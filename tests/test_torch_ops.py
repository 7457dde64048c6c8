"""The port's `ops` against the JAX package's, on the CPU.

Every helper of `pobrax_tpu.ops.__all__` runs in both packages on the same
numpy-seeded float32 inputs, under the same name and keywords, and the
outputs agree within 1e-6 (each formula is written as the JAX module writes
it). One parametrised test per helper; its cases are tests/test_ops.py's
inputs (`test_ops`), random unit quaternions (with leading batch axes), the
identity, a quaternion with |xyz| < 1e-10, quaternions with w < 0 (the
angle's wrap into (-pi, pi]), zero vectors, and `axis=0` / `keepdims=True`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pobrax_tpu import ops as jops
from pobrax_tpu_torch import ops

ATOL = 1e-6
QUAT_CASES = ("test_ops", "random", "identity", "tiny_xyz", "w_negative")
VEC_CASES = ("random", "zero", "axis0_keepdims")


def _unit(q):
    q = np.asarray(q, np.float64)
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)


def _quats(case, seed=0):
    rng = np.random.default_rng(seed)
    if case == "test_ops":  # test_ops.py's _rand_quat
        q = rng.normal(size=(7, 4)).astype(np.float32)
        return q / np.linalg.norm(q, axis=-1, keepdims=True)
    if case == "random":
        return _unit(rng.normal(size=(2, 5, 4)))
    if case == "identity":
        return np.tile(np.float32([1, 0, 0, 0]), (5, 1))
    if case == "tiny_xyz":
        q = np.concatenate([np.ones((5, 1)), rng.normal(size=(5, 3)) * 1e-12], -1)
        return q.astype(np.float32)
    q = rng.normal(size=(6, 4))
    q[..., 0] = -np.abs(q[..., 0])  # w < 0
    return _unit(q)


def _partner(q, seed=1):
    """Random unit quaternions of q's shape: the other operand."""
    return _unit(np.random.default_rng(seed).normal(size=q.shape))


def _vecs(case, seed=0, lead=None):
    rng = np.random.default_rng(seed + 100)
    shape = lead if lead is not None else (5,)
    v = rng.normal(size=shape + (3,)).astype(np.float32) * 2
    if case == "zero":
        v[::2] = 0.0
    return v


def _axis_kw(case):
    return dict(axis=0, keepdims=True) if case == "axis0_keepdims" else {}


def _same(want, got):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for w, g in zip(want, got):
            _same(w, g)
        return
    want = np.asarray(want)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def _run(name, *args, **kwargs):
    """ops.<name> in both packages on the same inputs -> the port's output."""
    want = getattr(jops, name)(*[jnp.asarray(a) for a in args], **kwargs)
    got = getattr(ops, name)(*[torch.as_tensor(np.array(a)) for a in args], **kwargs)
    _same(want, got)
    return got


def test_exports_match_jax():
    assert ops.__all__ == jops.__all__


@pytest.mark.parametrize("case", QUAT_CASES)
def test_quat_mul(case):
    q = _quats(case)
    _run("quat_mul", q, _partner(q))
    identity = np.broadcast_to(np.float32([1, 0, 0, 0]), q.shape)
    for a, b in ((q, identity), (identity, q)):  # test_ops.py's identity case
        np.testing.assert_allclose(_run("quat_mul", a, b).numpy(), q, atol=ATOL)


@pytest.mark.parametrize("case", QUAT_CASES)
def test_quat_inv(case):
    q = _quats(case)
    inv = _run("quat_inv", q)
    prod = ops.quat_mul(torch.as_tensor(q), inv).numpy()
    np.testing.assert_allclose(prod, np.broadcast_to([1.0, 0, 0, 0], q.shape), atol=ATOL)


@pytest.mark.parametrize("case", QUAT_CASES)
def test_rotate(case):
    q = _quats(case)
    _run("rotate", _vecs("random", lead=q.shape[:-1]), q)


@pytest.mark.parametrize("case", QUAT_CASES)
def test_inv_rotate(case):
    q = _quats(case)
    v = _vecs("random", lead=q.shape[:-1])
    back = _run("inv_rotate", ops.rotate(torch.as_tensor(v), torch.as_tensor(q)).numpy(), q)
    np.testing.assert_allclose(back.numpy(), v, atol=1e-5)  # test_ops.py's round trip


@pytest.mark.parametrize("case", VEC_CASES)
def test_ang_to_quat(case):
    _run("ang_to_quat", _vecs(case))


@pytest.mark.parametrize("case", ("test_ops", "random", "zero", "w_negative"))
def test_euler_to_quat(case):
    if case == "test_ops":  # test_ops.py's single-axis and x-y'-z'' order cases
        angles = np.float32([[0, 0, 90], [0, -90, 0], [90, -45, 0]])
    elif case == "zero":
        angles = np.zeros((3, 3), np.float32)
    else:  # a w < 0 quaternion needs |angle| > 180 about one axis
        scale = 360.0 if case == "w_negative" else 180.0
        angles = (np.random.default_rng(3).uniform(-1, 1, (2, 4, 3)) * scale).astype(np.float32)
    q = _run("euler_to_quat", angles)
    if case == "w_negative":
        assert bool((q[..., 0] < 0).any())


@pytest.mark.parametrize("case", ("test_ops", "random", "zero_angle", "w_negative"))
def test_quat_rot_axis(case):
    rng = np.random.default_rng(4)
    if case == "test_ops":
        axis, angle = np.float32([[0, 0, 1], [1, 0, 0]]), np.float32([0.7, -1.2])
    else:
        axis = _unit(rng.normal(size=(6, 3)))
        angle = {"random": rng.uniform(-np.pi, np.pi, 6), "zero_angle": np.zeros(6),
                 "w_negative": rng.uniform(np.pi, 2 * np.pi, 6)}[case].astype(np.float32)
    _run("quat_rot_axis", axis, angle)


@pytest.mark.parametrize("case", QUAT_CASES)
def test_relative_quat(case):
    q = _quats(case)
    _run("relative_quat", q, _partner(q))
    _run("relative_quat", _partner(q), q)


@pytest.mark.parametrize("case", QUAT_CASES + ("test_ops_roundtrip",))
def test_quat_to_axis_angle(case):
    if case == "test_ops_roundtrip":  # test_ops.py's axis-angle round trip
        axis, angle = np.float32([[0, 0, 1], [1, 0, 0]]), np.float32([0.7, -1.2])
        q = jops.quat_rot_axis(jnp.asarray(axis), jnp.asarray(angle))
        got_axis, got_angle = _run("quat_to_axis_angle", np.asarray(q))
        np.testing.assert_allclose(got_axis.numpy() * got_angle.numpy()[:, None],
                                   axis * angle[:, None], atol=ATOL)
        return
    q = _quats(case)
    axis, angle = _run("quat_to_axis_angle", q)
    assert bool(((angle > -np.pi) & (angle <= np.float32(np.pi))).all())
    small = np.linalg.norm(q[..., 1:], axis=-1) < 1e-10
    if case in ("identity", "tiny_xyz"):
        assert small.all()
        np.testing.assert_array_equal(axis.numpy(), np.broadcast_to([1.0, 0, 0], axis.shape))
    if case == "w_negative":
        assert bool((angle < 0).any())


@pytest.mark.parametrize("case", VEC_CASES)
def test_cross(case):
    _run("cross", _vecs(case), _vecs("random", 1))


@pytest.mark.parametrize("case", VEC_CASES)
def test_norm(case):
    _run("norm", _vecs(case), **_axis_kw(case))


@pytest.mark.parametrize("case", VEC_CASES + ("keepdims_last",))
def test_safe_norm(case):
    kw = dict(keepdims=True) if case == "keepdims_last" else _axis_kw(case)
    x = _vecs("zero" if case == "keepdims_last" else case)
    _run("safe_norm", x, **kw)
    # the gradient is defined at zero, as test_ops.py asks of JAX's
    t = torch.zeros(3, requires_grad=True)
    ops.safe_norm(t).backward()
    assert float(ops.safe_norm(t.detach())) == 0.0
    assert bool(torch.isfinite(t.grad).all())
    assert np.isfinite(np.asarray(jax.grad(jops.safe_norm)(jnp.zeros(3)))).all()


@pytest.mark.parametrize("case", ("test_ops",) + VEC_CASES)
def test_normalize(case):
    if case == "test_ops":
        for v in (np.float32([3, 4, 0]), np.zeros(3, np.float32)):
            _run("normalize", v)
        return
    kw = dict(axis=0) if case == "axis0_keepdims" else {}
    x = _vecs(case)
    got = _run("normalize", x, **kw).numpy()
    if case == "zero":
        np.testing.assert_array_equal(got[::2], 0.0)
