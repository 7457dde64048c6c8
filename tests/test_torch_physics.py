"""The port's plain physics (pobrax_tpu_torch.physics) against the JAX package.

Seeded numpy states go through both: batched FK, `info`, one `step_generic`
on AntTag, on tests/test_fused.py's mini system (every row kind, thrusters)
and on its 2-dof + angle-servo system, and the JAX Pallas whole-step kernel
in interpret mode on the mini and 2-dof systems. Per
control step the tolerances are tests/test_fused.py:61-68's: pos/rot 1e-5,
vel/ang/contact 1e-3 (float32 reassociation through stiff contact impulses).
The joint and actuator Info sums are accelerations of O(1e3); they are held
to a relative 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pobrax_tpu.envs.ant_tag import extend_ant_cfg as jax_ant_tag_cfg
from pobrax_tpu.physics import config as jc
from pobrax_tpu.physics.state import QP as JQP
from pobrax_tpu.physics.system import System as JSystem
from pobrax_tpu_torch.envs.ant_tag import extend_ant_cfg as torch_ant_tag_cfg
from pobrax_tpu_torch.physics import config as tc
from pobrax_tpu_torch.physics.state import QP
from pobrax_tpu_torch.physics.system import System as TSystem

# The port's CPU tests step batches of 1-8 envs, where torch's intra-op
# threads buy nothing; under the suite's parallel workers (pytest-xdist, which
# imports every test module in every worker, so this line reaches them all)
# they oversubscribe the cores and doubled the port tests' wall time.
torch.set_num_threads(1)


def mini_cfg(c):
    """tests/test_fused.py::_mini_system's scene, from config module `c`:
    point-plane, capsule-capsule (sphere as capsule), capsule-box rows and a
    thruster."""
    return c.Config(
        bodies=(
            c.Body(name="a", colliders=(c.Collider(geom=c.Sphere(0.2)),), mass=1.0),
            c.Body(name="b",
                   colliders=(c.Collider(geom=c.Capsule(radius=0.1, length=0.4)),),
                   mass=1.5),
            c.Body(name="wall",
                   colliders=(c.Collider(geom=c.Box(halfsize=(0.2, 1.0, 0.5)),
                                         position=(1.0, 0.0, 0.5)),),
                   frozen=True),
            c.Body(name="G", colliders=(c.Collider(geom=c.Plane()),), frozen=True),
        ),
        joints=(c.Joint(name="j", parent="a", child="b", stiffness=5000.0,
                        parent_offset=(0.1, 0.0, 0.0), child_offset=(0.0, 0.0, 0.2),
                        angle_limits=(c.AngleLimit(-45.0, 45.0),),
                        angular_damping=20.0),),
        actuators=(c.Actuator(name="j", joint="j", strength=50.0),),
        thrusters=(c.Thruster(name="t", body="a", strength=10.0,
                              direction=(1.0, 0.0, 0.0)),),
        collide_include=(("a", "G"), ("b", "G"), ("a", "b"),
                         ("a", "wall"), ("b", "wall")),
        default_qps=(c.DefaultQP(name="a", pos=(0.6, 0.0, 0.5)),),
        dt=0.05, substeps=10,
    )


def multidof_cfg(c):
    """tests/test_fused.py::test_fused_multidof_and_servo_match_generic's
    scene, from config module `c`: a 2-dof joint with an angle servo under a
    hinge with a torque actuator, hanging from a frozen root."""
    return c.Config(
        bodies=(
            c.Body(name="root", frozen=True),
            c.Body(name="a", colliders=(
                c.Collider(geom=c.Capsule(radius=0.05, length=0.4)),), mass=1.0),
            c.Body(name="b", colliders=(
                c.Collider(geom=c.Capsule(radius=0.05, length=0.4)),), mass=1.0),
        ),
        joints=(
            c.Joint(name="u", parent="root", child="a",
                    stiffness=4000.0, spring_damping=126.0, angular_damping=5.0,
                    parent_offset=(0.0, 0.0, 0.0), child_offset=(0.0, 0.0, 0.2),
                    angle_limits=(c.AngleLimit(-40, 40), c.AngleLimit(-30, 30))),
            c.Joint(name="h", parent="a", child="b",
                    stiffness=4000.0, spring_damping=126.0, angular_damping=5.0,
                    parent_offset=(0.0, 0.0, -0.2), child_offset=(0.0, 0.0, 0.2),
                    angle_limits=(c.AngleLimit(-60, 10),)),
        ),
        actuators=(c.Actuator(name="u", joint="u", strength=20.0, kind="angle"),
                   c.Actuator(name="h", joint="h", strength=20.0)),
        default_qps=(c.DefaultQP(name="root", pos=(0.0, 0.0, 1.5)),),
        dt=0.04, substeps=10,
    )


SCENES = {
    "ant_tag": (jax_ant_tag_cfg, torch_ant_tag_cfg),
    "mini": (lambda: mini_cfg(jc), lambda: mini_cfg(tc)),
    "multidof": (lambda: multidof_cfg(jc), lambda: multidof_cfg(tc)),
}


def systems(name):
    jcfg, tcfg = SCENES[name]
    return JSystem(jcfg()), TSystem(tcfg(), device="cpu")


def perturbed_state(jsys, B, seed):
    """(pos, rot, vel, ang) numpy arrays: the default pose, jittered; frozen
    bodies keep zero velocity."""
    rs = np.random.RandomState(seed)
    qp = jsys.default_qp()
    n = jsys.num_bodies
    pos = (np.asarray(qp.pos)[None] + 0.01 * rs.randn(B, n, 3)).astype(np.float32)
    rot = np.broadcast_to(np.asarray(qp.rot), (B, n, 4)).astype(np.float32)
    vel = (0.1 * rs.randn(B, n, 3)).astype(np.float32)
    ang = (0.1 * rs.randn(B, n, 3)).astype(np.float32)
    vel[:, jsys.body.frozen] = 0.0
    ang[:, jsys.body.frozen] = 0.0
    return pos, rot, vel, ang


def to_jax(arrs):
    return JQP(*(jnp.asarray(a) for a in arrs))


def to_torch(arrs):
    return QP(*(torch.from_numpy(np.array(a, dtype=np.float32)) for a in arrs))


def assert_step_close(q_ref, i_ref, q, i):
    """Tolerances of tests/test_fused.py:61-68; joint/actuator sums relative."""
    get = lambda x: x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    for name, tol in (("pos", 1e-5), ("rot", 1e-5), ("vel", 1e-3), ("ang", 1e-3)):
        np.testing.assert_allclose(get(getattr(q, name)), get(getattr(q_ref, name)),
                                   rtol=0, atol=tol, err_msg=name)
    for f in ("vel", "ang"):
        np.testing.assert_allclose(get(getattr(i.contact, f)), get(getattr(i_ref.contact, f)),
                                   rtol=0, atol=1e-3, err_msg=f"contact.{f}")
        for part in ("joint", "actuator"):
            want = get(getattr(getattr(i_ref, part), f))
            np.testing.assert_allclose(get(getattr(getattr(i, part), f)), want, rtol=1e-5,
                                       atol=1e-5 * max(1.0, np.abs(want).max()),
                                       err_msg=f"{part}.{f}")


def test_default_qp_fk_matches():
    jsys, tsys = systems("ant_tag")
    rs = np.random.RandomState(3)
    B = 4
    angle = (np.asarray(jsys.default_angle())[None]
             + rs.uniform(-0.3, 0.3, (B, jsys.num_joint_dof))).astype(np.float32)
    vel = rs.uniform(-0.5, 0.5, (B, jsys.num_joint_dof)).astype(np.float32)
    want = jax.vmap(jsys.default_qp)(jnp.asarray(angle), jnp.asarray(vel))
    got = tsys.default_qp(torch.from_numpy(angle), torch.from_numpy(vel))
    for name in ("pos", "rot", "vel", "ang"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=0, atol=1e-6, err_msg=name)
    # no angles given: the default pose, as a batch of one
    np.testing.assert_allclose(tsys.default_qp().pos[0].numpy(),
                               np.asarray(jsys.default_qp().pos), rtol=0, atol=1e-6)


@pytest.mark.parametrize("scene", ["ant_tag", "mini", "multidof"])
def test_info_matches_generic(scene):
    jsys, tsys = systems(scene)
    arrs = perturbed_state(jsys, 4, seed=1)
    want = jax.jit(jax.vmap(jsys.info))(to_jax(arrs))
    got = tsys.info(to_torch(arrs))
    for f in ("vel", "ang"):
        np.testing.assert_allclose(getattr(got.contact, f).numpy(),
                                   np.asarray(getattr(want.contact, f)), rtol=0, atol=1e-3)
        assert float(np.abs(getattr(got.joint, f).numpy()).max()) == 0.0


@pytest.mark.parametrize("scene", ["ant_tag", "mini", "multidof"])
def test_step_matches_generic(scene):
    jsys, tsys = systems(scene)
    arrs = perturbed_state(jsys, 4, seed=2)
    act = np.random.RandomState(5).uniform(-1, 1, (4, jsys.action_size)).astype(np.float32)
    q_ref, i_ref = jax.jit(jax.vmap(jsys.step_generic))(to_jax(arrs), jnp.asarray(act))
    q, i = tsys.step_generic(to_torch(arrs), torch.from_numpy(act))
    assert_step_close(q_ref, i_ref, q, i)
    # System.step on CPU tensors is the plain step
    q2, _ = tsys.step(to_torch(arrs), torch.from_numpy(act))
    np.testing.assert_array_equal(q2.pos.numpy(), q.pos.numpy())


def test_plain_step_matches_pallas_interpret():
    """The port's plain step against the JAX whole-step Pallas kernel, run in
    interpret mode as tests/test_pallas.py:68-84 runs it."""
    from tests.test_pallas import _mini_pallas_system

    sys_ = _mini_pallas_system()
    B = 8
    qp = sys_.default_qp()
    qps = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape), qp)
    acts = jnp.tile(jnp.array([[0.3, -0.5]]), (B, 1))
    q_ref, i_ref = jax.jit(jax.vmap(sys_.step))(qps, acts)  # -> the Pallas kernel

    tsys = TSystem(mini_cfg(tc), device="cpu")
    arrs = tuple(np.asarray(getattr(qps, f)) for f in ("pos", "rot", "vel", "ang"))
    q, i = tsys.step_generic(to_torch(arrs), torch.from_numpy(np.array(acts)))
    for name, tol in (("pos", 1e-5), ("rot", 1e-5), ("vel", 1e-3), ("ang", 1e-3)):
        np.testing.assert_allclose(getattr(q, name).numpy(), np.asarray(getattr(q_ref, name)),
                                   rtol=0, atol=tol, err_msg=name)
    np.testing.assert_allclose(i.contact.vel.numpy(), np.asarray(i_ref.contact.vel),
                               rtol=0, atol=1e-3)


def test_plain_step_matches_pallas_interpret_multidof(monkeypatch):
    """The same on the 2-dof + angle-servo system: the JAX Pallas kernel,
    selected by POBRAX_FUSED=1 and POBRAX_PALLAS=1 when the System is built,
    runs vmapped in interpret mode on the CPU."""
    monkeypatch.setenv("POBRAX_FUSED", "1")
    monkeypatch.setenv("POBRAX_PALLAS", "1")
    sys_ = JSystem(multidof_cfg(jc))
    monkeypatch.delenv("POBRAX_FUSED")
    monkeypatch.delenv("POBRAX_PALLAS")
    assert sys_._fused_step is not None
    B = 8
    arrs = perturbed_state(sys_, B, seed=9)
    act = np.random.RandomState(3).uniform(-1, 1, (B, sys_.action_size)).astype(np.float32)
    q_ref, i_ref = jax.jit(jax.vmap(sys_.step))(to_jax(arrs), jnp.asarray(act))  # -> Pallas
    q, i = TSystem(multidof_cfg(tc), device="cpu").step_generic(to_torch(arrs),
                                                               torch.from_numpy(act))
    assert_step_close(q_ref, i_ref, q, i)


def test_step_matches_generic_substeps_8():
    """The opt-in substeps=8 preset (envs/base.py:58-89) steps alike too."""
    import dataclasses

    jsys = JSystem(dataclasses.replace(jax_ant_tag_cfg(), substeps=8))
    tsys = TSystem(dataclasses.replace(torch_ant_tag_cfg(), substeps=8), device="cpu")
    arrs = perturbed_state(jsys, 4, seed=4)
    act = np.random.RandomState(6).uniform(-1, 1, (4, 8)).astype(np.float32)
    q_ref, i_ref = jax.jit(jax.vmap(jsys.step_generic))(to_jax(arrs), jnp.asarray(act))
    q, i = tsys.step_generic(to_torch(arrs), torch.from_numpy(act))
    assert_step_close(q_ref, i_ref, q, i)
