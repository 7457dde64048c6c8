"""State crossing from the JAX package into the port (pobrax_tpu_torch.interop).

A JAX env state, sent through `state_from_numpy` and stepped by the port,
must track JAX stepping the same state.
"""

import jax
import numpy as np
import pytest
import torch

from pobrax_tpu.envs import create as jax_create
from pobrax_tpu_torch import interop
from pobrax_tpu_torch.envs import create
from pobrax_tpu_torch.physics.state import QP


@pytest.mark.parametrize("mode", ["cached", "naive"])
def test_jax_state_steps_alike_in_the_port(mode):
    B = 4
    kw = dict(episode_length=50, batch_size=B, randomized_autoreset=True, autoreset_mode=mode,
              tag_radius=6.0)
    jenv = jax_create("ant_tag", **kw)
    tenv = create("ant_tag", device="cpu", **kw)
    acts = np.random.RandomState(2).uniform(-1, 1, (8, B, 8)).astype(np.float32)
    jstep = jax.jit(jenv.step)
    js = jax.jit(jenv.reset)(jax.random.PRNGKey(4))
    for a in acts[:3]:
        js = jstep(js, a)

    ts = interop.state_from_numpy(js, device="cpu")
    assert isinstance(ts.qp, QP) and ts.qp.pos.shape == (B, 12, 3)
    assert ts.info["rng"].dtype == torch.int64
    if mode == "cached":
        assert isinstance(ts.info["first_qp"], QP)
        assert int(ts.info["cache_age"][0]) == 3
    for a in acts[3:]:
        js = jstep(js, a)
        ts = tenv.step(ts, torch.from_numpy(a))
        np.testing.assert_allclose(ts.obs.numpy(), np.asarray(js.obs), rtol=0, atol=1e-3)
        np.testing.assert_array_equal(ts.done.numpy(), np.asarray(js.done))
        np.testing.assert_array_equal(ts.info["rng"].numpy(),
                                      np.asarray(js.info["rng"]).astype(np.int64))

    back = interop.state_to_numpy(ts)
    assert back["info"]["rng"].dtype == np.uint32
    np.testing.assert_array_equal(back["info"]["rng"], np.asarray(js.info["rng"]))
    np.testing.assert_allclose(back["qp"]["pos"], np.asarray(js.qp.pos), rtol=0, atol=1e-3)


def test_round_trip_through_numpy():
    env = create("ant_tag", batch_size=2, randomized_autoreset=True, autoreset_mode="cached",
                 device="cpu")
    from pobrax_tpu_torch import random as jr
    s = env.reset(jr.PRNGKey(1))
    s2 = interop.state_from_numpy(interop.state_to_numpy(s), device="cpu")
    for f in ("pos", "rot", "vel", "ang"):
        assert torch.equal(getattr(s.qp, f), getattr(s2.qp, f))
        assert torch.equal(getattr(s.info["first_qp"], f), getattr(s2.info["first_qp"], f))
    assert torch.equal(s.obs, s2.obs)
    for k in s.info:
        if isinstance(s.info[k], torch.Tensor):
            assert torch.equal(s.info[k], s2.info[k]) and s.info[k].dtype == s2.info[k].dtype, k
    qp = interop.qp_from_numpy({f: getattr(s.qp, f).numpy() for f in ("pos", "rot", "vel", "ang")},
                               device="cpu")
    assert torch.equal(qp.rot, s.qp.rot)


def test_no_device_means_the_card():
    """Like `create`, the crossings default to the card: with no device named
    and no GPU they raise rather than land on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    env = create("ant_tag", batch_size=2, device="cpu")
    from pobrax_tpu_torch import random as jr
    s = interop.state_to_numpy(env.reset(jr.PRNGKey(1)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        interop.qp_from_numpy(s["qp"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        interop.state_from_numpy(s)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create("ant_tag", batch_size=2)
