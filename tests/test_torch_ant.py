"""The port's stock `ant` env against the JAX package's, on the CPU.

  * reset: the keys bit for bit; qp and the 87-dim observation to 1e-6 (the
    forward kinematics of the default pose round at the last ulp, as JAX's
    own jitted and eager resets differ);
  * 20 plain steps of seeded actions: pos/rot within 1e-5 and vel/ang within
    1e-3 (tests/test_fused.py's tolerances), reward and metrics within 1e-5,
    `done` equal;
  * the registry names it and the kernel's host build (g++) agrees with the
    plain step on its System with contacts live.
"""

import jax
import numpy as np
import torch

from pobrax_tpu.envs import create as jax_create
from pobrax_tpu_torch import random as jr
from pobrax_tpu_torch.envs import _envs, create
from pobrax_tpu_torch.envs.ant import Ant
from tests.test_torch_kernel_host import assert_close, host_lib, host_step  # noqa: F401

torch.set_num_threads(1)

B, T = 4, 20
KW = dict(episode_length=1000, batch_size=B, auto_reset=False)


def test_reset_matches_jax():
    jenv, tenv = jax_create("ant", **KW), create("ant", device="cpu", **KW)
    for seed in (0, 5):
        want = jax.jit(jenv.reset)(jax.random.PRNGKey(seed))
        got = tenv.reset(jr.PRNGKey(seed))
        assert got.obs.shape == (B, 87) == tuple(np.shape(want.obs))
        np.testing.assert_array_equal(got.info["rng"].numpy(),
                                      np.asarray(want.info["rng"]).astype(np.int64))
        np.testing.assert_allclose(got.obs.numpy(), np.asarray(want.obs), rtol=0, atol=1e-6)
        for f in ("pos", "rot", "vel", "ang"):
            np.testing.assert_allclose(getattr(got.qp, f).numpy(),
                                       np.asarray(getattr(want.qp, f)), rtol=0, atol=1e-6,
                                       err_msg=f)
        assert sorted(got.metrics) == sorted(want.metrics)


def test_plain_steps_match_jax():
    jenv, tenv = jax_create("ant", **KW), create("ant", device="cpu", **KW)
    js, ts = jax.jit(jenv.reset)(jax.random.PRNGKey(1)), tenv.reset(jr.PRNGKey(1))
    jstep = jax.jit(jenv.step)
    acts = np.random.RandomState(0).uniform(-1, 1, (T, B, 8)).astype(np.float32)
    for t in range(T):
        js, ts = jstep(js, acts[t]), tenv.step(ts, torch.from_numpy(acts[t]))
        for f, tol in (("pos", 1e-5), ("rot", 1e-5), ("vel", 1e-3), ("ang", 1e-3)):
            np.testing.assert_allclose(getattr(ts.qp, f).numpy(), np.asarray(getattr(js.qp, f)),
                                       rtol=0, atol=tol, err_msg=f"{f}, step {t}")
        np.testing.assert_allclose(ts.reward.numpy(), np.asarray(js.reward), rtol=0, atol=1e-5,
                                   err_msg=f"step {t}")
        np.testing.assert_array_equal(ts.done.numpy(), np.asarray(js.done))
        for k, v in ts.metrics.items():
            np.testing.assert_allclose(v.numpy(), np.asarray(js.metrics[k]), rtol=0, atol=1e-5,
                                       err_msg=k)


def test_ant_is_registered():
    assert _envs["ant"] is Ant
    env = Ant(device="cpu")
    assert env.observation_size == 87 and env.action_size == 8
    assert env.sys.info_mode == "full"


def test_host_kernel_matches_plain_step_on_ant(host_lib):  # noqa: F811
    env = Ant(device="cpu")
    qp = env.reset(jr.split(jr.PRNGKey(2), 8)).qp
    g = torch.Generator().manual_seed(0)
    for _ in range(10):
        qp, _ = env.sys.step_generic(qp, torch.rand(8, 8, generator=g) * 2 - 1)
    act = torch.rand(8, 8, generator=g) * 2 - 1
    want = env.sys.step_generic(qp, act)
    assert float(want[1].contact.vel.abs().max()) > 0, "contacts must be live"
    assert_close(host_step(host_lib, env.sys, qp, act), want)
