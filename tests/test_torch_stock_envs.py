"""The port's stock envs against the JAX package, on the CPU.

For each of the nine ported stock env names: the scene config equals the JAX
one field for field; `reset` gives the JAX env's observation and qp for the
same key (atol 1e-5: FK and the obs are float32 chains of a few dozen ops on
both sides, so only round-off separates them); and a 20-step rollout of the
same seeded actions through JAX (`System.step` is the generic step on the
CPU) and the port's plain step tracks it: obs atol 1e-3 and reward atol 1e-4
(the physics tolerances of tests/test_fused.py, carried through 20 steps),
`done` equal. One JAX jit of reset and of step per env, shared by its tests.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from pobrax_tpu.envs import create as jax_create
from pobrax_tpu.physics import humanoid as j_humanoid
from pobrax_tpu.physics import manipulation as j_manipulation
from pobrax_tpu.physics import pendulum as j_pendulum
from pobrax_tpu.physics import quadruped as j_quadruped
from pobrax_tpu.physics import reacher as j_reacher
from pobrax_tpu_torch import random as jr
from pobrax_tpu_torch.envs import create
from pobrax_tpu_torch.physics import humanoid as t_humanoid
from pobrax_tpu_torch.physics import manipulation as t_manipulation
from pobrax_tpu_torch.physics import pendulum as t_pendulum
from pobrax_tpu_torch.physics import quadruped as t_quadruped
from pobrax_tpu_torch.physics import reacher as t_reacher

NAMES = ["humanoid", "humanoidstandup", "fetch", "grasp", "ur5e", "reacher", "reacherangle",
         "inverted_pendulum", "inverted_double_pendulum"]
B, T = 4, 20

CONFIGS = {
    "humanoid": (j_humanoid.humanoid_config, t_humanoid.humanoid_config),
    "humanoid_standup": (j_humanoid.humanoid_standup_config,
                         t_humanoid.humanoid_standup_config),
    "fetch": (j_quadruped.fetch_config, t_quadruped.fetch_config),
    "grasp": (j_manipulation.grasp_config, t_manipulation.grasp_config),
    "ur5e": (j_manipulation.ur5e_config, t_manipulation.ur5e_config),
    "reacher": (j_reacher.reacher_config, t_reacher.reacher_config),
    "reacherangle": (lambda: j_reacher.reacher_config("angle"),
                     lambda: t_reacher.reacher_config("angle")),
    "inverted_pendulum": (j_pendulum.inverted_pendulum_config,
                          t_pendulum.inverted_pendulum_config),
    "inverted_double_pendulum": (j_pendulum.inverted_double_pendulum_config,
                                 t_pendulum.inverted_double_pendulum_config),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_configs_equal(name):
    jcfg, tcfg = CONFIGS[name]
    assert dataclasses.asdict(jcfg()) == dataclasses.asdict(tcfg())


@functools.lru_cache(maxsize=None)
def pair(name):
    """(jitted JAX reset, jitted JAX step, port env) at batch B."""
    kw = dict(episode_length=1000, batch_size=B, auto_reset=False)
    jenv = jax_create(name, **kw)
    return jax.jit(jenv.reset), jax.jit(jenv.step), create(name, device="cpu", **kw)


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("name", NAMES)
def test_reset_matches_jax(name, seed):
    jreset, _, tenv = pair(name)
    want = jreset(jax.random.PRNGKey(seed))
    got = tenv.reset(jr.PRNGKey(seed))
    assert got.obs.shape == (B, tenv.observation_size)
    np.testing.assert_allclose(got.obs.numpy(), np.asarray(want.obs), rtol=0, atol=1e-5)
    for f in ("pos", "rot", "vel", "ang"):
        np.testing.assert_allclose(getattr(got.qp, f).numpy(), np.asarray(getattr(want.qp, f)),
                                   rtol=0, atol=1e-5, err_msg=f)
    np.testing.assert_array_equal(got.info["rng"].numpy(),
                                  np.asarray(want.info["rng"]).astype(np.int64))


@pytest.mark.parametrize("name", NAMES)
def test_rollout_matches_jax(name):
    jreset, jstep, tenv = pair(name)
    js, ts = jreset(jax.random.PRNGKey(1)), tenv.reset(jr.PRNGKey(1))
    acts = np.random.RandomState(0).uniform(-1, 1, (T, B, tenv.action_size)).astype(np.float32)
    for t in range(T):
        js, ts = jstep(js, acts[t]), tenv.step(ts, torch.from_numpy(acts[t]))
        np.testing.assert_allclose(ts.obs.numpy(), np.asarray(js.obs), rtol=0, atol=1e-3,
                                   err_msg=f"step {t}")
        np.testing.assert_allclose(ts.reward.numpy(), np.asarray(js.reward), rtol=0, atol=1e-4,
                                   err_msg=f"step {t}")
        np.testing.assert_array_equal(ts.done.numpy(), np.asarray(js.done), err_msg=f"step {t}")
        for k, v in ts.metrics.items():
            np.testing.assert_allclose(v.numpy(), np.asarray(js.metrics[k]), rtol=0, atol=1e-3,
                                       err_msg=f"metric {k}, step {t}")
    np.testing.assert_array_equal(ts.info["rng"].numpy(),
                                  np.asarray(js.info["rng"]).astype(np.int64))
