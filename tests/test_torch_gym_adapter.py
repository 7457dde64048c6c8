"""The port's gymnasium adapters against the JAX package's, on the CPU.

`create_gym_env` of both packages, same env, seed and actions:
  * batched (`AutoresetVmapGymWrapper`) on `fast` (whose arithmetic both
    packages round alike) and on hopper (falls end episodes early; episodes
    of 12 steps add truncations), and unbatched (`AutoresetGymWrapper`) on
    hopper: the adapter's key after reset and after every host autoreset
    bit-equal to JAX's; reset obs bit-equal on `fast`, within 1e-6 on hopper
    (FK round-off); step obs 1e-3 and rewards 1e-4 (the physics tolerances
    of tests/test_fused.py), `terminated` / `truncated` equal, through the
    host-autoreset merges;
  * `EvalGymWrapper.get_stats()` equal (1e-5 relative) over the same run,
    and its queue cap;
  * the spaces are the same gymnasium Boxes, and the returns are tensors on
    the env's device.
"""

import jax
import numpy as np
import pytest
import torch
from gymnasium import spaces

from pobrax_tpu.envs import create_gym_env as jax_create_gym_env
from pobrax_tpu_torch.envs import create_gym_env
from pobrax_tpu_torch.envs.gym_adapter import EvalGymWrapper

STEPS = 30
EPISODE = 12


def _same_key(tenv, jenv):
    np.testing.assert_array_equal(tenv._key.numpy(), np.asarray(jenv._key).astype(np.int64))


@pytest.mark.parametrize("name", ["fast", "hopper"])
def test_vector_env_matches_jax(name):
    kw = dict(batch_size=4, seed=5, episode_length=EPISODE)
    jenv, tenv = jax_create_gym_env(name, **kw), create_gym_env(name, device="cpu", **kw)
    for attr in ("single_observation_space", "single_action_space", "observation_space",
                 "action_space"):
        got, want = getattr(tenv, attr), getattr(jenv, attr)
        assert isinstance(got, spaces.Box) and got == want, attr
    jobs, _ = jenv.reset()
    tobs, _ = tenv.reset()
    assert isinstance(tobs, torch.Tensor) and tobs.device.type == "cpu"
    np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), rtol=0,
                               atol=0.0 if name == "fast" else 1e-6)
    _same_key(tenv, jenv)
    acts = np.random.RandomState(0).uniform(
        -1, 1, (STEPS,) + tenv.action_space.shape).astype(np.float32)
    ends = {"terminated": 0, "truncated": 0}
    for t in range(STEPS):
        jo, jr_, jterm, jtrunc, jinfo = jenv.step(acts[t])
        to, tr_, tterm, ttrunc, tinfo = tenv.step(acts[t])
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=1e-3,
                                   err_msg=f"step {t}")
        np.testing.assert_allclose(tr_.numpy(), np.asarray(jr_), rtol=0, atol=1e-4)
        np.testing.assert_array_equal(tterm.numpy(), np.asarray(jterm), err_msg=f"step {t}")
        np.testing.assert_array_equal(ttrunc.numpy(), np.asarray(jtrunc), err_msg=f"step {t}")
        assert set(tinfo["metrics"]) == set(jinfo["metrics"])
        _same_key(tenv, jenv)
        ends["terminated"] += int(tterm.sum())
        ends["truncated"] += int(ttrunc.sum())
    assert ends["truncated"] > 0
    if name == "hopper":
        assert ends["terminated"] > 0


def test_unbatched_env_matches_jax():
    jenv = jax_create_gym_env("hopper", seed=2, episode_length=EPISODE)
    tenv = create_gym_env("hopper", seed=2, device="cpu", episode_length=EPISODE)
    assert tenv.observation_space == jenv.observation_space
    assert tenv.action_space == jenv.action_space
    jobs, _ = jenv.reset()
    tobs, _ = tenv.reset()
    assert tobs.shape == (14,)
    np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), rtol=0, atol=1e-6)
    acts = np.random.RandomState(1).uniform(-1, 1, (STEPS, 3)).astype(np.float32)
    resets = 0
    for t in range(STEPS):
        jo, jr_, jterm, jtrunc, _ = jenv.step(acts[t])
        to, tr_, tterm, ttrunc, _ = tenv.step(acts[t])
        assert (tterm, ttrunc) == (jterm, jtrunc), f"step {t}"
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=1e-3)
        np.testing.assert_allclose(float(tr_), float(jr_), rtol=0, atol=1e-4)
        _same_key(tenv, jenv)
        resets += tterm or ttrunc
    assert resets > 0


@pytest.mark.parametrize("batch_size", [4, None])
def test_eval_stats_match_jax(batch_size):
    kw = dict(batch_size=batch_size, seed=3, episode_length=EPISODE, eval_metrics=True,
              discount=0.97)
    jenv, tenv = jax_create_gym_env("hopper", **kw), create_gym_env("hopper", device="cpu", **kw)
    assert isinstance(tenv, EvalGymWrapper) and tenv.num_envs == (batch_size or 1)
    jenv.reset()
    tenv.reset()
    shape = (3,) if batch_size is None else (batch_size, 3)
    acts = np.random.RandomState(2).uniform(-1, 1, (STEPS,) + shape).astype(np.float32)
    for t in range(STEPS):
        jenv.step(acts[t])
        tenv.step(acts[t])
    want, got = jenv.get_stats(), tenv.get_stats()
    assert set(got) == set(want)
    assert len(tenv.l_q) == len(jenv.l_q) > 1
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


def test_eval_queue_cap():
    env = EvalGymWrapper(create_gym_env("fast", batch_size=4, seed=0, device="cpu",
                                        episode_length=2), queue_cap=5)
    env.reset()
    for _ in range(8):  # 4 rounds of 4 episodes end
        env.step(np.zeros((4, 1), np.float32))
    assert len(env.r_q) == len(env.dr_q) == len(env.l_q) == 5
    assert env.l_q[-1] == 2 and np.isfinite(env.get_stats()["charts/mean_episodic_length"])
