"""The port's env factory against the JAX package's, and one PPO epoch on
halfcheetah against JAX's, on the CPU.

  * The registry holds every name of JAX's `_envs`; `register`, `create_fn`
    and `HAI_ACTION_REPEAT` behave as JAX's; `create_gym_env` refuses a
    batch size <= 0.
  * PPO on halfcheetah at a small size (8 envs, unroll 4, 2 minibatches,
    PPOConfig's other defaults), from a JAX-drawn state carried across with
    `interop`: the rollout (unroll 4, halfcheetah's 16 substeps a step,
    JAX's key stream) agrees with JAX's (obs, reward, log-prob 1e-4, value
    1e-5); then the epoch's update, run on JAX's rollout, lands within 5e-5
    of JAX's parameters (Adam's moments 1e-5 relative, the normaliser 1e-4
    relative, the losses 1e-4 relative, the counts exactly). The whole epoch
    closed-loop does not hold 5e-5: the rollout's round-off (obs ~5e-6)
    reaches the value net's gradients, and Adam turns a difference in a
    near-zero moment into a step of up to the learning rate (3e-4), so a
    few of 270k entries part by up to 3.8e-4 on the CPU. So the
    update is compared from JAX's rollout, as tests/test_torch_checkpoint.py
    compares the closed-loop replay one step at a time.
"""

import jax
import numpy as np
import pytest
import torch

from pobrax_tpu import envs as jenvs
from pobrax_tpu.envs import wrappers as jwrappers
from pobrax_tpu.envs.planar import Halfcheetah as JHalfcheetah
from pobrax_tpu.training import ppo as jppo
from pobrax_tpu_torch import envs, interop
from pobrax_tpu_torch import random as jr
from pobrax_tpu_torch.envs.fast import Fast
from pobrax_tpu_torch.envs.planar import Halfcheetah
from pobrax_tpu_torch.training import ppo
from tests.test_torch_ppo import _leaves

torch.set_num_threads(1)


def test_registry_holds_every_jax_env():
    assert set(jenvs._envs) <= set(envs._envs)
    assert envs.HAI_ACTION_REPEAT == jenvs.HAI_ACTION_REPEAT == 6


def test_register_and_create_fn(monkeypatch):
    class Tagged(Fast):
        pass

    monkeypatch.setitem(envs._envs, "tagged_fast", Tagged)
    envs.register("tagged_fast", Tagged)
    make = envs.create_fn("tagged_fast", episode_length=7, batch_size=3, device="cpu")
    env = make()
    assert isinstance(env.unwrapped, Tagged)
    s = env.reset(jr.PRNGKey(0))
    assert s.obs.shape == (3, env.observation_size)
    for _ in range(7):
        s = env.step(s, torch.zeros(3, env.action_size))
    assert s.info["truncation"].tolist() == [1.0, 1.0, 1.0]


@pytest.mark.parametrize("batch_size", [0, -2])
def test_create_gym_env_refuses_batch_size_not_positive(batch_size):
    with pytest.raises(ValueError, match="batch_size"):
        envs.create_gym_env("fast", batch_size=batch_size, device="cpu")
    with pytest.raises(ValueError, match="batch_size"):
        jenvs.create_gym_env("fast", batch_size=batch_size)


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.as_tensor(np.array(x))


def test_ppo_epoch_on_halfcheetah_matches_jax():
    kw = dict(num_envs=8, episode_length=1000, unroll_length=4, num_minibatches=2)
    jcfg, tcfg = jppo.PPOConfig(**kw), ppo.PPOConfig(**kw)
    jwrapped = jwrappers.ActionRepeatWrapper(JHalfcheetah(), 1)
    jwrapped = jwrappers.EpisodeWrapper(jwrapped, jcfg.episode_length, 1)
    jwrapped = jwrappers.VmapWrapper(jwrapped, batch_size=jcfg.num_envs)
    jwrapped = jwrappers.randomized_autoreset(jwrapped, "naive")
    jl = jppo.PPOLearner(jwrapped, jcfg)
    twrapped = ppo.wrap_for_training(Halfcheetah(device="cpu"), tcfg, "naive")
    tl = ppo.PPOLearner(twrapped, tcfg)

    jts = jl.init(jax.random.PRNGKey(7))
    k_reset, k_epoch = jax.random.split(jax.random.PRNGKey(3))
    _, k_roll, _ = jax.random.split(k_epoch, 3)
    jstate = jax.jit(jwrapped.reset)(jax.random.split(k_reset, tcfg.num_envs))
    want_ts, _, want_m = jax.jit(jl._build_epoch_fn())(jts, jstate, k_epoch)
    _, jdata, jboot = jax.jit(jl._rollout)(jts, jstate, k_roll)

    # the rollout, closed loop, from the carried state and the same reset key
    tstate = twrapped.reset(jr.split(_t(k_reset).long(), tcfg.num_envs))
    _, tdata, _ = tl._rollout(interop.training_state_from_numpy(jax.device_get(jts), tl), tstate,
                              _t(k_roll).long())
    for f, tol in (("obs", 1e-4), ("reward", 1e-4), ("log_prob", 1e-4), ("value", 1e-5)):
        np.testing.assert_allclose(getattr(tdata, f).numpy(), _np(getattr(jdata, f)), rtol=0,
                                   atol=tol, err_msg=f)
    np.testing.assert_array_equal(tdata.done.numpy(), _np(jdata.done))

    # the update, from JAX's rollout
    data = ppo.Transition(**{f: _t(getattr(jdata, f)) for f in ppo.Transition.__dataclass_fields__})
    tl._rollout = lambda ts, env_state, key: (env_state, data, _t(jboot))
    ts, _, got_m = tl.epoch(interop.training_state_from_numpy(jax.device_get(jts), tl), tstate,
                            _t(k_epoch).long())
    for k in want_m:
        np.testing.assert_allclose(float(got_m[k]), float(want_m[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    got, want = interop.training_state_to_numpy(ts), jax.device_get(want_ts)
    assert int(got["epochs"]) == int(want.epochs) == 1
    want_params = dict(_leaves(interop._as_tree(want.params)))
    for path, g in _leaves(got["params"]):
        np.testing.assert_allclose(g, want_params[path], rtol=0, atol=5e-5, err_msg=str(path))
    adam = interop._find_adam(want.opt_state)
    assert got["opt_state"]["count"] == int(adam.count) == 4 * 2
    for k in ("mu", "nu"):
        w = _np(getattr(adam, k))
        np.testing.assert_allclose(got["opt_state"][k], w, rtol=1e-5, atol=1e-5 * np.abs(w).max())
    # the summed variance of the torso's z (mean ~0.6, spread ~0.04) is a
    # difference of float32 sums ~200x larger than itself: ~2e-5 relative
    for k, v in got["normalizer"].items():
        np.testing.assert_allclose(v, _np(getattr(want.normalizer, k)), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
