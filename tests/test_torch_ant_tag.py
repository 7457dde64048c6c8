"""The port's AntTag env stack against the JAX package and its fixture.

Reset observations seed for seed; the committed po-brax trajectory
(tests/fixtures/ref_ant_tag_s7.npz) and the JAX goldens (tests/golden/)
replayed through the port's plain path at the cross-implementation gate of
tests/test_replay_fixtures.py (1e-3); and `create(...)` with randomized
autoreset in both modes tracking JAX's `create(...)` across forced autoresets
(tag_radius=8.0, as the event goldens use) and a cache refresh.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from pobrax_tpu.envs import create as jax_create
from pobrax_tpu.envs.ant_tag import AntTagEnv as JAntTag
from pobrax_tpu_torch import random as jr
from pobrax_tpu_torch.envs import create
from pobrax_tpu_torch.envs.ant_tag import AntTagEnv

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "ref_ant_tag_s7.npz")


@pytest.fixture(scope="module")
def jax_reset():
    return jax.jit(JAntTag().reset)


@pytest.fixture(scope="module")
def torch_env():
    return AntTagEnv(device="cpu")


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_reset_matches_jax(seed, jax_reset, torch_env):
    want = jax_reset(jax.random.PRNGKey(seed))
    got = torch_env.reset(jr.PRNGKey(seed)[None])
    np.testing.assert_allclose(got.obs[0].numpy(), np.asarray(want.obs), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.qp.pos[0].numpy(), np.asarray(want.qp.pos), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got.info["rng"][0].numpy(),
                                  np.asarray(want.info["rng"]).astype(np.int64))
    assert got.obs.shape == (1, torch_env.observation_size)


def test_fixture_replay():
    fx = np.load(FIXTURE)
    meta = json.loads(str(fx["meta"]))
    env = create("ant_tag", episode_length=meta["steps"] + 1, auto_reset=False, batch_size=1,
                 device="cpu")
    s = env.reset(jr.PRNGKey(meta["seed"])[None])
    np.testing.assert_allclose(s.obs[0].numpy(), fx["reset_obs"], rtol=0, atol=1e-5)
    obs, rew, done = [], [], []
    for a in fx["actions"]:
        s = env.step(s, torch.from_numpy(a)[None])
        obs.append(s.obs[0].numpy())
        rew.append(s.reward[0].item())
        done.append(s.done[0].item())
    np.testing.assert_allclose(np.stack(obs), fx["obs"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(rew, fx["reward"], rtol=0, atol=1e-3)
    np.testing.assert_array_equal(done, fx["done"])


@pytest.mark.parametrize("mode", ["cached", "naive"])
def test_create_tracks_jax_across_autoresets(mode):
    B, T, refresh = 4, 30, 7
    kw = dict(episode_length=12, batch_size=B, randomized_autoreset=True,
              autoreset_mode=mode, tag_radius=8.0)
    jenv = jax_create("ant_tag", **kw)
    tenv = create("ant_tag", device="cpu", **kw)
    if mode == "cached":
        jenv.refresh_every = refresh
        tenv.refresh_every = refresh
    js = jax.jit(jenv.reset)(jax.random.PRNGKey(11))
    ts = tenv.reset(jr.PRNGKey(11))
    jstep = jax.jit(jenv.step)
    acts = np.random.RandomState(0).uniform(-1, 1, (T, B, tenv.action_size)).astype(np.float32)
    dones = 0.0
    for t in range(T):
        js = jstep(js, acts[t])
        ts = tenv.step(ts, torch.from_numpy(acts[t]))
        np.testing.assert_array_equal(ts.done.numpy(), np.asarray(js.done), err_msg=f"step {t}")
        np.testing.assert_allclose(ts.obs.numpy(), np.asarray(js.obs), rtol=0, atol=1e-3,
                                   err_msg=f"step {t}")
        np.testing.assert_allclose(ts.reward.numpy(), np.asarray(js.reward), rtol=0, atol=1e-3)
        np.testing.assert_allclose(ts.info["final_obs"].numpy(), np.asarray(js.info["final_obs"]),
                                   rtol=0, atol=1e-3)
        np.testing.assert_array_equal(ts.info["rng"].numpy(),
                                      np.asarray(js.info["rng"]).astype(np.int64))
        np.testing.assert_array_equal(ts.info["steps"].numpy(), np.asarray(js.info["steps"]))
        np.testing.assert_array_equal(ts.info["truncation"].numpy(),
                                      np.asarray(js.info["truncation"]))
        if mode == "cached":
            np.testing.assert_array_equal(ts.info["cache_age"].numpy(),
                                          np.asarray(js.info["cache_age"]))
            np.testing.assert_allclose(ts.info["first_obs"].numpy(),
                                       np.asarray(js.info["first_obs"]), rtol=0, atol=1e-5)
        dones += float(ts.done.sum())
    assert dones >= B, "the window must cross autoresets"


def test_substeps_8_preset_tracks_jax():
    kw = dict(episode_length=100, batch_size=2, auto_reset=False, substeps=8)
    jenv = jax_create("ant_tag", **kw)
    tenv = create("ant_tag", device="cpu", **kw)
    assert tenv.sys.config.substeps == 8
    js = jax.jit(jenv.reset)(jax.random.PRNGKey(5))
    ts = tenv.reset(jr.PRNGKey(5))
    jstep = jax.jit(jenv.step)
    acts = np.random.RandomState(1).uniform(-1, 1, (5, 2, 8)).astype(np.float32)
    for a in acts:
        js = jstep(js, a)
        ts = tenv.step(ts, torch.from_numpy(a))
    np.testing.assert_allclose(ts.obs.numpy(), np.asarray(js.obs), rtol=0, atol=1e-3)


def test_unported_env_names_raise():
    # every name of the JAX registry is ported (tests/test_torch_factory.py);
    # any other name raises and lists the registered ones
    with pytest.raises(ValueError, match=r"unknown env 'no_such_env'.*'halfcheetah'"):
        create("no_such_env", device="cpu")
    with pytest.raises(ValueError):
        create("ant_tag", device="cpu", autoreset_mode="Cached")


GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _golden_rollout(env, T, seed=7):
    """tests/test_golden.py's rollout: actions from the same threefry key
    chain (`key, k = split(key)`, uniform(k, (8,), -1, 1)), batch of one."""
    key = jr.PRNGKey(seed)
    s = env.reset(key[None])
    obs, rew, done = [], [], []
    for _ in range(T):
        key, k = jr.split(key)
        s = env.step(s, jr.uniform(k, (env.action_size,), -1, 1)[None])
        obs.append(s.obs[0].numpy())
        rew.append(s.reward[0].item())
        done.append(s.done[0].item())
    return np.stack(obs), np.array(rew, np.float32), np.array(done, np.float32)


def test_golden_trajectory():
    """tests/golden/po_envs_seed7.npz's 20-step AntTag window, seed for seed."""
    data = np.load(os.path.join(GOLDEN, "po_envs_seed7.npz"))
    env = create("ant_tag", episode_length=100, auto_reset=False, batch_size=1, device="cpu")
    obs, rew, done = _golden_rollout(env, 20)
    np.testing.assert_allclose(obs, data["ant_tag_obs"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(rew, data["ant_tag_rew"], rtol=0, atol=1e-3)
    np.testing.assert_array_equal(done, data["ant_tag_done"])


def test_golden_events_window():
    """The 120-step event window (tools/gen_golden.py: tag_radius=8.0,
    episode length 30, naive randomized autoreset) — tags, truncations and
    resets all fire inside it."""
    data = np.load(os.path.join(GOLDEN, "po_envs_events_seed7.npz"))
    env = create("ant_tag", episode_length=30, randomized_autoreset=True, batch_size=1,
                 tag_radius=8.0, device="cpu")
    obs, rew, done = _golden_rollout(env, 120)
    assert done.sum() > 0 and (rew == 1.0).any()
    np.testing.assert_array_equal(done, data["ant_tag_done"])
    np.testing.assert_allclose(rew, data["ant_tag_rew"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(obs, data["ant_tag_obs"], rtol=0, atol=1e-3)
