"""The port's AntHeavenHell, AntGather and AntMaze replaying recorded
trajectories, on the CPU.

The goldens (tests/golden/: the 20-step window of po_envs_seed7.npz and the
120-step event windows of po_envs_events_seed7.npz, single env, seed 7, as
tools/gen_golden.py records them) and the committed fixtures
(tests/fixtures/: po-brax's reference dumps and the JAX package's own) go
through `create(...)` at batch 1 on the port's plain step, held at the
cross-implementation gate of tests/test_replay_fixtures.py: obs and reward
1e-3, `done` equal, reset obs 1e-5.
"""

import json
import os

import numpy as np
import pytest
import torch

from pobrax_tpu_torch import random as jr
from pobrax_tpu_torch.envs import create
from tests.test_torch_ant_tag import _golden_rollout
from tests.test_torch_po_envs import EVENT_SPECS, NAMES

HERE = os.path.dirname(__file__)


@pytest.mark.parametrize("name", ["ant_heavenhell", "ant_gather"])
def test_golden_trajectory(name):
    """tests/golden/po_envs_seed7.npz's 20-step window, seed for seed."""
    data = np.load(os.path.join(HERE, "golden", "po_envs_seed7.npz"))
    env = create(name, episode_length=100, auto_reset=False, batch_size=1, device="cpu")
    obs, rew, done = _golden_rollout(env, 20)
    np.testing.assert_allclose(obs, data[f"{name}_obs"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(rew, data[f"{name}_rew"], rtol=0, atol=1e-3)
    np.testing.assert_array_equal(done, data[f"{name}_done"])


@pytest.mark.parametrize("name", NAMES)
def test_golden_events_window(name):
    """The 120-step event window (tools/gen_golden.py): goal entries, gather
    catches and teleports, truncations and naive randomized autoresets all
    fire inside it."""
    data = np.load(os.path.join(HERE, "golden", "po_envs_events_seed7.npz"))
    kwargs, episode_length = EVENT_SPECS[name]
    env = create(name, episode_length=episode_length, randomized_autoreset=True, batch_size=1,
                 device="cpu", **kwargs)
    obs, rew, done = _golden_rollout(env, 120)
    assert done.sum() > 0
    np.testing.assert_array_equal(done, data[f"{name}_done"])
    np.testing.assert_allclose(rew, data[f"{name}_rew"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(obs, data[f"{name}_obs"], rtol=0, atol=1e-3)


FIXTURES = ["ref_ant_heavenhell_s7.npz", "ant_heavenhell_s7_ours.npz", "ref_ant_gather_s7.npz",
            "ant_gather_s7_ours.npz", "ant_maze_s7_ours.npz"]


def replay_fixture(path, device="cpu"):
    """A fixture's recorded actions through `create(...)` at batch 1: (reset
    obs, obs, reward, done), as tools/compare_reference.py's `run_ours`."""
    fx = np.load(path)
    meta = json.loads(str(fx["meta"]))
    env = create(meta["env"], episode_length=meta["steps"] + 1, auto_reset=False, batch_size=1,
                 device=device)
    s = env.reset(jr.PRNGKey(meta["seed"], device)[None])
    obs0 = s.obs[0].cpu().numpy()
    obs, rew, done = [], [], []
    for a in fx["actions"]:
        s = env.step(s, torch.as_tensor(a, device=device)[None])
        obs.append(s.obs[0])
        rew.append(s.reward[0])
        done.append(s.done[0])
    return (fx, obs0, torch.stack(obs).cpu().numpy(), torch.stack(rew).cpu().numpy(),
            torch.stack(done).cpu().numpy())


@pytest.mark.parametrize("fixture", FIXTURES)
def test_fixture_replay(fixture):
    fx, obs0, obs, rew, done = replay_fixture(os.path.join(HERE, "fixtures", fixture))
    np.testing.assert_allclose(obs0, fx["reset_obs"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(obs, fx["obs"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(rew, fx["reward"], rtol=0, atol=1e-3)
    np.testing.assert_array_equal(done, fx["done"])
