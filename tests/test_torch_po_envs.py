"""The port's AntHeavenHell, AntGather and AntMaze against the JAX package.

For each env: the scene config equals the JAX one field for field (and the
port's copy of `maze_utils` gives JAX's grids and wall segments); `reset`
gives the JAX env's observation and body positions (atol 1e-6) and key for
seeds 0-3; and AntGather's binned sensor on hand-placed objects. The
goldens and fixtures replay in tests/test_torch_po_replay.py, the factory
and wrappers are held against JAX in tests/test_torch_po_wrappers.py.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from pobrax_tpu.envs import maze_utils as j_maze_utils
from pobrax_tpu.envs.ant_gather import AntGatherEnv as JGather
from pobrax_tpu.envs.ant_heavenhell import AntHeavenHellEnv as JHeavenHell
from pobrax_tpu.envs.ant_maze import AntMazeEnv as JMaze
from pobrax_tpu_torch import random as jr
from pobrax_tpu_torch.envs import maze_utils
from pobrax_tpu_torch.envs.ant_gather import AntGatherEnv
from pobrax_tpu_torch.envs.ant_heavenhell import AntHeavenHellEnv
from pobrax_tpu_torch.envs.ant_maze import AntMazeEnv

NAMES = ["ant_heavenhell", "ant_gather", "ant_maze"]
ENVS = {"ant_heavenhell": (JHeavenHell, AntHeavenHellEnv), "ant_gather": (JGather, AntGatherEnv),
        "ant_maze": (JMaze, AntMazeEnv)}
# tools/gen_golden.py's SPECS: event-forcing kwargs, episode length
EVENT_SPECS = {"ant_heavenhell": (dict(visible_radius=9.0), 30),
               "ant_gather": (dict(catch_range=5.0), 30), "ant_maze": (dict(), 40)}


@functools.lru_cache(maxsize=None)
def pair(name):
    """(JAX env, its jitted reset, the port's env on the CPU)."""
    jcls, tcls = ENVS[name]
    jenv = jcls()
    return jenv, jax.jit(jenv.reset), tcls(device="cpu")


@pytest.mark.parametrize("name", NAMES)
def test_configs_equal(name):
    jenv, _, tenv = pair(name)
    assert dataclasses.asdict(jenv._cfg) == dataclasses.asdict(tenv._cfg)
    assert tenv.observation_size == jenv.observation_size


@pytest.mark.parametrize("maze_id", range(11))
def test_maze_utils_copy_equal(maze_id):
    structure = maze_utils.construct_maze(maze_id, 1)
    assert structure == j_maze_utils.construct_maze(maze_id, 1)
    np.testing.assert_array_equal(np.asarray(maze_utils.maze_to_wall_segments(structure, 4.0)),
                                  np.asarray(j_maze_utils.maze_to_wall_segments(structure, 4.0)))
    for a, b in zip(maze_utils.maze_cell_centers(structure, 4.0),
                    j_maze_utils.maze_cell_centers(structure, 4.0)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("name", NAMES)
def test_reset_matches_jax(name, seed):
    _, jreset, tenv = pair(name)
    want = jreset(jax.random.PRNGKey(seed))
    got = tenv.reset(jr.PRNGKey(seed)[None])
    assert got.obs.shape == (1, tenv.observation_size)
    np.testing.assert_allclose(got.obs[0].numpy(), np.asarray(want.obs), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.qp.pos[0].numpy(), np.asarray(want.qp.pos), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(got.info["rng"][0].numpy(),
                                  np.asarray(want.info["rng"]).astype(np.int64))
    for k, v in got.metrics.items():
        assert float(v[0]) == float(want.metrics[k])


def test_gather_sensor_quirks():
    """The binned sensor on hand-placed objects, against JAX's: an object
    behind the ant (bin -1, wrapping to the last slot), two objects in one
    bin (the later one wins), a bomb aliased into an apple bin, and the
    de-aliased diagnostic sensor."""
    for offset in (None, 10):
        jenv, tenv = JGather(bomb_bin_offset=offset), AntGatherEnv(bomb_bin_offset=offset,
                                                                   device="cpu")
        js = jax.jit(jenv.reset)(jax.random.PRNGKey(5))
        rs = np.random.RandomState(1)
        pos = np.asarray(js.qp.pos).copy()
        pos[tenv.objects, :2] = rs.uniform(-6, 6, (tenv.n_objects, 2))
        pos[tenv.objects.start + 3, :2] = pos[tenv.objects.start + 2, :2] + 0.01
        qp = js.qp.replace(pos=pos)
        d = np.linalg.norm(pos[tenv.torso_idx, :2] - pos[tenv.objects, :2], axis=1)
        want = np.asarray(jenv._get_readings(qp, d))
        tqp = tenv.reset(jr.PRNGKey(5)[None]).qp.replace(pos=torch.from_numpy(pos)[None])
        got = tenv._get_readings(tqp, torch.from_numpy(d.astype(np.float32))[None])
        np.testing.assert_allclose(got[0].numpy(), want, rtol=0, atol=1e-6)
        assert (want > 0).sum() >= 3
