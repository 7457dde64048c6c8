"""The committed AntGather and AntMaze checkpoints carried across to the port,
and the evaluators that score them, on the CPU.

  * pobrax_tpu_torch/checkpoints/{ant_gather_rnn_800M,
    ant_gather_rnn_bombmem02_1B, ant_maze_rnn_400M}.npz (written by
    tools/export_torch_checkpoint.py) equal their orbax checkpoints leaf for
    leaf, bit for bit, their stored checksums are the orbax parameters', and
    `eval_checkpoint.load` finds the loaded parameters' checksum equal;
  * one deterministic policy step of each, from JAX's restored state on a
    seeded JAX reset with a nonzero hidden state, within 1e-4 (actions) and
    1e-5 (hidden state);
  * `gather_eval` (random, and the 800M policy det and stoch) and
    `goal_rate_rnn` (the maze policy, det and stoch) equal the JAX
    examples' at 16 episodes of 30 control steps, action_repeat 1 (as in
    tests/test_torch_examples_eval.py), on env arguments under which the
    event happens in some episodes: AntGather with catch_range 3, the
    corridor maze 3 of length 0 at scaling 1.05;
  * `eval_checkpoint.render` writes a well-formed page of the episode.
"""

import importlib.util
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import examples.train_ant_gather_rnn as jgather
import examples.train_ant_maze_rnn as jmaze
from pobrax_tpu.envs import HAI_ACTION_REPEAT
from pobrax_tpu.envs import _envs as jenvs
from pobrax_tpu.envs import wrappers as jw
from pobrax_tpu.training import checkpoint as jckpt
from pobrax_tpu.training import ppo_rnn as jrnn
from pobrax_tpu_torch import eval_checkpoint, interop
from pobrax_tpu_torch.envs import _envs
from pobrax_tpu_torch.examples import train_ant_gather_rnn, train_ant_maze_rnn

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("gather", "gather_bombmem", "maze")
ORBAX = {"gather": "ant_gather_rnn_800M", "gather_bombmem": "ant_gather_rnn_bombmem02_1B",
         "maze": "ant_maze_rnn_400M"}
HIDDEN, EPISODES, LENGTH = 128, 16, 30
GATHER = dict(catch_range=3.0)
MAZE = dict(maze_id=3, length=0, scaling=1.05)


def _export():
    spec = importlib.util.spec_from_file_location(
        "export_torch_checkpoint", os.path.join(ROOT, "tools", "export_torch_checkpoint.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


_LOADED = {}


def _pair(name):
    """(JAX inference fn, JAX params tuple, port learner, port state) of a
    committed checkpoint, loaded once per test process."""
    if name not in _LOADED:
        env_name = eval_checkpoint.CHECKPOINTS[name][0]
        jenv = jw.VmapWrapper(jw.EpisodeWrapper(jw.ActionRepeatWrapper(
            jenvs[env_name](), HAI_ACTION_REPEAT), 1000, 1), batch_size=8)
        cfg = jrnn.RNNPPOConfig(num_envs=8, num_minibatches=8, hidden_size=HIDDEN,
                                encoder_sizes=(256,))
        jl = jrnn.RNNPPOLearner(jenv, cfg)
        path = os.path.join(ROOT, "checkpoints", ORBAX[name])
        jts = jckpt.restore(jckpt.latest_step_dir(path) or path,
                            template=jl.init(jax.random.PRNGKey(0)))
        learner, ts, same = eval_checkpoint.load(name, device="cpu")
        assert same
        _LOADED[name] = (jl.make_inference_fn(), (jts.normalizer, jts.params), learner, ts)
    return _LOADED[name]


@pytest.mark.parametrize("name", NAMES)
def test_npz_equals_the_orbax_checkpoint(name):
    export = _export()
    tree = export.restore(os.path.join(ROOT, "checkpoints", ORBAX[name]))
    want = dict(export.leaves(tree))
    npz = eval_checkpoint.npz_path(name)
    with np.load(npz, allow_pickle=False) as z:
        got = {k: z[k] for k in z.files}
    assert str(got.pop("params_sha256")) == interop.params_checksum(tree["params"])
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        assert got[k].tobytes() == w.tobytes(), k
    assert os.path.getsize(npz) < 2_600_000


@pytest.mark.parametrize("name", NAMES)
def test_one_policy_step_follows_jax(name):
    jinf, jparams, learner, ts = _pair(name)
    jcore = jenvs[eval_checkpoint.CHECKPOINTS[name][0]]()
    state = jax.jit(jax.vmap(jcore.reset))(jax.random.split(jax.random.PRNGKey(5), 4))
    h = np.random.default_rng(0).normal(0, 0.3, (4, HIDDEN)).astype(np.float32)
    jh, jact = jinf(jparams, jnp.asarray(h), state.obs, jax.random.PRNGKey(0), deterministic=True)
    th, tact = learner.make_inference_fn()(learner.inference_params(ts), torch.as_tensor(h),
                                           torch.as_tensor(np.asarray(state.obs)), None,
                                           deterministic=True)
    np.testing.assert_allclose(tact.numpy(), np.asarray(jact), rtol=0, atol=1e-4)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0, atol=1e-5)
    assert float(np.abs(np.asarray(jact)).max()) > 0.1


@pytest.mark.parametrize("policy", ["random", "det", "stoch"])
def test_gather_eval(policy):
    kw = dict(episodes=EPISODES, episode_length=LENGTH, seed=1)
    jcore, core = jenvs["ant_gather"](**GATHER), _envs["ant_gather"](device="cpu", **GATHER)
    if policy == "random":
        want = jgather.gather_eval(jcore, None, **kw)
        got = train_ant_gather_rnn.gather_eval(core, None, **kw)
    else:
        jinf, jparams, learner, ts = _pair("gather")
        det = policy == "det"
        want = jgather.gather_eval(jcore, (jparams, jinf, det), hidden_size=HIDDEN, **kw)
        got = train_ant_gather_rnn.gather_eval(
            core, (learner.inference_params(ts), learner.make_inference_fn(), det),
            hidden_size=HIDDEN, **kw)
    assert 0 < want[0] < 8 and 0 < want[1] < 8  # apples and bombs caught in some episodes
    assert got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("deterministic", [True, False], ids=["det", "stoch"])
def test_goal_rate_rnn(deterministic):
    jinf, jparams, learner, ts = _pair("maze")
    kw = dict(episodes=EPISODES, episode_length=LENGTH, seed=2, deterministic=deterministic)
    want = jmaze.goal_rate_rnn(jenvs["ant_maze"](**MAZE), jinf, jparams, HIDDEN, **kw)
    got = train_ant_maze_rnn.goal_rate_rnn(_envs["ant_maze"](device="cpu", **MAZE),
                                           learner.make_inference_fn(),
                                           learner.inference_params(ts), HIDDEN, **kw)
    assert 0 < want < 1
    assert got == want


def test_render_writes_the_episode(monkeypatch, tmp_path):
    frames = 3
    monkeypatch.setitem(eval_checkpoint.CHECKPOINTS, "maze",
                        eval_checkpoint.CHECKPOINTS["maze"][:2] + (frames,))
    _, _, learner, ts = _pair("maze")
    out = str(tmp_path / "sub" / "maze.html")
    got = eval_checkpoint.render("maze", learner, ts, out)
    assert set(got) == {"goal_reached"}
    with open(out) as f:
        page = f.read()
    found = json.loads(re.search(r"const FRAMES\s*=\s*(.*?);\n", page, re.DOTALL).group(1))
    assert len(found) == frames and page.rstrip().endswith("</html>")
