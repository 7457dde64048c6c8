"""The AntMaze GRU-PPO policy the port trained on the H100 at
examples/train_ant_maze_rnn.py's recipe (400M env-steps, 2048 envs, cached
autoreset, MAZE_SEED=0), carried back into the JAX package, on the CPU.

  * pobrax_tpu_torch/checkpoints/ant_maze_rnn_400M_torch.npz (written by
    `pobrax_tpu_torch.tools.export_run_checkpoint --maze` from the run's
    last step dir) loads through `eval_checkpoint.load("maze_port")` with
    its checksum equal, and `interop.training_state_to_numpy` of the loaded
    state gives the file's arrays back bit for bit; the export tool with
    `name="maze"` writes the same entries from a step dir the port saved;
  * one GRU policy step, deterministic and stochastic, of the port against
    JAX's `ppo_rnn` inference on the carried parameters, from one seeded JAX
    reset, one nonzero hidden state and one key, within 1e-5;
  * the port-trained policy in JAX's own env: examples/train_ant_maze_rnn's
    `goal_rate_rnn`, 8 episodes of 1000 control steps at action_repeat 6,
    deterministic, reset seed 0, with JAX's GRU inference, meets MIN_GOALS;
  * each seed's committed progress log holds its record's calls and curve;
  * `eval_checkpoint.evaluate("maze_port")` runs `goal_rate_rnn` det and
    stoch both at reset seed 0 (the example's).
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import examples.train_ant_maze_rnn as jmaze
from pobrax_tpu.envs import HAI_ACTION_REPEAT
from pobrax_tpu.envs import _envs as jenvs
from pobrax_tpu.envs import wrappers as jw
from pobrax_tpu.training import ppo_rnn as jrnn
from pobrax_tpu_torch import eval_checkpoint, interop
from pobrax_tpu_torch import random as jr
from pobrax_tpu_torch.envs import _envs
from pobrax_tpu_torch.examples import train_ant_maze_rnn
from pobrax_tpu_torch.tools import curve_levels, export_run_checkpoint
from pobrax_tpu_torch.training import checkpoint as ckpt

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECORD = os.path.join(ROOT, "pobrax_tpu_torch", "docs", "learning_ant_maze_rnn.json")
HIDDEN, EPISODES = 128, 8
# The policy's deterministic goal rate on the H100 over 256 episodes was
# 1.000 (pobrax_tpu_torch/docs/learning_ant_maze_rnn.json). 256 of 256 bounds
# the rate below only by the rule of three, p >= 1 - 3/256 = 0.988 (95%). At
# that p, 8 episodes miss 0.09 on average with a binomial spread of
# sqrt(8 p (1 - p)) = 0.30 episodes; the gate allows 1 miss of 8 (three
# spreads above the mean; 2 or more come with probability 0.37%), since
# JAX's closed loop parts from the port's within a few control steps. Eight
# episodes, not sixteen: JAX's scan of 1000 control steps takes ~41 s for 8
# on the CPU and ~67 s for 16.
MIN_GOALS = 7


@functools.lru_cache(maxsize=None)
def _pair():
    """(JAX inference fn, JAX (normalizer, params), port learner, port
    state, the npz's entries), loaded once per test process."""
    learner, ts, same = eval_checkpoint.load("maze_port", device="cpu")
    assert same
    tree = ckpt.load_npz(eval_checkpoint.npz_path("maze_port"))
    jenv = jw.VmapWrapper(jw.EpisodeWrapper(jw.ActionRepeatWrapper(
        jenvs["ant_maze"](), HAI_ACTION_REPEAT), 1000, 1), batch_size=8)
    jl = jrnn.RNNPPOLearner(jenv, jrnn.RNNPPOConfig(num_envs=8, num_minibatches=8,
                                                    hidden_size=HIDDEN, encoder_sizes=(256,)))
    jts = jl.init(jax.random.PRNGKey(0))
    normalizer = jts.normalizer.replace(**{k: jnp.asarray(v)
                                           for k, v in tree["normalizer"].items()})
    params = jax.tree_util.tree_map(jnp.asarray, tree["params"])
    return jl.make_inference_fn(), (normalizer, params), learner, ts, tree


def _flat(tree):
    return dict(export_run_checkpoint.leaves(tree))


def test_npz_loads_with_its_checksum():
    _, _, learner, ts, tree = _pair()
    assert interop.params_checksum(tree["params"]) == tree["params_sha256"]
    # 400M env-steps in calls of 8 epochs of 2048 x 32 x 6: 128 calls, the last whole
    assert ts.epochs == 1024
    assert os.path.getsize(eval_checkpoint.npz_path("maze_port")) < 2_600_000
    with open(RECORD) as f:
        record = json.load(f)
    assert record["seed"] == 0 and record["num_envs"] == 2048
    assert record["calls"][-1]["to"] == ts.epochs * 2048 * 32 * HAI_ACTION_REPEAT


@pytest.mark.parametrize("seed", [0, 1])
def test_progress_log_is_the_records_curve(seed):
    """Each seed's committed progress log (seed 0's beside its npz, seed 1's
    beside its record) holds the record's calls and, every tenth report, its
    curve, at the record's seed."""
    docs = os.path.dirname(RECORD)
    record, log = {
        0: (RECORD, eval_checkpoint.npz_path("maze_port")[:-len(".npz")] + ".progress.jsonl"),
        1: (os.path.join(docs, "learning_ant_maze_rnn_seed1.json"),
            os.path.join(docs, "learning_ant_maze_rnn_seed1.progress.jsonl"))}[seed]
    with open(record) as f:
        record = json.load(f)
    run = curve_levels.read(log)
    assert record["seed"] == seed and record["num_timesteps"] == 400_000_000
    assert record["curve"] == run["curve"][::10] and record["calls"] == run["calls"]
    assert run["curve"][-1]["steps"] == 1024 * 2048 * 32 * HAI_ACTION_REPEAT
    with open(log) as f:
        assert {json.loads(line).get("seed") for line in f if '"call"' in line} == {seed}


def test_state_round_trips_bit_for_bit():
    _, _, _, ts, tree = _pair()
    got = _flat(interop.training_state_to_numpy(ts))
    with np.load(eval_checkpoint.npz_path("maze_port"), allow_pickle=False) as z:
        want = {k: z[k] for k in z.files if k != "params_sha256"}
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        assert got[k].tobytes() == w.tobytes(), k


def test_export_tool_writes_a_saved_state(tmp_path):
    """A state the port saved (`save_step`) through the export tool's
    `--maze` and `eval_checkpoint.load("maze_port")`: the same leaves, bit
    for bit."""
    _, _, _, ts, _ = _pair()
    ckpt.save_step(str(tmp_path / "ckpt"), 123, ts)
    out = str(tmp_path / "out" / "maze.npz")
    export_run_checkpoint.export(str(tmp_path / "ckpt"), out, device="cpu", name="maze")
    _, back, same = eval_checkpoint.load("maze_port", device="cpu", npz=out)
    assert same and back.epochs == ts.epochs
    want, got = _flat(interop.training_state_to_numpy(ts)), _flat(
        interop.training_state_to_numpy(back))
    assert sorted(got) == sorted(want)
    assert all(got[k].tobytes() == w.tobytes() for k, w in want.items())


@pytest.mark.parametrize("deterministic", [True, False], ids=["det", "stoch"])
def test_one_policy_step_follows_jax(deterministic):
    jinf, jparams, learner, ts, _ = _pair()
    state = jax.jit(jax.vmap(jenvs["ant_maze"]().reset))(
        jax.random.split(jax.random.PRNGKey(5), 4))
    h = np.random.default_rng(0).normal(0, 0.3, (4, HIDDEN)).astype(np.float32)
    jh, jact = jinf(jparams, jnp.asarray(h), state.obs, jax.random.PRNGKey(3),
                    deterministic=deterministic)
    th, tact = learner.make_inference_fn()(learner.inference_params(ts), torch.as_tensor(h),
                                           torch.as_tensor(np.array(state.obs)),
                                           jr.PRNGKey(3), deterministic=deterministic)
    np.testing.assert_allclose(tact.numpy(), np.asarray(jact), rtol=0, atol=1e-5)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0, atol=1e-5)
    assert float(np.abs(np.asarray(jact)).max()) > 0.1


def test_port_policy_in_jax_env():
    jinf, jparams, _, _, _ = _pair()
    rate = jmaze.goal_rate_rnn(jenvs["ant_maze"](), jinf, jparams, HIDDEN, episodes=EPISODES,
                               seed=0, action_repeat=HAI_ACTION_REPEAT, deterministic=True)
    goals = round(rate * EPISODES)
    print(f"JAX's env, {EPISODES} det episodes at seed 0: {goals} reach the goal")
    assert goals >= MIN_GOALS, rate


def test_evaluate_runs_goal_rate_at_the_examples_seeds(monkeypatch):
    _, _, learner, ts, _ = _pair()
    calls = []

    def recorder(core, inference_fn, params, hidden_size, episodes, seed, action_repeat,
                 deterministic):
        assert hidden_size == HIDDEN and type(core) is type(_envs["ant_maze"](device="cpu"))
        calls.append((episodes, seed, action_repeat, deterministic))
        return 0.5 + 0.25 * deterministic

    monkeypatch.setattr(eval_checkpoint, "goal_rate_rnn", recorder)
    got = eval_checkpoint.evaluate("maze_port", learner, ts, episodes=7)
    assert calls == [(7, 0, HAI_ACTION_REPEAT, True), (7, 0, HAI_ACTION_REPEAT, False)]
    assert got == {"det_goal_rate": 0.75, "stoch_goal_rate": 0.5}
    assert eval_checkpoint.CHECKPOINTS["maze_port"][:2] == ("ant_maze",
                                                           "ant_maze_rnn_400M_torch.npz")
    assert train_ant_maze_rnn.HIDDEN == HIDDEN
