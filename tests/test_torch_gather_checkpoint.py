"""The AntGather GRU-PPO policy the port trained on the H100 with
examples/train_ant_gather_rnn.py's sensor-range curriculum (14 m to 400M,
then the true 6 m to 800M env-steps; 2048 envs, cached autoreset,
GATHER_SEED=0, `curriculum --checkpoint-dir`), carried back into the JAX
package, on the CPU.

  * pobrax_tpu_torch/checkpoints/ant_gather_rnn_800M_torch.npz (written by
    `pobrax_tpu_torch.tools.export_run_checkpoint --gather` from the run's
    last step dir) loads through `eval_checkpoint.load("gather_port")` with
    its checksum equal, at the run's last epoch, and
    `interop.training_state_to_numpy` of the loaded state gives the file's
    arrays back bit for bit; the export tool with `name="gather"` writes the
    same entries from a step dir the port saved;
  * each seed's record and committed progress log agree: the log's calls,
    its curve every tenth report, its phase end, its seed;
  * one GRU policy step, deterministic and stochastic, of the port against
    JAX's `ppo_rnn` inference on the carried parameters, from one seeded JAX
    reset, one nonzero hidden state and one key, within 1e-5;
  * the port-trained policy in JAX's own true AntGather env:
    examples/train_ant_gather_rnn's `gather_eval`, EPISODES episodes of 1000
    control steps at action_repeat 6, deterministic, reset seed 0, with JAX's
    GRU inference, catches at least MIN_APPLES apples an episode;
  * `eval_checkpoint.evaluate("gather_port")` runs `gather_eval` det and
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

import examples.train_ant_gather_rnn as jgather
from pobrax_tpu.envs import HAI_ACTION_REPEAT
from pobrax_tpu.envs import _envs as jenvs
from pobrax_tpu.envs import wrappers as jw
from pobrax_tpu.training import ppo_rnn as jrnn
from pobrax_tpu_torch import eval_checkpoint, interop
from pobrax_tpu_torch import random as jr
from pobrax_tpu_torch.envs import _envs
from pobrax_tpu_torch.examples import train_ant_gather_rnn
from pobrax_tpu_torch.tools import curve_levels, export_run_checkpoint
from pobrax_tpu_torch.training import checkpoint as ckpt

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DOCS = os.path.join(ROOT, "pobrax_tpu_torch", "docs")
RECORDS = {0: os.path.join(DOCS, "learning_gather_rnn_curriculum.json"),
           1: os.path.join(DOCS, "learning_gather_rnn_curriculum_seed1.json")}
LOGS = {0: eval_checkpoint.npz_path("gather_port")[:-len(".npz")] + ".progress.jsonl",
        1: RECORDS[1][:-len(".json")] + ".progress.jsonl"}
HIDDEN, EPISODES = 128, 8
PHASE_1_END, FINAL_STEPS, FINAL_EPOCHS = 402_653_184, 802_160_640, 2040
# The gate on the mean apples an episode of EPISODES det episodes in JAX's
# env. On the H100 the policy's det apples over reset seeds 0-7 (256
# episodes each, pobrax_tpu_torch/docs/learning_gather_rnn_curriculum_seeds.jsonl)
# had a mean of MEAN_8 and a standard deviation of the seed means of SD_8; an
# episode's own spread is then about SD_8 * sqrt(256) = SD_EPISODE. A mean of
# EPISODES episodes spreads by SD_EPISODE / sqrt(EPISODES) = 0.85; the gate
# sits three such spreads under MEAN_8 (3.26, a chance of about 0.1% to fall
# under it), rounded down, since JAX's closed loop parts from the port's
# within a few control steps. A uniform random policy catches 1.23 apples an
# episode (docs/LEARNING.md). Eight episodes, not more: gather's episodes
# never end early, and JAX's scan of 1000 control steps takes ~17 s for four
# on the CPU, ~23 s for eight.
MEAN_8, SD_8 = 5.8135, 0.1508
SD_EPISODE = 2.41
MIN_APPLES = 3.25


@functools.lru_cache(maxsize=None)
def _pair():
    """(JAX inference fn, JAX (normalizer, params), port learner, port
    state, the npz's entries), loaded once per test process."""
    learner, ts, same = eval_checkpoint.load("gather_port", device="cpu")
    assert same
    tree = ckpt.load_npz(eval_checkpoint.npz_path("gather_port"))
    jenv = jw.VmapWrapper(jw.EpisodeWrapper(jw.ActionRepeatWrapper(
        jenvs["ant_gather"](), HAI_ACTION_REPEAT), 1000, 1), batch_size=8)
    jl = jrnn.RNNPPOLearner(jenv, jrnn.RNNPPOConfig(num_envs=8, num_minibatches=8,
                                                    hidden_size=HIDDEN, encoder_sizes=(256,)))
    jts = jl.init(jax.random.PRNGKey(0))
    normalizer = jts.normalizer.replace(**{k: jnp.asarray(v)
                                           for k, v in tree["normalizer"].items()})
    params = jax.tree_util.tree_map(jnp.asarray, tree["params"])
    return jl.make_inference_fn(), (normalizer, params), learner, ts, tree


def _flat(tree):
    return dict(export_run_checkpoint.leaves(tree))


def _record(seed):
    with open(RECORDS[seed]) as f:
        return json.load(f)


def test_npz_loads_with_its_checksum():
    _, _, learner, ts, tree = _pair()
    assert interop.params_checksum(tree["params"]) == tree["params_sha256"]
    # phase 1: 128 calls of 8 epochs of 2048 x 32 x 6; phase 2: 127 more, the last whole
    assert ts.epochs == FINAL_EPOCHS
    assert os.path.getsize(eval_checkpoint.npz_path("gather_port")) < 2_600_000
    record = _record(0)
    assert record["seed"] == 0 and record["num_envs"] == 2048
    assert (record["epochs"], record["steps"]) == (FINAL_EPOCHS, FINAL_STEPS)
    assert record["calls"][-1]["to"] == ts.epochs * 2048 * 32 * HAI_ACTION_REPEAT


@pytest.mark.parametrize("seed", [0, 1])
def test_progress_log_is_the_records_curve(seed):
    """Each seed's committed progress log (seed 0's beside its npz, seed 1's
    beside its record) holds the record's calls, phase end and, every tenth
    report, its curve, at the record's seed and the unchanged recipe; the
    calls chain from 0 to the end on a named card."""
    record = _record(seed)
    run = curve_levels.read(LOGS[seed])
    assert record["seed"] == seed and record["curriculum"] == [[14.0, 400_000_000],
                                                               [6.0, 800_000_000]]
    assert (record["bomb_coef"], record["bomb_memory"], record["novelty_beta"],
            record["dealiased_sensor"]) == (0.0, 0.0, [0.0], False)
    assert record["curve"] == run["curve"][::10] and record["calls"] == run["calls"]
    assert run["curve"][-1]["steps"] == FINAL_STEPS
    assert [c["from"] for c in record["calls"]] == [0] + [c["to"] for c in record["calls"][:-1]]
    assert all(c["card"].startswith("NVIDIA") and "W" in c["card"] for c in record["calls"])
    assert record["wall_s"] == pytest.approx(sum(c["train_s"] for c in record["calls"]))
    with open(LOGS[seed]) as f:
        log = [json.loads(line) for line in f]
    assert {e.get("seed") for e in log if "call" in e} == {seed}
    ends = [e for e in log if "phase_end" in e]
    assert [(e["phase_end"], e["steps"]) for e in ends] == [(14.0, PHASE_1_END)]
    assert record["phase_ends"] == ends


def test_state_round_trips_bit_for_bit():
    _, _, _, ts, tree = _pair()
    got = _flat(interop.training_state_to_numpy(ts))
    with np.load(eval_checkpoint.npz_path("gather_port"), allow_pickle=False) as z:
        want = {k: z[k] for k in z.files if k != "params_sha256"}
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        assert got[k].tobytes() == w.tobytes(), k


def test_export_tool_writes_a_saved_state(tmp_path):
    """A state the port saved (`save_step`) through the export tool's
    `--gather` and `eval_checkpoint.load("gather_port")`: the same leaves,
    bit for bit."""
    _, _, _, ts, _ = _pair()
    ckpt.save_step(str(tmp_path / "ckpt"), 123, ts)
    out = str(tmp_path / "out" / "gather.npz")
    export_run_checkpoint.export(str(tmp_path / "ckpt"), out, device="cpu", name="gather")
    _, back, same = eval_checkpoint.load("gather_port", device="cpu", npz=out)
    assert same and back.epochs == ts.epochs
    want, got = _flat(interop.training_state_to_numpy(ts)), _flat(
        interop.training_state_to_numpy(back))
    assert sorted(got) == sorted(want)
    assert all(got[k].tobytes() == w.tobytes() for k, w in want.items())


@functools.lru_cache(maxsize=None)
def _reset():
    """One seeded JAX reset of 4 AntGather envs."""
    return jax.jit(jax.vmap(jenvs["ant_gather"]().reset))(
        jax.random.split(jax.random.PRNGKey(5), 4))


@pytest.mark.parametrize("deterministic", [True, False], ids=["det", "stoch"])
def test_one_policy_step_follows_jax(deterministic):
    jinf, jparams, learner, ts, _ = _pair()
    state = _reset()
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
    apples, bombs = jgather.gather_eval(jenvs["ant_gather"](), (jparams, jinf, True),
                                        episodes=EPISODES, seed=0,
                                        action_repeat=HAI_ACTION_REPEAT, hidden_size=HIDDEN)
    print(f"JAX's env, {EPISODES} det episodes at seed 0: apples {apples:.2f} bombs "
          f"{bombs:.2f} an episode")
    assert apples >= MIN_APPLES, (apples, bombs)


def test_evaluate_runs_gather_eval_at_the_examples_seeds(monkeypatch):
    _, _, learner, ts, _ = _pair()
    calls = []

    def recorder(core, act_fn, episodes, seed, action_repeat, hidden_size):
        params, inference_fn, det = act_fn
        assert hidden_size == HIDDEN and type(core) is type(_envs["ant_gather"](device="cpu"))
        calls.append((episodes, seed, action_repeat, det))
        return 6.0 + det, 3.0

    monkeypatch.setattr(eval_checkpoint, "gather_eval", recorder)
    got = eval_checkpoint.evaluate("gather_port", learner, ts, episodes=7)
    assert calls == [(7, 0, HAI_ACTION_REPEAT, True), (7, 0, HAI_ACTION_REPEAT, False)]
    assert got == {"det_apples": 7.0, "det_bombs": 3.0, "det_net": 4.0,
                   "stoch_apples": 6.0, "stoch_bombs": 3.0, "stoch_net": 3.0}
    assert eval_checkpoint.CHECKPOINTS["gather_port"] == ("ant_gather",
                                                          "ant_gather_rnn_800M_torch.npz",
                                                          500, (0, 0))
    assert train_ant_gather_rnn.HIDDEN == HIDDEN


def test_curve_levels_windows():
    """`curve_levels` reads JAX's two curriculum records' `mean_reward` over
    its WINDOWS (the figures PERF.md compares the port's with) and the
    port's, on the records' every-tenth grids."""
    assert curve_levels.WINDOWS == ((286, 381), (695, 790))
    got = [curve_levels.summary(os.path.join(ROOT, "docs", name))
           for name in ("learning_gather_rnn_curriculum.json",
                        "learning_gather_rnn_curriculum_seed1.json")]
    assert [[round(v, 4) for v in g["window_means"].values()] for g in got] == [
        [0.094, 0.0932], [0.0957, 0.0964]]
    assert curve_levels.window_means([{"steps": 1_000_000, "mean_reward": 1.0}]) == {
        "286:381": None, "695:790": None}
    for seed in (0, 1):
        port = curve_levels.summary(RECORDS[seed])
        assert list(port["window_means"]) == ["286:381", "695:790"]
        assert all(0.0 < v < 1.0 for v in port["window_means"].values())
