"""The AntGather GRU-PPO policies the port trained on the H100 with
examples/train_ant_gather_rnn.py's curriculum (2048 envs, cached autoreset,
GATHER_SEED=0, `curriculum --checkpoint-dir`), carried back into the JAX
package, on the CPU; each test runs for both runs in RUNS:

  * `gather_port`: the sensor-range curriculum (14 m to 400M, then the true
    6 m to 800M env-steps), pobrax_tpu_torch/checkpoints/
    ant_gather_rnn_800M_torch.npz;
  * `gather_bombmem_port`: its bomb-memory recipe (14 m to 400M, 6 m to
    800M, 6 m to 1B; novelty bonus 0.25 / 0.25 / 0, bomb memory 0.2), a run
    whose calls were resumed inside phase 2, which restarted the novelty
    wrapper's bomb-cell grid (its records are named for that),
    pobrax_tpu_torch/checkpoints/ant_gather_rnn_bombmem02_cut_in_phase2_1B_torch.npz.

For each:

  * the npz (written by `pobrax_tpu_torch.tools.export_run_checkpoint
    --gather` from the run's last step dir) loads through
    `eval_checkpoint.load(name)` with its checksum equal, at the run's last
    epoch, and `interop.training_state_to_numpy` of the loaded state gives
    the file's arrays back bit for bit; the export tool with `name="gather"`
    writes the same entries from a step dir the port saved;
  * each seed's record and committed progress log agree: the log's calls,
    its curve every tenth report, its phase ends, its seed and the recipe;
  * one GRU policy step, deterministic and stochastic, of the port against
    JAX's `ppo_rnn` inference on the carried parameters, from one seeded JAX
    reset, one nonzero hidden state and one key, within 1e-5;
  * the port-trained policy in JAX's own true AntGather env:
    examples/train_ant_gather_rnn's `gather_eval`, EPISODES episodes of 1000
    control steps at action_repeat 6, deterministic, reset seed 0, with JAX's
    GRU inference, catches at least the run's `min_apples` and at most its
    `max_bombs` an episode; JAX's env and the jitted evaluator are built
    once for the module and take the policy as an argument, so the second
    state costs only its episodes;
  * `eval_checkpoint.evaluate(name)` runs `gather_eval` det and stoch both at
    reset seed 0 (the example's).
"""

import dataclasses
import functools
import json
import os
from typing import Dict, Tuple
from unittest import mock

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
HIDDEN, EPISODES = 128, 12
PER_EPOCH = 2048 * 32 * HAI_ACTION_REPEAT
SPREAD = os.path.join(DOCS, "gather_det_episode_spread.jsonl")
# The gates on the mean apples and bombs an episode of EPISODES det episodes
# in JAX's env. On the H100 each policy's det episodes at reset seeds 0-7
# (256 each, `eval_checkpoint --modes det --seeds 0 .. 7 --spread`, one line
# of SPREAD a policy) had a mean of `mean_8` apples, and within each seed a
# per-episode standard deviation whose root mean square over the 8 seeds is
# `sd`. A mean of EPISODES episodes spreads by sd / sqrt(EPISODES); the
# apples gate sits three such spreads under mean_8 (a chance of about 0.1%
# to fall under it), rounded down to 0.05, and the bombs gate three spreads
# over their mean, rounded up, since JAX's closed loop parts from the
# port's within a few control steps
# (`test_min_apples_is_three_spreads_under_the_seeds_mean`). A uniform
# random policy catches 1.23 apples an episode (docs/LEARNING.md): twelve
# episodes put both apples gates over twice that, where eight would leave
# the bomb-memory state's at 2.45. Gather's episodes never end early, and
# JAX's scan of 1000 control steps takes ~20 s for twelve on the CPU once
# compiled, more under a loaded host.


@dataclasses.dataclass(frozen=True)
class Run:
    """A port-trained gather run: its records by seed (seed 0's state is
    the npz), the recipe they hold, where each phase but the last ends, its
    last step, and the det apples and bombs gates in JAX's env (SPREAD)."""

    records: Dict[int, str]
    seeds_file: str
    curriculum: list
    knobs: Tuple[float, float, list, bool]  # bomb_coef, bomb_memory, novelty_beta, dealiased
    phase_ends: list
    final_epochs: int
    min_apples: float
    max_bombs: float

    @property
    def final_steps(self) -> int:
        return self.final_epochs * PER_EPOCH


def _doc(name):
    return os.path.join(DOCS, name)


RUNS = {
    # phase 1: 128 calls of 8 epochs of 2048 x 32 x 6; phase 2: 127 more, the last whole
    "gather_port": Run(
        {0: _doc("learning_gather_rnn_curriculum.json"),
         1: _doc("learning_gather_rnn_curriculum_seed1.json")},
        _doc("learning_gather_rnn_curriculum_seeds.jsonl"),
        [[14.0, 400_000_000], [6.0, 800_000_000]], (0.0, 0.0, [0.0], False),
        [(14.0, 402_653_184)], 2040, 3.55, 4.85),
    # phase 3: 63 calls more, the last whole; both seeds' calls were resumed
    # inside phase 2, so the records are this run's and not JAX's recipe's
    "gather_bombmem_port": Run(
        {0: _doc("learning_gather_rnn_bombmem02_cut_in_phase2.json"),
         1: _doc("learning_gather_rnn_bombmem02_cut_in_phase2_seed1.json")},
        _doc("learning_gather_rnn_bombmem02_cut_in_phase2_seeds.jsonl"),
        [[14.0, 400_000_000], [6.0, 800_000_000], [6.0, 1_000_000_000]],
        (0.0, 0.2, [0.25, 0.25, 0.0], False),
        [(14.0, 402_653_184), (6.0, 802_160_640)], 2544, 2.95, 4.5),
}
NAMES = list(RUNS)


def _log(name, seed):
    """Seed 0's progress log lies beside its npz, seed 1's beside its record."""
    if seed == 0:
        return eval_checkpoint.npz_path(name)[:-len(".npz")] + ".progress.jsonl"
    return RUNS[name].records[seed][:-len(".json")] + ".progress.jsonl"


@functools.lru_cache(maxsize=None)
def _jax_learner():
    """(JAX's GRU inference fn, a JAX training state at the examples'
    widths), built once per test process."""
    jenv = jw.VmapWrapper(jw.EpisodeWrapper(jw.ActionRepeatWrapper(
        jenvs["ant_gather"](), HAI_ACTION_REPEAT), 1000, 1), batch_size=8)
    jl = jrnn.RNNPPOLearner(jenv, jrnn.RNNPPOConfig(num_envs=8, num_minibatches=8,
                                                    hidden_size=HIDDEN, encoder_sizes=(256,)))
    return jl.make_inference_fn(), jl.init(jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _pair(name):
    """(JAX inference fn, JAX (normalizer, params), port learner, port
    state, the npz's entries) of `name`'s npz, loaded once per test process."""
    learner, ts, same = eval_checkpoint.load(name, device="cpu")
    assert same
    tree = ckpt.load_npz(eval_checkpoint.npz_path(name))
    jinf, jts = _jax_learner()
    normalizer = jts.normalizer.replace(**{k: jnp.asarray(v)
                                           for k, v in tree["normalizer"].items()})
    params = jax.tree_util.tree_map(jnp.asarray, tree["params"])
    return jinf, (normalizer, params), learner, ts, tree


@functools.lru_cache(maxsize=None)
def _jax_det_eval():
    """JAX's `gather_eval` on its true env, EPISODES det episodes at reset
    seed 0, jitted once with the policy's (normalizer, params) an argument.
    `gather_eval` ends in `float()`, which a traced mean refuses: while it is
    traced, `float` in its module is the identity."""
    jinf, _ = _jax_learner()
    core = jenvs["ant_gather"]()

    def run(jparams):
        with mock.patch.object(jgather, "float", lambda x: x, create=True):
            return jgather.gather_eval(core, (jparams, jinf, True), episodes=EPISODES, seed=0,
                                       action_repeat=HAI_ACTION_REPEAT, hidden_size=HIDDEN)

    return jax.jit(run)


def _flat(tree):
    return dict(export_run_checkpoint.leaves(tree))


def _record(name, seed):
    with open(RUNS[name].records[seed]) as f:
        return json.load(f)


@pytest.mark.parametrize("name", NAMES)
def test_npz_loads_with_its_checksum(name):
    run = RUNS[name]
    _, _, learner, ts, tree = _pair(name)
    assert interop.params_checksum(tree["params"]) == tree["params_sha256"]
    assert ts.epochs == run.final_epochs
    assert os.path.getsize(eval_checkpoint.npz_path(name)) < 2_600_000
    record = _record(name, 0)
    assert record["seed"] == 0 and record["num_envs"] == 2048
    assert (record["epochs"], record["steps"]) == (run.final_epochs, run.final_steps)
    assert record["calls"][-1]["to"] == ts.epochs * PER_EPOCH


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("seed", [0, 1])
def test_progress_log_is_the_records_curve(name, seed):
    """Each seed's committed progress log (seed 0's beside its npz, seed 1's
    beside its record) holds the record's calls, phase ends and, every tenth
    report, its curve, at the record's seed and the unchanged recipe; the
    calls chain from 0 to the end on a named card."""
    run = RUNS[name]
    record = _record(name, seed)
    logged = curve_levels.read(_log(name, seed))
    assert record["seed"] == seed and record["curriculum"] == run.curriculum
    assert (record["bomb_coef"], record["bomb_memory"], record["novelty_beta"],
            record["dealiased_sensor"]) == run.knobs
    assert record["curve"] == logged["curve"][::10] and record["calls"] == logged["calls"]
    assert logged["curve"][-1]["steps"] == run.final_steps
    assert [c["from"] for c in record["calls"]] == [0] + [c["to"] for c in record["calls"][:-1]]
    assert all(c["card"].startswith("NVIDIA") and "W" in c["card"] for c in record["calls"])
    assert record["wall_s"] == pytest.approx(sum(c["train_s"] for c in record["calls"]))
    with open(_log(name, seed)) as f:
        log = [json.loads(line) for line in f]
    assert {e.get("seed") for e in log if "call" in e} == {seed}
    ends = [e for e in log if "phase_end" in e]
    assert [(e["phase_end"], e["steps"]) for e in ends] == run.phase_ends
    assert record["phase_ends"] == ends


@pytest.mark.parametrize("name", NAMES)
def test_state_round_trips_bit_for_bit(name):
    _, _, _, ts, tree = _pair(name)
    got = _flat(interop.training_state_to_numpy(ts))
    with np.load(eval_checkpoint.npz_path(name), allow_pickle=False) as z:
        want = {k: z[k] for k in z.files if k != "params_sha256"}
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        assert got[k].tobytes() == w.tobytes(), k


@pytest.mark.parametrize("name", NAMES)
def test_export_tool_writes_a_saved_state(tmp_path, name):
    """A state the port saved (`save_step`) through the export tool's
    `--gather` and `eval_checkpoint.load(name)`: the same leaves, bit for
    bit."""
    _, _, _, ts, _ = _pair(name)
    ckpt.save_step(str(tmp_path / "ckpt"), 123, ts)
    out = str(tmp_path / "out" / "gather.npz")
    export_run_checkpoint.export(str(tmp_path / "ckpt"), out, device="cpu", name="gather")
    _, back, same = eval_checkpoint.load(name, device="cpu", npz=out)
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


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("deterministic", [True, False], ids=["det", "stoch"])
def test_one_policy_step_follows_jax(deterministic, name):
    jinf, jparams, learner, ts, _ = _pair(name)
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


@pytest.mark.parametrize("name", NAMES)
def test_min_apples_is_three_spreads_under_the_seeds_mean(name):
    """Each run's gates from its det episodes at reset seeds 0-7 on the card
    (its line of SPREAD): the apples gate three spreads of an
    EPISODES-episode mean under the mean, rounded down to 0.05, the bombs
    gate three over theirs, rounded up; the per-episode spread is the root
    mean square of the 8 seeds' standard deviations. The same episodes'
    means are the run's `seeds` file's, bit for bit."""
    run = RUNS[name]
    with open(SPREAD) as f:
        line, = [e for e in map(json.loads, f)
                 if e["npz"] == os.path.basename(eval_checkpoint.npz_path(name))]
    with open(run.seeds_file) as f:
        port = json.loads(f.readline())
    assert (line["episodes"], line["checksum_ok"]) == (256, True)
    assert all(line[f"det_{what}_s{s}"] == port[f"det_{what}_s{s}"]
               for what in ("apples", "bombs") for s in range(8))
    gates = []
    for what, side in (("apples", -1), ("bombs", 1)):
        mean = np.mean([line[f"det_{what}_s{s}"] for s in range(8)])
        sd = np.sqrt(np.mean([line[f"det_{what}_sd_s{s}"] ** 2 for s in range(8)]))
        gate = (mean + side * 3 * sd / np.sqrt(EPISODES)) / 0.05
        gates.append((np.floor(gate) if side < 0 else np.ceil(gate)) * 0.05)
    assert (run.min_apples, run.max_bombs) == pytest.approx(tuple(gates))
    assert run.min_apples > 2 * 1.23  # twice a uniform random policy's apples


@pytest.mark.parametrize("name", NAMES)
def test_port_policy_in_jax_env(name):
    _, jparams, _, _, _ = _pair(name)
    apples, bombs = (float(x) for x in _jax_det_eval()(jparams))
    print(f"{name} in JAX's env, {EPISODES} det episodes at seed 0: apples {apples:.2f} "
          f"bombs {bombs:.2f} an episode")
    assert apples >= RUNS[name].min_apples and bombs <= RUNS[name].max_bombs, (apples, bombs)


@pytest.mark.parametrize("name", NAMES)
def test_evaluate_runs_gather_eval_at_the_examples_seeds(monkeypatch, name):
    _, _, learner, ts, _ = _pair(name)
    calls = []

    def recorder(core, act_fn, episodes, seed, action_repeat, hidden_size):
        params, inference_fn, det = act_fn
        assert hidden_size == HIDDEN and type(core) is type(_envs["ant_gather"](device="cpu"))
        calls.append((episodes, seed, action_repeat, det))
        return 6.0 + det, 3.0

    monkeypatch.setattr(eval_checkpoint, "gather_eval", recorder)
    got = eval_checkpoint.evaluate(name, learner, ts, episodes=7)
    assert calls == [(7, 0, HAI_ACTION_REPEAT, True), (7, 0, HAI_ACTION_REPEAT, False)]
    assert got == {"det_apples": 7.0, "det_bombs": 3.0, "det_net": 4.0,
                   "stoch_apples": 6.0, "stoch_bombs": 3.0, "stoch_net": 3.0}
    assert eval_checkpoint.CHECKPOINTS[name] == (
        "ant_gather", os.path.basename(eval_checkpoint.npz_path(name)), 500, (0, 0))
    assert train_ant_gather_rnn.HIDDEN == HIDDEN


@pytest.mark.parametrize("name", NAMES)
def test_evaluate_spread_reads_gather_counts(monkeypatch, name):
    """`--spread`: the same means from `gather_counts`' episodes, with their
    per-episode standard deviations (ddof 1); other envs refuse it."""
    _, _, learner, ts, _ = _pair(name)
    calls = []

    def recorder(core, act_fn, episodes, seed, action_repeat, hidden_size):
        calls.append((episodes, seed, act_fn[2]))
        return torch.tensor([1.0, 2.0, 6.0]), torch.tensor([0.0, 0.0, 3.0])

    monkeypatch.setattr(eval_checkpoint, "gather_counts", recorder)
    got = eval_checkpoint.evaluate(name, learner, ts, episodes=3, seeds=[4], modes=["det"],
                                   spread=True)
    assert calls == [(3, 4, True)]
    assert got == pytest.approx({"det_apples_s4": 3.0, "det_bombs_s4": 1.0, "det_net_s4": 2.0,
                                 "det_apples_sd_s4": np.std([1, 2, 6], ddof=1),
                                 "det_bombs_sd_s4": np.std([0, 0, 3], ddof=1)})
    with pytest.raises(ValueError, match="AntGather"):
        eval_checkpoint.evaluate("maze_port", learner, ts, spread=True)


# JAX's records of each recipe, and their `mean_reward` over curve_levels'
# WINDOWS on the records' every-tenth grids, seed 0 then seed 1
JAX_WINDOWS = {
    "gather_port": (("learning_gather_rnn_curriculum.json",
                     "learning_gather_rnn_curriculum_seed1.json"),
                    [[0.094, 0.0932], [0.0957, 0.0964]]),
    "gather_bombmem_port": (("learning_gather_rnn_curriculum_novelty_anneal_bombmem02.json",
                             "learning_gather_rnn_curriculum_novelty_anneal_bombmem02_seed1.json"),
                            [[0.0283, 0.0339], [0.0399, 0.0357]])}


@pytest.mark.parametrize("name", NAMES)
def test_curve_levels_windows(name):
    """`curve_levels` reads JAX's two records' `mean_reward` over its
    WINDOWS (the figures PERF.md compares the port's with) and the port's,
    on the records' every-tenth grids."""
    assert curve_levels.WINDOWS == ((286, 381), (695, 790))
    files, want = JAX_WINDOWS[name]
    got = [curve_levels.summary(os.path.join(ROOT, "docs", f)) for f in files]
    assert [[round(v, 4) for v in g["window_means"].values()] for g in got] == want
    assert curve_levels.window_means([{"steps": 1_000_000, "mean_reward": 1.0}]) == {
        "286:381": None, "695:790": None}
    for seed in (0, 1):
        port = curve_levels.summary(RUNS[name].records[seed])
        assert list(port["window_means"]) == ["286:381", "695:790"]
        assert all(0.0 < v < 1.0 for v in port["window_means"].values())
