"""The examples' main functions against the JAX examples', on the CPU.

Every `main`, `main_curriculum`, `run_phase` and the carry `main` runs in
both packages with the learners' `train` and the examples' evaluators
replaced by recorders. The two call sequences must be equal: each call's
env stack (wrapper classes and their arguments, the core env's class, its
radius / sensor / catch arguments, substeps and dt), `num_timesteps` and
every other keyword, the evaluators' arguments (bound to their signatures,
defaults applied). The JAX examples read their knobs from the environment
(some at import: the JAX module is reloaded under the environment and again
after); the port's read them at the call. A recorded path under a test's
own directory is compared relative to it. This costs no training.

Then one real `main_curriculum` in the port at 8 envs, one epoch a phase:
the three phases resume one checkpoint (epochs 1 -> 2 -> 3). And the
carry script's resume dir, seeded from the GRU-SAC export, restores the
export's parameters; `visualize` draws the frames JAX's draws (to the
page's 4 decimals); `rollout_demo`'s two paths run.
"""

import functools
import importlib
import inspect
import json
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import examples.train_ant_gather_rnn as jgather
import examples.train_ant_maze_rnn as jmaze
import examples.train_ant_tag as jtag
import examples.train_ant_tag_rnn as jtag_rnn
import examples.train_ant_tag_sac_rnn as jtag_sac
import examples.train_ant_tag_sac_rnn_carry as jcarry
import examples.train_heavenhell_rnn as jhh
import examples.train_heavenhell_sac_rnn as jhh_sac
import examples.train_masked_ant as jmasked_ant
import examples.train_masked_pendulum as jpendulum
import examples.train_ppo as jtrain_ppo
import examples.train_sac as jtrain_sac
import examples.train_sac_rnn_pendulum as jsac_pendulum
import examples.visualize as jvisualize
import pobrax_tpu.training.ppo as jppo
import pobrax_tpu.training.ppo_rnn as jrnn
import pobrax_tpu.training.sac as jsac
import pobrax_tpu.training.sac_rnn as jsac_rnn
from pobrax_tpu_torch import eval_tag_checkpoint, interop
from pobrax_tpu_torch import random as jr
from pobrax_tpu_torch.examples import (rollout_demo, train_ant_gather_rnn, train_ant_maze_rnn,
                                       train_ant_tag, train_ant_tag_rnn, train_ant_tag_sac_rnn,
                                       train_ant_tag_sac_rnn_carry, train_heavenhell_rnn,
                                       train_heavenhell_sac_rnn, train_masked_ant,
                                       train_masked_pendulum, train_ppo, train_sac,
                                       train_sac_rnn_pendulum, visualize)
from pobrax_tpu_torch.examples._common import ProgressLog, split_options
from pobrax_tpu_torch.training import checkpoint as ckpt
from pobrax_tpu_torch.training import ppo, ppo_rnn, sac, sac_rnn

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_EXAMPLES = (jtag, jtag_rnn, jtag_sac, jcarry, jhh, jhh_sac, jgather, jmaze, jmasked_ant,
                jpendulum, jsac_pendulum, jtrain_ppo, jtrain_sac)
PORT_EXAMPLES = (train_ant_tag, train_ant_tag_rnn, train_ant_tag_sac_rnn,
                 train_ant_tag_sac_rnn_carry, train_heavenhell_rnn, train_heavenhell_sac_rnn,
                 train_ant_gather_rnn, train_ant_maze_rnn, train_masked_ant,
                 train_masked_pendulum, train_sac_rnn_pendulum, train_ppo, train_sac)
JAX_LEARNERS = {"ppo": jppo, "ppo_rnn": jrnn, "sac": jsac, "sac_rnn": jsac_rnn}
PORT_LEARNERS = {"ppo": ppo, "ppo_rnn": ppo_rnn, "sac": sac, "sac_rnn": sac_rnn}
# what each evaluator's recorder returns
EVALUATORS = {"tag_rate": 0.25, "tag_rate_rnn": 0.5, "outcome_rates": (0.5, 0.25),
              "gather_eval": (2.0, 1.0), "goal_rate_rnn": 0.75, "goal_rate_random": 0.0,
              "eval_policy": {"episode_reward": 1.0, "x_displacement": 0.5},
              "mean_length": 3.0}
CORE_ATTRS = ("visible_radius", "tag_radius", "sensor_range", "bomb_bin_offset", "catch_range",
              "maze_id", "scaling")
WRAPPER_ATTRS = ("coef", "gamma", "bomb_coef", "bomb_cap", "beta", "half_extent", "grid",
                 "decay", "bomb_memory")


def describe(env):
    """[(class name, arguments)] from the outermost wrapper to the core env."""
    chain = []
    while True:
        d = vars(env)
        wrapper = "env" in d
        attrs = {a: _plain(d[a]) for a in (WRAPPER_ATTRS if wrapper else CORE_ATTRS) if a in d}
        if "_mask" in d:
            attrs["mask"] = np.asarray(d["_mask"]).tolist()
        if not wrapper:
            attrs.update(substeps=int(env.sys.config.substeps), dt=float(env.sys.config.dt))
        chain.append((type(env).__name__, attrs))
        if not wrapper:
            return chain
        env = env.env


def _plain(x, root=None):
    if isinstance(x, str):
        return x.replace(root, "<root>") if root else x
    if x is None or isinstance(x, (bool, int, float)):
        return x
    if isinstance(x, np.generic):
        return x.item()
    if isinstance(x, (list, tuple)):
        return [_plain(v, root) for v in x]
    if isinstance(x, dict):
        return {k: _plain(v, root) for k, v in x.items()}
    if hasattr(x, "unwrapped"):
        return describe(x)
    if type(x).__name__ == "Mesh":
        return "<mesh>"
    return "<fn>" if callable(x) else "<obj>"


class _Record:
    """Replaces every learner's `train` and every example's evaluators in one
    package with recorders that log into `self.calls`."""

    def __init__(self, monkeypatch, learners, examples, root, jax_side):
        self.calls, self.root = [], root
        for name, module in learners.items():
            monkeypatch.setattr(module, "train", self._train(f"{name}.train", jax_side))
        self.patch_examples(monkeypatch, examples)

    def patch_examples(self, monkeypatch, examples):
        for module in examples:
            for name, value in EVALUATORS.items():
                if hasattr(module, name):
                    monkeypatch.setattr(module, name,
                                        self._evaluator(name, getattr(module, name), value))

    def _train(self, name, jax_side):
        def train(env, **kwargs):
            self.calls.append((name, {"env": describe(env),
                                      **{k: _plain(v, self.root) for k, v in kwargs.items()}}))
            asz = env.action_size
            if jax_side:
                def inference_fn(params, obs, key, deterministic=False):
                    return jnp.zeros(obs.shape[:-1] + (asz,))
            else:
                def inference_fn(params, obs, key, deterministic=False):
                    return torch.zeros(obs.shape[:-1] + (asz,), device=obs.device)
            return inference_fn, "PARAMS", []
        return train

    def _evaluator(self, name, fn, value):
        sig = inspect.signature(fn)

        def evaluator(*args, **kwargs):
            bound = sig.bind(*args, **kwargs)
            bound.apply_defaults()
            self.calls.append((name, {k: _plain(v, self.root)
                                      for k, v in bound.arguments.items()}))
            return value
        return evaluator


@pytest.fixture
def both(monkeypatch, tmp_path):
    """(JAX recorder, port recorder, JAX root, port root); JAX runs in its
    root, where its docs/ is."""
    jroot, proot = tmp_path / "jax", tmp_path / "port"
    (jroot / "docs").mkdir(parents=True)
    proot.mkdir()
    monkeypatch.chdir(jroot)
    jrec = _Record(monkeypatch, JAX_LEARNERS, JAX_EXAMPLES, str(jroot), True)
    prec = _Record(monkeypatch, PORT_LEARNERS, PORT_EXAMPLES, str(proot), False)
    return jrec, prec, jroot, proot


def _reloaded(monkeypatch, module, request, **environ):
    """`module` re-imported under `environ` (its knobs are read at import),
    and re-imported again once the test has restored the environment."""
    for k, v in environ.items():
        monkeypatch.setenv(k, v)
    request.addfinalizer(lambda: importlib.reload(module))
    return importlib.reload(module)


def _same(jrec, prec, n_train):
    assert jrec.calls == prec.calls
    assert sum(name.endswith(".train") for name, _ in jrec.calls) == n_train


@pytest.mark.parametrize("case", ["train_ant_tag", "train_ant_tag_rnn", "curriculum"])
def test_ant_tag_mains(both, monkeypatch, case):
    jrec, prec, jroot, proot = both
    if case == "train_ant_tag":
        jtag.main(10_000, 16)
        train_ant_tag.main(10_000, 16, device="cpu", out=str(proot / "a.json"))
        _same(jrec, prec, 1)
    elif case == "train_ant_tag_rnn":
        jtag_rnn.main(10_000, 16)
        train_ant_tag_rnn.main(10_000, 16, device="cpu", out=str(proot / "a.json"))
        _same(jrec, prec, 1)
    else:
        monkeypatch.setenv("TAG_SEED", "3")
        monkeypatch.setenv("TAG_OUT", str(jroot / "tag.json"))
        jtag_rnn.main_curriculum(16, str(jroot / "ckpt"))
        monkeypatch.setenv("TAG_OUT", str(proot / "tag.json"))
        train_ant_tag_rnn.main_curriculum(16, str(proot / "ckpt"), device="cpu")
        _same(jrec, prec, 3)
        with open(proot / "tag.json") as f:
            got = json.load(f)
        with open(jroot / "tag.json") as f:
            assert got == json.load(f)


@pytest.mark.parametrize("phase", [0, 3])
def test_ant_tag_sac_rnn_run_phase(both, phase):
    jrec, prec, jroot, proot = both
    jtag_sac.run_phase(phase, 16, str(jroot / "ckpt"))
    train_ant_tag_sac_rnn.run_phase(phase, 16, str(proot / "ckpt"), device="cpu",
                                    out=str(proot / "p.json"))
    _same(jrec, prec, 1)
    assert len(jrec.calls) == 5  # 4 tag rates


def test_ant_tag_sac_rnn_carry(both, monkeypatch):
    jrec, prec, jroot, proot = both
    monkeypatch.setattr(jcarry, "PHASE0", os.path.join(ROOT, jcarry.PHASE0))
    jcarry.main(0.3, 2, 16, str(jroot / "ckpt"))
    train_ant_tag_sac_rnn_carry.main(0.3, 2, 16, str(proot / "ckpt"), device="cpu",
                                     out=str(proot / "c.json"))
    _same(jrec, prec, 1)
    # the seeded resume dir restores the committed phase-0 parameters
    step = proot / "ckpt" / train_ant_tag_sac_rnn_carry.PHASE0_STEP
    learner, want, _ = eval_tag_checkpoint.load(eval_tag_checkpoint.SAC_NPZ, "cpu", sac=True)
    got = ckpt.restore(str(step), learner.init(jr.PRNGKey(1)))
    assert got.epochs == want.epochs > 0
    assert (interop.params_checksum(interop.params_to_numpy(got.params))
            == ckpt.load_npz(eval_tag_checkpoint.SAC_NPZ)["params_sha256"])


@pytest.mark.parametrize("substeps", [10, 8])
def test_heavenhell_mains(both, monkeypatch, substeps):
    jrec, prec, jroot, proot = both
    monkeypatch.setattr(jhh, "SUBSTEPS", substeps)
    monkeypatch.setenv("HH_SUBSTEPS", str(substeps))
    jhh.main(10_000, 16)
    train_heavenhell_rnn.main(10_000, 16, device="cpu", out=str(proot / "h.json"))
    _same(jrec, prec, 1)
    assert len(jrec.calls) == (4 if substeps == 10 else 5)
    if substeps == 10:
        jhh_sac.main(10_000, 16)
        train_heavenhell_sac_rnn.main(10_000, 16, device="cpu", out=str(proot / "s.json"))
        _same(jrec, prec, 2)


@pytest.mark.parametrize("recipe", ["default", "bombmem02", "dealiased"])
def test_gather_main_curriculum(both, monkeypatch, request, recipe):
    jrec, prec, jroot, proot = both
    environ = {"default": {},
               "bombmem02": {"GATHER_CURRICULUM": "14:400,6:800,6:1000",
                             "GATHER_NOVELTY": "0.25,0.25,0", "GATHER_BOMB_MEMORY": "0.2",
                             "GATHER_SEED": "1"},
               "dealiased": {"GATHER_DEALIASED": "1", "GATHER_BOMB_COEF": "0.3",
                             "GATHER_NOVELTY": "0.1"}}[recipe]
    module = _reloaded(monkeypatch, jgather, request, **environ)
    jrec.patch_examples(monkeypatch, [module])  # the reload redefined its evaluator
    monkeypatch.setenv("GATHER_OUT", str(jroot / "g.json"))
    module.main_curriculum(16, str(jroot / "ckpt"))
    knobs = train_ant_gather_rnn.gather_knobs({**environ, "GATHER_OUT": str(proot / "g.json")})
    train_ant_gather_rnn.main_curriculum(16, str(proot / "ckpt"), knobs=knobs, device="cpu")
    _same(jrec, prec, len(knobs.curriculum))
    with open(proot / "g.json") as f:
        got = json.load(f)
    with open(jroot / "g.json") as f:
        assert got == json.load(f)
    assert os.path.basename(train_ant_gather_rnn.curriculum_out(knobs)) == {
        "default": "learning_gather_rnn_curriculum.json",
        "bombmem02": "learning_gather_rnn_curriculum_novelty_anneal_bombmem_seed1.json",
        "dealiased": "learning_gather_rnn_curriculum_dealiased_bomb_novelty.json"}[recipe]


@pytest.mark.parametrize("variant", ["bomb", "mask"])
def test_gather_main(both, monkeypatch, variant):
    jrec, prec, jroot, proot = both
    monkeypatch.setenv("GATHER_GAMMA", "0.99")
    jgather.main(variant, 10_000, 16)
    train_ant_gather_rnn.main(variant, 10_000, 16, out=str(proot / "g.json"), device="cpu")
    _same(jrec, prec, 1)


def test_maze_main(both, monkeypatch):
    jrec, prec, jroot, proot = both
    monkeypatch.setenv("MAZE_SEED", "2")
    monkeypatch.setenv("MAZE_OUT", str(jroot / "m.json"))
    jmaze.main(10_000, 16, str(jroot / "ckpt"))
    monkeypatch.setenv("MAZE_OUT", str(proot / "m.json"))
    train_ant_maze_rnn.main(10_000, 16, str(proot / "ckpt"), device="cpu")
    _same(jrec, prec, 1)
    with open(proot / "m.json") as f:
        got = json.load(f)
    with open(jroot / "m.json") as f:
        assert got == json.load(f)


def test_masked_mains(both):
    jrec, prec, jroot, proot = both
    jmasked_ant.main(10_000, 16)
    train_masked_ant.main(10_000, 16, device="cpu", out=str(proot / "a.json"))
    _same(jrec, prec, 3)
    jpendulum.main(10_000)
    train_masked_pendulum.main(10_000, device="cpu", out=str(proot / "p.json"))
    _same(jrec, prec, 6)
    for path in (jroot / "docs" / "learning_masked_pendulum.json", proot / "p.json"):
        with open(path) as f:
            assert json.load(f)["gru_masked"] == EVALUATORS["mean_length"]
    jsac_pendulum.main(10_000)
    train_sac_rnn_pendulum.main(10_000, device="cpu", out=str(proot / "p.json"))
    _same(jrec, prec, 7)
    with open(proot / "p.json") as f:
        got = json.load(f)
    with open(jroot / "docs" / "learning_masked_pendulum.json") as f:
        assert got == json.load(f)


def test_train_ppo_and_train_sac(both):
    jrec, prec, jroot, proot = both
    jtrain_ppo.main("fast", 10_000)
    out = train_ppo.main("fast", 10_000, device="cpu", out=str(proot / "fast_eval.html"))
    jtrain_sac.main("fast", 10_000)
    train_sac.main("fast", 10_000, device="cpu")
    _same(jrec, prec, 2)
    pages = [open(p).read() for p in (jroot / "fast_eval.html", out)]
    frames = [re.search(r"const FRAMES\s*=\s*(.*?);\n", p, re.DOTALL).group(1) for p in pages]
    assert frames[0] == frames[1]  # the zero policy's 301 frames of `fast`


def test_main_curriculum_resumes_across_phases(monkeypatch, tmp_path):
    """A real curriculum in the port: 8 envs, one epoch a phase; the
    evaluations at 4 episodes of 5 steps."""
    monkeypatch.setattr(train_ant_tag_rnn, "tag_rate_rnn",
                        functools.partial(train_ant_tag_rnn.tag_rate_rnn, episodes=4,
                                          episode_length=5))
    saves = []
    save_step = ckpt.save_step

    def spy(root, step, ts, mesh=None):
        saves.append((step, ts.epochs))
        return save_step(root, step, ts, mesh)

    monkeypatch.setattr(ckpt, "save_step", spy)
    per_epoch = 32 * 8 * 6
    curriculum = tuple((r, (i + 1) * per_epoch) for i, r in enumerate((20.0, 6.0, 4.0)))
    det = train_ant_tag_rnn.main_curriculum(8, str(tmp_path / "ckpt"), curriculum, seed=0,
                                            device="cpu", out=str(tmp_path / "t.json"))
    assert saves == [(per_epoch, 1), (2 * per_epoch, 2), (3 * per_epoch, 3)]
    assert sorted(os.listdir(tmp_path / "ckpt")) == [f"step_{s:012d}" for s, _ in saves]
    with open(tmp_path / "t.json") as f:
        record = json.load(f)
    assert record["true_tag_rate_det"] == det and 0 <= det <= 1
    assert record["curriculum"] == [list(p) for p in curriculum]


class _Cut(Exception):
    """A call cut short."""


@pytest.mark.parametrize("cut_at", ["phase_1_end", "inside_phase_2"])
def test_curriculum_resumes_a_cut_run(monkeypatch, tmp_path, cut_at):
    """`--curriculum --checkpoint-dir D` at 8 envs (the recipe's unroll cut to
    one control step), cut and run again; `--partial` between the calls says
    where the cut run stands (in phase 2, at radius 6). The replays run 4
    episodes of one control step.

    `phase_1_end`: one epoch a phase, cut after phase 1. The second call
    resumes from phase 1's step dir, trains phases 2 and 3, and every step dir
    equals an uncut call's bit for bit, as do the curve, the phase-end replays
    and the rates; `calls` says which call trained what. The call without the
    flag empties the directory first (no `progress.jsonl` survives) and,
    since save points and logs change nothing in training, ends at the same
    state.

    `inside_phase_2`: two epochs a phase and a save every epoch, cut right
    after phase 2's first epoch is saved; the second call finishes phase 2,
    replays its end and crosses into phase 3. The env and hidden state restart
    on resume, so the run it equals bit for bit, step dir by step dir, is one
    whose first call ends at the same step dir without a cut (a curriculum
    whose last phase ends there). Each phase end is logged once, the curve's
    steps rise with no repeat, and `calls` says which call trained what."""
    inside = cut_at == "inside_phase_2"
    monkeypatch.setitem(train_ant_tag_rnn.RECIPE, "unroll_length", 1)
    monkeypatch.setattr(train_ant_tag_rnn, "tag_rate_rnn",
                        functools.partial(train_ant_tag_rnn.tag_rate_rnn, episodes=4,
                                          episode_length=1))
    per_epoch = train_ant_tag_rnn.steps_per_epoch(8)
    assert per_epoch == 8 * 1 * 6
    per_phase = (2 if inside else 1) * per_epoch
    curriculum = tuple((r, (i + 1) * per_phase) for i, r in enumerate((20.0, 6.0, 4.0)))
    monkeypatch.setattr(train_ant_tag_rnn, "CURRICULUM", curriculum)
    if inside:
        monkeypatch.setattr(train_ant_tag_rnn, "RESUME_CHECKPOINT_EVERY", per_epoch)
    every = per_epoch if inside else per_phase  # the save points
    steps = [f"step_{s:012d}" for s in range(every, 3 * per_phase + 1, every)]
    cut_steps = per_phase + (per_epoch if inside else 0)

    def run(name, *flag):
        out = str(tmp_path / f"{name}.json")
        train_ant_tag_rnn.cli(["--curriculum", "8", *flag, "--device", "cpu", "--out", out])
        with open(out) as f:
            return json.load(f)

    def listing(d):
        return sorted(os.listdir(d))

    def states(d):
        return [torch.load(os.path.join(d, s, "state.pt"), weights_only=True) for s in steps]

    cut, whole = tmp_path / "cut", tmp_path / "whole"
    train, save_step = ppo_rnn.train, ckpt.save_step
    calls = []

    def cut_train(*args, **kwargs):
        calls.append(kwargs["num_timesteps"])
        if len(calls) == 2:
            raise _Cut()
        return train(*args, **kwargs)

    def cut_save(root, step, ts, mesh=None):
        path = save_step(root, step, ts, mesh)
        if step == cut_steps:
            raise _Cut()
        return path

    if inside:
        monkeypatch.setattr(ckpt, "save_step", cut_save)
    else:
        monkeypatch.setattr(ppo_rnn, "train", cut_train)
    with pytest.raises(_Cut):
        run("cut1", "--checkpoint-dir", str(cut))
    assert listing(cut) == ["progress.jsonl", *steps[:steps.index(f"step_{cut_steps:012d}") + 1]]
    partial = run("partial", "--partial", "--checkpoint-dir", str(cut))
    assert (partial["partial"], partial["steps"]) == (True, cut_steps)
    assert partial["epochs"] == cut_steps // per_epoch
    assert partial["training_radius"] == 6.0 and partial["device"] == "cpu"
    assert [e["phase_end"] for e in partial["phase_ends"]] == [20.0]
    assert [(c["from"], c["to"]) for c in partial["calls"]] == [(0, cut_steps)]
    monkeypatch.setattr(ppo_rnn, "train", train)
    monkeypatch.setattr(ckpt, "save_step", save_step)
    resumed = run("cut2", "--checkpoint-dir", str(cut))
    if inside:  # the uncut run's first call ends where the cut one was cut
        monkeypatch.setattr(train_ant_tag_rnn, "CURRICULUM",
                            (curriculum[0], (curriculum[1][0], cut_steps)))
        run("whole1", "--checkpoint-dir", str(whole))
        monkeypatch.setattr(train_ant_tag_rnn, "CURRICULUM", curriculum)
    uncut = run("whole", "--checkpoint-dir", str(whole))
    assert listing(cut) == listing(whole) == ["progress.jsonl", *steps]
    for a, b in zip(states(cut), states(whole)):
        assert a["epochs"] == b["epochs"]
        for k in ("params", "opt_state", "normalizer"):
            assert _bits(a[k]) == _bits(b[k]), k
    assert [(c["from"], c["to"]) for c in resumed["calls"]] == [(0, cut_steps),
                                                                 (cut_steps, 3 * per_phase)]
    assert [(c["from"], c["to"]) for c in uncut["calls"]] == (
        [(0, cut_steps), (cut_steps, 3 * per_phase)] if inside else [(0, 3 * per_phase)])
    assert [e["steps"] for e in resumed["curve"]] == list(range(per_epoch, 3 * per_phase + 1,
                                                                per_epoch))
    for k in ("curve", "phase_ends", "true_tag_rate_det", "true_tag_rate_stoch", "curriculum"):
        assert resumed[k] == uncut[k], k
    assert [(e["phase_end"], e["steps"]) for e in resumed["phase_ends"]] == [
        (20.0, per_phase), (6.0, 2 * per_phase)]
    with open(cut / "progress.jsonl") as f:
        log = [json.loads(line) for line in f]
    assert [(e["phase_end"], e["steps"]) for e in log if "phase_end" in e] == [
        (20.0, per_phase), (6.0, 2 * per_phase)]
    assert resumed["device"] == "cpu" and resumed["wall_s"] > 0
    assert (resumed["steps"], resumed["epochs"]) == (3 * per_phase, 3 * per_phase // per_epoch)
    if inside:
        return
    # without the flag: JAX's fresh directory (its default, here `cut`) and record
    monkeypatch.setattr(train_ant_tag_rnn, "run_path", lambda name: str(cut))
    flagless = run("flagless")
    assert listing(cut) == steps
    assert sorted(flagless) == ["curriculum", "hidden_size", "num_envs", "seed",
                                "true_tag_rate_det", "true_tag_rate_stoch"]
    assert flagless["true_tag_rate_det"] == uncut["true_tag_rate_det"]
    for a, b in zip(states(cut), states(whole)):
        assert _bits(a["params"]) == _bits(b["params"])


def _bits(tree):
    """A saved state's tensors as bytes, by key."""
    if isinstance(tree, dict):
        return {k: _bits(v) for k, v in tree.items()}
    return tree.numpy().tobytes() if isinstance(tree, torch.Tensor) else tree


def test_visualize_draws_jax_frames(tmp_path):
    steps = 3
    jvisualize.main("ant_tag", steps, str(tmp_path / "j.html"))
    visualize.main("ant_tag", steps, str(tmp_path / "p" / "t.html"), device="cpu")
    frames = []
    for path in (tmp_path / "j.html", tmp_path / "p" / "t.html"):
        with open(path) as f:
            frames.append(json.loads(re.search(r"const FRAMES\s*=\s*(.*?);\n", f.read(),
                                               re.DOTALL).group(1)))
    assert len(frames[0]) == len(frames[1]) == steps
    for key in ("pos", "rot"):
        np.testing.assert_allclose(np.array([f[key] for f in frames[1]]),
                                   np.array([f[key] for f in frames[0]]), rtol=0, atol=2e-4)


def test_rollout_demo_paths():
    stats = rollout_demo.gym_path("ant_tag", 4, 3, device="cpu")
    # no episode completes in 3 steps: the stats are the empty queues' NaN
    assert set(stats) == {"charts/mean_episodic_return", "charts/mean_discounted_episodic_return",
                          "charts/mean_episodic_length"}
    out = rollout_demo.native_path("ant_tag", 4, 3, device="cpu")
    assert out["env_steps_per_s"] > 0 and np.isfinite(out["mean_reward"])


def _pendulum_learners(monkeypatch, seen, per_epoch=1024 * 32):
    """`ppo.train` and `ppo_rnn.train` replaced by recorders that keep their
    contract with a `checkpoint_dir`: resume from its latest step dir, report
    each epoch after it to `progress_fn`, and save the last epoch's step dir
    (holding only its epoch count); their policies are never called, as
    the evaluator (`mean_length`, `eval_policy`) is replaced too."""

    def train(env, num_timesteps, checkpoint_dir, progress_fn, **kwargs):
        seen.append(dict(kwargs, checkpoint_dir=checkpoint_dir, progress_fn=progress_fn))
        latest = ckpt.latest_step_dir(checkpoint_dir)
        resumed = int(os.path.basename(latest)[len("step_"):]) if latest else 0
        epochs = -(-num_timesteps // per_epoch)
        for e in range(resumed // per_epoch + 1, epochs + 1):
            progress_fn(e * per_epoch, {"mean_reward": float(e)})
        path = os.path.join(checkpoint_dir, f"step_{epochs * per_epoch:012d}")
        os.makedirs(path)
        torch.save({"epochs": epochs}, os.path.join(path, "state.pt"))
        return None, "PARAMS", []

    monkeypatch.setattr(ppo, "train", train)
    monkeypatch.setattr(ppo_rnn, "train", train)
    return per_epoch


MASKED_ANT_RESULT = {"episode_reward": 1.0, "x_displacement": 0.5}


def _masked_ant_stubbed(monkeypatch, seen, evaluations, num_envs=16):
    """The masked ant's learners as `_pendulum_learners` and its evaluator
    as a recorder; -> (per_epoch, its `main` at `num_envs` on the CPU)."""
    monkeypatch.setattr(train_masked_ant, "eval_policy",
                        lambda *a, **k: evaluations.append(a[0]) or dict(MASKED_ANT_RESULT))
    return (_pendulum_learners(monkeypatch, seen, num_envs * 32),
            functools.partial(train_masked_ant.main, num_envs=num_envs, device="cpu"))


@pytest.mark.parametrize("example", ["heavenhell", "pendulum", "maze", "masked_ant"])
def test_mains_resume_from_checkpoint_dir(monkeypatch, tmp_path, example):
    """Each example run twice into one `checkpoint_dir`: the second call,
    with a larger budget, resumes from the first's step dir and trains only
    the rest; the record's `calls` say which call trained which env-steps.
    HeavenHell and the maze train for real at 16 envs, one epoch a call at an
    unroll of 8 (their evaluators at 4 episodes of 5 steps; the maze with its
    recipe's cached autoreset, at MAZE_SEED=1, and then refusing the dir to
    seed 0); the
    pendulum's and the masked ant's learners are `_pendulum_learners`, and
    each of their three arms gets its own subdirectory, `CHECKPOINT_EVERY`
    and `ProgressLog` there; a masked-ant call at a budget its arms cover
    trains and evaluates nothing, and `arm=` trains one arm."""
    root = str(tmp_path / "ckpt")
    if example in ("heavenhell", "maze"):
        dirs = {"": root}
    if example == "heavenhell":
        monkeypatch.setitem(train_heavenhell_rnn.RECIPE, "unroll_length", 8)
        per_epoch = 16 * 8 * 6
        monkeypatch.setattr(train_heavenhell_rnn, "outcome_rates",
                            functools.partial(train_heavenhell_rnn.outcome_rates, episodes=4,
                                              episode_length=5))
        run = functools.partial(train_heavenhell_rnn.main, num_envs=16, device="cpu",
                                checkpoint_dir=root)
    elif example == "maze":
        monkeypatch.setenv("MAZE_SEED", "1")
        for name in ("goal_rate_rnn", "goal_rate_random"):
            monkeypatch.setattr(train_ant_maze_rnn, name,
                                functools.partial(getattr(train_ant_maze_rnn, name), episodes=4,
                                                  episode_length=5))
        assert train_ant_maze_rnn.RECIPE["autoreset_mode"] == "cached"
        monkeypatch.setitem(train_ant_maze_rnn.RECIPE, "epochs_per_call", 1)
        monkeypatch.setitem(train_ant_maze_rnn.RECIPE, "unroll_length", 8)
        per_epoch = 16 * 8 * 6
        run = functools.partial(train_ant_maze_rnn.main, num_envs=16, device="cpu",
                                checkpoint_dir=root)
    elif example == "masked_ant":
        seen, evaluations = [], []
        per_epoch, main = _masked_ant_stubbed(monkeypatch, seen, evaluations)
        dirs = {arm: os.path.join(root, arm) for arm in train_masked_ant.ARMS}
        run = functools.partial(main, checkpoint_dir=root)
    else:
        monkeypatch.setattr(train_masked_pendulum, "mean_length", lambda *a, **k: 3.0)
        seen = []
        per_epoch = _pendulum_learners(monkeypatch, seen)
        dirs = {arm: os.path.join(root, arm) for arm in train_masked_pendulum.ARMS}
        run = functools.partial(train_masked_pendulum.main, device="cpu", checkpoint_dir=root)
    first, second = per_epoch, 2 * per_epoch

    def step_dirs():
        return {arm: sorted(d for d in os.listdir(path) if d.startswith("step_"))
                for arm, path in dirs.items()}

    one = run(first, out=str(tmp_path / "1.json"))
    assert step_dirs() == {arm: [f"step_{first:012d}"] for arm in dirs}
    two = run(first + 1, out=str(tmp_path / "2.json"))
    assert step_dirs() == {arm: [f"step_{first:012d}", f"step_{second:012d}"] for arm in dirs}
    for arm, path in dirs.items():
        assert torch.load(os.path.join(path, f"step_{second:012d}", "state.pt"),
                          weights_only=True)["epochs"] == second // per_epoch
    calls = two["calls"] if example in ("pendulum", "masked_ant") else {"": two["calls"]}
    assert set(calls) == set(dirs)
    for arm_calls in calls.values():
        assert [(c["from"], c["to"], c["card"]) for c in arm_calls] == [(0, first, None),
                                                                         (first, second, None)]
        assert all(c["train_s"] > 0 for c in arm_calls)
    if example == "heavenhell":
        assert [e["steps"] for e in one["curve"]] == list(range(per_epoch, first + 1, per_epoch))
        assert two["curve"][:1] == one["curve"]
        assert [e["steps"] for e in two["curve"]] == list(range(per_epoch, second + 1, per_epoch))
        assert two["wall_s"] == pytest.approx(sum(c["train_s"] for c in two["calls"]))
        assert two["device"] == "cpu"
    elif example == "maze":
        # the record samples every tenth report, as JAX's; the log keeps them all
        assert [e["steps"] for e in one["curve"]] == [per_epoch]
        assert two["curve"] == one["curve"]
        with open(os.path.join(root, "progress.jsonl")) as f:
            log = [json.loads(line) for line in f]
        assert [e["steps"] for e in log if "steps" in e] == [per_epoch, second]
        assert [e.get("seed") for e in log if "call" in e] == [1, 1]
        assert (one["seed"], two["seed"]) == (1, 1)
        assert two["wall_s"] == pytest.approx(sum(c["train_s"] for c in two["calls"]))
        assert two["device"] == "cpu"
        monkeypatch.setenv("MAZE_SEED", "0")  # seed 1's dir: refused before anything trains
        with pytest.raises(ValueError, match="seed"):
            run(3 * per_epoch, out=str(tmp_path / "3.json"))
        assert step_dirs() == {"": [f"step_{first:012d}", f"step_{second:012d}"]}
        assert not os.path.exists(tmp_path / "3.json")
    elif example == "masked_ant":
        assert [(kw["checkpoint_dir"], kw["checkpoint_every"]) for kw in seen] == 2 * [
            (dirs[arm], train_masked_ant.CHECKPOINT_EVERY) for arm in dirs]
        assert len(evaluations) == 6
        assert {k: two[k] for k in ("env", "hidden", "num_timesteps", "num_envs",
                                    "episode_cap", "device")} == {
            "env": "ant", "hidden": ["VELOCITY"], "num_timesteps": first + 1, "num_envs": 16,
            "episode_cap": 1000, "device": "cpu"}
        assert all(two[train_masked_ant.RESULT_KEYS[arm]] == MASKED_ANT_RESULT for arm in dirs)
        for arm, path in dirs.items():  # each arm's log: its seed, recipe and evaluations
            with open(os.path.join(path, "progress.jsonl")) as f:
                log = [json.loads(line) for line in f]
            assert [(e["seed"], e["recipe"]) for e in log if "call" in e] == 2 * [
                (0, {"env": "ant", "num_envs": 16})]
            assert [e["steps"] for e in log if "evaluation" in e] == [first, second]
        # covered and evaluated: a third call trains and evaluates nothing
        three = run(first + 1, out=str(tmp_path / "3.json"))
        assert (len(seen), len(evaluations)) == (6, 6)
        assert three == two
        # one arm alone: a larger budget trains that arm only; no record yet
        alone = run(3 * per_epoch, arm="ff_masked", out=str(tmp_path / "4.json"))
        assert [kw["checkpoint_dir"] for kw in seen[6:]] == [dirs["ff_masked"]]
        assert len(evaluations) == 7 and set(alone) == {"feedforward_masked"}
        assert not os.path.exists(tmp_path / "4.json")
        assert step_dirs()["ff_masked"][-1] == f"step_{3 * per_epoch:012d}"
    else:
        assert [(kw["checkpoint_dir"], kw["checkpoint_every"]) for kw in seen] == 2 * [
            (dirs[arm], train_masked_pendulum.CHECKPOINT_EVERY) for arm in dirs]
        assert all(isinstance(kw["progress_fn"], ProgressLog)
                   and kw["progress_fn"].path == os.path.join(kw["checkpoint_dir"],
                                                              "progress.jsonl") for kw in seen)
        assert two["gru_masked"] == 3.0
    assert split_options(["7", "--checkpoint-dir", "d", "--device", "cpu"],
                         "--checkpoint-dir") == (["7"], "cpu", None, "d")


def test_masked_ant_arm_alone_is_the_three_arm_calls_arm(monkeypatch, tmp_path):
    """The arms that the three-arm call trains after another, each trained
    alone (`arm=`), save the state, bit for bit, that the three-arm call
    saves for them (its first arm, ff_full, runs after nothing there): the
    real learners, 8 envs, one epoch of an unroll cut to 4 (the evaluator is
    a recorder: it is the replay's concern)."""
    monkeypatch.setitem(train_masked_ant.RECIPE, "unroll_length", 4)
    monkeypatch.setattr(train_masked_ant, "eval_policy",
                        lambda *a, **k: dict(MASKED_ANT_RESULT))
    per_epoch = 8 * 4
    run = functools.partial(train_masked_ant.main, per_epoch, 8, device="cpu")
    three = run(checkpoint_dir=str(tmp_path / "three"), out=str(tmp_path / "three.json"))
    assert three["calls"]["gru_masked"][0]["to"] == per_epoch
    for arm in train_masked_ant.ARMS[1:]:
        alone = run(checkpoint_dir=str(tmp_path / "alone"), arm=arm,
                    out=str(tmp_path / "alone.json"))
        assert set(alone) == {train_masked_ant.RESULT_KEYS[arm]}
        states = [torch.load(os.path.join(tmp_path, d, arm, f"step_{per_epoch:012d}",
                                          "state.pt"), weights_only=False)
                  for d in ("three", "alone")]
        want, got = (dict(export_leaves(s)) for s in states)
        assert sorted(got) == sorted(want) and len(want) > 10, arm
        for k, w in want.items():
            assert got[k].dtype == w.dtype and got[k].tobytes() == w.tobytes(), (arm, k)
    assert not os.path.exists(tmp_path / "alone.json")  # ff_full's dir is empty there


def export_leaves(tree, path=()):
    """(path, numpy array) of every tensor or number in a saved state."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from export_leaves(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from export_leaves(v, path + (str(i),))
    elif hasattr(tree, "__dataclass_fields__"):
        yield from export_leaves({f: getattr(tree, f) for f in tree.__dataclass_fields__}, path)
    else:
        value = tree.detach().cpu().numpy() if torch.is_tensor(tree) else np.asarray(tree)
        yield "/".join(path), value


@pytest.mark.parametrize("other", ["seed", "env", "num_envs"])
def test_masked_ant_refuses_another_runs_dir(monkeypatch, tmp_path, other):
    """A masked-ant checkpoint dir trained at MASKED_SEED 0 on `ant` at 16
    envs is refused, before any arm trains and with its dirs left as they
    were, by a call at another seed, env or envs."""
    seen, evaluations = [], []
    per_epoch, main = _masked_ant_stubbed(monkeypatch, seen, evaluations)
    root = str(tmp_path / "ckpt")
    main(per_epoch, checkpoint_dir=root, out=str(tmp_path / "1.json"))
    before = {arm: sorted(os.listdir(os.path.join(root, arm))) for arm in train_masked_ant.ARMS}
    kwargs = {"num_envs": 32} if other == "num_envs" else {}
    if other == "seed":
        monkeypatch.setenv("MASKED_SEED", "1")
    if other == "env":
        monkeypatch.setenv("MASKED_ENV", "humanoid")
    with pytest.raises(ValueError, match="seed 1" if other == "seed" else "recipe"):
        main(2 * per_epoch, checkpoint_dir=root, out=str(tmp_path / "2.json"), **kwargs)
    assert len(seen) == 3 and len(evaluations) == 3
    assert {arm: sorted(os.listdir(os.path.join(root, arm)))
            for arm in train_masked_ant.ARMS} == before
    assert not os.path.exists(tmp_path / "2.json")


def test_progress_log_merges_calls(tmp_path):
    """A call cut after its last step dir: the next call's log drops the
    reports past that dir, and `curve` and `calls` join what the calls kept."""
    root = str(tmp_path / "ckpt")
    log = ProgressLog(root, "card A")
    for steps in (10, 20, 30):
        log(steps, {"mean_reward": steps / 10})
    os.makedirs(os.path.join(root, f"step_{20:012d}"))  # the cut call saved at 20
    log = ProgressLog(root, "card B")
    assert [e["steps"] for e in log.curve()] == [10, 20]
    for steps in (30, 40):
        log(steps, {"mean_reward": -steps / 10})
    assert log.curve() == [{"steps": 10, "mean_reward": 1.0}, {"steps": 20, "mean_reward": 2.0},
                           {"steps": 30, "mean_reward": -3.0},
                           {"steps": 40, "mean_reward": -4.0}]
    calls = log.calls()
    assert [(c["from"], c["to"], c["card"]) for c in calls] == [(0, 20, "card A"),
                                                                 (20, 40, "card B")]
    assert all(c["train_s"] > 0 for c in calls)
    os.makedirs(os.path.join(root, f"step_{40:012d}"))
    ProgressLog(root, "card C")  # a call that trains nothing more is left out of `calls`
    assert [(c["from"], c["to"]) for c in ProgressLog(root, None).calls()] == [(0, 20), (20, 40)]


@pytest.mark.parametrize("before", ["another_seed", "no_log"])
def test_progress_log_refuses_another_seeds_dir(tmp_path, before):
    """A log opened for a seed refuses a dir whose log names another seed,
    and a dir of step dirs that no call of its seed saved (one trained before
    its log named seeds), and leaves the dir as it was."""
    root = str(tmp_path / "ckpt")
    if before == "another_seed":
        ProgressLog(root, None, seed=0)(20, {"mean_reward": 1.0})
    os.makedirs(os.path.join(root, f"step_{20:012d}"))
    log_path = os.path.join(root, "progress.jsonl")
    kept = open(log_path).read() if before == "another_seed" else None
    with pytest.raises(ValueError, match="seed 1"):
        ProgressLog(root, None, seed=1)
    assert (open(log_path).read() if os.path.exists(log_path) else None) == kept
    # the dir's own seed resumes it; a log that names no seed opens any dir
    if before == "another_seed":
        assert [e["steps"] for e in ProgressLog(root, None, seed=0).curve()] == [20]
    else:
        assert ProgressLog(root, None).curve() == []
