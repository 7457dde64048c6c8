"""The port's resumable AntGather curriculum (`train_ant_gather_rnn
curriculum --checkpoint-dir D`) on the CPU, at 8 envs on the recipe's cached
autoreset, the unroll cut to one control step, two epochs a call and two
grad steps an epoch; the true-env evaluations at 4 episodes of one control
step.

A run cut and run again ends, step dir by step dir, where an uncut one does,
bit for bit; each phase end is logged once; a dir of one GATHER_SEED refuses
the other before anything trains. Without the flag the example empties its
dir and writes JAX's keys (`tests/test_torch_examples_mains.py` holds that
record equal to JAX's, key for key).
"""

import dataclasses
import functools
import json
import os

import pytest
import torch

from pobrax_tpu_torch.examples import train_ant_gather_rnn as gather
from pobrax_tpu_torch.examples._common import ProgressLog
from pobrax_tpu_torch.training import checkpoint as ckpt
from pobrax_tpu_torch.training import ppo_rnn

torch.set_num_threads(1)

JAX_KEYS = ["bomb_coef", "bomb_memory", "curriculum", "curve", "dealiased_sensor",
            "hidden_size", "novelty_beta", "num_envs", "results", "seed"]


class _Cut(Exception):
    """A call cut short."""


def _bits(tree):
    """A saved state's tensors as bytes, by key."""
    if isinstance(tree, dict):
        return {k: _bits(v) for k, v in tree.items()}
    return tree.numpy().tobytes() if isinstance(tree, torch.Tensor) else tree


def _small(monkeypatch, curriculum, every=None):
    """The recipe at one control step an epoch, two epochs a call and two
    grad steps an epoch, the knobs' curriculum replaced (GATHER_SEED still
    read from the environment), the evaluations at 4 episodes of one control
    step."""
    monkeypatch.setitem(gather.RECIPE, "unroll_length", 1)
    monkeypatch.setitem(gather.RECIPE, "epochs_per_call", 2)
    monkeypatch.setitem(gather.RECIPE, "num_minibatches", 2)
    monkeypatch.setitem(gather.RECIPE, "num_update_epochs", 1)
    knobs = gather.gather_knobs
    monkeypatch.setattr(gather, "gather_knobs", lambda environ=None: dataclasses.replace(
        knobs(environ), curriculum=curriculum))
    monkeypatch.setattr(gather, "gather_eval", functools.partial(gather.gather_eval, episodes=4,
                                                                 episode_length=1))
    if every is not None:
        monkeypatch.setattr(gather, "RESUME_CHECKPOINT_EVERY", every)


def _run(tmp_path, name, *flag):
    out = str(tmp_path / f"{name}.json")
    gather.cli(["curriculum", "8", *flag, "--device", "cpu", "--out", out])
    with open(out) as f:
        return json.load(f)


@pytest.mark.parametrize("cut_at", ["phase_1_end", "inside_phase_2"])
def test_gather_curriculum_resumes_a_cut_run(monkeypatch, tmp_path, cut_at):
    """`phase_1_end`: one call a phase (14 m, then 6 m), the first call cut
    after phase 1; the second resumes from phase 1's step dir, trains phase 2,
    and every step dir equals an uncut call's bit for bit, as do the curve,
    the phase-end replay and the results; `calls` says which call trained
    what. The call without the flag empties the directory first (no
    `progress.jsonl` survives), writes JAX's keys only and, since save points
    and logs change nothing in training, ends at the same state.

    `inside_phase_2`: two calls a phase and a save every call, cut right
    after phase 2's first call is saved; the second call finishes phase 2.
    The envs, the cached autoreset's clock and the hidden state restart on
    resume, so the run it equals bit for bit is one whose first call ends at
    the same step dir without a cut (its last phase's `train` given that
    budget; the knobs stay the recipe's, which the dir's log holds)."""
    inside = cut_at == "inside_phase_2"
    per_call = 8 * 1 * 6 * 2  # 8 envs, one control step of 6, two epochs
    per_phase = (2 if inside else 1) * per_call
    curriculum = ((14.0, per_phase), (6.0, 2 * per_phase))
    _small(monkeypatch, curriculum, per_call if inside else None)
    every = per_call if inside else per_phase  # the save points
    steps = [f"step_{s:012d}" for s in range(every, 2 * per_phase + 1, every)]
    cut_steps = per_phase + (per_call if inside else 0)
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

    def listing(d):
        return sorted(os.listdir(d))

    def states(d):
        return [torch.load(os.path.join(d, s, "state.pt"), weights_only=True) for s in steps]

    if inside:
        monkeypatch.setattr(ckpt, "save_step", cut_save)
    else:
        monkeypatch.setattr(ppo_rnn, "train", cut_train)
    with pytest.raises(_Cut):
        _run(tmp_path, "cut1", "--checkpoint-dir", str(cut))
    assert listing(cut) == ["progress.jsonl", *steps[:steps.index(f"step_{cut_steps:012d}") + 1]]
    assert not os.path.exists(tmp_path / "cut1.json")
    monkeypatch.setattr(ppo_rnn, "train", train)
    monkeypatch.setattr(ckpt, "save_step", save_step)
    resumed = _run(tmp_path, "cut2", "--checkpoint-dir", str(cut))
    if inside:  # the uncut run's first call ends where the cut one was cut
        monkeypatch.setattr(ppo_rnn, "train", lambda *args, **kwargs: train(
            *args, **{**kwargs, "num_timesteps": min(kwargs["num_timesteps"], cut_steps)}))
        _run(tmp_path, "whole1", "--checkpoint-dir", str(whole))
        monkeypatch.setattr(ppo_rnn, "train", train)
    uncut = _run(tmp_path, "whole", "--checkpoint-dir", str(whole))
    assert listing(cut) == listing(whole) == ["progress.jsonl", *steps]
    for a, b in zip(states(cut), states(whole)):
        assert a["epochs"] == b["epochs"]
        for k in ("params", "opt_state", "normalizer"):
            assert _bits(a[k]) == _bits(b[k]), k
    assert [(c["from"], c["to"]) for c in resumed["calls"]] == [(0, cut_steps),
                                                                 (cut_steps, 2 * per_phase)]
    assert [(c["from"], c["to"]) for c in uncut["calls"]] == (
        [(0, cut_steps), (cut_steps, 2 * per_phase)] if inside else [(0, 2 * per_phase)])
    for k in ("curve", "phase_ends", "results", "curriculum", "epochs", "steps"):
        assert resumed[k] == uncut[k], k
    assert (resumed["steps"], resumed["epochs"]) == (2 * per_phase,
                                                     2 * per_phase // (per_call // 2))
    assert resumed["device"] == "cpu" and resumed["wall_s"] > 0
    assert sorted(resumed) == sorted(JAX_KEYS + ["calls", "device", "epochs", "phase_ends",
                                                 "steps", "wall_s"])
    # one phase end, logged once, with the true env's apples and bombs
    with open(cut / "progress.jsonl") as f:
        log = [json.loads(line) for line in f]
    ends = [e for e in log if "phase_end" in e]
    assert [(e["phase_end"], e["steps"]) for e in ends] == [(14.0, per_phase)]
    assert sorted(ends[0]) == ["det_apples", "det_bombs", "phase_end", "steps", "stoch_apples",
                               "stoch_bombs"]
    assert resumed["phase_ends"] == ends
    # the record's curve is every tenth report of the log's, as JAX's of its history
    reports = [e["steps"] for e in log if "mean_reward" in e]
    assert reports == list(range(per_call, 2 * per_phase + 1, per_call))
    assert [e["steps"] for e in resumed["curve"]] == reports[::10]
    if inside:
        return
    # without the flag: JAX's fresh directory (its default, here `cut`) and record
    monkeypatch.setattr(gather, "run_path", lambda name: str(cut))
    flagless = _run(tmp_path, "flagless")
    assert listing(cut) == steps
    assert sorted(flagless) == JAX_KEYS
    assert flagless["results"] == uncut["results"] and flagless["curve"] == uncut["curve"]
    for a, b in zip(states(cut), states(whole)):
        assert _bits(a["params"]) == _bits(b["params"])


OTHER_KNOBS = {  # GATHER_* settings a call may give a dir that the recipe's trained
    "bomb_coef": {"GATHER_BOMB_COEF": "0.5"},
    "novelty": {"GATHER_NOVELTY": "0.02"},
    "bomb_memory": {"GATHER_BOMB_MEMORY": "0.2"},
    "dealiased": {"GATHER_DEALIASED": "1"},
}


@pytest.mark.parametrize("dir_seed,seed,other", [
    pytest.param(0, 1, None, id="0-1"), pytest.param(1, 0, None, id="1-0"),
    *(pytest.param(0, 0, name, id=name) for name in [*OTHER_KNOBS, "curriculum", "num_envs",
                                                     "no_recipe"])])
def test_gather_curriculum_refuses_another_seeds_dir(monkeypatch, tmp_path, dir_seed, seed,
                                                     other):
    """A dir that GATHER_SEED=`dir_seed` trained (its log and a step dir)
    refuses GATHER_SEED=`seed` before anything trains or is written; so
    does a dir of the same seed that another setting of the knobs shaping
    training trained (`other`: a GATHER_* knob, the curriculum, the envs),
    or whose log names no recipe."""
    root = tmp_path / "ckpt"
    curriculum = ((14.0, 96), (6.0, 192))
    _small(monkeypatch, curriculum)
    recipe = gather.gather_knobs({}).recipe(8)
    if other == "curriculum":
        recipe["curriculum"] = ((14.0, 96), (6.0, 288))
    elif other == "num_envs":
        recipe["num_envs"] = 16
    ProgressLog(str(root), None, seed=dir_seed,
                recipe=None if other == "no_recipe" else recipe)(96, {"mean_reward": 1.0})
    os.makedirs(root / f"step_{96:012d}")
    kept = (root / "progress.jsonl").read_text()

    def train(*args, **kwargs):
        raise AssertionError("trained on another run's dir")

    monkeypatch.setattr(ppo_rnn, "train", train)
    monkeypatch.setenv("GATHER_SEED", str(seed))
    for k, v in OTHER_KNOBS.get(other, {}).items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match=f"seed {seed}" if other is None else "recipe"):
        _run(tmp_path, "other", "--checkpoint-dir", str(root))
    assert (root / "progress.jsonl").read_text() == kept
    assert sorted(os.listdir(root)) == ["progress.jsonl", f"step_{96:012d}"]
    assert not os.path.exists(tmp_path / "other.json")


def test_gather_curriculum_resumes_its_own_recipe(monkeypatch, tmp_path):
    """The same seed and knobs resume their dir: the guard refuses nothing
    that the same command repeated would give it, and each call line names
    the recipe."""
    root = tmp_path / "ckpt"
    _small(monkeypatch, ((14.0, 96), (6.0, 192)))
    monkeypatch.setenv("GATHER_BOMB_COEF", "0.5")
    first = _run(tmp_path, "first", "--checkpoint-dir", str(root))
    again = _run(tmp_path, "again", "--checkpoint-dir", str(root))
    assert again["results"] == first["results"] and again["curve"] == first["curve"]
    with open(root / "progress.jsonl") as f:
        calls = [e for e in map(json.loads, f) if "call" in e]
    recipe = json.loads(json.dumps(gather.gather_knobs().recipe(8)))
    assert [(e["call"], e["seed"], e["recipe"]) for e in calls] == [(0, 0, recipe),
                                                                     (192, 0, recipe)]
    assert recipe["bomb_coef"] == 0.5
