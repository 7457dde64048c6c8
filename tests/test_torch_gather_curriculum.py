"""The port's resumable AntGather curriculum (`train_ant_gather_rnn
curriculum --checkpoint-dir D`) on the CPU, at 8 envs on the recipe's cached
autoreset, the unroll cut to one control step, one or two epochs a call
and two grad steps an epoch; the true-env evaluations at 4 episodes of one
control step.

A run cut and run again ends, save by save, where an uncut one does, bit
for bit; each phase end is logged once; a dir of one GATHER_SEED refuses
the other before anything trains, and a dir cut inside a phase that the
novelty wrapper trains is refused. Without the flag the example empties its
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


def _small(monkeypatch, curriculum, epochs_per_call=2):
    """The recipe at one control step an epoch, two epochs a call (unless
    given) and two grad steps an epoch, the knobs' curriculum replaced
    (GATHER_SEED still read from the environment), the evaluations at 4
    episodes of one control step."""
    monkeypatch.setitem(gather.RECIPE, "unroll_length", 1)
    monkeypatch.setitem(gather.RECIPE, "epochs_per_call", epochs_per_call)
    monkeypatch.setitem(gather.RECIPE, "num_minibatches", 2)
    monkeypatch.setitem(gather.RECIPE, "num_update_epochs", 1)
    knobs = gather.gather_knobs
    monkeypatch.setattr(gather, "gather_knobs", lambda environ=None: dataclasses.replace(
        knobs(environ), curriculum=curriculum))
    monkeypatch.setattr(gather, "gather_eval", functools.partial(gather.gather_eval, episodes=4,
                                                                 episode_length=1))


def _run(tmp_path, name, *flag):
    out = str(tmp_path / f"{name}.json")
    gather.cli(["curriculum", "8", *flag, "--device", "cpu", "--out", out])
    with open(out) as f:
        return json.load(f)


def _step(steps):
    return f"step_{steps:012d}"


PER_CALL = 8 * 1 * 6 * 2  # 8 envs, one control step of 6, two epochs


@pytest.mark.parametrize("cut_at", ["phase_1_end", "inside_phase_2", "bombmem02"])
def test_gather_curriculum_resumes_a_cut_run(monkeypatch, tmp_path, cut_at):
    """`phase_1_end`: one call of one epoch a phase (14 m, then 6 m), the
    first call cut after phase 1; the second resumes from phase 1's step
    dir, trains phase 2, and every state saved equals an uncut call's bit
    for bit, as do the
    curve, the phase-end replay and the results; `calls` says which call
    trained what. The call without the flag empties the directory first (no
    `progress.jsonl` survives), writes JAX's keys only and, since save points
    and logs change nothing in training, ends at the same state.

    `inside_phase_2`: two calls a phase and a save every call, cut right
    after phase 2's first call is saved; the second call finishes phase 2.
    The envs, the cached autoreset's clock and the hidden state restart on
    resume, so the run it equals bit for bit is one whose first call ends at
    the same step dir without a cut (its last phase's `train` given that
    budget; the knobs stay the recipe's, which the dir's log holds).

    `bombmem02`: the bomb-memory recipe's three phases (14 m, 6 m, 6 m;
    GATHER_NOVELTY=0.25,0.25,0 and GATHER_BOMB_MEMORY=0.2) at one epoch a
    call, one call for
    each of phases 1 and 2 and two for phase 3, the first call cut as phase
    3's second call reports, before its save (the bonus off, bomb memory
    on). The novelty wrapper's grids carry across a phase's episodes, so
    each phase saves at its end alone: the cut call leaves phase 2's step
    dir, the second call trains phase 3 again from its start, and the run
    equals one uncut call bit for bit. Each phase end is logged once.

    A dir keeps the last two saves."""
    inside = cut_at == "inside_phase_2"
    epc = 2 if inside else 1
    per_call = PER_CALL // 2 * epc
    if cut_at == "bombmem02":
        monkeypatch.setenv("GATHER_NOVELTY", "0.25,0.25,0")
        monkeypatch.setenv("GATHER_BOMB_MEMORY", "0.2")
        curriculum = ((14.0, per_call), (6.0, 2 * per_call), (6.0, 4 * per_call))
    else:
        per_phase = (2 if inside else 1) * per_call
        curriculum = ((14.0, per_phase), (6.0, 2 * per_phase))
    end = curriculum[-1][1]
    _small(monkeypatch, curriculum, epc)
    # the steps saved: every call's, or each phase's end where the wrapper trains
    steps = ([total for _, total in curriculum] if cut_at == "bombmem02"
             else list(range(per_call, end + 1, per_call)))
    cut_steps = {"phase_1_end": curriculum[0][1], "inside_phase_2": 3 * per_call,
                 "bombmem02": end}[cut_at]
    cut, whole = tmp_path / "cut", tmp_path / "whole"
    train, save_step = ppo_rnn.train, ckpt.save_step
    saved = {str(cut): [], str(whole): []}
    calls = []

    def recording_save(root, step, ts, mesh=None):
        path = save_step(root, step, ts, mesh)
        state = torch.load(os.path.join(path, "state.pt"), weights_only=True)
        saved[root].append((step, state["epochs"], *(
            _bits(state[k]) for k in ("params", "opt_state", "normalizer"))))
        if inside and root == str(cut) and step == cut_steps and not calls:
            calls.append(step)
            raise _Cut()
        return path

    def cut_train(*args, **kwargs):
        calls.append(kwargs["num_timesteps"])
        if cut_at == "phase_1_end" and len(calls) == 2:
            raise _Cut()
        if cut_at == "bombmem02" and kwargs["num_timesteps"] == end:
            progress = kwargs["progress_fn"]

            def cut_progress(steps, metrics):
                progress(steps, metrics)
                if steps == cut_steps:
                    raise _Cut()

            kwargs = {**kwargs, "progress_fn": cut_progress}
        return train(*args, **kwargs)

    def listing(d):
        return sorted(os.listdir(d))

    monkeypatch.setattr(ckpt, "save_step", recording_save)
    if not inside:
        monkeypatch.setattr(ppo_rnn, "train", cut_train)
    with pytest.raises(_Cut):
        _run(tmp_path, "cut1", "--checkpoint-dir", str(cut))
    kept = [s for s in steps if s <= cut_steps][-2:] if inside else [curriculum[-2][1]]
    assert listing(cut) == ["progress.jsonl", *map(_step, kept)]
    assert not os.path.exists(tmp_path / "cut1.json")
    monkeypatch.setattr(ppo_rnn, "train", train)
    resumed = _run(tmp_path, "cut2", "--checkpoint-dir", str(cut))
    if inside:  # the uncut run's first call ends where the cut one was cut
        monkeypatch.setattr(ppo_rnn, "train", lambda *args, **kwargs: train(
            *args, **{**kwargs, "num_timesteps": min(kwargs["num_timesteps"], cut_steps)}))
        _run(tmp_path, "whole1", "--checkpoint-dir", str(whole))
        monkeypatch.setattr(ppo_rnn, "train", train)
    uncut = _run(tmp_path, "whole", "--checkpoint-dir", str(whole))
    monkeypatch.setattr(ckpt, "save_step", save_step)
    assert [s[0] for s in saved[str(whole)]] == steps
    assert saved[str(cut)] == saved[str(whole)]
    assert listing(cut) == listing(whole) == ["progress.jsonl", *map(_step, steps[-2:])]
    resumed_from = cut_steps if inside else curriculum[-2][1]
    assert [(c["from"], c["to"]) for c in resumed["calls"]] == [(0, resumed_from),
                                                                 (resumed_from, end)]
    assert [(c["from"], c["to"]) for c in uncut["calls"]] == (
        [(0, cut_steps), (cut_steps, end)] if inside else [(0, end)])
    for k in ("curve", "phase_ends", "results", "curriculum", "epochs", "steps",
              "novelty_beta", "bomb_memory"):
        assert resumed[k] == uncut[k], k
    assert (resumed["steps"], resumed["epochs"]) == (end, end // (per_call // epc))
    if cut_at == "bombmem02":
        assert (resumed["novelty_beta"], resumed["bomb_memory"]) == ([0.25, 0.25, 0.0], 0.2)
    assert resumed["device"] == "cpu" and resumed["wall_s"] > 0
    assert sorted(resumed) == sorted(JAX_KEYS + ["calls", "device", "epochs", "phase_ends",
                                                 "steps", "wall_s"])
    # each phase end but the last, logged once, with the true env's apples and bombs
    with open(cut / "progress.jsonl") as f:
        log = [json.loads(line) for line in f]
    ends = [e for e in log if "phase_end" in e]
    assert [(e["phase_end"], e["steps"]) for e in ends] == [
        (srange, total) for srange, total in curriculum[:-1]]
    assert all(sorted(e) == ["det_apples", "det_bombs", "phase_end", "steps", "stoch_apples",
                             "stoch_bombs"] for e in ends)
    assert resumed["phase_ends"] == ends
    # the record's curve is every tenth report of the log's, as JAX's of its history
    reports = [e["steps"] for e in log if "mean_reward" in e]
    assert reports == list(range(per_call, end + 1, per_call))
    assert [e["steps"] for e in resumed["curve"]] == reports[::10]
    if cut_at != "phase_1_end":
        return
    # without the flag: JAX's fresh directory (its default, here `cut`) and record
    monkeypatch.setattr(gather, "run_path", lambda name: str(cut))
    flagless = _run(tmp_path, "flagless")
    assert listing(cut) == list(map(_step, steps))
    assert sorted(flagless) == JAX_KEYS
    assert flagless["results"] == uncut["results"] and flagless["curve"] == uncut["curve"]
    for s in steps:
        a, b = (torch.load(os.path.join(d, _step(s), "state.pt"), weights_only=True)
                for d in (cut, whole))
        assert _bits(a["params"]) == _bits(b["params"])


def test_gather_curriculum_refuses_a_dir_cut_inside_a_wrapped_phase(monkeypatch, tmp_path):
    """A dir whose latest step dir lies inside a phase that the novelty
    wrapper trains (here phase 1 of the bomb-memory recipe) raises before
    anything trains or is written; the same step inside a phase of the plain
    recipe resumes (`test_gather_curriculum_resumes_a_cut_run[inside_phase_2]`)."""
    root = tmp_path / "ckpt"
    monkeypatch.setenv("GATHER_NOVELTY", "0.25,0.25,0")
    monkeypatch.setenv("GATHER_BOMB_MEMORY", "0.2")
    _small(monkeypatch, ((14.0, PER_CALL), (6.0, 3 * PER_CALL), (6.0, 4 * PER_CALL)))
    ProgressLog(str(root), None, seed=0, recipe=gather.gather_knobs().recipe(8))(
        2 * PER_CALL, {"mean_reward": 1.0})
    os.makedirs(root / _step(2 * PER_CALL))
    kept = (root / "progress.jsonl").read_text()

    def train(*args, **kwargs):
        raise AssertionError("trained from inside a wrapped phase")

    monkeypatch.setattr(ppo_rnn, "train", train)
    with pytest.raises(ValueError, match=f"inside phase 1 .*past {PER_CALL}"):
        _run(tmp_path, "inside", "--checkpoint-dir", str(root))
    assert (root / "progress.jsonl").read_text() == kept
    assert sorted(os.listdir(root)) == ["progress.jsonl", _step(2 * PER_CALL)]
    assert not os.path.exists(tmp_path / "inside.json")


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
