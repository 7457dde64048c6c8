"""What the example modules share: the evaluators' env stack, key order and
loop, uniform random actions, where a run's record and checkpoints go, and
the progress log of a run that resumes across calls."""

from __future__ import annotations

import json
import os
import time
from typing import Callable, List, Optional, Sequence

import torch

from pobrax_tpu_torch import random as jr
from pobrax_tpu_torch.envs import wrappers
from pobrax_tpu_torch.envs.base import Env, State
from pobrax_tpu_torch.training import checkpoint as ckpt

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# a run's records and checkpoints (gitignored); the JAX examples write docs/
RUNS = os.path.join(ROOT, "runs")


def run_path(name: str) -> str:
    """`runs/<name>`."""
    return os.path.join(RUNS, name)


def split2(key: torch.Tensor):
    return jr.split(key, 2).unbind(-2)


def uniform_actions(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """`jax.random.uniform(key, shape, minval=-1.0, maxval=1.0)`."""
    return jr.uniform(key, tuple(shape), -1.0, 1.0)


@torch.no_grad()
def run_episodes(env_core: Env, act_fn: Callable, carry, observe: Callable[[State, torch.Tensor],
                                                                         None],
                 episodes: int, episode_length: int, seed: int,
                 action_repeat: int = 1) -> State:
    """The loop of every evaluator of the examples: `episodes` parallel
    episodes of `env_core` under ActionRepeat -> Episode(episode_length) ->
    Vmap, reset from `split(k_reset, episodes)` with `k_reset, key =
    split(PRNGKey(seed))`, then per control step `key, k = split(key)`,
    `carry, action = act_fn(carry, obs, k)`, the env step, and
    `observe(state, alive)` with `alive` the episodes that had not ended
    before this step. It stops once every episode has ended, where no
    evaluator's sums can change any more (the JAX examples scan all
    `episode_length` steps). Returns the reset state."""
    env = wrappers.ActionRepeatWrapper(env_core, action_repeat)
    env = wrappers.EpisodeWrapper(env, episode_length, 1)
    env = wrappers.VmapWrapper(env, batch_size=episodes)
    k_reset, key = split2(jr.PRNGKey(seed, env.device))
    state = first = env.reset(jr.split(k_reset, episodes))
    alive = torch.ones(episodes, device=env.device)
    for t in range(episode_length):
        key, k = split2(key)
        carry, act = act_fn(carry, state.obs, k)
        state = env.step(state, act)
        observe(state, alive)
        alive = alive * (1.0 - state.done)
        if t % 10 == 9 and not bool(alive.any()):
            break
    return first


def phase_end(total: int, per_call: int) -> int:
    """The env-steps where a curriculum phase of cumulative budget `total`
    ends: its last call of `per_call` env-steps (an epoch's, or a call's of
    `epochs_per_call` epochs) is whole, as the learners' `train` runs it."""
    return -(-total // per_call) * per_call


def make_parent(path: str) -> str:
    """Makes `path`'s directory; returns `path`."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    return path


def write_json(out: str, payload: dict) -> None:
    """Writes `payload` to `out`, making its directory."""
    with open(make_parent(out), "w") as f:
        json.dump(payload, f, indent=1)
    print(f"wrote {out}", flush=True)


def env_int(name: str, default: int, environ: Optional[dict] = None) -> int:
    return int((os.environ if environ is None else environ).get(name, str(default)))


def split_options(argv, *extra: str):
    """(argv without `--device D` / `--out P` and the `extra` options, device
    or None, out or None, then each `extra` option's value or None): the
    options every example's command line takes besides the JAX one's, and
    those of its own (e.g. "--checkpoint-dir")."""
    names = ("--device", "--out") + extra
    rest, found = [], dict.fromkeys(names)
    it = iter(argv)
    for a in it:
        if a in found:
            found[a] = next(it)
        else:
            rest.append(a)
    return (rest, *(found[n] for n in names))


class ProgressLog:
    """The progress of a run that resumes from `checkpoint_dir` across calls,
    kept beside its step dirs in `progress.jsonl`: a line {"call": env-steps
    resumed from, "card": ...} where a call starts training (and "seed" when
    one is given: a dir whose log names another seed, or that holds step dirs
    while no call of its log names this seed, raises, since its step dirs are
    another run's; "recipe" likewise, for an example whose training knobs a
    call may change), then one
    {"steps", "mean_reward", "t"} per progress report (`t`: seconds since the
    call started training). Opening the log drops the reports past the latest
    step dir: a cut call trains those epochs again. A curriculum adds one
    {"phase_end": the phase's knob (AntTag's visible radius, AntGather's
    sensor range), "steps", ...its replays' results} where a phase's last
    step dir is replayed (`phase_end`, `phase_ends`); a run that evaluates its
    final state once adds {"evaluation": ...its result, "steps"}
    (`evaluated`, `evaluation`)."""

    def __init__(self, checkpoint_dir: str, card: Optional[str], seed: Optional[int] = None,
                 recipe: Optional[dict] = None):
        os.makedirs(checkpoint_dir, exist_ok=True)
        self.path = os.path.join(checkpoint_dir, "progress.jsonl")
        resumed, lines = _load_log(checkpoint_dir)
        named = {e["seed"] for e in lines if "call" in e and "seed" in e}
        if seed is not None and (named - {seed} or (resumed and seed not in named)):
            raise ValueError(f"{checkpoint_dir} holds another run than seed {seed}'s (its log "
                             f"names seeds {sorted(named)}): give each seed its own checkpoint "
                             "dir")
        if recipe is not None:
            recipe = json.loads(json.dumps(recipe))  # as the log holds it: lists, not tuples
            named = [e["recipe"] for e in lines if "call" in e and "recipe" in e]
            if any(r != recipe for r in named) or (resumed and not named):
                raise ValueError(f"{checkpoint_dir} holds another run than recipe {recipe}'s "
                                 f"(its log names {named}): train it with the knobs it was "
                                 "started with, or give this recipe its own checkpoint dir")
        lines = _kept(lines, resumed)
        lines.append({"call": resumed, "card": card,
                      **({} if seed is None else {"seed": seed}),
                      **({} if recipe is None else {"recipe": recipe})})
        self.lines = lines
        with open(self.path, "w") as f:
            f.writelines(json.dumps(e) + "\n" for e in lines)
        self.t0 = time.perf_counter()

    @classmethod
    def read(cls, checkpoint_dir: str) -> "ProgressLog":
        """The log of `checkpoint_dir` as the next call would keep it, read
        without writing: no call line is added, and another process may be
        training there."""
        log = cls.__new__(cls)
        log.path = os.path.join(checkpoint_dir, "progress.jsonl")
        resumed, lines = _load_log(checkpoint_dir)
        log.lines, log.t0 = _kept(lines, resumed), None
        return log

    def __call__(self, steps: int, metrics: dict) -> None:
        """A learner's `progress_fn`."""
        self._append({"steps": steps, "mean_reward": metrics.get("mean_reward"),
                      "t": time.perf_counter() - self.t0})

    def _append(self, entry: dict) -> None:
        self.lines.append(entry)
        with open(self.path, "a") as f:
            f.write(json.dumps(entry) + "\n")

    def phase_end(self, knob: float, steps: int, **rates: float) -> None:
        """Logs the replays of a curriculum phase's last step dir."""
        self._append({"phase_end": knob, "steps": steps, **rates})

    def phase_ends(self) -> List[dict]:
        """The `phase_end` entries logged so far."""
        return [e for e in self.lines if "phase_end" in e]

    def phase_end_due(self, steps: int) -> bool:
        """Whether a phase that ends at `steps` awaits its replays: its step
        dir is the latest, and no phase end at `steps` is logged."""
        root = os.path.dirname(self.path)
        return (ckpt.latest_step_dir(root) == os.path.join(root, f"step_{steps:012d}")
                and all(e["steps"] != steps for e in self.phase_ends()))

    def evaluated(self, steps: int, result: dict) -> None:
        """Logs the evaluation of the state saved at `steps`."""
        self._append({"evaluation": result, "steps": steps})

    def evaluation(self, steps: int) -> Optional[dict]:
        """The evaluation logged for the state at `steps`, or None."""
        found = [e["evaluation"] for e in self.lines
                 if "evaluation" in e and e["steps"] == steps]
        return found[-1] if found else None

    def _reports(self) -> List[dict]:
        return [e for e in self.lines if "phase_end" not in e and "evaluation" not in e]

    def curve(self) -> List[dict]:
        """[{"steps", "mean_reward"}] of every call."""
        return [{"steps": e["steps"], "mean_reward": e["mean_reward"]}
                for e in self._reports() if "steps" in e]

    def calls(self) -> List[dict]:
        """`merged_calls` of this log."""
        return merged_calls(self._reports())


def saved_steps(checkpoint_dir: str) -> int:
    """The env-steps of the latest step dir under `checkpoint_dir`, or 0."""
    latest = ckpt.latest_step_dir(checkpoint_dir)
    return int(os.path.basename(latest)[len("step_"):]) if latest else 0


def _load_log(checkpoint_dir: str):
    """(`saved_steps`, the log's lines)."""
    path, lines = os.path.join(checkpoint_dir, "progress.jsonl"), []
    if os.path.exists(path):
        with open(path) as f:
            lines = [json.loads(line) for line in f if line.strip()]
    return saved_steps(checkpoint_dir), lines


def _kept(lines: List[dict], resumed: int) -> List[dict]:
    """The lines a call resuming at `resumed` keeps: none past it."""
    return [e for e in lines if e.get("steps", 0) <= resumed]


def log_keys(log: ProgressLog, card: Optional[str]) -> dict:
    """What a resumable run's record adds to JAX's keys, from its log (the
    curve of every call's reports)."""
    calls = log.calls()
    return {"phase_ends": log.phase_ends(), "curve": log.curve(), "calls": calls,
            "wall_s": sum(c["train_s"] for c in calls), "device": card or "cpu"}


def merged_calls(reports: List[dict]) -> List[dict]:
    """[{"from", "to", "train_s", "card"}] of a progress log's call and
    report lines: the env-steps each call trained that a later call kept,
    and its training's seconds up to its last kept report; a call that kept
    none is left out."""
    out = []
    for e in reports:
        if "call" in e:
            out.append({"from": e["call"], "to": e["call"], "train_s": 0.0, "card": e["card"]})
        else:
            out[-1].update(to=e["steps"], train_s=e["t"])
    return [c for c in out if c["to"] > c["from"]]
