"""Recurrent PPO on AntGather; the port of examples/train_ant_gather_rnn.py.

AntGather rewards +1 per apple and -1 per bomb, sensed only through the
binned egocentric range sensor. `ShapedAntGather` shapes toward the nearest
LIVE apple (and, with `bomb_coef`, away from the nearest live bomb, capped),
with the potential's delta masked on any step that caught an object: the
caught object jumps to the sky waiting area and the nearest apple switches,
so an unmasked delta would punish the catch. Training-time only; the
evaluation (`gather_eval`) reports apples and bombs per episode on the TRUE
env.

`main_curriculum` runs the sensor-range curriculum (the whole arena readable
first, then the true 6 m), each phase resuming one shared checkpoint, with
the optional count-based novelty bonus and bomb memory
(`envs/exploration.GridNoveltyBonusWrapper`) around the shaped env. Its
knobs are the JAX example's environment variables, GATHER_CURRICULUM
("14:400,6:800": sensor range in m : cumulative budget in M steps),
GATHER_DEALIASED, GATHER_NOVELTY (a per-phase list), GATHER_BOMB_MEMORY,
GATHER_BOMB_COEF, GATHER_SEED, GATHER_GAMMA and GATHER_OUT, read at the
call (`gather_knobs`), not at import.

`curriculum --checkpoint-dir PATH` keeps PATH and resumes it: the same
command repeated trains the curriculum across calls and writes the record
once the last phase ends. Each GATHER_SEED, and each setting of the knobs
that shape training, needs its own PATH (a dir whose log names another seed
or other knobs raises before anything trains). A call resumes with fresh
envs. The novelty wrapper's visit and bomb-cell grids live in the envs'
`state.info`, and the autoresets keep them across a phase's episodes, so a
phase that the wrapper trains is resumed only from its start: its step dir
is saved at its end alone (a cut call trains the phase again), and a dir
whose latest step lies inside such a phase raises. Other phases save after
every call of `epochs_per_call` epochs. The dir keeps the last two saves.

Usage: python -m pobrax_tpu_torch.examples.train_ant_gather_rnn [variant] [num_timesteps]
       [num_envs] [--device cpu] [--out PATH]
  variant: "mask" (catch mask only) | "bomb" (catch mask + bomb repulsion) |
  "curriculum" (then [num_envs] [--checkpoint-dir PATH])
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import sys
from typing import Optional, Sequence, Tuple

import torch

from pobrax_tpu_torch.envs import HAI_ACTION_REPEAT, _envs
from pobrax_tpu_torch.envs.base import Env, State, Wrapper
from pobrax_tpu_torch.envs.exploration import GridNoveltyBonusWrapper
from pobrax_tpu_torch.device import resolve
from pobrax_tpu_torch.examples._common import (ProgressLog, log_keys, phase_end, run_episodes,
                                               run_path, saved_steps, split_options,
                                               uniform_actions, write_json)
from pobrax_tpu_torch.training import ppo_rnn
from pobrax_tpu_torch.utils.profiling import record_device

HIDDEN = 128
# examples/train_ant_gather_rnn.py's main_curriculum's ppo_rnn.train
# arguments but the env, the budget, the batch, the seed, the checkpoint dir
# and the progress function
RECIPE = dict(episode_length=1000, action_repeat=HAI_ACTION_REPEAT, unroll_length=32,
              num_minibatches=8, num_update_epochs=4, learning_rate=3e-4, entropy_cost=3e-3,
              discounting=0.97, reward_scaling=1.0, hidden_size=HIDDEN, encoder_sizes=(256,),
              epochs_per_call=8, autoreset_mode="cached")
CHECKPOINT_EVERY = 100_000_000  # the JAX example's


class ShapedAntGather(Wrapper):
    """TRAINING-TIME shaping: r' = r + coef * (phi' - phi), the delta masked
    to 0 on any step where `metrics['apples'] + metrics['bombs'] > 0`, with
    phi = -d_apple + bomb_coef * min(d_bomb, bomb_cap) per env; d_* is the 3D
    distance to the nearest LIVE object of the kind (caught objects wait in
    the sky at z = 12; z < 5 marks the live ones)."""

    def __init__(self, env: Env, coef: float = 5.0, bomb_coef: float = 0.0,
                 bomb_cap: float = 3.0):
        super().__init__(env)
        self.coef = coef
        self.bomb_coef = bomb_coef
        self.bomb_cap = bomb_cap

    def _phi(self, qp) -> torch.Tensor:
        u = self.unwrapped
        torso = qp.pos[:, u.torso_idx]
        obj = qp.pos[:, u.objects]
        d = torch.linalg.norm(torso[:, None] - obj, dim=-1)
        d = torch.where(obj[..., 2] < 5.0, d, torch.full_like(d, 1e6))
        phi = -d[:, :u.n_apples].min(-1).values
        if self.bomb_coef:
            d_bomb = d[:, u.n_apples:].min(-1).values
            phi = phi + self.bomb_coef * torch.clamp(d_bomb, max=self.bomb_cap)
        return phi

    def step(self, state: State, action: torch.Tensor) -> State:
        p0 = self._phi(state.qp)
        nstate = self.env.step(state, action)
        delta = self._phi(nstate.qp) - p0
        caught = (nstate.metrics["apples"] + nstate.metrics["bombs"]) > 0
        delta = torch.where(caught, torch.zeros_like(delta), delta)
        return nstate.replace(reward=nstate.reward + self.coef * delta)


def gather_counts(env_core: Env, act_fn, episodes: int = 256, episode_length: int = 1000,
                  seed: int = 0, action_repeat: int = 1,
                  hidden_size: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apples and bombs caught in each of `episodes` episodes on the TRUE
    env, as `gather_eval` runs them."""
    dev = env_core.device
    asz = env_core.action_size
    apples = torch.zeros(episodes, device=dev)
    bombs = torch.zeros(episodes, device=dev)

    def observe(state, alive):
        apples.add_(alive * state.metrics["apples"])
        bombs.add_(alive * state.metrics["bombs"])

    if act_fn is None:
        def act(h, obs, k):
            return h, uniform_actions(k, (episodes, asz))
    else:
        params, inference_fn, deterministic = act_fn

        def act(h, obs, k):
            return inference_fn(params, h, obs, k, deterministic=deterministic)

    run_episodes(env_core, act, torch.zeros(episodes, hidden_size, device=dev), observe,
                 episodes, episode_length, seed, action_repeat)
    return apples, bombs


def gather_eval(env_core: Env, act_fn, episodes: int = 256, episode_length: int = 1000,
                seed: int = 0, action_repeat: int = 1, hidden_size: int = 0) -> Tuple[float, float]:
    """Mean apples and bombs caught per episode on the TRUE env. `act_fn` is
    None (uniform random actions) or (params, inference_fn, deterministic)
    of a GRU-PPO policy with `hidden_size` units."""
    apples, bombs = gather_counts(env_core, act_fn, episodes, episode_length, seed,
                                  action_repeat, hidden_size)
    return float(apples.mean()), float(bombs.mean())


@dataclasses.dataclass(frozen=True)
class GatherKnobs:
    """The JAX example's environment knobs (`gather_knobs`)."""

    curriculum: Tuple[Tuple[float, int], ...] = ((14.0, 400_000_000), (6.0, 800_000_000))
    dealiased: bool = False
    novelty: Tuple[float, ...] = (0.0,)
    bomb_memory: float = 0.0
    bomb_coef: float = 0.0
    seed: int = 0
    gamma: float = 0.97
    out: Optional[str] = None

    @property
    def env_kw(self) -> dict:
        # the diagnostic de-aliased sensor: bomb bins offset by n_bins
        return {"bomb_bin_offset": 10} if self.dealiased else {}

    def novelty_beta(self, phase_idx: int) -> float:
        return self.novelty[min(phase_idx, len(self.novelty) - 1)]

    def wrapped(self, phase_idx: int) -> bool:
        """Whether the phase trains inside `GridNoveltyBonusWrapper`, whose
        grids carry across its episodes: its beta or the bomb memory is
        positive."""
        return self.novelty_beta(phase_idx) > 0.0 or self.bomb_memory > 0.0

    def recipe(self, num_envs: int) -> dict:
        """What shapes `main_curriculum`'s training beside the seed (GATHER_GAMMA
        and GATHER_OUT do not): a dir it resumes must have been trained with
        the same."""
        return {"num_envs": num_envs, "curriculum": self.curriculum,
                "dealiased": self.dealiased, "novelty": self.novelty,
                "bomb_memory": self.bomb_memory, "bomb_coef": self.bomb_coef}


def gather_knobs(environ: Optional[dict] = None) -> GatherKnobs:
    """The knobs from `environ` (the process environment unless given):
    GATHER_CURRICULUM ("14:400,10:700,6:1200": sensor range in m and
    cumulative budget in M steps), GATHER_DEALIASED ("1"), GATHER_NOVELTY
    (a beta, or a comma list of per-phase betas), GATHER_BOMB_MEMORY,
    GATHER_BOMB_COEF, GATHER_SEED, GATHER_GAMMA, GATHER_OUT."""
    e = os.environ if environ is None else environ
    return GatherKnobs(
        curriculum=tuple((float(p.split(":")[0]), int(p.split(":")[1]) * 1_000_000)
                         for p in e.get("GATHER_CURRICULUM", "14:400,6:800").split(",")),
        dealiased=e.get("GATHER_DEALIASED", "0") == "1",
        novelty=tuple(float(b) for b in e.get("GATHER_NOVELTY", "0.0").split(",")),
        bomb_memory=float(e.get("GATHER_BOMB_MEMORY", "0.0")),
        bomb_coef=float(e.get("GATHER_BOMB_COEF", "0.0")),
        seed=int(e.get("GATHER_SEED", "0")),
        gamma=float(e.get("GATHER_GAMMA", "0.97")),
        out=e.get("GATHER_OUT"))


def _training_env(core_env: Env, bomb_coef: float, phase_idx: int = 0,
                  knobs: Optional[GatherKnobs] = None) -> Env:
    """The shaped env, inside the novelty bonus / bomb memory wrapper when
    the phase's beta or the bomb memory is positive (half-life 500 core
    steps: the wrapper sits below ActionRepeat, so about half an episode)."""
    knobs = knobs or gather_knobs()
    env = ShapedAntGather(core_env, coef=5.0, bomb_coef=bomb_coef)
    if knobs.wrapped(phase_idx):
        env = GridNoveltyBonusWrapper(env, beta=knobs.novelty_beta(phase_idx),
                                      half_extent=10.0, grid=16,
                                      halflife_steps=500.0, bomb_memory=knobs.bomb_memory)
    return env


def _progress(history):
    def progress(steps, metrics):
        history.append({"steps": steps, "mean_reward": metrics.get("mean_reward")})
        if len(history) % 20 == 0:
            print(f"  {steps:>12,} steps  mean_reward={history[-1]['mean_reward']:+.4f}",
                  flush=True)
    return progress


def _evaluate(inference_fn, params, env_kw: dict, device) -> dict:
    results = {}
    for det in (True, False):
        a, b = gather_eval(_envs["ant_gather"](device=device, **env_kw),
                           (params, inference_fn, det), action_repeat=HAI_ACTION_REPEAT,
                           hidden_size=HIDDEN)
        mode = "det" if det else "stoch"
        results[mode] = {"apples": a, "bombs": b}
        print(f"GRU ({mode}): apples {a:.2f} bombs {b:.2f} net {a - b:+.2f}", flush=True)
    return results


def curriculum_out(knobs: GatherKnobs) -> str:
    """The record's default name: the variant and any non-zero seed in it,
    so that no run overwrites another's."""
    nov = knobs.novelty
    return run_path(
        "learning_gather_rnn_curriculum" + ("_dealiased" if knobs.dealiased else "")
        + ("_bomb" if knobs.bomb_coef != 0.0 else "")
        + ("_novelty" if max(nov) > 0.0 else "")
        + ("_anneal" if max(nov) > 0.0 and len(nov) > 1 and nov[-1] == 0.0 else "")
        + ("_bombmem" if knobs.bomb_memory > 0.0 else "")
        + (f"_seed{knobs.seed}" if knobs.seed != 0 else "") + ".json")


def _check_resume_point(checkpoint_dir: str, knobs: GatherKnobs, per_call: int) -> None:
    """Raises if the latest step dir in `checkpoint_dir` lies inside a phase
    that `GatherKnobs.wrapped`: a resumed call restarts the envs, and with
    them the wrapper's grids that an uncut phase keeps across episodes."""
    saved, start = saved_steps(checkpoint_dir), 0
    for phase_idx, (srange, total) in enumerate(knobs.curriculum):
        end = phase_end(total, per_call)
        if knobs.wrapped(phase_idx) and start < saved < end:
            raise ValueError(
                f"{checkpoint_dir}: its latest step dir, at {saved:,} env-steps, lies inside "
                f"phase {phase_idx} ({start:,} to {end:,}, sensor_range={srange}), whose "
                "novelty wrapper keeps its grids across episodes; a resumed call would "
                f"restart them. Remove the step dirs past {start:,} to train the phase again "
                "from its start")
        start = end


def _prune(checkpoint_dir: str) -> None:
    """Removes all but the latest step dir under `checkpoint_dir`."""
    steps = sorted(d for d in os.listdir(checkpoint_dir) if d.startswith("step_"))
    for d in steps[:-1]:
        shutil.rmtree(os.path.join(checkpoint_dir, d))


def main_curriculum(num_envs: int = 2048, checkpoint_dir: Optional[str] = None,
                    knobs: Optional[GatherKnobs] = None, device=None,
                    out: Optional[str] = None, resume: bool = False) -> dict:
    """The sensor-range curriculum: phase i trains at its sensor range up to
    its cumulative budget on `_training_env(..., i)`, resuming the shared
    checkpoint in `checkpoint_dir` (emptied first; runs/ant_gather_rnn_ckpt
    unless named); then `gather_eval` det and stoch on the true env.
    `knobs` default to `gather_knobs()`.

    With `resume` (the command line's `--checkpoint-dir`) the directory is
    kept and the run goes on from its latest step dir, so the same call
    repeated trains the curriculum across calls: a phase whose budget the
    dir already covers trains nothing. A phase saves after every call of
    `epochs_per_call` epochs, or at its end alone where `GatherKnobs.wrapped`
    (save points change nothing in training); before each call's save the
    dir keeps only its latest step dir, so it holds the last two saves. A
    dir whose latest step lies inside a wrapped phase raises before anything
    is written (`_check_resume_point`). The call is logged in `ProgressLog`
    (which refuses a dir of another GATHER_SEED or other knobs,
    `GatherKnobs.recipe`), the last step dir of every phase but the last is
    replayed on the true env (`_evaluate`) into that log, and the record
    gains `epochs`, `steps`, `calls`, `wall_s`, `device` and `phase_ends`;
    its `curve` is every tenth report of every call."""
    knobs = knobs or gather_knobs()
    checkpoint_dir = checkpoint_dir or run_path("ant_gather_rnn_ckpt")
    per_call = num_envs * RECIPE["unroll_length"] * RECIPE["action_repeat"] * RECIPE[
        "epochs_per_call"]
    log = card = None
    if resume:
        _check_resume_point(checkpoint_dir, knobs, per_call)
        card = record_device(resolve(device))["card"]
        log = ProgressLog(checkpoint_dir, card, seed=knobs.seed, recipe=knobs.recipe(num_envs))
    else:
        shutil.rmtree(checkpoint_dir, ignore_errors=True)
    history = []
    report = _progress(history)

    def progress(steps, metrics):
        if log is not None:
            log(steps, metrics)
            _prune(checkpoint_dir)  # the learner saves after its report
        report(steps, metrics)

    common = dict(num_envs=num_envs, seed=knobs.seed, checkpoint_dir=checkpoint_dir,
                  progress_fn=progress, **RECIPE)
    inference_fn = params = None
    for phase_idx, (srange, total) in enumerate(knobs.curriculum):
        every = (total if knobs.wrapped(phase_idx) else per_call) if resume else CHECKPOINT_EVERY
        inference_fn, params, _ = ppo_rnn.train(
            _training_env(_envs["ant_gather"](sensor_range=srange, device=device,
                                              **knobs.env_kw),
                          knobs.bomb_coef, phase_idx, knobs),
            num_timesteps=total, checkpoint_every=every, **common)
        print(f"curriculum phase done: sensor_range={srange}", flush=True)
        end = phase_end(total, per_call)
        if log is not None and phase_idx < len(knobs.curriculum) - 1 and log.phase_end_due(end):
            print(f"phase end {end:,} (sensor_range={srange}): TRUE env", flush=True)
            results = _evaluate(inference_fn, params, knobs.env_kw, device)
            log.phase_end(srange, end, **{f"{mode}_{k}": v for mode, r in results.items()
                                          for k, v in r.items()})
    results = _evaluate(inference_fn, params, knobs.env_kw, device)
    payload = {"curriculum": [list(p) for p in knobs.curriculum], "num_envs": num_envs,
               "bomb_coef": knobs.bomb_coef, "seed": knobs.seed,
               "dealiased_sensor": knobs.dealiased, "novelty_beta": list(knobs.novelty),
               "bomb_memory": knobs.bomb_memory, "hidden_size": HIDDEN, "results": results,
               "curve": history[::10]}
    if log is not None:
        steps = phase_end(knobs.curriculum[-1][1], per_call)
        per_epoch = per_call // RECIPE["epochs_per_call"]
        payload.update(log_keys(log, card), epochs=steps // per_epoch, steps=steps)
        payload["curve"] = payload["curve"][::10]  # every tenth report, as JAX's
        print(f"trained {steps:,} env-steps over {len(payload['calls'])} call(s) in "
              f"{payload['wall_s']:.1f} s; {payload['device']}", flush=True)
    write_json(out or knobs.out or curriculum_out(knobs), payload)
    return payload


def main(variant: str = "bomb", num_timesteps: int = 400_000_000, num_envs: int = 2048,
         out: Optional[str] = None, device=None, knobs: Optional[GatherKnobs] = None) -> dict:
    knobs = knobs or gather_knobs()
    bomb_coef = 0.3 if variant == "bomb" else 0.0
    ra, rb = gather_eval(_envs["ant_gather"](device=device), None,
                         action_repeat=HAI_ACTION_REPEAT)
    print(f"random: apples {ra:.2f} bombs {rb:.2f} net {ra - rb:+.2f}", flush=True)
    history = []
    inference_fn, params, _ = ppo_rnn.train(
        ShapedAntGather(_envs["ant_gather"](device=device), coef=5.0, bomb_coef=bomb_coef),
        num_timesteps=num_timesteps, num_envs=num_envs, episode_length=1000,
        action_repeat=HAI_ACTION_REPEAT, unroll_length=32, num_minibatches=8,
        num_update_epochs=4, learning_rate=3e-4, entropy_cost=3e-3,
        discounting=knobs.gamma, reward_scaling=1.0, hidden_size=HIDDEN,
        encoder_sizes=(256,), epochs_per_call=8, autoreset_mode="cached", seed=0,
        progress_fn=_progress(history))
    results = {"random": {"apples": ra, "bombs": rb},
               **_evaluate(inference_fn, params, {}, device)}
    payload = {"variant": variant, "bomb_coef": bomb_coef, "gamma": knobs.gamma,
               "num_timesteps": num_timesteps, "num_envs": num_envs, "hidden_size": HIDDEN,
               "results": results, "curve": history[::10]}
    write_json(out or run_path(f"learning_gather_rnn_{variant}.json"), payload)
    return payload


def cli(argv: Sequence[str]):
    """The command line (module docstring)."""
    args, device, out, checkpoint_dir = split_options(argv, "--checkpoint-dir")
    variant = args[0] if args else "bomb"
    if variant == "curriculum":
        return main_curriculum(*[int(a) for a in args[1:2]], checkpoint_dir=checkpoint_dir,
                               device=device, out=out, resume=checkpoint_dir is not None)
    return main(variant, *[int(a) for a in args[1:3]], out=out, device=device)


if __name__ == "__main__":
    cli(sys.argv[1:])
