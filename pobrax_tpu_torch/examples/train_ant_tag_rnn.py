"""Recurrent PPO learns AntTag; the port of examples/train_ant_tag_rnn.py.

A GRU policy (`training/ppo_rnn.py`) can dead-reckon its own position from
the velocity observations and remember target sightings, which the
feed-forward policy of train_ant_tag.py cannot. Trained on the same
potential-shaped AntTag, it is scored by the TRUE sparse tag rate
(`tag_rate_rnn`). `--curriculum` runs the staged visibility curriculum that
solves the true env (`main_curriculum`: visible radius 20 -> 6 -> 4, each
phase resuming one shared checkpoint).

`--curriculum --checkpoint-dir PATH` keeps PATH and resumes it: the same
command repeated trains the curriculum across calls and writes the record
once the last phase ends (`--resume-from NPZ` first seeds an empty PATH from
a committed resume state); `--partial` records where such a run stands.

Usage:
  python -m pobrax_tpu_torch.examples.train_ant_tag_rnn [num_timesteps] [num_envs]
  python -m pobrax_tpu_torch.examples.train_ant_tag_rnn --curriculum [num_envs]
      [--checkpoint-dir PATH [--resume-from NPZ]]
  python -m pobrax_tpu_torch.examples.train_ant_tag_rnn --curriculum --partial
      --checkpoint-dir PATH [num_envs]   (where a cut run stands; trains nothing)
  (each with [--device cpu] [--out PATH]; TAG_SEED and TAG_OUT as in JAX)
"""

from __future__ import annotations

import os
import shutil
import sys
from typing import Callable, Optional, Sequence, Tuple

import torch

from pobrax_tpu_torch import random as jr
from pobrax_tpu_torch.envs import HAI_ACTION_REPEAT, _envs
from pobrax_tpu_torch.envs.base import Env
from pobrax_tpu_torch.examples._common import (ProgressLog, env_int, log_keys, phase_end,
                                               run_episodes, run_path, split_options,
                                               write_json)
from pobrax_tpu_torch.examples.train_ant_tag import ShapedAntTag, random_act, tag_rate
from pobrax_tpu_torch.training import checkpoint as ckpt
from pobrax_tpu_torch.training import ppo_rnn
from pobrax_tpu_torch.utils.profiling import record_device


def tag_rate_rnn(env_core: Env, inference_fn: Callable, params, hidden_size: int,
                 episodes: int = 256, episode_length: int = 1000, seed: int = 0,
                 action_repeat: int = 1, deterministic: bool = True) -> float:
    """True sparse tag rate of a GRU policy: the share of `episodes` parallel
    episodes that end in a tag (a done with reward > 0.5) before any other
    end; the hidden state rides along the loop."""
    dev = env_core.device
    tagged = torch.zeros(episodes, device=dev)

    def observe(state, alive):
        torch.maximum(tagged, state.done * alive * (state.reward > 0.5), out=tagged)

    def act(h, obs, k):
        return inference_fn(params, h, obs, k, deterministic=deterministic)

    run_episodes(env_core, act, torch.zeros(episodes, hidden_size, device=dev), observe,
                 episodes, episode_length, seed, action_repeat)
    return float(tagged.mean())


CURRICULUM = ((20.0, 300_000_000), (6.0, 600_000_000), (4.0, 900_000_000))
HIDDEN = 128
CHECKPOINT_EVERY = 50_000_000  # examples/train_ant_tag_rnn.py's
# with `resume`: ~4-5 min of training on the H100, the most a cut call loses
RESUME_CHECKPOINT_EVERY = 8_000_000
RECIPE = dict(episode_length=1000, action_repeat=HAI_ACTION_REPEAT, unroll_length=32,
              num_minibatches=8, num_update_epochs=4, learning_rate=3e-4, entropy_cost=3e-3,
              discounting=0.97, reward_scaling=1.0, hidden_size=HIDDEN, encoder_sizes=(256,))


def true_rates(inference_fn, params, device=None) -> Tuple[float, float]:
    """(det at reset seed 0, stoch at seed 1): the true-env tag rates on 256
    episodes, as the curriculum reports them."""
    det = tag_rate_rnn(_envs["ant_tag"](device=device), inference_fn, params, HIDDEN,
                       action_repeat=HAI_ACTION_REPEAT)
    stoch = tag_rate_rnn(_envs["ant_tag"](device=device), inference_fn, params, HIDDEN,
                         action_repeat=HAI_ACTION_REPEAT, seed=1, deterministic=False)
    return det, stoch


def steps_per_epoch(num_envs: int) -> int:
    return num_envs * RECIPE["unroll_length"] * RECIPE["action_repeat"]


def seed_checkpoint_dir(checkpoint_dir: str, npz: str, num_envs: int = 2048,
                        device=None) -> Optional[str]:
    """Starts a resumable run from a committed resume state: when
    `checkpoint_dir` holds no step dir, the training state exported to `npz`
    (`tools/export_run_checkpoint.py --tag`) becomes its step dir, and the
    progress log committed beside it (`<npz without .npz>.progress.jsonl`)
    its `progress.jsonl`. Returns the step dir written, or None."""
    if ckpt.latest_step_dir(checkpoint_dir) is not None:
        return None
    from pobrax_tpu_torch import eval_tag_checkpoint  # it imports this module

    _, ts, same = eval_tag_checkpoint.load(npz, device)
    if not same:
        raise RuntimeError(f"{npz}: the loaded parameters do not match their checksum")
    path = ckpt.save_step(checkpoint_dir, ts.epochs * steps_per_epoch(num_envs), ts)
    log = npz[:-len(".npz")] + ".progress.jsonl"
    if os.path.exists(log):
        shutil.copyfile(log, os.path.join(checkpoint_dir, "progress.jsonl"))
    print(f"seeded {path} from {npz}", flush=True)
    return path


def main_curriculum(num_envs: int = 2048, checkpoint_dir: Optional[str] = None,
                    curriculum: Sequence[Tuple[float, int]] = CURRICULUM,
                    seed: Optional[int] = None, device=None, out: Optional[str] = None,
                    resume: bool = False, resume_from: Optional[str] = None) -> float:
    """The run that solves true AntTag: a staged visibility curriculum.

    `curriculum` is ((visible_radius, cumulative num_timesteps), ...); phase
    1 (radius 20, the target always observable) makes pursuit learnable,
    the later phases shrink visibility toward the true env. Each phase
    resumes the shared checkpoint in `checkpoint_dir` (emptied first;
    runs/ant_tag_rnn_ckpt unless named). Then the true-env tag rate, det at
    reset seed 0 and stoch at seed 1, 256 episodes each. `seed` defaults to
    TAG_SEED, `out` to TAG_OUT, else runs/learning_ant_tag_curriculum
    [_seed<s>].json. Returns the det rate.

    With `resume` (the command line's `--checkpoint-dir`) the directory is
    kept and the run goes on from its latest step dir, so the same call
    repeated trains the curriculum across calls: a phase whose budget the
    dir already covers trains nothing. It saves every
    `RESUME_CHECKPOINT_EVERY` env-steps (save points change nothing in
    training), logs each call in `ProgressLog`, replays the last step dir of
    every phase but the last on the true env (det seed 0, stoch seed 1) into
    that log, and the record gains `epochs`, `steps`, `curve`, `calls`,
    `wall_s`, `device` and `phase_ends`. `resume_from` seeds an empty dir
    (`seed_checkpoint_dir`)."""
    checkpoint_dir = checkpoint_dir or run_path("ant_tag_rnn_ckpt")
    if not resume:
        shutil.rmtree(checkpoint_dir, ignore_errors=True)
    elif resume_from is not None:
        seed_checkpoint_dir(checkpoint_dir, resume_from, num_envs, device)
    seed = env_int("TAG_SEED", 0) if seed is None else seed
    log = None
    if resume:
        card = record_device(_envs["ant_tag"](device=device).device)["card"]
        log = ProgressLog(checkpoint_dir, card)
    common = dict(num_envs=num_envs, seed=seed, checkpoint_dir=checkpoint_dir,
                  checkpoint_every=RESUME_CHECKPOINT_EVERY if resume else CHECKPOINT_EVERY,
                  progress_fn=log or (lambda s, m: None), **RECIPE)
    per_epoch = steps_per_epoch(num_envs)
    inference_fn = params = None
    for i, (radius, total) in enumerate(curriculum):
        inference_fn, params, _ = ppo_rnn.train(
            ShapedAntTag(_envs["ant_tag"](visible_radius=radius, device=device), coef=5.0),
            num_timesteps=total, **common)
        print(f"curriculum phase done: visible_radius={radius}", flush=True)
        end = phase_end(total, per_epoch)
        if log is not None and i < len(curriculum) - 1 and log.phase_end_due(end):
            det, stoch = true_rates(inference_fn, params, device)
            log.phase_end(radius, end, det=det, stoch=stoch)
            print(f"phase end {end:,} (visible_radius={radius}): TRUE-env tag rate det "
                  f"{det:.3f} / stoch {stoch:.3f}", flush=True)
    det, stoch = true_rates(inference_fn, params, device)
    print(f"TRUE-env tag rate: det {det:.3f} / stoch {stoch:.3f}", flush=True)
    out = out or os.environ.get(
        "TAG_OUT", run_path("learning_ant_tag_curriculum"
                            + (f"_seed{seed}" if seed != 0 else "") + ".json"))
    payload = {"curriculum": [list(p) for p in curriculum], "num_envs": num_envs,
               "seed": seed, "hidden_size": HIDDEN, "true_tag_rate_det": det,
               "true_tag_rate_stoch": stoch}
    if log is not None:
        steps = phase_end(curriculum[-1][1], per_epoch)
        payload.update(epochs=steps // per_epoch, steps=steps, **log_keys(log, card))
        print(f"trained over {len(payload['calls'])} call(s) in {payload['wall_s']:.1f} s; "
              f"{payload['device']}", flush=True)
    write_json(out, payload)
    print(f"final checkpoint under {checkpoint_dir}", flush=True)
    return det


def partial_record(checkpoint_dir: str, num_envs: int = 2048,
                   curriculum: Sequence[Tuple[float, int]] = CURRICULUM,
                   seed: Optional[int] = None, device=None, out: Optional[str] = None) -> dict:
    """The record of a resumable curriculum run that has not reached its end
    (`--partial`): `main_curriculum`'s keys, the rates those of the latest
    step dir (det seed 0, stoch seed 1, 256 episodes), `steps` where it
    stands, `partial`, and the det rate (seed 0) at the visible radius of the
    phase it is in, which is the next one's at a phase's end
    (`training_radius`). Trains nothing. `out` defaults to
    runs/learning_ant_tag_curriculum_partial.json."""
    latest = ckpt.latest_step_dir(checkpoint_dir)
    if latest is None:
        raise FileNotFoundError(f"no step dir under {checkpoint_dir}")
    learner = ppo_rnn.RNNPPOLearner(_envs["ant_tag"](device=device), ppo_rnn.ANT_TAG)
    ts = ckpt.restore(latest, template=learner.init(jr.PRNGKey(0, learner.device)))
    inference_fn, params = learner.make_inference_fn(), learner.inference_params(ts)
    det, stoch = true_rates(inference_fn, params, device)
    per_epoch = steps_per_epoch(num_envs)
    steps = ts.epochs * per_epoch
    radius = next((r for r, total in curriculum if steps < phase_end(total, per_epoch)),
                  curriculum[-1][0])
    at_radius = tag_rate_rnn(_envs["ant_tag"](visible_radius=radius, device=device),
                             inference_fn, params, HIDDEN, action_repeat=HAI_ACTION_REPEAT)
    card = record_device(learner.device)["card"]
    payload = {"curriculum": [list(p) for p in curriculum], "num_envs": num_envs,
               "seed": env_int("TAG_SEED", 0) if seed is None else seed,
               "hidden_size": HIDDEN, "true_tag_rate_det": det,
               "true_tag_rate_stoch": stoch, "partial": True, "epochs": ts.epochs,
               "steps": steps, "training_radius": radius,
               "tag_rate_det_at_training_radius": at_radius,
               **log_keys(ProgressLog(checkpoint_dir, card), card)}
    print(f"{steps:,} env-steps ({ts.epochs} epochs) of {curriculum[-1][1]:,}: TRUE-env tag "
          f"rate det {det:.3f} / stoch {stoch:.3f}; det {at_radius:.3f} at the training "
          f"radius {radius:g}; {payload['device']}", flush=True)
    write_json(out or run_path("learning_ant_tag_curriculum_partial.json"), payload)
    return payload


def main(num_timesteps: int = 150_000_000, num_envs: int = 2048, device=None,
         out: Optional[str] = None) -> dict:
    env = _envs["ant_tag"](device=device)
    rand = tag_rate(_envs["ant_tag"](device=device), random_act(env.action_size),
                    action_repeat=HAI_ACTION_REPEAT)
    print(f"random-policy tag rate: {rand:.3f}", flush=True)

    history = []

    def progress(steps, metrics):
        history.append({"steps": steps, "mean_reward": metrics.get("mean_reward"),
                        "steps_per_second": metrics.get("steps_per_second")})
        if len(history) % 20 == 0:
            print(f"  {steps:>12,} steps  mean_reward={history[-1]['mean_reward']:+.4f}  "
                  f"({history[-1]['steps_per_second']:,.0f} steps/s)", flush=True)

    inference_fn, params, _ = ppo_rnn.train(
        ShapedAntTag(_envs["ant_tag"](device=device), coef=5.0),
        num_timesteps=num_timesteps, num_envs=num_envs, seed=0, progress_fn=progress, **RECIPE)

    det, stoch = true_rates(inference_fn, params, device)
    print(f"GRU tag rate: det {det:.3f} / stoch {stoch:.3f} (random: {rand:.3f})", flush=True)
    payload = {"num_timesteps": num_timesteps, "num_envs": num_envs, "hidden_size": HIDDEN,
               "random_tag_rate": rand, "trained_tag_rate_det": det,
               "trained_tag_rate_stochastic": stoch, "curve": history}
    write_json(out or run_path("learning_ant_tag_rnn.json"), payload)
    return payload


def cli(argv: Sequence[str]):
    """The command line (module docstring)."""
    args, device, out, checkpoint_dir, resume_from = split_options(
        argv, "--checkpoint-dir", "--resume-from")
    if "--partial" in args:
        return partial_record(checkpoint_dir, *[int(a) for a in args if a[0] != "-"][:1],
                              curriculum=CURRICULUM, device=device, out=out)
    if "--curriculum" in args:
        return main_curriculum(*[int(a) for a in args if a != "--curriculum"][:1],
                               checkpoint_dir=checkpoint_dir, curriculum=CURRICULUM,
                               device=device, out=out, resume=checkpoint_dir is not None,
                               resume_from=resume_from)
    return main(*[int(a) for a in args[:2]], device=device, out=out)


if __name__ == "__main__":
    cli(sys.argv[1:])
