"""Recurrent PPO learns AntTag; the port of examples/train_ant_tag_rnn.py.

A GRU policy (`training/ppo_rnn.py`) can dead-reckon its own position from
the velocity observations and remember target sightings, which the
feed-forward policy of train_ant_tag.py cannot. Trained on the same
potential-shaped AntTag, it is scored by the TRUE sparse tag rate
(`tag_rate_rnn`). `--curriculum` runs the staged visibility curriculum that
solves the true env (`main_curriculum`: visible radius 20 -> 6 -> 4, each
phase resuming one shared checkpoint).

Usage:
  python -m pobrax_tpu_torch.examples.train_ant_tag_rnn [num_timesteps] [num_envs]
  python -m pobrax_tpu_torch.examples.train_ant_tag_rnn --curriculum [num_envs]
  (either with [--device cpu] [--out PATH]; TAG_SEED and TAG_OUT as in JAX)
"""

from __future__ import annotations

import os
import shutil
import sys
from typing import Callable, Optional, Sequence, Tuple

import torch

from pobrax_tpu_torch.envs import HAI_ACTION_REPEAT, _envs
from pobrax_tpu_torch.envs.base import Env
from pobrax_tpu_torch.examples._common import (env_int, run_episodes, run_path,
                                               split_options, write_json)
from pobrax_tpu_torch.examples.train_ant_tag import ShapedAntTag, random_act, tag_rate
from pobrax_tpu_torch.training import ppo_rnn


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


def main_curriculum(num_envs: int = 2048, checkpoint_dir: Optional[str] = None,
                    curriculum: Sequence[Tuple[float, int]] = CURRICULUM,
                    seed: Optional[int] = None, device=None, out: Optional[str] = None) -> float:
    """The run that solves true AntTag: a staged visibility curriculum.

    `curriculum` is ((visible_radius, cumulative num_timesteps), ...); phase
    1 (radius 20, the target always observable) makes pursuit learnable,
    the later phases shrink visibility toward the true env. Each phase
    resumes the shared checkpoint in `checkpoint_dir` (emptied first;
    runs/ant_tag_rnn_ckpt unless named). Then the true-env tag rate, det at
    reset seed 0 and stoch at seed 1, 256 episodes each. `seed` defaults to
    TAG_SEED, `out` to TAG_OUT, else runs/learning_ant_tag_curriculum
    [_seed<s>].json. Returns the det rate."""
    checkpoint_dir = checkpoint_dir or run_path("ant_tag_rnn_ckpt")
    shutil.rmtree(checkpoint_dir, ignore_errors=True)
    seed = env_int("TAG_SEED", 0) if seed is None else seed
    common = dict(num_envs=num_envs, episode_length=1000, action_repeat=HAI_ACTION_REPEAT,
                  unroll_length=32, num_minibatches=8, num_update_epochs=4, learning_rate=3e-4,
                  entropy_cost=3e-3, discounting=0.97, reward_scaling=1.0, hidden_size=HIDDEN,
                  encoder_sizes=(256,), seed=seed, checkpoint_dir=checkpoint_dir,
                  checkpoint_every=50_000_000, progress_fn=lambda s, m: None)
    inference_fn = params = None
    for radius, total in curriculum:
        inference_fn, params, _ = ppo_rnn.train(
            ShapedAntTag(_envs["ant_tag"](visible_radius=radius, device=device), coef=5.0),
            num_timesteps=total, **common)
        print(f"curriculum phase done: visible_radius={radius}", flush=True)
    det = tag_rate_rnn(_envs["ant_tag"](device=device), inference_fn, params, HIDDEN,
                       action_repeat=HAI_ACTION_REPEAT)
    stoch = tag_rate_rnn(_envs["ant_tag"](device=device), inference_fn, params, HIDDEN,
                         action_repeat=HAI_ACTION_REPEAT, seed=1, deterministic=False)
    print(f"TRUE-env tag rate: det {det:.3f} / stoch {stoch:.3f}", flush=True)
    out = out or os.environ.get(
        "TAG_OUT", run_path("learning_ant_tag_curriculum"
                            + (f"_seed{seed}" if seed != 0 else "") + ".json"))
    write_json(out, {"curriculum": [list(p) for p in curriculum], "num_envs": num_envs,
                     "seed": seed, "hidden_size": HIDDEN, "true_tag_rate_det": det,
                     "true_tag_rate_stoch": stoch})
    print(f"final checkpoint under {checkpoint_dir}", flush=True)
    return det


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
        num_timesteps=num_timesteps, num_envs=num_envs, episode_length=1000,
        action_repeat=HAI_ACTION_REPEAT, unroll_length=32, num_minibatches=8,
        num_update_epochs=4, learning_rate=3e-4, entropy_cost=3e-3, discounting=0.97,
        reward_scaling=1.0, hidden_size=HIDDEN, encoder_sizes=(256,), seed=0,
        progress_fn=progress)

    det = tag_rate_rnn(_envs["ant_tag"](device=device), inference_fn, params, HIDDEN,
                       action_repeat=HAI_ACTION_REPEAT)
    stoch = tag_rate_rnn(_envs["ant_tag"](device=device), inference_fn, params, HIDDEN,
                         action_repeat=HAI_ACTION_REPEAT, seed=1, deterministic=False)
    print(f"GRU tag rate: det {det:.3f} / stoch {stoch:.3f} (random: {rand:.3f})", flush=True)
    payload = {"num_timesteps": num_timesteps, "num_envs": num_envs, "hidden_size": HIDDEN,
               "random_tag_rate": rand, "trained_tag_rate_det": det,
               "trained_tag_rate_stochastic": stoch, "curve": history}
    write_json(out or run_path("learning_ant_tag_rnn.json"), payload)
    return payload


if __name__ == "__main__":
    args, device, out = split_options(sys.argv[1:])
    if "--curriculum" in args:
        main_curriculum(*[int(a) for a in args if a != "--curriculum"][:1], device=device,
                        out=out)
    else:
        main(*[int(a) for a in args[:2]], device=device, out=out)
