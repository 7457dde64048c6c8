"""Memory against no memory on a pure partial-observability task; the port
of examples/train_masked_pendulum.py.

masked_inverted_pendulum hides the VELOCITY segment: the policy sees cart
and pole positions only, so a feed-forward policy cannot tell a pole
falling left from one swinging right through the same angle. Trains PPO on
the full observation (the ceiling), PPO masked (the gap) and GRU-PPO masked
(memory closing it) and reports each deterministic policy's mean episode
length (`mean_length`, cap EPISODE_LENGTH).

`--checkpoint-dir PATH` gives each arm its own subdirectory (`ARMS`), where
its learner saves every CHECKPOINT_EVERY env-steps and at the end; the same
command run again resumes each arm from its latest step dir, and an arm
that had finished goes straight to its evaluation. The record then also
holds `calls`: per arm, the env-steps each call trained, its training's
seconds and the card.

Usage: python -m pobrax_tpu_torch.examples.train_masked_pendulum [num_timesteps]
       [--device cpu] [--out PATH] [--checkpoint-dir PATH]
"""

from __future__ import annotations

import os
import sys
from typing import Callable, Optional

import torch

from pobrax_tpu_torch.envs import _envs
from pobrax_tpu_torch.envs.base import Env
from pobrax_tpu_torch.envs.masked import MaskedObservationWrapper
from pobrax_tpu_torch.examples._common import (ProgressLog, run_episodes, run_path,
                                               split_options, write_json)
from pobrax_tpu_torch.training import ppo, ppo_rnn
from pobrax_tpu_torch.utils.profiling import record_device

EPISODE_LENGTH = 500
HIDDEN = 64
# the arms' checkpoint subdirectories, in training order
ARMS = ("ff_full", "ff_masked", "gru_masked")
CHECKPOINT_EVERY = 5_000_000  # a quarter of the recipe; a feed-forward arm's state is ~3 MB


def masked_env(device=None) -> Env:
    return MaskedObservationWrapper(_envs["inverted_pendulum"](device=device),
                                    env_name="inverted_pendulum", hidden=("VELOCITY",))


def mean_length(env_core: Env, act_fn: Callable, carry_init: Optional[Callable] = None,
                episodes: int = 256, seed: int = 0) -> float:
    """Mean steps survived (cap EPISODE_LENGTH) of a policy, `act_fn(carry,
    obs, key) -> (carry, action)`; carry_init=None for stateless policies."""
    dev = env_core.device
    length = torch.zeros(episodes, device=dev)

    def observe(state, alive):
        length.add_(alive)

    carry0 = carry_init(episodes) if carry_init else torch.zeros(episodes, device=dev)
    run_episodes(env_core, act_fn, carry0, observe, episodes, EPISODE_LENGTH, seed)
    return float(length.mean())


def main(num_timesteps: int = 20_000_000, device=None, out: Optional[str] = None,
         checkpoint_dir: Optional[str] = None) -> dict:
    common = dict(num_timesteps=num_timesteps, num_envs=1024, episode_length=EPISODE_LENGTH,
                  unroll_length=32, num_update_epochs=4, learning_rate=3e-4, entropy_cost=1e-2,
                  discounting=0.97, reward_scaling=1.0, seed=0, progress_fn=lambda s, m: None)
    results, logs = {}, {}

    def arm(name: str, env: Env) -> dict:
        """`common`, and with a checkpoint dir the arm's subdirectory and log."""
        if checkpoint_dir is None:
            return common
        arm_dir = os.path.join(checkpoint_dir, name)
        logs[name] = ProgressLog(arm_dir, record_device(env.device)["card"])
        return {**common, "checkpoint_dir": arm_dir, "checkpoint_every": CHECKPOINT_EVERY,
                "progress_fn": logs[name]}

    # feed-forward on the FULL observation: the skill ceiling
    env = _envs["inverted_pendulum"](device=device)
    ff_full_inf, ff_full_params, _ = ppo.train(env, num_minibatches=32, **arm("ff_full", env))
    results["feedforward_full_obs"] = mean_length(
        _envs["inverted_pendulum"](device=device),
        lambda c, obs, k: (c, ff_full_inf(ff_full_params, obs, k, deterministic=True)))
    print(f"feedforward, full obs:   {results['feedforward_full_obs']:.1f}", flush=True)

    # feed-forward on the MASKED observation: the PO gap
    env = masked_env(device)
    ff_inf, ff_params, _ = ppo.train(env, num_minibatches=32, **arm("ff_masked", env))
    results["feedforward_masked"] = mean_length(
        masked_env(device), lambda c, obs, k: (c, ff_inf(ff_params, obs, k, deterministic=True)))
    print(f"feedforward, masked:     {results['feedforward_masked']:.1f}", flush=True)

    # GRU on the MASKED observation: memory closes the gap
    env = masked_env(device)
    rnn_inf, rnn_params, _ = ppo_rnn.train(env, num_minibatches=8, hidden_size=HIDDEN,
                                           encoder_sizes=(64,), **arm("gru_masked", env))
    eval_env = masked_env(device)
    results["gru_masked"] = mean_length(
        eval_env, lambda h, obs, k: rnn_inf(rnn_params, h, obs, k, deterministic=True),
        carry_init=lambda n: torch.zeros(n, HIDDEN, device=eval_env.device))
    print(f"GRU, masked:             {results['gru_masked']:.1f}", flush=True)

    results["episode_cap"] = EPISODE_LENGTH
    results["num_timesteps"] = num_timesteps
    if logs:
        results["calls"] = {name: log.calls() for name, log in logs.items()}
        for name, calls in results["calls"].items():
            steps, wall = sum(c["to"] - c["from"] for c in calls), sum(c["train_s"] for c in calls)
            print(f"{name}: {steps:,} env-steps trained in {wall:.1f} s over {len(calls)} "
                  f"call(s)" + (f", {steps / wall:,.0f} env-steps/s" if wall else ""),
                  flush=True)
    write_json(out or run_path("learning_masked_pendulum.json"), results)
    return results


if __name__ == "__main__":
    args, device, out, checkpoint_dir = split_options(sys.argv[1:], "--checkpoint-dir")
    main(*[int(a) for a in args[:1]], device=device, out=out, checkpoint_dir=checkpoint_dir)
