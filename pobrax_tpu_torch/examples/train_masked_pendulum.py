"""Memory against no memory on a pure partial-observability task; the port
of examples/train_masked_pendulum.py.

masked_inverted_pendulum hides the VELOCITY segment: the policy sees cart
and pole positions only, so a feed-forward policy cannot tell a pole
falling left from one swinging right through the same angle. Trains PPO on
the full observation (the ceiling), PPO masked (the gap) and GRU-PPO masked
(memory closing it) and reports each deterministic policy's mean episode
length (`mean_length`, cap EPISODE_LENGTH).

Usage: python -m pobrax_tpu_torch.examples.train_masked_pendulum [num_timesteps]
       [--device cpu] [--out PATH]
"""

from __future__ import annotations

import sys
from typing import Callable, Optional

import torch

from pobrax_tpu_torch.envs import _envs
from pobrax_tpu_torch.envs.base import Env
from pobrax_tpu_torch.envs.masked import MaskedObservationWrapper
from pobrax_tpu_torch.examples._common import run_episodes, run_path, split_options, write_json
from pobrax_tpu_torch.training import ppo, ppo_rnn

EPISODE_LENGTH = 500
HIDDEN = 64


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


def main(num_timesteps: int = 20_000_000, device=None, out: Optional[str] = None) -> dict:
    common = dict(num_timesteps=num_timesteps, num_envs=1024, episode_length=EPISODE_LENGTH,
                  unroll_length=32, num_update_epochs=4, learning_rate=3e-4, entropy_cost=1e-2,
                  discounting=0.97, reward_scaling=1.0, seed=0, progress_fn=lambda s, m: None)
    results = {}

    # feed-forward on the FULL observation: the skill ceiling
    ff_full_inf, ff_full_params, _ = ppo.train(_envs["inverted_pendulum"](device=device),
                                               num_minibatches=32, **common)
    results["feedforward_full_obs"] = mean_length(
        _envs["inverted_pendulum"](device=device),
        lambda c, obs, k: (c, ff_full_inf(ff_full_params, obs, k, deterministic=True)))
    print(f"feedforward, full obs:   {results['feedforward_full_obs']:.1f}", flush=True)

    # feed-forward on the MASKED observation: the PO gap
    ff_inf, ff_params, _ = ppo.train(masked_env(device), num_minibatches=32, **common)
    results["feedforward_masked"] = mean_length(
        masked_env(device), lambda c, obs, k: (c, ff_inf(ff_params, obs, k, deterministic=True)))
    print(f"feedforward, masked:     {results['feedforward_masked']:.1f}", flush=True)

    # GRU on the MASKED observation: memory closes the gap
    rnn_inf, rnn_params, _ = ppo_rnn.train(masked_env(device), num_minibatches=8,
                                           hidden_size=HIDDEN, encoder_sizes=(64,), **common)
    eval_env = masked_env(device)
    results["gru_masked"] = mean_length(
        eval_env, lambda h, obs, k: rnn_inf(rnn_params, h, obs, k, deterministic=True),
        carry_init=lambda n: torch.zeros(n, HIDDEN, device=eval_env.device))
    print(f"GRU, masked:             {results['gru_masked']:.1f}", flush=True)

    results["episode_cap"] = EPISODE_LENGTH
    results["num_timesteps"] = num_timesteps
    write_json(out or run_path("learning_masked_pendulum.json"), results)
    return results


if __name__ == "__main__":
    args, device, out = split_options(sys.argv[1:])
    main(*[int(a) for a in args[:1]], device=device, out=out)
