"""Memory against no memory on a masked locomotion body; the port of
examples/train_masked_ant.py.

masked_ant hides the VELOCITY segment (`envs/masks.py`): the policy sees
joint and torso positions and contact forces but no rates, so a
feed-forward policy cannot tell a leg swinging forward from one swinging
back through the same pose; a GRU can estimate rates from consecutive
frames. Trains three arms at one budget (feed-forward PPO on the full
observation, feed-forward PPO masked, GRU-PPO masked) and reports each
deterministic policy's mean episode reward and torso x-displacement on its
own observation regime (`eval_policy`). MASKED_ENV picks another stock env,
MASKED_SEED the seed, MASKED_OUT the record's path.

Usage: python -m pobrax_tpu_torch.examples.train_masked_ant [num_timesteps] [num_envs]
       [--device cpu] [--out PATH]
"""

from __future__ import annotations

import os
import sys
from typing import Callable, Optional

import torch

from pobrax_tpu_torch.envs import _envs
from pobrax_tpu_torch.envs.base import Env
from pobrax_tpu_torch.envs.masked import MaskedObservationWrapper
from pobrax_tpu_torch.examples._common import (env_int, run_episodes, run_path, split_options,
                                               write_json)
from pobrax_tpu_torch.training import ppo, ppo_rnn

EPISODE_LENGTH = 1000
HIDDEN = 128


def env_name(environ: Optional[dict] = None) -> str:
    """MASKED_ENV ("ant" unless set)."""
    return (os.environ if environ is None else environ).get("MASKED_ENV", "ant")


def masked_env(device=None, name: Optional[str] = None) -> Env:
    """The stock env (`env_name()` unless named) with its VELOCITY segment
    hidden."""
    name = name or env_name()
    return MaskedObservationWrapper(_envs[name](device=device), env_name=name,
                                    hidden=("VELOCITY",))


def eval_policy(env_core: Env, act_fn: Callable, carry_init: Optional[Callable] = None,
                episodes: int = 256, seed: int = 0) -> dict:
    """Mean episode reward and torso x-displacement (to the last step alive)
    of a policy, `act_fn(carry, obs, key) -> (carry, action)`, over
    EPISODE_LENGTH-step episodes."""
    dev = env_core.device
    torso = getattr(env_core, "torso_idx", 0)
    ret = torch.zeros(episodes, device=dev)
    xlast = torch.zeros(episodes, device=dev)

    def observe(state, alive):
        ret.add_(alive * state.reward)
        torch.where(alive > 0, state.qp.pos[:, torso, 0], xlast, out=xlast)

    carry0 = carry_init(episodes) if carry_init else torch.zeros(episodes, device=dev)
    first = run_episodes(env_core, act_fn, carry0, observe, episodes, EPISODE_LENGTH, seed)
    x0 = first.qp.pos[:, torso, 0]
    return {"episode_reward": float(ret.mean()), "x_displacement": float((xlast - x0).mean())}


def main(num_timesteps: int = 100_000_000, num_envs: int = 2048, device=None,
         out: Optional[str] = None) -> dict:
    name = env_name()
    common = dict(num_timesteps=num_timesteps, num_envs=num_envs,
                  episode_length=EPISODE_LENGTH, unroll_length=32, num_update_epochs=4,
                  learning_rate=3e-4, entropy_cost=1e-2, discounting=0.97, reward_scaling=1.0,
                  seed=env_int("MASKED_SEED", 0), progress_fn=lambda s, m: None)
    results = {}

    ff_full_inf, ff_full_params, _ = ppo.train(_envs[name](device=device), num_minibatches=32,
                                               **common)
    results["feedforward_full_obs"] = eval_policy(
        _envs[name](device=device),
        lambda c, obs, k: (c, ff_full_inf(ff_full_params, obs, k, deterministic=True)))
    print(f"feedforward, full obs:  {results['feedforward_full_obs']}", flush=True)

    ff_inf, ff_params, _ = ppo.train(masked_env(device, name), num_minibatches=32, **common)
    results["feedforward_masked"] = eval_policy(
        masked_env(device, name),
        lambda c, obs, k: (c, ff_inf(ff_params, obs, k, deterministic=True)))
    print(f"feedforward, masked:    {results['feedforward_masked']}", flush=True)

    rnn_inf, rnn_params, _ = ppo_rnn.train(masked_env(device, name), num_minibatches=8,
                                           hidden_size=HIDDEN, encoder_sizes=(256,), **common)
    eval_env = masked_env(device, name)
    results["gru_masked"] = eval_policy(
        eval_env, lambda h, obs, k: rnn_inf(rnn_params, h, obs, k, deterministic=True),
        carry_init=lambda n: torch.zeros(n, HIDDEN, device=eval_env.device))
    print(f"GRU, masked:            {results['gru_masked']}", flush=True)

    results.update(env=name, hidden=["VELOCITY"], num_timesteps=num_timesteps,
                   num_envs=num_envs, episode_cap=EPISODE_LENGTH)
    write_json(out or os.environ.get("MASKED_OUT", run_path(f"learning_masked_{name}.json")),
               results)
    return results


if __name__ == "__main__":
    args, device, out = split_options(sys.argv[1:])
    main(*[int(a) for a in args[:2]], device=device, out=out)
