"""Train SAC on a registered env; the port of examples/train_sac.py.

Usage: python -m pobrax_tpu_torch.examples.train_sac [env_name] [num_timesteps] [--device cpu]
"""

from __future__ import annotations

import sys

import torch

from pobrax_tpu_torch import random as jr
from pobrax_tpu_torch.envs import _envs
from pobrax_tpu_torch.examples._common import split_options
from pobrax_tpu_torch.training import sac


def main(env_name: str = "ant", num_timesteps: int = 500_000, device=None) -> torch.Tensor:
    env = _envs[env_name](device=device)

    def progress(steps, m):
        print(f"steps {steps:>10,}  reward {m['mean_reward']:+.3f}  q_loss {m['q_loss']:.3f}  "
              f"alpha {m['alpha']:.3f}  sps {m['steps_per_second']:,.0f}", flush=True)

    inference_fn, params, _ = sac.train(
        env, num_timesteps=num_timesteps, num_envs=128, episode_length=1000,
        replay_capacity=4096, batch_size=64, steps_per_epoch=32, min_replay=64,
        progress_fn=progress)

    obs = torch.zeros(1, env.observation_size, device=env.device)
    act = inference_fn(params, obs, jr.PRNGKey(1, env.device), deterministic=True)
    print("trained; deterministic action on zero obs:", act[0][:4].tolist(), flush=True)
    return act


if __name__ == "__main__":
    args, device, _ = split_options(sys.argv[1:])
    main(args[0] if args else "ant", int(args[1]) if len(args) > 1 else 500_000, device=device)
