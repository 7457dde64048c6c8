"""Rollout and eval-stats demo; the port of examples/rollout_demo.py.

Runs a batched AntTag rollout two ways:
  1. `gym_path`: the gymnasium VectorEnv adapter with host-side autoreset
     and EvalGymWrapper stats (`create_gym_env`; gymnasium is imported only
     there, so the native path runs where it is not installed);
  2. `native_path`: the env on its device with the randomised autoreset,
     stepped in a host loop of on-device random actions (the JAX example
     jits a scan; the port runs the loop once to warm up, then times it
     from the same state).

Usage: python -m pobrax_tpu_torch.examples.rollout_demo [env_name] [batch] [steps]
       [--device cpu]
"""

from __future__ import annotations

import sys
import time

import torch

from pobrax_tpu_torch import random as jr
from pobrax_tpu_torch.envs import create, create_gym_env
from pobrax_tpu_torch.examples._common import split_options, split2, uniform_actions


def gym_path(env_name: str = "ant_tag", batch: int = 16, steps: int = 200, device=None) -> dict:
    egym = create_gym_env(env_name, batch_size=batch, seed=0, eval_metrics=True, device=device)
    egym.reset()
    t0 = time.perf_counter()
    for _ in range(steps):
        egym.step(egym.action_space.sample())
    stats = egym.get_stats()
    dt = time.perf_counter() - t0
    print(f"[gym path]    {batch * steps / dt:,.0f} env-steps/s; stats: "
          f"{ {k: round(float(v), 3) for k, v in stats.items()} }", flush=True)
    return {k: float(v) for k, v in stats.items()}


def native_path(env_name: str = "ant_tag", batch: int = 16, steps: int = 200,
                device=None) -> dict:
    env = create(env_name, batch_size=batch, randomized_autoreset=True, device=device)
    key = jr.PRNGKey(0, env.device)
    state0 = env.reset(jr.split(key, batch))

    def rollout(state, key):
        rewards = []
        for _ in range(steps):
            key, k = split2(key)
            state = env.step(state, uniform_actions(k, (batch, env.action_size)))
            rewards.append(state.reward)
        return state, torch.stack(rewards)

    def sync():
        if env.device.type == "cuda":
            torch.cuda.synchronize()

    rollout(state0, key)  # warm-up: the kernel's first launch, the allocator
    sync()
    t0 = time.perf_counter()
    _, rewards = rollout(state0, key)
    sync()
    dt = time.perf_counter() - t0
    out = {"env_steps_per_s": batch * steps / dt, "mean_reward": float(rewards.mean())}
    print(f"[native path] {out['env_steps_per_s']:,.0f} env-steps/s; mean reward "
          f"{out['mean_reward']:.4f}", flush=True)
    return out


if __name__ == "__main__":
    args, device, _ = split_options(sys.argv[1:])
    env_name = args[0] if args else "ant_tag"
    batch = int(args[1]) if len(args) > 1 else 16
    steps = int(args[2]) if len(args) > 2 else 200
    gym_path(env_name, batch, steps, device=device)
    native_path(env_name, batch, steps, device=device)
