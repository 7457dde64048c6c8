"""PPO learns AntTag; the port of examples/train_ant_tag.py.

Trains feed-forward PPO on a potential-shaped AntTag (`ShapedAntTag`) at the
example's recipe and reports the deterministic and stochastic policy's TRUE
sparse tag rate (`tag_rate`: the share of evaluation episodes that end in a
tag) beside the random policy's. The record goes to `--out`
(runs/learning_ant_tag.json unless named).

Usage: python -m pobrax_tpu_torch.examples.train_ant_tag [num_timesteps] [num_envs]
       [--device cpu] [--out PATH]
"""

from __future__ import annotations

import sys
from typing import Callable, Optional

import torch

from pobrax_tpu_torch.envs import HAI_ACTION_REPEAT, _envs
from pobrax_tpu_torch.envs.base import Env, State, Wrapper
from pobrax_tpu_torch.examples._common import (run_episodes, run_path, split_options,
                                               uniform_actions, write_json)
from pobrax_tpu_torch.training import ppo


class ShapedAntTag(Wrapper):
    """TRAINING-TIME potential-based reward shaping for the sparse tag task:
    r' = r + coef * (gamma * phi(s') - phi(s)), phi = -||torso_xy - target_xy||
    per env. The default gamma = 1 is the pure progress form (the JAX
    example's docstring gives the measured reason: with gamma < 1 the term
    carries a standing bonus for keeping the target far). The shaping reads
    the privileged target position even outside the visible radius, which
    is legitimate at training time; evaluation reports the true sparse rate
    on the unshaped env."""

    def __init__(self, env: Env, coef: float = 1.0, gamma: float = 1.0):
        super().__init__(env)
        self.coef = coef
        self.gamma = gamma

    def _dist(self, qp) -> torch.Tensor:
        u = self.unwrapped
        return torch.linalg.norm(qp.pos[:, u.torso_idx, :2] - qp.pos[:, u.target_idx, :2], dim=-1)

    def step(self, state: State, action: torch.Tensor) -> State:
        d0 = self._dist(state.qp)
        nstate = self.env.step(state, action)
        d1 = self._dist(nstate.qp)
        return nstate.replace(reward=nstate.reward + self.coef * (self.gamma * (-d1) - (-d0)))


def tag_rate(env_core: Env, act_fn: Callable, episodes: int = 256, episode_length: int = 1000,
             seed: int = 0, action_repeat: int = 1) -> float:
    """The share of parallel episodes that end via a tag (a done with reward
    > 0.5; death and truncation do not count). `act_fn(obs, key) -> action`."""
    tagged = torch.zeros(episodes, device=env_core.device)

    def observe(state, alive):
        torch.maximum(tagged, state.done * alive * (state.reward > 0.5), out=tagged)

    run_episodes(env_core, lambda c, obs, k: (c, act_fn(obs, k)), None, observe, episodes,
                 episode_length, seed, action_repeat)
    return float(tagged.mean())


def random_act(action_size: int) -> Callable:
    """The examples' uniform random policy, `act_fn(obs, key)`."""
    return lambda obs, k: uniform_actions(k, obs.shape[:-1] + (action_size,))


def main(num_timesteps: int = 300_000_000, num_envs: int = 4096, device=None,
         out: Optional[str] = None) -> dict:
    env = _envs["ant_tag"](device=device)

    # NOTE: ActionRepeatWrapper rescales the wrapped System's dt / substeps,
    # so training and every evaluation get their own env instance
    rand = tag_rate(_envs["ant_tag"](device=device), random_act(env.action_size),
                    action_repeat=HAI_ACTION_REPEAT)
    print(f"random-policy tag rate: {rand:.3f}", flush=True)

    history = []

    def progress(steps, metrics):
        entry = {"steps": steps, "mean_reward": metrics.get("mean_reward"),
                 "steps_per_second": metrics.get("steps_per_second")}
        history.append(entry)
        if len(history) % 20 == 0:
            print(f"  {steps:>12,} steps  mean_reward={entry['mean_reward']:+.4f}  "
                  f"({entry['steps_per_second']:,.0f} steps/s)", flush=True)

    inference_fn, params, _ = ppo.train(
        ShapedAntTag(_envs["ant_tag"](device=device), coef=5.0),
        num_timesteps=num_timesteps, num_envs=num_envs, episode_length=1000,
        action_repeat=HAI_ACTION_REPEAT, unroll_length=16, num_minibatches=32,
        num_update_epochs=4, learning_rate=3e-4, entropy_cost=3e-3, discounting=0.97,
        reward_scaling=1.0, seed=0, progress_fn=progress)

    trained = tag_rate(_envs["ant_tag"](device=device),
                       lambda obs, k: inference_fn(params, obs, k, deterministic=True),
                       action_repeat=HAI_ACTION_REPEAT)
    trained_stoch = tag_rate(_envs["ant_tag"](device=device),
                             lambda obs, k: inference_fn(params, obs, k),
                             action_repeat=HAI_ACTION_REPEAT, seed=1)
    print(f"trained tag rate: det {trained:.3f} / stoch {trained_stoch:.3f} "
          f"(random: {rand:.3f})", flush=True)
    payload = {"num_timesteps": num_timesteps, "num_envs": num_envs, "random_tag_rate": rand,
               "trained_tag_rate": trained, "trained_tag_rate_stochastic": trained_stoch,
               "curve": history}
    write_json(out or run_path("learning_ant_tag.json"), payload)
    return payload


if __name__ == "__main__":
    args, device, out = split_options(sys.argv[1:])
    main(*[int(a) for a in args[:2]], device=device, out=out)
