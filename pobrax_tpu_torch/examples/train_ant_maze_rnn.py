"""Recurrent PPO learns AntMaze; the port of examples/train_ant_maze_rnn.py.

AntMaze's true reward is terminal-sparse (goal_reward on arrival), so
training uses privileged progress shaping, and in a maze the euclidean
potential is wrong (on maze 0's U-shaped corridor the straight line to the
goal points through the dividing wall). `ShapedAntMaze` shapes on the
GEODESIC distance instead: `maze_utils.geodesic_distance_field` computed on
the host once, uploaded to the env's device, and read per env by a clipped
bilinear lookup. Evaluation (`goal_rate_rnn`, `goal_rate_random`) reports
the TRUE sparse goal rate on the unshaped env.

Training saves its state to the checkpoint dir (`--checkpoint-dir PATH`,
runs/ant_maze_rnn_ckpt unless named) every 50M env-steps and at the end, as
JAX's example does; the same command run again resumes from the latest step
dir (the envs and the cached autoreset's clock restart, and the epoch count
is folded into the key). `progress.jsonl` there keeps the curve, each call
and its seed, so the record holds the curve of every call, `calls` (the
env-steps each call trained, its training's seconds and the card), `wall_s`
and `device`. Each seed needs its own dir: a dir whose log names another
seed raises before anything trains.

Usage: python -m pobrax_tpu_torch.examples.train_ant_maze_rnn [num_timesteps] [num_envs]
       [--device cpu] [--out PATH] [--checkpoint-dir PATH]   (MAZE_SEED and MAZE_OUT as in
       JAX; one checkpoint dir per MAZE_SEED)
"""

from __future__ import annotations

import os
import sys
from typing import Callable, Optional

import torch

from pobrax_tpu_torch.envs import HAI_ACTION_REPEAT, _envs, maze_utils
from pobrax_tpu_torch.envs.base import Env, State, Wrapper
from pobrax_tpu_torch.device import resolve
from pobrax_tpu_torch.examples._common import (ProgressLog, env_int, run_episodes, run_path,
                                               split_options, uniform_actions, write_json)
from pobrax_tpu_torch.training import ppo_rnn
from pobrax_tpu_torch.utils.profiling import record_device

HIDDEN = 128
# examples/train_ant_maze_rnn.py's ppo_rnn.train arguments but the env, the
# budget, the batch, the checkpoint dir, the seed and the progress function
RECIPE = dict(episode_length=1000, action_repeat=HAI_ACTION_REPEAT, unroll_length=32,
              num_minibatches=8, num_update_epochs=4, learning_rate=3e-4, entropy_cost=3e-3,
              discounting=0.97, reward_scaling=1.0, hidden_size=HIDDEN, encoder_sizes=(256,),
              epochs_per_call=8, autoreset_mode="cached")


class ShapedAntMaze(Wrapper):
    """TRAINING-TIME geodesic progress shaping: r' = r + coef * (phi' - phi),
    phi = -geodesic_dist_to_goal(torso_xy) per env (pure progress form,
    shaping gamma = 1)."""

    def __init__(self, env: Env, coef: float = 1.0, subdivisions: int = 5):
        super().__init__(env)
        self.coef = coef
        u = self.unwrapped
        structure = maze_utils.construct_maze(u.maze_id, u.length)
        if u._goals.shape[0] != 1:
            raise ValueError("geodesic shaping assumes a single-goal maze")
        field, x0, y0, res = maze_utils.geodesic_distance_field(structure, u.scaling,
                                                                subdivisions)
        self._field = torch.as_tensor(field, device=u.device)
        self._x0, self._y0, self._res = float(x0), float(y0), float(res)

    def _phi(self, qp) -> torch.Tensor:
        """The field bilinearly interpolated at each env's torso xy, the grid
        coordinates clipped to [0, size - 1.001] (JAX's lookup)."""
        u = self.unwrapped
        xy = qp.pos[:, u.torso_idx, :2]
        f = self._field
        a = torch.clamp((self._y0 - xy[:, 1]) / self._res, 0.0, f.shape[0] - 1.001)
        b = torch.clamp((xy[:, 0] - self._x0) / self._res, 0.0, f.shape[1] - 1.001)
        ia, ib = torch.floor(a).long(), torch.floor(b).long()
        ta, tb = a - ia, b - ib
        d = ((1 - ta) * (1 - tb) * f[ia, ib] + (1 - ta) * tb * f[ia, ib + 1]
             + ta * (1 - tb) * f[ia + 1, ib] + ta * tb * f[ia + 1, ib + 1])
        return -d

    def step(self, state: State, action: torch.Tensor) -> State:
        p0 = self._phi(state.qp)
        nstate = self.env.step(state, action)
        return nstate.replace(reward=nstate.reward + self.coef * (self._phi(nstate.qp) - p0))


def _goal_rate(env_core: Env, act: Callable, carry, episodes: int, episode_length: int,
               seed: int, action_repeat: int) -> float:
    reached = torch.zeros(episodes, device=env_core.device)

    def observe(state, alive):
        torch.maximum(reached, state.done * alive * (state.reward > 1.0), out=reached)

    run_episodes(env_core, act, carry, observe, episodes, episode_length, seed, action_repeat)
    return float(reached.mean())


def goal_rate_rnn(env_core: Env, inference_fn: Callable, params, hidden_size: int,
                  episodes: int = 256, episode_length: int = 1000, seed: int = 0,
                  action_repeat: int = 1, deterministic: bool = True) -> float:
    """The share of evaluation episodes ending AT THE GOAL (a done with
    reward > 1: +goal_reward; death at dying_cost and truncation do not
    count), with a GRU policy."""
    def act(h, obs, k):
        return inference_fn(params, h, obs, k, deterministic=deterministic)

    return _goal_rate(env_core, act, torch.zeros(episodes, hidden_size, device=env_core.device),
                      episodes, episode_length, seed, action_repeat)


def goal_rate_random(env_core: Env, episodes: int = 256, episode_length: int = 1000,
                     seed: int = 0, action_repeat: int = 1) -> float:
    """`goal_rate_rnn`'s measurement with uniform random actions."""
    asz = env_core.action_size
    return _goal_rate(env_core, lambda c, obs, k: (c, uniform_actions(k, (episodes, asz))), None,
                      episodes, episode_length, seed, action_repeat)


def main(num_timesteps: int = 400_000_000, num_envs: int = 2048,
         checkpoint_dir: Optional[str] = None, device=None, out: Optional[str] = None) -> dict:
    """`checkpoint_dir`: runs/ant_maze_rnn_ckpt unless named; its progress
    log must name no seed but MAZE_SEED."""
    seed = env_int("MAZE_SEED", 0)
    checkpoint_dir = checkpoint_dir or run_path("ant_maze_rnn_ckpt")
    dev = resolve(device)
    card = record_device(dev)["card"]
    log = ProgressLog(checkpoint_dir, card, seed=seed)
    rand = goal_rate_random(_envs["ant_maze"](device=device), action_repeat=HAI_ACTION_REPEAT)
    print(f"random-policy goal rate: {rand:.3f}", flush=True)

    history = log.curve()

    def progress(steps, metrics):
        log(steps, metrics)
        history.append({"steps": steps, "mean_reward": metrics.get("mean_reward")})
        if len(history) % 20 == 0:
            print(f"  {steps:>12,} steps  mean_reward={history[-1]['mean_reward']:+.4f}",
                  flush=True)

    inference_fn, params, _ = ppo_rnn.train(
        ShapedAntMaze(_envs["ant_maze"](device=device), coef=5.0),
        num_timesteps=num_timesteps, num_envs=num_envs, checkpoint_dir=checkpoint_dir,
        checkpoint_every=50_000_000, seed=seed, progress_fn=progress, **RECIPE)

    results = {}
    for det in (True, False):
        r = goal_rate_rnn(_envs["ant_maze"](device=device), inference_fn, params, HIDDEN,
                          action_repeat=HAI_ACTION_REPEAT, deterministic=det)
        results["det" if det else "stoch"] = r
        print(f"GRU goal rate ({'det' if det else 'stoch'}): {r:.3f} (random: {rand:.3f})",
              flush=True)
    payload = {"num_timesteps": num_timesteps, "num_envs": num_envs, "hidden_size": HIDDEN,
               "seed": seed, "random_goal_rate": rand, "results": results,
               "curve": history[::10]}
    calls = log.calls()
    if calls:  # a learner that reported nothing leaves JAX's record as it is
        payload.update(device=card or str(dev), calls=calls,
                       wall_s=sum(c["train_s"] for c in calls))
        print(f"trained {history[-1]['steps']:,} env-steps over {len(calls)} call(s) in "
              f"{payload['wall_s']:.1f} s; {payload['device']}", flush=True)
    out = out or os.environ.get(
        "MAZE_OUT", run_path("learning_ant_maze_rnn" + (f"_seed{seed}" if seed != 0 else "")
                             + ".json"))
    write_json(out, payload)
    return payload


if __name__ == "__main__":
    args, device, out, checkpoint_dir = split_options(sys.argv[1:], "--checkpoint-dir")
    main(*[int(a) for a in args[:2]], checkpoint_dir=checkpoint_dir, device=device, out=out)
