"""Recurrent PPO on AntHeavenHell, the priest-memory task; the port of
examples/train_heavenhell_rnn.py.

Heaven and hell swap sides every episode, and the heaven direction is
observed only near the priest, so a memoryless policy completes no better
than 50% heaven. Training uses privileged progress shaping toward heaven
(`ShapedHeavenHell`); evaluation (`outcome_rates`) reports on the TRUE env
the completion rate and the heaven rate among completions. `HH_SUBSTEPS=8`
trains on the retuned integrator (`Env.retune_substeps`) and also evaluates
on the true 10-substep env.

`--checkpoint-dir PATH` saves the training state there every 50M env-steps
and at the end, as examples/train_ant_maze_rnn.py does; the same command run
again resumes from the latest step dir (the envs reset and the epoch count is
folded into the key, so a resumed run is not the uncut run's trajectory).
The record then holds the curve of every call, `calls` (the env-steps each
call trained, its training's seconds and the card), `wall_s` and `device`.

Usage: python -m pobrax_tpu_torch.examples.train_heavenhell_rnn [num_timesteps] [num_envs]
       [--device cpu] [--out PATH] [--checkpoint-dir PATH]
"""

from __future__ import annotations

import sys
from typing import Callable, Optional, Tuple

import torch

from pobrax_tpu_torch.envs import HAI_ACTION_REPEAT, _envs
from pobrax_tpu_torch.envs.base import Env, State, Wrapper
from pobrax_tpu_torch.examples._common import (ProgressLog, env_int, run_episodes, run_path,
                                               split_options, uniform_actions, write_json)
from pobrax_tpu_torch.training import ppo_rnn
from pobrax_tpu_torch.utils.profiling import record_device

HIDDEN = 128
# examples/train_heavenhell_rnn.py's ppo_rnn.train arguments but the env,
# the budget, the batch and the progress function
RECIPE = dict(episode_length=1000, action_repeat=HAI_ACTION_REPEAT, unroll_length=32,
              num_minibatches=8, num_update_epochs=4, learning_rate=3e-4, entropy_cost=3e-3,
              discounting=0.97, reward_scaling=1.0, hidden_size=HIDDEN, encoder_sizes=(256,),
              seed=0)
CHECKPOINT_EVERY = 50_000_000  # examples/train_ant_maze_rnn.py's


class ShapedHeavenHell(Wrapper):
    """Training-time progress shaping toward the (privileged) heaven goal:
    r' = r + coef * (d_prev - d_new), d = ||torso_xy - heaven_xy|| per env."""

    def __init__(self, env: Env, coef: float = 5.0):
        super().__init__(env)
        self.coef = coef

    def _dist(self, qp) -> torch.Tensor:
        u = self.unwrapped
        return torch.linalg.norm(qp.pos[:, u.torso_idx, :2] - qp.pos[:, u.target_idx, :2], dim=-1)

    def step(self, state: State, action: torch.Tensor) -> State:
        d0 = self._dist(state.qp)
        nstate = self.env.step(state, action)
        d1 = self._dist(nstate.qp)
        return nstate.replace(reward=nstate.reward + self.coef * (d0 - d1))


def outcome_rates(env_core: Env, act_fn: Callable, carry_init: Callable, episodes: int = 256,
                  episode_length: int = 1000, seed: int = 0,
                  action_repeat: int = 1) -> Tuple[float, float]:
    """(completion_rate, heaven_rate | completed) on the TRUE env: an
    episode completes when its first done comes with reward > 0.5 (heaven)
    or within 0.25 of -1 (hell). `act_fn(carry, obs, key) -> (carry,
    action)`, `carry_init(episodes)` the first carry."""
    dev = env_core.device
    heaven = torch.zeros(episodes, device=dev)
    hell = torch.zeros(episodes, device=dev)

    def observe(state, alive):
        first_done = state.done * alive
        heaven.add_(first_done * (state.reward > 0.5))
        hell.add_(first_done * ((state.reward + 1.0).abs() < 0.25))

    run_episodes(env_core, act_fn, carry_init(episodes), observe, episodes, episode_length, seed,
                 action_repeat)
    completed = heaven.sum() + hell.sum()
    rate = torch.where(completed > 0, heaven.sum() / completed, torch.zeros_like(completed))
    return float(completed / episodes), float(rate)


def substeps_knob(environ: Optional[dict] = None) -> int:
    """HH_SUBSTEPS (10 unless set): the integrator's substeps to train at."""
    return env_int("HH_SUBSTEPS", 10, environ)


def _hh(substeps: Optional[int] = None, device=None) -> Env:
    """A core AntHeavenHell, retuned to `substeps` (HH_SUBSTEPS unless
    given) before any wrapper when that is not 10."""
    env = _envs["ant_heavenhell"](device=device)
    substeps = substeps or substeps_knob()
    if substeps != 10:
        env.retune_substeps(substeps)
    return env


def random_policy(action_size: int, device) -> dict:
    """`outcome_rates`' act_fn and carry_init of the uniform random policy."""
    return {"act_fn": lambda c, obs, k: (c, uniform_actions(k, obs.shape[:-1] + (action_size,))),
            "carry_init": lambda n: torch.zeros(n, device=device)}


def gru_policy(inference_fn, params, hidden: int, device, deterministic: bool = False) -> dict:
    """`outcome_rates`' act_fn and carry_init of a GRU policy."""
    return {"act_fn": lambda h, obs, k: inference_fn(params, h, obs, k,
                                                     deterministic=deterministic),
            "carry_init": lambda n: torch.zeros(n, hidden, device=device)}


def main(num_timesteps: int = 400_000_000, num_envs: int = 2048, device=None,
         out: Optional[str] = None, checkpoint_dir: Optional[str] = None) -> dict:
    substeps = substeps_knob()
    env = _envs["ant_heavenhell"](device=device)
    rand_c, rand_h = outcome_rates(_envs["ant_heavenhell"](device=device),
                                   **random_policy(env.action_size, env.device),
                                   action_repeat=HAI_ACTION_REPEAT)
    print(f"random: completion {rand_c:.3f}, heaven|completed {rand_h:.3f}", flush=True)

    history = []

    def progress(steps, metrics):
        history.append({"steps": steps, "mean_reward": metrics.get("mean_reward")})
        if len(history) % 50 == 0:
            print(f"  {steps:>12,} steps  mean_reward={history[-1]['mean_reward']:+.4f}",
                  flush=True)

    resumable = {}
    if checkpoint_dir is not None:
        card = record_device(env.device)["card"]
        log = ProgressLog(checkpoint_dir, card)
        history[:] = log.curve()

        def logged(steps, metrics):
            log(steps, metrics)
            progress(steps, metrics)

        resumable = dict(checkpoint_dir=checkpoint_dir, checkpoint_every=CHECKPOINT_EVERY)
    inference_fn, params, _ = ppo_rnn.train(
        ShapedHeavenHell(_hh(substeps, device), coef=5.0),
        num_timesteps=num_timesteps, num_envs=num_envs,
        progress_fn=progress if checkpoint_dir is None else logged, **resumable, **RECIPE)

    det_c, det_h = outcome_rates(_hh(substeps, device),
                                 **gru_policy(inference_fn, params, HIDDEN, env.device, True),
                                 action_repeat=HAI_ACTION_REPEAT)
    sto_c, sto_h = outcome_rates(_hh(substeps, device),
                                 **gru_policy(inference_fn, params, HIDDEN, env.device),
                                 action_repeat=HAI_ACTION_REPEAT, seed=1)
    print(f"GRU det:   completion {det_c:.3f}, heaven|completed {det_h:.3f}", flush=True)
    print(f"GRU stoch: completion {sto_c:.3f}, heaven|completed {sto_h:.3f}", flush=True)
    payload = {"num_timesteps": num_timesteps, "num_envs": num_envs, "substeps": substeps,
               "random": {"completion": rand_c, "heaven": rand_h},
               "gru_det": {"completion": det_c, "heaven": det_h},
               "gru_stoch": {"completion": sto_c, "heaven": sto_h}, "curve": history}
    if checkpoint_dir is not None:
        calls = log.calls()
        payload.update(device=card or str(env.device), calls=calls,
                       wall_s=sum(c["train_s"] for c in calls))
        print(f"trained {num_timesteps:,} env-steps over {len(calls)} call(s) in "
              f"{payload['wall_s']:.1f} s; {payload['device']}", flush=True)
    if substeps != 10:
        # transfer: the retuned-env policy evaluated on the true physics
        t_c, t_h = outcome_rates(_hh(10, device),
                                 **gru_policy(inference_fn, params, HIDDEN, env.device, True),
                                 action_repeat=HAI_ACTION_REPEAT)
        payload["gru_det_on_true_substeps10"] = {"completion": t_c, "heaven": t_h}
        print(f"GRU det on TRUE substeps=10 env: completion {t_c:.3f}, heaven|completed "
              f"{t_h:.3f}", flush=True)
    name = ("learning_heavenhell_rnn.json" if substeps == 10
            else f"learning_heavenhell_rnn_substeps{substeps}.json")
    write_json(out or run_path(name), payload)
    return payload


if __name__ == "__main__":
    args, device, out, checkpoint_dir = split_options(sys.argv[1:], "--checkpoint-dir")
    main(*[int(a) for a in args[:2]], device=device, out=out, checkpoint_dir=checkpoint_dir)
