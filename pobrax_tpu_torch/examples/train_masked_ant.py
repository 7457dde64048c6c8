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

`--checkpoint-dir PATH` gives each arm its own subdirectory (`ARMS`), where
its learner saves every CHECKPOINT_EVERY env-steps and at the end, and a
`ProgressLog` that names MASKED_SEED and `recipe` (the env and the envs;
not the budget, so that a call with a larger one resumes) and refuses
another run's dir. The same command run again resumes each arm from its
latest step dir. An arm whose latest step dir covers the budget is
evaluated once, into its log; later calls neither train nor evaluate it
again. `--arm NAME` limits a call to one arm, so that the three can run as
three processes on one card: an arm's training does not depend on the
others. A call that finds all three arms evaluated writes the record:
JAX's keys, plus `calls` (per arm, the env-steps each call trained, its
training's seconds and the card) and `device`.

Usage: python -m pobrax_tpu_torch.examples.train_masked_ant [num_timesteps] [num_envs]
       [--device cpu] [--out PATH] [--checkpoint-dir PATH [--arm NAME]]
"""

from __future__ import annotations

import os
import sys
from typing import Callable, Optional, Tuple

import torch

from pobrax_tpu_torch.device import resolve
from pobrax_tpu_torch.envs import _envs
from pobrax_tpu_torch.envs.base import Env
from pobrax_tpu_torch.envs.masked import MaskedObservationWrapper
from pobrax_tpu_torch.examples._common import (ProgressLog, env_int, run_episodes, run_path,
                                               saved_steps, split_options, write_json)
from pobrax_tpu_torch.training import ppo, ppo_rnn
from pobrax_tpu_torch.utils.profiling import record_device

EPISODE_LENGTH = 1000
HIDDEN = 128
# the arms' checkpoint subdirectories, in training order, and their keys in the record
ARMS = ("ff_full", "ff_masked", "gru_masked")
RESULT_KEYS = dict(zip(ARMS, ("feedforward_full_obs", "feedforward_masked", "gru_masked")))
CHECKPOINT_EVERY = 5_000_000  # 77 epochs at 2048 envs
# every arm's training knobs but the budget, the envs and the seed
RECIPE = dict(episode_length=EPISODE_LENGTH, unroll_length=32, num_update_epochs=4,
              learning_rate=3e-4, entropy_cost=1e-2, discounting=0.97, reward_scaling=1.0)


def env_name(environ: Optional[dict] = None) -> str:
    """MASKED_ENV ("ant" unless set)."""
    return (os.environ if environ is None else environ).get("MASKED_ENV", "ant")


def masked_env(device=None, name: Optional[str] = None) -> Env:
    """The stock env (`env_name()` unless named) with its VELOCITY segment
    hidden."""
    name = name or env_name()
    return MaskedObservationWrapper(_envs[name](device=device), env_name=name,
                                    hidden=("VELOCITY",))


def arm_env(arm: str, device=None, name: Optional[str] = None) -> Env:
    """The env an arm trains and is evaluated on: the full observation for
    "ff_full", else the masked one."""
    name = name or env_name()
    return _envs[name](device=device) if arm == "ff_full" else masked_env(device, name)


def train_arm(arm: str, env: Env, **kwargs):
    """The arm's learner's `train` at its widths: PPO with 32 minibatches,
    or for "gru_masked" GRU-PPO with 8, hidden HIDDEN, encoder (256,)."""
    if arm == "gru_masked":
        return ppo_rnn.train(env, num_minibatches=8, hidden_size=HIDDEN, encoder_sizes=(256,),
                             **kwargs)
    return ppo.train(env, num_minibatches=32, **kwargs)


def det_policy(arm: str, inference_fn: Callable, params,
               device) -> Tuple[Callable, Optional[Callable]]:
    """(act_fn, carry_init) of `eval_policy` for an arm's deterministic
    policy: the GRU's hidden state as the carry, none for feed-forward."""
    if arm == "gru_masked":
        return (lambda h, obs, k: inference_fn(params, h, obs, k, deterministic=True),
                lambda n: torch.zeros(n, HIDDEN, device=device))
    return lambda c, obs, k: (c, inference_fn(params, obs, k, deterministic=True)), None


def learner_for(arm: str, device=None, name: Optional[str] = None):
    """The learner an arm's saved state restores into: `train_arm`'s, at
    its widths, on the arm's env."""
    env = arm_env(arm, device, name)
    if arm == "gru_masked":
        return ppo_rnn.RNNPPOLearner(env, ppo_rnn.RNNPPOConfig(
            num_minibatches=8, hidden_size=HIDDEN, encoder_sizes=(256,), **RECIPE))
    return ppo.PPOLearner(env, ppo.PPOConfig(num_minibatches=32, **RECIPE))


def evaluate(arm: str, inference_fn: Callable, params, device=None,
             name: Optional[str] = None, seed: int = 0, episodes: int = 256) -> dict:
    """`eval_policy` of an arm's deterministic policy on a fresh env of its
    observation regime."""
    env = arm_env(arm, device, name)
    act_fn, carry_init = det_policy(arm, inference_fn, params, env.device)
    return eval_policy(env, act_fn, carry_init=carry_init, episodes=episodes, seed=seed)


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


def recipe(name: str, num_envs: int) -> dict:
    """What an arm's log names besides the seed: the env and the envs."""
    return {"env": name, "num_envs": num_envs}


def main(num_timesteps: int = 100_000_000, num_envs: int = 2048, device=None,
         out: Optional[str] = None, checkpoint_dir: Optional[str] = None,
         arm: Optional[str] = None) -> dict:
    name = env_name()
    seed = env_int("MASKED_SEED", 0)
    if arm is not None and (checkpoint_dir is None or arm not in ARMS):
        raise ValueError(f"--arm takes one of {ARMS}, with --checkpoint-dir")
    arms = ARMS if arm is None else (arm,)
    common = dict(num_timesteps=num_timesteps, num_envs=num_envs, **RECIPE, seed=seed,
                  progress_fn=lambda s, m: None)
    results = {}
    for a in arms:
        if checkpoint_dir is None:
            inference_fn, params, _ = train_arm(a, arm_env(a, device, name), **common)
            results[RESULT_KEYS[a]] = evaluate(a, inference_fn, params, device, name)
        else:
            arm_dir = os.path.join(checkpoint_dir, a)
            log = ProgressLog(arm_dir, record_device(resolve(device))["card"], seed=seed,
                              recipe=recipe(name, num_envs))
            steps = saved_steps(arm_dir)
            result = log.evaluation(steps) if steps >= num_timesteps else None
            if result is None:  # an arm whose budget is covered and evaluated trains nothing
                inference_fn, params, _ = train_arm(
                    a, arm_env(a, device, name), **{**common, "checkpoint_dir": arm_dir,
                                                    "checkpoint_every": CHECKPOINT_EVERY,
                                                    "progress_fn": log})
                result = evaluate(a, inference_fn, params, device, name)
                log.evaluated(saved_steps(arm_dir), result)
            results[RESULT_KEYS[a]] = result
        print(f"{a}: {results[RESULT_KEYS[a]]}", flush=True)

    if checkpoint_dir is not None:
        dirs = {a: os.path.join(checkpoint_dir, a) for a in ARMS}
        kept = {a: ProgressLog.read(d) for a, d in dirs.items()}
        calls = {a: log.calls() for a, log in kept.items()}
        for a, arm_calls in calls.items():
            steps, wall = (sum(c["to"] - c["from"] for c in arm_calls),
                           sum(c["train_s"] for c in arm_calls))
            print(f"{a}: {steps:,} env-steps trained in {wall:.1f} s over {len(arm_calls)} "
                  f"call(s)" + (f", {steps / wall:,.0f} env-steps/s" if wall else ""),
                  flush=True)
        done = {a: kept[a].evaluation(saved_steps(d)) if saved_steps(d) >= num_timesteps
                else None for a, d in dirs.items()}
        if None in done.values():
            return results  # the record waits for every arm's evaluation
        results = {RESULT_KEYS[a]: done[a] for a in ARMS}
    results.update(env=name, hidden=["VELOCITY"], num_timesteps=num_timesteps,
                   num_envs=num_envs, episode_cap=EPISODE_LENGTH)
    if checkpoint_dir is not None:
        cards = sorted({c["card"] or "cpu" for arm_calls in calls.values() for c in arm_calls})
        results.update(calls=calls, device=" / ".join(cards) or "cpu")
    write_json(out or os.environ.get("MASKED_OUT", run_path(f"learning_masked_{name}.json")),
               results)
    return results


def cli(argv) -> dict:
    """`main` from the command line's arguments."""
    args, device, out, checkpoint_dir, arm = split_options(argv, "--checkpoint-dir", "--arm")
    return main(*[int(a) for a in args[:2]], device=device, out=out,
                checkpoint_dir=checkpoint_dir, arm=arm)


if __name__ == "__main__":
    cli(sys.argv[1:])
