"""What the example modules share: the evaluators' env stack, key order and
loop, uniform random actions, and where a run's record and checkpoints go."""

from __future__ import annotations

import json
import os
from typing import Callable, Optional, Sequence

import torch

from pobrax_tpu_torch import random as jr
from pobrax_tpu_torch.envs import wrappers
from pobrax_tpu_torch.envs.base import Env, State

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# a run's records and checkpoints (gitignored); the JAX examples write docs/
RUNS = os.path.join(ROOT, "runs")


def run_path(name: str) -> str:
    """`runs/<name>`."""
    return os.path.join(RUNS, name)


def split2(key: torch.Tensor):
    return jr.split(key, 2).unbind(-2)


def uniform_actions(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """`jax.random.uniform(key, shape, minval=-1.0, maxval=1.0)`."""
    return jr.uniform(key, tuple(shape), -1.0, 1.0)


@torch.no_grad()
def run_episodes(env_core: Env, act_fn: Callable, carry, observe: Callable[[State, torch.Tensor],
                                                                         None],
                 episodes: int, episode_length: int, seed: int,
                 action_repeat: int = 1) -> State:
    """The loop of every evaluator of the examples: `episodes` parallel
    episodes of `env_core` under ActionRepeat -> Episode(episode_length) ->
    Vmap, reset from `split(k_reset, episodes)` with `k_reset, key =
    split(PRNGKey(seed))`, then per control step `key, k = split(key)`,
    `carry, action = act_fn(carry, obs, k)`, the env step, and
    `observe(state, alive)` with `alive` the episodes that had not ended
    before this step. It stops once every episode has ended, where no
    evaluator's sums can change any more (the JAX examples scan all
    `episode_length` steps). Returns the reset state."""
    env = wrappers.ActionRepeatWrapper(env_core, action_repeat)
    env = wrappers.EpisodeWrapper(env, episode_length, 1)
    env = wrappers.VmapWrapper(env, batch_size=episodes)
    k_reset, key = split2(jr.PRNGKey(seed, env.device))
    state = first = env.reset(jr.split(k_reset, episodes))
    alive = torch.ones(episodes, device=env.device)
    for t in range(episode_length):
        key, k = split2(key)
        carry, act = act_fn(carry, state.obs, k)
        state = env.step(state, act)
        observe(state, alive)
        alive = alive * (1.0 - state.done)
        if t % 10 == 9 and not bool(alive.any()):
            break
    return first


def make_parent(path: str) -> str:
    """Makes `path`'s directory; returns `path`."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    return path


def write_json(out: str, payload: dict) -> None:
    """Writes `payload` to `out`, making its directory."""
    with open(make_parent(out), "w") as f:
        json.dump(payload, f, indent=1)
    print(f"wrote {out}", flush=True)


def env_int(name: str, default: int, environ: Optional[dict] = None) -> int:
    return int((os.environ if environ is None else environ).get(name, str(default)))


def split_options(argv):
    """(argv without `--device D` / `--out P`, device or None, out or None):
    the options every example's command line takes besides the JAX one's."""
    rest, found = [], {"--device": None, "--out": None}
    it = iter(argv)
    for a in it:
        if a in found:
            found[a] = next(it)
        else:
            rest.append(a)
    return rest, found["--device"], found["--out"]
