"""Env registry and factory; the port of `pobrax_tpu/envs/__init__.py`.

`create(env_name, ..., device=None)` assembles the wrapper stack in the JAX
factory's order: ActionRepeat -> Episode -> Vmap -> autoreset -> Eval.
`MaskedObservationWrapper(env, env_name=..., hidden=...)` on top makes the
PO variant of a stock env, as `bench.py`'s `masked_<name>` does. Every env of
the JAX registry is registered. `create_fn` and `register` mirror the JAX
factory; `create_gym_env` builds the gymnasium adapters of
`envs/gym_adapter.py`, imported lazily so that pure-tensor users never import
gymnasium. `HAI_ACTION_REPEAT = 6` is the reference's 0.3 s control interval.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

from pobrax_tpu_torch.envs import wrappers
from pobrax_tpu_torch.envs.acrobot import Acrobot
from pobrax_tpu_torch.envs.ant import Ant
from pobrax_tpu_torch.envs.ant_gather import AntGatherEnv
from pobrax_tpu_torch.envs.ant_heavenhell import AntHeavenHellEnv
from pobrax_tpu_torch.envs.ant_maze import AntMazeEnv
from pobrax_tpu_torch.envs.ant_tag import AntTagEnv
from pobrax_tpu_torch.envs.base import Env, State, Wrapper
from pobrax_tpu_torch.envs.fast import Fast
from pobrax_tpu_torch.envs.fetch import Fetch
from pobrax_tpu_torch.envs.grasp import Grasp
from pobrax_tpu_torch.envs.humanoid import Humanoid, HumanoidStandup
from pobrax_tpu_torch.envs.masked import MaskedObservationWrapper
from pobrax_tpu_torch.envs.pendulum import InvertedDoublePendulum, InvertedPendulum
from pobrax_tpu_torch.envs.planar import Halfcheetah, Hopper, Walker2d
from pobrax_tpu_torch.envs.reacher import Reacher, ReacherAngle
from pobrax_tpu_torch.envs.ur5e import Ur5e

HAI_ACTION_REPEAT = 6

_envs = {
    "acrobot": Acrobot,
    "ant": Ant,
    "ant_tag": AntTagEnv,
    "ant_heavenhell": AntHeavenHellEnv,
    "ant_gather": AntGatherEnv,
    "ant_maze": AntMazeEnv,
    "fast": Fast,
    "fetch": Fetch,
    "grasp": Grasp,
    "halfcheetah": Halfcheetah,
    "hopper": Hopper,
    "humanoid": Humanoid,
    "humanoidstandup": HumanoidStandup,
    "inverted_pendulum": InvertedPendulum,
    "inverted_double_pendulum": InvertedDoublePendulum,
    "reacher": Reacher,
    "reacherangle": ReacherAngle,
    "ur5e": Ur5e,
    "walker2d": Walker2d,
}


def register(name: str, cls) -> None:
    _envs[name] = cls


def create(
    env_name: str,
    episode_length: Optional[int] = 1000,
    action_repeat: Optional[int] = 1,
    auto_reset: bool = True,
    batch_size: Optional[int] = None,
    eval_metrics: bool = False,
    randomized_autoreset: bool = False,
    autoreset_mode: str = "naive",
    device=None,
    **kwargs,
) -> Env:
    """Create an Env with the JAX factory's wrapper stack.

    `device` is "cuda" unless given ("cpu" runs the plain PyTorch path); with
    no GPU and no device this raises. `randomized_autoreset=True` swaps the
    cached AutoResetWrapper for a randomised one, chosen by `autoreset_mode`:
    'naive' (resample every step — reference parity) or 'cached' (cached
    fresh states refreshed every 200 steps). `eval_metrics=True` adds the
    EvalWrapper on top. `substeps=N` retunes the integrator; `info="contact"`
    builds the System with contact Info only."""
    if env_name not in _envs:
        raise ValueError(f"unknown env {env_name!r} (available: {sorted(_envs)})")
    if autoreset_mode not in ("naive", "cached"):
        raise ValueError(
            f"autoreset_mode must be 'naive' or 'cached', got {autoreset_mode!r}")
    if autoreset_mode != "naive" and not (auto_reset and randomized_autoreset):
        raise ValueError(
            "autoreset_mode='cached' requires auto_reset=True and "
            "randomized_autoreset=True — without them the mode is silently "
            "ignored and the run would NOT be in cached mode")
    substeps = kwargs.pop("substeps", None)
    env = _envs[env_name](device=device, **kwargs)
    if substeps is not None:
        env.retune_substeps(substeps)
    if action_repeat is not None:
        env = wrappers.ActionRepeatWrapper(env, action_repeat=action_repeat)
    if episode_length is not None:
        env = wrappers.EpisodeWrapper(env, episode_length, 1)
    if batch_size:
        env = wrappers.VmapWrapper(env, batch_size=batch_size)
    if auto_reset:
        if randomized_autoreset:
            env = wrappers.randomized_autoreset(env, autoreset_mode)
        else:
            env = wrappers.AutoResetWrapper(env)
    if eval_metrics:
        env = wrappers.EvalWrapper(env)
    return env


def create_fn(env_name: str, **kwargs) -> Callable[..., Env]:
    """Returns a function that when called, creates an Env."""
    return functools.partial(create, env_name, **kwargs)


def create_gym_env(
    env_name: str,
    batch_size: Optional[int] = None,
    seed: int = 0,
    device=None,
    **kwargs,
):
    """Create a gymnasium Env (batch_size None: one env, run as a batch of
    one) or VectorEnv with host-side autoreset; `eval_metrics=True` wraps it
    in the EvalGymWrapper (with `discount`). `device` resolves as `create`'s
    does: "cuda" unless given, raising where no GPU is present."""
    from pobrax_tpu_torch.envs.gym_adapter import (AutoresetGymWrapper, AutoresetVmapGymWrapper,
                                                   EvalGymWrapper)

    kwargs["auto_reset"] = False  # the gym side owns autoreset
    eval_metrics = kwargs.pop("eval_metrics", False)
    discount = kwargs.pop("discount", 1.0)
    if batch_size is not None and batch_size <= 0:
        raise ValueError(f"batch_size must be a positive int or None, got {batch_size!r}")
    environment = create(env_name=env_name, batch_size=batch_size, device=device, **kwargs)
    if batch_size is None:
        e = AutoresetGymWrapper(environment, seed=seed)
    else:
        e = AutoresetVmapGymWrapper(environment, batch_size, seed=seed)
    if eval_metrics:
        e = EvalGymWrapper(e, discount=discount)
    return e


__all__ = ["Acrobot", "Ant", "AntGatherEnv", "AntHeavenHellEnv", "AntMazeEnv", "AntTagEnv", "Env",
           "Fast", "Fetch", "Grasp", "HAI_ACTION_REPEAT", "Halfcheetah", "Hopper", "Humanoid",
           "HumanoidStandup", "InvertedDoublePendulum", "InvertedPendulum",
           "MaskedObservationWrapper", "Reacher", "ReacherAngle", "State", "Ur5e", "Walker2d",
           "Wrapper", "create", "create_fn", "create_gym_env", "register", "wrappers"]
