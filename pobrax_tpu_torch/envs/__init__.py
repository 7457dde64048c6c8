"""Env registry and factory; the port of `pobrax_tpu/envs/__init__.py`.

`create(env_name, ..., device=None)` assembles the wrapper stack in the JAX
factory's order: ActionRepeat -> Episode -> Vmap -> autoreset -> Eval.
`MaskedObservationWrapper(env, env_name=..., hidden=...)` on top makes the
PO variant of a stock env, as `bench.py`'s `masked_<name>` does. Ported:
the PO ant tasks (`ant_tag`, `ant_heavenhell`, `ant_gather`, `ant_maze`), the
stock envs below (`ant` among them) and the debug env `fast`; the planar envs
(`halfcheetah`, `hopper`, `walker2d`) and `acrobot` are queued in ROADMAP.md.
"""

from __future__ import annotations

from typing import Optional

from pobrax_tpu_torch.envs import wrappers
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
from pobrax_tpu_torch.envs.reacher import Reacher, ReacherAngle
from pobrax_tpu_torch.envs.ur5e import Ur5e

_envs = {
    "ant": Ant,
    "ant_tag": AntTagEnv,
    "ant_heavenhell": AntHeavenHellEnv,
    "ant_gather": AntGatherEnv,
    "ant_maze": AntMazeEnv,
    "fast": Fast,
    "fetch": Fetch,
    "grasp": Grasp,
    "humanoid": Humanoid,
    "humanoidstandup": HumanoidStandup,
    "inverted_pendulum": InvertedPendulum,
    "inverted_double_pendulum": InvertedDoublePendulum,
    "reacher": Reacher,
    "reacherangle": ReacherAngle,
    "ur5e": Ur5e,
}


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
        raise ValueError(
            f"env {env_name!r} is not ported to pobrax_tpu_torch yet (available: "
            f"{sorted(_envs)}); ROADMAP.md lists the envs still to port")
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


__all__ = ["Ant", "AntGatherEnv", "AntHeavenHellEnv", "AntMazeEnv", "AntTagEnv", "Env", "Fast", "Fetch",
           "Grasp", "Humanoid", "HumanoidStandup",
           "InvertedDoublePendulum", "InvertedPendulum", "MaskedObservationWrapper",
           "Reacher", "ReacherAngle", "State", "Ur5e", "Wrapper", "create", "wrappers"]
