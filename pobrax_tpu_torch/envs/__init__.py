"""Env registry and factory; the port of `pobrax_tpu/envs/__init__.py`.

`create(env_name, ..., device=None)` assembles the wrapper stack in the JAX
factory's order: ActionRepeat -> Episode -> Vmap -> autoreset. The registry
holds `ant_tag` only; the other envs are queued in ROADMAP.md.
"""

from __future__ import annotations

from typing import Optional

from pobrax_tpu_torch.envs import wrappers
from pobrax_tpu_torch.envs.ant_tag import AntTagEnv
from pobrax_tpu_torch.envs.base import Env, State, Wrapper

_envs = {
    "ant_tag": AntTagEnv,
}


def create(
    env_name: str,
    episode_length: Optional[int] = 1000,
    action_repeat: Optional[int] = 1,
    auto_reset: bool = True,
    batch_size: Optional[int] = None,
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
    fresh states refreshed every 200 steps). `substeps=N` retunes the
    integrator (8 and 10 are supported; 10 is the default)."""
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
    return env


__all__ = ["AntTagEnv", "Env", "State", "Wrapper", "create", "wrappers"]
