"""Env / State base API; the port of `pobrax_tpu/envs/base.py`.

`State(qp, obs, reward, done, metrics, info)` and `Env` with
`reset(keys) -> State`, `step(state, action) -> State`, `observation_size`,
`action_size` and `sys`. Port envs are natively batched: `reset` takes a
(B, 2) batch of threefry keys (`pobrax_tpu_torch.random`) and every State
leaf carries the batch axis first.
"""

from __future__ import annotations

import abc
import dataclasses
from dataclasses import dataclass
from typing import Any, Dict

import torch

from pobrax_tpu_torch import device as _device
from pobrax_tpu_torch.physics import config as pcfg
from pobrax_tpu_torch.physics.state import QP
from pobrax_tpu_torch.physics.system import System


@dataclass
class State:
    qp: QP
    obs: torch.Tensor       # (B, observation_size)
    reward: torch.Tensor    # (B,)
    done: torch.Tensor      # (B,) float 0/1
    metrics: Dict[str, torch.Tensor]
    info: Dict[str, Any]

    def replace(self, **changes) -> "State":
        return dataclasses.replace(self, **changes)


class Env(abc.ABC):
    """A physics-backed environment; subclasses build a Config in __init__.
    `info="contact"` builds the System with contact Info only (see
    `physics/system.py`); every env's observation reads contact Info alone."""

    def __init__(self, cfg: pcfg.Config, device=None, info: str = "full"):
        self._cfg = cfg
        self.device = _device.resolve(device)
        self.sys = System(cfg, self.device, info)

    @abc.abstractmethod
    def reset(self, rng: torch.Tensor) -> State:
        ...

    @abc.abstractmethod
    def step(self, state: State, action: torch.Tensor) -> State:
        ...

    def rescale_time(self, action_repeat: int) -> None:
        """dt *= k, substeps *= k (ActionRepeatWrapper semantics). Rebuilds
        the System since configs are immutable."""
        self._cfg = self._cfg.scale_time(action_repeat)
        self.sys = System(self._cfg, self.device, self.sys.info_mode)

    def retune_substeps(self, substeps: int) -> None:
        """Opt-in integrator retune: same dt, fewer substeps (larger h_sub).
        The default stays 10 (the fixtures pin it); 8 is the measured
        stability edge. Call on the core env before wrapping."""
        if substeps < 1:
            raise ValueError(f"substeps must be >= 1, got {substeps}")
        if self.unwrapped is not self:
            raise TypeError(
                "retune_substeps must be called on the core env before "
                "wrapping (use env.unwrapped.retune_substeps(...) or "
                "create(..., substeps=N))")
        self._cfg = dataclasses.replace(self._cfg, substeps=substeps)
        self.sys = System(self._cfg, self.device, self.sys.info_mode)

    @property
    @abc.abstractmethod
    def observation_size(self) -> int:
        ...

    @property
    def action_size(self) -> int:
        return self.sys.action_size

    @property
    def unwrapped(self) -> "Env":
        return self


class Wrapper(Env):
    """Wraps an Env to delegate everything not overridden."""

    def __init__(self, env: Env):
        self.env = env

    def reset(self, rng: torch.Tensor) -> State:
        return self.env.reset(rng)

    def step(self, state: State, action: torch.Tensor) -> State:
        return self.env.step(state, action)

    @property
    def observation_size(self) -> int:
        return self.env.observation_size

    @property
    def action_size(self) -> int:
        return self.env.action_size

    @property
    def sys(self) -> System:
        return self.env.sys

    @property
    def device(self) -> torch.device:
        return self.env.device

    @property
    def unwrapped(self) -> Env:
        return self.env.unwrapped

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        return getattr(self.env, name)
