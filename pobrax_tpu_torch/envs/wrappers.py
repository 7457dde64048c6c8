"""Episode control, batching and autoreset wrappers; the port of
`pobrax_tpu/envs/wrappers.py` for the AntTag main path.

Port envs are natively batched, so `VmapWrapper` only splits one key into a
batch of keys. Autoreset semantics match the JAX wrappers:
  * AutoResetWrapper — restores the episode-initial qp/obs on done.
  * RandomizedAutoResetWrapperNaive — resamples a fresh initial state every
    step and selects it per env where done.
  * RandomizedAutoResetWrapperCachedOnDevice — selects from cached fresh
    states, re-randomised every `refresh_every` steps.
Every autoreset wrapper records `info["final_obs"]`, the pre-reset
observation of the step (equal to `obs` where the episode did not end), so
off-policy learners can bootstrap from the true final state (PARITY.md).

Not ported yet: the on-terminal and host-counter cached variants and
EvalWrapper (ROADMAP).
"""

from __future__ import annotations

from typing import Optional

import torch

from pobrax_tpu_torch import random as jr
from pobrax_tpu_torch.envs.base import Env, State, Wrapper
from pobrax_tpu_torch.physics.state import QP


def randomized_autoreset(env: Env, mode: str) -> Wrapper:
    """'naive' (per-step resample, reference parity) or 'cached' (cached
    fresh states refreshed every 200 steps); anything else raises."""
    if mode == "cached":
        return RandomizedAutoResetWrapperCachedOnDevice(env)
    if mode == "naive":
        return RandomizedAutoResetWrapperNaive(env)
    raise ValueError(f"autoreset_mode must be 'naive' or 'cached', got {mode!r}")


def where_done(done: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-env select: x where done else y; `done` is (B,)."""
    mask = (done != 0).reshape((x.shape[0],) + (1,) * (x.dim() - 1))
    return torch.where(mask, x, y)


class ActionRepeatWrapper(Wrapper):
    """Scales the integrator: dt *= k, substeps *= k."""

    def __init__(self, env: Env, action_repeat: int):
        super().__init__(env)
        if action_repeat != 1 and hasattr(self.unwrapped, "rescale_time"):
            self.unwrapped.rescale_time(action_repeat)
        self.action_repeat = action_repeat


class EpisodeWrapper(Wrapper):
    """Step-budget termination; tracks info['steps'] / info['truncation']."""

    def __init__(self, env: Env, episode_length: int, action_repeat: int = 1):
        super().__init__(env)
        self.episode_length = episode_length
        self.action_repeat = action_repeat

    def reset(self, rng: torch.Tensor) -> State:
        state = self.env.reset(rng)
        info = {**state.info,
                "steps": torch.zeros_like(state.reward),
                "truncation": torch.zeros_like(state.reward)}
        return state.replace(info=info)

    def step(self, state: State, action: torch.Tensor) -> State:
        rewards = []
        for _ in range(self.action_repeat):
            state = self.env.step(state, action)
            rewards.append(state.reward)
        state = state.replace(reward=torch.stack(rewards).sum(0))
        steps = state.info["steps"] + self.action_repeat
        episode_done = steps >= self.episode_length
        done = torch.where(episode_done, torch.ones_like(state.done), state.done)
        truncation = torch.where(episode_done, 1 - state.done, torch.zeros_like(state.done))
        info = {**state.info, "steps": steps, "truncation": truncation}
        return state.replace(done=done, info=info)


class VmapWrapper(Wrapper):
    """Batch entry point: `reset` accepts one key and splits it into
    `batch_size` keys (as `jax.random.split(key, batch_size)`), so each env
    owns an independent RNG stream in state.info['rng']. The env below is
    already batched, so `step` passes through."""

    def __init__(self, env: Env, batch_size: Optional[int] = None):
        super().__init__(env)
        self.batch_size = batch_size

    def reset(self, rng: torch.Tensor) -> State:
        if rng.dim() == 1:
            if self.batch_size is None:
                raise ValueError("VmapWrapper.reset needs batched keys or a batch_size")
            rng = jr.split(rng, self.batch_size)
        return self.env.reset(rng)


class AutoResetWrapper(Wrapper):
    """Cached autoreset: restore the episode-initial qp/obs on done."""

    def reset(self, rng: torch.Tensor) -> State:
        state = self.env.reset(rng)
        info = {**state.info, "first_qp": state.qp, "first_obs": state.obs,
                "final_obs": state.obs}
        return state.replace(info=info)

    def step(self, state: State, action: torch.Tensor) -> State:
        state = _zero_steps_where_done(state)
        state = state.replace(done=torch.zeros_like(state.done))
        state = self.env.step(state, action)
        return _select_reset(state, state.info["first_qp"], state.info["first_obs"])


def _zero_steps_where_done(state: State) -> State:
    if "steps" in state.info:
        steps = where_done(state.done, torch.zeros_like(state.info["steps"]), state.info["steps"])
        return state.replace(info={**state.info, "steps": steps})
    return state


def _select_reset(state: State, reset_qp, reset_obs) -> State:
    """Swap in the reset qp/obs where done; keep the pre-reset obs."""
    cur = state.qp
    qp = QP(pos=where_done(state.done, reset_qp.pos, cur.pos),
            rot=where_done(state.done, reset_qp.rot, cur.rot),
            vel=where_done(state.done, reset_qp.vel, cur.vel),
            ang=where_done(state.done, reset_qp.ang, cur.ang))
    obs = where_done(state.done, reset_obs, state.obs)
    return state.replace(qp=qp, obs=obs, info={**state.info, "final_obs": state.obs})


def _split_info_rng(state: State):
    """Split each env's info['rng'] into (carried key, consumable key). The
    reference reuses info['rng'] verbatim for every autoreset; splitting
    gives each reset fresh randomness for every env (JAX wrappers.py:149)."""
    keep, use = jr.split(state.info["rng"], 2).unbind(-2)
    return state.replace(info={**state.info, "rng": keep}), use


class RandomizedAutoResetWrapperNaive(Wrapper):
    """Resample a fresh initial state every step; one extra reset per step."""

    def reset(self, rng: torch.Tensor) -> State:
        state = self.env.reset(rng)
        return state.replace(info={**state.info, "final_obs": state.obs})

    def step(self, state: State, action: torch.Tensor) -> State:
        state = _zero_steps_where_done(state)
        state = state.replace(done=torch.zeros_like(state.done))
        state = self.env.step(state, action)
        state, reset_rng = _split_info_rng(state)
        maybe_reset = self.env.reset(reset_rng)
        return _select_reset(state, maybe_reset.qp, maybe_reset.obs)


class RandomizedAutoResetWrapperCachedOnDevice(Wrapper):
    """Randomised autoreset at near-zero cost: cached fresh states, refreshed
    every `refresh_every` steps.

    Each env restarts from its cached freshly-sampled state; the whole cache
    re-randomises when the batch clock reaches a multiple of `refresh_every`
    (the JAX wrapper decides this on device with `lax.cond`).
    `info["cache_age"]` keeps that clock on the device, per env, for parity
    with the JAX state. The refresh DECISION reads a host-side mirror of the
    same clock instead, so no step waits on a device-to-host read: `reset`
    sets the mirror to 0 and every `step` advances it. The mirror follows one
    batch — the one this wrapper last reset. To step a state from elsewhere
    (a restored or converted one), call `sync_clock(state)` first; a wrapper
    that has never reset syncs itself once on its first step."""

    def __init__(self, env: Env, refresh_every: int = 200):
        super().__init__(env)
        self.refresh_every = refresh_every
        self._clock: Optional[int] = None

    def sync_clock(self, state: State) -> None:
        """Set the host mirror from `state.info['cache_age']` (one read)."""
        self._clock = int(state.info["cache_age"].reshape(-1)[0])

    def reset(self, rng: torch.Tensor) -> State:
        state = self.env.reset(rng)
        self._clock = 0
        info = {**state.info, "first_qp": state.qp, "first_obs": state.obs,
                "final_obs": state.obs,
                "cache_age": torch.zeros(state.reward.shape, dtype=torch.int32,
                                         device=state.reward.device)}
        return state.replace(info=info)

    def step(self, state: State, action: torch.Tensor) -> State:
        if self._clock is None:
            self.sync_clock(state)
        self._clock += 1
        if self._clock % self.refresh_every == 0:
            state, rng_use = _split_info_rng(state)
            fresh = self.env.reset(rng_use)
            state = state.replace(info={**state.info, "first_qp": fresh.qp,
                                        "first_obs": fresh.obs})
        state = state.replace(info={**state.info, "cache_age": state.info["cache_age"] + 1})
        state = _zero_steps_where_done(state)
        state = state.replace(done=torch.zeros_like(state.done))
        state = self.env.step(state, action)
        return _select_reset(state, state.info["first_qp"], state.info["first_obs"])
