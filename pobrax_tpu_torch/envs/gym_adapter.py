"""Gymnasium adapters: batched VectorEnv facade + host-side autoreset + eval
statistics; the port of `pobrax_tpu/envs/gym_adapter.py`.

Step returns gymnasium's 5-tuple (obs, reward, terminated, truncated, info).
The adapter owns the threefry key (`pobrax_tpu_torch.random`), split as the
JAX adapter splits it, so a seed gives the JAX adapter's resets. Observations,
rewards and the terminated / truncated flags come back as torch tensors on
the env's device (the unbatched adapter's flags are Python bools, as in
JAX); actions may be numpy arrays or tensors. The spaces are gymnasium
`Box`es, as in JAX.

The native path (on-device autoreset in `envs/wrappers.py`, the learners)
needs none of this; these adapters exist for host training loops, and read
`done` on the host once per step, as the reference does.
"""

from __future__ import annotations

import gymnasium as gym
import numpy as np
import torch
from gymnasium import spaces
from gymnasium.vector import VectorEnv

from pobrax_tpu_torch import random as jr
from pobrax_tpu_torch.envs.base import Env
from pobrax_tpu_torch.envs.wrappers import where_done
from pobrax_tpu_torch.physics.state import QP


def _boxes(env: Env):
    obs_high = np.inf * np.ones(env.observation_size, dtype="float32")
    action_high = np.ones(env.action_size, dtype="float32")
    return (spaces.Box(-obs_high, obs_high, dtype="float32"),
            spaces.Box(-action_high, action_high, dtype="float32"))


def _terminated_truncated(state):
    """(done and not truncated, truncated) from the EpisodeWrapper's info."""
    truncation = state.info.get("truncation", torch.zeros_like(state.done))
    return (state.done > 0) & (truncation == 0), truncation > 0


class VmapGymWrapper(VectorEnv):
    """Batched Env -> gymnasium VectorEnv (reference wrappers.py:126-172)."""

    metadata = {"render_modes": []}

    def __init__(self, env: Env, batch_size: int, seed: int = 0):
        self._env = env
        self._device = env.device
        self.num_envs = batch_size
        self.seed(seed)
        self._state = None
        self.single_observation_space, self.single_action_space = _boxes(env)
        self.observation_space = gym.vector.utils.batch_space(
            self.single_observation_space, self.num_envs)
        self.action_space = gym.vector.utils.batch_space(self.single_action_space, self.num_envs)

    def seed(self, seed: int = 0):
        self._key = jr.PRNGKey(seed, self._device)

    def _reset(self):
        """A fresh batch from the next key: (state, obs); advances the key."""
        keys = jr.split(self._key, self.num_envs + 1)
        self._key = keys[0]
        state = self._env.reset(keys[1:])
        return state, state.obs

    def reset(self, *, seed=None, options=None):
        if seed is not None:
            self.seed(seed)
        self._state, obs = self._reset()
        return obs, {}

    def step(self, action):
        action = torch.as_tensor(action, dtype=torch.float32, device=self._device)
        self._state = self._env.step(self._state, action)
        terminated, truncated = _terminated_truncated(self._state)
        return (self._state.obs, self._state.reward, terminated, truncated,
                {"metrics": self._state.metrics})


class AutoresetVmapGymWrapper(VmapGymWrapper):
    """Host-side autoreset: on any done, reset all and merge per env with
    where_done, zeroing info['steps'] (reference :240-262). One
    device->host read per step, of the done check (:248)."""

    def step(self, action):
        obs, reward, terminated, truncated, info = super().step(action)
        done = terminated | truncated
        if bool(done.any()):
            new_state, new_obs = self._reset()
            cur = self._state.qp
            qp = QP(*(where_done(done, getattr(new_state.qp, f), getattr(cur, f))
                      for f in ("pos", "rot", "vel", "ang")))
            obs = where_done(done, new_obs, obs)
            state_info = dict(self._state.info)
            if "steps" in state_info:
                state_info["steps"] = torch.where(
                    done, torch.zeros_like(state_info["steps"]), state_info["steps"])
            self._state = self._state.replace(qp=qp, obs=obs, info=state_info)
        return obs, reward, terminated, truncated, info


class AutoresetGymWrapper(gym.Env):
    """Unbatched Env -> gymnasium Env with host-side `if done: reset`
    (reference :232-237). The port's envs are natively batched, so the env
    runs as a batch of one; obs and reward come back without the batch axis."""

    metadata = {"render_modes": []}

    def __init__(self, env: Env, seed: int = 0):
        self._env = env
        self._device = env.device
        self.seed(seed)
        self._state = None
        self.observation_space, self.action_space = _boxes(env)

    def seed(self, seed: int = 0):
        self._key = jr.PRNGKey(seed, self._device)

    def _reset(self):
        self._key, key = jr.split(self._key).unbind(0)
        self._state = self._env.reset(key[None])
        return self._state.obs[0]

    def reset(self, *, seed=None, options=None):
        if seed is not None:
            self.seed(seed)
        return self._reset(), {}

    def step(self, action):
        action = torch.as_tensor(action, dtype=torch.float32, device=self._device)
        self._state = self._env.step(self._state, action[None])
        obs, reward = self._state.obs[0], self._state.reward[0]
        metrics = {k: v[0] for k, v in self._state.metrics.items()}
        terminated, truncated = (bool(x[0]) for x in _terminated_truncated(self._state))
        if terminated or truncated:
            obs = self._reset()
        return obs, reward, terminated, truncated, {"metrics": metrics}


class EvalGymWrapper:
    """Episode statistics with host-side completed-episode queues and
    nan-mean summaries (reference :175-229).

    Duck-typed (not gymnasium.Wrapper): it must wrap both `gym.Env` and
    `gym.vector.VectorEnv`, which share no base class in gymnasium 1.x."""

    def __init__(self, env, discount: float = 1.0, queue_cap: int = 100_000):
        self.env = env
        self._discount = discount
        self.num_envs = getattr(env, "num_envs", 1)
        # completed-episode queues keep only the most recent `queue_cap`
        # entries — the reference's grow without bound (wrappers.py:209-219),
        # which leaks in long evaluations
        self._queue_cap = queue_cap

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        return getattr(self.env, name)

    def reset(self, **kwargs):
        obs, info = self.env.reset(**kwargs)
        like = torch.atleast_1d(obs[..., -1])
        self.episode_returns = torch.zeros_like(like)
        self.discounted_episode_returns = torch.zeros_like(like)
        self.episode_lengths = torch.zeros_like(like, dtype=torch.int64)
        self.current_discount = torch.ones_like(like)
        self.r_q, self.dr_q, self.l_q = [np.nan], [np.nan], [np.nan]
        return obs, info

    def step(self, action):
        obs, r, terminated, truncated, info = self.env.step(action)
        dev = self.episode_returns.device
        d = torch.atleast_1d(torch.as_tensor(terminated, device=dev)
                             | torch.as_tensor(truncated, device=dev))
        r = torch.atleast_1d(r)
        self.episode_returns = self.episode_returns + r
        self.episode_lengths = self.episode_lengths + 1
        self.discounted_episode_returns = (
            self.discounted_episode_returns + r * self.current_discount)
        self.current_discount = self.current_discount * self._discount
        if bool(d.any()):
            d_idx = d.nonzero().reshape(-1)
            self.r_q.extend(self.episode_returns[d_idx].cpu().numpy())
            self.dr_q.extend(self.discounted_episode_returns[d_idx].cpu().numpy())
            self.l_q.extend(self.episode_lengths[d_idx].cpu().numpy())
            self.episode_returns[d_idx] = 0
            self.discounted_episode_returns[d_idx] = 0
            self.episode_lengths[d_idx] = 0
            self.current_discount[d_idx] = 1
            if len(self.r_q) > self._queue_cap:
                self.r_q = self.r_q[-self._queue_cap:]
                self.dr_q = self.dr_q[-self._queue_cap:]
                self.l_q = self.l_q[-self._queue_cap:]
        return obs, r, terminated, truncated, info

    def get_stats(self):
        return {
            "charts/mean_episodic_return": float(np.nanmean(np.asarray(self.r_q, np.float64))),
            "charts/mean_discounted_episodic_return": float(
                np.nanmean(np.asarray(self.dr_q, np.float64))),
            "charts/mean_episodic_length": float(np.nanmean(np.asarray(self.l_q, np.float64))),
        }
