"""Fetch env: a quadruped dog runs to a target ball; target resampled on
reach. The port of `pobrax_tpu/envs/fetch.py`, natively batched.

Behavioral equivalent of the stock brax fetch the reference registers
(po-brax po_brax/envs/__init__.py:35). Observation (101) matches the
reference's mask tables: POSITION [0,6)+[10,49), TARGET_POS [6,10),
VELOCITY [49,88), CFRC [88,101).
"""

from __future__ import annotations

import math

import torch

from pobrax_tpu_torch import random as jr
from pobrax_tpu_torch.envs.base import Env, State
from pobrax_tpu_torch.envs.common import polar_point, teleport
from pobrax_tpu_torch.ops.vector import norm
from pobrax_tpu_torch.physics import quadruped
from pobrax_tpu_torch.physics.state import Info, QP


class Fetch(Env):
    def __init__(self, target_distance: float = 15.0, device=None, info: str = "full", **kwargs):
        super().__init__(quadruped.fetch_config(), device, info)
        self.target_distance = target_distance
        self.torso = self.sys.body.index["torso"]
        self.target = self.sys.body.index["Target"]
        self._obs_bodies = torch.tensor(
            [self.sys.body.index[n] for n in quadruped.BODY_ORDER], device=self.device)  # 13

    @property
    def observation_size(self) -> int:
        return 101

    def reset(self, rng: torch.Tensor) -> State:
        """(B, 2) keys -> a batch of B fresh episodes."""
        rng, rng1, rng2, rng3 = jr.split(rng, 4).unbind(-2)
        ndof = self.sys.num_joint_dof
        qpos = self.sys.default_angle() + jr.uniform(rng1, (ndof,), -0.05, 0.05)
        qvel = jr.uniform(rng2, (ndof,), -0.05, 0.05)
        qp = self.sys.default_qp(joint_angle=qpos, joint_velocity=qvel)
        qp = teleport(qp, self.target, self._target_pos(rng3))
        info = self.sys.info(qp)
        obs = self._get_obs(qp, info)
        zero = torch.zeros(rng.shape[0], device=rng.device)
        return State(qp, obs, zero, zero.clone(), {"hits": zero.clone()}, {"rng": rng})

    def _target_pos(self, rng: torch.Tensor) -> torch.Tensor:
        r1, r2 = jr.split(rng).unbind(-2)
        theta = jr.uniform(r1, (), 0.0, 2.0 * math.pi)
        radius = jr.uniform(r2, (), 0.5 * self.target_distance, self.target_distance)
        return polar_point(radius, theta, 0.2)

    def _get_obs(self, qp: QP, info: Info) -> torch.Tensor:
        B = qp.pos.shape[0]
        to_target = qp.pos[:, self.target] - qp.pos[:, self.torso]
        dist = norm(to_target[:, :2])
        body_pos = qp.pos[:, self._obs_bodies].reshape(B, -1)  # 39
        body_vel = qp.vel[:, self._obs_bodies].reshape(B, -1)  # 39
        contact_mag = norm(torch.clamp(info.contact.vel, -1, 1))[:, :13]  # 13 dynamic bodies
        return torch.cat([
            qp.pos[:, self.torso, 2:], qp.rot[:, self.torso], dist[:, None],  # [0,6)
            to_target, torch.atan2(to_target[:, 1], to_target[:, 0])[:, None],  # [6,10)
            body_pos,  # [10,49)
            body_vel,  # [49,88)
            contact_mag,  # [88,101)
        ], dim=-1)

    def step(self, state: State, action: torch.Tensor) -> State:
        qp, info = self.sys.step(state.qp, action)
        rng, rng1 = jr.split(state.info["rng"]).unbind(-2)
        d_before = norm((state.qp.pos[:, self.target] - state.qp.pos[:, self.torso])[:, :2])
        d_after = norm((qp.pos[:, self.target] - qp.pos[:, self.torso])[:, :2])
        progress = (d_before - d_after) / self.sys.config.dt
        hit = (d_after < 0.5).to(torch.float32)
        qp = teleport(qp, self.target, self._target_pos(rng1), where=hit > 0)
        obs = self._get_obs(qp, info)
        ctrl = 0.01 * torch.square(torch.clamp(action, -1, 1)).sum(-1)
        reward = progress + 25.0 * hit - ctrl
        z = qp.pos[:, self.torso, 2]
        done = ((z < 0.1) | (z > 1.2)).to(torch.float32)
        metrics = {**state.metrics, "hits": state.metrics["hits"] + hit}
        return state.replace(qp=qp, obs=obs, reward=reward, done=done, metrics=metrics,
                             info={**state.info, "rng": rng})
