"""Planar locomotion envs: halfcheetah, hopper, walker2d; the port of
`pobrax_tpu/envs/planar.py`, natively batched.

Behavioral equivalents of the stock brax envs the reference registers
(po-brax po_brax/envs/__init__.py:37,38,46). Observation layouts match the
reference's mask tables (standard_observability_masks.py):
  halfcheetah: POSITION [0,11) = z + quat + 6 angles, VELOCITY [11,23)
  hopper:      POSITION [0,8)  = z + quat + 3 angles, VELOCITY [8,14)
  walker2d:    POSITION [0,11) = z + quat + 6 angles, VELOCITY [11,20)
"""

from __future__ import annotations

import torch

from pobrax_tpu_torch import random as jr
from pobrax_tpu_torch.envs.base import Env, State
from pobrax_tpu_torch.physics import planar
from pobrax_tpu_torch.physics.state import QP


class _PlanarEnv(Env):
    """Shared reset/obs/reward machinery for the planar family: reward =
    forward velocity - `_ctrl_weight` * ctrl cost + `_survive`. `_healthy` is
    ((z_min, z_max), |pitch| max) where a fall ends the episode; None means
    only the step budget ends it."""

    _noise = 0.005
    _ctrl_weight = 1e-3
    _survive = 1.0
    _healthy = None
    _torso_vel_size = 3  # vx, vz, wy

    def __init__(self, cfg, device=None, info: str = "full"):
        super().__init__(cfg, device, info)
        self.torso = self.sys.body.index["torso"]

    @property
    def observation_size(self) -> int:
        return 1 + 4 + 2 * self.sys.num_joint_dof + self._torso_vel_size

    def reset(self, rng: torch.Tensor) -> State:
        """(B, 2) keys -> a batch of B fresh episodes."""
        rng, rng1, rng2 = jr.split(rng, 3).unbind(-2)
        ndof = self.sys.num_joint_dof
        qpos = self.sys.default_angle() + jr.uniform(rng1, (ndof,), -self._noise, self._noise)
        qvel = jr.uniform(rng2, (ndof,), -self._noise, self._noise)
        qp = self.sys.default_qp(joint_angle=qpos, joint_velocity=qvel)
        obs = self._get_obs(qp)
        zero = torch.zeros(rng.shape[0], device=rng.device)
        metrics = {"reward_forward": zero, "reward_ctrl_cost": zero.clone(),
                   "reward_survive": zero.clone()}
        return State(qp, obs, zero.clone(), zero.clone(), metrics, {"rng": rng})

    def _get_obs(self, qp: QP) -> torch.Tensor:
        angles, vels = [], []
        for g in self.sys.joints:
            a, v = g.angle_vel(qp)
            angles += list(a)
            vels += list(v)
        return self._obs_from_parts(qp, torch.cat(angles, -1), torch.cat(vels, -1))

    def _obs_from_parts(self, qp: QP, joint_angle, joint_vel) -> torch.Tensor:
        """z(1) + quat(4) + angles, then vx, vz, wy + joint velocities."""
        t = self.torso
        return torch.cat([
            qp.pos[:, t, 2:], qp.rot[:, t], joint_angle,
            qp.vel[:, t, 0:1], qp.vel[:, t, 2:3], qp.ang[:, t, 1:2], joint_vel,
        ], dim=-1)

    def step(self, state: State, action: torch.Tensor) -> State:
        qp, _ = self.sys.step(state.qp, action)
        obs = self._get_obs(qp)
        t = self.torso
        forward = (qp.pos[:, t, 0] - state.qp.pos[:, t, 0]) / self.sys.config.dt
        ctrl = self._ctrl_weight * torch.square(torch.clamp(action, -1, 1)).sum(-1)
        survive = torch.full_like(forward, self._survive)
        reward = forward - ctrl + survive
        if self._healthy is None:
            done = torch.zeros_like(reward)
        else:
            (z_min, z_max), pitch_max = self._healthy
            z = qp.pos[:, t, 2]
            pitch = 2.0 * torch.atan2(qp.rot[:, t, 2], qp.rot[:, t, 0])
            done = ((z < z_min) | (z > z_max) | (torch.abs(pitch) > pitch_max)).to(torch.float32)
        metrics = {**state.metrics, "reward_forward": forward,
                   "reward_ctrl_cost": ctrl, "reward_survive": survive}
        return state.replace(qp=qp, obs=obs, reward=reward, done=done, metrics=metrics)


class Halfcheetah(_PlanarEnv):
    """Run forward; reward = forward velocity - 0.1 * ctrl cost; no
    termination besides the step budget (stock halfcheetah semantics)."""

    _ctrl_weight = 0.1
    _survive = 0.0
    _torso_vel_size = 6  # vel(3) + ang(3)

    def __init__(self, device=None, info: str = "full", **kwargs):
        super().__init__(planar.halfcheetah_config(), device, info)

    def _obs_from_parts(self, qp: QP, joint_angle, joint_vel) -> torch.Tensor:
        # pos [0,11): z(1) + quat(4) + angles(6); vel [11,23): vel(3)+ang(3)+vels(6)
        t = self.torso
        return torch.cat([
            qp.pos[:, t, 2:], qp.rot[:, t], joint_angle,
            qp.vel[:, t], qp.ang[:, t], joint_vel,
        ], dim=-1)


class Hopper(_PlanarEnv):
    """Hop forward; healthy while z in (0.7, 2.0) and |pitch| < 0.3 rad.
    pos [0,8): z(1) + quat(4) + angles(3); vel [8,14): vx,vz,wy + vels(3)."""

    _healthy = ((0.7, 2.0), 0.3)

    def __init__(self, device=None, info: str = "full", **kwargs):
        super().__init__(planar.hopper_config(), device, info)


class Walker2d(_PlanarEnv):
    """Walk forward; healthy while z in (0.8, 2.0) and |pitch| < 1.0 rad.
    pos [0,11): z(1) + quat(4) + angles(6); vel [11,20): vx,vz,wy + vels(6)."""

    _healthy = ((0.8, 2.0), 1.0)

    def __init__(self, device=None, info: str = "full", **kwargs):
        super().__init__(planar.walker2d_config(), device, info)
