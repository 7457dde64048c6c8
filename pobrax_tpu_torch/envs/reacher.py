"""Reacher envs: torque-driven `reacher` and servo-driven `reacherangle`;
the port of `pobrax_tpu/envs/reacher.py`, natively batched.

Behavioral equivalents of the stock brax envs the reference registers
(po-brax po_brax/envs/__init__.py:43-44). Observation layout matches the
reference's mask tables (standard_observability_masks.py): 11 dims =
arm cos(2)+sin(2) [0,4), target xy [4,6) (the table's POSITION segment),
joint vels [6,8), fingertip-minus-target [8,11) (TARGET_POS covers
[0,4)+[8,11)).
"""

from __future__ import annotations

import math

import torch

from pobrax_tpu_torch import random as jr
from pobrax_tpu_torch.envs.base import Env, State
from pobrax_tpu_torch.envs.common import polar_point, teleport
from pobrax_tpu_torch.ops import quaternion as quat
from pobrax_tpu_torch.ops.vector import norm
from pobrax_tpu_torch.physics import reacher as reacher_model
from pobrax_tpu_torch.physics.state import QP


class Reacher(Env):
    _actuator_kind = "torque"

    def __init__(self, device=None, info: str = "full", **kwargs):
        super().__init__(reacher_model.reacher_config(self._actuator_kind), device, info)
        self.body1 = self.sys.body.index["body1"]
        self.target = self.sys.body.index["target"]
        self._tip = torch.tensor([0.06, 0.0, 0.0], device=self.device)

    @property
    def observation_size(self) -> int:
        return 11

    def reset(self, rng: torch.Tensor) -> State:
        """(B, 2) keys -> a batch of B fresh episodes."""
        rng, rng1, rng2, rng3, rng4 = jr.split(rng, 5).unbind(-2)
        ndof = self.sys.num_joint_dof
        qpos = self.sys.default_angle() + jr.uniform(rng1, (ndof,), -0.1, 0.1)
        qvel = jr.uniform(rng2, (ndof,), -0.005, 0.005)
        qp = self.sys.default_qp(joint_angle=qpos, joint_velocity=qvel)
        # target uniform in the reachable disk (radius <= 0.2), rejection-free:
        # sample angle + sqrt-radius
        theta = jr.uniform(rng3, (), 0.0, 2.0 * math.pi)
        radius = 0.2 * torch.sqrt(jr.uniform(rng4, (), 0.04, 1.0))
        qp = teleport(qp, self.target, polar_point(radius, theta, 0.01))
        obs = self._get_obs(qp)
        zero = torch.zeros(rng.shape[0], device=rng.device)
        metrics = {"reward_dist": zero, "reward_ctrl": zero}
        return State(qp, obs, zero, zero.clone(), metrics, {"rng": rng})

    def _fingertip(self, qp: QP) -> torch.Tensor:
        rot = qp.rot[:, self.body1]
        return qp.pos[:, self.body1] + quat.rotate(self._tip.expand(rot.shape[0], 3), rot)

    def _get_obs(self, qp: QP) -> torch.Tensor:
        (a,), (v,) = self.sys.joints[0].angle_vel(qp)
        to_target = self._fingertip(qp) - qp.pos[:, self.target]
        return torch.cat([torch.cos(a), torch.sin(a), qp.pos[:, self.target, :2], v, to_target],
                         dim=-1)

    def step(self, state: State, action: torch.Tensor) -> State:
        qp, _ = self.sys.step(state.qp, action)
        obs = self._get_obs(qp)
        dist = norm(self._fingertip(qp) - qp.pos[:, self.target])
        reward_dist = -dist
        reward_ctrl = -torch.square(torch.clamp(action, -1, 1)).sum(-1)
        reward = reward_dist + 0.1 * reward_ctrl
        metrics = {**state.metrics, "reward_dist": reward_dist, "reward_ctrl": reward_ctrl}
        return state.replace(qp=qp, obs=obs, reward=reward, done=torch.zeros_like(reward),
                             metrics=metrics)


class ReacherAngle(Reacher):
    """Same arm; actions command target joint angles through position servos
    (the brax ReacherAngle variant). Actions in [-1,1] map to the joint's
    angle-limit range."""

    _actuator_kind = "angle"

    def __init__(self, device=None, info: str = "full", **kwargs):
        super().__init__(device, info, **kwargs)
        limits = torch.as_tensor(self.sys.joints[0].limit, device=self.device)  # (J, 1, 2)
        self._servo_lo = torch.clamp(limits[:, 0, 0], min=-math.pi)
        self._servo_hi = torch.clamp(limits[:, 0, 1], max=math.pi)

    def step(self, state: State, action: torch.Tensor) -> State:
        lo, hi = self._servo_lo, self._servo_hi
        target = lo + (torch.clamp(action, -1.0, 1.0) * 0.5 + 0.5) * (hi - lo)
        return super().step(state, target)
