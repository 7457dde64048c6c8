"""Cart-pole envs: inverted_pendulum, inverted_double_pendulum; the port of
`pobrax_tpu/envs/pendulum.py`, natively batched.

Behavioral equivalents of the stock brax envs the reference registers
(po-brax po_brax/envs/__init__.py:41-42). Observation layouts match the
reference's mask tables (standard_observability_masks.py):
  inverted_pendulum:        POSITION [0,6), VELOCITY [6,10)
  inverted_double_pendulum: POSITION [0,5), VELOCITY [5,25)
"""

from __future__ import annotations

import torch

from pobrax_tpu_torch import random as jr
from pobrax_tpu_torch.envs.base import Env, State
from pobrax_tpu_torch.ops import quaternion as quat
from pobrax_tpu_torch.physics import pendulum
from pobrax_tpu_torch.physics.state import QP


class _CartPole(Env):
    """Reset shared by both: joint angles and velocities jittered by 0.01."""

    _metric = ""

    def reset(self, rng: torch.Tensor) -> State:
        """(B, 2) keys -> a batch of B fresh episodes."""
        rng, rng1, rng2 = jr.split(rng, 3).unbind(-2)
        ndof = self.sys.num_joint_dof
        qpos = self.sys.default_angle() + jr.uniform(rng1, (ndof,), -0.01, 0.01)
        qvel = jr.uniform(rng2, (ndof,), -0.01, 0.01)
        qp = self.sys.default_qp(joint_angle=qpos, joint_velocity=qvel)
        obs = self._get_obs(qp)
        zero = torch.zeros(rng.shape[0], device=rng.device)
        return State(qp, obs, zero, zero.clone(), {self._metric: zero.clone()}, {"rng": rng})


class InvertedPendulum(_CartPole):
    """Balance a pole on a sliding cart; +1 per step, done when it tips."""

    _metric = "survive"

    def __init__(self, device=None, info: str = "full", **kwargs):
        super().__init__(pendulum.inverted_pendulum_config(), device, info)
        self.cart = self.sys.body.index["cart"]
        self.pole = self.sys.body.index["pole"]

    @property
    def observation_size(self) -> int:
        return 10

    def _get_obs(self, qp: QP) -> torch.Tensor:
        (a,), (v,) = self.sys.joints[0].angle_vel(qp)
        # pos [0,6): cart_x + pole quat(4) + hinge angle
        # vel [6,10): cart_vx + pole w_y + hinge vel + pole vx
        return torch.cat([
            qp.pos[:, self.cart, 0:1], qp.rot[:, self.pole], a[:, 0:1],
            qp.vel[:, self.cart, 0:1], qp.ang[:, self.pole, 1:2], v[:, 0:1],
            qp.vel[:, self.pole, 0:1],
        ], dim=-1)

    def step(self, state: State, action: torch.Tensor) -> State:
        qp, _ = self.sys.step(state.qp, action)
        obs = self._get_obs(qp)
        (a,), _ = self.sys.joints[0].angle_vel(qp)
        reward = torch.ones_like(a[:, 0])
        done = (torch.abs(a[:, 0]) > 0.2).to(torch.float32)
        return state.replace(qp=qp, obs=obs, reward=reward, done=done,
                             metrics={**state.metrics, "survive": reward})


class InvertedDoublePendulum(_CartPole):
    """Balance a 2-link pole; mujoco-style alive bonus minus tip-distance and
    velocity penalties; done when the tip drops below 1 m above the cart."""

    _metric = "distance"

    def __init__(self, device=None, info: str = "full", **kwargs):
        super().__init__(pendulum.inverted_double_pendulum_config(), device, info)
        self.cart = self.sys.body.index["cart"]
        self.pole = self.sys.body.index["pole"]
        self.pole2 = self.sys.body.index["pole2"]
        self._tip_offset = torch.tensor([0.0, 0.0, 0.3], device=self.device)

    @property
    def observation_size(self) -> int:
        return 25

    def _tip(self, qp: QP) -> torch.Tensor:
        rot = qp.rot[:, self.pole2]
        return qp.pos[:, self.pole2] + quat.rotate(self._tip_offset.expand(rot.shape[0], 3), rot)

    def _get_obs(self, qp: QP) -> torch.Tensor:
        (a,), (v,) = self.sys.joints[0].angle_vel(qp)
        a1, a2 = a[:, 0], a[:, 1]
        # pos [0,5): cart_x, sin(a1), sin(a2), cos(a1), cos(a2)
        pos = torch.stack([qp.pos[:, self.cart, 0], torch.sin(a1), torch.sin(a2),
                           torch.cos(a1), torch.cos(a2)], dim=-1)
        # vel [5,25): (vel,ang) of cart/pole/pole2 (18) + 2 hinge vels
        vel = torch.cat([
            qp.vel[:, self.cart], qp.ang[:, self.cart],
            qp.vel[:, self.pole], qp.ang[:, self.pole],
            qp.vel[:, self.pole2], qp.ang[:, self.pole2],
            v[:, 0:2],
        ], dim=-1)
        return torch.cat([pos, vel], dim=-1)

    def step(self, state: State, action: torch.Tensor) -> State:
        qp, _ = self.sys.step(state.qp, action)
        obs = self._get_obs(qp)
        tip = self._tip(qp)
        x_rel = tip[:, 0] - qp.pos[:, self.cart, 0]
        height = tip[:, 2] - qp.pos[:, self.cart, 2]
        # mujoco IDP semantics (same 0.6+0.6 geometry): penalty target 2.0 is
        # ABOVE the 1.2 reachable tip height, so the penalty is monotone in
        # height and uniquely minimized at upright; done when the tip drops
        # below 1 m above the cart
        dist_penalty = 0.01 * torch.square(x_rel) + torch.square(height - 2.0)
        _, (v,) = self.sys.joints[0].angle_vel(qp)
        vel_penalty = 1e-3 * torch.square(v[:, 0]) + 5e-3 * torch.square(v[:, 1])
        reward = 10.0 - dist_penalty - vel_penalty
        done = (height < 1.0).to(torch.float32)
        return state.replace(qp=qp, obs=obs, reward=reward, done=done,
                             metrics={**state.metrics, "distance": torch.abs(x_rel)})
