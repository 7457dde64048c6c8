"""ur5e env: 6-dof position-servo arm reaching a floating target; the port
of `pobrax_tpu/envs/ur5e.py`, natively batched.

Behavioral equivalent of the stock brax ur5e the reference registers
(po-brax po_brax/envs/__init__.py:45). Observation (66) matches the
reference's mask tables: POSITION [0,6)+[10,34), TARGET_POS [6,10),
VELOCITY [34,58), CFRC [58,66).
"""

from __future__ import annotations

import math

import torch

from pobrax_tpu_torch import random as jr
from pobrax_tpu_torch.envs.base import Env, State
from pobrax_tpu_torch.envs.common import polar_point, teleport
from pobrax_tpu_torch.ops.vector import norm
from pobrax_tpu_torch.physics import manipulation
from pobrax_tpu_torch.physics.state import Info, QP


class Ur5e(Env):
    def __init__(self, device=None, info: str = "full", **kwargs):
        super().__init__(manipulation.ur5e_config(), device, info)
        self.target = self.sys.body.index["Target"]
        self.wrist = self.sys.body.index["wrist_3"]
        # the 8 bodies whose positions/velocities enter the obs
        self._obs_bodies = torch.tensor(
            [self.sys.body.index[n] for n in
             ("pedestal",) + manipulation.UR5E_LINKS + ("Target",)], device=self.device)

    @property
    def observation_size(self) -> int:
        return 66

    def reset(self, rng: torch.Tensor) -> State:
        """(B, 2) keys -> a batch of B fresh episodes."""
        rng, rng1, rng2, rng3 = jr.split(rng, 4).unbind(-2)
        ndof = self.sys.num_joint_dof
        qpos = self.sys.default_angle() + jr.uniform(rng1, (ndof,), -0.1, 0.1)
        qvel = jr.uniform(rng2, (ndof,), -0.005, 0.005)
        qp = self.sys.default_qp(joint_angle=qpos, joint_velocity=qvel)
        qp = teleport(qp, self.target, self._target_pos(rng3))
        info = self.sys.info(qp)
        obs = self._get_obs(qp, info)
        zero = torch.zeros(rng.shape[0], device=rng.device)
        return State(qp, obs, zero, zero.clone(), {"hits": zero.clone()}, {"rng": rng})

    def _target_pos(self, rng: torch.Tensor) -> torch.Tensor:
        r1, r2, r3 = jr.split(rng, 3).unbind(-2)
        theta = jr.uniform(r1, (), 0.0, 2.0 * math.pi)
        radius = jr.uniform(r2, (), 0.3, 0.7)
        return polar_point(radius, theta, jr.uniform(r3, (), 0.3, 0.9))

    def _get_obs(self, qp: QP, info: Info) -> torch.Tensor:
        B = qp.pos.shape[0]
        (a,), (v,) = self.sys.joints[0].angle_vel(qp)
        to_target = qp.pos[:, self.target] - qp.pos[:, self.wrist]
        dist = norm(to_target)
        body_pos = qp.pos[:, self._obs_bodies].reshape(B, -1)  # 24
        body_vel = qp.vel[:, self._obs_bodies[1:7]].reshape(B, -1)  # 18
        contact_mag = norm(torch.clamp(info.contact.vel, -1, 1))  # (B, nbody) = 8
        return torch.cat([
            a,  # [0,6) joint angles
            to_target, dist[:, None],  # [6,10) target block
            body_pos,  # [10,34)
            v, body_vel,  # [34,58)
            contact_mag,  # [58,66)
        ], dim=-1)

    def step(self, state: State, action: torch.Tensor) -> State:
        # actions in [-1,1] command joint angles in [-pi, pi]
        target_angles = torch.clamp(action, -1.0, 1.0) * math.pi
        qp, info = self.sys.step(state.qp, target_angles)
        rng, rng1 = jr.split(state.info["rng"]).unbind(-2)
        dist = norm(qp.pos[:, self.target] - qp.pos[:, self.wrist])
        hit = (dist < 0.1).to(torch.float32)
        # resample the target on a hit (stays put otherwise)
        qp = teleport(qp, self.target, self._target_pos(rng1), where=hit > 0)
        obs = self._get_obs(qp, info)
        reward = -dist + 10.0 * hit
        metrics = {**state.metrics, "hits": state.metrics["hits"] + hit}
        return state.replace(qp=qp, obs=obs, reward=reward, done=torch.zeros_like(reward),
                             metrics=metrics, info={**state.info, "rng": rng})
