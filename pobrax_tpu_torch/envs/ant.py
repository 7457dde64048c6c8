"""The stock Ant locomotion env (registry name 'ant'); the port of
`pobrax_tpu/envs/ant.py`, natively batched.

Reward: forward x-velocity + survival - control cost - contact cost;
done outside the torso-height band (0.2, 1.0). The 87-dim observation
matches the reference's mask tables: pos [0, 13) = torso z (1) + quat (4) +
8 joint angles; vel [13, 27) = torso vel + ang + 8 joint velocities;
cfrc [27, 87) = clipped contact vel and ang of the 10 bodies. It reads the
contact Info, so the System runs the full-Info kernel by default.
"""

from __future__ import annotations

import torch

from pobrax_tpu_torch import random as jr
from pobrax_tpu_torch.envs.base import Env, State
from pobrax_tpu_torch.physics import ant as ant_model
from pobrax_tpu_torch.physics.state import Info, QP


class Ant(Env):
    def __init__(self, device=None, info: str = "full", **kwargs):
        super().__init__(ant_model.ant_config(), device, info)
        self.torso_idx = self.sys.body.index["$ Torso"]

    @property
    def observation_size(self) -> int:
        ndof = self.sys.num_joint_dof
        return 1 + 4 + ndof + 3 + 3 + ndof + 6 * self.sys.num_bodies

    def reset(self, rng: torch.Tensor) -> State:
        """(B, 2) keys -> a batch of B fresh episodes."""
        rng, rng1, rng2 = jr.split(rng, 3).unbind(-2)
        ndof = self.sys.num_joint_dof
        qpos = self.sys.default_angle() + jr.uniform(rng1, (ndof,), -0.1, 0.1)
        qvel = jr.uniform(rng2, (ndof,), -0.1, 0.1)
        qp = self.sys.default_qp(joint_angle=qpos, joint_velocity=qvel)
        obs = self._get_obs(qp, self.sys.info(qp))
        zero = torch.zeros(rng.shape[0], device=rng.device)
        metrics = {"reward_ctrl_cost": zero, "reward_contact_cost": zero,
                   "reward_forward": zero, "reward_survive": zero}
        return State(qp, obs, zero, zero.clone(), metrics, {"rng": rng})

    def step(self, state: State, action: torch.Tensor) -> State:
        qp, info = self.sys.step(state.qp, action)
        obs = self._get_obs(qp, info)
        t = self.torso_idx
        forward = (qp.pos[:, t, 0] - state.qp.pos[:, t, 0]) / self.sys.config.dt
        ctrl_cost = 0.5 * torch.square(action).sum(-1)
        contact_cost = 0.5 * 1e-3 * torch.square(torch.clamp(info.contact.vel, -1, 1)).sum((1, 2))
        survive = torch.ones_like(forward)
        reward = forward - ctrl_cost - contact_cost + survive
        z = qp.pos[:, t, 2]
        done = ((z < 0.2) | (z > 1.0)).to(torch.float32)
        metrics = {**state.metrics, "reward_ctrl_cost": ctrl_cost,
                   "reward_contact_cost": contact_cost, "reward_forward": forward,
                   "reward_survive": survive}
        return state.replace(qp=qp, obs=obs, reward=reward, done=done, metrics=metrics)

    def _get_obs(self, qp: QP, info: Info) -> torch.Tensor:
        """Torso z, orientation and joint angles; velocities; clipped cfrc."""
        (joint_angle,), (joint_vel,) = self.sys.joints[0].angle_vel(qp)
        B = qp.pos.shape[0]
        qpos = [qp.pos[:, 0, 2:], qp.rot[:, 0], joint_angle]
        qvel = [qp.vel[:, 0], qp.ang[:, 0], joint_vel]
        cfrc = [torch.clamp(info.contact.vel, -1, 1).reshape(B, -1),
                torch.clamp(info.contact.ang, -1, 1).reshape(B, -1)]
        return torch.cat(qpos + qvel + cfrc, dim=-1)
