"""Humanoid envs: locomotion (`humanoid`) and stand-up (`humanoidstandup`);
the port of `pobrax_tpu/envs/humanoid.py`, natively batched.

Behavioral equivalents of the stock brax envs the reference registers
(po-brax po_brax/envs/__init__.py:39-40). The 299-dim observation layout
matches the reference's mask tables (standard_observability_masks.py):
  [0,22)    qpos: torso z + torso quat + 17 joint angles
  [22,45)   qvel: torso vel + torso ang + 17 joint vels
  [45,144)  com-inertia block: per dynamic body (11) 9 values
  [144,210) com-velocity block: per dynamic body (11) vel+ang
  [210,227) actuator-force block: 17 clipped action torques
  [227,299) contact block: clipped contact vel+ang per body (12)
(POSITION covers [0,22)+[45,144); VELOCITY [22,45)+[144,210);
CFRC [210,299).)
"""

from __future__ import annotations

from typing import Tuple

import torch

from pobrax_tpu_torch import random as jr
from pobrax_tpu_torch.envs.base import Env, State
from pobrax_tpu_torch.physics import humanoid as humanoid_model
from pobrax_tpu_torch.physics.state import Info, QP


class Humanoid(Env):
    """Run forward; alive bonus 5, velocity reward, quadratic ctrl/contact
    costs; done outside the torso-height band (0.7, 2.1)."""

    _config_fn = staticmethod(humanoid_model.humanoid_config)

    def __init__(self, device=None, info: str = "full", **kwargs):
        super().__init__(self._config_fn(), device, info)
        self.torso = self.sys.body.index["torso"]
        self.n_dyn = len(humanoid_model.BODY_ORDER)
        masses = [b.mass for b in self._cfg.bodies[: self.n_dyn]]
        self._mass = torch.tensor(masses, dtype=torch.float32, device=self.device)
        strengths = []
        for a in self._cfg.actuators:
            j = next(jj for jj in self._cfg.joints if jj.name == a.joint)
            strengths += [a.strength] * len(j.angle_limits)
        self._strength = torch.tensor(strengths, dtype=torch.float32, device=self.device)

    @property
    def observation_size(self) -> int:
        return 299

    def reset(self, rng: torch.Tensor) -> State:
        """(B, 2) keys -> a batch of B fresh episodes."""
        rng, rng1, rng2 = jr.split(rng, 3).unbind(-2)
        ndof = self.sys.num_joint_dof
        qpos = self.sys.default_angle() + jr.uniform(rng1, (ndof,), -0.01, 0.01)
        qvel = jr.uniform(rng2, (ndof,), -0.01, 0.01)
        qp = self.sys.default_qp(joint_angle=qpos, joint_velocity=qvel)
        info = self.sys.info(qp)
        B = rng.shape[0]
        obs = self._get_obs(qp, info, torch.zeros(B, self.sys.action_size, device=rng.device))
        zero = torch.zeros(B, device=rng.device)
        metrics = {"reward_forward": zero, "reward_survive": zero,
                   "reward_ctrl_cost": zero, "reward_contact_cost": zero}
        return State(qp, obs, zero, zero.clone(), metrics, {"rng": rng})

    def _joint_angles_vels(self, qp: QP) -> Tuple[torch.Tensor, torch.Tensor]:
        B = qp.pos.shape[0]
        angles, vels = [], []
        for g in self.sys.joints:
            a, v = g.angle_vel(qp)
            # interleave per-joint (j0d0, j0d1, ...) within each group
            angles.append(torch.stack(a, dim=-1).reshape(B, -1))
            vels.append(torch.stack(v, dim=-1).reshape(B, -1))
        return torch.cat(angles, -1), torch.cat(vels, -1)

    def _get_obs(self, qp: QP, info: Info, action: torch.Tensor) -> torch.Tensor:
        joint_angle, joint_vel = self._joint_angles_vels(qp)
        B, n = qp.pos.shape[0], self.n_dyn
        com = (self._mass[:, None] * qp.pos[:, :n]).sum(1) / self._mass.sum()
        rel = qp.pos[:, :n] - com[:, None]
        qpos = [qp.pos[:, self.torso, 2:], qp.rot[:, self.torso], joint_angle]
        qvel = [qp.vel[:, self.torso], qp.ang[:, self.torso], joint_vel]
        cinert = [rel.reshape(B, -1), qp.rot[:, :n, 1:].reshape(B, -1),
                  (self._mass[:, None] * rel).reshape(B, -1)]  # 11 * 9 = 99
        cvel = [qp.vel[:, :n].reshape(B, -1), qp.ang[:, :n].reshape(B, -1)]  # 66
        qfrc = [self._strength * torch.clamp(action, -1.0, 1.0)]  # 17
        cfrc = [torch.clamp(info.contact.vel, -1, 1).reshape(B, -1),
                torch.clamp(info.contact.ang, -1, 1).reshape(B, -1)]  # 72
        return torch.cat(qpos + qvel + cinert + cvel + qfrc + cfrc, dim=-1)

    def _costs(self, info: Info, action: torch.Tensor):
        ctrl = 0.1 * torch.square(torch.clamp(action, -1, 1)).sum(-1)
        contact = 0.5e-6 * torch.square(torch.clamp(info.contact.vel, -1, 1)).sum((1, 2))
        return ctrl, contact

    def step(self, state: State, action: torch.Tensor) -> State:
        qp, info = self.sys.step(state.qp, action)
        obs = self._get_obs(qp, info, action)
        forward = (qp.pos[:, self.torso, 0] - state.qp.pos[:, self.torso, 0]) / self.sys.config.dt
        ctrl, contact = self._costs(info, action)
        survive = torch.full_like(forward, 5.0)
        reward = 1.25 * forward + survive - ctrl - contact
        z = qp.pos[:, self.torso, 2]
        done = ((z < 0.7) | (z > 2.1)).to(torch.float32)
        metrics = {**state.metrics, "reward_forward": forward, "reward_survive": survive,
                   "reward_ctrl_cost": ctrl, "reward_contact_cost": contact}
        return state.replace(qp=qp, obs=obs, reward=reward, done=done, metrics=metrics)


class HumanoidStandup(Humanoid):
    """Start lying on the back; reward torso height gain (no termination)."""

    _config_fn = staticmethod(humanoid_model.humanoid_standup_config)

    def step(self, state: State, action: torch.Tensor) -> State:
        qp, info = self.sys.step(state.qp, action)
        obs = self._get_obs(qp, info, action)
        z = qp.pos[:, self.torso, 2]
        uph = z / self.sys.config.dt * 0.1
        ctrl, contact = self._costs(info, action)
        reward = uph - ctrl - contact + 1.0
        metrics = {**state.metrics, "reward_forward": uph,
                   "reward_survive": torch.ones_like(uph), "reward_ctrl_cost": ctrl,
                   "reward_contact_cost": contact}
        return state.replace(qp=qp, obs=obs, reward=reward, done=torch.zeros_like(uph),
                             metrics=metrics)
