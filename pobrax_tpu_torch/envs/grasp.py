"""Grasp env: a flying 4-finger claw picks up a ball and carries it to a
floating target; target resampled on delivery. The port of
`pobrax_tpu/envs/grasp.py`, natively batched.

Behavioral equivalent of the stock brax grasp the reference registers
(po-brax po_brax/envs/__init__.py:36). Observation (132) matches the
reference's mask tables: OBJECT_POS [0,4), TARGET_POS [4,8),
POSITION [8,56), VELOCITY [56,104)+[107,110), HEADINGS [104,107)+[110,116),
CFRC [116,132).
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


class Grasp(Env):
    def __init__(self, device=None, info: str = "full", **kwargs):
        super().__init__(manipulation.grasp_config(), device, info)
        self.palm = self.sys.body.index["palm"]
        self.obj = self.sys.body.index["Object"]
        self.target = self.sys.body.index["Target"]
        # palm + 12 finger segments + Object + Target + Ground = 16 bodies
        # (Ground pads the block to the mask table's 48-wide POSITION span)
        self._obs_bodies = torch.tensor(
            [self.sys.body.index[n] for n in manipulation.GRASP_BODY_ORDER]
            + [self.sys.body.index["Ground"]], device=self.device)
        limits = torch.as_tensor(self.sys.joints[0].limit, device=self.device)  # (12, 1, 2)
        self._servo_lo, self._servo_hi = limits[:, 0, 0], limits[:, 0, 1]

    @property
    def observation_size(self) -> int:
        return 132

    def reset(self, rng: torch.Tensor) -> State:
        """(B, 2) keys -> a batch of B fresh episodes."""
        rng, rng1, rng2 = jr.split(rng, 3).unbind(-2)
        qpos = self.sys.default_angle() + jr.uniform(rng1, (self.sys.num_joint_dof,), -0.05, 0.05)
        qp = self.sys.default_qp(joint_angle=qpos)
        qp = teleport(qp, self.target, self._target_pos(rng2))
        info = self.sys.info(qp)
        obs = self._get_obs(qp, info)
        zero = torch.zeros(rng.shape[0], device=rng.device)
        return State(qp, obs, zero, zero.clone(), {"hits": zero.clone()}, {"rng": rng})

    def _target_pos(self, rng: torch.Tensor) -> torch.Tensor:
        r1, r2 = jr.split(rng).unbind(-2)
        theta = jr.uniform(r1, (), 0.0, 2.0 * math.pi)
        radius = jr.uniform(r2, (), 0.4, 0.8)
        return polar_point(radius, theta, 0.8)

    def _get_obs(self, qp: QP, info: Info) -> torch.Tensor:
        B = qp.pos.shape[0]
        n16 = self._obs_bodies  # 16 bodies: hand(13) + Object + Target + Ground
        obj_pos, tgt_pos = qp.pos[:, self.obj], qp.pos[:, self.target]
        palm_to_obj = obj_pos - qp.pos[:, self.palm]
        obj_to_tgt = tgt_pos - obj_pos
        body_pos = qp.pos[:, n16].reshape(B, -1)  # 48
        body_vel = qp.vel[:, n16].reshape(B, -1)  # 48
        contact_mag = norm(torch.clamp(info.contact.vel, -1, 1))[:, :16]  # 16
        return torch.cat([
            obj_pos, norm(palm_to_obj)[:, None],  # [0,4) object block
            tgt_pos, norm(obj_to_tgt)[:, None],  # [4,8) target block
            body_pos,  # [8,56)
            body_vel,  # [56,104)
            palm_to_obj,  # [104,107) heading: palm -> object
            qp.vel[:, self.obj],  # [107,110) object velocity
            obj_to_tgt, qp.ang[:, self.obj],  # [110,116) heading: object -> target
            contact_mag,  # [116,132)
        ], dim=-1)

    def step(self, state: State, action: torch.Tensor) -> State:
        # finger servos take [-1,1] -> their limit range; thrusters raw
        n_joint = self.sys.num_joint_dof
        lo, hi = self._servo_lo, self._servo_hi
        servo = lo + (torch.clamp(action[:, :n_joint], -1.0, 1.0) * 0.5 + 0.5) * (hi - lo)
        act = torch.cat([servo, action[:, n_joint:]], dim=-1)
        qp, info = self.sys.step(state.qp, act)
        rng, rng1 = jr.split(state.info["rng"]).unbind(-2)
        obj_to_tgt = norm(qp.pos[:, self.target] - qp.pos[:, self.obj])
        palm_to_obj = norm(qp.pos[:, self.obj] - qp.pos[:, self.palm])
        hit = (obj_to_tgt < 0.15).to(torch.float32)
        qp = teleport(qp, self.target, self._target_pos(rng1), where=hit > 0)
        obs = self._get_obs(qp, info)
        reward = -0.5 * palm_to_obj - obj_to_tgt + 20.0 * hit
        metrics = {**state.metrics, "hits": state.metrics["hits"] + hit}
        return state.replace(qp=qp, obs=obs, reward=reward, done=torch.zeros_like(reward),
                             metrics=metrics, info={**state.info, "rng": rng})
