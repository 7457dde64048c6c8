"""Shared observation assembly for the ant family; the port of
`pobrax_tpu/envs/common.py`."""

from __future__ import annotations

from typing import List

import torch

from pobrax_tpu_torch.physics.state import Info, QP
from pobrax_tpu_torch.physics.system import System


def ant_full_obs(sys: System, qp: QP, info: Info) -> List[torch.Tensor]:
    """qpos + qvel + clipped contact-force blocks common to the PO ant envs,
    each (B, k).

    Layout: torso pos (3), torso rot quat (4), joint angles (8), torso vel
    (3), torso ang (3), joint vels (8), clip(contact.vel, ±1) flattened
    (3*nbody), clip(contact.ang, ±1) flattened (3*nbody).
    """
    (joint_angle,), (joint_vel,) = sys.joints[0].angle_vel(qp)
    B = qp.pos.shape[0]
    qpos = [qp.pos[:, 0], qp.rot[:, 0], joint_angle]
    qvel = [qp.vel[:, 0], qp.ang[:, 0], joint_vel]
    cfrc = [
        torch.clamp(info.contact.vel, -1, 1).reshape(B, -1),
        torch.clamp(info.contact.ang, -1, 1).reshape(B, -1),
    ]
    return qpos + qvel + cfrc


def dead_and_reward(qp: QP, torso_idx: int, dying_cost: float):
    """Torso-height termination band: dead if z < 0.2 or z > 1.0; reward =
    dying_cost when dead else 0. Both (B,) float32."""
    z = qp.pos[:, torso_idx, 2]
    dead = ((z < 0.2) | (z > 1.0)).to(torch.float32)
    reward = torch.where(dead > 0, torch.full_like(z, dying_cost), torch.zeros_like(z))
    return dead, reward
