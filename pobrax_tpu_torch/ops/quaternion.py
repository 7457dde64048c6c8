"""Quaternion algebra on the last axis; the port of
`pobrax_tpu/ops/quaternion.py`.

Quaternions are (w, x, y, z) on the last axis and every function broadcasts
over leading axes, so a (B, nbody, 4) rotation field needs no loop. The
formulas are written as in the JAX module so both round alike.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from pobrax_tpu_torch.ops.vector import cross, norm


def quat_mul(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Hamilton product u ∘ v; (..., 4) x (..., 4) -> (..., 4)."""
    uw, ux, uy, uz = u.unbind(-1)
    vw, vx, vy, vz = v.unbind(-1)
    return torch.stack(
        [
            uw * vw - ux * vx - uy * vy - uz * vz,
            uw * vx + ux * vw + uy * vz - uz * vy,
            uw * vy - ux * vz + uy * vw + uz * vx,
            uw * vz + ux * vy - uy * vx + uz * vw,
        ],
        dim=-1,
    )


def quat_inv(q: torch.Tensor) -> torch.Tensor:
    """Conjugate of a unit quaternion: (w, -x, -y, -z)."""
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def rotate(vec: torch.Tensor, quat: torch.Tensor) -> torch.Tensor:
    """Rotate (..., 3) vectors by (..., 4) unit quaternions."""
    s = quat[..., 0:1]
    u = quat[..., 1:]
    # 2(u·v)u + (s² − u·u)v + 2s(u×v)
    dot_uv = (u * vec).sum(-1, keepdim=True)
    dot_uu = (u * u).sum(-1, keepdim=True)
    return 2.0 * dot_uv * u + (s * s - dot_uu) * vec + 2.0 * s * cross(u, vec)


def inv_rotate(vec: torch.Tensor, quat: torch.Tensor) -> torch.Tensor:
    """Rotate vectors by the inverse of unit quaternions (world -> body frame)."""
    return rotate(vec, quat_inv(quat))


def ang_to_quat(ang: torch.Tensor) -> torch.Tensor:
    """Embed an angular-velocity 3-vector as a pure quaternion (0, wx, wy, wz)."""
    return torch.cat([torch.zeros_like(ang[..., :1]), ang], dim=-1)


def euler_to_quat(v: torch.Tensor) -> torch.Tensor:
    """Euler angles in *degrees*, intrinsic Tait-Bryan x-y'-z'' -> quaternion
    (the convention of a scene's `rotation {x: .. y: .. z: ..}` fields)."""
    half = v * (math.pi / 360.0)
    c1, c2, c3 = torch.cos(half).unbind(-1)
    s1, s2, s3 = torch.sin(half).unbind(-1)
    w = c1 * c2 * c3 - s1 * s2 * s3
    x = s1 * c2 * c3 + c1 * s2 * s3
    y = c1 * s2 * c3 - s1 * c2 * s3
    z = c1 * c2 * s3 + s1 * s2 * c3
    return torch.stack([w, x, y, z], dim=-1)


def quat_rot_axis(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Quaternion for a rotation of `angle` radians about unit `axis` (..., 3)."""
    half = angle[..., None] * 0.5
    return torch.cat([torch.cos(half), axis * torch.sin(half)], dim=-1)


def relative_quat(q_parent: torch.Tensor, q_child: torch.Tensor) -> torch.Tensor:
    """Rotation taking the parent frame to the child frame: inv(q_p) ∘ q_c."""
    return quat_mul(quat_inv(q_parent), q_child)


def quat_to_axis_angle(q: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decompose unit quaternions into (unit axis (..., 3), angle (...,) in
    (-pi, pi]); the axis is (1, 0, 0) where |xyz| < 1e-10."""
    sin_half = norm(q[..., 1:])
    # keep the sign of w so the angle lands in (-pi, pi]
    angle = 2.0 * torch.atan2(sin_half, q[..., 0])
    angle = torch.where(angle > math.pi, angle - 2.0 * math.pi, angle)
    small = sin_half[..., None] < 1e-10
    safe = torch.where(small, torch.ones_like(sin_half[..., None]), sin_half[..., None])
    x_axis = torch.tensor([1.0, 0.0, 0.0], dtype=q.dtype, device=q.device)
    axis = torch.where(small, x_axis.expand_as(q[..., 1:]), q[..., 1:] / safe)
    return axis, angle
