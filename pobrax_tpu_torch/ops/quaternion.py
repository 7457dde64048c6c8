"""Quaternion algebra on the last axis; the port of the functions of
`pobrax_tpu/ops/quaternion.py` that the ported path uses.

Quaternions are (w, x, y, z) on the last axis and every function broadcasts
over leading axes, so a (B, nbody, 4) rotation field needs no loop. The
formulas are written as in the JAX module so both round alike.
"""

from __future__ import annotations

import torch

from pobrax_tpu_torch.ops.vector import cross


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


def ang_to_quat(ang: torch.Tensor) -> torch.Tensor:
    """Embed an angular-velocity 3-vector as a pure quaternion (0, wx, wy, wz)."""
    return torch.cat([torch.zeros_like(ang[..., :1]), ang], dim=-1)


def quat_rot_axis(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Quaternion for a rotation of `angle` radians about unit `axis` (..., 3)."""
    half = angle[..., None] * 0.5
    return torch.cat([torch.cos(half), axis * torch.sin(half)], dim=-1)
