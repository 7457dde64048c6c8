"""Vector helpers on the last axis; the port of `pobrax_tpu/ops/vector.py`."""

from __future__ import annotations

import torch


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product of (..., 3) vectors, broadcasting like `jnp.cross`."""
    ax, ay, az = a.unbind(-1)
    bx, by, bz = b.unbind(-1)
    return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(-1)


def norm(x: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis, computed as sqrt(sum(x*x)) like
    `jnp.linalg.norm` of a vector."""
    return torch.sqrt((x * x).sum(-1))


def safe_norm(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """Norm over the last axis that is exactly 0 (not NaN-prone) at x == 0."""
    sq = (x * x).sum(-1, keepdim=keepdim)
    is_zero = sq < 1e-24
    sq = torch.where(is_zero, torch.ones_like(sq), sq)
    return torch.where(is_zero, torch.zeros_like(sq), torch.sqrt(sq))
