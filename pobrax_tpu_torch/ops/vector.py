"""Vector helpers; the port of `pobrax_tpu/ops/vector.py`."""

from __future__ import annotations

import torch


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product of (..., 3) vectors, broadcasting like `jnp.cross`."""
    ax, ay, az = a.unbind(-1)
    bx, by, bz = b.unbind(-1)
    return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(-1)


def norm(x: torch.Tensor, axis: int = -1, keepdims: bool = False) -> torch.Tensor:
    """Euclidean norm over `axis`, computed as sqrt(sum(x*x)) like
    `jnp.linalg.norm` of a vector."""
    return torch.sqrt((x * x).sum(axis, keepdim=keepdims))


def safe_norm(x: torch.Tensor, axis: int = -1, keepdims: bool = False) -> torch.Tensor:
    """Norm over `axis` that is exactly 0 (not NaN-prone) at x == 0."""
    sq = (x * x).sum(axis, keepdim=keepdims)
    is_zero = sq < 1e-24
    sq = torch.where(is_zero, torch.ones_like(sq), sq)
    return torch.where(is_zero, torch.zeros_like(sq), torch.sqrt(sq))


def normalize(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """x / |x| over `axis`, returning 0 for vectors with norm < 1e-12."""
    n = safe_norm(x, axis=axis, keepdims=True)
    small = n < 1e-12
    return torch.where(small, torch.zeros_like(x), x / torch.where(small, torch.ones_like(n), n))
