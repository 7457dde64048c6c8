"""Physics state as dataclasses of tensors; the port of `pobrax_tpu/physics/state.py`.

Every leaf carries the batch axis FIRST: `QP.pos` is (B, nbody, 3) and
`QP.rot` (B, nbody, 4), (w, x, y, z). `P` is a per-body velocity /
angular-velocity increment, `Info` the per-body contact, joint and actuator
sums over one control step (`info.contact.vel/.ang` feed the observations).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch


class _Replace:
    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


@dataclass
class QP(_Replace):
    pos: torch.Tensor  # (B, nbody, 3)
    rot: torch.Tensor  # (B, nbody, 4) unit quaternion (w, x, y, z)
    vel: torch.Tensor  # (B, nbody, 3)
    ang: torch.Tensor  # (B, nbody, 3) world-frame angular velocity


@dataclass
class P(_Replace):
    """A per-body (velocity, angular-velocity) increment — force or impulse."""

    vel: torch.Tensor  # (B, nbody, 3)
    ang: torch.Tensor  # (B, nbody, 3)

    def __add__(self, other: "P") -> "P":
        return P(vel=self.vel + other.vel, ang=self.ang + other.ang)

    @classmethod
    def zero(cls, batch: int, nbody: int, device=None) -> "P":
        return cls(vel=torch.zeros(batch, nbody, 3, device=device),
                   ang=torch.zeros(batch, nbody, 3, device=device))


@dataclass
class Info(_Replace):
    """Aggregated per-body dynamics diagnostics over one env step."""

    contact: P
    joint: P
    actuator: P

    @classmethod
    def zero(cls, batch: int, nbody: int, device=None) -> "Info":
        return cls(contact=P.zero(batch, nbody, device), joint=P.zero(batch, nbody, device),
                   actuator=P.zero(batch, nbody, device))
