"""Semi-implicit Euler with substeps; the port of `pobrax_tpu/physics/integrator.py`.

Update order per substep (velocity first, then position — symplectic):
  1. potential: vel += (gravity + force-accels) * h, with exponential damping
  2. kinetic:   pos += vel * h; rot integrated by the quaternion derivative
  3. collide:   vel += contact impulses (velocity level, no dt)

Per-axis frozen masks gate every component update, so fully frozen targets
and walls stay bit-stable across steps and planar models stay in-plane.
"""

from __future__ import annotations

import numpy as np
import torch

from pobrax_tpu_torch.ops import quaternion as quat
from pobrax_tpu_torch.physics.bodies import Bodies
from pobrax_tpu_torch.physics.state import P, QP


class Integrator:
    def __init__(self, *, dt: float, substeps: int, gravity, velocity_damping: float,
                 angular_damping: float, bodies: Bodies, device: torch.device):
        self.h = float(dt) / int(substeps)
        self.substeps = int(substeps)
        self.gravity = np.asarray(gravity, np.float32)
        # exponential damping factors e^(c*h); c <= 0 damps
        self.vel_damp = float(np.exp(velocity_damping * self.h))
        self.ang_damp = float(np.exp(angular_damping * self.h))
        self._gravity = torch.as_tensor(self.gravity, device=device)
        self._mpos = torch.as_tensor(bodies.active_pos > 0, device=device)
        self._mrot = torch.as_tensor(bodies.active_rot > 0, device=device)
        self._rot_free = torch.as_tensor(
            np.any(bodies.active_rot > 0, axis=-1, keepdims=True), device=device)

    def potential(self, qp: QP, dp: P) -> QP:
        vel = self.vel_damp * qp.vel + (self._gravity + dp.vel) * self.h
        ang = self.ang_damp * qp.ang + dp.ang * self.h
        return qp.replace(vel=torch.where(self._mpos, vel, qp.vel),
                          ang=torch.where(self._mrot, ang, qp.ang))

    def kinetic(self, qp: QP) -> QP:
        pos = qp.pos + qp.vel * self.h
        drot = 0.5 * self.h * quat.quat_mul(quat.ang_to_quat(qp.ang), qp.rot)
        rot = qp.rot + drot
        rot = rot / torch.sqrt((rot * rot).sum(-1, keepdim=True))
        return qp.replace(pos=torch.where(self._mpos, pos, qp.pos),
                          rot=torch.where(self._rot_free, rot, qp.rot))

    def collide(self, qp: QP, dp: P) -> QP:
        return qp.replace(vel=torch.where(self._mpos, qp.vel + dp.vel, qp.vel),
                          ang=torch.where(self._mrot, qp.ang + dp.ang, qp.ang))
