"""Spring joints: compiled tables, forces, angle readout; the port of
`pobrax_tpu/physics/joints.py`.

The legacy-Brax joint contract, for 1, 2 and 3 rotational dof:
  * a positional spring pulling the two bodies' world-space anchors together
  * alignment torques locking the (3 - dof) non-free rotational axes
  * per-dof angle-limit torque springs
  * relative angular damping
  * torque actuators (tau = strength * clip(act, -1, 1)) and angle actuators
    (a saturating position servo toward a commanded angle)

Joint angles are the intrinsic x-y'-z'' Euler decomposition of the relative
rotation in the joint frame; a 1-dof hinge reads 2*atan2(q_x, q_w). All J
joints of a dof class are one batched computation on (B, J, ...) tensors;
per-body sums are `index_add` over the body axis.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch

from pobrax_tpu_torch.ops import quaternion as quat
from pobrax_tpu_torch.ops.vector import cross
from pobrax_tpu_torch.physics import config as pcfg
from pobrax_tpu_torch.physics.bodies import Bodies
from pobrax_tpu_torch.physics.state import P, QP

# Position-servo gain for "angle" actuators: tau = clip(GAIN * (target_rad -
# angle_rad), ±strength) — the JAX package's documented deviation from legacy
# brax (PARITY.md "Known deltas").
ANGLE_SERVO_GAIN = 25.0

_AXES = np.eye(3, dtype=np.float32)


def _euler_to_quat_np(v_deg) -> np.ndarray:
    half = np.asarray(v_deg, np.float64) * (math.pi / 360.0)
    c1, c2, c3 = np.cos(half)
    s1, s2, s3 = np.sin(half)
    return np.array(
        [
            c1 * c2 * c3 - s1 * s2 * s3,
            s1 * c2 * c3 + c1 * s2 * s3,
            c1 * s2 * c3 - s1 * c2 * s3,
            c1 * c2 * s3 + s1 * s2 * c3,
        ],
        np.float32,
    )


def euler_xyz_from_quat(q: torch.Tensor) -> torch.Tensor:
    """Intrinsic x-y'-z'' Euler angles (..., 3) of a quaternion (..., 4)."""
    w, x, y, z = q.unbind(-1)
    m02 = 2.0 * (x * z + w * y)
    m12 = 2.0 * (y * z - w * x)
    m22 = 1.0 - 2.0 * (x * x + y * y)
    m01 = 2.0 * (x * y - w * z)
    m00 = 1.0 - 2.0 * (y * y + z * z)
    a = torch.atan2(-m12, m22)
    b = torch.asin(torch.clamp(m02, -1.0, 1.0))
    c = torch.atan2(-m01, m00)
    return torch.stack([a, b, c], dim=-1)


def scatter_bodies(nbody: int, *pairs) -> torch.Tensor:
    """(B, nbody, 3) sums of per-row (B, K, 3) values into body indices, in
    the order given — the `.at[idx].add(...)` chain of the JAX code."""
    first = pairs[1]
    out = first.new_zeros(first.shape[0], nbody, 3)
    for idx, val in zip(pairs[0::2], pairs[1::2]):
        out = out.index_add(1, idx, val)
    return out


class JointGroup:
    """All joints of one dof class (1, 2 or 3), as flat tables (J, ...)."""

    def __init__(self, cfg: pcfg.Config, bodies: Bodies,
                 joints: Sequence[pcfg.Joint], dof: int, device: torch.device):
        assert all(len(j.angle_limits) == dof for j in joints)
        self.dof = dof
        self.count = len(joints)
        self.names = tuple(j.name for j in joints)
        self.parent = np.array([bodies.index[j.parent] for j in joints], np.int32)
        self.child = np.array([bodies.index[j.child] for j in joints], np.int32)
        self.off_p = np.array([j.parent_offset for j in joints], np.float32)
        self.off_c = np.array([j.child_offset for j in joints], np.float32)
        self.q_j = (np.stack([_euler_to_quat_np(j.rotation) for j in joints])
                    if joints else np.zeros((0, 4), np.float32))
        deg2rad = math.pi / 180.0
        self.limit = np.array(
            [[[l.min * deg2rad, l.max * deg2rad] for l in j.angle_limits] for j in joints],
            np.float32,
        ).reshape(self.count, dof, 2)
        self.stiffness = np.array([j.stiffness for j in joints], np.float32)
        self.spring_damping = np.array(
            [j.spring_damping if j.spring_damping is not None else 2.0 * math.sqrt(j.stiffness)
             for j in joints],
            np.float32,
        )
        self.limit_strength = np.array(
            [j.limit_strength if j.limit_strength is not None else j.stiffness for j in joints],
            np.float32,
        )
        self.angular_damping = np.array([j.angular_damping for j in joints], np.float32)

        # actuator wiring: act_idx[j] = start index into the action vector
        # (or -1); the action vector is ordered by cfg.actuators declaration,
        # each actuator consuming `dof(joint)` consecutive dims
        act_idx = np.full(self.count, -1, np.int32)
        act_strength = np.zeros(self.count, np.float32)
        act_kind = np.zeros(self.count, np.int32)  # 0 torque, 1 angle
        joint_pos = {name: i for i, name in enumerate(self.names)}
        a_i = 0
        for a in cfg.actuators:
            if a.joint in joint_pos:
                j = joint_pos[a.joint]
                act_idx[j] = a_i
                act_strength[j] = a.strength
                act_kind[j] = 1 if a.kind == "angle" else 0
            a_i += _dof_of(cfg, a.joint)
        self.act_idx = act_idx
        self.act_strength = act_strength
        self.act_kind = act_kind

        # default angle: config override, else midpoint of limits
        overrides = {d.name: d.angle for d in cfg.default_angles}
        defaults = []
        for j in joints:
            ov = overrides.get(j.name)
            for d, l in enumerate(j.angle_limits):
                val = ov[d] if ov is not None else 0.5 * (l.min + l.max)
                defaults.append(val * deg2rad)
        self.default_angle = np.array(defaults, np.float32).reshape(self.count * dof)

        # device copies of everything the batched functions read
        t = lambda a, dtype=torch.float32: torch.as_tensor(a, dtype=dtype, device=device)
        self._nbody = bodies.count
        self._parent = t(self.parent, torch.long)
        self._child = t(self.child, torch.long)
        self._off_p, self._off_c, self._q_j = t(self.off_p), t(self.off_c), t(self.q_j)
        self._lim_lo, self._lim_hi = t(self.limit[..., 0]), t(self.limit[..., 1])
        self._k, self._kd = t(self.stiffness)[:, None], t(self.spring_damping)[:, None]
        self._klim = t(self.limit_strength)[:, None]
        self._kang = t(self.angular_damping)[:, None]
        self._free_mask = t(np.concatenate(
            [np.zeros(dof, np.float32), np.ones(3 - dof, np.float32)]))
        self._axes = t(np.broadcast_to(_AXES[:dof, None, :], (dof, self.count, 3)).copy())
        self._im_c = t(bodies.inv_mass[self.child])[:, None]
        self._im_p = t(bodies.inv_mass[self.parent])[:, None]
        self._ii_c = t(bodies.inv_inertia[self.child])
        self._ii_p = t(bodies.inv_inertia[self.parent])
        self._actuated = bool(np.any(act_idx >= 0))
        self._act_on = t(act_idx >= 0, torch.bool)[:, None]
        self._act_ids = t(np.maximum(act_idx, 0)[:, None] + np.arange(dof)[None, :], torch.long)
        self._act_k = t(act_strength)[:, None]
        self._act_angle = t(act_kind == 1, torch.bool)[:, None]

    # ---- kinematics ------------------------------------------------------------

    def _frames(self, qp: QP):
        """World-frame joint data: joint frames and relative rotation."""
        q_p = qp.rot[:, self._parent]  # (B, J, 4)
        q_c = qp.rot[:, self._child]
        q_pj = quat.quat_mul(q_p, self._q_j)  # joint frame in world (via parent)
        q_cj = quat.quat_mul(q_c, self._q_j)  # joint frame in world (via child)
        q_d = quat.quat_mul(quat.quat_inv(q_pj), q_cj)  # relative rot, joint frame
        return q_p, q_c, q_pj, q_d

    def _world_axes(self, q_pj: torch.Tensor) -> torch.Tensor:
        """(B, J, dof, 3) world-frame rotation axes (joint-frame x, y, z)."""
        return torch.stack([quat.rotate(self._axes[d], q_pj) for d in range(self.dof)], dim=-2)

    def angles(self, q_d: torch.Tensor) -> torch.Tensor:
        """(B, J, dof) joint angles from the relative rotation."""
        if self.dof == 1:
            return (2.0 * torch.atan2(q_d[..., 1], q_d[..., 0]))[..., None]
        return euler_xyz_from_quat(q_d)[..., : self.dof]

    def angle_vel(self, qp: QP) -> Tuple[Tuple[torch.Tensor, ...], Tuple[torch.Tensor, ...]]:
        """((angles per dof), (vels per dof)), each (B, J); radians, rad/s."""
        _, _, q_pj, q_d = self._frames(qp)
        ang = self.angles(q_d)
        axes = self._world_axes(q_pj)
        rel_ang = (qp.ang[:, self._child] - qp.ang[:, self._parent])[:, :, None, :]
        vel = (rel_ang * axes).sum(-1)  # (B, J, dof)
        return (tuple(ang[..., d] for d in range(self.dof)),
                tuple(vel[..., d] for d in range(self.dof)))

    # ---- dynamics ------------------------------------------------------------

    def apply(self, qp: QP) -> P:
        """Spring + limit + alignment + damping forces, as accelerations."""
        B = qp.pos.shape[0]
        if self.count == 0:
            return P.zero(B, self._nbody, qp.pos.device)
        q_p, q_c, q_pj, q_d = self._frames(qp)
        par, chi = self._parent, self._child
        r_p = quat.rotate(self._off_p, q_p)  # anchor lever arms, world
        r_c = quat.rotate(self._off_c, q_c)
        anchor_p = qp.pos[:, par] + r_p
        anchor_c = qp.pos[:, chi] + r_c
        vel_anchor_p = qp.vel[:, par] + cross(qp.ang[:, par], r_p)
        vel_anchor_c = qp.vel[:, chi] + cross(qp.ang[:, chi], r_c)

        # (a) positional spring pulling anchors together (force on child toward parent)
        d = anchor_p - anchor_c
        force_c = self._k * d + self._kd * (vel_anchor_p - vel_anchor_c)

        # (b) alignment torque on the (3 - dof) locked rotational axes
        rv = 2.0 * torch.sign(q_d[..., 0:1]) * q_d[..., 1:]
        torque_align_c = -self._k * quat.rotate(rv * self._free_mask, q_pj)

        # (c) per-dof angle-limit torque springs about the world axes
        ang = self.angles(q_d)
        clipped = torch.minimum(torch.maximum(ang, self._lim_lo), self._lim_hi)
        axes = self._world_axes(q_pj)
        torque_limit_c = ((self._klim * (clipped - ang))[..., None] * axes).sum(-2)

        # (d) relative angular damping
        torque_damp_c = -self._kang * (qp.ang[:, chi] - qp.ang[:, par])

        torque_c = torque_align_c + torque_limit_c + torque_damp_c

        dvel = scatter_bodies(self._nbody, chi, force_c * self._im_c, par, -force_c * self._im_p)
        tq_child = cross(r_c, force_c) + torque_c
        tq_parent = cross(r_p, -force_c) - torque_c
        dang = scatter_bodies(self._nbody, chi, tq_child * self._ii_c, par, tq_parent * self._ii_p)
        return P(vel=dvel, ang=dang)

    def apply_actuators(self, qp: QP, act: torch.Tensor) -> P:
        """Per-dof actuation about the world joint axes.

        torque kind: tau_d = strength * clip(act_d, -1, 1)
        angle kind:  tau_d = clip(25 * (act_d - angle_d), -strength, strength)
        """
        B = qp.pos.shape[0]
        if self.count == 0 or not self._actuated:
            return P.zero(B, self._nbody, qp.pos.device)
        _, _, q_pj, q_d = self._frames(qp)
        axes = self._world_axes(q_pj)
        a = torch.where(self._act_on, act[:, self._act_ids], 0.0)

        tau_torque = self._act_k * torch.clamp(a, -1.0, 1.0)
        ang = self.angles(q_d)
        tau_angle = torch.minimum(torch.maximum(ANGLE_SERVO_GAIN * (a - ang), -self._act_k),
                                  self._act_k)
        tau = torch.where(self._act_angle, tau_angle, tau_torque)
        tau = torch.where(self._act_on, tau, 0.0)

        torque = (tau[..., None] * axes).sum(-2)
        dang = scatter_bodies(self._nbody, self._child, torque * self._ii_c,
                              self._parent, -torque * self._ii_p)
        return P(vel=torch.zeros_like(dang), ang=dang)


def _dof_of(cfg: pcfg.Config, joint_name: str) -> int:
    for j in cfg.joints:
        if j.name == joint_name:
            return len(j.angle_limits)
    raise KeyError(joint_name)
