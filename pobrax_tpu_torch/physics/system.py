"""The System: a compiled scene and its batched physics; the port of
`pobrax_tpu/physics/system.py`.

Mirrors the `brax.System` contract the envs consume: `body.index`,
`num_bodies`, `num_joint_dof`, `action_size`, `default_angle()`,
`default_qp(joint_angle=, joint_velocity=)`, `info(qp)`,
`joints[0].angle_vel(qp)`, and `step(qp, act) -> (qp, Info)` running
`substeps` of semi-implicit spring dynamics. Every tensor is batch-first.

`step` dispatches on the DEVICE OF THE TENSORS and nothing else: CUDA tensors
go to the hand-written whole-step kernel (`physics/whole_step.py`), CPU
tensors to the plain `step_generic`. Joint dofs are ordered group-major
(1-dof joints, then 2-dof, then 3-dof) and joint-major within a group; the
action vector is `cfg.actuators` in declaration order (each its joint's dof
dims), then one dim per thruster.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from pobrax_tpu_torch import device as _device
from pobrax_tpu_torch.ops import quaternion as quat
from pobrax_tpu_torch.ops.vector import cross
from pobrax_tpu_torch.physics import config as pcfg
from pobrax_tpu_torch.physics.bodies import Bodies
from pobrax_tpu_torch.physics.geometry import Contacts
from pobrax_tpu_torch.physics.integrator import Integrator
from pobrax_tpu_torch.physics.joints import JointGroup, _euler_to_quat_np
from pobrax_tpu_torch.physics.state import Info, P, QP

_AXES = np.eye(3, dtype=np.float32)


class System:
    def __init__(self, cfg: pcfg.Config, device=None):
        pcfg.validate(cfg)
        self.config = cfg
        self.device = _device.resolve(device)
        self.body = Bodies(cfg)
        self.num_bodies = self.body.count

        self.joints = []
        for dof in (1, 2, 3):
            group = tuple(j for j in cfg.joints if len(j.angle_limits) == dof)
            if group:
                self.joints.append(JointGroup(cfg, self.body, group, dof, self.device))
        self.num_joints = len(cfg.joints)
        self.num_joint_dof = sum(len(j.angle_limits) for j in cfg.joints)
        num_act_dof = sum(len(self._joint_by_name(a.joint).angle_limits)
                          for a in cfg.actuators)
        # thrusters consume one action dim each, after all joint-actuator dims
        self.action_size = num_act_dof + len(cfg.thrusters)
        self._thruster_body = np.array(
            [self.body.index[t.body] for t in cfg.thrusters], np.int32)
        self._thruster_dir = np.array(
            [t.direction for t in cfg.thrusters], np.float32).reshape(-1, 3)
        self._thruster_strength = np.array(
            [t.strength for t in cfg.thrusters], np.float32)
        self._thruster_act0 = num_act_dof
        self.contacts = Contacts(cfg, self.body, self.device)
        self.integrator = Integrator(
            dt=cfg.dt, substeps=cfg.substeps, gravity=cfg.gravity,
            velocity_damping=cfg.velocity_damping, angular_damping=cfg.angular_damping,
            bodies=self.body, device=self.device)
        self._fk_order = self._topological_joints(cfg)
        self._default_pose = self._compile_default_pose(cfg)
        self._fk = self._compile_fk()
        self._thrusters = (
            (torch.as_tensor(self._thruster_body, dtype=torch.long, device=self.device),
             torch.as_tensor(self._thruster_strength, device=self.device),
             torch.as_tensor(self._thruster_dir, device=self.device),
             torch.as_tensor(self.body.inv_mass[self._thruster_body], device=self.device))
            if len(cfg.thrusters) else None)
        # the whole-step kernel's constant tables, built on first CUDA step
        self._step_tables = None

    # ---- defaults / FK -------------------------------------------------------

    def _joint_by_name(self, name: str) -> pcfg.Joint:
        for j in self.config.joints:
            if j.name == name:
                return j
        raise KeyError(name)

    def _dof_slice(self, joint_name: str):
        """(group, slot, start) — where `joint_name`'s dofs live in the
        global group-major angle vector."""
        start = 0
        for g in self.joints:
            if joint_name in g.names:
                slot = g.names.index(joint_name)
                return g, slot, start + slot * g.dof
            start += g.count * g.dof
        raise KeyError(joint_name)

    @staticmethod
    def _topological_joints(cfg: pcfg.Config):
        remaining = list(cfg.joints)
        placed = {b.name for b in cfg.bodies} - {j.child for j in cfg.joints}
        order = []
        while remaining:
            progressed = False
            for j in list(remaining):
                if j.parent in placed:
                    order.append(j)
                    placed.add(j.child)
                    remaining.remove(j)
                    progressed = True
            if not progressed:
                raise ValueError("joint graph has a cycle or disconnected parent")
        return tuple(order)

    def _compile_default_pose(self, cfg: pcfg.Config):
        pos = np.zeros((self.num_bodies, 3), np.float32)
        rot = np.zeros((self.num_bodies, 4), np.float32)
        rot[:, 0] = 1.0
        for d in cfg.default_qps:
            i = self.body.index[d.name]
            pos[i] = np.asarray(d.pos, np.float32)
            rot[i] = _euler_to_quat_np(d.rot)
        return pos, rot

    def _compile_fk(self):
        """FK constants on the System's device, made once: the default pose,
        the joint axes and, per joint in topological order, (parent, child,
        dof, first angle index, q_j, parent offset, child offset)."""
        t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=self.device)
        joints = []
        for j in self._fk_order:
            group, slot, start = self._dof_slice(j.name)
            joints.append((self.body.index[j.parent], self.body.index[j.child], group.dof, start,
                           t(group.q_j[slot]), t(group.off_p[slot]), t(group.off_c[slot])))
        angles = (np.concatenate([g.default_angle for g in self.joints]) if self.joints
                  else np.zeros(0, np.float32))
        return dict(pos0=t(self._default_pose[0]), rot0=t(self._default_pose[1]),
                    axes=t(_AXES), joints=joints, default_angle=t(angles))

    def default_angle(self) -> torch.Tensor:
        """Per-dof default joint angles (radians): config override else limit midpoint."""
        return self._fk["default_angle"]

    def default_qp(self, joint_angle: Optional[torch.Tensor] = None,
                   joint_velocity: Optional[torch.Tensor] = None) -> QP:
        """Forward kinematics from (B, num_joint_dof) joint angles to body
        frames; with no angles given, the default pose as a batch of one."""
        if joint_angle is None:
            joint_angle = self.default_angle()[None]
        if joint_velocity is None:
            joint_velocity = torch.zeros_like(joint_angle)
        B = joint_angle.shape[0]
        dev = joint_angle.device
        fk = self._fk
        pos = list(fk["pos0"].expand(B, -1, -1).unbind(1))
        rot = list(fk["rot0"].expand(B, -1, -1).unbind(1))
        zero3 = torch.zeros(B, 3, device=dev)
        vel = [zero3] * self.num_bodies
        ang = [zero3] * self.num_bodies
        axes = fk["axes"]

        for p_i, c_i, dof, start, q_j, off_p, off_c in fk["joints"]:
            theta = joint_angle[:, start:start + dof]
            theta_dot = joint_velocity[:, start:start + dof]
            q_p = rot[p_i]
            # intrinsic x-y'-z'' composition over the joint's free axes
            q_axis = quat.quat_rot_axis(axes[0], theta[:, 0])
            for d in range(1, dof):
                q_axis = quat.quat_mul(q_axis, quat.quat_rot_axis(axes[d], theta[:, d]))
            q_c = quat.quat_mul(quat.quat_mul(quat.quat_mul(q_p, q_j), q_axis), quat.quat_inv(q_j))
            anchor = pos[p_i] + quat.rotate(off_p, q_p)
            c_pos = anchor - quat.rotate(off_c, q_c)
            q_pj = quat.quat_mul(q_p, q_j)
            c_ang = ang[p_i]
            for d in range(dof):
                c_ang = c_ang + quat.rotate(axes[d], q_pj) * theta_dot[:, d:d + 1]
            c_vel = vel[p_i] + cross(ang[p_i], anchor - pos[p_i]) + cross(c_ang, c_pos - anchor)
            pos[c_i], rot[c_i], vel[c_i], ang[c_i] = c_pos, q_c, c_vel, c_ang
        return QP(pos=torch.stack(pos, 1), rot=torch.stack(rot, 1),
                  vel=torch.stack(vel, 1), ang=torch.stack(ang, 1))

    # ---- dynamics ------------------------------------------------------------

    def info(self, qp: QP) -> Info:
        """Contact diagnostics for the current qp, without stepping."""
        dp_c = self.contacts.apply(qp)
        zero = P.zero(qp.pos.shape[0], self.num_bodies, qp.pos.device)
        return Info(contact=dp_c, joint=zero, actuator=zero)

    def step(self, qp: QP, act: torch.Tensor) -> Tuple[QP, Info]:
        """One control step of `substeps` substeps; returns (qp', summed Info).

        CUDA tensors run the whole-step kernel, CPU tensors `step_generic`."""
        from pobrax_tpu_torch.physics import whole_step
        return whole_step.whole_step(self, qp, act)

    def step_generic(self, qp: QP, act: torch.Tensor) -> Tuple[QP, Info]:
        """The plain batched implementation of `step`, in PyTorch ops."""
        B, n, dev = qp.pos.shape[0], self.num_bodies, qp.pos.device
        info = Info.zero(B, n, dev)
        for _ in range(self.config.substeps):
            dp_j = P.zero(B, n, dev)
            dp_a = P.zero(B, n, dev)
            for g in self.joints:
                dp_j = dp_j + g.apply(qp)
                dp_a = dp_a + g.apply_actuators(qp, act)
            if self._thrusters is not None:
                body, strength, direction, inv_mass = self._thrusters
                t0 = self._thruster_act0
                a = act[:, t0:t0 + len(self._thruster_body)]
                force = (strength * torch.clamp(a, -1.0, 1.0))[..., None] * direction
                dvel = torch.zeros(B, n, 3, device=dev).index_add(
                    1, body, force * inv_mass[:, None])
                dp_a = dp_a + P(vel=dvel, ang=torch.zeros(B, n, 3, device=dev))
            qp = self.integrator.potential(qp, dp_j + dp_a)
            qp = self.integrator.kinetic(qp)
            dp_c = self.contacts.apply(qp)
            qp = self.integrator.collide(qp, dp_c)
            info = Info(contact=info.contact + dp_c, joint=info.joint + dp_j,
                        actuator=info.actuator + dp_a)
        return qp, info
