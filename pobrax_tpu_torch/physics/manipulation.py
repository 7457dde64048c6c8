"""Manipulation models: ur5e arm and the grasp claw.

A copy of `pobrax_tpu/physics/manipulation.py`, numpy only. The port keeps its own
copy because importing any `pobrax_tpu` module pulls in jax;
tests/test_torch_stock_envs.py holds the two configs equal.

Behavioral equivalents of the stock brax envs the reference registers
(po-brax po_brax/envs/__init__.py:36,45): a 6-joint position-servo
arm reaching a floating target, and a flying 4-finger claw that lifts a ball
to a floating target. Both use "angle" (position-servo) actuators; the claw
palm translates via Thruster forces.
"""

from __future__ import annotations

import math

from pobrax_tpu_torch.physics import config as c

_ARM_STIFF = dict(stiffness=8000.0, angular_damping=40.0, spring_damping=100.0)
_HINGE_Z = (0.0, -90.0, 0.0)  # joint-frame x -> world z
_HINGE_Y = (0.0, 0.0, 90.0)  # joint-frame x -> world y

UR5E_LINKS = ("shoulder", "upper_arm", "forearm", "wrist_1", "wrist_2", "wrist_3")


def _link(name, radius, length, mass):
    return c.Body(name=name, mass=mass, colliders=(
        c.Collider(geom=c.Capsule(radius=radius, length=length)),))


def ur5e_config() -> c.Config:
    """Six-dof arm on a frozen pedestal; 6 angle actuators."""
    bodies = (
        c.Body(name="pedestal",
               colliders=(c.Collider(geom=c.Box(halfsize=(0.1, 0.1, 0.2))),),
               frozen=True),
        _link("shoulder", 0.06, 0.12, 3.7),
        _link("upper_arm", 0.05, 0.425, 8.393),
        _link("forearm", 0.04, 0.392, 2.275),
        _link("wrist_1", 0.035, 0.09, 1.219),
        _link("wrist_2", 0.035, 0.09, 1.219),
        _link("wrist_3", 0.03, 0.06, 0.1879),
        c.Body(name="Target",
               colliders=(c.Collider(geom=c.Sphere(radius=0.05)),), frozen=True),
    )
    free = (c.AngleLimit(-180.0, 180.0),)
    joints = (
        c.Joint(name="shoulder_pan", parent="pedestal", child="shoulder",
                parent_offset=(0.0, 0.0, 0.2), child_offset=(0.0, 0.0, -0.06),
                rotation=_HINGE_Z, angle_limits=free, limit_strength=0.0,
                **_ARM_STIFF),
        c.Joint(name="shoulder_lift", parent="shoulder", child="upper_arm",
                parent_offset=(0.0, 0.0, 0.06), child_offset=(0.0, 0.0, -0.2125),
                rotation=_HINGE_Y, angle_limits=free, limit_strength=0.0,
                **_ARM_STIFF),
        c.Joint(name="elbow", parent="upper_arm", child="forearm",
                parent_offset=(0.0, 0.0, 0.2125), child_offset=(0.0, 0.0, -0.196),
                rotation=_HINGE_Y, angle_limits=free, limit_strength=0.0,
                **_ARM_STIFF),
        c.Joint(name="wrist_1_joint", parent="forearm", child="wrist_1",
                parent_offset=(0.0, 0.0, 0.196), child_offset=(0.0, 0.0, -0.045),
                rotation=_HINGE_Y, angle_limits=free, limit_strength=0.0,
                **_ARM_STIFF),
        c.Joint(name="wrist_2_joint", parent="wrist_1", child="wrist_2",
                parent_offset=(0.0, 0.0, 0.045), child_offset=(0.0, 0.0, -0.045),
                rotation=_HINGE_Z, angle_limits=free, limit_strength=0.0,
                **_ARM_STIFF),
        c.Joint(name="wrist_3_joint", parent="wrist_2", child="wrist_3",
                parent_offset=(0.0, 0.0, 0.045), child_offset=(0.0, 0.0, -0.03),
                rotation=_HINGE_Y, angle_limits=free, limit_strength=0.0,
                **_ARM_STIFF),
    )
    actuators = tuple(
        c.Actuator(name=j.name, joint=j.name, strength=100.0, kind="angle")
        for j in joints)
    return c.Config(
        bodies=bodies, joints=joints, actuators=actuators,
        default_qps=(c.DefaultQP(name="pedestal", pos=(0.0, 0.0, 0.2)),
                     c.DefaultQP(name="Target", pos=(0.4, 0.4, 0.5))),
        gravity=(0.0, 0.0, -9.8),
        dt=0.02, substeps=8,
    )


GRASP_FINGERS = ("f0", "f1", "f2", "f3")
GRASP_BODY_ORDER = ("palm",) + tuple(
    f"{f}_{part}" for f in GRASP_FINGERS for part in ("prox", "mid", "dist")
) + ("Object", "Target")


def grasp_config() -> c.Config:
    """Flying 4-finger claw: palm driven by xyz thrusters (rotation frozen),
    12 finger hinges with angle servos, a ball to lift, a floating target."""
    bodies = [c.Body(
        name="palm",
        colliders=(c.Collider(geom=c.Capsule(radius=0.12, length=0.24)),),
        mass=2.0,
        frozen_rotation=(1.0, 1.0, 1.0),
    )]
    joints, actuators, collide = [], [], []
    for k, f in enumerate(GRASP_FINGERS):
        ang = k * math.pi / 2.0
        rx, ry = math.cos(ang), math.sin(ang)
        # radial hinge axis: perpendicular to the finger's radial direction
        axis_rot = (0.0, 0.0, 90.0 + math.degrees(ang))
        prox, mid, dist = f"{f}_prox", f"{f}_mid", f"{f}_dist"
        for name, ln in ((prox, 0.15), (mid, 0.12), (dist, 0.10)):
            bodies.append(c.Body(
                name=name,
                colliders=(c.Collider(geom=c.Capsule(radius=0.02, length=ln)),),
                mass=0.5))
        joints += [
            c.Joint(name=f"{f}_knuckle", parent="palm", child=prox,
                    parent_offset=(0.12 * rx, 0.12 * ry, -0.08),
                    child_offset=(0.0, 0.0, 0.075),
                    rotation=axis_rot,
                    angle_limits=(c.AngleLimit(-40.0, 40.0),),
                    stiffness=4000.0, angular_damping=10.0, spring_damping=80.0),
            c.Joint(name=f"{f}_mid_joint", parent=prox, child=mid,
                    parent_offset=(0.0, 0.0, -0.075), child_offset=(0.0, 0.0, 0.06),
                    rotation=axis_rot,
                    angle_limits=(c.AngleLimit(-60.0, 10.0),),
                    stiffness=4000.0, angular_damping=10.0, spring_damping=80.0),
            c.Joint(name=f"{f}_dist_joint", parent=mid, child=dist,
                    parent_offset=(0.0, 0.0, -0.06), child_offset=(0.0, 0.0, 0.05),
                    rotation=axis_rot,
                    angle_limits=(c.AngleLimit(-60.0, 10.0),),
                    stiffness=4000.0, angular_damping=10.0, spring_damping=80.0),
        ]
        actuators += [
            c.Actuator(name=f"{f}_knuckle", joint=f"{f}_knuckle", strength=30.0, kind="angle"),
            c.Actuator(name=f"{f}_mid_joint", joint=f"{f}_mid_joint", strength=30.0, kind="angle"),
            c.Actuator(name=f"{f}_dist_joint", joint=f"{f}_dist_joint", strength=30.0, kind="angle"),
        ]
        collide += [(mid, "Object"), (dist, "Object")]
    bodies += [
        c.Body(name="Object",
               colliders=(c.Collider(geom=c.Sphere(radius=0.12)),), mass=1.0),
        c.Body(name="Target",
               colliders=(c.Collider(geom=c.Sphere(radius=0.1)),), frozen=True),
        c.Body(name="Ground", colliders=(c.Collider(geom=c.Plane()),), frozen=True),
    ]
    collide += [("Object", "Ground"), ("palm", "Object"), ("palm", "Ground")]
    thrusters = tuple(
        c.Thruster(name=f"palm_{ax}", body="palm", strength=60.0, direction=d)
        for ax, d in (("x", (1.0, 0.0, 0.0)), ("y", (0.0, 1.0, 0.0)),
                      ("z", (0.0, 0.0, 1.0))))
    return c.Config(
        bodies=tuple(bodies), joints=tuple(joints), actuators=tuple(actuators),
        thrusters=thrusters,
        collide_include=tuple(collide),
        default_qps=(c.DefaultQP(name="palm", pos=(0.0, 0.0, 0.6)),
                     c.DefaultQP(name="Object", pos=(0.0, 0.0, 0.12)),
                     c.DefaultQP(name="Target", pos=(0.5, 0.5, 0.8))),
        friction=1.0, angular_damping=-0.05,
        dt=0.02, substeps=16,
    )
