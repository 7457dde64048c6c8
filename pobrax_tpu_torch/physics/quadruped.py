"""Fetch quadruped model: a 13-body dog that chases a target ball.

A copy of `pobrax_tpu/physics/quadruped.py`, numpy only. The port keeps its own
copy because importing any `pobrax_tpu` module pulls in jax;
tests/test_torch_stock_envs.py holds the two configs equal.

Behavioral equivalent of the stock brax `fetch` the reference registers
(po-brax po_brax/envs/__init__.py:35): torso + 4 legs x (upper,
lower, foot), 2-dof hips + 1-dof knees + 1-dof ankles (16 action dims),
plus a frozen target sphere teleported by the env.
"""

from __future__ import annotations

from pobrax_tpu_torch.physics import config as c

_STIFF = dict(stiffness=12000.0, angular_damping=25.0, spring_damping=100.0)

BODY_ORDER = ("torso",) + tuple(
    f"{leg}_{part}" for leg in ("fr", "fl", "br", "bl")
    for part in ("upper", "lower", "foot"))

# leg root positions on the torso (x forward)
_LEG_XY = {"fr": (0.25, -0.15), "fl": (0.25, 0.15),
           "br": (-0.25, -0.15), "bl": (-0.25, 0.15)}


def fetch_config() -> c.Config:
    bodies = [c.Body(
        name="torso",
        colliders=(c.Collider(geom=c.Capsule(radius=0.14, length=0.8),
                              rotation=(0.0, 90.0, 0.0)),),
        mass=10.0)]
    joints, actuators, collide = [], [], [("torso", "Ground")]
    for leg, (lx, ly) in _LEG_XY.items():
        upper, lower, foot = f"{leg}_upper", f"{leg}_lower", f"{leg}_foot"
        bodies += [
            c.Body(name=upper,
                   colliders=(c.Collider(geom=c.Capsule(radius=0.05, length=0.25)),),
                   mass=1.0),
            c.Body(name=lower,
                   colliders=(c.Collider(geom=c.Capsule(radius=0.04, length=0.25)),),
                   mass=1.0),
            c.Body(name=foot,
                   colliders=(c.Collider(geom=c.Sphere(radius=0.06)),),
                   mass=0.5),
        ]
        joints += [
            c.Joint(name=f"{leg}_hip", parent="torso", child=upper,
                    parent_offset=(lx, ly, -0.1), child_offset=(0.0, 0.0, 0.125),
                    angle_limits=(c.AngleLimit(-30.0, 30.0),
                                  c.AngleLimit(-45.0, 45.0)),
                    **_STIFF),
            c.Joint(name=f"{leg}_knee", parent=upper, child=lower,
                    parent_offset=(0.0, 0.0, -0.125), child_offset=(0.0, 0.0, 0.125),
                    rotation=(0.0, 0.0, 90.0),
                    angle_limits=(c.AngleLimit(-70.0, 5.0),),
                    **_STIFF),
            c.Joint(name=f"{leg}_ankle", parent=lower, child=foot,
                    parent_offset=(0.0, 0.0, -0.125), child_offset=(0.0, 0.0, 0.05),
                    rotation=(0.0, 0.0, 90.0),
                    angle_limits=(c.AngleLimit(-30.0, 30.0),),
                    **_STIFF),
        ]
        actuators += [
            c.Actuator(name=f"{leg}_hip", joint=f"{leg}_hip", strength=150.0),
            c.Actuator(name=f"{leg}_knee", joint=f"{leg}_knee", strength=150.0),
            c.Actuator(name=f"{leg}_ankle", joint=f"{leg}_ankle", strength=80.0),
        ]
        collide += [(foot, "Ground"), (lower, "Ground")]
    bodies += [
        c.Body(name="Target",
               colliders=(c.Collider(geom=c.Sphere(radius=0.2)),), frozen=True),
        c.Body(name="Ground", colliders=(c.Collider(geom=c.Plane()),), frozen=True),
    ]
    default_angles = tuple(
        c.DefaultAngle(name=f"{leg}_knee", angle=(-10.0, 0.0, 0.0))
        for leg in _LEG_XY)
    return c.Config(
        bodies=tuple(bodies), joints=tuple(joints), actuators=tuple(actuators),
        collide_include=tuple(collide),
        default_qps=(c.DefaultQP(name="torso", pos=(0.0, 0.0, 0.43)),
                     c.DefaultQP(name="Target", pos=(5.0, 0.0, 0.2))),
        default_angles=default_angles,
        friction=1.0, angular_damping=-0.05, dt=0.02, substeps=8,
    )
