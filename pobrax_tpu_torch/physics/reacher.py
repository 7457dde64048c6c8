"""2-link planar reacher arm model (reacher / reacherangle).

A copy of `pobrax_tpu/physics/reacher.py`, numpy only. The port keeps its own
copy because importing any `pobrax_tpu` module pulls in jax;
tests/test_torch_stock_envs.py holds the two configs equal.

Behavioral equivalent of the stock brax reacher the reference registers
(po-brax po_brax/envs/__init__.py:43-44): two links hinged about z
on a tabletop (z translation and in-plane tilting frozen; gravity off), a
frozen target sphere teleported at reset. `reacherangle` uses the same
system with "angle" (position-servo) actuators instead of torques.
"""

from __future__ import annotations

from pobrax_tpu_torch.physics import config as c

_HINGE_Z = (0.0, -90.0, 0.0)  # joint-frame x -> world z
_LINK_LEN = 0.12  # capsule length; hinge anchors 0.1 apart
_HALF = 0.05


def _link(name: str) -> c.Body:
    return c.Body(
        name=name,
        colliders=(c.Collider(geom=c.Capsule(radius=0.016, length=_LINK_LEN),
                              rotation=(0.0, 90.0, 0.0)),),
        mass=0.036,
        # unit inertia, like every legacy-era body (see bodies.py docstring):
        # keeps the alignment-torque stiffness integrable at this dt
        inertia=(1.0, 1.0, 1.0),
        frozen_position=(0.0, 0.0, 1.0),
        frozen_rotation=(1.0, 1.0, 0.0),  # rotate about z only
    )


def reacher_config(actuator_kind: str = "torque") -> c.Config:
    bodies = (
        c.Body(name="base", frozen=True),
        _link("body0"),
        _link("body1"),
        c.Body(name="target",
               colliders=(c.Collider(geom=c.Sphere(radius=0.009)),),
               frozen=True),
    )
    joints = (
        c.Joint(name="joint0", parent="base", child="body0",
                stiffness=100.0, spring_damping=3.0, angular_damping=0.8,
                parent_offset=(0.0, 0.0, 0.0), child_offset=(-_HALF, 0.0, 0.0),
                rotation=_HINGE_Z,
                angle_limits=(c.AngleLimit(-360.0, 360.0),),
                limit_strength=0.0),
        c.Joint(name="joint1", parent="body0", child="body1",
                stiffness=100.0, spring_damping=3.0, angular_damping=0.8,
                parent_offset=(_HALF, 0.0, 0.0), child_offset=(-_HALF, 0.0, 0.0),
                rotation=_HINGE_Z,
                angle_limits=(c.AngleLimit(-170.0, 170.0),),
                limit_strength=20.0),
    )
    actuators = tuple(
        c.Actuator(name=j.name, joint=j.name, strength=25.0, kind=actuator_kind)
        for j in joints)
    return c.Config(
        bodies=bodies, joints=joints, actuators=actuators,
        default_qps=(c.DefaultQP(name="target", pos=(0.1, 0.1, 0.01)),
                     c.DefaultQP(name="base", pos=(0.0, 0.0, 0.01)),
                     c.DefaultQP(name="body0", pos=(_HALF, 0.0, 0.01)),
                     c.DefaultQP(name="body1", pos=(3 * _HALF, 0.0, 0.01))),
        gravity=(0.0, 0.0, 0.0),
        dt=0.02, substeps=4,
    )
