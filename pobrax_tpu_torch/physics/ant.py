"""The ant model as a frozen-dataclass scene config.

A copy of `pobrax_tpu/physics/ant.py`, numpy only. The port keeps its own
copy because importing any `pobrax_tpu` module pulls in jax;
tests/test_torch_scene.py holds the two to the same compiled tables.

Equivalent of the `brax.envs.ant._SYSTEM_CONFIG` text-proto the reference
parses and extends (po-brax po_brax/envs/ant_tag.py:13): 9 ant bodies
("$ Torso", 4x "Aux i", 4x "$ Body k") + frozen "Ground" plane, 8 hinge
joints (4 hips about z, 4 knees about the in-plane leg perpendicular, limits
mirrored per leg quadrant), 8 torque actuators, torso+lower-leg ground
contacts, dt=0.05 / substeps=10.

Geometry: legs extend diagonally in the xy plane; aux capsule length
2*0.08 + 0.2*sqrt(2), lower-leg capsule length 2*0.08 + 0.4*sqrt(2) — the
hallmark dimensions of the era this engine reproduces. Default knee angle is
the limit midpoint (+-50 deg), bending every leg downward, with the torso
spawning at z=0.55 so the feet rest on the ground.
"""

from __future__ import annotations

import math

from pobrax_tpu_torch.physics import config as c

_SQRT2 = math.sqrt(2.0)
AUX_LEN = 2 * 0.08 + 0.2 * _SQRT2  # 0.44284...
LEG_LEN = 2 * 0.08 + 0.4 * _SQRT2  # 0.72568...
TORSO_Z = 0.55

# per-leg quadrant data: (sx, sy, collider_rot_y, knee_axis_euler_z, knee_lim)
_LEGS = (
    (1.0, 1.0, -45.0, 135.0, (30.0, 70.0)),    # front left  (+x, +y)
    (-1.0, 1.0, 45.0, 45.0, (-70.0, -30.0)),   # front right (-x, +y)
    (-1.0, -1.0, -45.0, 135.0, (-70.0, -30.0)),  # back right (-x, -y)
    (1.0, -1.0, 45.0, 45.0, (30.0, 70.0)),     # back left   (+x, -y)
)

ANT_BODY_NAMES = (
    "$ Torso",
    "Aux 1", "$ Body 4",
    "Aux 2", "$ Body 7",
    "Aux 3", "$ Body 10",
    "Aux 4", "$ Body 13",
)


def ant_config(
    *,
    friction: float = 1.0,
    torque_strength: float = 300.0,
    joint_stiffness: float = 5000.0,
    joint_angular_damping: float = 35.0,
    joint_spring_damping: float = 50.0,
) -> c.Config:
    bodies = [
        c.Body(
            name="$ Torso",
            colliders=(c.Collider(geom=c.Capsule(radius=0.25, length=0.5, end=1)),),
            mass=10.0,
        )
    ]
    joints = []
    actuators = []
    leg_body_ids = (4, 7, 10, 13)
    for k, (sx, sy, col_rot_y, knee_axis_z, knee_lim) in enumerate(_LEGS):
        aux = f"Aux {k + 1}"
        leg = f"$ Body {leg_body_ids[k]}"
        bodies.append(
            c.Body(
                name=aux,
                colliders=(c.Collider(geom=c.Capsule(radius=0.08, length=AUX_LEN),
                                      rotation=(90.0, col_rot_y, 0.0)),),
                mass=1.0,
            )
        )
        bodies.append(
            c.Body(
                name=leg,
                colliders=(c.Collider(geom=c.Capsule(radius=0.08, length=LEG_LEN, end=-1),
                                      rotation=(90.0, col_rot_y, 0.0)),),
                mass=1.0,
            )
        )
        hip = c.Joint(
            name=f"$ Torso_{aux}",
            parent="$ Torso",
            child=aux,
            stiffness=joint_stiffness,
            angular_damping=joint_angular_damping,
            spring_damping=joint_spring_damping,
            parent_offset=(0.2 * sx, 0.2 * sy, 0.0),
            child_offset=(-0.1 * sx, -0.1 * sy, 0.0),
            rotation=(0.0, -90.0, 0.0),  # hinge about world z at rest
            angle_limits=(c.AngleLimit(-30.0, 30.0),),
        )
        knee = c.Joint(
            name=f"{aux}_{leg}",
            parent=aux,
            child=leg,
            stiffness=joint_stiffness,
            angular_damping=joint_angular_damping,
            spring_damping=joint_spring_damping,
            parent_offset=(0.1 * sx, 0.1 * sy, 0.0),
            child_offset=(-0.2 * sx, -0.2 * sy, 0.0),
            rotation=(0.0, 0.0, knee_axis_z),  # hinge ⊥ leg, in plane
            angle_limits=(c.AngleLimit(*knee_lim),),
        )
        joints += [hip, knee]
        actuators += [
            c.Actuator(name=hip.name, joint=hip.name, strength=torque_strength),
            c.Actuator(name=knee.name, joint=knee.name, strength=torque_strength),
        ]
    bodies.append(c.Body(name="Ground", colliders=(c.Collider(geom=c.Plane()),), frozen=True))

    collide = (("$ Torso", "Ground"),) + tuple(
        (f"$ Body {i}", "Ground") for i in leg_body_ids
    )
    return c.Config(
        bodies=tuple(bodies),
        joints=tuple(joints),
        actuators=tuple(actuators),
        collide_include=collide,
        default_qps=(c.DefaultQP(name="$ Torso", pos=(0.0, 0.0, TORSO_Z)),),
        friction=friction,
        elasticity=0.0,
        gravity=(0.0, 0.0, -9.8),
        angular_damping=-0.05,
        baumgarte_erp=0.1,
        dt=0.05,
        substeps=10,
    )
