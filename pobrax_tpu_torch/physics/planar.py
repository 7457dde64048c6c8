"""Planar locomotion models: halfcheetah, hopper, walker2d.

A copy of `pobrax_tpu/physics/planar.py`, numpy only. The port keeps its own
copy because importing any `pobrax_tpu` module pulls in jax;
tests/test_torch_planar.py holds the three configs equal.

Behavioral equivalents of the stock brax envs the reference registers
(po-brax po_brax/envs/__init__.py:37-38,46) built for this engine:
2-D models realized by per-axis freezing (y-translation and x/z-rotation
frozen on every dynamic body), all hinges about the world y axis
(joint rotation (0,0,90): the joint-frame x axis maps onto +y).

Masses/limits/gears follow the classic mujoco-era values; geometry is
simplified to top-anchored capsule chains. Observation layouts match the
reference's mask tables exactly (standard_observability_masks.py):
halfcheetah 23 = pos[0,11) + vel[11,23); hopper 14 = pos[0,8) + vel[8,14);
walker2d 20 = pos[0,11) + vel[11,20).
"""

from __future__ import annotations

from pobrax_tpu_torch.physics import config as c

_PLANAR_POS = (0.0, 1.0, 0.0)  # freeze y translation
_PLANAR_ROT = (1.0, 0.0, 1.0)  # freeze x/z rotation (free pitch about y)
_HINGE_Y = (0.0, 0.0, 90.0)  # joint-frame x -> world y


def _planar_body(name, colliders, mass):
    return c.Body(name=name, colliders=colliders, mass=mass,
                  frozen_position=_PLANAR_POS, frozen_rotation=_PLANAR_ROT)


def _zcap(radius, length, offset=(0.0, 0.0, 0.0)):
    """A capsule along the body-frame z axis (limbs hang downward)."""
    return (c.Collider(geom=c.Capsule(radius=radius, length=length),
                       position=offset, rotation=(0.0, 0.0, 0.0)),)


def _xcap(radius, length, offset=(0.0, 0.0, 0.0)):
    """A capsule along the body-frame x axis (torsos, feet)."""
    return (c.Collider(geom=c.Capsule(radius=radius, length=length),
                       position=offset, rotation=(0.0, 90.0, 0.0)),)


def _hinge(name, parent, child, p_off, c_off, lim, *, stiffness=15000.0,
           angular_damping=20.0, spring_damping=80.0):
    return c.Joint(
        name=name, parent=parent, child=child,
        stiffness=stiffness, angular_damping=angular_damping,
        spring_damping=spring_damping,
        parent_offset=p_off, child_offset=c_off,
        rotation=_HINGE_Y, angle_limits=(c.AngleLimit(*lim),),
    )


def halfcheetah_config() -> c.Config:
    """7-link planar cheetah; 6 torque actuators (gears 120/90/60/120/60/30)."""
    r = 0.046
    bodies = [
        _planar_body("torso", _xcap(r, 1.0 + 2 * r), 9.457),
        _planar_body("bthigh", _zcap(r, 0.29), 2.335),
        _planar_body("bshin", _zcap(r, 0.30), 2.402),
        _planar_body("bfoot", _zcap(r, 0.188), 3.466),
        _planar_body("fthigh", _zcap(r, 0.266), 2.176),
        _planar_body("fshin", _zcap(r, 0.212), 1.817),
        _planar_body("ffoot", _zcap(r, 0.14), 1.6),
        c.Body(name="Ground", colliders=(c.Collider(geom=c.Plane()),), frozen=True),
    ]
    joints = [
        _hinge("bthigh_joint", "torso", "bthigh", (-0.5, 0.0, 0.0), (0.0, 0.0, 0.145), (-30.0, 60.0)),
        _hinge("bshin_joint", "bthigh", "bshin", (0.0, 0.0, -0.145), (0.0, 0.0, 0.15), (-45.0, 45.0)),
        _hinge("bfoot_joint", "bshin", "bfoot", (0.0, 0.0, -0.15), (0.0, 0.0, 0.094), (-23.0, 50.0)),
        _hinge("fthigh_joint", "torso", "fthigh", (0.5, 0.0, 0.0), (0.0, 0.0, 0.133), (-57.0, 40.0)),
        _hinge("fshin_joint", "fthigh", "fshin", (0.0, 0.0, -0.133), (0.0, 0.0, 0.106), (-69.0, 50.0)),
        _hinge("ffoot_joint", "fshin", "ffoot", (0.0, 0.0, -0.106), (0.0, 0.0, 0.07), (-28.0, 28.0)),
    ]
    gears = {"bthigh_joint": 120.0, "bshin_joint": 90.0, "bfoot_joint": 60.0,
             "fthigh_joint": 120.0, "fshin_joint": 60.0, "ffoot_joint": 30.0}
    actuators = tuple(c.Actuator(name=j.name, joint=j.name, strength=gears[j.name])
                      for j in joints)
    collide = tuple((b, "Ground") for b in
                    ("torso", "bthigh", "bshin", "bfoot", "fthigh", "fshin", "ffoot"))
    return c.Config(
        bodies=tuple(bodies), joints=tuple(joints), actuators=actuators,
        collide_include=collide,
        default_qps=(c.DefaultQP(name="torso", pos=(0.0, 0.0, 0.8)),),
        friction=0.77, angular_damping=-0.05, dt=0.05, substeps=16,
    )


def hopper_config() -> c.Config:
    """4-link planar hopper; 3 torque actuators (gear 200)."""
    bodies = [
        _planar_body("torso", _zcap(0.05, 0.4), 3.534),
        _planar_body("thigh", _zcap(0.05, 0.45), 3.927),
        _planar_body("leg", _zcap(0.04, 0.5), 2.714),
        _planar_body("foot", _xcap(0.06, 0.39, (0.065, 0.0, 0.0)), 5.089),
        c.Body(name="Ground", colliders=(c.Collider(geom=c.Plane()),), frozen=True),
    ]
    joints = [
        _hinge("thigh_joint", "torso", "thigh", (0.0, 0.0, -0.2), (0.0, 0.0, 0.225), (-150.0, 0.0)),
        _hinge("leg_joint", "thigh", "leg", (0.0, 0.0, -0.225), (0.0, 0.0, 0.25), (-150.0, 0.0)),
        _hinge("foot_joint", "leg", "foot", (0.0, 0.0, -0.25), (-0.065, 0.0, 0.0), (-45.0, 45.0)),
    ]
    actuators = tuple(c.Actuator(name=j.name, joint=j.name, strength=200.0)
                      for j in joints)
    return c.Config(
        bodies=tuple(bodies), joints=tuple(joints), actuators=actuators,
        collide_include=(("torso", "Ground"), ("foot", "Ground"), ("leg", "Ground")),
        default_qps=(c.DefaultQP(name="torso", pos=(0.0, 0.0, 1.25)),),
        default_angles=(c.DefaultAngle(name="thigh_joint", angle=(-5.0, 0.0, 0.0)),
                        c.DefaultAngle(name="leg_joint", angle=(-5.0, 0.0, 0.0)),
                        c.DefaultAngle(name="foot_joint", angle=(0.0, 0.0, 0.0))),
        friction=1.0, angular_damping=-0.05, dt=0.02, substeps=8,
    )


def walker2d_config() -> c.Config:
    """7-link planar biped; 6 torque actuators (gear 100)."""
    bodies = [_planar_body("torso", _zcap(0.05, 0.4), 3.534)]
    joints, actuators, collide = [], [], [("torso", "Ground")]
    for side in ("", "_left"):
        thigh, leg, foot = f"thigh{side}", f"leg{side}", f"foot{side}"
        bodies += [
            _planar_body(thigh, _zcap(0.05, 0.45), 3.927),
            _planar_body(leg, _zcap(0.04, 0.5), 2.714),
            _planar_body(foot, _xcap(0.05, 0.2, (0.06, 0.0, 0.0)), 2.941),
        ]
        joints += [
            _hinge(f"{thigh}_joint", "torso", thigh, (0.0, 0.0, -0.2), (0.0, 0.0, 0.225), (-150.0, 0.0)),
            _hinge(f"{leg}_joint", thigh, leg, (0.0, 0.0, -0.225), (0.0, 0.0, 0.25), (-150.0, 0.0)),
            _hinge(f"{foot}_joint", leg, foot, (0.0, 0.0, -0.25), (-0.06, 0.0, 0.0), (-45.0, 45.0)),
        ]
        collide += [(foot, "Ground"), (leg, "Ground")]
    actuators = tuple(c.Actuator(name=j.name, joint=j.name, strength=100.0)
                      for j in joints)
    bodies.append(c.Body(name="Ground", colliders=(c.Collider(geom=c.Plane()),), frozen=True))
    default_angles = tuple(
        c.DefaultAngle(name=j.name, angle=(-5.0, 0.0, 0.0))
        for j in joints if "foot" not in j.name)
    return c.Config(
        bodies=tuple(bodies), joints=tuple(joints), actuators=actuators,
        collide_include=tuple(collide),
        default_qps=(c.DefaultQP(name="torso", pos=(0.0, 0.0, 1.25)),),
        default_angles=default_angles,
        friction=1.0, angular_damping=-0.05, dt=0.02, substeps=8,
    )
