"""Humanoid model: 11 dynamic bodies, 10 joints (17 dof), 17 actuators.

A copy of `pobrax_tpu/physics/humanoid.py`, numpy only. The port keeps its own
copy because importing any `pobrax_tpu` module pulls in jax;
tests/test_torch_stock_envs.py holds the two configs equal.

Behavioral equivalent of the stock brax humanoid the reference registers
(po-brax po_brax/envs/__init__.py:39-40), with the classic
mass/limit/gear values. Exercises every joint dof-class this engine supports
(abdomen 2-dof, hips 3-dof, knees/elbows 1-dof, shoulders 2-dof).
"""

from __future__ import annotations

from pobrax_tpu_torch.physics import config as c

_STIFF = dict(stiffness=15000.0, angular_damping=30.0, spring_damping=120.0)


def _zcap(name, radius, length, mass, offset=(0.0, 0.0, 0.0)):
    return c.Body(name=name, mass=mass, colliders=(
        c.Collider(geom=c.Capsule(radius=radius, length=length), position=offset),))


def _joint(name, parent, child, p_off, c_off, limits, rotation=(0.0, 0.0, 0.0)):
    return c.Joint(
        name=name, parent=parent, child=child,
        parent_offset=p_off, child_offset=c_off, rotation=rotation,
        angle_limits=tuple(c.AngleLimit(*l) for l in limits), **_STIFF)


BODY_ORDER = (
    "torso", "lwaist", "pelvis",
    "right_thigh", "right_shin", "left_thigh", "left_shin",
    "right_upper_arm", "right_lower_arm", "left_upper_arm", "left_lower_arm",
)


def humanoid_config() -> c.Config:
    bodies = [
        _zcap("torso", 0.11, 0.30, 8.907),
        _zcap("lwaist", 0.09, 0.12, 2.036),
        _zcap("pelvis", 0.11, 0.10, 6.616),
        _zcap("right_thigh", 0.06, 0.34, 4.752),
        _zcap("right_shin", 0.049, 0.30, 2.756),
        _zcap("left_thigh", 0.06, 0.34, 4.752),
        _zcap("left_shin", 0.049, 0.30, 2.756),
        _zcap("right_upper_arm", 0.04, 0.277, 1.661),
        _zcap("right_lower_arm", 0.031, 0.295, 1.234),
        _zcap("left_upper_arm", 0.04, 0.277, 1.661),
        _zcap("left_lower_arm", 0.031, 0.295, 1.234),
        c.Body(name="Ground", colliders=(c.Collider(geom=c.Plane()),), frozen=True),
    ]
    joints = [
        # spine: 2-dof twist/bend + 1-dof side bend
        _joint("abdomen_zy", "torso", "lwaist",
               (0.0, 0.0, -0.20), (0.0, 0.0, 0.11),
               [(-45.0, 45.0), (-75.0, 30.0)]),
        _joint("abdomen_x", "lwaist", "pelvis",
               (0.0, 0.0, -0.065), (0.0, 0.0, 0.10),
               [(-35.0, 35.0)]),
    ]
    for side, sx in (("right", -1.0), ("left", 1.0)):
        joints += [
            _joint(f"{side}_hip", "pelvis", f"{side}_thigh",
                   (sx * 0.10, 0.0, -0.04), (0.0, 0.0, 0.17),
                   [(-25.0, 5.0), (-60.0, 35.0), (-110.0, 20.0)]),
            _joint(f"{side}_knee", f"{side}_thigh", f"{side}_shin",
                   (0.0, 0.0, -0.17), (0.0, 0.0, 0.15),
                   [(-160.0, -2.0)], rotation=(0.0, 0.0, 90.0)),
            _joint(f"{side}_shoulder", "torso", f"{side}_upper_arm",
                   (sx * 0.17, 0.0, 0.06), (0.0, 0.0, 0.14),
                   [(-85.0, 60.0), (-85.0, 60.0)]),
            _joint(f"{side}_elbow", f"{side}_upper_arm", f"{side}_lower_arm",
                   (0.0, 0.0, -0.14), (0.0, 0.0, 0.15),
                   [(-90.0, 50.0)], rotation=(0.0, 0.0, 90.0)),
        ]
    gears = {"abdomen_zy": 100.0, "abdomen_x": 100.0,
             "right_hip": 300.0, "left_hip": 300.0,
             "right_knee": 200.0, "left_knee": 200.0,
             "right_shoulder": 25.0, "left_shoulder": 25.0,
             "right_elbow": 25.0, "left_elbow": 25.0}
    actuators = tuple(c.Actuator(name=j.name, joint=j.name, strength=gears[j.name])
                      for j in joints)
    collide = tuple((b, "Ground") for b in BODY_ORDER)
    # knees' default angle is the limit midpoint (-81 deg) — override so the
    # humanoid spawns standing with legs nearly straight
    default_angles = (
        c.DefaultAngle(name="right_knee", angle=(-5.0, 0.0, 0.0)),
        c.DefaultAngle(name="left_knee", angle=(-5.0, 0.0, 0.0)),
        c.DefaultAngle(name="right_hip", angle=(0.0, 0.0, -5.0)),
        c.DefaultAngle(name="left_hip", angle=(0.0, 0.0, -5.0)),
        c.DefaultAngle(name="abdomen_zy", angle=(0.0, 0.0, 0.0)),
        c.DefaultAngle(name="abdomen_x", angle=(0.0, 0.0, 0.0)),
        c.DefaultAngle(name="right_shoulder", angle=(0.0, 0.0, 0.0)),
        c.DefaultAngle(name="left_shoulder", angle=(0.0, 0.0, 0.0)),
        c.DefaultAngle(name="right_elbow", angle=(-20.0, 0.0, 0.0)),
        c.DefaultAngle(name="left_elbow", angle=(-20.0, 0.0, 0.0)),
    )
    return c.Config(
        bodies=tuple(bodies), joints=tuple(joints), actuators=actuators,
        collide_include=collide,
        default_qps=(c.DefaultQP(name="torso", pos=(0.0, 0.0, 1.25)),),
        default_angles=default_angles,
        friction=1.0, angular_damping=-0.05, dt=0.015, substeps=8,
    )


def humanoid_standup_config() -> c.Config:
    """Same body, spawned lying on its back."""
    cfg = humanoid_config()
    return cfg.evolve(default_qps=(
        c.DefaultQP(name="torso", pos=(0.0, 0.0, 0.28), rot=(0.0, -90.0, 0.0)),))
