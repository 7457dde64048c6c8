"""Scene configuration as frozen dataclasses (host-side, build-time only).

A copy of `pobrax_tpu/physics/config.py`, numpy only. The port keeps its own
copy because importing any `pobrax_tpu` module pulls in jax;
tests/test_torch_scene.py holds the two to the same compiled tables.

Replaces the reference's protobuf `brax.Config` surface (consumed via
`text_format.Parse` + programmatic mutation, e.g.
po-brax po_brax/envs/ant_tag.py:13-25 and utils.py). Frozen dataclasses
are hashable, so a `System` built from one can be closed over by jitted
functions as a static constant; there is no serialization on any hot path (the
reference's protobuf was likewise build-time only — SURVEY.md §2.10).

Builders return *new* configs (functional update) rather than mutating, which
keeps scene construction referentially transparent; `evolve` helpers make the
"parse ant config then extend it" pattern of the reference one-liners.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Optional, Tuple

Vec3 = Tuple[float, float, float]

ZERO3: Vec3 = (0.0, 0.0, 0.0)


@dataclass(frozen=True)
class Sphere:
    radius: float


@dataclass(frozen=True)
class Capsule:
    radius: float
    length: float  # total length including end caps
    # which capsule end (if any) is the "foot" used for reference ordering only
    end: int = 0


@dataclass(frozen=True)
class Box:
    halfsize: Vec3


@dataclass(frozen=True)
class Plane:
    pass


Geom = object  # Sphere | Capsule | Box | Plane


@dataclass(frozen=True)
class Collider:
    """A collision shape attached to a body, with a local pose.

    `rotation` is Euler degrees, intrinsic x-y'-z'' (the protobuf convention
    the reference's wall builders use, utils.py:26,54-55).
    """

    geom: Geom
    position: Vec3 = ZERO3
    rotation: Vec3 = ZERO3


@dataclass(frozen=True)
class Body:
    name: str
    colliders: Tuple[Collider, ...] = ()
    mass: float = 1.0
    inertia: Vec3 = (1.0, 1.0, 1.0)
    frozen: bool = False  # frozen.all in the reference (ant_tag.py:18)
    # per-axis freezing (1.0 = that component never updates), for planar
    # models (halfcheetah/walker2d: y-translation + x/z-rotation frozen) and
    # sliding carts; `frozen=True` freezes everything regardless
    frozen_position: Vec3 = ZERO3
    frozen_rotation: Vec3 = ZERO3


@dataclass(frozen=True)
class AngleLimit:
    min: float = 0.0  # degrees
    max: float = 0.0


@dataclass(frozen=True)
class Joint:
    """A spring joint connecting parent->child (1-3 rotational dof).

    Matches the legacy-Brax joint contract consumed by the reference
    (SURVEY.md §2.9): spring constraint pulling world-space anchors together,
    axis-alignment torques, angle limits, per-dof actuation.
    """

    name: str
    parent: str
    child: str
    stiffness: float = 5000.0
    parent_offset: Vec3 = ZERO3
    child_offset: Vec3 = ZERO3
    rotation: Vec3 = ZERO3  # Euler degrees: joint frame in parent's frame
    angle_limits: Tuple[AngleLimit, ...] = (AngleLimit(),)  # one per dof
    angular_damping: float = 0.0
    spring_damping: Optional[float] = None  # None -> 2*sqrt(stiffness)
    limit_strength: Optional[float] = None  # None -> stiffness
    reference_rotation: Vec3 = ZERO3  # rest pose of child relative to parent


@dataclass(frozen=True)
class Actuator:
    name: str
    joint: str
    strength: float
    kind: str = "torque"  # "torque" | "angle"


@dataclass(frozen=True)
class Thruster:
    """A linear force actuator on a body along a fixed world-frame direction
    (one action dim, appended after all joint-actuator dims). Used by
    cart-style systems (inverted pendulum family)."""

    name: str
    body: str
    strength: float
    direction: Vec3 = (1.0, 0.0, 0.0)


@dataclass(frozen=True)
class DefaultQP:
    name: str
    pos: Vec3 = ZERO3
    rot: Vec3 = ZERO3  # Euler degrees


@dataclass(frozen=True)
class DefaultAngle:
    name: str  # joint name
    angle: Vec3 = ZERO3  # degrees, per dof


@dataclass(frozen=True)
class Config:
    """A static scene description; the unit the System compiler consumes."""

    bodies: Tuple[Body, ...] = ()
    joints: Tuple[Joint, ...] = ()
    actuators: Tuple[Actuator, ...] = ()
    thrusters: Tuple[Thruster, ...] = ()
    # only these (first, second) body-name pairs collide; empty -> no contacts
    collide_include: Tuple[Tuple[str, str], ...] = ()
    default_qps: Tuple[DefaultQP, ...] = ()
    default_angles: Tuple[DefaultAngle, ...] = ()
    friction: float = 1.0
    elasticity: float = 0.0
    gravity: Vec3 = (0.0, 0.0, -9.8)
    angular_damping: float = 0.0  # global velocity-damping exponent (<= 0)
    velocity_damping: float = 0.0
    baumgarte_erp: float = 0.1
    dt: float = 0.05
    substeps: int = 10

    # ---- functional builders -------------------------------------------------

    def add_body(self, body: Body) -> "Config":
        return replace(self, bodies=self.bodies + (body,))

    def add_joint(self, joint: Joint) -> "Config":
        return replace(self, joints=self.joints + (joint,))

    def add_actuator(self, actuator: Actuator) -> "Config":
        return replace(self, actuators=self.actuators + (actuator,))

    def add_collide_pair(self, first: str, second: str) -> "Config":
        return replace(self, collide_include=self.collide_include + ((first, second),))

    def add_default_qp(self, dqp: DefaultQP) -> "Config":
        return replace(self, default_qps=self.default_qps + (dqp,))

    def add_default_angle(self, da: DefaultAngle) -> "Config":
        return replace(self, default_angles=self.default_angles + (da,))

    def add_colliders_to_body(self, body_name: str, colliders: Tuple[Collider, ...]) -> "Config":
        bodies = tuple(
            replace(b, colliders=b.colliders + colliders) if b.name == body_name else b
            for b in self.bodies
        )
        return replace(self, bodies=bodies)

    def scale_time(self, action_repeat: int) -> "Config":
        """dt *= k, substeps *= k — the reference's ActionRepeatWrapper
        semantics (po-brax po_brax/envs/wrappers.py:22-23)."""
        return replace(self, dt=self.dt * action_repeat, substeps=self.substeps * action_repeat)

    def body_names(self) -> Tuple[str, ...]:
        return tuple(b.name for b in self.bodies)

    def evolve(self, **kwargs) -> "Config":
        return replace(self, **kwargs)


def validate(cfg: Config) -> None:
    """Raise on structurally invalid configs (dangling names, dup bodies)."""
    names = [b.name for b in cfg.bodies]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate body names in config: {names}")
    name_set = set(names)
    for j in cfg.joints:
        if j.parent not in name_set or j.child not in name_set:
            raise ValueError(f"joint {j.name} references unknown body")
        if not 1 <= len(j.angle_limits) <= 3:
            raise ValueError(f"joint {j.name} must have 1-3 dof")
        if any(v != 0.0 for v in j.reference_rotation):
            raise NotImplementedError(
                f"joint {j.name}: reference_rotation is declared for legacy "
                f"schema parity but not implemented by this engine — bake "
                f"the rest pose into `rotation`/`default_angles` instead")
    joint_names = {j.name for j in cfg.joints}
    for a in cfg.actuators:
        if a.joint not in joint_names:
            raise ValueError(f"actuator {a.name} references unknown joint {a.joint}")
    for first, second in cfg.collide_include:
        if first not in name_set or second not in name_set:
            raise ValueError(f"collide_include references unknown body: {(first, second)}")
    for t in cfg.thrusters:
        if t.body not in name_set:
            raise ValueError(f"thruster {t.name} references unknown body {t.body}")
