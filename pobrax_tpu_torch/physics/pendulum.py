"""Cart-pole models: inverted_pendulum, inverted_double_pendulum.

A copy of `pobrax_tpu/physics/pendulum.py`, numpy only. The port keeps its own
copy because importing any `pobrax_tpu` module pulls in jax;
tests/test_torch_stock_envs.py holds the two configs equal.

Behavioral equivalents of the stock brax envs the reference registers
(po-brax po_brax/envs/__init__.py:41-42). The cart is a body free
only in x translation (per-axis freezing), driven by a `Thruster` force
actuator; poles hang off hinge joints about y with limit springs disabled
(limit_strength=0 — free rotation).
"""

from __future__ import annotations

from pobrax_tpu_torch.physics import config as c

_HINGE_Y = (0.0, 0.0, 90.0)  # joint-frame x -> world y

_CART = c.Body(
    name="cart",
    colliders=(c.Collider(geom=c.Capsule(radius=0.1, length=0.4),
                          rotation=(90.0, 0.0, 0.0)),),
    mass=4.0,
    frozen_position=(0.0, 1.0, 1.0),  # slides along x only
    frozen_rotation=(1.0, 1.0, 1.0),
)


def _pole(name: str, length: float = 0.6, mass: float = 1.0) -> c.Body:
    return c.Body(
        name=name,
        colliders=(c.Collider(geom=c.Capsule(radius=0.049, length=length)),),
        mass=mass,
        frozen_position=(0.0, 1.0, 0.0),
        frozen_rotation=(1.0, 0.0, 1.0),  # pitch about y only
    )


def _free_hinge(name, parent, child, p_off, c_off):
    return c.Joint(
        name=name, parent=parent, child=child,
        stiffness=4000.0, spring_damping=126.0, angular_damping=0.0,
        parent_offset=p_off, child_offset=c_off,
        rotation=_HINGE_Y,
        angle_limits=(c.AngleLimit(-360.0, 360.0),),
        limit_strength=0.0,
    )


def inverted_pendulum_config() -> c.Config:
    return c.Config(
        bodies=(_CART, _pole("pole")),
        joints=(_free_hinge("hinge", "cart", "pole",
                            (0.0, 0.0, 0.0), (0.0, 0.0, -0.3)),),
        thrusters=(c.Thruster(name="slide", body="cart", strength=100.0,
                              direction=(1.0, 0.0, 0.0)),),
        default_qps=(c.DefaultQP(name="cart", pos=(0.0, 0.0, 0.6)),),
        gravity=(0.0, 0.0, -9.8),
        dt=0.04, substeps=12,
    )


def inverted_double_pendulum_config() -> c.Config:
    return c.Config(
        bodies=(_CART, _pole("pole"), _pole("pole2")),
        joints=(
            _free_hinge("hinge", "cart", "pole",
                        (0.0, 0.0, 0.0), (0.0, 0.0, -0.3)),
            _free_hinge("hinge2", "pole", "pole2",
                        (0.0, 0.0, 0.3), (0.0, 0.0, -0.3)),
        ),
        thrusters=(c.Thruster(name="slide", body="cart", strength=200.0,
                              direction=(1.0, 0.0, 0.0)),),
        default_qps=(c.DefaultQP(name="cart", pos=(0.0, 0.0, 0.6)),),
        gravity=(0.0, 0.0, -9.8),
        dt=0.04, substeps=12,
    )
