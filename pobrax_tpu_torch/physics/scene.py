"""Procedural scene construction: arenas, T-mazes, walls.

A copy of `pobrax_tpu/physics/scene.py`, numpy only. The port keeps its own
copy because importing any `pobrax_tpu` module pulls in jax;
tests/test_torch_scene.py holds the two to the same compiled tables.

Functional re-expression of the reference's protobuf mutators
(po-brax po_brax/envs/utils.py): builders take a Config and return a
new Config with a frozen wall body added. Wall placement math matches the
reference exactly — midpoint positioning, z-rotation from
arccos(dot(x_hat, v)/|v|) in degrees (utils.py:18-28), arena corner expansion
by the half-width (utils.py:75-83), and the 8-segment T outline
(utils.py:108-119).

All of this is host-side numpy at build time; nothing here touches a device.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np

from pobrax_tpu_torch.physics import config as c


def box_wall(from_xy: Sequence[float], to_xy: Sequence[float],
             half_height: float = 0.5, wall_width: float = 0.25) -> c.Collider:
    """A box collider spanning from_xy -> to_xy (utils.py:6-28 semantics)."""
    from_xy = np.asarray(from_xy, np.float64)
    to_xy = np.asarray(to_xy, np.float64)
    vector = to_xy - from_xy
    length = float(np.linalg.norm(vector))
    midpoint = (from_xy + to_xy) / 2.0
    # arccos of dot with x-hat, in degrees (always in [0, 180] — reference quirk)
    z_rotation = math.degrees(math.acos(float(np.clip(vector[0] / length, -1.0, 1.0))))
    return c.Collider(
        geom=c.Box(halfsize=(length / 2.0, wall_width, half_height)),
        position=(float(midpoint[0]), float(midpoint[1]), 0.0),
        rotation=(0.0, 0.0, z_rotation),
    )


def capsule_wall(from_xy: Sequence[float], to_xy: Sequence[float],
                 radius: float = 0.5, include_radius: bool = False) -> c.Collider:
    """An axis-aligned capsule wall collider (utils.py:31-57 semantics)."""
    from_xy = np.asarray(from_xy, np.float64)
    to_xy = np.asarray(to_xy, np.float64)
    if not (from_xy[0] == to_xy[0] or from_xy[1] == to_xy[1]):
        raise ValueError("capsule walls must be axis-aligned (utils.py:50)")
    length = float(np.linalg.norm(from_xy - to_xy)) - (include_radius * radius)
    mid = (from_xy + to_xy) / 2.0
    vertical = from_xy[0] == to_xy[0]
    rotation = (90.0, 0.0, 0.0) if vertical else (0.0, 90.0, 0.0)
    return c.Collider(
        geom=c.Capsule(radius=radius, length=length),
        position=(float(mid[0]), float(mid[1]), 0.0),
        rotation=rotation,
    )


def _wall_body(cfg: c.Config, name: str, corners: np.ndarray, half: float,
               r: float, use_boxes: bool) -> c.Config:
    """Add a frozen body named `name` whose colliders trace `corners` in a
    loop; `r` is the wall half-thickness (box) or radius (capsule)."""
    colliders: Tuple[c.Collider, ...] = ()
    n = corners.shape[0]
    for i in range(n):
        a, b = corners[i], corners[(i + 1) % n]
        if use_boxes:
            colliders += (box_wall(a, b, half_height=half, wall_width=r),)
        else:
            colliders += (capsule_wall(a, b, radius=r, include_radius=True),)
    body = c.Body(name=name, colliders=colliders, mass=1.0, frozen=True)
    cfg = cfg.add_body(body)
    # default height so the walls just touch the ground (utils.py:78-79)
    return cfg.add_default_qp(c.DefaultQP(name=name, pos=(0.0, 0.0, half)))


def draw_arena(cfg: c.Config, cage_x: float, cage_y: float, half: float = 0.5,
               arena_name: str = "Arena", use_boxes: bool = True) -> c.Config:
    """4-wall rectangular arena enclosing [-cage_x, cage_x] x [-cage_y, cage_y]
    (utils.py:60-83; the reference halves the box thickness here, :74)."""
    r = half / 2.0 if use_boxes else half
    x, y = cage_x, cage_y
    corners = np.array(
        [[x + r, y + r], [x + r, -y - r], [-x - r, -y - r], [-x - r, y + r]], np.float64
    )
    return _wall_body(cfg, arena_name, corners, half, r, use_boxes)


def draw_t_maze(cfg: c.Config, t_x: float, t_y: float, hallway_width: float = 2.0,
                half: float = 0.5, arena_name: str = "Arena",
                use_boxes: bool = True) -> c.Config:
    """8-segment T-maze outline (utils.py:87-119): stem along +y from the
    origin, crossbar at the top spanning [-t_x, t_x]. Unlike draw_arena, the
    reference does NOT halve the box thickness here (utils.py:102) — walls
    are `half` thick either way."""
    r = half
    h = hallway_width
    corners = np.array(
        [
            [-t_x - r, t_y + r],
            [t_x + r, t_y + r],
            [t_x + r, t_y - h - r],
            [h + r, t_y - h - r],
            [h + r, -r],
            [-h - r, -r],
            [-h - r, t_y - h - r],
            [-t_x - r, t_y - h - r],
        ],
        np.float64,
    )
    return _wall_body(cfg, arena_name, corners, half, r, use_boxes)
