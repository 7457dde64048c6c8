"""Maze grids + 2-D geometry helpers (host-side, build-time numpy).

A copy of `pobrax_tpu/envs/maze_utils.py`: that module is numpy only, but
importing any `pobrax_tpu` module pulls in jax, so the port keeps its own;
tests/test_torch_po_envs.py holds the two to the same grids and segments.

Behavioral equivalent of the reference's maze toolkit
(po-brax po_brax/envs/maze_utils.py): `line_intersect`,
`ray_segment_intersect`, `point_distance`, and `construct_maze` producing the
same 11 grid layouts (ids 0-10) of `1` walls / `0` floor / `'r'` start /
`'g'` goal cells. The reference never actually consumes these (its AntMaze is
broken — SURVEY.md §2.8); here they additionally feed a *working* AntMaze via
`maze_to_wall_segments`, which converts a grid into merged wall segments for
the scene builders.

Geometry is vectorized numpy over arrays of segments (the reference loops in
scalar Python math); everything stays host-side — mazes are compiled into the
scene Config once at env construction.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

_DET_TOLERANCE = 1e-8


def line_intersect(pt1, pt2, ptA, ptB) -> Tuple[float, float, int, float, float]:
    """Intersect Line(pt1,pt2) with Line(ptA,ptB).

    Returns (xi, yi, valid, r, s): the intersection point, a validity flag
    (0 when parallel/degenerate), and the scalar parameters along each line
    (reference maze_utils.py:5-67 contract).
    """
    x1, y1 = pt1
    d1 = (pt2[0] - x1, pt2[1] - y1)
    xA, yA = ptA
    d2 = (ptB[0] - xA, ptB[1] - yA)
    det = -d1[0] * d2[1] + d1[1] * d2[0]
    if abs(det) < _DET_TOLERANCE:
        return (0.0, 0.0, 0, 0.0, 0.0)
    r = (-d2[1] * (xA - x1) + d2[0] * (yA - y1)) / det
    s = (-d1[1] * (xA - x1) + d1[0] * (yA - y1)) / det
    return (x1 + r * d1[0], y1 + r * d1[1], 1, r, s)


def ray_segment_intersect(ray, segment) -> Optional[Tuple[float, float]]:
    """Intersection of a ray ((x, y), theta) with a 2-point segment, or None
    (reference maze_utils.py:70-83)."""
    (x, y), theta = ray
    pt2 = (x + math.cos(theta), y + math.sin(theta))
    xo, yo, valid, r, s = line_intersect((x, y), pt2, *segment)
    if valid and r >= 0 and 0 <= s <= 1:
        return (xo, yo)
    return None


def ray_segments_intersect(ray, segments: np.ndarray) -> np.ndarray:
    """Vectorized ray-vs-N-segments: returns (N,) distances, inf where missed.

    `segments` is (N, 2, 2). This is the batch form the working AntMaze's
    range sensor uses (no scalar Python in the build loop).
    """
    (x, y), theta = ray
    p = segments[:, 0, :]
    d2 = segments[:, 1, :] - p
    d1 = np.array([math.cos(theta), math.sin(theta)])
    det = -d1[0] * d2[:, 1] + d1[1] * d2[:, 0]
    ok = np.abs(det) >= _DET_TOLERANCE
    det_safe = np.where(ok, det, 1.0)
    rel = p - np.array([x, y])
    r = (-d2[:, 1] * rel[:, 0] + d2[:, 0] * rel[:, 1]) / det_safe
    s = (-d1[1] * rel[:, 0] + d1[0] * rel[:, 1]) / det_safe
    hit = ok & (r >= 0) & (s >= 0) & (s <= 1)
    return np.where(hit, r, np.inf)


def point_distance(p1, p2) -> float:
    return math.hypot(p1[0] - p2[0], p1[1] - p2[1])


def construct_maze(maze_id: int = 0, length: int = 1) -> List[list]:
    """The reference's 11 maze layouts (maze_utils.py:92-186), same grids.

    Cells: 1 wall, 0 floor, 'r' robot start, 'g' goal.
    """
    if maze_id == 0:
        if length != 1:
            raise NotImplementedError("Maze_id 0 only has length 1!")
        return [
            [1, 1, 1, 1, 1],
            [1, 'r', 0, 0, 1],
            [1, 1, 1, 0, 1],
            [1, 'g', 0, 0, 1],
            [1, 1, 1, 1, 1],
        ]
    if maze_id in (1, 2):
        # donut ring; id 2 blocks one arm to force the long way (spiral)
        c = length + 4
        m = np.ones((c, c), int)
        m[1:c - 1, (1, c - 2)] = 0
        m[(1, c - 2), 1:c - 1] = 0
        grid = m.tolist()
        grid[1][c // 2] = 'r'
        if maze_id == 1:
            grid[c - 2][c // 2] = 'g'
        else:
            grid[1][c // 2 - 1] = 1
            grid[1][c // 2 - 2] = 'g'
        return grid
    if maze_id == 3:
        # corridor with goals at both extremes
        return [
            [1] * (2 * length + 5),
            [1, 'g'] + [0] * length + ['r'] + [0] * length + ['g', 1],
            [1] * (2 * length + 5),
        ]
    if 4 <= maze_id <= 7:
        # X-shaped cross corridor: both diagonals carved 3 cells wide,
        # start at the center, goal in the corner selected by maze_id
        c = 2 * length + 5
        m = np.ones((c, c), int)
        i = np.arange(c)
        for off in (-1, 0, 1):
            valid = (i + off >= 0) & (i + off < c)
            m[i[valid], (i + off)[valid]] = 0  # main diagonal band
            j = c - 1 - i
            valid = (j + off >= 0) & (j + off < c)
            m[i[valid], (j + off)[valid]] = 0  # anti-diagonal band
        m[0, :] = m[c - 1, :] = 1
        m[:, 0] = m[:, c - 1] = 1
        grid = m.tolist()
        grid[c // 2][c // 2] = 'r'
        corner = {4: (1, 1), 5: (1, c - 2), 6: (c - 2, 1), 7: (c - 2, c - 2)}[maze_id]
        grid[corner[0]][corner[1]] = 'g'
        return grid
    if maze_id == 8:
        return [
            [1, 1, 1, 1, 1],
            [1, 'g', 0, 0, 1],
            [1, 1, 1, 0, 1],
            [1, 'r', 0, 0, 1],
            [1, 1, 1, 1, 1],
        ]
    if maze_id == 9:
        return [
            [1, 1, 1, 1, 1],
            [1, 0, 0, 'r', 1],
            [1, 0, 1, 1, 1],
            [1, 0, 0, 'g', 1],
            [1, 1, 1, 1, 1],
        ]
    if maze_id == 10:
        return [
            [1, 1, 1, 1, 1],
            [1, 0, 0, 'g', 1],
            [1, 0, 1, 1, 1],
            [1, 0, 0, 'r', 1],
            [1, 1, 1, 1, 1],
        ]
    raise NotImplementedError("The provided MazeId is not recognized")


def maze_cell_centers(structure: Sequence[Sequence], scaling: float = 4.0,
                      ) -> Tuple[np.ndarray, Optional[np.ndarray], np.ndarray]:
    """World-frame (x, y) of the 'r' cell, 'g' cells, and all floor cells.

    The grid is laid out row-major with the 'r' cell at the origin
    (the usual rllab maze convention the layouts come from).
    """
    struct = [list(row) for row in structure]
    r_cell = None
    for i, row in enumerate(struct):
        for j, v in enumerate(row):
            if v == 'r':
                r_cell = (i, j)
    if r_cell is None:
        raise ValueError("maze has no 'r' start cell")
    goals, floors = [], []
    for i, row in enumerate(struct):
        for j, v in enumerate(row):
            xy = ((j - r_cell[1]) * scaling, (r_cell[0] - i) * scaling)
            if v == 'g':
                goals.append(xy)
            if v != 1:
                floors.append(xy)
    return (np.zeros(2),
            np.asarray(goals, np.float64) if goals else None,
            np.asarray(floors, np.float64))


def maze_to_wall_segments(structure: Sequence[Sequence], scaling: float = 4.0,
                          ) -> np.ndarray:
    """Convert a maze grid into merged wall segments (N, 2, 2) in world frame.

    Walls are the boundaries between a wall cell and a floor cell (interior
    wall-wall boundaries produce nothing). Collinear runs merge into single
    segments so the resulting scene Config has few colliders — collider count
    is the contact-phase cost driver at 4096 envs.
    """
    struct = [list(row) for row in structure]
    rows, cols = len(struct), len(struct[0])
    r_cell = None
    for i, row in enumerate(struct):
        for j, v in enumerate(row):
            if v == 'r':
                r_cell = (i, j)
    if r_cell is None:
        raise ValueError("maze has no 'r' start cell")

    def is_wall(i, j):
        return struct[i][j] == 1

    # horizontal edges between row i-1 and i; vertical between col j-1 and j
    h_edges = np.zeros((rows + 1, cols), bool)
    v_edges = np.zeros((rows, cols + 1), bool)
    for i in range(rows):
        for j in range(cols):
            if not is_wall(i, j):
                continue
            if i == 0 or not is_wall(i - 1, j):
                h_edges[i, j] = True
            if i == rows - 1 or not is_wall(i + 1, j):
                h_edges[i + 1, j] = True
            if j == 0 or not is_wall(i, j - 1):
                v_edges[i, j] = True
            if j == cols - 1 or not is_wall(i, j + 1):
                v_edges[i, j + 1] = True

    def cell_corner(i, j):
        # world xy of grid corner (i, j): cell centers offset by half a cell
        x = (j - r_cell[1] - 0.5) * scaling
        y = (r_cell[0] - i + 0.5) * scaling
        return x, y

    segments = []
    for i in range(rows + 1):  # merge horizontal runs
        j = 0
        while j < cols:
            if h_edges[i, j]:
                j0 = j
                while j < cols and h_edges[i, j]:
                    j += 1
                segments.append([cell_corner(i, j0), cell_corner(i, j)])
            else:
                j += 1
    for j in range(cols + 1):  # merge vertical runs
        i = 0
        while i < rows:
            if v_edges[i, j]:
                i0 = i
                while i < rows and v_edges[i, j]:
                    i += 1
                segments.append([cell_corner(i0, j), cell_corner(i, j)])
            else:
                i += 1
    return np.asarray(segments, np.float64)


def geodesic_distance_field(structure: Sequence[Sequence],
                            scaling: float = 4.0,
                            subdivisions: int = 5,
                            ) -> Tuple[np.ndarray, float, float, float]:
    """In-maze (geodesic) distance-to-goal field for potential shaping.

    Euclidean distance is the WRONG potential in a maze: on maze 0's
    U-shaped corridor the straight line to the goal points through a wall,
    so progress shaping on ||xy - goal|| rewards pressing into the divider
    (the AntTag shaping lesson — docs/LEARNING.md — transplanted to a world
    with obstacles). This computes the true shortest-path distance instead:
    each maze cell is subdivided `subdivisions` x `subdivisions`, wall cells
    are blocked, and an 8-connected Dijkstra from the 'g' cell(s) labels
    every floor subcell with its path length. Blocked subcells get
    max+scaling so bilinear interpolation near a wall slopes away from it.

    Returns (field[rows*S, cols*S] row-major in grid frame, x0, y0, res):
    subcell (a, b) center is world (x0 + b*res, y0 - a*res); `res` =
    scaling/subdivisions. Host-side numpy, build-time only — the consumer
    uploads the field once as a constant and interpolates inside jit.
    """
    import heapq

    struct = [list(row) for row in structure]
    rows, cols = len(struct), len(struct[0])
    S = subdivisions
    res = scaling / S
    r_cell = None
    for i, row in enumerate(struct):
        for j, v in enumerate(row):
            if v == 'r':
                r_cell = (i, j)
    if r_cell is None:
        raise ValueError("maze has no 'r' start cell")
    # world xy of subcell (a, b): subdivide each cell around its center
    x0 = (0 - r_cell[1] - 0.5) * scaling + res / 2.0
    y0 = (r_cell[0] - 0 + 0.5) * scaling - res / 2.0

    blocked = np.zeros((rows * S, cols * S), bool)
    seeds = []
    for i in range(rows):
        for j in range(cols):
            if struct[i][j] == 1:
                blocked[i * S:(i + 1) * S, j * S:(j + 1) * S] = True
            elif struct[i][j] == 'g':
                c = S // 2
                seeds.append((i * S + c, j * S + c))
    if not seeds:
        raise ValueError("maze has no 'g' goal cell")

    dist = np.full(blocked.shape, np.inf)
    heap = []
    for s in seeds:
        dist[s] = 0.0
        heapq.heappush(heap, (0.0, s))
    diag = res * math.sqrt(2.0)
    while heap:
        d, (a, b) = heapq.heappop(heap)
        if d > dist[a, b]:
            continue
        for da in (-1, 0, 1):
            for db in (-1, 0, 1):
                if da == 0 and db == 0:
                    continue
                na, nb = a + da, b + db
                if not (0 <= na < blocked.shape[0]
                        and 0 <= nb < blocked.shape[1]):
                    continue
                if blocked[na, nb]:
                    continue
                # no corner cutting: a diagonal move requires both
                # adjacent orthogonal subcells open
                if da != 0 and db != 0 and (
                        blocked[a, nb] or blocked[na, b]):
                    continue
                nd = d + (diag if da != 0 and db != 0 else res)
                if nd < dist[na, nb]:
                    dist[na, nb] = nd
                    heapq.heappush(heap, (nd, (na, nb)))
    finite = dist[np.isfinite(dist)]
    fill = (finite.max() if finite.size else 0.0) + scaling
    dist[~np.isfinite(dist)] = fill
    return dist.astype(np.float32), float(x0), float(y0), float(res)
