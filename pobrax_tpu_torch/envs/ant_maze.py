"""AntMaze: navigate a procedurally built maze to a goal cell; the port of
`pobrax_tpu/envs/ant_maze.py`, natively batched.

The JAX package's working AntMaze (the reference's cannot be constructed):
`maze_utils.construct_maze`'s grid becomes merged wall segments, each a box
collider on one frozen `Maze` body; the ant starts at the origin and is
rewarded for reaching the goal, one of the maze's 'g' cells drawn with
`randint` at every reset.

Partial observability: the ant senses walls through an egocentric `n_bins`
range sensor (ray-segment distances over rays x segments) and sees the
goal's direction only within `visible_radius`.

Observation: ant proprio + contacts (27 + 6 * nbody) + n_bins wall readings
+ 2 gated goal-direction dims.
"""

from __future__ import annotations

import numpy as np
import torch

from pobrax_tpu_torch import random as jr
from pobrax_tpu_torch.envs import maze_utils
from pobrax_tpu_torch.envs.base import Env, State
from pobrax_tpu_torch.envs.common import ant_full_obs, dead_and_reward
from pobrax_tpu_torch.ops import quaternion as quat
from pobrax_tpu_torch.ops.vector import norm
from pobrax_tpu_torch.physics import ant as ant_model
from pobrax_tpu_torch.physics import config as pcfg, scene
from pobrax_tpu_torch.physics.state import Info, QP


def extend_ant_cfg(maze_id: int = 0, length: int = 1, scaling: float = 4.0,
                   wall_half_height: float = 1.0) -> pcfg.Config:
    """Ant + maze walls (one frozen body, one box collider per merged
    segment) + frozen Goal sphere. Body order: ant(9), Ground, Maze, Goal."""
    cfg = ant_model.ant_config()
    structure = maze_utils.construct_maze(maze_id, length)
    segments = maze_utils.maze_to_wall_segments(structure, scaling)
    colliders = tuple(scene.box_wall(seg[0], seg[1], half_height=wall_half_height,
                                     wall_width=0.25)
                      for seg in segments)
    cfg = cfg.add_body(pcfg.Body(name="Maze", colliders=colliders, mass=1.0, frozen=True))
    cfg = cfg.add_default_qp(pcfg.DefaultQP(name="Maze", pos=(0.0, 0.0, wall_half_height)))
    for name in ant_model.ANT_BODY_NAMES:
        cfg = cfg.add_collide_pair(name, "Maze")
    cfg = cfg.add_body(pcfg.Body(
        name="Goal", colliders=(pcfg.Collider(geom=pcfg.Sphere(0.5)),), mass=1.0, frozen=True))
    return cfg


class AntMazeEnv(Env):
    def __init__(self, maze_id: int = 0, length: int = 1, scaling: float = 4.0,
                 n_bins: int = 8, sensor_range: float = 6.0,
                 sensor_span: float = 2.0 * np.pi, visible_radius: float = 3.0,
                 goal_reward: float = 10.0, dying_cost: float = -10.0,
                 device=None, info: str = "full"):
        super().__init__(extend_ant_cfg(maze_id, length, scaling), device, info)
        self.maze_id = maze_id
        self.length = length
        self.scaling = scaling
        self.n_bins = n_bins
        self.sensor_range = sensor_range
        self.half_span = sensor_span / 2.0
        self.visible_radius = visible_radius
        self.goal_reward = goal_reward
        self.dying_cost = dying_cost
        self.torso_idx = self.sys.body.index["$ Torso"]
        self.goal_idx = self.sys.body.index["Goal"]

        structure = maze_utils.construct_maze(maze_id, length)
        segments = torch.as_tensor(
            np.asarray(maze_utils.maze_to_wall_segments(structure, scaling), np.float32),
            device=self.device)
        self._seg_p = segments[:, 0]                  # (S, 2)
        self._seg_e = segments[:, 1] - segments[:, 0]  # (S, 2)
        _, goals, _ = maze_utils.maze_cell_centers(structure, scaling)
        if goals is None:
            raise ValueError(f"maze {maze_id} has no goal cell")
        self._goals = torch.as_tensor(np.asarray(goals, np.float32), device=self.device)
        # ray offsets from the heading, at the centre of each bin
        self._bin_offsets = (torch.arange(n_bins, dtype=torch.float32, device=self.device)
                             + 0.5) * (2.0 * self.half_span / n_bins)
        self._x_axis = torch.tensor([1.0, 0.0, 0.0], device=self.device)

    @property
    def observation_size(self) -> int:
        ndof, n = self.sys.num_joint_dof, self.sys.num_bodies
        return 3 + 4 + ndof + 3 + 3 + ndof + 6 * n + self.n_bins + 2

    # ---- sensors -------------------------------------------------------------

    def _heading(self, qp: QP) -> torch.Tensor:
        fwd = quat.rotate(self._x_axis, qp.rot[:, self.torso_idx])
        return torch.atan2(fwd[:, 1], fwd[:, 0])

    def _wall_readings(self, qp: QP) -> torch.Tensor:
        """(B, n_bins) wall proximity per egocentric bin: 1 at contact, 0 at
        or beyond sensor_range; rays x segments, batched."""
        xy = qp.pos[:, self.torso_idx, :2]
        angles = (self._heading(qp) - self.half_span)[:, None] + self._bin_offsets  # (B, R)
        dx, dy = torch.cos(angles)[..., None], torch.sin(angles)[..., None]     # (B, R, 1)
        ex, ey = self._seg_e[:, 0], self._seg_e[:, 1]                            # (S,)
        rel = self._seg_p - xy[:, None, :]                                       # (B, S, 2)
        rx, ry = rel[:, None, :, 0], rel[:, None, :, 1]                          # (B, 1, S)
        det = dx * (-ey) + dy * ex                                               # (B, R, S)
        ok = torch.abs(det) > 1e-8
        det = torch.where(ok, det, torch.ones_like(det))
        t = (rx * (-ey) + ry * ex) / det
        s = (dx * ry - dy * rx) / det
        hit = ok & (t >= 0.0) & (s >= 0.0) & (s <= 1.0)
        dist = torch.where(hit, t, torch.full_like(t, float("inf"))).amin(-1)   # (B, R)
        return torch.clamp(1.0 - dist / self.sensor_range, 0.0, 1.0)

    def _goal_obs(self, qp: QP) -> torch.Tensor:
        """Goal direction (unit xy in the ant's frame), zeroed beyond
        visible_radius."""
        rel = qp.pos[:, self.goal_idx, :2] - qp.pos[:, self.torso_idx, :2]
        dist = norm(rel)
        ori = self._heading(qp)
        ca, sa = torch.cos(-ori), torch.sin(-ori)
        local = torch.stack([ca * rel[:, 0] - sa * rel[:, 1], sa * rel[:, 0] + ca * rel[:, 1]], -1)
        unit = local / torch.clamp(dist, min=1e-6)[:, None]
        return torch.where((dist <= self.visible_radius)[:, None], unit, torch.zeros_like(unit))

    # ---- env API -------------------------------------------------------------

    def reset(self, rng: torch.Tensor) -> State:
        """(B, 2) keys -> a batch of B fresh episodes."""
        rng, rng1, rng2, rng3 = jr.split(rng, 4).unbind(-2)
        ndof = self.sys.num_joint_dof
        qpos = self.sys.default_angle() + jr.uniform(rng1, (ndof,), -0.1, 0.1)
        qvel = jr.uniform(rng2, (ndof,), -0.1, 0.1)
        qp = self.sys.default_qp(joint_angle=qpos, joint_velocity=qvel)
        # goal: one of the maze's 'g' cells, uniformly
        gi = jr.randint(rng3, (), 0, len(self._goals)).long()
        pos = qp.pos.clone()
        pos[:, self.goal_idx, :2] = self._goals[gi]
        pos[:, self.goal_idx, 2] = 0.5
        qp = qp.replace(pos=pos)
        info = self.sys.info(qp)
        obs = self._get_obs(qp, info)
        zero = torch.zeros(rng.shape[0], device=rng.device)
        return State(qp, obs, zero, zero.clone(), {"goals": zero.clone()}, {"rng": rng})

    def step(self, state: State, action: torch.Tensor) -> State:
        qp, info = self.sys.step(state.qp, action)
        obs = self._get_obs(qp, info)
        dead, reward = dead_and_reward(qp, self.torso_idx, self.dying_cost)
        dist = norm(qp.pos[:, self.goal_idx, :2] - qp.pos[:, self.torso_idx, :2])
        reached = (dist <= 1.0).to(torch.float32)
        reward = torch.where(reached > 0, torch.full_like(reward, self.goal_reward), reward)
        done = torch.maximum(dead, reached)
        return state.replace(qp=qp, obs=obs, reward=reward, done=done,
                             metrics={**state.metrics, "goals": reached})

    def _get_obs(self, qp: QP, info: Info) -> torch.Tensor:
        return torch.cat(ant_full_obs(self.sys, qp, info)
                         + [self._wall_readings(qp), self._goal_obs(qp)], dim=-1)
