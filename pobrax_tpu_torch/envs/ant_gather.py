"""AntGather: collect apples (+1), avoid bombs (-1), sensed through a binned
range sensor; the port of `pobrax_tpu/envs/ant_gather.py`, natively batched.

Behaviour follows po-brax's ant_gather.py as the JAX env does — the arena
with 8 frozen apple and 8 frozen bomb spheres, integer-grid spawns drawn
without replacement at every reset, catch-and-teleport to a waiting area,
any-apple / any-bomb rewards (not summed; the bomb wins), the binned
range-bearing sensor — with its quirks kept:
  * the reset keeps the key it was given as `info['rng']` (the split keys
    feed the draws only);
  * object bearing is arctan2(x, y) of the object's absolute position, not
    of its position relative to the ant;
  * bomb readings are offset by n_apples (8), not n_bins (10), so bombs
    overlap apple bins 8-9; `bomb_bin_offset=n_bins` is the JAX package's
    de-aliased diagnostic sensor, kept here too;
  * out-of-range objects write intensity 0 into bin -1, which wraps to the
    last reading slot; the last writer in object order wins each slot;
  * the waiting area adds 2 * sensor_range to all three coordinates of the
    last grid point, so caught objects teleport into the sky;
  * the observation is taken before the caught objects teleport;
  * `metrics['objects']` is declared but never updated.

The apples and bombs are frozen and no contact row names them, so the
whole-step kernel passes them through (physics/step_tables.py).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from pobrax_tpu_torch import random as jr
from pobrax_tpu_torch.envs.base import Env, State
from pobrax_tpu_torch.envs.common import ant_full_obs, dead_and_reward
from pobrax_tpu_torch.ops import quaternion as quat
from pobrax_tpu_torch.ops.vector import norm
from pobrax_tpu_torch.physics import ant as ant_model
from pobrax_tpu_torch.physics import config as pcfg, scene
from pobrax_tpu_torch.physics.state import Info, QP


def extend_ant_cfg(cage_max_xy=(6.0, 6.0), offset: float = 1.0,
                   n_apples: int = 8, n_bombs: int = 8) -> pcfg.Config:
    """Ant + arena + frozen Target_i / Bomb_i spheres r=0.25. Body order:
    ant(9), Ground, Arena, Target_1..n, Bomb_1..n."""
    cfg = ant_model.ant_config()
    cfg = scene.draw_arena(cfg, cage_max_xy[0] + offset, cage_max_xy[1] + offset, 0.5)
    for name in ant_model.ANT_BODY_NAMES:
        cfg = cfg.add_collide_pair(name, "Arena")
    for prefix, count in (("Target", n_apples), ("Bomb", n_bombs)):
        for i in range(count):
            cfg = cfg.add_body(pcfg.Body(
                name=f"{prefix}_{i + 1}",
                colliders=(pcfg.Collider(geom=pcfg.Sphere(0.25)),), mass=1.0, frozen=True))
    return cfg


class AntGatherEnv(Env):
    """Args (po-brax ant_gather.py:43-58): n_apples / n_bombs, cage_xy,
    robot_object_spacing (least spawn distance from the origin), catch_range,
    n_bins / sensor_range / sensor_span (the sensor), dying_cost,
    bomb_bin_offset (None: n_apples, the reference's aliased sensor);
    device, info as `Env`."""

    def __init__(
        self,
        n_apples: int = 8,
        n_bombs: int = 8,
        cage_xy: Sequence[float] = (6.0, 6.0),
        robot_object_spacing: float = 2.0,
        catch_range: float = 1.0,
        n_bins: int = 10,
        sensor_range: float = 6.0,
        sensor_span: float = float(np.pi),
        dying_cost: float = -10.0,
        bomb_bin_offset: Optional[int] = None,
        device=None,
        info: str = "full",
    ):
        super().__init__(extend_ant_cfg(cage_max_xy=tuple(cage_xy), offset=1.0,
                                        n_apples=n_apples, n_bombs=n_bombs), device, info)
        self.torso_idx = self.sys.body.index["$ Torso"]
        self.n_apples = n_apples
        self.n_bombs = n_bombs
        self.n_objects = n_apples + n_bombs
        self.n_bins = n_bins
        self.bomb_bin_offset = n_apples if bomb_bin_offset is None else int(bomb_bin_offset)
        self.dying_cost = dying_cost
        self.sensor_range = sensor_range
        self.half_span = sensor_span / 2
        self.catch_range = catch_range
        last = self.sys.num_bodies
        self.objects = slice(last - self.n_objects, last)

        # integer grid points farther than robot_object_spacing from the
        # origin, in meshgrid-xy raveled order (x varies fastest)
        gx, gy = np.meshgrid(np.arange(-cage_xy[0], cage_xy[0] + 1),
                             np.arange(-cage_xy[1], cage_xy[1] + 1), indexing="xy")
        grid = np.stack([gx.ravel(), gy.ravel()], axis=1).astype(np.float32)
        grid = grid[np.linalg.norm(grid, axis=1) > robot_object_spacing]
        grid = np.concatenate([grid, np.zeros((grid.shape[0], 1), np.float32)], axis=1)
        self.possible_grid_positions = torch.as_tensor(grid, device=self.device)
        # ALL coords shifted by 2 * sensor_range, z too — reference quirk
        self.waiting_area = self.possible_grid_positions[-1] + self.sensor_range * 2
        self._y_axis = torch.tensor([0.0, 1.0, 0.0, 0.0], device=self.device)
        # the de-aliased sensor routes bin -1 to a trash slot, dropped after
        self._work_slots = 2 * n_bins + (self.bomb_bin_offset != n_apples)
        self._slot_ids = torch.arange(self._work_slots, device=self.device)
        self._writer_ids = torch.arange(1, self.n_objects + 1, device=self.device)

    @property
    def observation_size(self) -> int:
        ndof, n = self.sys.num_joint_dof, self.sys.num_bodies
        return 3 + 4 + ndof + 3 + 3 + ndof + 6 * n + 2 * self.n_bins

    def reset(self, rng: torch.Tensor) -> State:
        """(B, 2) keys -> a batch of B fresh episodes."""
        qp = self.sample_init_qp(rng)
        info = self.sys.info(qp)
        obs = self._get_obs(qp, info, self._distances(qp))
        zero = torch.zeros(rng.shape[0], device=rng.device)
        metrics = {"apples": zero.clone(), "bombs": zero.clone(), "objects": zero.clone()}
        return State(qp, obs, zero, zero.clone(), metrics, {"rng": rng})

    def sample_init_qp(self, rng: torch.Tensor) -> QP:
        _, rng1, rng2, rng3 = jr.split(rng, 4).unbind(-2)
        ndof = self.sys.num_joint_dof
        qpos = self.sys.default_angle() + jr.uniform(rng1, (ndof,), -0.1, 0.1)
        qvel = jr.uniform(rng2, (ndof,), -0.1, 0.1)
        qp = self.sys.default_qp(joint_angle=qpos, joint_velocity=qvel)
        object_pos = jr.choice(rng3, self.possible_grid_positions, self.n_objects)
        object_pos[:, :self.n_apples, 2] = 1.0  # apples at z=1, bombs at z=0
        pos = qp.pos.clone()
        pos[:, self.objects] = object_pos
        return qp.replace(pos=pos)

    def _distances(self, qp: QP) -> torch.Tensor:
        """(B, n_objects) xy distances from the torso to each object."""
        return norm(qp.pos[:, self.torso_idx, None, :2] - qp.pos[:, self.objects, :2])

    def step(self, state: State, action: torch.Tensor) -> State:
        qp, info = self.sys.step(state.qp, action)
        distances = self._distances(qp)
        # the observation uses pre-teleport positions — reference order
        obs = self._get_obs(qp, info, distances)
        dead, reward = dead_and_reward(qp, self.torso_idx, self.dying_cost)
        in_range = distances <= self.catch_range
        obj_pos = torch.where(in_range[..., None], self.waiting_area, qp.pos[:, self.objects])
        pos = qp.pos.clone()
        pos[:, self.objects] = obj_pos
        qp = qp.replace(pos=pos)

        apple, bomb = in_range[:, :self.n_apples], in_range[:, self.n_apples:]
        alive = dead == 0
        reward = torch.where(apple.any(-1) & alive, torch.ones_like(reward), reward)
        reward = torch.where(bomb.any(-1) & alive, -torch.ones_like(reward), reward)
        all_waiting = (obj_pos == self.waiting_area).flatten(1).all(-1)
        done = torch.where(all_waiting, torch.ones_like(dead), dead)
        metrics = {**state.metrics, "apples": apple.sum(-1).to(torch.float32),
                   "bombs": bomb.sum(-1).to(torch.float32)}
        return state.replace(qp=qp, obs=obs, reward=reward, done=done, metrics=metrics)

    def _get_readings(self, qp: QP, distances: torch.Tensor) -> torch.Tensor:
        """The binned range-bearing sensor, (B, 2 * n_bins), quirks intact."""
        bin_res = (2 * self.half_span) / self.n_bins
        q = qp.rot[:, self.torso_idx]
        ori_vec = quat.quat_mul(quat.quat_mul(q, self._y_axis), quat.quat_inv(q))[:, 1:3]
        ori = torch.atan2(ori_vec[:, 1], ori_vec[:, 0])
        object_xy = qp.pos[:, self.objects, :2]
        # arctan2(x, y) of the ABSOLUTE object position — reference quirk
        angles = torch.atan2(object_xy[..., 0], object_xy[..., 1]) - ori[:, None]
        seen = (torch.abs(angles) <= self.half_span) & (distances <= self.sensor_range)
        bins = torch.where(seen, ((angles + self.half_span) / bin_res).to(torch.int32),
                           torch.full_like(angles, -1, dtype=torch.int32))
        if self.bomb_bin_offset != self.n_apples:
            # de-aliased diagnostic only: a bearing of exactly +half_span
            # gives bin n_bins; merge it into the last bin
            bins = torch.where(bins >= 0, torch.clamp(bins, max=self.n_bins - 1), bins)
        # bombs offset by n_apples, NOT n_bins — reference quirk
        bomb = bins[:, self.n_apples:]
        bins = torch.cat([bins[:, :self.n_apples],
                          torch.where(bomb >= 0, bomb + self.bomb_bin_offset, bomb)], dim=-1)
        intensity = torch.where(bins >= 0, 1.0 - distances / self.sensor_range,
                                torch.zeros_like(distances))
        slots = torch.where(bins < 0, bins + self._work_slots, bins)
        # last writer in object order wins: per slot, the highest object
        # index (1-based, 0 for none) that writes it
        hits = slots[:, :, None] == self._slot_ids
        writer = (hits * self._writer_ids[:, None]).amax(1)
        readings = torch.gather(intensity, 1, (writer - 1).clamp(min=0))
        readings = torch.where(writer > 0, readings, torch.zeros_like(readings))
        return readings[:, :2 * self.n_bins]

    def _get_obs(self, qp: QP, info: Info, distances: torch.Tensor) -> torch.Tensor:
        return torch.cat(ant_full_obs(self.sys, qp, info) + [self._get_readings(qp, distances)],
                         dim=-1)
