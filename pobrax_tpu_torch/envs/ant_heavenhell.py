"""AntHeavenHell: a T-maze where a priest reveals which arm is heaven; the
port of `pobrax_tpu/envs/ant_heavenhell.py`, natively batched.

Behaviour follows po-brax's ant_heavenhell.py as the JAX env does — the
scene with Priest/Target/Hell spheres and T-maze walls, the heaven/hell side
swap drawn at every reset, the priest-gated heaven-direction observation
bit, +1 / -1 / dying rewards with done on any nonzero reward — with its
quirks kept:
  * the reset reuses `rng3` for both the ant's spawn and the side swap;
  * `ant_slice` includes the frozen Ground body;
  * the step writes a 'hits' metric while the reference's reset declares
    'heavens' / 'hells'; all three keys are declared at reset, as in JAX.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from pobrax_tpu_torch import random as jr
from pobrax_tpu_torch.envs.base import Env, State
from pobrax_tpu_torch.envs.common import ant_full_obs, dead_and_reward
from pobrax_tpu_torch.ops.vector import norm
from pobrax_tpu_torch.physics import ant as ant_model
from pobrax_tpu_torch.physics import config as pcfg, scene
from pobrax_tpu_torch.physics.state import Info, QP


def extend_ant_cfg(hhp: np.ndarray, hallway_width: float = 2.0) -> pcfg.Config:
    """Ant + Priest/Target/Hell frozen spheres + T-maze walls. Body order:
    ant(9), Ground, Priest, Target, Hell, Arena."""
    cfg = ant_model.ant_config()
    cfg = cfg.add_body(
        pcfg.Body(name="Priest", colliders=(pcfg.Collider(geom=pcfg.Sphere(0.5)),),
                  mass=1.0, frozen=True))
    cfg = cfg.add_default_qp(
        pcfg.DefaultQP(name="Priest", pos=(float(hhp[-1, 0]), float(hhp[-1, 1]), 1.0)))
    for name in ("Target", "Hell"):
        cfg = cfg.add_body(
            pcfg.Body(name=name, colliders=(pcfg.Collider(geom=pcfg.Sphere(0.5)),),
                      mass=1.0, frozen=True))
    cfg = scene.draw_t_maze(
        cfg,
        t_x=float(hhp[:, 0].max()) + hallway_width / 2,
        t_y=float(hhp[:, 1].max()) + hallway_width / 2,
        hallway_width=hallway_width,
    )
    for name in ant_model.ANT_BODY_NAMES:
        cfg = cfg.add_collide_pair(name, "Arena")
    return cfg


class AntHeavenHellEnv(Env):
    """Args (po-brax ant_heavenhell.py:43-50):
        heaven_hell: xy of the two goal arms (same y, left + right)
        priest_position: priest xy (top of the T)
        visible_radius: in-range radius for goals and priest
        dying_cost: reward on torso-height death
        device, info: as `Env`
    """

    def __init__(
        self,
        heaven_hell: Sequence[Sequence[float]] = ((-5.25, 7.0), (5.25, 7.0)),
        priest_position: Sequence[float] = (0.0, 7.0),
        visible_radius: float = 2.0,
        dying_cost: float = -2.0,
        device=None,
        info: str = "full",
    ):
        hhp = np.concatenate(
            [np.concatenate([np.asarray(heaven_hell, np.float32),
                             np.asarray(priest_position, np.float32)[None]], 0),
             np.ones((3, 1), np.float32)],
            axis=1,
        )
        self.visible_radius = visible_radius
        self.dying_cost = dying_cost
        super().__init__(extend_ant_cfg(hhp=hhp, hallway_width=2.0), device, info)
        self._hhp = torch.as_tensor(hhp, device=self.device)
        self.target_idx = self.sys.body.index["Target"]
        self.hell_idx = self.sys.body.index["Hell"]
        self.priest_idx = self.sys.body.index["Priest"]
        self.torso_idx = self.sys.body.index["$ Torso"]
        self.ant_slice = slice(self.torso_idx, self.priest_idx)  # incl. Ground (quirk)
        self._hhp_idx = [self.target_idx, self.hell_idx, self.priest_idx]
        # (low, high) of the ant's xy spawn box
        self._spawn_lo = torch.tensor([-0.5, 0.5], device=self.device)
        self._spawn_hi = torch.tensor([0.5, 1.5], device=self.device)

    @property
    def observation_size(self) -> int:
        ndof, n = self.sys.num_joint_dof, self.sys.num_bodies
        return 3 + 4 + ndof + 3 + 3 + ndof + 6 * n + 1

    def reset(self, rng: torch.Tensor) -> State:
        """(B, 2) keys -> a batch of B fresh episodes."""
        rng, rng1, rng2, rng3, _ = jr.split(rng, 5).unbind(-2)
        ndof = self.sys.num_joint_dof
        qpos = self.sys.default_angle() + jr.uniform(rng1, (ndof,), -0.1, 0.1)
        qvel = jr.uniform(rng2, (ndof,), -0.1, 0.1)
        # rng3 draws the spawn AND, below, the side swap — reference quirk
        ant_pos = jr.uniform(rng3, (2,), self._spawn_lo, self._spawn_hi)
        qp = self.sys.default_qp(joint_angle=qpos, joint_velocity=qvel)
        pos = qp.pos.clone()
        pos[:, self.ant_slice, :2] += ant_pos[:, None, :]
        hh = jr.choice(rng3, self._hhp[:2], 2)
        pos[:, self.target_idx] = hh[:, 0]
        pos[:, self.hell_idx] = hh[:, 1]
        qp = qp.replace(pos=pos)
        info = self.sys.info(qp)
        zero = torch.zeros(rng.shape[0], device=rng.device)
        obs = self._get_obs(qp, info, zero)
        metrics = {"heavens": zero.clone(), "hells": zero.clone(), "hits": zero.clone()}
        return State(qp, obs, zero, zero.clone(), metrics, {"rng": rng})

    def step(self, state: State, action: torch.Tensor) -> State:
        qp, info = self.sys.step(state.qp, action)
        dead, reward = dead_and_reward(qp, self.torso_idx, self.dying_cost)
        hhp_xy = qp.pos[:, self._hhp_idx, :2]
        in_range = norm(hhp_xy - qp.pos[:, self.torso_idx, None, :2]) <= self.visible_radius
        priest_in_range = in_range[:, 2].to(torch.float32)
        reward = torch.where(in_range[:, 0], torch.ones_like(reward), reward)
        reward = torch.where(in_range[:, 1], -torch.ones_like(reward), reward)
        done = (reward != 0).to(torch.float32)
        obs = self._get_obs(qp, info, priest_in_range)
        return state.replace(qp=qp, obs=obs, reward=reward, done=done,
                             metrics={**state.metrics, "hits": done})

    def _get_obs(self, qp: QP, info: Info, priest_in_range: torch.Tensor) -> torch.Tensor:
        """Core ant obs + the priest-gated heaven direction sign(target_x)."""
        tgt_x = qp.pos[:, self.target_idx, :1]
        heaven_direction = torch.where(priest_in_range[:, None] > 0, torch.sign(tgt_x),
                                       torch.zeros_like(tgt_x))
        return torch.cat(ant_full_obs(self.sys, qp, info) + [heaven_direction], dim=-1)
