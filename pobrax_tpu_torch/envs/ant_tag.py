"""AntTag: an ant chases an evasive moving target, visible only nearby; the
port of `pobrax_tpu/envs/ant_tag.py`, natively batched.

Behaviour follows po-brax's ant_tag.py as the JAX env does — the scene,
the rejection-sampled target spawn, the 4-move adversary, the
visibility-gated observation, tag / death termination — with its documented
quirks kept:
  * `ant_slice` spans torso..Target exclusive, so the frozen Ground body is
    included in the spawn-offset add (harmless, kept);
  * target z is 0.5 at spawn but 1.0 after every adversary step;
  * the whole adversary move reverts if ANY |coord| leaves the cage;
  * the NaN hazard of `_step_target` (see there).

Random draws use `pobrax_tpu_torch.random` with the JAX env's key chain, so
a seed replays the JAX env's resets and adversary moves exactly.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from pobrax_tpu_torch import random as jr
from pobrax_tpu_torch.envs.base import Env, State
from pobrax_tpu_torch.envs.common import ant_full_obs, dead_and_reward
from pobrax_tpu_torch.ops.vector import norm
from pobrax_tpu_torch.physics import ant as ant_model
from pobrax_tpu_torch.physics import config as pcfg, scene
from pobrax_tpu_torch.physics.state import Info, QP


def extend_ant_cfg(cage_max_xy=(4.5, 4.5), offset: float = 1.0) -> pcfg.Config:
    """Ant + frozen Target sphere + box-wall arena + ant-vs-arena contacts."""
    cfg = ant_model.ant_config()
    cfg = cfg.add_body(
        pcfg.Body(name="Target", colliders=(pcfg.Collider(geom=pcfg.Sphere(0.5)),),
                  mass=1.0, frozen=True)
    )
    cfg = scene.draw_arena(cfg, cage_max_xy[0] + offset, cage_max_xy[1] + offset, 0.5)
    for name in ant_model.ANT_BODY_NAMES:
        cfg = cfg.add_collide_pair(name, "Arena")
    return cfg


class AntTagEnv(Env):
    """Args (po-brax ant_tag.py:29-37):
        tag_radius: distance at which the target counts as tagged (ends episode)
        visible_radius: distance within which the target appears in the obs
        target_step: adversary step size
        min_spawn_distance: minimum target spawn distance from the ant
        cage_xy: play-area half-extent
        dying_cost: reward on torso-height death
        device: "cuda" (default) or "cpu"
        info: "full" (default) or "contact" (contact Info only)
    """

    def __init__(
        self,
        tag_radius: float = 1.5,
        visible_radius: float = 3.0,
        target_step: float = 0.5,
        min_spawn_distance: float = 5.0,
        cage_xy: Sequence[float] = (4.5, 4.5),
        dying_cost: float = -1.0,
        device=None,
        info: str = "full",
    ):
        self.tag_radius = tag_radius
        self.visible_radius = visible_radius
        self.target_step = target_step
        self.min_spawn_distance = min_spawn_distance
        self.dying_cost = dying_cost
        super().__init__(extend_ant_cfg(cage_max_xy=tuple(cage_xy), offset=1.0), device, info)
        self.cage_xy = torch.tensor(tuple(cage_xy), dtype=torch.float32, device=self.device)
        self.target_idx = self.sys.body.index["Target"]
        self.torso_idx = self.sys.body.index["$ Torso"]
        # all bodies in [torso, target): includes Ground — reference quirk
        self.ant_slice = slice(self.torso_idx, self.target_idx)

    @property
    def observation_size(self) -> int:
        ndof, n = self.sys.num_joint_dof, self.sys.num_bodies
        return 3 + 4 + ndof + 3 + 3 + ndof + 6 * n + 2

    def reset(self, rng: torch.Tensor) -> State:
        """(B, 2) keys -> a batch of B fresh episodes."""
        rng, rng1, rng2, rng3, rng4 = jr.split(rng, 5).unbind(-2)
        ndof = self.sys.num_joint_dof
        qpos = self.sys.default_angle() + jr.uniform(rng1, (ndof,), -0.1, 0.1)
        qvel = jr.uniform(rng2, (ndof,), -0.1, 0.1)
        ant_pos = jr.uniform(rng3, (2,), -self.cage_xy, self.cage_xy)
        qp = self.sys.default_qp(joint_angle=qpos, joint_velocity=qvel)
        pos = qp.pos.clone()
        pos[:, self.ant_slice, :2] += ant_pos[:, None, :]
        pos[:, self.target_idx] = self._random_target(rng4, ant_pos)
        qp = qp.replace(pos=pos)
        info = self.sys.info(qp)
        obs = self._get_obs(qp, info)
        zeros = torch.zeros(rng.shape[0], device=rng.device)
        return State(qp, obs, zeros, zeros.clone(), {"hits": zeros.clone()}, {"rng": rng})

    def _random_target(self, rng: torch.Tensor, ant_xy: torch.Tensor) -> torch.Tensor:
        """Rejection-sample a spawn > min_spawn_distance from the ant. Each
        env keeps its own key chain and iteration count, exactly as `vmap` of
        the JAX env's `while_loop` does; the loop runs while any env is still
        too close (one device-to-host read per iteration, reset only)."""
        xy = jr.uniform(rng, (2,), -self.cage_xy, self.cage_xy)
        key = rng.clone()
        todo = norm(xy - ant_xy) <= self.min_spawn_distance
        while bool(todo.any()):
            idx = todo.nonzero().squeeze(-1)
            k1 = jr.split(key[idx], 2)[:, 1]
            key[idx] = k1
            xy[idx] = jr.uniform(k1, (2,), -self.cage_xy, self.cage_xy)
            todo[idx] = norm(xy[idx] - ant_xy[idx]) <= self.min_spawn_distance
        return torch.cat([xy, torch.full_like(xy[:, :1], 0.5)], dim=-1)

    def step(self, state: State, action: torch.Tensor) -> State:
        qp, info = self.sys.step(state.qp, action)
        dead, reward = dead_and_reward(qp, self.torso_idx, self.dying_cost)
        rng, tgt_pos = self._step_target(
            state.info["rng"], qp.pos[:, self.torso_idx, :2], qp.pos[:, self.target_idx, :2])
        pos = qp.pos.clone()
        pos[:, self.target_idx] = tgt_pos
        qp = qp.replace(pos=pos)
        obs = self._get_obs(qp, info)
        tagged = norm(pos[:, self.torso_idx, :2] - pos[:, self.target_idx, :2]) <= self.tag_radius
        done = tagged.to(torch.float32)
        reward = torch.where(tagged, torch.ones_like(reward), reward)
        return state.replace(
            qp=qp, obs=obs, reward=reward, done=((dead > 0) | tagged).to(torch.float32),
            metrics={**state.metrics, "hits": done}, info={**state.info, "rng": rng})

    def _step_target(self, rng, ant_xy, tgt_xy) -> Tuple[torch.Tensor, torch.Tensor]:
        """Adversary: one of {2 perpendiculars, flee, stay}, reverting moves
        that leave the cage.

        HAZARD (parity with the reference): if the ant torso sits exactly on
        the target, norm(t2a) is 0 and the division yields NaN, which
        propagates into the target position. Unreachable at the default
        tag_radius=1.5 (the episode ends first); kept as-is because the
        divide is part of the fixed-seed replay surface."""
        rng, rng1 = jr.split(rng, 2).unbind(-2)
        choice = jr.randint(rng1, (), 0, 4).long()
        t2a = ant_xy - tgt_xy
        t2a = t2a / norm(t2a)[:, None]
        tx, ty = t2a.unbind(-1)
        per_vec_1 = torch.stack([ty, -tx], -1)
        per_vec_2 = torch.stack([-ty, tx], -1)
        vec_list = torch.stack([per_vec_1, per_vec_2, -t2a, torch.zeros_like(t2a)], 1)
        move = vec_list[torch.arange(vec_list.shape[0], device=vec_list.device), choice]
        new_xy = move * self.target_step + tgt_xy
        out = (torch.abs(new_xy) > self.cage_xy).any(-1, keepdim=True)
        new_xy = torch.where(out, tgt_xy, new_xy)
        # target z pinned to 1.0 after stepping — reference quirk
        return rng, torch.cat([new_xy, torch.ones_like(new_xy[:, :1])], dim=-1)

    def _get_obs(self, qp: QP, info: Info) -> torch.Tensor:
        """Core ant obs + target xy zeroed outside visible_radius."""
        target_xy = qp.pos[:, self.target_idx, :2]
        ant_xy = qp.pos[:, self.torso_idx, :2]
        visible = (norm(target_xy - ant_xy) <= self.visible_radius)[:, None]
        target_xy = torch.where(visible, target_xy, torch.zeros_like(target_xy))
        return torch.cat(ant_full_obs(self.sys, qp, info) + [target_xy], dim=-1)
