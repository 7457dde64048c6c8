"""Count-based exploration bonus as a training-time wrapper; the port of
`pobrax_tpu/envs/exploration.py`.

`GridNoveltyBonusWrapper` adds beta / sqrt(N(cell)) on a coarse torso-xy
grid (the MBIE-EB form), AntGather's training-time shaping. The per-env
count grid lives in `state.info['visit_counts']`, (B, G, G); the torso's cell
is a one-hot grid, the update a multiply-add and the read a masked sum, as in
JAX. Counts decay (`halflife_steps`) instead of resetting at episode
boundaries. With `bomb_memory > 0` a second grid, `info['bomb_cells']`,
marks the cells where the wrapped env's `metrics['bombs']` fired; standing in
a marked cell costs `bomb_memory` per step, and the marks never decay.

Training-time shaping: evaluate on the unwrapped env.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from pobrax_tpu_torch.envs.base import State, Wrapper


class GridNoveltyBonusWrapper(Wrapper):
    """r' = r + beta / sqrt(N(cell(torso_xy))) with decayed visit counts.

    Args:
      env: an env exposing `torso_idx` (or pass torso_idx).
      beta: bonus scale; 0 disables the bonus.
      half_extent: the grid covers [-half_extent, half_extent]^2 in xy.
      grid: cells per side.
      halflife_steps: visit-count half-life in env steps; None / inf keeps
        counts forever.
      bomb_memory: per-step penalty for occupying a cell where a bomb was
        hit; 0 disables the danger grid.
    """

    def __init__(self, env, beta: float = 0.25, half_extent: float = 10.0,
                 grid: int = 16, halflife_steps: Optional[float] = 500.0,
                 torso_idx: Optional[int] = None, bomb_memory: float = 0.0):
        super().__init__(env)
        if beta < 0:
            raise ValueError("beta must be >= 0")
        if bomb_memory < 0:
            raise ValueError("bomb_memory must be >= 0")
        self.beta = float(beta)
        self.bomb_memory = float(bomb_memory)
        self.half_extent = float(half_extent)
        self.grid = int(grid)
        self.cell = 2.0 * self.half_extent / self.grid
        self.decay = (1.0 if not halflife_steps or math.isinf(halflife_steps)
                      else 0.5 ** (1.0 / float(halflife_steps)))
        self.torso_idx = (getattr(env.unwrapped, "torso_idx", 0)
                          if torso_idx is None else int(torso_idx))

    def _onehot_cell(self, qp) -> torch.Tensor:
        """(B, G, G) one-hot grid of the torso's cell, clipped to the border
        cells outside the extent."""
        xy = qp.pos[:, self.torso_idx, :2]
        ij = torch.clamp(torch.floor((xy + self.half_extent) / self.cell),
                         0, self.grid - 1).to(torch.int32)
        ar = torch.arange(self.grid, device=xy.device)
        oi = (ar == ij[:, :1]).to(torch.float32)
        oj = (ar == ij[:, 1:]).to(torch.float32)
        return oi[:, :, None] * oj[:, None, :]

    def reset(self, rng: torch.Tensor) -> State:
        state = self.env.reset(rng)
        zeros = torch.zeros(state.reward.shape + (self.grid, self.grid),
                            device=state.reward.device)
        info = {**state.info, "visit_counts": zeros}
        if self.bomb_memory > 0.0:
            info["bomb_cells"] = zeros.clone()
        return state.replace(info=info)

    def step(self, state: State, action: torch.Tensor) -> State:
        nstate = self.env.step(state, action)
        onehot = self._onehot_cell(nstate.qp)
        counts = state.info["visit_counts"] * self.decay + onehot
        n_here = (counts * onehot).sum((-2, -1))  # masked sum, not a gather
        bonus = self.beta / torch.sqrt(torch.clamp(n_here, min=1.0))
        info = {**nstate.info, "visit_counts": counts}
        if self.bomb_memory > 0.0:
            # metrics['bombs'] is the wrapped env's per-step bomb-hit count
            hit = nstate.metrics.get("bombs", torch.zeros_like(nstate.reward))
            bomb_cells = torch.maximum(state.info["bomb_cells"],
                                       onehot * torch.clamp(hit, max=1.0)[:, None, None])
            in_danger = (bomb_cells * onehot).sum((-2, -1))
            bonus = bonus - self.bomb_memory * torch.clamp(in_danger, max=1.0)
            info["bomb_cells"] = bomb_cells
        return nstate.replace(reward=nstate.reward + bonus, info=info)
