"""The 'fast' debug env; the port of `pobrax_tpu/envs/fast.py`, natively
batched.

No contacts, no joints: one body drifts along x under a bang-bang velocity
command (+dt where action[0] > 0, else -dt). The learner tests train on it
at near-zero physics cost.
"""

from __future__ import annotations

import torch

from pobrax_tpu_torch.envs.base import Env, State
from pobrax_tpu_torch.physics import config as pcfg
from pobrax_tpu_torch.physics.state import QP


class Fast(Env):
    def __init__(self, device=None, info: str = "full"):
        super().__init__(pcfg.Config(bodies=(pcfg.Body(name="body"),), dt=0.02, substeps=1),
                         device, info)

    def reset(self, rng: torch.Tensor) -> State:
        """(B, 2) keys -> B bodies at rest at the origin."""
        batch = rng.shape[0]
        zeros3 = torch.zeros(batch, 1, 3, device=rng.device)
        rot = torch.zeros(batch, 1, 4, device=rng.device)
        rot[..., 0] = 1.0
        qp = QP(pos=zeros3, rot=rot, vel=zeros3.clone(), ang=zeros3.clone())
        zero = torch.zeros(batch, device=rng.device)
        return State(qp, torch.zeros(batch, 2, device=rng.device), zero, zero.clone(), {},
                     {"rng": rng})

    def step(self, state: State, action: torch.Tensor) -> State:
        dt = self.sys.config.dt
        dvx = torch.where(action[:, 0] > 0.0, dt, -dt)
        vel = state.qp.vel.clone()
        vel[:, 0, 0] += dvx
        pos = state.qp.pos + vel * dt
        qp = state.qp.replace(pos=pos, vel=vel)
        obs = torch.stack([pos[:, 0, 0], vel[:, 0, 0]], dim=-1)
        return state.replace(qp=qp, obs=obs, reward=pos[:, 0, 0],
                             done=torch.zeros_like(state.done))

    @property
    def observation_size(self) -> int:
        return 2

    @property
    def action_size(self) -> int:
        return 1
