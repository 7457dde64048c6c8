"""Acrobot: 2-link underactuated swing-up; the port of
`pobrax_tpu/envs/acrobot.py`, natively batched, with its own numpy copy of
`acrobot_config` (tests/test_torch_planar.py holds the two configs equal).

The reference's mask tables include an 'acrobot' entry
(po-brax po_brax/standard_observability_masks.py:6,23) with no env behind
it anywhere (brax v0 never shipped one). This env backs the entry: a
fixed-base 2-link pendulum actuated only at the elbow, obs layout matching
the table — POSITION [0,2) = joint angles, VELOCITY [2,4) = joint
velocities. Reward: tip height above the base minus 1 (classic swing-up
shaping); done when the tip passes above 1.8. The frozen base has no
collider and the links collide with nothing: the System has no contact row.
"""

from __future__ import annotations

import torch

from pobrax_tpu_torch import random as jr
from pobrax_tpu_torch.envs.base import Env, State
from pobrax_tpu_torch.ops import quaternion as quat
from pobrax_tpu_torch.physics import config as c
from pobrax_tpu_torch.physics.state import QP

_HINGE_Y = (0.0, 0.0, 90.0)
_LINK_LEN = 1.0


def acrobot_config() -> c.Config:
    def link(name):
        return c.Body(
            name=name,
            colliders=(c.Collider(geom=c.Capsule(radius=0.05, length=_LINK_LEN)),),
            mass=1.0,
            frozen_position=(0.0, 1.0, 0.0),
            frozen_rotation=(1.0, 0.0, 1.0),
        )

    def hinge(name, parent, child, p_off):
        return c.Joint(
            name=name, parent=parent, child=child,
            stiffness=4000.0, spring_damping=126.0, angular_damping=0.5,
            parent_offset=p_off, child_offset=(0.0, 0.0, 0.5 * _LINK_LEN),
            rotation=_HINGE_Y,
            angle_limits=(c.AngleLimit(-360.0, 360.0),),
            limit_strength=0.0,
        )

    return c.Config(
        bodies=(c.Body(name="base", frozen=True), link("link1"), link("link2")),
        joints=(
            hinge("shoulder", "base", "link1", (0.0, 0.0, 0.0)),
            hinge("elbow", "link1", "link2", (0.0, 0.0, -0.5 * _LINK_LEN)),
        ),
        # underactuated: torque only at the elbow
        actuators=(c.Actuator(name="elbow", joint="elbow", strength=30.0),),
        default_qps=(c.DefaultQP(name="base", pos=(0.0, 0.0, 2.5)),),
        gravity=(0.0, 0.0, -9.8),
        dt=0.04, substeps=12,
    )


class Acrobot(Env):
    def __init__(self, device=None, info: str = "full", **kwargs):
        super().__init__(acrobot_config(), device, info)
        self.link2 = self.sys.body.index["link2"]
        self.base = self.sys.body.index["base"]
        self._tip_offset = torch.tensor([0.0, 0.0, -0.5 * _LINK_LEN], device=self.device)

    @property
    def observation_size(self) -> int:
        return 4

    def reset(self, rng: torch.Tensor) -> State:
        """(B, 2) keys -> a batch of B episodes hanging down (the zero pose:
        child_offset +0.5L puts link centers below their anchors at angle 0)
        with small jitter; pi would be the inverted goal configuration."""
        rng, rng1, rng2 = jr.split(rng, 3).unbind(-2)
        qpos = jr.uniform(rng1, (2,), -0.1, 0.1)
        qvel = jr.uniform(rng2, (2,), -0.1, 0.1)
        qp = self.sys.default_qp(joint_angle=qpos, joint_velocity=qvel)
        obs = self._get_obs(qp)
        zero = torch.zeros(rng.shape[0], device=rng.device)
        return State(qp, obs, zero, zero.clone(), {"tip_height": zero.clone()}, {"rng": rng})

    def _tip(self, qp: QP) -> torch.Tensor:
        rot = qp.rot[:, self.link2]
        return qp.pos[:, self.link2] + quat.rotate(self._tip_offset.expand(rot.shape[0], 3), rot)

    def _get_obs(self, qp: QP) -> torch.Tensor:
        (a,), (v,) = self.sys.joints[0].angle_vel(qp)
        return torch.cat([a, v], dim=-1)  # POSITION [0,2), VELOCITY [2,4)

    def step(self, state: State, action: torch.Tensor) -> State:
        qp, _ = self.sys.step(state.qp, action)
        obs = self._get_obs(qp)
        tip_h = self._tip(qp)[:, 2] - qp.pos[:, self.base, 2]  # in [-2, 2]
        reward = tip_h - 1.0  # height shaping on top of the classic -1/step
        done = (tip_h > 1.8).to(torch.float32)
        return state.replace(qp=qp, obs=obs, reward=reward, done=done,
                             metrics={**state.metrics, "tip_height": tip_h})
