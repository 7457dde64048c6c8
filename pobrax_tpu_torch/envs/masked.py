"""Observation masking: turn any env into a PO variant; the port of
`pobrax_tpu/envs/masked.py`.

The mask is applied on every reset and step as one elementwise select on
the device, so a masked env costs one `torch.where` on top of the base env.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from pobrax_tpu_torch.envs.base import Env, State, Wrapper
from pobrax_tpu_torch.envs.masks import segment_mask


class MaskedObservationWrapper(Wrapper):
    """Zeroes hidden observation segments on every reset/step.

    Either pass `mask` (boolean keep-mask over the obs vector) or
    `env_name` + `hidden` segment names resolved via the standard tables.
    """

    def __init__(self, env: Env, mask: Optional[np.ndarray] = None,
                 env_name: Optional[str] = None,
                 hidden: Sequence[str] = ("VELOCITY",)):
        super().__init__(env)
        if mask is None:
            if env_name is None:
                raise ValueError("need either mask or env_name")
            mask = segment_mask(env_name, env.observation_size, hidden)
        self._mask = torch.as_tensor(np.asarray(mask, bool), device=env.device)

    def _apply(self, state: State) -> State:
        return state.replace(obs=torch.where(self._mask, state.obs, 0.0))

    def reset(self, rng: torch.Tensor) -> State:
        return self._apply(self.env.reset(rng))

    def step(self, state: State, action: torch.Tensor) -> State:
        return self._apply(self.env.step(state, action))
