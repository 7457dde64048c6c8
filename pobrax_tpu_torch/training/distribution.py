"""Tanh-squashed diagonal normal over the action box; the port of
`pobrax_tpu/training/distribution.py`.

Parameterised by the policy's output, 2 * action_size values (loc,
pre-softplus scale); every method works over any leading batch axes. Samples
draw from `pobrax_tpu_torch.random.normal`, so a key gives jax's sample.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from pobrax_tpu_torch import random as jr

_LOG_2PI = math.log(2.0 * math.pi)
_LOG_2 = math.log(2.0)


@dataclasses.dataclass(frozen=True)
class NormalTanhDistribution:
    """tanh(Normal(loc, scale)) with a stable log-prob correction."""

    event_size: int
    min_std: float = 0.001

    @property
    def param_size(self) -> int:
        return 2 * self.event_size

    def _split(self, params: torch.Tensor):
        loc, scale = params.chunk(2, dim=-1)
        return loc, F.softplus(scale) + self.min_std

    def sample_no_postprocess(self, params: torch.Tensor, key: torch.Tensor,
                              block=None) -> torch.Tensor:
        """Pre-tanh sample (the value whose log-prob is cheap to evaluate).
        `block` = (axis, i, n): `params` is block i of n along `axis` of a
        global batch, and the noise is that block of the global draw
        (`random.normal`)."""
        loc, scale = self._split(params)
        return loc + scale * jr.normal(key, loc.shape, block)

    def sample(self, params: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
        return self.postprocess(self.sample_no_postprocess(params, key))

    def mode(self, params: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self._split(params)[0])

    def postprocess(self, pre_tanh: torch.Tensor) -> torch.Tensor:
        return torch.tanh(pre_tanh)

    @staticmethod
    def _log_det_tanh(x: torch.Tensor) -> torch.Tensor:
        # log(1 - tanh(x)^2) = 2 (log 2 - x - softplus(-2x))
        return 2.0 * (_LOG_2 - x - F.softplus(-2.0 * x))

    def log_prob(self, params: torch.Tensor, pre_tanh: torch.Tensor) -> torch.Tensor:
        """log p(tanh(x)) for a pre-tanh sample x, summed over the event axis."""
        loc, scale = self._split(params)
        base = -0.5 * torch.square((pre_tanh - loc) / scale) - torch.log(scale) - 0.5 * _LOG_2PI
        return torch.sum(base - self._log_det_tanh(pre_tanh), dim=-1)

    def entropy(self, params: torch.Tensor, key: torch.Tensor, block=None) -> torch.Tensor:
        """Analytic normal entropy plus a sampled tanh correction (`block`:
        see `sample_no_postprocess`)."""
        loc, scale = self._split(params)
        normal_ent = 0.5 * math.log(2.0 * math.pi * math.e) + torch.log(scale)
        x = loc + scale * jr.normal(key, loc.shape, block)
        return torch.sum(normal_ent + self._log_det_tanh(x), dim=-1)
