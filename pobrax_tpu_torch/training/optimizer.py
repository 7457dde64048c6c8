"""Clip-by-global-norm + Adam over one flat vector: what the JAX learners
build as `optax.chain(optax.clip_by_global_norm(max_norm), optax.adam(lr))`
(`ppo.py:221-234`), written out with optax's formulas.

The update concatenates the gradients of every parameter (in
`module.parameters()` order) into one vector, clips it as optax does
(`g * max_norm / |g|` only where `|g| >= max_norm`, no epsilon), runs
Adam's moments and bias correction on it, and adds the result to the
parameters in place. `AdamState.mu` / `nu` are that flat vector's moments;
`pobrax_tpu_torch.interop` maps them to and from the JAX package's layout.
Under a mesh the vector is averaged over the ranks first, in one
all-reduce before the clip: what JAX's gradient psum under a 'data'-sharded
jit, or its `pmean` under `shard_map`, gives the optimizer.

Whether JAX wraps the chain in `optax.flatten` (`flatten_optimizer=True`,
the default) or runs it leaf by leaf, Adam's per-element math is the same
and the clip's norm is the same sum of squares, up to the order it is
added in (the rows the flax model lacks, the GRU's r and z recurrent
biases, have zero gradients). So one update serves both; `AdamState.per_leaf` only says which
layout the moments take when they cross to JAX: one flat vector, or
parameter-shaped trees.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch import nn

from pobrax_tpu_torch.parallel.mesh import pmean


def _bias_correction(decay: float, count: int) -> float:
    """1 - decay**count in float32, as optax computes it: for the second
    moment this is a difference of nearby numbers, so float64 would give
    another update in the first steps."""
    return float(np.float32(1) - np.float32(decay) ** np.float32(count))


@dataclass
class AdamState:
    count: int           # updates taken (optax's `count`)
    mu: torch.Tensor     # first moment, flat over the parameters
    nu: torch.Tensor     # second moment, flat
    per_leaf: bool = False  # JAX's moments are parameter-shaped trees, not one vector


class Optimizer:
    def __init__(self, learning_rate: float, max_grad_norm: Optional[float] = None,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, per_leaf: bool = False):
        self.learning_rate = learning_rate
        self.max_grad_norm = max_grad_norm
        self.b1, self.b2, self.eps = b1, b2, eps
        self.per_leaf = per_leaf

    def init(self, module: nn.Module) -> AdamState:
        p = next(module.parameters())
        n = sum(q.numel() for q in module.parameters())
        return AdamState(count=0, mu=torch.zeros(n, device=p.device),
                         nu=torch.zeros(n, device=p.device), per_leaf=self.per_leaf)

    def step(self, module: nn.Module, state: AdamState, mesh=None) -> AdamState:
        """Apply one update from the parameters' `.grad` (missing grads count
        as zero) and return the new state; with a `mesh`, from their mean
        over its ranks."""
        params = list(module.parameters())
        g = pmean(torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                             for p in params]), mesh)
        if self.max_grad_norm is not None:
            g_norm = torch.sqrt(torch.sum(g * g))
            clip = g_norm >= self.max_grad_norm
            g = torch.where(clip, g / g_norm * self.max_grad_norm, g)
        mu = (1 - self.b1) * g + self.b1 * state.mu
        nu = (1 - self.b2) * (g * g) + self.b2 * state.nu
        count = state.count + 1
        mu_hat = mu / _bias_correction(self.b1, count)
        nu_hat = nu / _bias_correction(self.b2, count)
        update = -self.learning_rate * (mu_hat / (torch.sqrt(nu_hat) + self.eps))
        with torch.no_grad():
            torch._foreach_add_(params, [u.view_as(p) for u, p in
                                         zip(update.split([p.numel() for p in params]), params)])
        return AdamState(count=count, mu=mu, nu=nu, per_leaf=state.per_leaf)
