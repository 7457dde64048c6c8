"""Policy and value networks; the port of `pobrax_tpu/models/networks.py`.

`MLP` (swish by default, `F.silu`), the spectral-normalised `SNDense` and
`SNMLP`, `make_model` and `make_models` (policy [32, 32, 32, 32, P], value
[256 x 5, 1], the reference's sizes). Layers are `nn.Linear`s in
`hidden[i]`, flax's `hidden_{i}`; a torch weight is (out, in), the transpose
of a flax kernel (`pobrax_tpu_torch.interop` carries weights across).

Initialisation draws flax's distributions (lecun-uniform kernels, zero
biases, a standard-normal singular vector) from a threefry key
(`pobrax_tpu_torch.random`), so a seed gives the same network every time; it
does not reproduce flax's own key derivation, so a seed gives other weights
than the JAX package's.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from pobrax_tpu_torch import random as jr
from pobrax_tpu_torch.device import resolve


def _key(key: Optional[torch.Tensor]) -> torch.Tensor:
    return jr.PRNGKey(0) if key is None else key.cpu()


def lecun_uniform(key: torch.Tensor, fan_in: int, fan_out: int) -> torch.Tensor:
    """A torch (out, in) weight drawn as flax's lecun_uniform (in, out) kernel."""
    kernel = jr.uniform(key, (fan_in, fan_out), -1.0, 1.0) * math.sqrt(3.0 / fan_in)
    return kernel.t().contiguous()


def lecun_normal(key: torch.Tensor, fan_in: int, fan_out: int) -> torch.Tensor:
    """A torch (out, in) weight drawn as flax's lecun_normal (in, out) kernel
    (a normal truncated at +-2 standard deviations)."""
    stddev = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    kernel = jr.truncated_normal(key, -2.0, 2.0, (fan_in, fan_out)) * stddev
    return kernel.t().contiguous()


def linear(key: torch.Tensor, fan_in: int, fan_out: int, bias: bool = True,
           init: Callable = lecun_uniform) -> nn.Linear:
    layer = nn.Linear(fan_in, fan_out, bias=bias)
    with torch.no_grad():
        layer.weight.copy_(init(key, fan_in, fan_out))
        if bias:
            layer.bias.zero_()
    return layer


class MLP(nn.Module):
    """Plain MLP: `activation` after every layer but the last (unless
    `activate_final`). `dtype=torch.bfloat16` runs the matmuls, bias adds and
    activations in bfloat16 with float32 parameters, as flax's `dtype`."""

    def __init__(self, layer_sizes: Sequence[int], in_size: int,
                 activation: Callable = F.silu, activate_final: bool = False,
                 bias: bool = True, dtype: Optional[torch.dtype] = None,
                 key: Optional[torch.Tensor] = None, device=None):
        super().__init__()
        keys = jr.split(_key(key), len(layer_sizes))
        sizes = [in_size] + list(layer_sizes)
        self.hidden = nn.ModuleList(linear(keys[i], sizes[i], sizes[i + 1], bias)
                                    for i in range(len(layer_sizes)))
        self.activation = activation
        self.activate_final = activate_final
        self.dtype = dtype
        self.to(resolve(device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = len(self.hidden)
        for i, layer in enumerate(self.hidden):
            if self.dtype is None:
                x = layer(x)
            else:
                bias = None if layer.bias is None else layer.bias.to(self.dtype)
                x = F.linear(x.to(self.dtype), layer.weight.to(self.dtype), bias)
            if i < n - 1 or self.activate_final:
                x = self.activation(x)
        return x


class SNDense(nn.Module):
    """Linear layer with spectral normalisation by power iteration (the JAX
    package's `SNDense`). The singular-vector estimate `u` (1, out) is a
    buffer; every forward refreshes it with `n_steps` power iterations
    (without gradient) and divides the kernel by the resulting sigma."""

    def __init__(self, in_features: int, features: int, bias: bool = True,
                 n_steps: int = 1, eps: float = 1e-4,
                 key: Optional[torch.Tensor] = None, sing_key: Optional[torch.Tensor] = None):
        super().__init__()
        self.weight = nn.Parameter(lecun_uniform(_key(key), in_features, features))
        self.bias = nn.Parameter(torch.zeros(features)) if bias else None
        self.register_buffer("u", jr.normal(_key(sing_key), (1, features)))
        self.n_steps = n_steps
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kernel = self.weight.t()  # flax's (in, out)
        with torch.no_grad():
            u = self.u
            for _ in range(self.n_steps):
                v = u @ kernel.t()
                v = v / torch.clamp(torch.linalg.vector_norm(v), min=self.eps)
                u = v @ kernel
                u = u / torch.clamp(torch.linalg.vector_norm(u), min=self.eps)
            self.u.copy_(u)
        sigma = (v @ kernel @ u.t()).squeeze()
        y = x @ (kernel / sigma)
        return y if self.bias is None else y + self.bias


class SNMLP(nn.Module):
    """MLP with spectral normalisation on every layer; two key streams, one
    for the kernels and one for the singular vectors."""

    def __init__(self, layer_sizes: Sequence[int], in_size: int,
                 activation: Callable = F.silu, activate_final: bool = False,
                 bias: bool = True, key: Optional[torch.Tensor] = None,
                 sing_key: Optional[torch.Tensor] = None, device=None):
        super().__init__()
        keys = jr.split(_key(key), len(layer_sizes))
        sing_keys = jr.split(_key(sing_key), len(layer_sizes))
        sizes = [in_size] + list(layer_sizes)
        self.hidden = nn.ModuleList(
            SNDense(sizes[i], sizes[i + 1], bias, key=keys[i], sing_key=sing_keys[i])
            for i in range(len(layer_sizes)))
        self.activation = activation
        self.activate_final = activate_final
        self.to(resolve(device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = len(self.hidden)
        for i, layer in enumerate(self.hidden):
            x = layer(x)
            if i < n - 1 or self.activate_final:
                x = self.activation(x)
        return x


def make_model(layer_sizes: Sequence[int], obs_size: int, activation: Callable = F.silu,
               spectral_norm: bool = False, dtype: Optional[torch.dtype] = None,
               key: Optional[torch.Tensor] = None, sing_key: Optional[torch.Tensor] = None,
               device=None) -> nn.Module:
    """An `MLP` (or, with `spectral_norm`, an `SNMLP` whose singular vectors
    draw from `sing_key`) on `device` (the card unless named)."""
    if spectral_norm:
        return SNMLP(layer_sizes, obs_size, activation, key=key, sing_key=sing_key,
                     device=device)
    return MLP(layer_sizes, obs_size, activation, dtype=dtype, key=key, device=device)


def make_models(policy_params_size: int, obs_size: int, key: Optional[torch.Tensor] = None,
                device=None) -> Tuple[nn.Module, nn.Module]:
    """Policy and value MLPs with the reference's sizes (networks.py:121-122)."""
    kp, kv = jr.split(_key(key), 2)
    return (make_model([32, 32, 32, 32, policy_params_size], obs_size, key=kp, device=device),
            make_model([256, 256, 256, 256, 256, 1], obs_size, key=kv, device=device))
