"""threefry2x32 random numbers that match `jax.random` bit for bit.

The JAX package seeds resets, the AntTag adversary and autoreset with
`jax.random` (threefry2x32 with `jax_threefry_partitionable=True`, as
jax 0.9 runs it). Its fixtures and goldens are therefore replayable only by
a generator that reproduces those bits exactly; this module is that
generator, for the few functions the ported path uses: `PRNGKey`, `split`,
`uniform`, `randint` (and `random_bits` beneath them).

Keys are int64 tensors whose last axis holds the two uint32 words of a JAX
key (values in [0, 2**32)); any leading axes are batch axes, so
`split(keys, 2)` on a (B, 2) batch of keys gives (B, 2, 2) — what
`vmap(lambda k: jax.random.split(k, 2))` gives. The uint32 arithmetic runs in
int64 with `& 0xFFFFFFFF`, because CPU torch's uint32 support is thin.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1, k2, x0, x1):
    """The Threefry-2x32 block cipher, 20 rounds (Salmon et al. 2011), as
    jax's `threefry2x32_p` computes it; all arguments broadcast."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def PRNGKey(seed: int, device: Optional[Union[str, torch.device]] = None) -> torch.Tensor:
    """`jax.random.PRNGKey(seed)` for a seed in the int32 range: (2,) int64."""
    if not -2 ** 31 <= int(seed) < 2 ** 31:
        raise ValueError(f"seed must fit in int32, got {seed}")
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64, device=device)


def _counters(shape: Sequence[int], device) -> torch.Tensor:
    # the low word of a flat iota over `shape`; the high word is 0 for every
    # size this module is used at (< 2**32 draws)
    n = 1
    for d in shape:
        n *= int(d)
    return torch.arange(n, dtype=torch.int64, device=device).reshape(tuple(shape))


def _bits_pair(key: torch.Tensor, shape: Sequence[int]):
    expand = (Ellipsis,) + (None,) * len(shape)
    k1 = key[..., 0][expand]
    k2 = key[..., 1][expand]
    lo = _counters(shape, key.device)
    return threefry2x32(k1, k2, torch.zeros_like(lo), lo)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """`jax.random.split`: (..., 2) keys -> (..., num, 2) keys."""
    b1, b2 = _bits_pair(key, (num,))
    return torch.stack([b1, b2], dim=-1)


def random_bits(key: torch.Tensor, shape: Sequence[int] = ()) -> torch.Tensor:
    """32 random bits per element, (..., *shape), values in [0, 2**32)."""
    b1, b2 = _bits_pair(key, shape)
    return b1 ^ b2


def _bound(v, device) -> torch.Tensor:
    """A float32 bound on `device`, made there (a Python number copied from
    the host would make the stream wait on every draw)."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float32)
    if isinstance(v, (int, float)):
        return torch.full((), float(v), dtype=torch.float32, device=device)
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def uniform(key: torch.Tensor, shape: Sequence[int] = (), minval=0.0, maxval=1.0) -> torch.Tensor:
    """`jax.random.uniform` in float32; `minval`/`maxval` broadcast against
    `shape` (trailing axes), as in jax."""
    bits = random_bits(key, shape)
    # 23 random mantissa bits under the exponent of 1.0 -> [1, 2) -> [0, 1)
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = fbits.view(torch.float32) - 1.0
    lo, hi = _bound(minval, key.device), _bound(maxval, key.device)
    # XLA contracts `floats * span + lo` into one fused multiply-add; the
    # float32 product is exact in float64, so one float64 sum rounded to
    # float32 reproduces the fused result
    scaled = (floats.double() * (hi - lo).double() + lo.double()).float()
    return torch.maximum(lo, scaled)


def _mul32(a: torch.Tensor, m: int) -> torch.Tensor:
    """(a * m) mod 2**32 for a, m in [0, 2**32), without int64 overflow."""
    lo = a * (m & 0xFFFF)
    hi = ((a * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def randint(key: torch.Tensor, shape: Sequence[int], minval: int, maxval: int) -> torch.Tensor:
    """`jax.random.randint` with int32 output and Python-int bounds."""
    keys = split(key, 2)
    higher = random_bits(keys[..., 0, :], shape)
    lower = random_bits(keys[..., 1, :], shape)
    span = (int(maxval) - int(minval)) & _MASK
    if maxval <= minval:
        span = 1
    # (a * 2**32 + b) mod span, from 64 random bits (jax's bias-reducing form)
    multiplier = (2 ** 16) % span
    multiplier = ((multiplier * multiplier) & _MASK) % span  # uint32 wrap
    offset = (_mul32(higher % span, multiplier) + lower % span) & _MASK
    offset = offset % span
    return (offset + int(minval)).to(torch.int32)
