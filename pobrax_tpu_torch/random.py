"""threefry2x32 random numbers that match `jax.random` bit for bit.

The JAX package seeds resets, the AntTag adversary and autoreset with
`jax.random` (threefry2x32 with `jax_threefry_partitionable=True`, as
jax 0.9 runs it). Its fixtures and goldens are therefore replayable only by
a generator that reproduces those bits exactly; this module is that
generator, for the few functions the ported path uses: `PRNGKey`, `split`,
`fold_in`, `uniform`, `normal`, `truncated_normal`, `randint`, `gumbel`,
`categorical` with replacement, and `permutation` and `choice` without
replacement (and `random_bits` beneath them).

Keys are int64 tensors whose last axis holds the two uint32 words of a JAX
key (values in [0, 2**32)); any leading axes are batch axes, so
`split(keys, 2)` on a (B, 2) batch of keys gives (B, 2, 2) — what
`vmap(lambda k: jax.random.split(k, 2))` gives. The uint32 arithmetic runs in
int64 with `& 0xFFFFFFFF`, because CPU torch's uint32 support is thin.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

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


Block = Optional[Tuple[int, int, int]]


def _counters(shape: Sequence[int], device, block: Block = None) -> torch.Tensor:
    # the low word of a flat iota over `shape`; the high word is 0 for every
    # size this module is used at (< 2**32 draws). With block = (axis, i, n),
    # `shape` is block i of n equal blocks along `axis` of the global shape,
    # and the counters are that block's part of the global iota
    shape = tuple(int(d) for d in shape)
    full = list(shape)
    if block is not None:
        axis, index, count = block
        full[axis] *= count
    n = 1
    for d in full:
        n *= d
    iota = torch.arange(n, dtype=torch.int64, device=device).reshape(full)
    if block is not None:
        iota = iota.narrow(axis, index * shape[axis], shape[axis])
    return iota


def _bits_pair(key: torch.Tensor, shape: Sequence[int], block: Block = None):
    expand = (Ellipsis,) + (None,) * len(shape)
    k1 = key[..., 0][expand]
    k2 = key[..., 1][expand]
    lo = _counters(shape, key.device, block)
    return threefry2x32(k1, k2, torch.zeros_like(lo), lo)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """`jax.random.split`: (..., 2) keys -> (..., num, 2) keys."""
    b1, b2 = _bits_pair(key, (num,))
    return torch.stack([b1, b2], dim=-1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """`jax.random.fold_in(key, data)` for a data word in [0, 2**32): the
    block cipher of `key` over the counter pair (0, data)."""
    x0, x1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(key[..., 0]),
                          torch.full_like(key[..., 1], int(data) & _MASK))
    return torch.stack([x0, x1], dim=-1)


def random_bits(key: torch.Tensor, shape: Sequence[int] = (), block: Block = None) -> torch.Tensor:
    """32 random bits per element, (..., *shape), values in [0, 2**32).
    `block` = (axis, i, n): the draw is block i of n along `axis` of the
    draw of the global shape (shape[axis] * n there), bit for bit; only the
    block is computed."""
    b1, b2 = _bits_pair(key, shape, block)
    return b1 ^ b2


def _bound(v, device) -> torch.Tensor:
    """A float32 bound on `device`, made there (a Python number copied from
    the host would make the stream wait on every draw)."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float32)
    if isinstance(v, (int, float)):
        return torch.full((), float(v), dtype=torch.float32, device=device)
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def uniform(key: torch.Tensor, shape: Sequence[int] = (), minval=0.0, maxval=1.0,
            block: Block = None) -> torch.Tensor:
    """`jax.random.uniform` in float32; `minval`/`maxval` broadcast against
    `shape` (trailing axes), as in jax. `block`: see `random_bits`."""
    bits = random_bits(key, shape, block)
    # 23 random mantissa bits under the exponent of 1.0 -> [1, 2) -> [0, 1)
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = fbits.view(torch.float32) - 1.0
    lo, hi = _bound(minval, key.device), _bound(maxval, key.device)
    # XLA contracts `floats * span + lo` into one fused multiply-add; the
    # float32 product is exact in float64, so one float64 sum rounded to
    # float32 reproduces the fused result
    scaled = (floats.double() * (hi - lo).double() + lo.double()).float()
    return torch.maximum(lo, scaled)


# XLA's single-precision ErfInv (Giles' polynomial in w = -log1p(-x^2)), the
# coefficients for w < 5 and for w >= 5, highest degree first
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
               -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
               -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)
_NORMAL_LO = -0.99999994  # nextafter(-1, 0) in float32
_SQRT2 = 1.4142135381698608  # sqrt(2) rounded to float32, as jax multiplies


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ErfInv for |x| < 1. Each Horner step is a fused
    multiply-add, reproduced as a float64 step rounded to float32; log1p and
    sqrt may differ from XLA's by an ulp, so the result agrees with
    `jax.scipy.special.erfinv` to within 1e-6, not bit for bit."""
    w = -torch.log1p(-x * x)
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0).double()
    p = torch.zeros_like(w)
    for lt5, ge5 in zip(_ERFINV_LT5, _ERFINV_GE5):
        c = torch.where(small, lt5, ge5).double()
        p = (c + p * w).float().double()
    return p.float() * x


def normal(key: torch.Tensor, shape: Sequence[int] = (), block: Block = None) -> torch.Tensor:
    """`jax.random.normal` in float32: sqrt(2) erfinv(u) for u uniform on
    [nextafter(-1, 0), 1). The uniform draw is bit-exact; the result agrees
    with jax to <= 1e-6 (see `erf_inv`). `block`: see `random_bits` (a
    rank's rows of a draw over every rank's)."""
    u = uniform(key, shape, _NORMAL_LO, 1.0, block)
    return _SQRT2 * erf_inv(u)


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


_TINY = 1.1754943508222875e-38  # float32's smallest normal, jnp.finfo(float32).tiny


def gumbel(key: torch.Tensor, shape: Sequence[int] = ()) -> torch.Tensor:
    """`jax.random.gumbel` in float32, jax's default mode "low":
    -log(-log(u)) for u uniform on [tiny, 1). The uniform draw is bit-exact;
    torch's log may differ from XLA's by an ulp."""
    u = uniform(key, shape, _TINY, 1.0)
    return -torch.log(-torch.log(u))


def categorical(key: torch.Tensor, logits: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """`jax.random.categorical(key, logits, shape=shape)` for 1-D logits
    (N,), with replacement: the argmax over N of gumbel noise of shape
    (*shape, N) added to the logits; int64 indices of `shape`."""
    noise = gumbel(key, tuple(shape) + (logits.shape[-1],))
    return torch.argmax(noise + logits, dim=-1)


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """`jax.random.permutation(key, n)`: a permutation of range(n) per key,
    (..., n) int64. jax's `_shuffle` runs ceil(3 ln n / ln(2**32 - 1))
    rounds (one for n up to ~1600), each splitting the key into (key,
    subkey), drawing 32 bits per element from the subkey and sorting the
    elements by them, stably. The bits sort as int64, so keys at 2**31 and
    above keep their unsigned order."""
    n = int(n)
    perm = torch.arange(n, device=key.device).expand(key.shape[:-1] + (n,))
    rounds = int(math.ceil(3 * math.log(max(1, n)) / math.log(_MASK)))
    for _ in range(rounds):
        key, sub = split(key, 2).unbind(-2)
        order = torch.sort(random_bits(sub, (n,)), dim=-1, stable=True).indices
        perm = torch.gather(perm, -1, order)
    return perm


def choice(key: torch.Tensor, a: torch.Tensor, n_draws: int) -> torch.Tensor:
    """`jax.random.choice(key, a, (n_draws,), replace=False)` over the first
    axis of `a`: the first `n_draws` rows of `a` in `permutation` order,
    (..., n_draws) + a.shape[1:]. Sampling with replacement is not ported."""
    if n_draws > a.shape[0]:
        raise ValueError(f"cannot draw {n_draws} of {a.shape[0]} without replacement")
    return a[permutation(key, a.shape[0])[..., :n_draws]]


def truncated_normal(key: torch.Tensor, lower: float, upper: float,
                     shape: Sequence[int] = ()) -> torch.Tensor:
    """`jax.random.truncated_normal` in float32: sqrt(2) erfinv(u) for u
    uniform between erf(lower / sqrt 2) and erf(upper / sqrt 2), clipped
    inside (lower, upper)."""
    a = math.erf(lower / math.sqrt(2.0))
    b = math.erf(upper / math.sqrt(2.0))
    out = _SQRT2 * erf_inv(uniform(key, shape, a, b))
    lo = torch.nextafter(torch.tensor(float(lower)), torch.tensor(math.inf)).item()
    hi = torch.nextafter(torch.tensor(float(upper)), torch.tensor(-math.inf)).item()
    return out.clamp(lo, hi)
