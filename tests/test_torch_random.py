"""pobrax_tpu_torch.random against jax.random, bit for bit.

Every draw the ported AntTag path makes: `split` into 5 and into a batch,
uniform (8,) and (2,) with array bounds, randint((), 0, 4), and the per-env
split(r, 2) of the autoreset wrappers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pobrax_tpu_torch import random as jr

SEEDS = [0, 1, 7, 42, 123456789]
CAGE = np.array([4.5, 4.5], np.float32)


def _keys(seed):
    return jax.random.PRNGKey(seed), jr.PRNGKey(seed)


def _eq_keys(jk, tk):
    np.testing.assert_array_equal(np.asarray(jk).astype(np.int64), tk.numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey_and_split(seed):
    jk, tk = _keys(seed)
    _eq_keys(jk, tk)
    _eq_keys(jax.random.split(jk, 5), jr.split(tk, 5))
    _eq_keys(jax.random.split(jk, 4096), jr.split(tk, 4096))
    # per-env split(r, 2), batched over a leading key axis (wrappers.py:160)
    batch_j = jax.random.split(jk, 64)
    batch_t = jr.split(tk, 64)
    _eq_keys(jax.vmap(lambda r: jax.random.split(r, 2))(batch_j), jr.split(batch_t, 2))


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform(seed):
    jk, tk = _keys(seed)
    cases = [((8,), -0.1, 0.1), ((2,), -CAGE, CAGE), ((3, 5), 0.0, 1.0), ((1000,), -1.0, 1.0)]
    for shape, lo, hi in cases:
        want = np.asarray(jax.random.uniform(jk, shape, minval=lo, maxval=hi))
        np.testing.assert_array_equal(jr.uniform(tk, shape, lo, hi).numpy(), want)
    # batched over keys, as the env draws them
    bj, bt = jax.random.split(jk, 16), jr.split(tk, 16)
    want = np.asarray(jax.vmap(
        lambda k: jax.random.uniform(k, (2,), minval=-CAGE, maxval=CAGE))(bj))
    np.testing.assert_array_equal(jr.uniform(bt, (2,), -CAGE, CAGE).numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
def test_randint(seed):
    jk, tk = _keys(seed)
    bj, bt = jax.random.split(jk, 256), jr.split(tk, 256)
    for lo, hi in [(0, 4), (0, 7), (-3, 10), (0, 2 ** 31 - 1)]:
        want = np.asarray(jax.vmap(lambda k: jax.random.randint(k, (), lo, hi))(bj))
        got = jr.randint(bt, (), lo, hi)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    want = np.asarray(jax.random.randint(jk, (5, 3), 0, 4))
    np.testing.assert_array_equal(jr.randint(tk, (5, 3), 0, 4).numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
def test_rejection_chain(seed):
    """The AntTag spawn loop's key chain: `_, k = split(k, 2)`, then a draw."""
    jk, tk = _keys(seed)
    for _ in range(5):
        jk = jax.random.split(jk, 2)[1]
        tk = jr.split(tk, 2)[1]
        want = np.asarray(jax.random.uniform(jk, (2,), minval=-CAGE, maxval=CAGE))
        np.testing.assert_array_equal(jr.uniform(tk, (2,), -CAGE, CAGE).numpy(), want)
    assert jnp.asarray(jk).dtype == jnp.uint32
