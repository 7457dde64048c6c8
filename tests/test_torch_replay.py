"""The port's replay buffer and its random draws against the JAX package.

  * `gumbel` within 1e-6 of `jax.random.gumbel` (the uniform draw is
    bit-exact; torch's log may differ from XLA's by an ulp), `categorical`
    and `randint` bit-equal, `randint` with the bound JAX passes as an array
    (`jnp.maximum(size, 1)`, replay.py:59) given here as a host int;
  * `insert` past the capacity (the ring wraps), `sample` and
    `sample_transitions`: the same slots, columns and data, bit for bit;
  * `sample_prioritized` over a table with unwritten (zero) entries: the same
    slots and columns, weights within 1e-6; `priorities_on_insert`;
  * `priorities_update` where a draw repeats pairs: the last write wins, as
    JAX's scatter on the CPU gives it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pobrax_tpu.training import replay as jreplay
from pobrax_tpu_torch import random as jr
from pobrax_tpu_torch.training import replay


@pytest.mark.parametrize("seed,shape", [(0, (64, 1000)), (7, (3, 5, 17))])
def test_gumbel_matches_jax(seed, shape):
    want = np.asarray(jax.random.gumbel(jax.random.PRNGKey(seed), shape))
    got = jr.gumbel(jr.PRNGKey(seed), shape).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n,batch", [(5000, 300), (7, 64)])
def test_categorical_matches_jax(n, batch):
    logits = np.random.RandomState(n).randn(n).astype(np.float32)
    logits[::3] = -np.inf
    want = np.asarray(jax.random.categorical(jax.random.PRNGKey(4), jnp.asarray(logits),
                                             shape=(batch,)))
    got = jr.categorical(jr.PRNGKey(4), torch.from_numpy(logits), (batch,)).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.isfinite(logits[got]).all()


@pytest.mark.parametrize("size", [0, 1, 37, 192])
def test_randint_with_array_bound_matches_jax(size):
    key = jax.random.PRNGKey(size + 1)
    want = np.asarray(jax.random.randint(key, (500,), 0, jnp.maximum(jnp.int32(size), 1)))
    got = jr.randint(jr.PRNGKey(size + 1), (500,), 0, max(size, 1)).numpy()
    np.testing.assert_array_equal(got, want)


def _samples(rng, n, cols=4):
    return [{"obs": rng.randn(cols, 3).astype(np.float32),
             "reward": rng.randn(cols).astype(np.float32)} for _ in range(n)]


def test_insert_sample_and_transitions_match_jax():
    rng = np.random.RandomState(0)
    rows = _samples(rng, 7)
    js = jreplay.init(rows[0], 5)
    ts = replay.init({k: torch.from_numpy(v) for k, v in rows[0].items()}, 5)
    for i, row in enumerate(rows):
        js = jreplay.insert(js, row)
        ts = replay.insert(ts, {k: torch.from_numpy(v) for k, v in row.items()})
        assert (ts.insert_pos, ts.size) == (int(js.insert_pos), int(js.size)), i
    for k in js.data:
        np.testing.assert_array_equal(ts.data[k].numpy(), np.asarray(js.data[k]))
    key = jax.random.PRNGKey(3)
    for jfn, tfn, batch in ((jreplay.sample, replay.sample, 9),
                            (jreplay.sample_transitions, replay.sample_transitions, 33)):
        want = jfn(js, key, batch)
        got = tfn(ts, jr.PRNGKey(3), batch)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


def test_sample_prioritized_matches_jax():
    rng = np.random.RandomState(1)
    pri = (rng.rand(24, 40) * 3).astype(np.float32)
    pri[18:] = 0.0  # slots never written
    pri[3, 5:9] = 0.0
    for alpha, beta in ((0.6, 0.4), (1.0, 1.0)):
        js, jc, jw = jreplay.sample_prioritized(jnp.asarray(pri), jax.random.PRNGKey(9), 128,
                                                alpha, beta)
        ts, tc, tw = replay.sample_prioritized(torch.from_numpy(pri), jr.PRNGKey(9), 128,
                                               alpha, beta)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6, atol=1e-6)
        assert (pri[ts.numpy(), tc.numpy()] > 0).all()


def test_priorities_on_insert_matches_jax():
    pri = np.zeros((6, 3), np.float32)
    want, got = jnp.asarray(pri), torch.from_numpy(pri.copy())
    for slot, td in ((0, None), (1, 2.5), (4, None)):
        if td is not None:
            want = want.at[0, 1].set(td)
            got[0, 1] = td
        want = jreplay.priorities_on_insert(want, jnp.int32(slot))
        got = replay.priorities_on_insert(got, slot)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_priorities_update_last_write_wins():
    rng = np.random.RandomState(2)
    pri = rng.rand(8, 5).astype(np.float32)
    slot = np.array([1, 3, 1, 7, 3, 1, 0, 7], np.int32)
    col = np.array([2, 4, 2, 0, 4, 2, 0, 1], np.int32)
    td = rng.rand(8).astype(np.float32)
    want = np.asarray(jreplay.priorities_update(jnp.asarray(pri), jnp.asarray(slot),
                                                jnp.asarray(col), jnp.asarray(td)))
    got = replay.priorities_update(torch.from_numpy(pri.copy()), torch.from_numpy(slot).long(),
                                   torch.from_numpy(col).long(), torch.from_numpy(td))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[1, 2] == torch.tensor(td[5] + 1e-3) and got[3, 4] == torch.tensor(td[4] + 1e-3)
