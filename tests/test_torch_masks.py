"""The port's observation masks (pobrax_tpu_torch.envs.masks, .masked) against
the JAX package.

Every segment table must be EQUAL to `pobrax_tpu.envs.masks`' (both are
numpy), and so must the keep-mask `segment_mask` compiles from them. The
wrapper is one select, so its output on the same observations must equal the
JAX wrapper's exactly; on a masked env from `create`, reset and a few steps
track the JAX masked env within the stock-env tolerances of
tests/test_torch_stock_envs.py (reset obs atol 1e-5, step obs atol 1e-3) and
the hidden entries are exactly 0.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pobrax_tpu.envs import MaskedObservationWrapper as JMasked
from pobrax_tpu.envs import create as jax_create
from pobrax_tpu.envs import masks as jmasks
from pobrax_tpu_torch import random as jr
from pobrax_tpu_torch.envs import MaskedObservationWrapper, create
from pobrax_tpu_torch.envs import masks as tmasks

SEGMENTS = sorted(jmasks.SEGMENTS)


@pytest.mark.parametrize("segment", SEGMENTS)
def test_segment_tables_equal(segment):
    want, got = jmasks.SEGMENTS[segment], tmasks.SEGMENTS[segment]
    assert sorted(got) == sorted(want)
    for env_name, idx in want.items():
        np.testing.assert_array_equal(got[env_name], idx, err_msg=f"{segment}/{env_name}")
        assert got[env_name].dtype == idx.dtype


OBS_SIZES = {"fetch": 101, "grasp": 132, "humanoid": 299, "humanoidstandup": 299,
             "inverted_pendulum": 10, "inverted_double_pendulum": 25, "reacher": 11,
             "reacherangle": 11, "ur5e": 66}


@pytest.mark.parametrize("env_name", sorted(OBS_SIZES))
def test_segment_mask_equal(env_name):
    """Every combination of one or two segments the env has, and the error
    for a segment it lacks."""
    size = OBS_SIZES[env_name]
    have = [s for s in SEGMENTS if env_name in jmasks.SEGMENTS[s]]
    for hidden in itertools.chain(itertools.combinations(have, 1),
                                  itertools.combinations(have, 2)):
        np.testing.assert_array_equal(tmasks.segment_mask(env_name, size, hidden),
                                      jmasks.segment_mask(env_name, size, hidden),
                                      err_msg=str(hidden))
    missing = [s for s in SEGMENTS if s not in have]
    for seg in missing:
        with pytest.raises(KeyError):
            tmasks.segment_mask(env_name, size, (seg,))


class _Fixed:
    """A stand-in env that resets to given observations; the wrappers read
    its `observation_size` (and the port's its `device`)."""

    def __init__(self, obs, state):
        self.observation_size = obs.shape[-1]
        self.device = torch.device("cpu")
        self._state = state

    def reset(self, rng):
        return self._state


@pytest.mark.parametrize("how", ["table", "explicit"])
def test_wrapper_equals_jax(how):
    """Both wrappers' reset on the same seeded obs, with a table mask
    (humanoid, VELOCITY and CFRC hidden) and with an explicit `mask=`."""
    from pobrax_tpu.envs.base import State as JState
    from pobrax_tpu_torch.envs.base import State
    rs = np.random.RandomState(0)
    obs = rs.randn(4, 299).astype(np.float32)
    kw = (dict(env_name="humanoid", hidden=("VELOCITY", "CFRC")) if how == "table"
          else dict(mask=rs.rand(299) > 0.5))
    got = MaskedObservationWrapper(
        _Fixed(obs, State(None, torch.from_numpy(obs), None, None, {}, {})), **kw).reset(None)
    want = JMasked(
        _Fixed(obs, JState(None, jnp.asarray(obs), None, None, {}, {})), **kw).reset(None)
    np.testing.assert_array_equal(got.obs.numpy(), np.asarray(want.obs))


def test_wrapper_needs_a_mask_or_a_name():
    with pytest.raises(ValueError):
        MaskedObservationWrapper(_Fixed(np.zeros((1, 11)), None))


@pytest.mark.parametrize("name", ["humanoid", "grasp"])
def test_masked_env_matches_jax(name):
    """`bench.py`'s masked_<name>: create(..., randomized cached autoreset)
    under MaskedObservationWrapper(hidden=("VELOCITY",)), at B=4: reset
    obs atol 1e-5, three steps of the same actions obs atol 1e-3, VELOCITY
    entries exactly 0 on both sides."""
    B, T = 4, 3
    kw = dict(episode_length=1000, batch_size=B, auto_reset=True, randomized_autoreset=True,
              autoreset_mode="cached")
    jenv = JMasked(jax_create(name, **kw), env_name=name, hidden=("VELOCITY",))
    tenv = MaskedObservationWrapper(create(name, device="cpu", **kw), env_name=name,
                                    hidden=("VELOCITY",))
    hidden = tmasks.VELOCITY[name]
    js = jax.jit(jenv.reset)(jax.random.PRNGKey(2))
    ts = tenv.reset(jr.PRNGKey(2))
    np.testing.assert_allclose(ts.obs.numpy(), np.asarray(js.obs), rtol=0, atol=1e-5)
    jstep = jax.jit(jenv.step)
    acts = np.random.RandomState(1).uniform(-1, 1, (T, B, tenv.action_size)).astype(np.float32)
    for t in range(T):
        js, ts = jstep(js, acts[t]), tenv.step(ts, torch.from_numpy(acts[t]))
        np.testing.assert_allclose(ts.obs.numpy(), np.asarray(js.obs), rtol=0, atol=1e-3,
                                   err_msg=f"step {t}")
        assert float(ts.obs[:, hidden].abs().max()) == 0.0
        assert float(np.abs(np.asarray(js.obs)[:, hidden]).max()) == 0.0
