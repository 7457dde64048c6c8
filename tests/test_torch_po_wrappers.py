"""The wrappers of the PO ant envs against their JAX twins.

`GridNoveltyBonusWrapper` (with its danger grid) on AntGather, and the
on-terminal and host-counter autoreset wrappers on HeavenHell, over the same
actions: obs and reward 1e-3, `done`, keys, steps, truncation and the
wrappers' own state equal. The novelty run continues from a JAX state carried
over with `interop.state_from_numpy`. Batch 4, one JAX jit per test; `track`
is shared with tests/test_torch_po_create.py.
"""

import jax
import numpy as np
import pytest
import torch

from pobrax_tpu.envs import wrappers as jw
from pobrax_tpu.envs.ant_gather import AntGatherEnv as JGather
from pobrax_tpu.envs.ant_heavenhell import AntHeavenHellEnv as JHeavenHell
from pobrax_tpu.envs.exploration import GridNoveltyBonusWrapper as JNovelty
from pobrax_tpu_torch import interop
from pobrax_tpu_torch import random as jr
from pobrax_tpu_torch.envs import wrappers as tw
from pobrax_tpu_torch.envs.ant_gather import AntGatherEnv
from pobrax_tpu_torch.envs.ant_heavenhell import AntHeavenHellEnv
from pobrax_tpu_torch.envs.exploration import GridNoveltyBonusWrapper

B = 4


def _eq_keys(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))


def track(jenv, tenv, js, ts, T, check=None, seed=0, jit=True):
    """Steps both envs through the same T actions; obs and reward 1e-3,
    `done`, keys, steps and truncation equal. Returns the final states and
    the number of envs that ended an episode."""
    jstep = jax.jit(jenv.step) if jit else jenv.step
    acts = np.random.RandomState(seed).uniform(-1, 1, (T, B, 8)).astype(np.float32)
    dones = 0.0
    for t in range(T):
        js = jstep(js, acts[t])
        ts = tenv.step(ts, torch.from_numpy(acts[t]))
        np.testing.assert_array_equal(ts.done.numpy(), np.asarray(js.done), err_msg=f"step {t}")
        np.testing.assert_allclose(ts.obs.numpy(), np.asarray(js.obs), rtol=0, atol=1e-3,
                                   err_msg=f"step {t}")
        np.testing.assert_allclose(ts.reward.numpy(), np.asarray(js.reward), rtol=0, atol=1e-3,
                                   err_msg=f"step {t}")
        _eq_keys(ts.info["rng"], js.info["rng"])
        for k in ("steps", "truncation"):
            if k in ts.info:
                np.testing.assert_array_equal(ts.info[k].numpy(), np.asarray(js.info[k]))
        for k, v in ts.metrics.items():
            np.testing.assert_allclose(v.numpy(), np.asarray(js.metrics[k]), rtol=0, atol=1e-3,
                                       err_msg=f"metric {k}, step {t}")
        if check is not None:
            check(js, ts, t)
        dones += float(ts.done.sum())
    return js, ts, dones


def test_grid_novelty_bonus_tracks_jax():
    """AntGather with a wide catch range (bombs fire), a coarse grid, a
    short half-life and the danger grid; half-way the port restarts from the
    JAX state, carried over by `interop.state_from_numpy`."""
    kw = dict(beta=0.5, half_extent=4.0, grid=8, halflife_steps=3.0, bomb_memory=0.25)
    jenv = jw.VmapWrapper(JNovelty(JGather(catch_range=5.0), **kw), batch_size=B)
    tenv = GridNoveltyBonusWrapper(tw.VmapWrapper(AntGatherEnv(catch_range=5.0, device="cpu"),
                                                  batch_size=B), **kw)

    def check(js, ts, t):
        np.testing.assert_allclose(ts.info["visit_counts"].numpy(),
                                   np.asarray(js.info["visit_counts"]), rtol=0, atol=1e-6)
        np.testing.assert_array_equal(ts.info["bomb_cells"].numpy(),
                                      np.asarray(js.info["bomb_cells"]))

    js = jax.jit(jenv.reset)(jax.random.PRNGKey(2))
    ts = tenv.reset(jr.PRNGKey(2))
    js, _, _ = track(jenv, tenv, js, ts, 6, check)
    ts = interop.state_from_numpy(js, device="cpu")
    assert ts.info["visit_counts"].shape == (B, 8, 8)
    js, ts, _ = track(jenv, tenv, js, ts, 6, check, seed=1)
    assert float(np.asarray(js.info["bomb_cells"]).sum()) > 0, "the danger grid must fire"
    assert float(np.asarray(js.metrics["apples"]).sum()) >= 0
    back = interop.state_to_numpy(ts)
    np.testing.assert_array_equal(back["info"]["bomb_cells"], ts.info["bomb_cells"].numpy())


@pytest.mark.parametrize("kind", ["on_terminal", "cached_host"])
def test_autoreset_wrappers_track_jax(kind):
    """The on-terminal wrapper (JAX: `lax.cond` on any done; here the reset
    selected every step) and the host-counter cached wrapper, refreshing
    every 4 steps, on HeavenHell with 6-step episodes. The host counter
    freezes under `jit`, so the JAX cached wrapper runs eagerly over a jitted
    inner env."""
    def stack(ns, inner):
        env = ns.VmapWrapper(ns.EpisodeWrapper(inner, 6), batch_size=B)
        if kind == "on_terminal":
            return ns.RandomizedAutoResetWrapperOnTerminal(env)
        return ns.RandomizedAutoResetWrapperCached(env, n_steps_between_updates=4)

    jenv = stack(jw, JHeavenHell(visible_radius=9.0))
    tenv = stack(tw, AntHeavenHellEnv(visible_radius=9.0, device="cpu"))

    def check(js, ts, t):
        np.testing.assert_allclose(ts.info["final_obs"].numpy(), np.asarray(js.info["final_obs"]),
                                   rtol=0, atol=1e-3)
        if kind == "cached_host":
            np.testing.assert_allclose(ts.info["first_obs"].numpy(),
                                       np.asarray(js.info["first_obs"]), rtol=0, atol=1e-5)

    if kind == "cached_host":
        jenv.env.step, jenv.env.reset = jax.jit(jenv.env.step), jax.jit(jenv.env.reset)
    js = jax.jit(jenv.reset)(jax.random.PRNGKey(4))
    ts = tenv.reset(jr.PRNGKey(4))
    _, _, dones = track(jenv, tenv, js, ts, 13, check, jit=kind != "cached_host")
    assert dones >= B
    if kind == "cached_host":
        assert jenv.steps == tenv.steps == 13
