"""`create(...)` on the PO ant envs against the JAX package's `create(...)`.

With randomized autoreset in both modes, the port tracks JAX across forced
autoresets (the event goldens' kwargs, a 6-step episode) and a cache
refresh, with the EvalWrapper on top in cached mode: obs and reward 1e-3,
`done`, steps, truncation, keys and the eval counters equal. Batch 4, one
JAX jit of reset and step per test.
"""

import jax
import numpy as np
import pytest

from pobrax_tpu.envs import create as jax_create
from pobrax_tpu_torch import random as jr
from pobrax_tpu_torch.envs import create
from tests.test_torch_po_envs import EVENT_SPECS, NAMES
from tests.test_torch_po_wrappers import B, track


@pytest.mark.parametrize("mode", ["cached", "naive"])
@pytest.mark.parametrize("name", NAMES)
def test_create_tracks_jax_across_autoresets(name, mode):
    kwargs, _ = EVENT_SPECS[name]
    kw = dict(episode_length=6, batch_size=B, randomized_autoreset=True, autoreset_mode=mode,
              eval_metrics=mode == "cached", **kwargs)
    jenv, tenv = jax_create(name, **kw), create(name, device="cpu", **kw)
    if mode == "cached":  # under the EvalWrapper
        jenv.env.refresh_every = tenv.env.refresh_every = 5

    def check(js, ts, t):
        if mode != "cached":
            return
        np.testing.assert_allclose(ts.info["first_obs"].numpy(), np.asarray(js.info["first_obs"]),
                                   rtol=0, atol=1e-5)
        np.testing.assert_array_equal(ts.info["cache_age"].numpy(),
                                      np.asarray(js.info["cache_age"]))
        tm, jm = ts.info["eval_metrics"], js.info["eval_metrics"]
        for f in ("completed_episodes", "completed_episodes_steps"):
            assert float(getattr(tm, f)) == float(getattr(jm, f)), f
        for k, v in tm.completed_episodes_metrics.items():
            np.testing.assert_allclose(float(v), float(jm.completed_episodes_metrics[k]),
                                       rtol=0, atol=1e-3, err_msg=k)
            np.testing.assert_allclose(tm.current_episode_metrics[k].numpy(),
                                       np.asarray(jm.current_episode_metrics[k]), rtol=0,
                                       atol=1e-3, err_msg=k)

    js = jax.jit(jenv.reset)(jax.random.PRNGKey(11))
    ts = tenv.reset(jr.PRNGKey(11))
    _, ts, dones = track(jenv, tenv, js, ts, 16, check)
    assert dones >= B, "the window must cross autoresets"
    if mode == "cached":
        assert float(ts.info["eval_metrics"].completed_episodes) >= B
