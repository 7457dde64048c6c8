"""The port's PPO and GRU-PPO on a two-rank 'data' mesh against the JAX
package's two-device mesh run, on the CPU.

JAX jits the epoch with the env batch on 'data' (one global program); the
port's two gloo ranks each hold four of the eight envs and keep the global
semantics (global draws, global minibatch indices, global advantage
normalisation and statistics). Both packages resume the same JAX-drawn
checkpoint at epoch 2 (tests/test_torch_ppo.py's setup) and train one epoch
of `fast`; the port's ranks run `train(mesh=...)` in a jax-free worker.

  * rank 0's checkpoint against JAX's mesh `train`: parameters within 5e-5,
    Adam's moments 1e-5 relative, statistics 1e-6, metrics rtol 1e-4;
  * the same against the port's own single process with `shuffle_blocks=2`
    (GRU-PPO: the single process as it is): the mesh changes no draw;
  * the two ranks' whole states (parameters, moments, statistics) and
    metrics bit-equal;
  * only rank 0 writes the checkpoint, and a second `train(mesh=...)` on
    the same directory resumes it on both ranks and runs only the rest;
  * the draw and minibatch slicing alone: `random.normal`'s `block` against
    `jax.random.normal` over the global shape, and `ppo.local_indices` of
    `minibatch_indices` against JAX's global indices, rank by rank.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pobrax_tpu.envs.fast import Fast as JFast
from pobrax_tpu.parallel import make_mesh as jmake_mesh
from pobrax_tpu.training import checkpoint as jckpt
from pobrax_tpu.training import ppo as jppo
from pobrax_tpu.training import ppo_rnn as jrnn
from pobrax_tpu_torch import interop
from pobrax_tpu_torch import random as jr
from pobrax_tpu_torch.envs.fast import Fast
from pobrax_tpu_torch.parallel.mesh import Mesh
from pobrax_tpu_torch.training import checkpoint as ckpt
from pobrax_tpu_torch.training import ppo, ppo_rnn
from torch_mesh_util import assert_trees_equal, leaves, run_worker

torch.set_num_threads(1)

SMALL = dict(num_envs=8, episode_length=8, unroll_length=4, num_minibatches=2,
             num_update_epochs=2)
RNN_SIZES = dict(hidden_size=16, encoder_sizes=(32,))
CASES = {"ppo": dict(SMALL), "gru_ppo": dict(SMALL, **RNN_SIZES)}
PER_EPOCH = SMALL["unroll_length"] * SMALL["num_envs"]

_WORKER = """
    from pobrax_tpu_torch import interop
    from pobrax_tpu_torch.envs.fast import Fast
    from pobrax_tpu_torch.training import checkpoint as ckpt
    from pobrax_tpu_torch.training import ppo, ppo_rnn

    CASES = __CASES__
    PER_EPOCH = __PER_EPOCH__


    def work(mesh, root):
        torch.set_num_threads(1)
        captured, wrote = {}, []
        save_step, save = ckpt.save_step, ckpt.save

        def spy_step(path, step, ts, mesh=None):
            captured["state"] = interop.training_state_to_numpy(ts)
            return save_step(path, step, ts, mesh)

        def spy_save(path, ts):
            wrote.append(path)
            return save(path, ts)

        ckpt.save_step, ckpt.save = spy_step, spy_save
        out = {}
        for case, kw in CASES.items():
            mod = ppo_rnn if case == "gru_ppo" else ppo
            hist, steps = [], []
            mod.train(Fast(device="cpu"), seed=0, mesh=mesh,
                      checkpoint_dir=os.path.join(root, case), num_timesteps=3 * PER_EPOCH,
                      progress_fn=lambda s, m: hist.append(m), **kw)
            state = captured.pop("state")
            # the resume: every rank restores epoch 3 and runs epoch 4 only
            mod.train(Fast(device="cpu"), seed=0, mesh=mesh,
                      checkpoint_dir=os.path.join(root, case), num_timesteps=4 * PER_EPOCH,
                      progress_fn=lambda s, m: steps.append(s), **kw)
            out[case] = {"state": state, "history": hist, "resumed_steps": steps,
                         "resumed_epochs": int(captured.pop("state")["epochs"])}
        out["wrote"] = len(wrote)
        return out


    if __name__ == "__main__":
        finish(pm.spawn(work, 2, "gloo", "cpu", os.path.join(OUT, "torch"), timeout=100))
"""


def _jax_state(rnn):
    cfg = (jrnn.RNNPPOConfig if rnn else jppo.PPOConfig)(**CASES["gru_ppo" if rnn else "ppo"])
    learner = (jrnn.RNNPPOLearner if rnn else jppo.PPOLearner)(JFast(), cfg)
    return learner, learner.init(jax.random.PRNGKey(7)).replace(epochs=jnp.int32(2))


def _torch_learner(case, shuffle_blocks=None):
    kw = dict(CASES[case])
    if case == "gru_ppo":
        cfg = ppo_rnn.RNNPPOConfig(**kw)
        return ppo_rnn.RNNPPOLearner(ppo.wrap_for_training(Fast(device="cpu"), cfg, "naive"),
                                     cfg)
    cfg = ppo.PPOConfig(shuffle_blocks=shuffle_blocks, **kw)
    return ppo.PPOLearner(ppo.wrap_for_training(Fast(device="cpu"), cfg, "naive"), cfg)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per case: JAX's mesh run (final state, metrics), the port's single
    process (final state, metrics), and the two ranks' results."""
    root = tmp_path_factory.mktemp("mesh_ppo")
    jmesh = jmake_mesh(devices=jax.devices()[:2])
    out = {}
    for case in CASES:
        rnn = case == "gru_ppo"
        jl, ts = _jax_state(rnn)
        tl = _torch_learner(case)
        tstate = interop.training_state_from_numpy(jax.device_get(ts), tl)
        for d in ("jax", "torch", "single"):
            path = str(root / d / case)
            if d == "jax":
                jckpt.save_step(path, 2 * PER_EPOCH, ts)
            else:
                ckpt.save_step(path, 2 * PER_EPOCH, tstate)
        jh, sh = [], []
        (jrnn if rnn else jppo).train(JFast(), seed=0, mesh=jmesh,
                                      checkpoint_dir=str(root / "jax" / case),
                                      num_timesteps=3 * PER_EPOCH,
                                      progress_fn=lambda s, m: jh.append(m),
                                      watchdog_deadline_s=None, **CASES[case])
        extra = {} if rnn else {"shuffle_blocks": 2}
        (ppo_rnn if rnn else ppo).train(Fast(device="cpu"), seed=0,
                                        checkpoint_dir=str(root / "single" / case),
                                        num_timesteps=3 * PER_EPOCH,
                                        progress_fn=lambda s, m: sh.append(m),
                                        **CASES[case], **extra)
        want = jax.device_get(jckpt.restore(jckpt.latest_step_dir(str(root / "jax" / case)),
                                            template=jl.init(jax.random.PRNGKey(0))))
        single = interop.training_state_to_numpy(ckpt.restore(
            ckpt.latest_step_dir(str(root / "single" / case)), tl.init(jr.PRNGKey(0))))
        out[case] = {"jax": (want, jh[0]), "single": (single, sh[0])}
    ranks = run_worker(root, _WORKER.replace("__CASES__", repr(CASES))
                       .replace("__PER_EPOCH__", str(PER_EPOCH)))
    return out, ranks


def _jax_as_numpy(want):
    adam = interop._find_adam(want.opt_state)
    return {"params": interop._as_tree(want.params),
            "opt_state": {"count": int(adam.count), "mu": np.asarray(adam.mu),
                          "nu": np.asarray(adam.nu)},
            "normalizer": {k: np.asarray(getattr(want.normalizer, k))
                           for k in ("count", "mean", "summed_variance", "std")},
            "epochs": int(want.epochs)}


def _assert_close(got, want):
    assert int(got["epochs"]) == int(want["epochs"]) == 3
    want_params = dict(leaves(want["params"]))
    for path, g in leaves(got["params"]):
        np.testing.assert_allclose(g, want_params[path], rtol=0, atol=5e-5, err_msg=str(path))
    assert got["opt_state"]["count"] == want["opt_state"]["count"]
    for k in ("mu", "nu"):
        w = np.asarray(want["opt_state"][k])
        np.testing.assert_allclose(got["opt_state"][k], w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max())
    for k, v in got["normalizer"].items():
        np.testing.assert_allclose(v, want["normalizer"][k], rtol=1e-6, atol=1e-6)


def _assert_metrics(got, want):
    for k in ("total_loss", "policy_loss", "value_loss", "entropy", "mean_reward"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("case", sorted(CASES))
def test_two_ranks_match_jax_mesh_train(runs, case):
    out, ranks = runs
    want, jm = out[case]["jax"]
    _assert_close(ranks[0][case]["state"], _jax_as_numpy(want))
    assert len(ranks[0][case]["history"]) == 1
    _assert_metrics(ranks[0][case]["history"][0], jm)


@pytest.mark.parametrize("case", sorted(CASES))
def test_two_ranks_match_the_single_process(runs, case):
    out, ranks = runs
    single, sm = out[case]["single"]
    _assert_close(ranks[0][case]["state"], single)
    _assert_metrics(ranks[0][case]["history"][0], sm)


@pytest.mark.parametrize("case", sorted(CASES))
def test_ranks_hold_bit_equal_states(runs, case):
    _, ranks = runs
    assert_trees_equal(ranks[0][case]["state"], ranks[1][case]["state"], case)
    timing = ("rollout_ms", "update_ms", "steps_per_second")  # each rank's own clock
    h0, h1 = ([{k: v for k, v in m.items() if k not in timing} for m in r[case]["history"]]
              for r in ranks)
    assert h0 == h1


@pytest.mark.parametrize("case", sorted(CASES))
def test_rank0_writes_and_every_rank_resumes(runs, case):
    _, ranks = runs
    # rank 0 wrote both trains' checkpoints of both cases; rank 1 none
    assert (ranks[0]["wrote"], ranks[1]["wrote"]) == (2 * len(CASES), 0)
    for r in ranks:
        assert r[case]["resumed_steps"] == [4 * PER_EPOCH]
        assert r[case]["resumed_epochs"] == 4


@pytest.mark.parametrize("axis", [0, 1])
def test_block_draw_is_the_global_draws_block(axis):
    key = jax.random.PRNGKey(3)
    shape = (6, 10, 3)
    want = np.asarray(jax.random.normal(key, shape))
    local = list(shape)
    local[axis] //= 2
    for d in range(2):
        got = jr.normal(jr.PRNGKey(3), local, block=(axis, d, 2)).numpy()
        rows = np.take(want, np.arange(d * local[axis], (d + 1) * local[axis]), axis=axis)
        np.testing.assert_allclose(got, rows, rtol=0, atol=1e-6)
        exact = jr.random_bits(jr.PRNGKey(3), local, block=(axis, d, 2)).numpy()
        full = jr.random_bits(jr.PRNGKey(3), shape).numpy()
        np.testing.assert_array_equal(
            exact, np.take(full, np.arange(d * local[axis], (d + 1) * local[axis]), axis=axis))


def _mesh(rank, data=2):
    return Mesh(data=data, model=1, rank=rank, group=None,
                device=torch.device("cpu"), backend=None)


@pytest.mark.parametrize("T,B,M", [(4, 8, 2), (16, 64, 32)])
def test_local_minibatch_indices_pick_the_global_samples(T, B, M):
    """Rank d's local indices into its (T, B/2) rollout select, in order,
    the samples JAX's global indices (blocks=2) select from columns
    [d S, (d + 1) S) of each minibatch row."""
    rng = np.random.RandomState(0)
    rollout = rng.randn(T, B).astype(np.float32)
    jidx = np.asarray(jppo.minibatch_indices(jax.random.PRNGKey(5), T, B, M, 2))
    tidx = ppo.minibatch_indices(jr.PRNGKey(5), T, B, M, 2).numpy()
    np.testing.assert_array_equal(tidx, jidx)
    flat = rollout.reshape(-1)
    S = jidx.shape[1] // 2
    for d in range(2):
        local = rollout[:, d * B // 2:(d + 1) * B // 2].reshape(-1)
        lidx = ppo.local_indices(torch.as_tensor(tidx), B // 2, _mesh(d)).numpy()
        np.testing.assert_array_equal(local[lidx], flat[jidx[:, d * S:(d + 1) * S]])


def test_gru_ppo_rank_owns_a_block_of_every_minibatch():
    """GRU-PPO's strided minibatches (env b -> minibatch b % M): rank d's
    local minibatch m is block d of the global minibatch m's env axis."""
    T, B, M = 3, 16, 2
    x = np.arange(T * B).reshape(T, B)

    def shape_mb(v):
        v = v.reshape(v.shape[0], -1, M)
        return np.moveaxis(v, 2, 0)  # (M, T, B/M)

    glob = shape_mb(x)
    for d in range(2):
        local = shape_mb(x[:, d * B // 2:(d + 1) * B // 2])
        per = B // (2 * M)
        np.testing.assert_array_equal(local, glob[:, :, d * per:(d + 1) * per])


def test_ppo_mesh_checks_its_sizes():
    cfg = ppo.PPOConfig(num_envs=6, unroll_length=4, num_minibatches=2)
    env = ppo.wrap_for_training(Fast(device="cpu"), cfg, "naive", 3)
    with pytest.raises(ValueError, match="shuffle_blocks"):
        ppo.PPOLearner(env, ppo.PPOConfig(num_envs=8, shuffle_blocks=4), _mesh(0))
    with pytest.raises(ValueError, match="divide"):
        ppo.PPOLearner(env, ppo.PPOConfig(num_envs=7), _mesh(0))
    with pytest.raises(ValueError, match="num_minibatches"):
        ppo_rnn.RNNPPOLearner(env, ppo_rnn.RNNPPOConfig(num_envs=12, num_minibatches=4),
                              _mesh(0))
