"""The port's SAC and GRU-SAC on a two-rank 'data' mesh against the JAX
package's two-device `shard_map` epoch, on the CPU.

JAX's off-policy epoch is per shard: each shard folds its index into the
key, steps its envs, fills its own replay columns and PER table and draws
its share of the batch; gradients, GRU-SAC's `logp`, the metrics and the
statistics' sums are the only collectives. The port's two gloo ranks (a
jax-free worker) start from `interop.shard_training_state`'s cut of the same
JAX state and env state, so each holds what JAX's shard d holds:

  * SAC on `fast` (tests/test_torch_sac.py's sizes: a 6-slot buffer that
    wraps, gradient steps from the 3rd step), and GRU-SAC on InvertedPendulum
    (episodes end) with PER on and off, one epoch each: every rank's
    replicated parameters within 5e-5 of JAX's, Adam's moments 1e-5
    relative, statistics 1e-6, metrics rtol 1e-4; its replay columns and
    PER table are its block of JAX's and agree with it (1e-5), and have the
    rank-local shapes (capacity, L, B/2, ...) and (capacity, B/2);
  * GRU-SAC's `train(mesh=...)` resumed one epoch from the same JAX-drawn
    checkpoint with PER and a carry env, against JAX's mesh `train`: the
    per-shard carry layout (a carry column then three train columns on each
    rank, keyed as JAX's interleaved global reset);
  * the ranks' replicated states and metrics bit-equal.
The pendulum's two off-plane quaternion entries are held at 0 in both
packages (tests/test_torch_sac_rnn.py's `OFF_PLANE`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pobrax_tpu.envs import wrappers as jw
from pobrax_tpu.envs.fast import Fast as JFast
from pobrax_tpu.envs.pendulum import InvertedPendulum as JPendulum
from pobrax_tpu.parallel import make_mesh as jmake_mesh
from pobrax_tpu.training import checkpoint as jckpt
from pobrax_tpu.training import sac as jsac
from pobrax_tpu.training import sac_rnn as jrs
from pobrax_tpu_torch import interop
from pobrax_tpu_torch.envs import wrappers
from pobrax_tpu_torch.envs.pendulum import InvertedPendulum
from pobrax_tpu_torch.training import checkpoint as ckpt
from pobrax_tpu_torch.training import sac_rnn
from torch_mesh_util import assert_trees_equal, leaves, plain, run_worker

torch.set_num_threads(1)

SAC = dict(num_envs=8, episode_length=5, replay_capacity=6, batch_size=16, steps_per_epoch=8,
           min_replay=3, hidden=(16, 16))
NETS = dict(encoder_sizes=(16,), hidden_size=8, head_sizes=(16,))
GRU = dict(num_envs=8, episode_length=12, seq_len=6, burn_in=2, replay_capacity=4,
           batch_size=4, seqs_per_epoch=2, grad_steps_per_seq=2, min_replay=1, nstep=3, **NETS)
# epoch cases: (learner, env, config)
EPOCHS = {"sac": ("sac", "fast", SAC),
          "gru_sac": ("gru_sac", "pendulum", GRU),
          "gru_sac_per": ("gru_sac", "pendulum", dict(GRU, per_alpha=0.6))}
TRAIN = dict(GRU, per_alpha=0.6)  # the resumed train, with a carry env
PER_EPOCH = GRU["seqs_per_epoch"] * GRU["seq_len"] * GRU["num_envs"]
OFF_PLANE = [2, 4]


class _JPendulumInPlane(JPendulum):
    def _get_obs(self, qp):
        return super()._get_obs(qp).at[jnp.asarray(OFF_PLANE)].set(0.0)


_WORKER = """
    from pobrax_tpu_torch import interop
    from pobrax_tpu_torch import random as jr
    from pobrax_tpu_torch.envs import wrappers
    from pobrax_tpu_torch.envs.fast import Fast
    from pobrax_tpu_torch.envs.pendulum import InvertedPendulum
    from pobrax_tpu_torch.training import checkpoint as ckpt
    from pobrax_tpu_torch.training import sac, sac_rnn

    EPOCHS = __EPOCHS__
    TRAIN = __TRAIN__
    PER_EPOCH = __PER_EPOCH__
    OFF_PLANE = __OFF_PLANE__


    class PendulumInPlane(InvertedPendulum):
        def _get_obs(self, qp):
            return super()._get_obs(qp).index_fill(-1, torch.tensor(OFF_PLANE), 0.0)


    class Spy(PendulumInPlane):
        # records the batch of every step
        def __init__(self, log, **kw):
            super().__init__(**kw)
            self.log = log

        def step(self, state, action):
            self.log.append(int(action.shape[0]))
            return super().step(state, action)


    CORE = {"fast": Fast, "pendulum": PendulumInPlane}


    def wrapped(name, cfg, batch):
        env = wrappers.EpisodeWrapper(CORE[name](device="cpu"), cfg.episode_length, 1)
        return wrappers.RandomizedAutoResetWrapperNaive(wrappers.VmapWrapper(env, batch))


    def work(mesh, root):
        torch.set_num_threads(1)
        with open(os.path.join(root, "inputs.pkl"), "rb") as f:
            inputs = pickle.load(f)
        out = {}
        for case, (kind, env_name, kw) in EPOCHS.items():
            mod = sac if kind == "sac" else sac_rnn
            cfg = (mod.SACConfig if kind == "sac" else mod.RSACConfig)(**kw)
            env = wrapped(env_name, cfg, cfg.num_envs // mesh.data)
            learner = (sac.SACLearner if kind == "sac" else sac_rnn.RSACLearner)(env, cfg, mesh)
            jts, jes = inputs[case]
            ts = interop.training_state_from_numpy(
                interop.shard_training_state(jts, mesh.rank, mesh.data), learner)
            es = pm.shard_batch(interop.state_from_numpy(jes, device="cpu"), mesh)
            if kind == "sac":
                ts, es, m = learner.epoch(ts, es, jr.PRNGKey(11))
            else:
                ts, es, _, m = learner.epoch(ts, es, learner.h0(learner.local_envs),
                                             jr.PRNGKey(11))
            out[case] = {"state": interop.training_state_to_numpy(ts),
                         "metrics": {k: float(v) for k, v in m.items()},
                         "obs": es.obs.numpy()}
        # the resumed train with a carry env: capture this rank's final state
        captured, hist, steps = {}, [], {"carry": [], "train": []}
        save_step = ckpt.save_step

        def spy_step(path, step, ts, mesh=None):
            captured["state"] = interop.training_state_to_numpy(ts)
            return save_step(path, step, ts, mesh)

        ckpt.save_step = spy_step
        sac_rnn.train(Spy(steps["train"], device="cpu"), seed=0, mesh=mesh,
                      checkpoint_dir=os.path.join(root, "torch"), num_timesteps=3 * PER_EPOCH,
                      progress_fn=lambda s, m: hist.append(m),
                      carry_env=Spy(steps["carry"], device="cpu"), **TRAIN)
        out["train"] = {"state": captured["state"], "history": hist,
                        "steps": {k: sorted(set(v)) for k, v in steps.items()}}
        return out


    if __name__ == "__main__":
        finish(pm.spawn(work, 2, "gloo", "cpu", OUT, timeout=100))
"""


def _jwrapped(env_name, cfg):
    core = JFast() if env_name == "fast" else _JPendulumInPlane()
    w = jw.EpisodeWrapper(core, cfg.episode_length, 1)
    return jw.RandomizedAutoResetWrapperNaive(jw.VmapWrapper(w, batch_size=cfg.num_envs))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's sharded epochs and mesh train, and the two ranks' results."""
    import pickle

    root = tmp_path_factory.mktemp("mesh_sac")
    jmesh = jmake_mesh(devices=jax.devices()[:2])
    data = jax.sharding.NamedSharding(jmesh, jax.sharding.PartitionSpec("data"))
    inputs, want = {}, {}
    for case, (kind, env_name, kw) in EPOCHS.items():
        cfg = (jsac.SACConfig if kind == "sac" else jrs.RSACConfig)(**kw)
        env = _jwrapped(env_name, cfg)
        jl = (jsac.SACLearner if kind == "sac" else jrs.RSACLearner)(env, cfg, mesh=jmesh)
        es = jax.jit(env.reset)(jax.random.split(jax.random.PRNGKey(4), cfg.num_envs))
        ts = jl.init(jax.random.PRNGKey(7), es).replace(epochs=jnp.int32(2))
        if kind == "gru_sac":
            ts = ts.replace(params=ts.params.replace(log_alpha=jnp.float32(-0.2)))
        inputs[case] = (plain(jax.device_get(ts)), plain(jax.device_get(es)))
        sts, ses = jax.device_put(ts, jl.state_sharding()), jax.device_put(es, data)
        epoch = jax.jit(jl.build_epoch_fn())
        if kind == "sac":
            got = epoch(sts, ses, jax.random.PRNGKey(11))
        else:
            got = epoch(sts, ses, jax.device_put(jl.h0(cfg.num_envs), data),
                        jax.random.PRNGKey(11))
        ts2, es2, m = got[0], got[1], got[-1]
        want[case] = (plain(jax.device_get(ts2)), {k: float(v) for k, v in m.items()},
                      np.asarray(es2.obs))
    with open(root / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)

    # the resumed mesh train with a carry env, from a JAX-drawn checkpoint
    cfg = jrs.RSACConfig(**TRAIN)
    jl = jrs.RSACLearner(_jwrapped("pendulum", cfg), cfg)
    es = jax.jit(jl.env.reset)(jax.random.split(jax.random.PRNGKey(4), cfg.num_envs))
    ts = jl.init(jax.random.PRNGKey(7), es)
    ts = ts.replace(epochs=jnp.int32(2), params=ts.params.replace(log_alpha=jnp.float32(-0.2)))
    jckpt.save_step(str(root / "jax"), 2 * PER_EPOCH, jrs._ckpt_slice(ts))
    tl = sac_rnn.RSACLearner(wrappers.VmapWrapper(InvertedPendulum(device="cpu"), 8),
                             sac_rnn.RSACConfig(**TRAIN))
    ckpt.save_step(str(root / "torch"), 2 * PER_EPOCH,
                   interop.training_state_from_numpy(jax.device_get(jrs._ckpt_slice(ts)), tl))
    jh = []
    jrs.train(_JPendulumInPlane(), seed=0, mesh=jmesh, checkpoint_dir=str(root / "jax"),
              num_timesteps=3 * PER_EPOCH, progress_fn=lambda s, m: jh.append(m),
              watchdog_deadline_s=None, carry_env=_JPendulumInPlane(), **TRAIN)
    train_want = jax.device_get(jckpt.restore(jckpt.latest_step_dir(str(root / "jax")),
                                              template=jrs._ckpt_slice(ts)))
    want["train"] = (plain(train_want), jh[0])
    source = (_WORKER.replace("__EPOCHS__", repr(EPOCHS)).replace("__TRAIN__", repr(TRAIN))
              .replace("__PER_EPOCH__", str(PER_EPOCH)).replace("__OFF_PLANE__", repr(OFF_PLANE)))
    return want, run_worker(root, source)


def _adam(tree):
    return interop._find_adam(tree)


def _assert_replicated_close(got, want, optimizers=("policy_opt", "q_opt", "alpha_opt")):
    assert int(got["epochs"]) == int(want["epochs"]) == 3
    for f in ("policy", "q", "target_q"):
        want_p = dict(leaves(interop._as_tree(want["params"][f])))
        for path, g in leaves(got["params"][f]):
            np.testing.assert_allclose(g, want_p[path], rtol=0, atol=5e-5, err_msg=f"{f} {path}")
    np.testing.assert_allclose(got["params"]["log_alpha"], want["params"]["log_alpha"], rtol=0,
                               atol=5e-5)
    for name in optimizers:
        adam = _adam(want[name])
        assert got[name]["count"] == int(adam["count"]), name
        for k in ("mu", "nu"):
            w = np.asarray(adam[k])
            np.testing.assert_allclose(got[name][k], w, rtol=1e-5, atol=1e-5 * np.abs(w).max(),
                                       err_msg=f"{name} {k}")
    for k, v in got["normalizer"].items():
        np.testing.assert_allclose(v, want["normalizer"][k], rtol=1e-6, atol=1e-6)


def _assert_metrics(got, want):
    for k in ("q_loss", "actor_loss", "alpha", "mean_reward"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("case", sorted(EPOCHS))
def test_two_ranks_match_jax_shard_map_epoch(runs, case):
    want, ranks = runs
    jts, jm, _ = want[case]
    assert jm["q_loss"] > 0  # the gradient steps ran
    for r in ranks:
        _assert_replicated_close(r[case]["state"], jts)
        _assert_metrics(r[case]["metrics"], jm)


@pytest.mark.parametrize("case", sorted(EPOCHS))
def test_each_rank_holds_its_block_of_the_replay(runs, case):
    want, ranks = runs
    jts, _, jobs = want[case]
    kind, _, kw = EPOCHS[case]
    sequences = kind == "gru_sac"
    for d, r in enumerate(ranks):
        got = r[case]["state"]
        buf, jbuf = got["buffer"], jts["buffer"]
        assert (buf["insert_pos"], buf["size"]) == (int(jbuf["insert_pos"]), int(jbuf["size"]))
        for k, v in buf["data"].items():
            axis = 2 if sequences and k != "h0" else 1
            assert v.shape[axis] == kw["num_envs"] // 2, (k, v.shape)
            assert v.shape[0] == kw["replay_capacity"]
            block = np.take(np.asarray(jbuf["data"][k]), np.arange(4 * d, 4 * d + 4), axis=axis)
            np.testing.assert_allclose(v, block, rtol=0, atol=1e-5, err_msg=k)
        np.testing.assert_allclose(r[case]["obs"], jobs[4 * d:4 * d + 4], rtol=0, atol=1e-5)
        if kw.get("per_alpha", 0) > 0:
            assert got["priorities"].shape == (kw["replay_capacity"], kw["num_envs"] // 2)
            np.testing.assert_allclose(got["priorities"], np.asarray(jts["priorities"])[:, 4 * d:
                                                                                     4 * d + 4],
                                       rtol=1e-5, atol=1e-6)
            assert (got["priorities"] != 1.0).any()
        else:
            assert "priorities" not in got


@pytest.mark.parametrize("case", sorted(EPOCHS) + ["train"])
def test_ranks_hold_bit_equal_replicated_states(runs, case):
    _, ranks = runs
    local = ("buffer", "priorities")  # each rank's own columns
    a, b = ({k: v for k, v in r[case]["state"].items() if k not in local} for r in ranks)
    assert_trees_equal(a, b, case)
    if case == "train":
        timing = ("rollout_ms", "update_ms", "steps_per_second")
        h0, h1 = ([{k: v for k, v in m.items() if k not in timing} for m in r[case]["history"]]
                  for r in ranks)
        assert h0 == h1
    else:
        assert ranks[0][case]["metrics"] == ranks[1][case]["metrics"]


def test_resumed_train_with_carry_matches_jax_mesh_train(runs):
    want, ranks = runs
    jts, jm = want["train"]
    got = ranks[0]["train"]["state"]
    assert len(ranks[0]["train"]["history"]) == 1
    _assert_metrics(ranks[0]["train"]["history"][0], jm)
    _assert_replicated_close(got, jts)
    # per shard: one carry column then three train columns, on every rank
    for r in ranks:
        assert r["train"]["steps"] == {"carry": [1], "train": [3]}
