"""`flatten_optimizer=False` in the port against the JAX package, on the CPU.

With False the JAX learners run optax's per-leaf
`chain(clip_by_global_norm, adam)`: Adam's per-element math is that of the
flat optimizer, the clip's norm sums the same squares in another order, and
the optimizer state holds `mu` / `nu` as parameter-shaped trees. The port
keeps its one flat Adam; `AdamState.per_leaf` makes `interop` carry the
moments as those trees.

  * the per-leaf moments take the parameters' layout: the port's flat
    parameter vector, written out as a moment, is JAX's parameter tree;
  * the per-leaf state crosses `interop` both ways bit for bit (random
    moments, the per-leaf trees' structure and every leaf);
  * a few optimizer steps on gradients whose global norm is far above
    `max_grad_norm` (the clip active) against optax's per-leaf chain on the
    same gradients: the norm within 1e-6 relative, parameters within 5e-5,
    moments within 1e-5 relative;
  * a PPO and a GRU-PPO `train` epoch resumed from a carried JAX state
    (with nonzero moments) in both packages, as tests/test_torch_ppo.py
    does it: parameters within 5e-5, Adam's moments within 1e-5 relative,
    the statistics 1e-6, the counts exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pobrax_tpu.envs.fast import Fast as JFast
from pobrax_tpu.training import checkpoint as jckpt
from pobrax_tpu.training import ppo as jppo
from pobrax_tpu.training import ppo_rnn as jrnn
from pobrax_tpu_torch import interop
from pobrax_tpu_torch import random as jr
from pobrax_tpu_torch.envs.fast import Fast
from pobrax_tpu_torch.training import checkpoint as ckpt
from pobrax_tpu_torch.training import ppo, ppo_rnn

torch.set_num_threads(1)

SMALL = dict(num_envs=8, episode_length=8, unroll_length=4, num_minibatches=2,
             num_update_epochs=2, flatten_optimizer=False)
RNN_SIZES = dict(hidden_size=16, encoder_sizes=(32,))
KINDS = pytest.mark.parametrize("rnn", [False, True], ids=["ppo", "gru_ppo"])


@dataclasses.dataclass
class _Sizes:
    """An env stand-in that only reports its sizes."""
    observation_size: int = 12
    action_size: int = 3
    device: torch.device = torch.device("cpu")


def _learners(rnn, env=_Sizes(), tenv=_Sizes(), **kw):
    if rnn:
        kw = dict(num_envs=8, flatten_optimizer=False, **RNN_SIZES, **kw)
        return (jrnn.RNNPPOLearner(env, jrnn.RNNPPOConfig(**kw)),
                ppo_rnn.RNNPPOLearner(tenv, ppo_rnn.RNNPPOConfig(**kw)))
    kw = dict(num_envs=8, flatten_optimizer=False, **kw)
    return jppo.PPOLearner(env, jppo.PPOConfig(**kw)), ppo.PPOLearner(tenv, ppo.PPOConfig(**kw))


def _adam(opt_state):
    return interop._find_adam(opt_state)


def _with_moments(opt_state, seed, count=5):
    """JAX's per-leaf optimizer state with random moments (nu > 0)."""
    rng = np.random.RandomState(seed)

    def rebuild(x):
        if isinstance(x, optax.ScaleByAdamState):
            mu = jax.tree_util.tree_map(
                lambda a: jnp.asarray(rng.randn(*a.shape).astype(np.float32) * 1e-3), x.mu)
            nu = jax.tree_util.tree_map(
                lambda a: jnp.asarray(rng.rand(*a.shape).astype(np.float32) * 1e-6), x.nu)
            return x._replace(count=jnp.int32(count), mu=mu, nu=nu)
        if isinstance(x, tuple):
            items = [rebuild(v) for v in x]
            return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
        return x
    return rebuild(opt_state)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, np.asarray(tree)


def _flat_params(module):
    return torch.cat([p.detach().reshape(-1) for p in module.parameters()]).numpy()


@KINDS
def test_per_leaf_moments_take_the_parameter_layout(rnn):
    jl, tl = _learners(rnn)
    ts = jax.device_get(jl.init(jax.random.PRNGKey(1)))
    tts = interop.training_state_from_numpy(ts, tl)
    assert tts.opt_state.per_leaf and tl.init(jr.PRNGKey(0)).opt_state.per_leaf
    # the flat optimizer writes one flat vector
    assert not ppo.PPOLearner(_Sizes(), ppo.PPOConfig(num_envs=8)).init(
        jr.PRNGKey(0)).opt_state.per_leaf
    # a moment equal to the parameters is JAX's parameter tree, leaf for leaf
    moment = interop.tree_to_numpy(tts.params, torch.as_tensor(_flat_params(tts.params)))
    got = dict(_leaves(moment))
    want = dict(_leaves(interop._as_tree(ts.params)))
    assert got.keys() == want.keys()
    for path, v in want.items():
        np.testing.assert_array_equal(got[path], v, err_msg=str(path))


@KINDS
def test_per_leaf_state_round_trips_to_jax_bit_for_bit(rnn):
    jl, tl = _learners(rnn)
    ts = jax.device_get(jl.init(jax.random.PRNGKey(2)))
    ts = ts.replace(opt_state=jax.device_get(_with_moments(ts.opt_state, 3, count=7)))
    tts = interop.training_state_from_numpy(ts, tl)
    assert tts.opt_state.count == 7
    back = interop.training_state_to_numpy(tts)["opt_state"]
    want = _adam(ts.opt_state)
    assert int(back["count"]) == 7
    for k in ("mu", "nu"):
        got = dict(_leaves(back[k]))
        exp = dict(_leaves(interop._as_tree(getattr(want, k))))
        assert got.keys() == exp.keys()
        for path, v in exp.items():
            assert got[path].dtype == np.float32
            np.testing.assert_array_equal(got[path], v, err_msg=str(path))
        # the same tree, in JAX's leaf order, rebuilds JAX's moment
        rebuilt = jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(getattr(want, k)),
            [got[p] for p, _ in _leaves(interop._as_tree(getattr(want, k)))])
        for a, b in zip(jax.tree_util.tree_leaves(rebuilt),
                        jax.tree_util.tree_leaves(getattr(want, k))):
            np.testing.assert_array_equal(a, b)


@KINDS
def test_clipped_steps_match_optax_per_leaf_chain(rnn):
    jl, tl = _learners(rnn)
    ts = jax.device_get(jl.init(jax.random.PRNGKey(4)))
    tts = interop.training_state_from_numpy(ts, tl)
    params, state = ts.params, jl.optimizer.init(ts.params)
    rng = np.random.RandomState(5)
    tstate = tts.opt_state
    for _ in range(3):
        grads = jax.tree_util.tree_map(
            lambda a: jnp.asarray(rng.randn(*a.shape).astype(np.float32) * 3.0), params)
        norm = float(optax.global_norm(grads))
        assert norm > 10 * jl.cfg.max_grad_norm  # the clip is active
        updates, state = jl.optimizer.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        # the same gradients on the port's parameters
        g = interop.tree_from_numpy(tts.params, grads)
        assert tstate.per_leaf
        # the port's one-vector norm is optax's leaf-by-leaf one
        np.testing.assert_allclose(float(torch.sqrt(torch.sum(g * g))), norm, rtol=1e-6)
        sizes = [p.numel() for p in tts.params.parameters()]
        for p, gp in zip(tts.params.parameters(), g.split(sizes)):
            p.grad = gp.view_as(p).clone()
        tstate = tl.optimizer.step(tts.params, tstate)
    got = interop.params_to_numpy(tts.params)
    want_params = dict(_leaves(interop._as_tree(params)))
    for path, v in _leaves(got):
        np.testing.assert_allclose(v, want_params[path], rtol=0, atol=5e-5, err_msg=str(path))
    back = interop.training_state_to_numpy(dataclasses.replace(tts, opt_state=tstate))
    adam = _adam(state)
    assert int(back["opt_state"]["count"]) == int(adam.count) == 3
    for k in ("mu", "nu"):
        want = dict(_leaves(interop._as_tree(getattr(adam, k))))
        scale = max(np.abs(v).max() for v in want.values())
        for path, v in _leaves(back["opt_state"][k]):
            np.testing.assert_allclose(v, want[path], rtol=1e-5, atol=1e-5 * scale,
                                       err_msg=str(path))


def _jax_wrapped(cfg):
    from pobrax_tpu.envs import wrappers
    w = wrappers.ActionRepeatWrapper(JFast(), cfg.action_repeat)
    w = wrappers.EpisodeWrapper(w, cfg.episode_length, 1)
    w = wrappers.VmapWrapper(w, batch_size=cfg.num_envs)
    return wrappers.randomized_autoreset(w, "naive")


@KINDS
def test_train_epoch_from_carried_state_matches_jax(rnn, tmp_path):
    if rnn:
        jmod, tmod = jrnn, ppo_rnn
        kw = dict(SMALL, **RNN_SIZES)
        jcfg, tcfg = jrnn.RNNPPOConfig(**kw), ppo_rnn.RNNPPOConfig(**kw)
        jl = jrnn.RNNPPOLearner(_jax_wrapped(jcfg), jcfg)
        tl = ppo_rnn.RNNPPOLearner(ppo.wrap_for_training(Fast(device="cpu"), tcfg, "naive"),
                                   tcfg)
    else:
        jmod, tmod = jppo, ppo
        kw = dict(SMALL)
        jcfg, tcfg = jppo.PPOConfig(**kw), ppo.PPOConfig(**kw)
        jl = jppo.PPOLearner(_jax_wrapped(jcfg), jcfg)
        tl = ppo.PPOLearner(ppo.wrap_for_training(Fast(device="cpu"), tcfg, "naive"), tcfg)
    per_epoch = tcfg.unroll_length * tcfg.num_envs * tcfg.action_repeat
    ts = jl.init(jax.random.PRNGKey(7))
    ts = ts.replace(epochs=jnp.int32(2), opt_state=_with_moments(ts.opt_state, 8))
    jckpt.save_step(str(tmp_path / "jax"), 2 * per_epoch, ts)
    ckpt.save_step(str(tmp_path / "torch"), 2 * per_epoch,
                   interop.training_state_from_numpy(jax.device_get(ts), tl))

    jhist, thist = [], []
    jmod.train(JFast(), seed=0, checkpoint_dir=str(tmp_path / "jax"),
               num_timesteps=3 * per_epoch, progress_fn=lambda s, m: jhist.append(m), **kw)
    tmod.train(Fast(device="cpu"), seed=0, checkpoint_dir=str(tmp_path / "torch"),
               num_timesteps=3 * per_epoch, progress_fn=lambda s, m: thist.append(m), **kw)
    assert len(jhist) == len(thist) == 1
    for k in ("total_loss", "policy_loss", "value_loss", "entropy", "mean_reward"):
        np.testing.assert_allclose(thist[0][k], jhist[0][k], rtol=1e-4, atol=1e-6)

    want = jax.device_get(jckpt.restore(jckpt.latest_step_dir(str(tmp_path / "jax")),
                                        template=jl.init(jax.random.PRNGKey(0))))
    restored = ckpt.restore(ckpt.latest_step_dir(str(tmp_path / "torch")),
                            template=tl.init(jr.PRNGKey(0)))
    assert restored.opt_state.per_leaf
    got = interop.training_state_to_numpy(restored)
    assert int(got["epochs"]) == int(want.epochs) == 3
    want_params = dict(_leaves(interop._as_tree(want.params)))
    for path, g in _leaves(got["params"]):
        np.testing.assert_allclose(g, want_params[path], rtol=0, atol=5e-5, err_msg=str(path))
    adam = _adam(want.opt_state)
    assert int(got["opt_state"]["count"]) == int(adam.count) == 5 + 2 * 2
    for k in ("mu", "nu"):
        w = dict(_leaves(interop._as_tree(getattr(adam, k))))
        scale = max(np.abs(v).max() for v in w.values())
        for path, g in _leaves(got["opt_state"][k]):
            np.testing.assert_allclose(g, w[path], rtol=1e-5, atol=1e-5 * scale,
                                       err_msg=str(path))
    for k, v in got["normalizer"].items():
        np.testing.assert_allclose(v, np.asarray(getattr(want.normalizer, k)), rtol=1e-6,
                                   atol=1e-6)
