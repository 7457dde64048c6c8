"""The port's PPO and GRU-PPO against the JAX package, on the CPU.

  * Loss and gradients of both learners on a fixed batch (numpy seed,
    parameters drawn by JAX and carried across) against
    `jax.value_and_grad`: within 1e-5 relative (of the largest gradient).
  * A whole `train` epoch of each learner on the `fast` env at the JAX
    tests' sizes (8 envs, unroll 4; tests/test_training.py). The two
    packages draw their initial weights differently, so both start from
    the same JAX-drawn state written as a checkpoint at epoch 2; each
    `train(seed=0, checkpoint_dir=...)` then resumes it — the key
    folded with the epoch count, as JAX does — and runs one epoch: rollout
    draws, minibatch permutations and entropy noise all follow the same key
    stream. The saved states agree within 5e-5 in the parameters (each of
    the epoch's Adam steps moves a parameter by up to the learning rate,
    3e-4, and a moment near zero turns a 1e-7 gradient difference into a
    visible one), 1e-5 relative in Adam's moments, 1e-6 in the statistics,
    and exactly in the counts.
  * The port's own resume: a second `train` on the same directory runs only
    the remaining epochs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
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
             num_update_epochs=2)
RNN_SIZES = dict(hidden_size=16, encoder_sizes=(32,))


@dataclasses.dataclass
class _Sizes:
    """An env stand-in that only reports its sizes (the loss needs no env)."""
    observation_size: int = 12
    action_size: int = 3
    device: torch.device = torch.device("cpu")


def _t(x):
    return torch.as_tensor(np.array(x))


def _batch(rng, lead, obs_size, act_size):
    return dict(obs=rng.randn(*lead, obs_size).astype(np.float32),
                action=(rng.randn(*lead, act_size) * 1.5).astype(np.float32),
                log_prob=(rng.randn(*lead) - 3).astype(np.float32),
                reward=rng.randn(*lead).astype(np.float32),
                done=(rng.rand(*lead) < 0.15).astype(np.float32),
                truncation=np.zeros(lead, np.float32),
                value=rng.randn(*lead).astype(np.float32))


def _grads_flat(module):
    flat = torch.cat([p.grad.reshape(-1) for p in module.parameters()])
    return interop.flat_to_numpy(module, flat)


@pytest.mark.parametrize("rnn", [False, True], ids=["ppo", "gru_ppo"])
def test_loss_and_gradients_match_jax(rnn):
    rng = np.random.RandomState(0)
    env = _Sizes()
    if rnn:
        jl = jrnn.RNNPPOLearner(env, jrnn.RNNPPOConfig(num_envs=8, **RNN_SIZES))
        tl = ppo_rnn.RNNPPOLearner(env, ppo_rnn.RNNPPOConfig(num_envs=8, **RNN_SIZES))
        T, Bm = 6, 5
        data = _batch(rng, (T, Bm), 12, 3)
        h0 = (rng.randn(Bm, 16) * 0.3).astype(np.float32)
        lead = (T, Bm)
    else:
        jl = jppo.PPOLearner(env, jppo.PPOConfig(num_envs=8))
        tl = ppo.PPOLearner(env, ppo.PPOConfig(num_envs=8))
        data = _batch(rng, (40,), 12, 3)
        lead = (40,)
    adv = rng.randn(*lead).astype(np.float32)
    ret = rng.randn(*lead).astype(np.float32)
    ts = jax.device_get(jl.init(jax.random.PRNGKey(1)))
    first = h0 if rnn else None
    jdata = (jrnn.RNNTransition if rnn else jppo.Transition)(**data)
    (jtotal, jm), jgrads = jax.value_and_grad(jl._loss, has_aux=True)(
        ts.params, first, jdata, adv, ret, jax.random.PRNGKey(2))

    tts = interop.training_state_from_numpy(ts, tl)
    tdata = ppo.Transition(**{k: _t(v) for k, v in data.items()})
    total, tm = tl._loss(tts.params, None if first is None else _t(first), tdata, _t(adv),
                         _t(ret), jr.PRNGKey(2))
    total.backward()
    for k in jm:
        np.testing.assert_allclose(float(tm[k].detach()), float(jm[k]), rtol=1e-5, atol=1e-7)
    want = np.concatenate([np.asarray(g).reshape(-1) for g in jax.tree_util.tree_leaves(jgrads)])
    np.testing.assert_allclose(_grads_flat(tts.params), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def _jax_wrapped(cfg):
    from pobrax_tpu.envs import wrappers
    w = wrappers.ActionRepeatWrapper(JFast(), cfg.action_repeat)
    w = wrappers.EpisodeWrapper(w, cfg.episode_length, 1)
    w = wrappers.VmapWrapper(w, batch_size=cfg.num_envs)
    return wrappers.randomized_autoreset(w, "naive")


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, np.asarray(tree)


@pytest.mark.parametrize("rnn", [False, True], ids=["ppo", "gru_ppo"])
def test_train_epoch_from_checkpoint_matches_jax(rnn, tmp_path):
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
    ts = jl.init(jax.random.PRNGKey(7)).replace(epochs=jnp.int32(2))
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
    got = interop.training_state_to_numpy(
        ckpt.restore(ckpt.latest_step_dir(str(tmp_path / "torch")),
                     template=tl.init(jr.PRNGKey(0))))
    assert int(got["epochs"]) == int(want.epochs) == 3
    want_params = dict(_leaves(interop._as_tree(want.params)))
    for path, g in _leaves(got["params"]):
        np.testing.assert_allclose(g, want_params[path], rtol=0, atol=5e-5, err_msg=str(path))
    adam = interop._find_adam(want.opt_state)
    assert got["opt_state"]["count"] == int(adam.count)
    for k in ("mu", "nu"):
        w = np.asarray(getattr(adam, k))
        np.testing.assert_allclose(got["opt_state"][k], w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max())
    for k, v in got["normalizer"].items():
        np.testing.assert_allclose(v, np.asarray(getattr(want.normalizer, k)), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("rnn", [False, True], ids=["ppo", "gru_ppo"])
def test_train_resumes_from_its_checkpoint(rnn, tmp_path):
    mod = ppo_rnn if rnn else ppo
    kw = dict(SMALL, **(RNN_SIZES if rnn else {}))
    per_epoch = kw["unroll_length"] * kw["num_envs"]
    root = str(tmp_path)
    _, _, first = mod.train(Fast(device="cpu"), seed=3, checkpoint_dir=root,
                            num_timesteps=2 * per_epoch, progress_fn=lambda s, m: None, **kw)
    assert len(first) == 2
    assert ckpt.latest_step_dir(root).endswith(f"step_{2 * per_epoch:012d}")
    steps = []
    _, params, second = mod.train(Fast(device="cpu"), seed=3, checkpoint_dir=root,
                                  num_timesteps=3 * per_epoch,
                                  progress_fn=lambda s, m: steps.append(s), **kw)
    assert steps == [3 * per_epoch] and len(second) == 1
    learner_cls = ppo_rnn.RNNPPOLearner if rnn else ppo.PPOLearner
    cfg = (ppo_rnn.RNNPPOConfig if rnn else ppo.PPOConfig)(**kw)
    template = learner_cls(ppo.wrap_for_training(Fast(device="cpu"), cfg, "naive"),
                           cfg).init(jr.PRNGKey(0))
    final = ckpt.restore(ckpt.latest_step_dir(root), template)
    assert final.epochs == 3
    assert final.opt_state.count == 3 * kw["num_update_epochs"] * kw["num_minibatches"]
    net = final.params if rnn else final.params.policy
    for a, b in zip(net.parameters(), params[1].parameters()):
        assert torch.equal(a, b)


def test_ppo_bf16_network_dtype_trains_and_infers_float32():
    inf, params, hist = ppo.train(Fast(device="cpu"), num_timesteps=128, network_dtype="bfloat16",
                                  seed=0, progress_fn=lambda s, m: None, **SMALL)
    assert all(np.isfinite(h["total_loss"]) for h in hist)
    assert inf(params, torch.zeros(2, 2), jr.PRNGKey(0)).dtype == torch.float32


def test_evaluate_runs_the_episodes():
    inf, params, _ = ppo.train(Fast(device="cpu"), num_timesteps=64, seed=0, **SMALL)
    out = ppo.evaluate(Fast(device="cpu"), inf, params, num_episodes=4, episode_length=12)
    assert out["eval/mean_length"] == 12.0 and np.isfinite(out["eval/mean_return"])
