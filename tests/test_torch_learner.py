"""The port's learner pieces against the JAX package, on the CPU.

Inputs come from numpy seeds; parameters are drawn by the JAX package and
carried across with `pobrax_tpu_torch.interop`. Tolerances:
  * keys: `split`, `fold_in` bit-equal; `normal` / `truncated_normal` within
    1e-6 abs (the uniform is bit-equal, XLA's ErfInv polynomial is rebuilt
    with fused steps, and log1p / sqrt may differ by an ulp);
  * `compute_gae` and the running statistics within 1e-6 (float32 sums in
    another order);
  * `minibatch_indices` bit-equal;
  * the distribution and the networks (MLP, SNMLP with its refreshed singular
    vector, GRUNet one step and a 16-step done-masked replay) within 1e-5;
  * one optimizer update (clip + Adam) from the same gradients within 1e-6
    relative of the update, clipped and unclipped.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pobrax_tpu.models import networks as jnet
from pobrax_tpu.training import ppo as jppo
from pobrax_tpu.training import ppo_rnn as jrnn
from pobrax_tpu.training import running_statistics as jrs
from pobrax_tpu.training.distribution import NormalTanhDistribution as JDist
from pobrax_tpu_torch import interop
from pobrax_tpu_torch import random as jr
from pobrax_tpu_torch.models import networks
from pobrax_tpu_torch.training import ppo, ppo_rnn
from pobrax_tpu_torch.training import running_statistics as rs
from pobrax_tpu_torch.training.distribution import NormalTanhDistribution
from pobrax_tpu_torch.training.optimizer import AdamState, Optimizer

torch.set_num_threads(1)


def _t(x):
    return torch.as_tensor(np.array(x))


# ---- random ------------------------------------------------------------------


@pytest.mark.parametrize("seed,shape", [(0, (5000,)), (7, (64, 8)), (123, (3, 5, 7))])
def test_normal_matches_jax(seed, shape):
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape))
    got = jr.normal(jr.PRNGKey(seed), shape).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # batched keys draw as vmap over keys does
    keys = jax.random.split(jax.random.PRNGKey(seed), 3)
    want = np.asarray(jax.vmap(lambda k: jax.random.normal(k, (6,)))(keys))
    got = jr.normal(_t(keys).long(), (6,)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_truncated_normal_matches_jax():
    want = np.asarray(jax.random.truncated_normal(jax.random.PRNGKey(4), -2.0, 2.0, (4000,)))
    got = jr.truncated_normal(jr.PRNGKey(4), -2.0, 2.0, (4000,)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert np.abs(got).max() < 2.0


@pytest.mark.parametrize("data", [0, 1, 2289, 2 ** 31 + 5])
def test_fold_in_matches_jax(data):
    for seed in (0, 42):
        want = np.asarray(jax.random.fold_in(jax.random.PRNGKey(seed), data))
        got = jr.fold_in(jr.PRNGKey(seed), data).numpy()
        np.testing.assert_array_equal(got, want.astype(np.int64))


def test_split_three_matches_jax():
    key = jax.random.PRNGKey(9)
    want = np.asarray(jax.random.split(key, 3))
    np.testing.assert_array_equal(jr.split(jr.PRNGKey(9), 3).numpy(), want.astype(np.int64))
    # the epoch's `key, k_roll, k_sgd = split(key, 3)` unpacking order
    k, k_roll, k_sgd = jr.split(jr.PRNGKey(9), 3).unbind(-2)
    np.testing.assert_array_equal(k_sgd.numpy(), want[2].astype(np.int64))


# ---- GAE, statistics, minibatches ------------------------------------------------


def test_compute_gae_matches_jax():
    rng = np.random.RandomState(0)
    T, B = 9, 6
    rewards = rng.randn(T, B).astype(np.float32)
    values = rng.randn(T, B).astype(np.float32)
    boot = rng.randn(B).astype(np.float32)
    dones = (rng.rand(T, B) < 0.2).astype(np.float32)
    trunc = dones * (rng.rand(T, B) < 0.5).astype(np.float32)
    assert trunc.sum() > 0 and (dones - trunc).sum() > 0
    want = jppo.compute_gae(rewards, dones, trunc, values, boot, 0.97, 0.95)
    got = ppo.compute_gae(*(_t(x) for x in (rewards, dones, trunc, values, boot)), 0.97, 0.95)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)
    assert float(got[0][trunc.astype(bool)].abs().max()) == 0.0


def test_running_statistics_match_jax():
    rng = np.random.RandomState(1)
    want, got = jrs.init_state(5), rs.init_state(5, device="cpu")
    for n in (64, 17):
        batch = (rng.randn(4, n, 5) * 3 + 2).astype(np.float32)
        want, got = jrs.update(want, batch), rs.update(got, _t(batch))
    for f in ("count", "mean", "summed_variance", "std"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=1e-6, atol=1e-6)
    obs = rng.randn(3, 5).astype(np.float32)
    np.testing.assert_allclose(rs.normalize(got, _t(obs)).numpy(),
                               np.asarray(jrs.normalize(want, obs)), rtol=0, atol=1e-6)


@pytest.mark.parametrize("blocks", [None, 2])
def test_minibatch_indices_match_jax(blocks):
    T, B, M = 6, 16, 4
    for seed in (0, 3):
        want = np.asarray(jppo.minibatch_indices(jax.random.PRNGKey(seed), T, B, M, blocks))
        got = ppo.minibatch_indices(jr.PRNGKey(seed), T, B, M, blocks).numpy()
        np.testing.assert_array_equal(got, want)
        assert sorted(got.reshape(-1).tolist()) == list(range(T * B))


# ---- distribution ----------------------------------------------------------------


def test_normal_tanh_distribution_matches_jax():
    rng = np.random.RandomState(2)
    params = (rng.randn(32, 8) * 2).astype(np.float32)
    pre = (rng.randn(32, 4) * 2).astype(np.float32)
    jd, td = JDist(event_size=4), NormalTanhDistribution(event_size=4)
    key, tkey = jax.random.PRNGKey(5), jr.PRNGKey(5)
    pairs = [
        (td.log_prob(_t(params), _t(pre)), jd.log_prob(params, pre)),
        (td.entropy(_t(params), tkey), jd.entropy(params, key)),
        (td.sample(_t(params), tkey), jd.sample(params, key)),
        (td.sample_no_postprocess(_t(params), tkey), jd.sample_no_postprocess(params, key)),
        (td.mode(_t(params)), jd.mode(params)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


# ---- networks --------------------------------------------------------------------


def test_mlp_matches_jax():
    obs = np.random.RandomState(3).randn(7, 27).astype(np.float32)
    jpol, jval = jnet.make_models(policy_params_size=16, obs_size=27)
    kp, kv = jax.random.split(jax.random.PRNGKey(0))
    jparams = {"policy": jpol.init(kp), "value": jval.init(kv)}
    tpol, tval = networks.make_models(16, 27, device="cpu")
    module = ppo.PPOParams(tpol, tval)
    interop.params_from_numpy(module, jparams)
    np.testing.assert_allclose(tpol(_t(obs)).detach().numpy(),
                               np.asarray(jpol.apply(jparams["policy"], obs)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tval(_t(obs)).detach().numpy(),
                               np.asarray(jval.apply(jparams["value"], obs)),
                               rtol=1e-5, atol=1e-5)
    # the carry back is exact
    back = interop.params_to_numpy(module)
    np.testing.assert_array_equal(back["value"]["params"]["hidden_5"]["kernel"],
                                  np.asarray(jparams["value"]["params"]["hidden_5"]["kernel"]))


def test_snmlp_and_refreshed_singular_vector_match_jax():
    obs = np.random.RandomState(4).randn(5, 6).astype(np.float32)
    model = jnet.make_model([8, 4], obs_size=6, spectral_norm=True)
    r1, r2 = jax.random.split(jax.random.PRNGKey(1))
    variables = model.init(r1, r2)
    tm = networks.make_model([8, 4], 6, spectral_norm=True, device="cpu")
    with torch.no_grad():
        for i, layer in enumerate(tm.hidden):
            p = variables["params"][f"hidden_{i}"]
            layer.weight.copy_(_t(p["kernel"]).t())
            layer.bias.copy_(_t(p["bias"]))
            layer.u.copy_(_t(variables["sing_vec"][f"hidden_{i}"]["u"]))
    want, updated = model.apply(variables, obs, mutable=["sing_vec"], rngs={"sing_vec": r2})
    got = tm(_t(obs))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    for i, layer in enumerate(tm.hidden):
        np.testing.assert_allclose(layer.u.numpy(),
                                   np.asarray(updated["sing_vec"][f"hidden_{i}"]["u"]),
                                   rtol=1e-5, atol=1e-5)


def _gru_pair(obs_size=10, enc=(16,), hidden=8, policy=6):
    net = jrnn.GRUNet(encoder_sizes=enc, hidden_size=hidden, policy_size=policy)
    params = net.init(jax.random.PRNGKey(2), jnp.zeros((1, hidden)), jnp.zeros((1, obs_size)))
    # nonzero biases, so the bias layout is checked too
    params = jax.tree.map(lambda x: x + 0.1 * jnp.cos(jnp.arange(x.size).reshape(x.shape)),
                          params)
    tnet = ppo_rnn.GRUNet(obs_size, enc, hidden, policy, device="cpu")
    interop.params_from_numpy(tnet, params)
    return net, params, tnet


def test_grunet_step_and_masked_replay_match_jax():
    net, params, tnet = _gru_pair()
    rng = np.random.RandomState(5)
    T, B = 16, 4
    obs = rng.randn(T, B, 10).astype(np.float32)
    done = (rng.rand(T, B) < 0.2).astype(np.float32)
    h0 = (rng.randn(B, 8) * 0.5).astype(np.float32)

    def jreplay(h, xs):
        o, d = xs
        nh, pol, val = net.apply(params, h, o)
        return nh * (1.0 - d[:, None]), (nh, pol, val)

    _, (jh, jpol, jval) = jax.lax.scan(jreplay, h0, (obs, done))
    h = _t(h0)
    for t in range(T):
        nh, pol, val = tnet(h, _t(obs[t]))
        for got, want in ((nh, jh[t]), (pol, jpol[t]), (val, jval[t])):
            np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-5)
        h = nh * (1.0 - _t(done[t])[:, None])
    # the r / z thirds of torch's recurrent bias are flax's missing biases
    assert float(tnet.gru.bias_hh[:16].detach().abs().max()) == 0.0


# ---- optimizer -------------------------------------------------------------------


@pytest.mark.parametrize("grad_scale", [10.0, 1e-3])
def test_optimizer_update_matches_optax(grad_scale):
    """One clip + Adam update from the same gradients and state, against
    optax.flatten(chain(clip_by_global_norm(0.5), adam(3e-4))); the first
    case is clipped, the second is not."""
    net, params, tnet = _gru_pair()
    rng = np.random.RandomState(6)
    grads = jax.tree.map(lambda x: jnp.asarray(rng.randn(*x.shape).astype(np.float32))
                         * grad_scale, params)
    tx = optax.flatten(optax.chain(optax.clip_by_global_norm(0.5), optax.adam(3e-4)))
    state = tx.init(params)
    # a state some steps in: nonzero moments, count 3
    warm = jax.tree.map(lambda g: g * 0.3, grads)
    for _ in range(3):
        _, state = tx.update(warm, state, params)
    updates, new_state = tx.update(grads, state, params)

    opt = Optimizer(3e-4, 0.5)
    adam = interop._find_adam(state)
    tstate = AdamState(count=int(adam.count), mu=interop.flat_from_numpy(tnet, adam.mu),
                       nu=interop.flat_from_numpy(tnet, adam.nu))
    gmod = ppo_rnn.GRUNet(10, (16,), 8, 6, device="cpu")
    interop.params_from_numpy(gmod, grads)
    with torch.no_grad():
        for p, g in zip(tnet.parameters(), gmod.parameters()):
            p.zero_()  # from zero, the parameters after the step ARE the update
            p.grad = g.detach().clone()
    tstate = opt.step(tnet, tstate)
    got = interop.params_to_numpy(tnet)
    for w, g in zip(jax.tree_util.tree_leaves(updates), jax.tree_util.tree_leaves(got)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-6, atol=1e-12)
    new_adam = interop._find_adam(new_state)
    np.testing.assert_allclose(interop.flat_to_numpy(tnet, tstate.mu), np.asarray(new_adam.mu),
                               rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(interop.flat_to_numpy(tnet, tstate.nu), np.asarray(new_adam.nu),
                               rtol=1e-6, atol=1e-15)
    assert tstate.count == int(new_adam.count) == 4
