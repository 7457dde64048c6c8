"""The port's SAC against the JAX package, on the CPU.

  * The critic and actor losses and their gradients on a fixed batch
    (numpy seed; parameters drawn by JAX, the target critics and the
    temperature moved off their initial values, and the statistics set, all
    carried across) against `jax.value_and_grad`: within 1e-5 relative of
    the largest gradient.
  * One epoch on the `fast` env at small widths (8 envs, 8 steps an epoch, a
    6-slot buffer that wraps, gradient steps from the 3rd step on, episodes
    of 5 steps so truncation bootstraps through `final_obs`) from the same
    JAX-drawn state and env state, with the same key: JAX's jitted epoch
    against the port's. JAX's `sac.train` has no checkpoint, so the epoch
    functions are compared directly; the parameters agree within 5e-5 (the
    learners' bound: an Adam step moves a parameter by up to the learning
    rate), the buffer's contents, the statistics and the metrics within
    1e-5 and 1e-4, the counts exactly.
  * The port's own resume: a second `train` on the same checkpoint
    directory runs only the remaining epochs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pobrax_tpu.envs import wrappers as jw
from pobrax_tpu.envs.fast import Fast as JFast
from pobrax_tpu.training import sac as jsac
from pobrax_tpu_torch import interop
from pobrax_tpu_torch import random as jr
from pobrax_tpu_torch.envs import wrappers
from pobrax_tpu_torch.envs.fast import Fast
from pobrax_tpu_torch.training import checkpoint as ckpt
from pobrax_tpu_torch.training import sac

torch.set_num_threads(1)

SMALL = dict(num_envs=8, episode_length=5, replay_capacity=6, batch_size=16, steps_per_epoch=8,
             min_replay=3, hidden=(16, 16))


@dataclasses.dataclass
class _Sizes:
    """An env stand-in that only reports its sizes (the losses need no env)."""
    observation_size: int = 12
    action_size: int = 3
    device: torch.device = torch.device("cpu")


class _EnvState:
    def __init__(self, batch, obs_size):
        self.obs = jnp.zeros((batch, obs_size))
        self.reward = jnp.zeros(batch)
        self.done = jnp.zeros(batch)


def _grads(module, want_tree):
    got = interop.flat_to_numpy(module, torch.cat([p.grad.reshape(-1)
                                                   for p in module.parameters()]))
    want = np.concatenate([np.asarray(g).reshape(-1)
                           for g in jax.tree_util.tree_leaves(want_tree)])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def _perturbed(jl, rng, batch, obs_size):
    """A JAX-drawn state whose target critics, temperature and statistics
    are off their initial values."""
    ts = jl.init(jax.random.PRNGKey(1), _EnvState(batch, obs_size))
    params = ts.params.replace(target_q=jax.tree.map(lambda x: x * 0.9, ts.params.target_q),
                               log_alpha=jnp.float32(-0.3))
    norm = ts.normalizer.replace(
        mean=jnp.asarray(rng.randn(obs_size).astype(np.float32)),
        std=jnp.asarray((rng.rand(obs_size) + 0.5).astype(np.float32)))
    return ts.replace(params=params, normalizer=norm)


def test_losses_and_gradients_match_jax():
    rng = np.random.RandomState(0)
    cfg = dict(num_envs=4, hidden=(16, 16), replay_capacity=8)
    jl = jsac.SACLearner(_Sizes(), jsac.SACConfig(**cfg))
    tl = sac.SACLearner(_Sizes(), sac.SACConfig(**cfg))
    jts = _perturbed(jl, rng, 4, 12)
    n = 40
    batch = dict(obs=rng.randn(n, 12), action=np.tanh(rng.randn(n, 3)), reward=rng.randn(n),
                 next_obs=rng.randn(n, 12), done=rng.rand(n) < 0.3,
                 truncation=rng.rand(n) < 0.3)
    batch = {k: np.asarray(v, np.float32) for k, v in batch.items()}
    jq, jq_grads = jax.value_and_grad(jl._critic_loss)(
        jts.params.q, jts.params, jts.normalizer, batch, jax.random.PRNGKey(2))
    (ja, jlogp), ja_grads = jax.value_and_grad(jl._actor_loss, has_aux=True)(
        jts.params.policy, jts.params, jts.normalizer, batch, jax.random.PRNGKey(3))
    jal, jal_grad = jax.value_and_grad(jl._alpha_loss)(jts.params.log_alpha, jlogp)

    tts = interop.training_state_from_numpy(jax.device_get(jts), tl)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    p = tts.params
    q_loss = tl._critic_loss(p, tts.normalizer, tb, jr.PRNGKey(2))
    q_loss.backward()
    a_loss, logp = tl._actor_loss(p, tts.normalizer, tb, jr.PRNGKey(3))
    a_loss.backward()
    al = tl._alpha_loss(p.log_alpha.value, logp)
    al.backward()
    for got, want in ((q_loss, jq), (a_loss, ja), (al, jal)):
        np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(logp.detach().numpy(), np.asarray(jlogp), rtol=1e-5, atol=1e-5)
    _grads(p.q, jq_grads)
    _grads(p.policy, ja_grads)
    np.testing.assert_allclose(float(p.log_alpha.value.grad), float(jal_grad), rtol=1e-5)
    # each loss differentiates its own argument only
    assert all(q.grad is None for q in p.target_q.parameters())


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, np.asarray(tree)


def _jax_wrapped(cfg):
    w = jw.EpisodeWrapper(JFast(), cfg.episode_length, 1)
    w = jw.VmapWrapper(w, batch_size=cfg.num_envs)
    return jw.randomized_autoreset(w, "naive")


def test_epoch_from_a_jax_state_matches_jax():
    jcfg, tcfg = jsac.SACConfig(**SMALL), sac.SACConfig(**SMALL)
    jenv = _jax_wrapped(jcfg)
    jl = jsac.SACLearner(jenv, jcfg)
    tenv = wrappers.randomized_autoreset(wrappers.VmapWrapper(
        wrappers.EpisodeWrapper(Fast(device="cpu"), tcfg.episode_length, 1),
        batch_size=tcfg.num_envs), "naive")
    tl = sac.SACLearner(tenv, tcfg)
    env_state = jax.jit(jenv.reset)(jax.random.split(jax.random.PRNGKey(4), 8))
    jts = jl.init(jax.random.PRNGKey(7), env_state).replace(epochs=jnp.int32(2))
    tts = interop.training_state_from_numpy(jax.device_get(jts), tl)
    tes = interop.state_from_numpy(jax.device_get(env_state), device="cpu")
    want, want_es, jm = jax.jit(jl.build_epoch_fn())(jts, env_state, jax.random.PRNGKey(11))
    want = jax.device_get(want)
    got_ts, got_es, tm = tl.epoch(tts, tes, jr.PRNGKey(11))
    got = interop.training_state_to_numpy(got_ts)

    assert int(got["epochs"]) == int(want.epochs) == 3
    for k in ("q_loss", "actor_loss", "alpha", "mean_reward"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, atol=1e-6, err_msg=k)
    assert float(jm["q_loss"]) > 0  # the gradient steps ran
    for f in ("policy", "q", "target_q"):
        want_p = dict(_leaves(interop._as_tree(getattr(want.params, f))))
        for path, g in _leaves(got["params"][f]):
            np.testing.assert_allclose(g, want_p[path], rtol=0, atol=5e-5, err_msg=f"{f} {path}")
    np.testing.assert_allclose(got["params"]["log_alpha"], np.asarray(want.params.log_alpha),
                               rtol=0, atol=5e-5)
    for name in ("policy_opt", "q_opt", "alpha_opt"):
        adam = interop._find_adam(getattr(want, name))
        assert got[name]["count"] == int(adam.count) == 6, name
        for k in ("mu", "nu"):
            w = np.asarray(getattr(adam, k))
            np.testing.assert_allclose(got[name][k], w, rtol=1e-5, atol=1e-5 * np.abs(w).max(),
                                       err_msg=f"{name} {k}")
    for k, v in got["normalizer"].items():
        np.testing.assert_allclose(v, np.asarray(getattr(want.normalizer, k)), rtol=1e-6,
                                   atol=1e-6)
    assert (got["buffer"]["insert_pos"], got["buffer"]["size"]) == (
        int(want.buffer.insert_pos), int(want.buffer.size)) == (2, 6)
    for k, v in got["buffer"]["data"].items():
        np.testing.assert_allclose(v, np.asarray(want.buffer.data[k]), rtol=0, atol=1e-5,
                                   err_msg=k)
    assert float(np.asarray(want.buffer.data["truncation"]).max()) == 1.0
    np.testing.assert_allclose(got_es.obs.numpy(), np.asarray(want_es.obs), rtol=0, atol=1e-5)


def test_train_resumes_from_its_checkpoint(tmp_path):
    per_epoch = SMALL["steps_per_epoch"] * SMALL["num_envs"]
    root = str(tmp_path)
    _, _, first = sac.train(Fast(device="cpu"), seed=3, checkpoint_dir=root,
                            num_timesteps=2 * per_epoch, progress_fn=lambda s, m: None, **SMALL)
    assert len(first) == 2
    assert ckpt.latest_step_dir(root).endswith(f"step_{2 * per_epoch:012d}")
    steps = []
    _, params, second = sac.train(Fast(device="cpu"), seed=3, checkpoint_dir=root,
                                  num_timesteps=3 * per_epoch,
                                  progress_fn=lambda s, m: steps.append(s), **SMALL)
    assert steps == [3 * per_epoch] and len(second) == 1
    assert all(np.isfinite(m[k]) for m in first + second for k in ("q_loss", "actor_loss"))
    cfg = sac.SACConfig(**SMALL)
    template = sac.SACLearner(wrappers.VmapWrapper(Fast(device="cpu"), 8), cfg).init(
        jr.PRNGKey(0))
    final = ckpt.restore(ckpt.latest_step_dir(root), template)
    assert final.epochs == 3
    # the buffer refills after the resume: the first 2 steps of an epoch from
    # an empty buffer take no gradient step (min_replay 3)
    assert final.q_opt.count == 6 + 8 + 6 and final.buffer.size == 0
    for a, b in zip(final.params.policy.parameters(), params[1].parameters()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("deterministic", [True, False])
def test_inference_fn(deterministic):
    inf, params, _ = sac.train(Fast(device="cpu"), num_timesteps=64, seed=0, **SMALL)
    act = inf(params, torch.zeros(5, 2), jr.PRNGKey(1), deterministic=deterministic)
    assert act.shape == (5, 1) and float(act.abs().max()) <= 1.0
