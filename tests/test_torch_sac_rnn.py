"""The port's recurrent SAC against the JAX package, on the CPU, at
tests/test_sac_rnn.py's small widths.

  * `ActorGRU` and the twin `CriticGRU` trunks and heads, one step and
    done-masked rolls over a sequence, from JAX-drawn parameters: 1e-5;
  * `nstep_targets` with n = 1 and 5: 1e-6;
  * `_losses` with burn-in, without and with PER importance weights: the
    critic and actor losses, the masked log-prob, the per-sequence |TD|, and
    the gradients of the critic loss (q) and the actor loss (policy) against
    `jax.value_and_grad`: 1e-5 relative;
  * one `train` epoch resumed from the same JAX-drawn checkpoint in both
    packages (the key folded with the epoch count): on `fast` with PER on
    and a carry env in the first columns, on `fast` with the actor frozen
    and PER off, and on InvertedPendulum (episodes end) with PER on: 4
    gradient steps, whose sequence draws, priorities and losses all follow
    the same key stream; losses within 1e-4, statistics 1e-6, counts
    exact, parameters within 5e-5 and Adam's moments 1e-5 relative (on
    InvertedPendulum with the pole's two off-plane quaternion entries held
    at 0 in both packages: see `OFF_PLANE`);
  * the `[carry | train]` column layout of a collection step, and the port's
    own resume.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pobrax_tpu.envs.fast import Fast as JFast
from pobrax_tpu.envs.pendulum import InvertedPendulum as JPendulum
from pobrax_tpu.training import checkpoint as jckpt
from pobrax_tpu.training import sac_rnn as jrs
from pobrax_tpu_torch import interop
from pobrax_tpu_torch import random as jr
from pobrax_tpu_torch.envs import wrappers
from pobrax_tpu_torch.envs.fast import Fast
from pobrax_tpu_torch.envs.pendulum import InvertedPendulum
from pobrax_tpu_torch.training import checkpoint as ckpt
from pobrax_tpu_torch.training import sac_rnn

torch.set_num_threads(1)

NETS = dict(encoder_sizes=(16,), hidden_size=8, head_sizes=(16,))


@dataclasses.dataclass
class _Sizes:
    observation_size: int = 6
    action_size: int = 2
    device: torch.device = torch.device("cpu")


class _EnvState:
    def __init__(self, batch, obs_size):
        self.obs = jnp.zeros((batch, obs_size))


def _pair(**kw):
    cfg = dict(num_envs=5, seq_len=8, burn_in=3, replay_capacity=4, batch_size=7,
               reward_scaling=10.0, discounting=0.97, **NETS)
    cfg.update(kw)
    jl = jrs.RSACLearner(_Sizes(), jrs.RSACConfig(**cfg))
    tl = sac_rnn.RSACLearner(_Sizes(), sac_rnn.RSACConfig(**cfg))
    rng = np.random.RandomState(0)
    ts = jl.init(jax.random.PRNGKey(1), _EnvState(5, 6))
    params = ts.params.replace(target_q=jax.tree.map(lambda x: x * 0.9, ts.params.target_q),
                               log_alpha=jnp.float32(-0.3))
    norm = ts.normalizer.replace(mean=jnp.asarray(rng.randn(6).astype(np.float32)),
                                 std=jnp.asarray((rng.rand(6) + 0.5).astype(np.float32)))
    jts = ts.replace(params=params, normalizer=norm)
    return jl, tl, jts, interop.training_state_from_numpy(jax.device_get(jts), tl)


def _seq(rng, L=8, B=7, per=False):
    seq = dict(obs=rng.randn(L, B, 6), action=np.tanh(rng.randn(L, B, 2)),
               reward=rng.randn(L, B), done=rng.rand(L, B) < 0.2,
               truncation=rng.rand(L, B) < 0.3, final_obs=rng.randn(L, B, 6),
               h0=rng.randn(B, 8) * 0.3)
    if per:
        seq["is_weight"] = rng.rand(B)
    return {k: np.asarray(v, np.float32) for k, v in seq.items()}


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(got, torch.Tensor) else got),
                               np.asarray(want), rtol=tol, atol=tol, err_msg=msg)


def test_actor_and_critic_rolls_match_jax():
    jl, tl, jts, tts = _pair()
    seq = _seq(np.random.RandomState(1))
    obs, done = seq["obs"], seq["done"]
    h = seq["h0"][:, :8]
    # one step each
    jh, jdp = jl.actor.apply(jts.params.policy, h, obs[0])
    th, tdp = tts.params.policy(torch.from_numpy(h), torch.from_numpy(obs[0]))
    _close(th, jh, 1e-5), _close(tdp, jdp, 1e-5)
    # done-masked rolls
    (jh_end, jdps) = jl._actor_roll(jts.params.policy, h, obs, done)
    th_end, tdps = tl._actor_roll(tts.params.policy, torch.from_numpy(h), torch.from_numpy(obs),
                                  torch.from_numpy(done))
    _close(th_end, jh_end, 1e-5, "actor h"), _close(tdps, jdps, 1e-5, "actor dist params")
    hq = np.stack([h, -h]) * 0.5
    jhq, jy = jl._critic_roll(jts.params.q, hq, obs, done)
    thq, ty = tl._critic_roll(tts.params.q, torch.from_numpy(hq), torch.from_numpy(obs),
                              torch.from_numpy(done))
    _close(thq, jhq, 1e-5, "critic h"), _close(ty, jy, 1e-5, "critic features")
    jq = jl._q_head(jts.params.q, jy, seq["action"])
    tq = tts.params.q.q_head(ty, torch.from_numpy(seq["action"]))
    assert tq.shape == (8, 7, 2)
    _close(tq, jq, 1e-5, "q head")


@pytest.mark.parametrize("n", [1, 5])
def test_nstep_targets_match_jax(n):
    rng = np.random.RandomState(n)
    r, v = rng.randn(9, 4).astype(np.float32), rng.randn(9, 4).astype(np.float32)
    nt = (rng.rand(9, 4) > 0.2).astype(np.float32)
    want = jrs.nstep_targets(jnp.asarray(r), jnp.asarray(nt), jnp.asarray(v), 0.97, n)
    got = sac_rnn.nstep_targets(torch.from_numpy(r), torch.from_numpy(nt), torch.from_numpy(v),
                                0.97, n)
    _close(got, want, 1e-6)


def _flat_grads(module):
    return interop.flat_to_numpy(module, torch.cat([
        (p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
        for p in module.parameters()]))


@pytest.mark.parametrize("per,nstep", [(False, 1), (True, 5)], ids=["uniform", "per_nstep5"])
def test_losses_and_gradients_match_jax(per, nstep):
    jl, tl, jts, tts = _pair(nstep=nstep)
    seq = _seq(np.random.RandomState(2), per=per)
    key = jax.random.PRNGKey(3)
    critic, actor, logp, td = jl._losses(jts.params, jts.normalizer, seq, key)
    (_, _), jq_grads = jax.value_and_grad(jl._critic_loss, has_aux=True)(
        jts.params.q, jts.params, jts.normalizer, seq, key)
    (_, _), jp_grads = jax.value_and_grad(jl._actor_loss, has_aux=True)(
        jts.params.policy, jts.params, jts.normalizer, seq, key)
    tseq = {k: torch.from_numpy(v) for k, v in seq.items()}
    p = tts.params
    c = tl._losses(p, tts.normalizer, tseq, jr.PRNGKey(3), actor=False)
    c["critic_loss"].backward()
    a = tl._losses(p, tts.normalizer, tseq, jr.PRNGKey(3), critic=False)
    a["actor_loss"].backward()
    both = tl._losses(p, tts.normalizer, tseq, jr.PRNGKey(3))
    for got, want, name in ((c["critic_loss"], critic, "critic"), (a["actor_loss"], actor, "actor"),
                            (a["logp"], logp, "logp"), (c["td_seq"], td, "td")):
        _close(got, want, 1e-5, name)
    _close(both["critic_loss"], critic, 1e-5), _close(both["actor_loss"], actor, 1e-5)
    for module, tree in ((p.q, jq_grads), (p.policy, jp_grads)):
        want = np.concatenate([np.asarray(g).reshape(-1) for g in jax.tree_util.tree_leaves(tree)])
        np.testing.assert_allclose(_flat_grads(module), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())
    assert all(t.grad is None for t in p.target_q.parameters())


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, np.asarray(tree)


EPOCH = dict(num_envs=8, episode_length=12, seq_len=6, burn_in=2, replay_capacity=4,
             batch_size=4, seqs_per_epoch=2, grad_steps_per_seq=2, min_replay=1, nstep=3,
             **NETS)
# (env, config changes, carry env): `fast` with PER and a carry env, `fast`
# with the actor frozen, InvertedPendulum (episodes end) with PER
CASES = {"fast_per_carry": ("fast", dict(per_alpha=0.6), True),
         "fast_freeze": ("fast", dict(actor_freeze_epochs=1), False),
         "pendulum_per": ("pendulum", dict(per_alpha=0.6), False)}
# the pole's quaternion x and z: exactly 0 in the port, round-off of up to
# 7e-9 in JAX, which the statistics' std floor (1e-3) scales to 7e-6 and
# Adam, dividing each gradient entry by its own magnitude, turns into
# steps of up to the learning rate on the encoder rows they feed; both
# packages' envs hold them at 0 here
OFF_PLANE = [2, 4]


class _JPendulumInPlane(JPendulum):
    def _get_obs(self, qp):
        return super()._get_obs(qp).at[jnp.asarray(OFF_PLANE)].set(0.0)


class _PendulumInPlane(InvertedPendulum):
    def _get_obs(self, qp):
        return super()._get_obs(qp).index_fill(-1, torch.tensor(OFF_PLANE), 0.0)


ENVS = {"fast": (JFast, Fast), "pendulum": (_JPendulumInPlane, _PendulumInPlane)}


@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    """Per case: (JAX's and the port's final checkpoint, their metrics) after
    each `train` resumed one epoch from the same JAX-drawn checkpoint."""
    out = {}

    def run(case):
        if case in out:
            return out[case]
        env_name, changes, carry = CASES[case]
        jenv, tenv = ENVS[env_name]
        kw = dict(EPOCH, **changes)
        root = tmp_path_factory.mktemp(case)
        cfg = jrs.RSACConfig(**kw)
        per_epoch = cfg.seqs_per_epoch * cfg.seq_len * cfg.num_envs
        obs_size = jenv().observation_size
        sizes = _Sizes(observation_size=obs_size, action_size=1)
        jl = jrs.RSACLearner(sizes, cfg)
        ts = jl.init(jax.random.PRNGKey(7), _EnvState(8, obs_size))
        ts = ts.replace(epochs=jnp.int32(2), params=ts.params.replace(log_alpha=jnp.float32(-0.2)))
        jckpt.save_step(str(root / "jax"), 2 * per_epoch, jrs._ckpt_slice(ts))
        tl = sac_rnn.RSACLearner(sizes, sac_rnn.RSACConfig(**kw))
        ckpt.save_step(str(root / "torch"), 2 * per_epoch,
                       interop.training_state_from_numpy(jax.device_get(jrs._ckpt_slice(ts)), tl))
        jh, th = [], []
        jrs.train(jenv(), seed=0, checkpoint_dir=str(root / "jax"), num_timesteps=3 * per_epoch,
                  progress_fn=lambda s, m: jh.append(m), watchdog_deadline_s=None,
                  carry_env=jenv() if carry else None, **kw)
        sac_rnn.train(tenv(device="cpu"), seed=0, checkpoint_dir=str(root / "torch"),
                      num_timesteps=3 * per_epoch, progress_fn=lambda s, m: th.append(m),
                      carry_env=tenv(device="cpu") if carry else None, **kw)
        template = jl.init(jax.random.PRNGKey(0), _EnvState(8, obs_size))
        want = jax.device_get(jckpt.restore(jckpt.latest_step_dir(str(root / "jax")),
                                            template=jrs._ckpt_slice(template)))
        got = interop.training_state_to_numpy(ckpt.restore(
            ckpt.latest_step_dir(str(root / "torch")), tl.init(jr.PRNGKey(0))))
        out[case] = (want, got, jh, th)
        return out[case]

    return run


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_epoch_from_checkpoint_matches_jax(resumed, case):
    want, got, jh, th = resumed(case)
    assert len(jh) == len(th) == 1
    for k in ("q_loss", "actor_loss", "alpha", "mean_reward"):
        np.testing.assert_allclose(th[0][k], jh[0][k], rtol=1e-4, atol=1e-6, err_msg=k)
    assert int(got["epochs"]) == int(want["epochs"]) == 3
    for k, v in got["normalizer"].items():
        np.testing.assert_allclose(v, np.asarray(getattr(want["normalizer"], k)), rtol=1e-6,
                                   atol=1e-6)
    for name in ("policy_opt", "q_opt", "alpha_opt"):
        assert got[name]["count"] == int(interop._find_adam(want[name]).count), name
    assert got["q_opt"]["count"] == 4
    # the freeze keeps the actor and the temperature where the checkpoint had them
    frozen = case.endswith("freeze")
    assert (got["policy_opt"]["count"] == 0) == frozen
    assert (float(got["params"]["log_alpha"]) == np.float32(-0.2)) == frozen
    for f in ("policy", "q", "target_q"):
        want_p = dict(_leaves(interop._as_tree(getattr(want["params"], f))))
        for path, g in _leaves(got["params"][f]):
            np.testing.assert_allclose(g, want_p[path], rtol=0, atol=5e-5, err_msg=f"{f} {path}")
    _close(got["params"]["log_alpha"], want["params"].log_alpha, 5e-5)
    for name in ("policy_opt", "q_opt", "alpha_opt"):
        adam = interop._find_adam(want[name])
        for k in ("mu", "nu"):
            w = np.asarray(getattr(adam, k))
            np.testing.assert_allclose(got[name][k], w, rtol=1e-5, atol=1e-5 * np.abs(w).max(),
                                       err_msg=f"{name} {k}")


def test_carry_columns_step_in_the_carry_env():
    calls = []

    def spy(env, name):
        step = env.step

        def wrapped(state, action):
            calls.append((name, state.obs.shape[0], action.shape[0]))
            return step(state, action)

        env.step = wrapped
        return env

    def make(batch, name):
        env = wrappers.VmapWrapper(wrappers.EpisodeWrapper(Fast(device="cpu"), 10, 1), batch)
        return spy(wrappers.randomized_autoreset(env, "naive"), name)

    cfg = sac_rnn.RSACConfig(num_envs=6, **NETS)
    learner = sac_rnn.RSACLearner(make(4, "train"), cfg, carry_env=make(2, "carry"),
                                  carry_envs=2)
    state = sac_rnn.tree_concat(learner.carry_env.reset(jr.split(jr.PRNGKey(0), 2)),
                                learner.env.reset(jr.split(jr.PRNGKey(1), 4)))
    action = torch.tensor([[1.0], [1.0], [-1.0], [-1.0], [-1.0], [-1.0]])
    out = learner._step_envs(state, action)
    assert calls == [("carry", 2, 2), ("train", 4, 4)]
    assert out.obs.shape == (6, 2) and (out.obs[:2, 1] > 0).all() and (out.obs[2:, 1] < 0).all()


def test_train_resumes_from_its_checkpoint(tmp_path):
    kw = dict(EPOCH, num_envs=4)
    per_epoch = kw["seqs_per_epoch"] * kw["seq_len"] * kw["num_envs"]
    root = str(tmp_path)
    _, _, first = sac_rnn.train(InvertedPendulum(device="cpu"), seed=3, checkpoint_dir=root,
                                num_timesteps=2 * per_epoch, progress_fn=lambda s, m: None,
                                **kw)
    assert len(first) == 2
    steps = []
    _, params, second = sac_rnn.train(InvertedPendulum(device="cpu"), seed=3,
                                      checkpoint_dir=root, num_timesteps=3 * per_epoch,
                                      progress_fn=lambda s, m: steps.append(s), **kw)
    assert steps == [3 * per_epoch] and len(second) == 1
    assert all(np.isfinite(m[k]) for m in first + second for k in ("q_loss", "actor_loss"))
    template = sac_rnn.RSACLearner(_Sizes(observation_size=10, action_size=1),
                                   sac_rnn.RSACConfig(**kw)).init(jr.PRNGKey(0))
    final = ckpt.restore(ckpt.latest_step_dir(root), template)
    assert final.epochs == 3 and final.q_opt.count == 3 * 4
    for a, b in zip(final.params.policy.parameters(), params[1].parameters()):
        assert torch.equal(a, b)
