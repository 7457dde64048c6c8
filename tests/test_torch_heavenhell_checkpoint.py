"""The AntHeavenHell GRU-PPO policy the port trained on the H100 at
examples/train_heavenhell_rnn.py's recipe (400M env-steps, 2048 envs, seed 0),
carried back into the JAX package, on the CPU.

  * pobrax_tpu_torch/checkpoints/ant_heavenhell_rnn_400M.npz (written by
    `pobrax_tpu_torch.tools.export_run_checkpoint` from the run's last step
    dir) loads through `eval_checkpoint.load("heavenhell")` with its
    checksum equal, and `interop.training_state_to_numpy` of the loaded
    state gives the file's arrays back bit for bit; the export tool writes
    the same entries from a step dir the port saved;
  * one GRU policy step, deterministic and stochastic, of the port against
    JAX's `ppo_rnn` inference on the carried parameters, from one seeded JAX
    reset, one nonzero hidden state and one key, within 1e-5;
  * the port-trained policy in JAX's own env: examples/train_heavenhell_rnn's
    `outcome_rates`, 16 episodes of 1000 control steps at action_repeat 6,
    deterministic, reset seed 0, with JAX's GRU inference, meets GATES;
  * `eval_checkpoint.evaluate` runs `outcome_rates` det at seed 0 and stoch
    at seed 1 (the example's), and `--html` with `--heavenhell` raises.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import examples.train_heavenhell_rnn as jhh
from pobrax_tpu.envs import HAI_ACTION_REPEAT
from pobrax_tpu.envs import _envs as jenvs
from pobrax_tpu.envs import wrappers as jw
from pobrax_tpu.training import ppo_rnn as jrnn
from pobrax_tpu_torch import eval_checkpoint, interop
from pobrax_tpu_torch import random as jr
from pobrax_tpu_torch.envs import _envs
from pobrax_tpu_torch.examples import train_heavenhell_rnn
from pobrax_tpu_torch.tools import export_run_checkpoint
from pobrax_tpu_torch.training import checkpoint as ckpt

torch.set_num_threads(1)

HIDDEN, EPISODES = 128, 16
# The policy's deterministic result on the H100 over 256 episodes was
# completion 1.000 and heaven rate 1.000
# (pobrax_tpu_torch/docs/learning_heavenhell_rnn.json). 256 of 256 bounds
# the rate below only by the rule of three, p >= 1 - 3/256 = 0.988 (95%). At
# that p, 16 episodes miss 0.19 on average with a binomial spread of
# sqrt(16 p (1 - p)) = 0.43 episodes; the gates allow 2 misses of 16 (four
# spreads above the mean; 3 or more come with probability 0.08%), since
# JAX's closed loop parts from the port's within a few control steps.
GATES = {"completion": 14 / 16, "heaven": 14 / 16}


@functools.lru_cache(maxsize=None)
def _pair():
    """(JAX inference fn, JAX (normalizer, params), port learner, port
    state, the npz's entries), loaded once per test process."""
    learner, ts, same = eval_checkpoint.load("heavenhell", device="cpu")
    assert same
    tree = ckpt.load_npz(eval_checkpoint.npz_path("heavenhell"))
    jenv = jw.VmapWrapper(jw.EpisodeWrapper(jw.ActionRepeatWrapper(
        jenvs["ant_heavenhell"](), HAI_ACTION_REPEAT), 1000, 1), batch_size=8)
    jl = jrnn.RNNPPOLearner(jenv, jrnn.RNNPPOConfig(num_envs=8, num_minibatches=8,
                                                    hidden_size=HIDDEN, encoder_sizes=(256,)))
    jts = jl.init(jax.random.PRNGKey(0))
    normalizer = jts.normalizer.replace(**{k: jnp.asarray(v)
                                           for k, v in tree["normalizer"].items()})
    params = jax.tree_util.tree_map(jnp.asarray, tree["params"])
    return jl.make_inference_fn(), (normalizer, params), learner, ts, tree


def _flat(tree):
    return dict(export_run_checkpoint.leaves(tree))


def test_npz_loads_with_its_checksum():
    _, _, learner, ts, tree = _pair()
    assert interop.params_checksum(tree["params"]) == tree["params_sha256"]
    assert ts.epochs == 1018  # 400M env-steps of 2048 x 32 x 6 a epoch, the last one whole
    assert os.path.getsize(eval_checkpoint.npz_path("heavenhell")) < 2_600_000


def test_state_round_trips_bit_for_bit():
    _, _, _, ts, tree = _pair()
    got = _flat(interop.training_state_to_numpy(ts))
    with np.load(eval_checkpoint.npz_path("heavenhell"), allow_pickle=False) as z:
        want = {k: z[k] for k in z.files if k != "params_sha256"}
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        assert got[k].tobytes() == w.tobytes(), k


def test_export_tool_writes_a_saved_state(tmp_path):
    """A state the port saved (`save_step`) through the export tool and
    `eval_checkpoint.load`: the same leaves, bit for bit."""
    _, _, _, ts, _ = _pair()
    ckpt.save_step(str(tmp_path / "ckpt"), 123, ts)
    out = str(tmp_path / "out" / "hh.npz")
    export_run_checkpoint.export(str(tmp_path / "ckpt"), out, device="cpu")
    _, back, same = eval_checkpoint.load("heavenhell", device="cpu", npz=out)
    assert same and back.epochs == ts.epochs
    want, got = _flat(interop.training_state_to_numpy(ts)), _flat(
        interop.training_state_to_numpy(back))
    assert all(got[k].tobytes() == w.tobytes() for k, w in want.items())


@pytest.mark.parametrize("deterministic", [True, False], ids=["det", "stoch"])
def test_one_policy_step_follows_jax(deterministic):
    jinf, jparams, learner, ts, _ = _pair()
    state = jax.jit(jax.vmap(jenvs["ant_heavenhell"]().reset))(
        jax.random.split(jax.random.PRNGKey(5), 4))
    h = np.random.default_rng(0).normal(0, 0.3, (4, HIDDEN)).astype(np.float32)
    jh, jact = jinf(jparams, jnp.asarray(h), state.obs, jax.random.PRNGKey(3),
                    deterministic=deterministic)
    th, tact = learner.make_inference_fn()(learner.inference_params(ts), torch.as_tensor(h),
                                           torch.as_tensor(np.array(state.obs)),
                                           jr.PRNGKey(3), deterministic=deterministic)
    np.testing.assert_allclose(tact.numpy(), np.asarray(jact), rtol=0, atol=1e-5)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0, atol=1e-5)
    assert float(np.abs(np.asarray(jact)).max()) > 0.1


def test_port_policy_in_jax_env():
    jinf, jparams, _, _, _ = _pair()
    completion, heaven = jhh.outcome_rates(
        jenvs["ant_heavenhell"](),
        lambda h, obs, k: jinf(jparams, h, obs, k, deterministic=True),
        carry_init=lambda n: jnp.zeros((n, HIDDEN)), episodes=EPISODES, seed=0,
        action_repeat=HAI_ACTION_REPEAT)
    print(f"JAX's env, {EPISODES} det episodes at seed 0: completion {completion:.4f}, "
          f"heaven {heaven:.4f}")
    assert completion >= GATES["completion"] and heaven >= GATES["heaven"], (completion, heaven)


def test_evaluate_runs_outcome_rates_at_the_examples_seeds(monkeypatch):
    _, _, learner, ts, _ = _pair()
    calls = []

    def recorder(core, act_fn, carry_init, episodes, seed, action_repeat):
        assert carry_init(3).shape == (3, HIDDEN) and type(core) is type(
            _envs["ant_heavenhell"](device="cpu"))
        calls.append((episodes, seed, action_repeat))
        return 0.5 + seed / 4, 0.25

    monkeypatch.setattr(eval_checkpoint, "outcome_rates", recorder)
    got = eval_checkpoint.evaluate("heavenhell", learner, ts, episodes=7)
    assert calls == [(7, 0, HAI_ACTION_REPEAT), (7, 1, HAI_ACTION_REPEAT)]
    assert got == {"det_completion": 0.5, "det_heaven": 0.25, "stoch_completion": 0.75,
                   "stoch_heaven": 0.25}
    calls.clear()
    got = eval_checkpoint.evaluate("heavenhell", learner, ts, episodes=7, seeds=[2],
                                   modes=["stoch"])
    assert calls == [(7, 2, HAI_ACTION_REPEAT)] and set(got) == {"stoch_completion_s2",
                                                                  "stoch_heaven_s2"}
    assert train_heavenhell_rnn.HIDDEN == HIDDEN


def test_html_raises_for_heavenhell(tmp_path):
    with pytest.raises(ValueError, match="no renderer"):
        eval_checkpoint.main("heavenhell", device="cpu", html_out=str(tmp_path / "hh.html"))
