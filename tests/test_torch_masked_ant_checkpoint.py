"""The masked-ant memory study the port trained on the H100 at
examples/train_masked_ant.py's recipe (`ant`, VELOCITY hidden, 100M
env-steps an arm, 2048 envs, naive autoreset, MASKED_SEED 0), carried back
into the JAX package, on the CPU.

  * pobrax_tpu_torch/checkpoints/masked_ant_{ff_full,ff_masked,gru_masked}
    _100M_torch.npz (written by `pobrax_tpu_torch.tools.export_run_checkpoint
    --masked-ant ARM` from each arm's last step dir: params, normalizer and
    epochs) load through `eval_checkpoint.load_masked_ant` with their
    checksums equal, and `interop.training_state_to_numpy` of each loaded
    state gives the file's arrays back bit for bit; the export tool writes
    the same entries from a step dir the port saved; each parameter tree has
    the JAX learner's structure and shapes;
  * each arm's committed progress log (beside its npz) holds the record's
    calls and evaluation, at seed 0 and the recipe's env and envs;
  * one policy step of each arm, deterministic and stochastic, of the port
    against JAX's `ppo` / `ppo_rnn` inference on the carried parameters, from
    one seeded JAX reset of the arm's env (and a nonzero hidden state for
    the GRU) and one key, within 1e-5;
  * the GRU-masked arm in JAX's own masked `ant` env, through JAX's
    example's `eval_policy` with JAX's GRU inference, cut to
    ROLLOUT_EPISODES episodes of ROLLOUT_STEPS steps, walks at least
    MIN_SHARE of the record's torso x-displacement pro rata.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import examples.train_masked_ant as jmasked_ant
from pobrax_tpu.envs import _envs as jenvs
from pobrax_tpu.training import ppo as jppo
from pobrax_tpu.training import ppo_rnn as jrnn
from pobrax_tpu.training import running_statistics as jrs
from pobrax_tpu_torch import eval_checkpoint, interop
from pobrax_tpu_torch import random as jr
from pobrax_tpu_torch.examples import train_masked_ant
from pobrax_tpu_torch.examples._common import merged_calls
from pobrax_tpu_torch.tools import export_run_checkpoint
from pobrax_tpu_torch.training import checkpoint as ckpt

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECORD = os.path.join(ROOT, "pobrax_tpu_torch", "docs", "learning_masked_ant.json")
ARMS = train_masked_ant.ARMS
HIDDEN = train_masked_ant.HIDDEN
# 100,000,000 env-steps in epochs of 2048 x 32: 1,526 epochs, the last whole
EPOCHS = 1526
# The GRU-masked arm in JAX's env: 4 episodes of 200 steps (JAX's scan of the
# ant with the GRU compiles and runs in a few seconds on the CPU, 1000 steps
# would take ~5x the run). Its record walks x_displacement metres in 1,000
# steps on average, so x_displacement / 5 in 200 at the same pace. The first
# steps start from rest (the record's pace includes its own start, once per
# 1,000 steps), and JAX's closed loop parts from the port's within a few
# steps, each stride on its own numbers; a policy that walks, as the record's
# does, keeps well over half its pace, and one that stands or falls keeps
# none. So the gate is MIN_SHARE = 0.5 of the pro-rata displacement.
ROLLOUT_EPISODES, ROLLOUT_STEPS, MIN_SHARE = 4, 200, 0.5


def _record():
    with open(RECORD) as f:
        return json.load(f)


def _log(arm):
    return eval_checkpoint.masked_ant_npz(arm)[:-len(".npz")] + ".progress.jsonl"


@functools.lru_cache(maxsize=None)
def _arm(arm):
    """(port learner, port state, the npz's entries), loaded once per test
    process."""
    learner, ts, same = eval_checkpoint.load_masked_ant(arm, device="cpu")
    assert same
    return learner, ts, ckpt.load_npz(eval_checkpoint.masked_ant_npz(arm))


def _jax_env(arm):
    return jenvs["ant"]() if arm == "ff_full" else jmasked_ant.masked_env()


@functools.lru_cache(maxsize=None)
def _jax_policy(arm):
    """(JAX inference fn, JAX params tuple on the npz's parameters, the
    shapes of the JAX learner's initial parameters)."""
    _, _, tree = _arm(arm)
    if arm == "gru_masked":
        jl = jrnn.RNNPPOLearner(_jax_env(arm), jrnn.RNNPPOConfig(
            num_envs=8, num_minibatches=8, hidden_size=HIDDEN, encoder_sizes=(256,)))
    else:
        jl = jppo.PPOLearner(_jax_env(arm), jppo.PPOConfig(num_envs=8, num_minibatches=8))
    shapes = jax.eval_shape(jl.init, jax.random.PRNGKey(0)).params
    if arm != "gru_masked":
        shapes = {"policy": shapes.policy, "value": shapes.value}
    normalizer = jrs.RunningStatisticsState(**{k: jnp.asarray(v)
                                               for k, v in tree["normalizer"].items()})
    params = jax.tree_util.tree_map(jnp.asarray, tree["params"])
    return (jl.make_inference_fn(),
            (normalizer, params if arm == "gru_masked" else params["policy"]),
            jax.tree_util.tree_map(lambda x: tuple(x.shape), shapes))


def _flat(tree):
    return dict(export_run_checkpoint.leaves(tree))


@pytest.mark.parametrize("arm", ARMS)
def test_npz_loads_with_its_checksum_into_jax_shapes(arm):
    _, ts, tree = _arm(arm)
    assert interop.params_checksum(tree["params"]) == tree["params_sha256"]
    assert ts.epochs == EPOCHS
    assert os.path.getsize(eval_checkpoint.masked_ant_npz(arm)) < 3_000_000
    _, _, shapes = _jax_policy(arm)
    assert shapes == jax.tree_util.tree_map(np.shape, tree["params"])


@pytest.mark.parametrize("arm", ARMS)
def test_log_holds_the_records_calls_and_evaluation(arm):
    record = _record()
    with open(_log(arm)) as f:
        log = [json.loads(line) for line in f if line.strip()]
    assert {(e["seed"], json.dumps(e["recipe"])) for e in log if "call" in e} == {
        (0, json.dumps({"env": "ant", "num_envs": 2048}))}
    assert merged_calls([e for e in log if "evaluation" not in e]) == record["calls"][arm]
    assert record["calls"][arm][-1]["to"] == EPOCHS * 2048 * 32
    evaluations = [e for e in log if "evaluation" in e]
    assert [e["steps"] for e in evaluations] == [EPOCHS * 2048 * 32]
    assert evaluations[0]["evaluation"] == record[train_masked_ant.RESULT_KEYS[arm]]
    assert {k: record[k] for k in ("env", "hidden", "num_timesteps", "num_envs",
                                   "episode_cap")} == {
        "env": "ant", "hidden": ["VELOCITY"], "num_timesteps": 100_000_000, "num_envs": 2048,
        "episode_cap": 1000}
    assert all("H100" in c["card"] for c in record["calls"][arm])


@pytest.mark.parametrize("arm", ARMS)
def test_state_round_trips_bit_for_bit(arm, tmp_path):
    """npz -> the port's state -> numpy: the file's arrays, bit for bit;
    and a state the port saved, through the export tool's `--masked-ant`,
    writes the same entries."""
    _, ts, _ = _arm(arm)
    got = _flat(interop.training_state_to_numpy(ts))
    with np.load(eval_checkpoint.masked_ant_npz(arm), allow_pickle=False) as z:
        want = {k: z[k] for k in z.files if k != "params_sha256"}
    assert sorted(want) == sorted(k for k in got if not k.startswith("opt_state/"))
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        assert got[k].tobytes() == w.tobytes(), k
    ckpt.save_step(str(tmp_path / "ckpt"), 123, ts)
    out = str(tmp_path / "out.npz")
    export_run_checkpoint.export(str(tmp_path / "ckpt"), out, device="cpu",
                                 name=export_run_checkpoint.MASKED_ANT + arm)
    with np.load(out, allow_pickle=False) as z:
        assert sorted(z.files) == sorted([*want, "params_sha256"])
        assert all(z[k].tobytes() == w.tobytes() for k, w in want.items())


@pytest.mark.parametrize("deterministic", [True, False], ids=["det", "stoch"])
@pytest.mark.parametrize("arm", ARMS)
def test_one_policy_step_follows_jax(arm, deterministic):
    """On 4 observations drawn from a seed around the arm's normalizer (its
    mean plus a standard normal times its std: what the policy saw in
    training, without the seconds JAX's env reset takes to compile)."""
    learner, ts, tree = _arm(arm)
    jinf, jparams, _ = _jax_policy(arm)
    norm = tree["normalizer"]
    obs = (norm["mean"] + norm["std"] * np.random.default_rng(5).normal(
        size=(4, norm["mean"].shape[0]))).astype(np.float32)
    inference_fn, params = learner.make_inference_fn(), learner.inference_params(ts)
    if arm == "gru_masked":
        h = np.random.default_rng(0).normal(0, 0.3, (4, HIDDEN)).astype(np.float32)
        jh, jact = jinf(jparams, jnp.asarray(h), jnp.asarray(obs), jax.random.PRNGKey(3),
                        deterministic=deterministic)
        th, tact = inference_fn(params, torch.as_tensor(h), torch.as_tensor(obs),
                                jr.PRNGKey(3), deterministic=deterministic)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0, atol=1e-5)
    else:
        jact = jinf(jparams, jnp.asarray(obs), jax.random.PRNGKey(3),
                    deterministic=deterministic)
        tact = inference_fn(params, torch.as_tensor(obs), jr.PRNGKey(3),
                            deterministic=deterministic)
    np.testing.assert_allclose(tact.numpy(), np.asarray(jact), rtol=0, atol=1e-5)
    assert float(np.abs(np.asarray(jact)).max()) > 0.1


def test_gru_arm_walks_in_jax_env(monkeypatch):
    jinf, jparams, _ = _jax_policy("gru_masked")
    monkeypatch.setattr(jmasked_ant, "EPISODE_LENGTH", ROLLOUT_STEPS)
    got = jmasked_ant.eval_policy(
        jmasked_ant.masked_env(),
        lambda h, obs, k: jinf(jparams, h, obs, k, deterministic=True),
        carry_init=lambda n: jnp.zeros((n, HIDDEN)), episodes=ROLLOUT_EPISODES, seed=0)
    want = _record()["gru_masked"]["x_displacement"] * ROLLOUT_STEPS / 1000
    print(f"JAX's masked ant, {ROLLOUT_EPISODES} det episodes of {ROLLOUT_STEPS} steps: {got} "
          f"(pro rata {want:.2f} m)")
    assert got["x_displacement"] >= MIN_SHARE * want, got
