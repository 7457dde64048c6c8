"""The AntTag GRU-PPO policy the port trained on the H100 with
examples/train_ant_tag_rnn.py's visibility curriculum (radius 20 -> 6 -> 4,
2048 envs, seed 0, `--curriculum --checkpoint-dir`, resumed across calls),
carried back into the JAX package, on the CPU.

The run is complete: the committed file is its final state at 900,071,424
env-steps (`eval_tag_checkpoint.PORT_NPZ`, the full training state and its
epoch count, 2,289, written by `tools/export_run_checkpoint.py --tag` from
the run's last step dir), with the run's progress log beside it and its
record `eval_tag_checkpoint.PORT_RECORD` (`main_curriculum`'s, written on
the card when phase 3 ended: the true-env rates of that state, the calls
that trained it).

  * the npz loads through `eval_tag_checkpoint.load` with its checksum
    equal, at the record's epoch count, and `interop.training_state_to_numpy`
    of the loaded state gives the file's arrays back bit for bit; the export
    tool writes the same entries from a step dir the port saved;
  * `train_ant_tag_rnn.seed_checkpoint_dir` turns it into the step dir a
    resumed run starts from, with the progress log; that log holds the
    replays of the first two phase ends, as the record does;
  * the record's `calls` chain from 0 to the end, each on an NVIDIA card
    named with its power limit, `wall_s` is their training seconds, and
    the record holds every key of JAX's own curriculum record;
  * one GRU policy step, deterministic and stochastic, of the port against
    JAX's `ppo_rnn` inference on the carried parameters, from one seeded JAX
    reset, one nonzero hidden state and one key, within 1e-5;
  * the port-trained policy in JAX's own true AntTag env (visible radius 3,
    the env's default; a record cut inside the curriculum would name its
    `training_radius`), with JAX's GRU inference: 16 det episodes at reset
    seed 0 (JAX's `tag_rate_rnn` key order, stopped once every episode has
    ended), gated a few episodes under the card's rate.
"""

import functools
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pobrax_tpu.envs import HAI_ACTION_REPEAT
from pobrax_tpu.envs import _envs as jenvs
from pobrax_tpu.envs import wrappers as jw
from pobrax_tpu.training import ppo_rnn as jrnn
from pobrax_tpu_torch import eval_tag_checkpoint, interop
from pobrax_tpu_torch import random as jr
from pobrax_tpu_torch.examples import train_ant_tag_rnn
from pobrax_tpu_torch.tools import export_run_checkpoint
from pobrax_tpu_torch.training import checkpoint as ckpt

torch.set_num_threads(1)

HIDDEN, EPISODES = 128, 16
NPZ = eval_tag_checkpoint.PORT_NPZ
FINAL_STEPS, FINAL_EPOCHS = 900_071_424, 2289  # the curriculum's last whole epoch
TRUE_RADIUS = 3.0  # AntTag's default visible radius: the true env
JAX_RECORD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "docs",
                          "learning_ant_tag_curriculum_seed1.json")


def _record() -> dict:
    with open(eval_tag_checkpoint.PORT_RECORD) as f:
        return json.load(f)


@functools.lru_cache(maxsize=None)
def _pair():
    """(JAX inference fn, JAX (normalizer, params), port learner, port
    state, the npz's entries), loaded once per test process."""
    learner, ts, same = eval_tag_checkpoint.load(NPZ, device="cpu")
    assert same
    tree = ckpt.load_npz(NPZ)
    jenv = jw.VmapWrapper(jw.EpisodeWrapper(jw.ActionRepeatWrapper(
        jenvs["ant_tag"](), HAI_ACTION_REPEAT), 1000, 1), batch_size=8)
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
    _, _, _, ts, tree = _pair()
    record = _record()
    assert interop.params_checksum(tree["params"]) == tree["params_sha256"]
    assert ts.epochs == record["epochs"] == FINAL_EPOCHS and not record.get("partial")
    assert record["steps"] == ts.epochs * 2048 * 32 * HAI_ACTION_REPEAT == FINAL_STEPS
    assert record["calls"][-1]["to"] == record["steps"]
    assert os.path.getsize(NPZ) < 2_600_000


def test_state_round_trips_bit_for_bit():
    _, _, _, ts, _ = _pair()
    got = _flat(interop.training_state_to_numpy(ts))
    with np.load(NPZ, allow_pickle=False) as z:
        want = {k: z[k] for k in z.files if k != "params_sha256"}
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        assert got[k].tobytes() == w.tobytes(), k


def test_export_tool_writes_a_saved_state(tmp_path):
    """A state the port saved (`save_step`) through the export tool with
    `--tag` and `eval_tag_checkpoint.load`: the same leaves, bit for bit."""
    _, _, _, ts, _ = _pair()
    ckpt.save_step(str(tmp_path / "ckpt"), 123, ts)
    out = str(tmp_path / "out" / "tag.npz")
    export_run_checkpoint.export(str(tmp_path / "ckpt"), out, device="cpu", name="tag")
    _, back, same = eval_tag_checkpoint.load(out, device="cpu")
    assert same and back.epochs == ts.epochs
    want, got = _flat(interop.training_state_to_numpy(ts)), _flat(
        interop.training_state_to_numpy(back))
    assert sorted(got) == sorted(want)
    assert all(got[k].tobytes() == w.tobytes() for k, w in want.items())


def test_seed_checkpoint_dir_starts_the_resumed_run(tmp_path):
    """`--resume-from` of the committed state: its step dir sits where the
    run left off and restores the state bit for bit; the progress log comes
    along, so the record's curve and calls go on from the committed ones; a
    dir that already holds a step dir is left alone."""
    _, _, learner, ts, _ = _pair()
    root = str(tmp_path / "ckpt")
    path = train_ant_tag_rnn.seed_checkpoint_dir(root, NPZ, device="cpu")
    record = _record()
    assert os.path.basename(path) == f"step_{record['steps']:012d}"
    back = ckpt.restore(path, learner.init(jr.PRNGKey(1)))
    want, got = _flat(interop.training_state_to_numpy(ts)), _flat(
        interop.training_state_to_numpy(back))
    assert all(got[k].tobytes() == w.tobytes() for k, w in want.items())
    with open(os.path.join(root, "progress.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    assert [c for c in lines if "call" in c][0]["call"] == 0
    assert max(e.get("steps", 0) for e in lines) == record["steps"]
    assert train_ant_tag_rnn.seed_checkpoint_dir(root, NPZ, device="cpu") is None


def test_progress_log_holds_the_phase_ends():
    """The progress log committed beside the npz: its `phase_end` entries are
    the curriculum's first two phase ends (300M and 600M), each once, equal to
    the record's `phase_ends`; its last kept report is at the npz's epochs."""
    _, _, _, ts, _ = _pair()
    with open(NPZ[:-len(".npz")] + ".progress.jsonl") as f:
        lines = [json.loads(line) for line in f]
    per_epoch = train_ant_tag_rnn.steps_per_epoch(2048)
    ends = [e for e in lines if "phase_end" in e]
    assert [(e["phase_end"], e["steps"]) for e in ends] == [
        (radius, train_ant_tag_rnn.phase_end(total, per_epoch))
        for radius, total in train_ant_tag_rnn.CURRICULUM[:2]]
    assert ends == _record()["phase_ends"]
    reports = [e["steps"] for e in lines if "mean_reward" in e]
    assert reports[-1] == ts.epochs * per_epoch == _record()["steps"] == FINAL_STEPS


def test_record_calls_chain_from_zero_to_the_end():
    """The calls that trained the run, in order: each starts where the one
    before it ended, from 0 to the final state, and names the NVIDIA card
    and its power limit as nvidia-smi gives them; `wall_s` is the sum of
    their training seconds. The record keeps every key of JAX's own."""
    record = _record()
    calls = record["calls"]
    assert calls[0]["from"] == 0 and calls[-1]["to"] == record["steps"] == FINAL_STEPS
    assert all(c["from"] < c["to"] for c in calls)
    assert all(a["to"] == b["from"] for a, b in zip(calls, calls[1:]))
    for c in calls:
        assert re.fullmatch(r"NVIDIA .+, \d+(\.\d+)? W", c["card"]), c["card"]
        assert c["train_s"] > 0
    assert record["wall_s"] == pytest.approx(sum(c["train_s"] for c in calls), rel=1e-12)
    with open(JAX_RECORD) as f:
        jax_keys = set(json.load(f))
    assert jax_keys <= set(record), jax_keys - set(record)


@functools.lru_cache(maxsize=None)
def _reset_obs() -> np.ndarray:
    """Four envs of one seeded JAX reset: their observations."""
    state = jax.jit(jax.vmap(jenvs["ant_tag"]().reset))(
        jax.random.split(jax.random.PRNGKey(5), 4))
    return np.array(state.obs)


@pytest.mark.parametrize("deterministic", [True, False], ids=["det", "stoch"])
def test_one_policy_step_follows_jax(deterministic):
    jinf, jparams, learner, ts, _ = _pair()
    obs = _reset_obs()
    h = np.random.default_rng(0).normal(0, 0.3, (4, HIDDEN)).astype(np.float32)
    jh, jact = jinf(jparams, jnp.asarray(h), jnp.asarray(obs), jax.random.PRNGKey(3),
                    deterministic=deterministic)
    th, tact = learner.make_inference_fn()(learner.inference_params(ts), torch.as_tensor(h),
                                           torch.as_tensor(obs), jr.PRNGKey(3),
                                           deterministic=deterministic)
    np.testing.assert_allclose(tact.numpy(), np.asarray(jact), rtol=0, atol=1e-5)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0, atol=1e-5)
    assert float(np.abs(np.asarray(jact)).max()) > 0.1


def jax_tag_rate(jinf, jparams, radius: float, episodes: int, seed: int = 0) -> float:
    """examples/train_ant_tag_rnn.py's `tag_rate_rnn` (det, action_repeat 6,
    1000 control steps, its key order) in JAX's env at `radius`, one jitted
    control step at a time, stopped once every episode has ended (past that
    the tag count cannot change)."""
    env = jw.VmapWrapper(jw.EpisodeWrapper(jw.ActionRepeatWrapper(
        jenvs["ant_tag"](visible_radius=radius), HAI_ACTION_REPEAT), 1000, 1),
        batch_size=episodes)
    k_reset, key = jax.random.split(jax.random.PRNGKey(seed))
    state = jax.jit(env.reset)(jax.random.split(k_reset, episodes))

    @jax.jit
    def step(state, h, alive, tagged, key):
        key, k = jax.random.split(key)
        h, act = jinf(jparams, h, state.obs, k, deterministic=True)
        state = env.step(state, act)
        tagged = jnp.maximum(tagged, state.done * alive * (state.reward > 0.5))
        return state, h, alive * (1.0 - state.done), tagged, key

    h, alive, tagged = jnp.zeros((episodes, HIDDEN)), jnp.ones(episodes), jnp.zeros(episodes)
    for t in range(1000):
        state, h, alive, tagged, key = step(state, h, alive, tagged, key)
        if t % 10 == 9 and not bool(alive.any()):
            break
    return float(tagged.mean())


def test_port_policy_in_jax_env():
    """The card's det rate p on 256 episodes of the true env at reset seed 0
    (the record's; a record cut inside the curriculum gives it at its
    `training_radius`) sets the gate: of 16 episodes, 16 p less 3 (about two
    binomial spreads sqrt(16 p (1 - p)) <= 2 episodes, more at p near 1/2),
    since JAX's closed loop parts from the port's within a few control
    steps."""
    jinf, jparams, _, _, _ = _pair()
    record = _record()
    radius = record.get("training_radius", TRUE_RADIUS)
    p = record.get("tag_rate_det_at_training_radius", record["true_tag_rate_det"])
    rate = jax_tag_rate(jinf, jparams, radius, EPISODES)
    print(f"JAX's env at radius {radius:g}, {EPISODES} det episodes at seed 0: tag rate "
          f"{rate:.4f} (the card: {p:.4f} on 256)")
    assert rate * EPISODES >= EPISODES * p - 3, (rate, p)
