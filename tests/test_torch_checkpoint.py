"""The committed AntTag checkpoint carried across to the port, on the CPU.

  * pobrax_tpu_torch/checkpoints/ant_tag_rnn_900M.npz (written by
    tools/export_torch_checkpoint.py) equals the orbax checkpoint
    checkpoints/ant_tag_rnn_900M leaf for leaf, bit for bit, and its stored
    checksum is that of the orbax parameters;
  * loaded into the port (`checkpoint.load_npz` ->
    `interop.training_state_from_numpy`) and carried back
    (`training_state_to_numpy`), every leaf returns bit for bit;
  * the port's `checkpoint.save` / `restore` round-trip a state exactly;
  * replay: 4 envs of AntTag under ActionRepeat(6) -> Episode(1000) -> Vmap,
    20 control steps of the deterministic GRU policy through the JAX package
    from a seeded reset; at every step the port (plain step) takes the JAX
    env state and hidden state (`interop.state_from_numpy`) and runs the
    same policy step and env step. Actions agree within 1e-4, hidden states
    within 1e-5, observations within 1e-3 (the fixture tolerance of
    tests/test_replay_fixtures.py) and `done` exactly, at every step. The
    state is taken from JAX each step because 60 substeps of closed-loop
    walking amplify round-off: run free, the two trajectories part by more
    than 1e-3 within a few control steps even where the port steps JAX's
    exact actions (a contact onset that flips), so a free-running
    comparison would test the chaos, not the port.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pobrax_tpu.envs import HAI_ACTION_REPEAT
from pobrax_tpu.envs import wrappers as jw
from pobrax_tpu.envs.ant_tag import AntTagEnv as JAntTag
from pobrax_tpu.training import ppo_rnn as jrnn
from pobrax_tpu_torch import eval_tag_checkpoint, interop
from pobrax_tpu_torch import random as jr
from pobrax_tpu_torch.envs import wrappers
from pobrax_tpu_torch.envs.ant_tag import AntTagEnv
from pobrax_tpu_torch.training import checkpoint as ckpt

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORBAX = os.path.join(ROOT, "checkpoints", "ant_tag_rnn_900M")
NPZ = eval_tag_checkpoint.DEFAULT_NPZ
B, T = 4, 20


def _export():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "export_torch_checkpoint", os.path.join(ROOT, "tools", "export_torch_checkpoint.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def orbax_tree():
    return _export().restore(ORBAX)


@pytest.fixture(scope="module")
def loaded():
    return eval_tag_checkpoint.load(NPZ, device="cpu")


def test_npz_equals_the_orbax_checkpoint(orbax_tree):
    want = dict(_export().leaves(orbax_tree))
    with np.load(NPZ, allow_pickle=False) as z:
        got = {k: z[k] for k in z.files}
    assert str(got.pop("params_sha256")) == interop.params_checksum(orbax_tree["params"])
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        assert got[k].tobytes() == w.tobytes(), k
    assert got["opt_state/1/0/mu"].shape == (176785,)
    assert os.path.getsize(NPZ) < 2_500_000


def test_port_state_carries_back_bit_for_bit(loaded):
    _, ts, same = loaded
    assert same
    tree = ckpt.load_npz(NPZ)
    back = interop.training_state_to_numpy(ts)

    def flat(t, path=()):
        if isinstance(t, dict):
            for k in sorted(t):
                yield from flat(t[k], path + (k,))
        else:
            yield path, np.asarray(t)

    for path, w in flat(tree["params"]):
        assert interop._leaf(back["params"], path).tobytes() == w.tobytes(), path
    adam = tree["opt_state"]["1"]["0"]
    for k in ("mu", "nu"):
        assert back["opt_state"][k].tobytes() == adam[k].tobytes()
    assert back["opt_state"]["count"] == adam["count"] and ts.opt_state.count == 73248
    for k, v in tree["normalizer"].items():
        assert back["normalizer"][k].tobytes() == v.tobytes(), k
    assert back["epochs"] == tree["epochs"] == 2289


def test_save_restore_round_trip(loaded, tmp_path):
    learner, ts, _ = loaded
    path = ckpt.save_step(str(tmp_path), 123, ts)
    assert ckpt.latest_step_dir(str(tmp_path)) == path
    got = ckpt.restore(path, learner.init(jr.PRNGKey(1)))
    for a, b in zip(got.params.parameters(), ts.params.parameters()):
        assert torch.equal(a, b)
    assert torch.equal(got.opt_state.mu, ts.opt_state.mu)
    assert torch.equal(got.normalizer.std, ts.normalizer.std)
    assert (got.epochs, got.opt_state.count) == (ts.epochs, ts.opt_state.count)


def test_replay_follows_jax(loaded):
    learner, ts, _ = loaded
    # JAX: the same checkpoint through the JAX learner and env stack
    jenv = jw.VmapWrapper(jw.EpisodeWrapper(jw.ActionRepeatWrapper(JAntTag(), HAI_ACTION_REPEAT),
                                            1000, 1), batch_size=B)
    cfg = jrnn.RNNPPOConfig(num_envs=8, num_minibatches=8, hidden_size=128,
                            encoder_sizes=(256,))
    jl = jrnn.RNNPPOLearner(jenv, cfg)
    from pobrax_tpu.training import checkpoint as jckpt
    jts = jckpt.restore(jckpt.latest_step_dir(ORBAX), template=jl.init(jax.random.PRNGKey(0)))
    jpolicy = jl.make_inference_fn()

    @jax.jit
    def jstep(state, h):
        h, act = jpolicy((jts.normalizer, jts.params), h, state.obs, jax.random.PRNGKey(0),
                         deterministic=True)
        return jenv.step(state, act), h, act

    env = wrappers.VmapWrapper(wrappers.EpisodeWrapper(
        wrappers.ActionRepeatWrapper(AntTagEnv(device="cpu"), HAI_ACTION_REPEAT), 1000, 1),
        batch_size=B)
    policy = learner.make_inference_fn()
    keys = jax.random.split(jax.random.PRNGKey(11), B)
    jstate = jax.jit(jenv.reset)(keys)
    state = env.reset(torch.as_tensor(np.asarray(keys).astype(np.int64)))
    np.testing.assert_allclose(state.obs.numpy(), np.asarray(jstate.obs), rtol=0, atol=1e-5)
    jh = jnp.zeros((B, 128))
    moved = 0.0
    for t in range(T):
        state = interop.state_from_numpy(jax.device_get(jstate), device="cpu")
        h, act = policy((ts.normalizer, ts.params), torch.as_tensor(np.array(jh)), state.obs,
                        None, deterministic=True)
        state = env.step(state, act)
        jstate, jh, jact = jstep(jstate, jh)
        np.testing.assert_allclose(act.numpy(), np.asarray(jact), rtol=0, atol=1e-4,
                                   err_msg=f"action, step {t}")
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=0, atol=1e-5,
                                   err_msg=f"hidden state, step {t}")
        np.testing.assert_allclose(state.obs.numpy(), np.asarray(jstate.obs), rtol=0, atol=1e-3,
                                   err_msg=f"obs, step {t}")
        np.testing.assert_array_equal(state.done.numpy(), np.asarray(jstate.done))
        moved = max(moved, float(act.abs().max()))
    assert moved > 0.1  # the policy drove the ants
