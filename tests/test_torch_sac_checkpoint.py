"""The committed AntTag GRU-SAC checkpoint carried across to the port, on the
CPU (tests/test_torch_checkpoint.py's method for the GRU-PPO one).

  * pobrax_tpu_torch/checkpoints/ant_tag_sac_rnn_phase0_750M.npz (written by
    tools/export_torch_checkpoint.py) equals the orbax checkpoint
    checkpoints/ant_tag_sac_rnn_phase0_750M leaf for leaf, bit for bit, and
    its stored checksum is that of the orbax parameters;
  * loaded into the port (`checkpoint.load_npz` ->
    `interop.training_state_from_numpy`) and carried back, every leaf
    returns bit for bit: the actor, the stacked twin critics and targets,
    log_alpha, the three Adam states, the statistics and the epoch count;
  * replay: 4 envs of AntTag at visible radius 20 (phase 0's) under
    ActionRepeat(6) -> Episode(1000) -> Vmap, 20 control steps of the
    deterministic GRU-SAC actor through the JAX package from a seeded
    reset; at every step the port (plain step) takes the JAX env state and
    hidden state and runs the same policy step and env step: actions within
    1e-4, hidden states 1e-5, observations 1e-3, `done` exactly. The state is
    taken from JAX each step because 60 substeps of closed-loop walking
    amplify round-off (see tests/test_torch_checkpoint.py).
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
from pobrax_tpu.training import checkpoint as jckpt
from pobrax_tpu.training import sac_rnn as jrs
from pobrax_tpu_torch import eval_tag_checkpoint, interop
from pobrax_tpu_torch.envs import wrappers
from pobrax_tpu_torch.envs.ant_tag import AntTagEnv
from pobrax_tpu_torch.training import checkpoint as ckpt
from pobrax_tpu_torch.training import sac_rnn

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORBAX = os.path.join(ROOT, "checkpoints", "ant_tag_sac_rnn_phase0_750M")
NPZ = eval_tag_checkpoint.SAC_NPZ
B, T, RADIUS = 4, 20, 20.0


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
    return eval_tag_checkpoint.load(NPZ, device="cpu", sac=True)


def _flat(t, path=()):
    if isinstance(t, dict):
        for k in sorted(t):
            yield from _flat(t[k], path + (k,))
    else:
        yield path, np.asarray(t)


def test_npz_equals_the_orbax_checkpoint(orbax_tree):
    want = dict(_export().leaves(orbax_tree))
    with np.load(NPZ, allow_pickle=False) as z:
        got = {k: z[k] for k in z.files}
    assert str(got.pop("params_sha256")) == interop.params_checksum(orbax_tree["params"])
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        assert got[k].tobytes() == w.tobytes(), k
    assert got["q_opt/0/mu"].shape == (419842,) and got["policy_opt/0/mu"].shape == (176656,)
    assert got["params/q/params/gru/hn/kernel"].shape == (2, 128, 128)
    assert os.path.getsize(NPZ) < 9_000_000


def test_port_state_carries_back_bit_for_bit(loaded):
    learner, ts, same = loaded
    assert same and isinstance(learner, sac_rnn.RSACLearner)
    tree = ckpt.load_npz(NPZ)
    back = interop.training_state_to_numpy(ts)
    for path, w in _flat(tree["params"]):
        assert interop._leaf(back["params"], path).tobytes() == w.tobytes(), path
    for opt in ("policy_opt", "q_opt", "alpha_opt"):
        adam = tree[opt]["0"]
        for k in ("mu", "nu"):
            assert back[opt][k].tobytes() == adam[k].tobytes(), (opt, k)
        assert back[opt]["count"] == adam["count"], opt
    for k, v in tree["normalizer"].items():
        assert back["normalizer"][k].tobytes() == v.tobytes(), k
    assert back["epochs"] == tree["epochs"] == ts.epochs > 0
    assert ts.buffer.capacity == 1  # the evaluation learner holds no real buffer


def test_report_plans_both_radii():
    plan = eval_tag_checkpoint.measurements(sac=True)
    assert [(n, r, s, d) for n, r, s, d in plan] == [
        ("r20_det", 20.0, 0, True), ("r20_stoch", 20.0, 0, False),
        ("r4_det", 4.0, 0, True), ("r4_stoch", 4.0, 0, False)]
    assert len(eval_tag_checkpoint.measurements(sac=False, seeds=[0, 1, 2])) == 6


def test_replay_follows_jax(loaded):
    learner, ts, _ = loaded
    jenv = jw.VmapWrapper(jw.EpisodeWrapper(jw.ActionRepeatWrapper(
        JAntTag(visible_radius=RADIUS), HAI_ACTION_REPEAT), 1000, 1), batch_size=B)
    cfg = jrs.RSACConfig(num_envs=B, replay_capacity=1, hidden_size=128, encoder_sizes=(256,),
                         head_sizes=(256,))
    jl = jrs.RSACLearner(jenv, cfg)
    keys = jax.random.split(jax.random.PRNGKey(11), B)
    jstate = jax.jit(jenv.reset)(keys)
    template = jl.init(jax.random.PRNGKey(0), jstate)
    jts = template.replace(**jckpt.restore(jckpt.latest_step_dir(ORBAX) or ORBAX,
                                           template=jrs._ckpt_slice(template)))
    jpolicy = jl.make_inference_fn()

    @jax.jit
    def jstep(state, h):
        h, act = jpolicy((jts.normalizer, jts.params.policy), h, state.obs,
                         jax.random.PRNGKey(0), deterministic=True)
        return jenv.step(state, act), h, act

    env = wrappers.VmapWrapper(wrappers.EpisodeWrapper(wrappers.ActionRepeatWrapper(
        AntTagEnv(device="cpu", visible_radius=RADIUS), HAI_ACTION_REPEAT), 1000, 1),
        batch_size=B)
    policy = learner.make_inference_fn()
    params = learner.inference_params(ts)
    state = env.reset(torch.as_tensor(np.asarray(keys).astype(np.int64)))
    np.testing.assert_allclose(state.obs.numpy(), np.asarray(jstate.obs), rtol=0, atol=1e-5)
    jh = jnp.zeros((B, 128))
    moved = 0.0
    for t in range(T):
        state = interop.state_from_numpy(jax.device_get(jstate), device="cpu")
        h, act = policy(params, torch.as_tensor(np.array(jh)), state.obs, None,
                        deterministic=True)
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
