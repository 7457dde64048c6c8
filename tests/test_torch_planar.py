"""The port's planar envs (halfcheetah, hopper, walker2d) and acrobot against
the JAX package, on the CPU.

For each of the four: the scene config equals the JAX one field for field;
`reset` draws the JAX env's joint jitter bit for bit from the same key (the
draws reach `System.default_qp` equal) and gives its observation and qp
within 1e-6 (FK round-off); a 20-step rollout of the same seeded actions
through JAX's generic step and the port's plain step agrees at the physics
tolerances of tests/test_fused.py carried through 20 steps (obs and metrics
1e-3, reward 1e-4, `done` equal); the observation sizes 23/14/20/4 are the
mask tables' spans; bodies stay in the y = 0 plane (|y| < 1e-5 over 60
steps, as tests/test_stock_envs.py checks the JAX envs) on the plain step
and on the host build of the kernel; acrobot's swing-up reward and done
(tests/test_stock_semantics.py's case). Halfcheetah replays the JAX
package's tests/fixtures/halfcheetah_s7_ours.npz and the halfcheetah event
window of tests/golden/po_envs_events_seed7.npz at the gate of
tests/test_torch_po_replay.py (obs, reward 1e-3, done equal, reset obs
1e-5). The kernel's tables and cost for the four Systems: a ground row per
capsule end, none for acrobot, each System's bound. The host-built kernel on
these Systems is in tests/test_torch_kernel_host.py.
"""

import dataclasses
import functools
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pobrax_tpu.envs import _envs as jax_envs
from pobrax_tpu.envs import acrobot as j_acrobot
from pobrax_tpu.envs import create as jax_create
from pobrax_tpu.physics import planar as j_planar
from pobrax_tpu_torch import random as jr
from pobrax_tpu_torch.envs import _envs, create, masks
from pobrax_tpu_torch.envs import acrobot as t_acrobot
from pobrax_tpu_torch.physics import planar as t_planar
from pobrax_tpu_torch.physics import step_tables, whole_step
from tests.test_torch_ant_tag import _golden_rollout
from tests.test_torch_kernel_host import build_host_lib, host_step
from tests.test_torch_po_replay import replay_fixture

HERE = os.path.dirname(__file__)
NAMES = ["halfcheetah", "hopper", "walker2d", "acrobot"]
OBS_SIZES = {"halfcheetah": 23, "hopper": 14, "walker2d": 20, "acrobot": 4}
B, T = 4, 20

CONFIGS = {
    "halfcheetah": (j_planar.halfcheetah_config, t_planar.halfcheetah_config),
    "hopper": (j_planar.hopper_config, t_planar.hopper_config),
    "walker2d": (j_planar.walker2d_config, t_planar.walker2d_config),
    "acrobot": (j_acrobot.acrobot_config, t_acrobot.acrobot_config),
}


@pytest.mark.parametrize("name", NAMES)
def test_configs_equal(name):
    jcfg, tcfg = CONFIGS[name]
    assert dataclasses.asdict(jcfg()) == dataclasses.asdict(tcfg())


@functools.lru_cache(maxsize=None)
def pair(name):
    """(jitted JAX reset, jitted JAX step, port env) at batch B."""
    kw = dict(episode_length=1000, batch_size=B, auto_reset=False)
    jenv = jax_create(name, **kw)
    return jax.jit(jenv.reset), jax.jit(jenv.step), create(name, device="cpu", **kw)


def _recording_default_qp(sys_, calls):
    """`sys_.default_qp` that records the joint angles and velocities it gets."""
    inner = sys_.default_qp

    def default_qp(joint_angle=None, joint_velocity=None):
        calls.append((np.asarray(joint_angle), np.asarray(joint_velocity)))
        return inner(joint_angle=joint_angle, joint_velocity=joint_velocity)

    return default_qp


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("name", NAMES)
def test_reset_matches_jax(name, seed, monkeypatch):
    jreset, _, tenv = pair(name)
    want = jreset(jax.random.PRNGKey(seed))
    got = tenv.reset(jr.PRNGKey(seed))
    assert got.obs.shape == (B, OBS_SIZES[name]) == (B, tenv.observation_size)
    np.testing.assert_allclose(got.obs.numpy(), np.asarray(want.obs), rtol=0, atol=1e-6)
    for f in ("pos", "rot", "vel", "ang"):
        np.testing.assert_allclose(getattr(got.qp, f).numpy(), np.asarray(getattr(want.qp, f)),
                                   rtol=0, atol=1e-6, err_msg=f)
    np.testing.assert_array_equal(got.info["rng"].numpy(),
                                  np.asarray(want.info["rng"]).astype(np.int64))
    # the jitter itself: both resets hand default_qp the same bits
    keys = jax.random.split(jax.random.PRNGKey(seed), B)
    jcore, tcore = jax_envs[name](), _envs[name](device="cpu")
    jcalls, tcalls = [], []
    monkeypatch.setattr(jcore.sys, "default_qp", _recording_default_qp(jcore.sys, jcalls))
    monkeypatch.setattr(tcore.sys, "default_qp", _recording_default_qp(tcore.sys, tcalls))
    for k in keys:
        jcore.reset(k)
    tcore.reset(jr.split(jr.PRNGKey(seed), B))
    for i in range(2):
        np.testing.assert_array_equal(tcalls[0][i], np.stack([c[i] for c in jcalls]))


@pytest.mark.parametrize("name", NAMES)
def test_rollout_matches_jax(name):
    jreset, jstep, tenv = pair(name)
    js, ts = jreset(jax.random.PRNGKey(1)), tenv.reset(jr.PRNGKey(1))
    acts = np.random.RandomState(0).uniform(-1, 1, (T, B, tenv.action_size)).astype(np.float32)
    for t in range(T):
        js, ts = jstep(js, acts[t]), tenv.step(ts, torch.from_numpy(acts[t]))
        np.testing.assert_allclose(ts.obs.numpy(), np.asarray(js.obs), rtol=0, atol=1e-3,
                                   err_msg=f"step {t}")
        np.testing.assert_allclose(ts.reward.numpy(), np.asarray(js.reward), rtol=0, atol=1e-4,
                                   err_msg=f"step {t}")
        np.testing.assert_array_equal(ts.done.numpy(), np.asarray(js.done), err_msg=f"step {t}")
        assert set(ts.metrics) == set(js.metrics)
        for k, v in ts.metrics.items():
            np.testing.assert_allclose(v.numpy(), np.asarray(js.metrics[k]), rtol=0, atol=1e-3,
                                       err_msg=f"metric {k}, step {t}")


@pytest.mark.parametrize("name", NAMES)
def test_obs_size_is_the_mask_tables_span(name):
    """POSITION is [0, k) and VELOCITY [k, size): together the whole obs."""
    size = _envs[name](device="cpu").observation_size
    assert size == OBS_SIZES[name]
    pos, vel = masks.POSITION[name], masks.VELOCITY[name]
    np.testing.assert_array_equal(np.concatenate([pos, vel]), np.arange(size))


@pytest.mark.parametrize("path", ["plain", "kernel"])
@pytest.mark.parametrize("name", NAMES)
def test_stays_in_plane(name, path, monkeypatch):
    """60 steps of seeded random actions; every body's |y| < 1e-5, on the
    plain step and on the host build of the kernel (the frozen-axis masks
    of the card's step)."""
    if path == "kernel":
        lib = build_host_lib()
        if lib is None:
            pytest.skip("g++ not found: the host build of the kernel's per-env step needs it")
        monkeypatch.setattr(whole_step, "whole_step", lambda s, q, a: host_step(lib, s, q, a))
    env = create(name, episode_length=None, auto_reset=False, batch_size=2, device="cpu")
    s = env.reset(jr.PRNGKey(0))
    g = torch.Generator().manual_seed(0)
    ys = []
    for _ in range(60):
        s = env.step(s, torch.rand(2, env.action_size, generator=g) * 2 - 1)
        ys.append(s.qp.pos[..., 1].abs().max())
    assert bool(torch.isfinite(s.qp.pos).all())
    assert float(torch.stack(ys).max()) < 1e-5


def test_acrobot_swingup_reward_and_done():
    """tests/test_stock_semantics.py's case on the port, and the same rewards
    as the JAX env."""
    env = _envs["acrobot"](device="cpu")
    s = env.reset(jr.PRNGKey(0)[None])
    zero = torch.zeros(1, env.action_size)
    hang = env.step(s, zero)
    assert float(hang.done[0]) == 0.0
    assert float(hang.reward[0]) < 0.0  # tip below base: shaped reward negative
    # zero pose hangs; the inverted configuration is shoulder = pi
    upright = s.replace(qp=env.sys.default_qp(joint_angle=torch.tensor([[math.pi, 0.0]])))
    up = env.step(upright, zero)
    assert float(up.done[0]) == 1.0  # tip above the 1.8 swing-up height
    assert float(up.reward[0]) > float(hang.reward[0])
    jenv = jax_envs["acrobot"]()
    js = jenv.reset(jax.random.PRNGKey(0))
    jstep = jax.jit(jenv.step)
    jup = jstep(js.replace(qp=jenv.sys.default_qp(joint_angle=jnp.array([math.pi, 0.0]))),
                jnp.zeros(1))
    np.testing.assert_allclose(float(up.reward[0]), float(jup.reward), rtol=0, atol=1e-4)
    np.testing.assert_allclose(float(hang.reward[0]), float(jstep(js, jnp.zeros(1)).reward),
                               rtol=0, atol=1e-4)


def test_halfcheetah_fixture_replay():
    """The JAX package's recorded halfcheetah trajectory, 100 steps, seed 7."""
    fx, obs0, obs, rew, done = replay_fixture(os.path.join(HERE, "fixtures",
                                                           "halfcheetah_s7_ours.npz"))
    np.testing.assert_allclose(obs0, fx["reset_obs"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(obs, fx["obs"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(rew, fx["reward"], rtol=0, atol=1e-3)
    np.testing.assert_array_equal(done, fx["done"])


def test_halfcheetah_golden_events_window():
    """tools/gen_golden.py's halfcheetah window: 120 steps, episodes of 40,
    naive randomized autoreset; three truncations fire inside it."""
    data = np.load(os.path.join(HERE, "golden", "po_envs_events_seed7.npz"))
    env = create("halfcheetah", episode_length=40, randomized_autoreset=True, batch_size=1,
                 device="cpu")
    obs, rew, done = _golden_rollout(env, 120)
    assert done.sum() == 3
    np.testing.assert_array_equal(done, data["halfcheetah_done"])
    np.testing.assert_allclose(rew, data["halfcheetah_rew"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(obs, data["halfcheetah_obs"], rtol=0, atol=1e-3)


@pytest.mark.parametrize("name, rows, substeps, bound_by", [
    ("halfcheetah", 14, 16, "operations"), ("hopper", 6, 8, "operations"),
    ("walker2d", 10, 8, "operations"), ("acrobot", 0, 12, "bytes")])
def test_kernel_tables_and_cost(name, rows, substeps, bound_by):
    """Two ground rows per colliding capsule (its ends), no row of any kind
    for acrobot, whose hinges have zero limit strength; every body takes a
    slot (no pass-through). Acrobot's three bodies and two hinges are
    byte-bound, the planar Systems' ground rows make them operation-bound."""
    sys_ = _envs[name](device="cpu").sys
    t = step_tables.build(sys_)
    assert (len(t["pp_rows"]), t["substeps"], len(t["slots"])) == (rows, substeps,
                                                                   sys_.num_bodies)
    assert not (t["cb_rows"] or t["ss_rows"] or t["cc_rows"] or t["pass_through"])
    if name == "acrobot":
        assert all(j.limit_strength == 0.0 for j in sys_.config.joints)
    ms, by = whole_step.bound_ms(sys_, 4096)
    assert ms > 0 and by == bound_by
    assert whole_step.cost(sys_, 8)["flops"] * 512 == whole_step.cost(sys_, 4096)["flops"]
