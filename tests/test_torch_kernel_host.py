"""The whole-step kernel's arithmetic, checked on the CPU.

csrc/whole_step.cuh's `ws::step_env` — the function every CUDA thread runs —
also compiles as plain C++. This file builds it with g++ (through
csrc/whole_step_host.cpp, no torch headers) into a small library loaded with
ctypes, and holds it against the port's plain step at the fused-vs-generic
tolerances of tests/test_fused.py (pos/rot 1e-5, vel/ang/contact 1e-3), so a
wrong kernel fails here, before it reaches a GPU: on AntTag, on every stock
System of the port (multi-dof joints, angle servos, thrusters, two-body
capsule contacts), on the PO ant Systems (HeavenHell's T-maze and the maze
with ants against their walls, AntGather's 16 pass-through bodies bit-equal),
on tests/test_fused.py's 2-dof + servo system and its mini system (every row
kind, a thruster), on the planar Systems (ground rows on bodies with frozen
axes, halfcheetah at 16 substeps) and acrobot (no contact row), over a
20-step humanoid rollout against the JAX package,
and in the contact-only Info variant (bit-equal to the full one in state and
contact Info, and against the JAX fused step under POBRAX_INFO=contact). The
host build emulates an env's 16 lanes by running each phase for lanes 0..15
in turn; run backwards instead, every result must come out bit-equal, which
is how a race between the lanes of one phase would show here. No entry point
of the package loads this build. Skips where g++ is missing.
"""

import ctypes
import hashlib
import json
import os
import shutil
import subprocess

import jax
import numpy as np
import pytest
import torch

from pobrax_tpu.envs import create as jax_create
from pobrax_tpu_torch import envs
from pobrax_tpu_torch import random as jr
from pobrax_tpu_torch.envs import create
from pobrax_tpu_torch.envs.ant_tag import AntTagEnv
from pobrax_tpu_torch.physics import config as tc
from pobrax_tpu_torch.physics.ant import ANT_BODY_NAMES
from pobrax_tpu_torch.physics import step_tables, whole_step
from pobrax_tpu_torch.physics.state import QP
from pobrax_tpu_torch.physics.system import System
from chip_smoke import ALL_WALLED_MIN_AGREE
from tests.test_torch_physics import mini_cfg, multidof_cfg

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "ref_ant_tag_s7.npz")
_WIDTHS = (3, 4, 3, 3, 3, 3, 3, 3, 3, 3)


def build_host_lib():
    """The host build of csrc/whole_step_host.cpp with g++, cached in build/
    by a hash of the sources; None where g++ is missing."""
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    src = whole_step.CSRC / "whole_step_host.cpp"
    digest = hashlib.sha256(src.read_bytes()
                            + (whole_step.CSRC / "whole_step.cuh").read_bytes()).hexdigest()
    out = whole_step.BUILD_DIR / f"whole_step_host-{digest[:16]}.so"
    if not out.exists():
        whole_step.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-o", str(tmp),
                        str(src)], check=True, capture_output=True)
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    lib.ws_whole_step_host.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 15
                                       + [ctypes.c_int])
    lib.ws_whole_step_host.restype = ctypes.c_int
    lib.ws_layout_words.argtypes = [ctypes.c_void_p]
    return lib


@pytest.fixture(scope="module")
def host_lib():
    lib = build_host_lib()
    if lib is None:
        pytest.skip("g++ not found: the host build of the kernel's per-env step needs it")
    return lib


def host_step(lib, sys_, qp, act, reversed_lanes=False):
    """One control step through the host build of the kernel's code, each
    phase's lanes run in turn, forwards (or backwards). The outputs start as NaN, so a value
    the kernel fails to write shows; with contact Info only, the joint and
    actuator pointers are null."""
    tables = step_tables.pack(step_tables.build(sys_))
    B, n = qp.pos.shape[0], sys_.num_bodies
    ins = [x.contiguous() for x in (qp.pos, qp.rot, qp.vel, qp.ang, act)]
    widths = _WIDTHS[:6] if sys_.info_mode == "contact" else _WIDTHS
    outs = [torch.full((B, n, k), float("nan")) for k in widths]
    ptrs = [o.data_ptr() for o in outs] + [None] * (len(_WIDTHS) - len(outs))
    assert lib.ws_whole_step_host(tables.ctypes.data, B, *[x.data_ptr() for x in ins], *ptrs,
                                  int(reversed_lanes)) == 0
    return whole_step.unpack(sys_, outs)


def assert_close(got, want, info_rtol=1e-5):
    """pos/rot 1e-5, vel/ang/contact 1e-3; the joint and actuator Info sums
    (accelerations up to ~1e4) to `info_rtol` of their largest entry."""
    (q, i), (q_ref, i_ref) = got, want
    for name, tol in (("pos", 1e-5), ("rot", 1e-5), ("vel", 1e-3), ("ang", 1e-3)):
        torch.testing.assert_close(getattr(q, name), getattr(q_ref, name), rtol=0, atol=tol,
                                   msg=name)
    for f in ("vel", "ang"):
        torch.testing.assert_close(getattr(i.contact, f), getattr(i_ref.contact, f), rtol=0,
                                   atol=1e-3, msg=f"contact.{f}")
        for part in ("joint", "actuator"):
            want_t = getattr(getattr(i_ref, part), f)
            torch.testing.assert_close(getattr(getattr(i, part), f), want_t, rtol=info_rtol,
                                       atol=info_rtol * max(1.0, float(want_t.abs().max())),
                                       msg=f"{part}.{f}")


def test_layout_words_match_step_tables(host_lib):
    got = (ctypes.c_int * 16)()
    n = host_lib.ws_layout_words(got)
    assert list(got[:n]) == [step_tables.words(s) for s in step_tables.STRUCTS]


def _state(env, case, B=8):
    """A contact-active AntTag batch: 30 plain steps from reset; "wall"
    also shifts every ant against the +x arena wall."""
    s = env.reset(jr.split(jr.PRNGKey(3), B))
    qp = s.qp
    if case == "wall":
        pos = qp.pos.clone()
        ant = env.ant_slice
        pos[:, ant, 0] += 5.15 - pos[:, env.torso_idx:env.torso_idx + 1, 0]
        qp = qp.replace(pos=pos)
        _, _, _, _, pen = env.sys.contacts._capsule_box(qp)
        assert bool((pen > 0).any()), "the wall case must touch the wall"
        return qp
    g = torch.Generator().manual_seed(0)
    for _ in range(30):
        qp, _ = env.sys.step_generic(qp, torch.rand(B, 8, generator=g) * 2 - 1)
    return qp


@pytest.mark.parametrize("case", ["steps", "wall", "substeps8"])
def test_host_kernel_matches_plain_step(host_lib, case):
    env = AntTagEnv(device="cpu")
    if case == "substeps8":
        env.retune_substeps(8)
    qp = _state(env, case)
    act = torch.rand(qp.pos.shape[0], 8, generator=torch.Generator().manual_seed(1)) * 2 - 1
    assert_close(host_step(host_lib, env.sys, qp, act), env.sys.step_generic(qp, act))


@pytest.mark.parametrize("name", ["ant_tag", "ant_maze", "grasp", "humanoid", "halfcheetah",
                                  "hopper", "walker2d", "acrobot"])
def test_host_kernel_lanes_reversed_are_bit_equal(host_lib, name):
    """Each phase's lanes run backwards instead of forwards. Every lane writes only
    its own records and owners read only after the phase that wrote them, so
    the results must be bit-equal; a phase in which two lanes write the same
    scratch word, or one lane reads a word another lane writes, would differ
    here, a race the card would show only sometimes. AntTag and the maze
    against walls (capsule-box rows live), grasp with its Object on a finger
    (two-body capsule-capsule rows live), humanoid (2- and 3-dof joints),
    the planar Systems (ground rows on bodies with frozen axes) and acrobot
    (no contact row at all)."""
    if name == "ant_tag":
        env = AntTagEnv(device="cpu")
        sys_, qp = env.sys, _state(env, "wall")
        act = torch.rand(qp.pos.shape[0], 8, generator=torch.Generator().manual_seed(3)) * 2 - 1
    elif name == "ant_maze":
        env, qp, act = po_state(name)
        sys_ = env.sys
    else:
        sys_, qp, act = stock_state(name)
    (q, i), (q_rev, i_rev) = (host_step(host_lib, sys_, qp, act, reversed_lanes=r)
                              for r in (False, True))
    for f in ("pos", "rot", "vel", "ang"):
        assert bool(torch.isfinite(getattr(q, f)).all()), f
        assert torch.equal(getattr(q, f), getattr(q_rev, f)), f
    for part in ("contact", "joint", "actuator"):
        for f in ("vel", "ang"):
            assert torch.equal(getattr(getattr(i, part), f), getattr(getattr(i_rev, part), f))
    if name != "acrobot":
        assert float(i.contact.vel.abs().max()) > 0, "contacts must be live"


def test_host_kernel_replays_fixture(host_lib, monkeypatch):
    """The po-brax AntTag trajectory, every step through the kernel's code."""
    calls = []

    def step(sys_, qp, act):
        calls.append(1)
        return host_step(host_lib, sys_, qp, act)

    monkeypatch.setattr(whole_step, "whole_step", step)
    fx = np.load(FIXTURE)
    meta = json.loads(str(fx["meta"]))
    env = create("ant_tag", episode_length=meta["steps"] + 1, auto_reset=False, batch_size=1,
                 device="cpu")
    s = env.reset(jr.PRNGKey(meta["seed"])[None])
    obs, done = [], []
    for a in fx["actions"]:
        s = env.step(s, torch.from_numpy(a)[None])
        obs.append(s.obs[0].numpy())
        done.append(s.done[0].item())
    assert len(calls) == meta["steps"]
    np.testing.assert_allclose(np.stack(obs), fx["obs"], rtol=0, atol=1e-3)
    np.testing.assert_array_equal(done, fx["done"])


# plain steps from reset that leave contacts live: the humanoid's feet land
# after ~10 steps; the fetch dog spawns with its feet in the ground; the
# planar bodies (frozen y translation and x/z rotation) touch the ground
# after 5-10 (halfcheetah at 16 substeps); acrobot has no contact row
STOCK_WARM_STEPS = {"humanoid": 20, "grasp": 12, "fetch": 0, "ur5e": 5, "reacherangle": 5,
                    "inverted_double_pendulum": 5, "halfcheetah": 5, "hopper": 10,
                    "walker2d": 10, "acrobot": 5}


def object_on_finger(env, qp, envs_=slice(None)):
    """Grasp: the Object moved against the inside of finger f0's distal
    segment (1.5 cm into both capsules), so its capsule-capsule rows, which
    pair two moving bodies, are live."""
    dist, obj = env.sys.body.index["f0_dist"], env.sys.body.index["Object"]
    pos = qp.pos.clone()
    pos[envs_, obj] = pos[envs_, dist] + torch.tensor([-0.125, 0.0, 0.0], device=pos.device)
    return qp.replace(pos=pos)


def stock_state(name, B=8):
    env = envs._envs[name](device="cpu")
    qp = env.reset(jr.split(jr.PRNGKey(3), B)).qp
    g = torch.Generator().manual_seed(0)
    for _ in range(STOCK_WARM_STEPS[name]):
        qp, _ = env.sys.step_generic(qp, torch.rand(B, env.action_size, generator=g) * 2 - 1)
    if name == "grasp":
        qp = object_on_finger(env, qp)
        assert bool((env.sys.contacts._capsule_capsule(qp)[4] > 0).any(-1).all())
    if name in ("halfcheetah", "hopper", "walker2d"):
        assert bool((env.sys.contacts._point_plane(qp)[4] > 0).any(-1).all()), "ground rows live"
    return env.sys, qp, torch.rand(B, env.action_size, generator=g) * 2 - 1


@pytest.mark.parametrize("name", sorted(STOCK_WARM_STEPS))
def test_host_kernel_matches_plain_step_on_stock_systems(host_lib, name):
    """The joint Info sum is k (anchor_p - anchor_c) / m: a difference of two
    O(1) m anchors, each rounded at ~6e-8, times k / m up to ~4e4 (ur5e's
    8000 N/m springs on its 0.19 kg wrist), summed over the substeps; so it is
    held to 1e-4 of its largest entry (the state itself to the usual 1e-5 /
    1e-3)."""
    sys_, qp, act = stock_state(name)
    want = sys_.step_generic(qp, act)
    if sys_.contacts.point_plane is not None or sys_.contacts.capsule_capsule is not None:
        assert float(want[1].contact.vel.abs().max()) > 0, "contacts must be live"
    assert_close(host_step(host_lib, sys_, qp, act), want, info_rtol=1e-4)


@pytest.mark.parametrize("scene", ["multidof", "mini"])
def test_host_kernel_matches_plain_step_on_test_systems(host_lib, scene):
    """tests/test_fused.py's 2-dof + servo system and its mini system, from
    seeded jittered states."""
    sys_ = System((multidof_cfg if scene == "multidof" else mini_cfg)(tc), device="cpu")
    qp, act = jittered(sys_, np.random.RandomState(4), 8)
    assert_close(host_step(host_lib, sys_, qp, act), sys_.step_generic(qp, act))


def jittered(sys_, rs, B):
    """A batch of the default pose jittered by 3 cm, with random velocities
    on the moving bodies, and random actions."""
    n = sys_.num_bodies
    qp0 = sys_.default_qp()
    moving = torch.from_numpy(~sys_.body.frozen)[None, :, None].float()
    qp = QP(pos=qp0.pos + torch.from_numpy(0.03 * rs.randn(B, n, 3).astype(np.float32)),
            rot=qp0.rot.expand(B, n, 4).contiguous(),
            vel=moving * torch.from_numpy(0.3 * rs.randn(B, n, 3).astype(np.float32)),
            ang=moving * torch.from_numpy(0.3 * rs.randn(B, n, 3).astype(np.float32)))
    return qp, torch.from_numpy(rs.uniform(-1, 1, (B, sys_.action_size)).astype(np.float32))


def test_host_kernel_replays_jax_humanoid(host_lib, monkeypatch):
    """A 20-step humanoid rollout through the kernel's code against the JAX
    env (its generic step on the CPU): obs 1e-3, reward 1e-4, `done` equal."""
    calls = []

    def step(sys_, qp, act):
        calls.append(1)
        return host_step(host_lib, sys_, qp, act)

    monkeypatch.setattr(whole_step, "whole_step", step)
    B, T = 4, 20
    kw = dict(episode_length=1000, batch_size=B, auto_reset=False)
    jenv, tenv = jax_create("humanoid", **kw), create("humanoid", device="cpu", **kw)
    js, ts = jax.jit(jenv.reset)(jax.random.PRNGKey(5)), tenv.reset(jr.PRNGKey(5))
    jstep = jax.jit(jenv.step)
    acts = np.random.RandomState(2).uniform(-1, 1, (T, B, tenv.action_size)).astype(np.float32)
    for t in range(T):
        js, ts = jstep(js, acts[t]), tenv.step(ts, torch.from_numpy(acts[t]))
        np.testing.assert_allclose(ts.obs.numpy(), np.asarray(js.obs), rtol=0, atol=1e-3,
                                   err_msg=f"step {t}")
        np.testing.assert_allclose(ts.reward.numpy(), np.asarray(js.reward), rtol=0, atol=1e-4)
        np.testing.assert_array_equal(ts.done.numpy(), np.asarray(js.done))
    assert len(calls) == T


# the PO ant Systems: a torso coordinate 0.35 m short of a wall's inner face,
# so the capsule-box rows of the ants moved there are live (AntTag's +x arena
# wall at x = 5.5, HeavenHell's T-maze stem wall at x = 2.0, the maze's
# corridor wall at y = 1.75); AntGather's ants stay where 20 plain steps leave
# them, on the ground amid the pass-through apples and bombs
WALLS = {"ant_heavenhell": (0, 1.65), "ant_maze": (1, 1.4)}


def push_ants(env, qp, axis, value, envs_=slice(None)):
    """`qp` with the ant's 9 bodies in `envs_` shifted along `axis` so the
    torso's coordinate is `value`."""
    ant = [env.sys.body.index[n] for n in ANT_BODY_NAMES]
    pos = qp.pos.clone()
    shift = value - pos[envs_, env.torso_idx, axis]
    pos[envs_, ant[0]:ant[-1] + 1, axis] += shift[:, None]
    return qp.replace(pos=pos)


def po_state(name, B=8, info="full"):
    env = envs._envs[name](device="cpu", info=info)
    qp = env.reset(jr.split(jr.PRNGKey(3), B)).qp
    g = torch.Generator().manual_seed(0)
    for _ in range(20):
        qp, _ = env.sys.step_generic(qp, torch.rand(B, 8, generator=g) * 2 - 1)
    if name in WALLS:
        qp = push_ants(env, qp, *WALLS[name])
        assert bool((env.sys.contacts._capsule_box(qp)[4] > 0).any(-1).all()), "walls live"
    return env, qp, torch.rand(B, 8, generator=g) * 2 - 1


@pytest.mark.parametrize("name", ["ant_heavenhell", "ant_gather", "ant_maze"])
def test_host_kernel_matches_plain_step_on_po_systems(host_lib, name):
    """HeavenHell's T-maze (72 capsule-box rows), the maze (108) and
    AntGather's 27 bodies, of which 16 pass through: their state comes out
    bit-equal to the input and their Info exactly zero (the outputs start as
    NaN, so a body left unwritten would show)."""
    env, qp, act = po_state(name)
    got = host_step(host_lib, env.sys, qp, act)
    assert_close(got, env.sys.step_generic(qp, act))
    passes = step_tables.build(env.sys)["pass_through"]
    assert len(passes) == {"ant_heavenhell": 3, "ant_gather": 16, "ant_maze": 1}[name]
    q, i = got
    for f in ("pos", "rot", "vel", "ang"):
        assert torch.equal(getattr(q, f)[:, passes], getattr(qp, f)[:, passes]), f
    for part in (i.contact, i.joint, i.actuator):
        assert not bool(part.vel[:, passes].any()) and not bool(part.ang[:, passes].any())


@pytest.mark.parametrize("scene", ["ant_tag", "mini"])
def test_contact_info_variant(host_lib, scene):
    """`info="contact"` on the host build and on the plain step: state and
    contact Info bit-equal to the "full" variant of the same path, joint and
    actuator Info exactly zero."""
    if scene == "ant_tag":
        env = AntTagEnv(device="cpu")
        full, contact = env.sys, AntTagEnv(device="cpu", info="contact").sys
        qp = _state(env, "wall")
        act = torch.rand(qp.pos.shape[0], 8, generator=torch.Generator().manual_seed(2)) * 2 - 1
    else:
        full = System(mini_cfg(tc), device="cpu")
        contact = System(mini_cfg(tc), device="cpu", info="contact")
        qp, act = jittered(full, np.random.RandomState(2), 4)
    for step in (lambda s, q, a: host_step(host_lib, s, q, a),
                 lambda s, q, a: s.step_generic(q, a)):
        (qf, i_f), (qc, ic) = step(full, qp, act), step(contact, qp, act)
        for f in ("pos", "rot", "vel", "ang"):
            assert torch.equal(getattr(qf, f), getattr(qc, f)), f
        assert torch.equal(i_f.contact.vel, ic.contact.vel)
        assert torch.equal(i_f.contact.ang, ic.contact.ang)
        for part in (ic.joint, ic.actuator):
            assert part.vel.shape == qp.pos.shape and not bool(part.vel.any())
            assert not bool(part.ang.any())
        assert bool(i_f.joint.vel.any())


def test_contact_info_variant_matches_jax_fused(host_lib, monkeypatch):
    """The host build with `info="contact"` against the JAX package's fused
    step built under POBRAX_INFO=contact (tests/test_fused.py's mini system):
    state and contact Info at the fused-vs-generic tolerances, joint and
    actuator Info both exactly zero."""
    from pobrax_tpu.physics import config as jc
    from pobrax_tpu.physics import system as jsys

    monkeypatch.setenv("POBRAX_INFO", "contact")
    monkeypatch.setenv("POBRAX_FUSED", "1")
    jsys_ = jsys.System(mini_cfg(jc))
    tsys_ = System(mini_cfg(tc), device="cpu", info="contact")
    qp, act = jittered(tsys_, np.random.RandomState(6), 4)
    jqp = type(jsys_.default_qp())(*(x.numpy() for x in (qp.pos, qp.rot, qp.vel, qp.ang)))
    jq, ji = jax.jit(jax.vmap(jsys_._fused_step))(jqp, act.numpy())
    q, i = host_step(host_lib, tsys_, qp, act)
    for name, tol in (("pos", 1e-5), ("rot", 1e-5), ("vel", 1e-3), ("ang", 1e-3)):
        np.testing.assert_allclose(getattr(q, name).numpy(), np.asarray(getattr(jq, name)),
                                   rtol=0, atol=tol, err_msg=name)
    np.testing.assert_allclose(i.contact.vel.numpy(), np.asarray(ji.contact.vel), rtol=0,
                               atol=1e-3)
    assert float(np.abs(np.asarray(ji.contact.vel)).max()) > 0
    for part_t, part_j in ((i.joint, ji.joint), (i.actuator, ji.actuator)):
        assert not bool(part_t.vel.any()) and not bool(part_t.ang.any())
        assert not np.asarray(part_j.vel).any() and not np.asarray(part_j.ang).any()


def walled_learner_state(batch, seed=5):
    """(System, qp, act): the learners' System after a reset and 3 plain
    steps of seeded random actions, every ant pushed to torso x = 5.15."""
    env = create("ant_tag", episode_length=None, action_repeat=6, auto_reset=False,
                 batch_size=batch, device="cpu")
    qp = env.reset(jr.PRNGKey(seed)).qp
    g = torch.Generator().manual_seed(seed)
    for _ in range(3):
        qp, _ = env.sys.step_generic(qp, torch.rand(batch, 8, generator=g) * 2 - 1)
    qp = push_ants(env.unwrapped, qp, 0, 5.15)
    return env.sys, qp, torch.rand(batch, 8, generator=g) * 2 - 1


def test_host_kernel_on_the_learners_system_all_walled(host_lib):
    """64 envs, all walled, 60 substeps: at least ALL_WALLED_MIN_AGREE of the
    envs within pos/rot 1e-5 and vel/ang 1e-3 of the plain step, all finite,
    and the lanes run backwards bit-equal to forwards."""
    sys_, qp, act = walled_learner_state(64)
    assert sys_.config.substeps == 60
    assert bool((sys_.contacts._capsule_box(qp)[4] > 0).any(-1).all()), "every ant walled"
    (q, i), (q_rev, _) = (host_step(host_lib, sys_, qp, act, reversed_lanes=r)
                          for r in (False, True))
    qg, _ = sys_.step_generic(qp, act)
    err = {f: (getattr(q, f) - getattr(qg, f)).abs().flatten(1).max(1).values
           for f in ("pos", "rot", "vel", "ang")}
    agree = ((err["pos"] <= 1e-5) & (err["rot"] <= 1e-5) & (err["vel"] <= 1e-3)
             & (err["ang"] <= 1e-3))
    assert float(agree.float().mean()) >= ALL_WALLED_MIN_AGREE, agree
    for f in ("pos", "rot", "vel", "ang"):
        assert bool(torch.isfinite(getattr(q, f)).all()), f
        assert torch.equal(getattr(q, f), getattr(q_rev, f)), f
    assert float(i.contact.vel.abs().max()) > 0
