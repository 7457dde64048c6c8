"""The whole-step kernel's arithmetic, checked on the CPU.

csrc/whole_step.cuh's `ws::step_env` — the function every CUDA thread runs —
also compiles as plain C++. This file builds it with g++ (through
csrc/whole_step_host.cpp, no torch headers) into a small library loaded with
ctypes, and holds it against the port's plain step at the fused-vs-generic
tolerances of tests/test_fused.py (pos/rot 1e-5, vel/ang/contact 1e-3), so a
wrong kernel fails here, before it reaches a GPU. No entry point of the
package loads this build. Skips where g++ is missing.
"""

import ctypes
import hashlib
import json
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from pobrax_tpu_torch import random as jr
from pobrax_tpu_torch.envs import create
from pobrax_tpu_torch.envs.ant_tag import AntTagEnv
from pobrax_tpu_torch.physics import step_tables, whole_step
from pobrax_tpu_torch.physics.state import P, QP, Info

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "ref_ant_tag_s7.npz")
_WIDTHS = (3, 4, 3, 3, 3, 3, 3, 3, 3, 3)


@pytest.fixture(scope="module")
def host_lib():
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: the host build of the kernel's per-env step needs it")
    src = whole_step.CSRC / "whole_step_host.cpp"
    digest = hashlib.sha256(src.read_bytes()
                            + (whole_step.CSRC / "whole_step.cuh").read_bytes()).hexdigest()
    out = whole_step.BUILD_DIR / f"whole_step_host-{digest[:16]}.so"
    if not out.exists():
        whole_step.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-o", str(tmp), str(src)],
                       check=True, capture_output=True)
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    lib.ws_whole_step_host.argtypes = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 15
    lib.ws_whole_step_host.restype = ctypes.c_int
    lib.ws_layout_words.argtypes = [ctypes.c_void_p]
    return lib


def host_step(lib, sys_, qp, act):
    """One control step through the host build of the kernel's code."""
    tables = step_tables.pack(step_tables.build(sys_))
    B, n = qp.pos.shape[0], sys_.num_bodies
    ins = [x.contiguous() for x in (qp.pos, qp.rot, qp.vel, qp.ang, act)]
    outs = [torch.empty(B, n, k) for k in _WIDTHS]
    lib.ws_whole_step_host(tables.ctypes.data, B, *[x.data_ptr() for x in ins],
                           *[o.data_ptr() for o in outs])
    p, r, v, a, cv, ca, jv, ja, av, aa = outs
    return QP(p, r, v, a), Info(P(cv, ca), P(jv, ja), P(av, aa))


def assert_close(got, want):
    (q, i), (q_ref, i_ref) = got, want
    for name, tol in (("pos", 1e-5), ("rot", 1e-5), ("vel", 1e-3), ("ang", 1e-3)):
        torch.testing.assert_close(getattr(q, name), getattr(q_ref, name), rtol=0, atol=tol,
                                   msg=name)
    for f in ("vel", "ang"):
        torch.testing.assert_close(getattr(i.contact, f), getattr(i_ref.contact, f), rtol=0,
                                   atol=1e-3, msg=f"contact.{f}")
        for part in ("joint", "actuator"):
            want_t = getattr(getattr(i_ref, part), f)
            torch.testing.assert_close(getattr(getattr(i, part), f), want_t, rtol=1e-5,
                                       atol=1e-5 * max(1.0, float(want_t.abs().max())),
                                       msg=f"{part}.{f}")


def test_layout_words_match_step_tables(host_lib):
    got = (ctypes.c_int * 8)()
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
