"""The whole-step kernel's packed tables (pobrax_tpu_torch/physics/step_tables.py).

Each slot's gather lists must name the result records that touch the body in
the exact order in which fused.py's loops, and the one-thread-per-env kernel
that ran them in series, added into its accumulators; the owner lane walks
them in that order, so the kernel's sums are fused.py's. The order is written
out here in plain Python, as those loops run, from the packed row tables, for
every registered System, the test systems, and both Info modes. The same file
checks that every registered System fits one block's shared memory and that a
System which does not raises ValueError before any launch.
"""

import numpy as np
import pytest
import torch

from pobrax_tpu_torch import envs
from pobrax_tpu_torch.physics import config as tc
from pobrax_tpu_torch.physics import step_tables as st
from pobrax_tpu_torch.physics import whole_step
from pobrax_tpu_torch.physics.system import System
from tests.test_torch_kernel_host import assert_close, host_lib, host_step, jittered  # noqa: F401
from tests.test_torch_physics import mini_cfg, multidof_cfg
from tests.test_torch_whole_step import many_spheres, overlapping

ROW_TABLES = (("bodies", st.BODY, "n_slots"), ("joints", st.JOINT, "n_joints"),
              ("thrusters", st.THRUSTER, "n_thr"), ("pp", st.POINT_PLANE, "n_pp"),
              ("ss", st.SPHERE_SPHERE, "n_ss"), ("cc", st.CAPSULE_CAPSULE, "n_cc"),
              ("cb", st.CAPSULE_BOX, "n_cb"), ("caps", st.CAPSULE, "n_caps"))


def _fields(buf, struct):
    out, off = {}, 0
    ints = buf.view(np.int32)
    for name, kind, count in struct:
        v = (ints if kind == "i" else buf)[off:off + count]
        out[name] = v[0].item() if count == 1 else v.copy()
        off += count
    return out


def decode(buf):
    """A packed buffer back into its header, row tables, slots and gather list."""
    H = _fields(buf, st.HEADER)
    out, off = {"H": H}, st.words(st.HEADER)
    for key, struct, count in ROW_TABLES:
        w = st.words(struct)
        out[key] = [_fields(buf[off + k * w:off + (k + 1) * w], struct) for k in range(H[count])]
        off += H[count] * w
    ints = buf[off:].view(np.int32)
    out["slot_of"] = ints[:H["n_bodies"]].tolist()
    out["gather"] = ints[H["n_bodies"]:].tolist()
    assert len(out["gather"]) == H["n_gather"]
    return out


def v1_order(T):
    """Per slot, the adds of one substep as the serial loops make them:
    (kind, record offset, rows summed)."""
    n = T["H"]["n_slots"]
    moves = [b["inv_mass"] != 0.0 for b in T["bodies"]]
    force, contact = [[] for _ in range(n)], [[] for _ in range(n)]
    for j in T["joints"]:  # fvel[c] += ..., fvel[p] -= ..., aang too when actuated
        kind = st.G_JOINT_ACT if j["act_idx"] >= 0 else st.G_JOINT
        force[j["child"]].append((kind, j["rec"], 0))
        force[j["parent"]].append((kind, j["rec"] + 9, 0))
    for t in T["thrusters"]:  # avel[body] += ...
        force[t["body"]].append((st.G_THRUST, t["rec"], 0))

    def resolve(a, b, rec):  # j on a (if it has mass), -j on b (if it has mass)
        if moves[a]:
            contact[a].append((st.G_SIDE, rec, 0))
        if moves[b]:
            contact[b].append((st.G_SIDE, rec + 6, 0))

    flush = {"cur": -1, "recs": []}

    def to(body):  # the frozen rows' running sum goes to `cur` when the body changes
        if flush["cur"] >= 0:
            recs = flush["recs"]
            assert recs == [recs[0] + 6 * i for i in range(len(recs))], "rows not contiguous"
            contact[flush["cur"]].append((st.G_FLUSH, recs[0], len(recs)))
        flush["cur"], flush["recs"] = body, []

    for r in T["pp"]:
        if r["b_moves"]:
            resolve(r["a"], r["b"], r["rec"])
            continue
        if r["a"] != flush["cur"]:
            to(r["a"])
        flush["recs"].append(r["rec"])
    to(-1)
    for r in T["ss"] + T["cc"]:
        resolve(r["a"], r["b"], r["rec"])
    for r in T["cb"]:
        if not r["b_moves"] and r["a"] != flush["cur"]:
            to(r["a"])
        if r["b_moves"]:
            for q in range(3):
                resolve(r["a"], r["b"], r["rec"] + 12 * q)
        else:
            flush["recs"].append(r["rec"])
    to(-1)
    return force, contact


def _entries(T, lo, hi):
    return [(e >> 28, e & 0xffff, (e >> 16) & 0xfff) for e in T["gather"][lo:hi]]


def every_kind_cfg():
    """One body, `hub` (a sphere and a capsule), in rows of every kind and
    phase: a frozen ground plane and a moving tray (point-plane against a
    frozen and a moving plane), a ball (sphere-sphere, capsule-capsule), a
    rod (capsule-capsule), a frozen wall and a moving crate (capsule-box
    against a frozen and a moving box); its accumulators see every phase, so
    any reordering of the phases shows in its gather list."""
    c = tc
    hub = c.Body(name="hub", colliders=(c.Collider(geom=c.Sphere(0.2)),
                                        c.Collider(geom=c.Capsule(radius=0.1, length=0.6),
                                                   position=(0.0, 0.0, 0.2))))
    others = (c.Body(name="ground", colliders=(c.Collider(geom=c.Plane()),), frozen=True),
              c.Body(name="tray", colliders=(c.Collider(geom=c.Plane(), position=(0, 0, 0.1)),)),
              c.Body(name="ball", colliders=(c.Collider(geom=c.Sphere(0.15)),)),
              c.Body(name="rod", colliders=(c.Collider(geom=c.Capsule(radius=0.1, length=0.5)),)),
              c.Body(name="wall", colliders=(c.Collider(geom=c.Box(halfsize=(0.3, 0.3, 0.3))),),
                     frozen=True),
              c.Body(name="crate", colliders=(c.Collider(geom=c.Box(halfsize=(0.2, 0.2, 0.2))),)))
    return c.Config(bodies=(hub,) + others,
                    collide_include=tuple(("hub", b.name) for b in others))


def _system(name, info):
    if name in ("mini", "multidof", "every_kind"):
        cfg = {"mini": mini_cfg, "multidof": multidof_cfg,
               "every_kind": lambda c: every_kind_cfg()}[name](tc)
        return System(cfg, device="cpu", info=info)
    return envs._envs[name](device="cpu", info=info).sys


SYSTEMS = sorted(envs._envs) + ["mini", "multidof", "every_kind"]


@pytest.mark.parametrize("info", st.INFO_MODES)
@pytest.mark.parametrize("name", SYSTEMS)
def test_gather_lists_follow_fused_order(name, info):
    sys_ = _system(name, info)
    T = decode(st.pack(st.build(sys_)))
    force, contact = v1_order(T)
    assert T["H"]["info_contact"] == (info == "contact")
    for i, b in enumerate(T["bodies"]):
        assert _entries(T, b["force_lo"], b["force_hi"]) == force[i], f"slot {i} forces"
        assert _entries(T, b["contact_lo"], b["contact_hi"]) == contact[i], f"slot {i} contacts"
        assert b["force_hi"] == b["contact_lo"]
        # its capsules are its own, and each frozen-box row reads its capsule
        assert all(T["caps"][k]["body"] == i for k in range(b["cap_lo"], b["cap_hi"]))
    assert sum(b["cap_hi"] - b["cap_lo"] for b in T["bodies"]) == T["H"]["n_caps"]
    cap_recs = {c["rec"]: c["body"] for c in T["caps"]}
    assert all(cap_recs[r["cap"]] == r["a"] for r in T["cb"])


def test_every_kind_scene_reaches_every_phase(host_lib):
    """The hub's lists hold every phase in fused.py's order, and the host
    build of the kernel steps the scene as the plain step does, forward and
    with each phase's lanes reversed, from a jittered state in which the
    bodies overlap."""
    sys_ = _system("every_kind", "full")
    T = decode(st.pack(st.build(sys_)))
    hub = T["bodies"][0]
    kinds = [k for k, _, _ in _entries(T, hub["contact_lo"], hub["contact_hi"])]
    assert kinds.count(st.G_FLUSH) == 2 and kinds.count(st.G_SIDE) >= 4
    assert {r["b_moves"] for r in T["pp"]} == {0, 1} == {r["b_moves"] for r in T["cb"]}
    assert T["H"]["n_ss"] > 0 and T["H"]["n_cc"] > 0
    qp, act = jittered(sys_, np.random.RandomState(9), 4)
    want = sys_.step_generic(qp, act)
    assert float(want[1].contact.vel[:, 0].abs().max()) > 0
    got = host_step(host_lib, sys_, qp, act)
    assert_close(got, want)
    rev = host_step(host_lib, sys_, qp, act, reversed_lanes=True)
    for f in ("pos", "rot", "vel", "ang"):
        assert torch.equal(getattr(got[0], f), getattr(rev[0], f)), f


@pytest.mark.parametrize("name", SYSTEMS)
def test_scratch_records_do_not_overlap(name):
    """Within a phase each record is written by one lane: the force records
    are disjoint, the contact records are disjoint, and neither overlaps the
    snapshot, the actions or the capsule endpoints, which they must not
    clobber while others read them."""
    T = decode(st.pack(st.build(_system(name, "full"))))
    H = T["H"]
    fixed_end = st.SNAP_WORDS + H["n_act"] + 6 * H["n_caps"]
    assert H["off_act"] == st.SNAP_WORDS and H["off_info"] == fixed_end

    def spans(rows):
        out = []
        for r in rows:
            size = (st.REC_TWO_BODY if r.get("b_moves", 1) else st.REC_FROZEN)
            out.append((r["rec"], r["rec"] + size * (3 if "cap" in r and r["b_moves"] else 1)))
        return out

    force = ([(j["rec"], j["rec"] + st.REC_JOINT) for j in T["joints"]]
             + [(t["rec"], t["rec"] + st.REC_THRUST) for t in T["thrusters"]])
    contact = spans(T["pp"]) + spans(T["ss"]) + spans(T["cc"]) + spans(T["cb"])
    caps = [(c["rec"], c["rec"] + st.REC_CAPSULE) for c in T["caps"]]
    for group in (force, contact, caps):
        group = sorted(group)
        assert all(lo >= st.SNAP_WORDS + H["n_act"] for lo, _ in group)
        assert all(hi <= lo2 for (_, hi), (lo2, _) in zip(group, group[1:]))
        assert all(hi <= H["scratch_words"] for _, hi in group)
    assert all(lo >= fixed_end for lo, _ in force + contact)
    assert fixed_end + st.INFO_WORDS * H["n_slots"] <= H["scratch_words"]


@pytest.mark.parametrize("name", sorted(envs._envs))
def test_registered_systems_fit_shared_memory(name):
    """Tables plus one scratch per env of the block, within an H100 block's
    227 KB; the maze, with the most rows, needs about 47 KB."""
    sys_ = _system(name, "full")
    need = whole_step.shared_bytes(sys_)
    assert 0 < need <= st.SHARED_LIMIT
    whole_step.check_fits(sys_)
    if name == "ant_maze":
        assert 40_000 < need < 50_000


def test_system_too_big_for_shared_memory_raises_before_launch():
    """40 x 40 = 1600 two-body rows: 12 scratch words each for each of the
    block's envs, beyond 227 KB. `launch` raises ValueError before it looks
    at the tensors or the library; nothing is launched."""
    sys_ = System(many_spheres(40), device="cpu")
    assert st.row_counts(st.build(sys_))["n_ss"] == 1600
    assert whole_step.shared_bytes(sys_) > st.SHARED_LIMIT
    qp = sys_.default_qp()
    before = whole_step.launches
    with pytest.raises(ValueError, match="shared memory"):
        whole_step.launch(sys_, qp, torch.zeros(1, 0))
    assert whole_step.launches == before
    # a smaller one of the same kind fits
    assert whole_step.shared_bytes(System(many_spheres(10), device="cpu")) < st.SHARED_LIMIT


@pytest.mark.parametrize("n", [6, 15])
def test_host_kernel_steps_many_row_systems(host_lib, n):
    """n x n two-body rows (36 and 225; 225 need more than the 48 KB of
    shared memory a kernel gets by default): the host build agrees with the
    plain step, and with each phase's lanes reversed it agrees bit for bit."""
    sys_ = System(many_spheres(n), device="cpu")
    assert (whole_step.shared_bytes(sys_) > 48 * 1024) == (n == 15)
    qp, act = overlapping(sys_, 4, n, "cpu")
    want = sys_.step_generic(qp, act)
    assert bool((want[1].contact.vel.abs().flatten(1).max(1).values > 0).all())
    got = host_step(host_lib, sys_, qp, act)
    assert_close(got, want)
    rev = host_step(host_lib, sys_, qp, act, reversed_lanes=True)
    for f in ("pos", "rot", "vel", "ang"):
        assert torch.equal(getattr(got[0], f), getattr(rev[0], f)), f
    assert torch.equal(got[1].contact.vel, rev[1].contact.vel)
