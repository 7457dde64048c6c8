"""The whole-step kernel's constant tables, built on the host from a `System`.

The host half of `pobrax_tpu/physics/fused.py`: the joint table
(fused.py:365-382), the thruster table (:400-403), the contact row lists
(:385-398), frozen bodies and their static rotations (:405-411), the
vectorised capsule-box and point-plane phases over rows against frozen
bodies (`compile_cb_vec`, `compile_pp_vec`: fused.py:138-208, :297-340) and
the integrator and contact constants (:352-363). `compile_cb_vec`,
`compile_pp_vec` and `joint_table` return what their fused.py twins return;
tests/test_torch_scene.py holds them equal.

`pack` lays the tables out as one flat buffer of 32-bit words in the C
structs of `csrc/whole_step.cuh` (Header, then Body x n_slots, Joint x nj,
Thruster x nt, PointPlane x npp, SphereSphere x nss, CapsuleCapsule x ncc,
CapsuleBox x ncb, Capsule x ncaps, the slot of each body, and the gather
lists). The kernel loops over these rows at run time, so one build of the
kernel serves every System; each block stages the buffer in shared memory.

Slots: only the bodies the step touches — those that move on some axis, and
those a joint, thruster or contact row names — take a slot, in body order;
lane i of an env's lanes owns slot i. Body records are written per slot, with
the body's index in the state arrays; every joint, thruster and row index is
a slot. Every other body (AntGather's 16 apples and bombs) passes through:
the kernel copies its state from input to output with zero Info, which is
exact, since the step gives such a body no force, no impulse and no motion.

Scratch: `pack` also lays out each env's scratch in shared memory (the
snapshot of the slots' state, the actions, the capsules' world endpoints,
and one result record per joint, thruster and contact row), writes each
row's record offset into the row, and builds each slot's gather lists: the
records that touch the body, in the exact order in which fused.py's loops
(and the first, one-thread-per-env kernel) added them into its accumulators
— joints in joint order, then point-plane rows against a moving body, the
frozen point-plane flush, sphere-sphere, capsule-capsule, capsule-box rows
against a moving box (sample by sample), the frozen capsule-box flush. The
owner lane walks its lists in order, so the sums are taken as fused.py takes
them.

Coverage: the whole engine — 1-, 2- and 3-dof joints with torque or
angle-servo actuators, thrusters, per-axis frozen masks, and point-plane,
sphere-sphere, capsule-capsule and capsule-box rows whether or not their
second body is frozen — with full Info or contact Info only. A point-plane or
capsule-box row against a frozen body folds that body's frame into the row;
one against a moving body carries the frame in the body's own coordinates
and is turned into the world each substep. The limits: `MAX_BODIES` touched
bodies (one lane each, with room in the snapshot), for which `build` raises
ValueError, and one block's shared memory (`shared_bytes`), which
`physics/whole_step.py` checks before a launch.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from pobrax_tpu_torch.physics.joints import ANGLE_SERVO_GAIN

# must equal ws::kMaxBodies in csrc/whole_step.cuh (owner lanes, snapshot
# slots); it bounds the touched bodies, not all bodies
MAX_BODIES = 16
INFO_MODES = ("full", "contact")
# envs per block: kEnvs in csrc/whole_step.cu (4 warps, a half-warp per
# env), checked at load
ENVS_PER_BLOCK = 8
# shared memory one block may use on an H100 (227 KB; NVIDIA's tuning guide)
SHARED_LIMIT = 232448
SNAP_WORDS = 13 * MAX_BODIES  # ws::kSnapWords: pos 3, rot 4, vel 3, ang 3 per slot
# result record words: a joint (child and parent, 9 each), a thruster, a row
# against a frozen body (j, r x j), a two-body row (both sides, 6 each), a
# capsule's world endpoints
REC_JOINT, REC_THRUST, REC_FROZEN, REC_TWO_BODY, REC_CAPSULE = 18, 3, 6, 12, 6
INFO_WORDS = 18  # a slot's staged Info sums
# gather entries (ws::GatherKind): kind << 28 | count << 16 | scratch offset
G_JOINT, G_JOINT_ACT, G_THRUST, G_SIDE, G_FLUSH = range(5)

# C struct layouts of csrc/whole_step.cuh, field by field: (name, kind, count)
# with kind "i" (int32) or "f" (float32). whole_step.py checks the word counts
# against the compiled library's.
HEADER = [("n_bodies", "i", 1), ("n_slots", "i", 1), ("info_contact", "i", 1),
          ("n_act", "i", 1), ("substeps", "i", 1),
          ("n_joints", "i", 1), ("n_thr", "i", 1), ("n_pp", "i", 1), ("n_ss", "i", 1),
          ("n_cc", "i", 1), ("n_cb", "i", 1), ("n_caps", "i", 1), ("n_gather", "i", 1),
          ("scratch_words", "i", 1), ("off_act", "i", 1), ("off_info", "i", 1),
          ("h", "f", 1), ("half_h", "f", 1), ("vel_damp", "f", 1), ("ang_damp", "f", 1),
          ("gravity", "f", 3), ("baumgarte", "f", 1), ("one_plus_e", "f", 1),
          ("friction", "f", 1), ("servo_gain", "f", 1)]
BODY = [("index", "i", 1), ("inv_mass", "f", 1), ("inv_inertia", "f", 3),
        ("active_pos", "f", 3), ("active_rot", "f", 3), ("frozen", "i", 1), ("rot_free", "i", 1),
        ("default_rot", "f", 4), ("force_lo", "i", 1), ("force_hi", "i", 1),
        ("contact_lo", "i", 1), ("contact_hi", "i", 1), ("cap_lo", "i", 1), ("cap_hi", "i", 1)]
JOINT = [("parent", "i", 1), ("child", "i", 1), ("dof", "i", 1), ("act_idx", "i", 1),
         ("act_kind", "i", 1), ("rec", "i", 1), ("off_p", "f", 3), ("off_c", "f", 3),
         ("q_j", "f", 4),
         ("lim", "f", 6), ("k", "f", 1), ("kd", "f", 1), ("klim", "f", 1),
         ("kang", "f", 1), ("act_k", "f", 1)]
THRUSTER = [("body", "i", 1), ("act", "i", 1), ("rec", "i", 1), ("dir", "f", 3),
            ("strength", "f", 1), ("inv_mass", "f", 1), ("pad", "f", 1)]
POINT_PLANE = [("a", "i", 1), ("b", "i", 1), ("b_moves", "i", 1), ("rec", "i", 1),
               ("point", "f", 3), ("radius", "f", 1), ("normal", "f", 3), ("off_w", "f", 3),
               ("invm_a", "f", 1), ("inertia_a", "f", 3), ("pad", "f", 1)]
SPHERE_SPHERE = [("a", "i", 1), ("b", "i", 1), ("rec", "i", 1), ("pa", "f", 3), ("ra", "f", 1),
                 ("pb", "f", 3), ("rb", "f", 1)]
CAPSULE_CAPSULE = [("a", "i", 1), ("b", "i", 1), ("rec", "i", 1), ("e0a", "f", 3),
                   ("e1a", "f", 3), ("ra", "f", 1), ("e0b", "f", 3), ("e1b", "f", 3),
                   ("rb", "f", 1)]
CAPSULE_BOX = [("a", "i", 1), ("b", "i", 1), ("cap", "i", 1), ("b_moves", "i", 1),
               ("rec", "i", 1), ("radius", "f", 1), ("rot", "f", 9), ("box_q", "f", 4),
               ("box_off_w", "f", 3), ("halfsize", "f", 3), ("invm_a", "f", 1),
               ("inertia_a", "f", 3)]
CAPSULE = [("body", "i", 1), ("rec", "i", 1), ("e0", "f", 3), ("e1", "f", 3), ("pad", "f", 1)]
STRUCTS = (HEADER, BODY, JOINT, THRUSTER, POINT_PLANE, SPHERE_SPHERE, CAPSULE_CAPSULE,
           CAPSULE_BOX, CAPSULE)


def words(struct) -> int:
    return sum(count for _, _, count in struct)


# ---- host-side float helpers (fused.py:101-132) ----------------------------


def _qmul_f(a, b):
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return (
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    )


def _qrot_f(v, q):
    w, x, y, z = q
    vx, vy, vz = v
    tx = 2.0 * (y * vz - z * vy)
    ty = 2.0 * (z * vx - x * vz)
    tz = 2.0 * (x * vy - y * vx)
    return (
        vx + w * tx + (y * tz - z * ty),
        vy + w * ty + (z * tx - x * tz),
        vz + w * tz + (x * ty - y * tx),
    )


def _quat_mat_f(q):
    """3x3 rotation matrix (local -> world) of a quaternion tuple."""
    w, x, y, z = q
    return [
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ]


def _body_slices(rows) -> list:
    """Contiguous (body, lo, hi) row ranges of rows sorted by capsule body."""
    out, lo = [], 0
    for k in range(1, len(rows) + 1):
        if k == len(rows) or rows[k]["a"] != rows[lo]["a"]:
            out.append((rows[lo]["a"], lo, k))
            lo = k
    return out


def compile_cb_vec(rows, default_rot, inv_mass, inv_inertia) -> Dict:
    """Constants of the capsule-box phase over rows whose box body is frozen,
    so the box world frame folds to per-row constants (fused.py:138-208).
    Rows are sorted by capsule body and capsule, so each capsule's rows, and
    each body's, are contiguous."""
    def cap_key(r):
        return (r["a"], tuple(r["e0"]), tuple(r["e1"]), r["radius"])

    rows = sorted(rows, key=lambda r: (r["a"], cap_key(r)))
    K = len(rows)
    caps, cap_repeats = [], []
    for r in rows:
        key = (r["a"], tuple(r["e0"]), tuple(r["e1"]))
        if caps and caps[-1] == key:
            cap_repeats[-1] += 1
        else:
            caps.append(key)
            cap_repeats.append(1)

    uniq_b = sorted({r["b"] for r in rows})
    b_mask = np.zeros((len(uniq_b), K, 1), np.float32)
    rot_w = np.zeros((K, 3, 3), np.float32)   # box local -> world
    box_off_w = np.zeros((K, 3), np.float32)  # rotate(box_pos_local, rot_b)
    halfsize = np.zeros((K, 3), np.float32)
    radius = np.zeros((K,), np.float32)
    invm_a = np.zeros((K,), np.float32)
    inertia_a = np.zeros((K, 3), np.float32)
    for k, r in enumerate(rows):
        b = r["b"]
        b_mask[uniq_b.index(b), k, 0] = 1.0
        q_b = default_rot[b]
        box_q = _qmul_f(q_b, tuple(r["box_quat"]))
        rot_w[k] = np.array(_quat_mat_f(box_q), np.float64)
        box_off_w[k] = _qrot_f(tuple(r["box_pos"]), q_b)
        halfsize[k] = r["halfsize"]
        radius[k] = r["radius"]
        invm_a[k] = inv_mass[r["a"]]
        inertia_a[k] = inv_inertia[r["a"]]

    return dict(
        caps=[(a, e0, e1) for (a, e0, e1) in caps],
        cap_repeats=np.asarray(cap_repeats, np.int32),
        uniq_b=uniq_b, b_mask=b_mask,
        rot_cols=[[rot_w[:, i, j].copy() for j in range(3)] for i in range(3)],
        box_off_w=box_off_w,
        halfsize=halfsize, radius=radius, invm_a=invm_a, inertia_a=inertia_a,
        body_slices=_body_slices(rows),
    )


def compile_pp_vec(rows, default_rot, inv_mass, inv_inertia) -> Dict:
    """Constants of the point-plane phase over rows against frozen planes:
    the plane normal and in-plane offset fold to constants (fused.py:297-340).
    Rows are sorted by point body."""
    rows = sorted(rows, key=lambda r: r["a"])
    K = len(rows)
    uniq_b = sorted({r["b"] for r in rows})
    b_mask = np.zeros((len(uniq_b), K), np.float32)
    normal = np.zeros((K, 3), np.float32)
    off_w = np.zeros((K, 3), np.float32)   # rotate(plane_pos_local, rot_b)
    radius = np.zeros((K,), np.float32)
    invm_a = np.zeros((K,), np.float32)
    inertia_a = np.zeros((K, 3), np.float32)
    points = []
    for k, r in enumerate(rows):
        b = r["b"]
        b_mask[uniq_b.index(b), k] = 1.0
        q_b = default_rot[b]
        prot = _qmul_f(q_b, tuple(r["plane_quat"]))
        normal[k] = _qrot_f((0.0, 0.0, 1.0), prot)
        off_w[k] = _qrot_f(tuple(r["plane_pos"]), q_b)
        radius[k] = r["radius"]
        invm_a[k] = inv_mass[r["a"]]
        inertia_a[k] = inv_inertia[r["a"]]
        points.append((r["a"], tuple(r["point"])))

    return dict(
        points=points, uniq_b=uniq_b, b_mask=b_mask,
        normal_cols=[normal[:, c].copy() for c in range(3)],
        off_w=off_w, radius=radius, invm_a=invm_a, inertia_a=inertia_a,
        body_slices=_body_slices(rows),
    )


def joint_table(sys) -> List[Dict]:
    """The flat joint table of fused.py:365-382, group-major."""
    joints = []
    for g in sys.joints:
        for j in range(g.count):
            joints.append(dict(
                dof=g.dof,
                parent=int(g.parent[j]), child=int(g.child[j]),
                off_p=tuple(float(v) for v in g.off_p[j]),
                off_c=tuple(float(v) for v in g.off_c[j]),
                q_j=tuple(float(v) for v in g.q_j[j]),
                lim=[(float(g.limit[j, d, 0]), float(g.limit[j, d, 1]))
                     for d in range(g.dof)],
                k=float(g.stiffness[j]), kd=float(g.spring_damping[j]),
                klim=float(g.limit_strength[j]),
                kang=float(g.angular_damping[j]),
                act_idx=int(g.act_idx[j]), act_k=float(g.act_strength[j]),
                act_kind=int(g.act_kind[j]),
            ))
    return joints


def contact_rows(packed, fields) -> List[Dict]:
    """A packed contact table as a list of per-row dicts (fused.py:385-393)."""
    if packed is None:
        return []
    out = []
    for k in range(packed["a"].shape[0]):
        out.append({f: (packed[f][k].tolist() if packed[f][k].ndim else packed[f][k].item())
                    for f in fields})
    return out


PP_FIELDS = ("a", "point", "radius", "b", "plane_pos", "plane_quat")
SS_FIELDS = ("a", "pa", "ra", "b", "pb", "rb")
CC_FIELDS = ("a", "e0a", "e1a", "ra", "b", "e0b", "e1b", "rb")
CB_FIELDS = ("a", "e0", "e1", "radius", "b", "box_pos", "box_quat", "halfsize")


def touched_bodies(sys, t: Dict) -> List[int]:
    """The bodies the step touches, in body order: those that move on some
    axis and those a joint, thruster or contact row of `t` names."""
    named = {b for j in t["joints"] for b in (j["parent"], j["child"])}
    named |= {th["body"] for th in t["thrusters"]}
    for rows in (t["pp_rows"], t["ss_rows"], t["cc_rows"], t["cb_rows"]):
        named |= {r[k] for r in rows for k in ("a", "b")}
    body = sys.body
    return [i for i in range(sys.num_bodies)
            if i in named or body.active_pos[i].any() or body.active_rot[i].any()]


def build(sys) -> Dict:
    """Every constant the kernel reads, as host values, with body indices (not
    slots); raises ValueError for a System whose touched bodies exceed the
    kernel's per-thread arrays."""
    body, ct = sys.body, sys.contacts
    n = sys.num_bodies
    frozen = [bool(f) for f in body.frozen]
    default_rot = [tuple(float(v) for v in sys._default_pose[1][i]) for i in range(n)]
    inv_mass = [float(m) for m in body.inv_mass]
    inv_inertia = [tuple(float(v) for v in row) for row in body.inv_inertia]

    # rows against a frozen body fold its frame in (fused.py's vectorised
    # phases); rows against a moving one keep it in the body's frame
    pp_rows = contact_rows(ct.point_plane, PP_FIELDS)
    cb_rows = contact_rows(ct.capsule_box, CB_FIELDS)
    pp_frozen = [r for r in pp_rows if frozen[r["b"]]]
    cb_frozen = [r for r in cb_rows if frozen[r["b"]]]
    thrusters = [dict(body=int(b), act=sys._thruster_act0 + t,
                      dir=tuple(float(v) for v in sys._thruster_dir[t]),
                      strength=float(sys._thruster_strength[t]), inv_mass=inv_mass[int(b)])
                 for t, b in enumerate(sys._thruster_body)]
    integ = sys.integrator
    t = dict(
        n_bodies=n, n_act=sys.action_size, substeps=integ.substeps,
        info_contact=sys.info_mode == "contact",
        h=integ.h, vel_damp=integ.vel_damp, ang_damp=integ.ang_damp,
        gravity=tuple(float(g) for g in integ.gravity),
        baumgarte=ct.baumgarte_erp / ct.h_sub, elasticity=ct.elasticity,
        friction=ct.friction, servo_gain=ANGLE_SERVO_GAIN,
        frozen=frozen, default_rot=default_rot, inv_mass=inv_mass, inv_inertia=inv_inertia,
        active_pos=body.active_pos, active_rot=body.active_rot,
        joints=joint_table(sys), thrusters=thrusters,
        pp_rows=pp_rows, cb_rows=cb_rows,
        pp_moving=[r for r in pp_rows if not frozen[r["b"]]],
        pp_vec=(compile_pp_vec(pp_frozen, default_rot, inv_mass, inv_inertia)
                if pp_frozen else None),
        ss_rows=contact_rows(ct.sphere_sphere, SS_FIELDS),
        cc_rows=contact_rows(ct.capsule_capsule, CC_FIELDS),
        cb_moving=[r for r in cb_rows if not frozen[r["b"]]],
        cb_vec=(compile_cb_vec(cb_frozen, default_rot, inv_mass, inv_inertia)
                if cb_frozen else None),
    )
    t["slots"] = touched_bodies(sys, t)
    t["pass_through"] = sorted(set(range(n)) - set(t["slots"]))
    if len(t["slots"]) > MAX_BODIES:
        raise ValueError(f"whole-step kernel: {len(t['slots'])} touched bodies (of {n}) exceed "
                         f"MAX_BODIES={MAX_BODIES} (one owner lane each in "
                         f"csrc/whole_step.cuh)")
    return t


def _record(struct, values: Dict) -> np.ndarray:
    out = np.zeros(words(struct), np.float32)
    ints = out.view(np.int32)
    off = 0
    for name, kind, count in struct:
        v = np.asarray(values.get(name, 0) if name == "pad" else values[name],
                       np.float64).reshape(count)
        if kind == "i":
            ints[off:off + count] = v.astype(np.int32)
        else:
            out[off:off + count] = v.astype(np.float32)
        off += count
    return out


def row_counts(t: Dict) -> Dict[str, int]:
    """The number of rows of each table of `build`'s output."""
    pv, cv = t["pp_vec"], t["cb_vec"]
    return dict(
        n_joints=len(t["joints"]), n_thr=len(t["thrusters"]),
        n_pp=len(t["pp_moving"]) + (len(pv["points"]) if pv else 0),
        n_ss=len(t["ss_rows"]), n_cc=len(t["cc_rows"]),
        n_cb=len(t["cb_moving"]) + (int(cv["cap_repeats"].sum()) if cv else 0))


def capsules(t: Dict) -> List:
    """The distinct capsules (body, e0, e1) of the capsule-box rows, by body:
    each one's world endpoints are computed once per substep, by its body's
    owner lane."""
    cv = t["cb_vec"]
    keys = list(cv["caps"]) if cv else []
    keys += [(r["a"], tuple(r["e0"]), tuple(r["e1"])) for r in t["cb_moving"]]
    out = []
    for key in sorted(keys, key=lambda k: k[0]):
        if key not in out:
            out.append(key)
    return out


def _rows(t: Dict, slot: Dict) -> Dict[str, List[Dict]]:
    """Every row as the kernel's table holds it (indices as slots), in table
    order: rows against a moving body before those against a frozen one, as
    fused.py's scalar rows run before its vectorised ones; within each table
    the rows keep fused.py's order, since the impulse sums are taken in it."""
    caps = capsules(t)
    pp = [dict(a=slot[r["a"]], b=slot[r["b"]], b_moves=1, point=r["point"], radius=r["radius"],
               normal=_qrot_f((0.0, 0.0, 1.0), tuple(r["plane_quat"])), off_w=r["plane_pos"],
               invm_a=t["inv_mass"][r["a"]], inertia_a=t["inv_inertia"][r["a"]])
          for r in t["pp_moving"]]
    pv = t["pp_vec"]
    for k, (a, point) in enumerate(pv["points"] if pv else []):
        pp.append(dict(
            a=slot[a], b=slot[pv["uniq_b"][int(np.argmax(pv["b_mask"][:, k]))]], b_moves=0,
            point=point, radius=pv["radius"][k],
            normal=[pv["normal_cols"][c][k] for c in range(3)],
            off_w=pv["off_w"][k], invm_a=pv["invm_a"][k], inertia_a=pv["inertia_a"][k]))
    cb = [dict(a=slot[r["a"]], b=slot[r["b"]], b_moves=1,
               cap=caps.index((r["a"], tuple(r["e0"]), tuple(r["e1"]))),
               radius=r["radius"], rot=np.zeros(9), box_q=r["box_quat"], box_off_w=r["box_pos"],
               halfsize=r["halfsize"], invm_a=t["inv_mass"][r["a"]],
               inertia_a=t["inv_inertia"][r["a"]])
          for r in t["cb_moving"]]
    cv = t["cb_vec"]
    if cv:
        row_cap = np.repeat(np.arange(len(cv["caps"])), cv["cap_repeats"])
        for k in range(len(row_cap)):
            cb.append(dict(
                a=slot[cv["caps"][row_cap[k]][0]],
                b=slot[cv["uniq_b"][int(np.argmax(cv["b_mask"][:, k, 0]))]], b_moves=0,
                cap=caps.index(cv["caps"][row_cap[k]]), radius=cv["radius"][k],
                rot=[cv["rot_cols"][i][j][k] for i in range(3) for j in range(3)],
                box_q=np.zeros(4), box_off_w=cv["box_off_w"][k], halfsize=cv["halfsize"][k],
                invm_a=cv["invm_a"][k], inertia_a=cv["inertia_a"][k]))
    return dict(
        joints=[{**j, "parent": slot[j["parent"]], "child": slot[j["child"]]}
                for j in t["joints"]],
        thrusters=[{**th, "body": slot[th["body"]]} for th in t["thrusters"]],
        pp=pp,
        ss=[{**r, "a": slot[r["a"]], "b": slot[r["b"]]} for r in t["ss_rows"]],
        cc=[{**r, "a": slot[r["a"]], "b": slot[r["b"]]} for r in t["cc_rows"]],
        cb=cb,
        caps=[dict(body=slot[a], e0=e0, e1=e1) for a, e0, e1 in caps])


def _entry(kind: int, off: int, count: int = 0) -> int:
    if not (0 <= off < 1 << 16 and 0 <= count < 1 << 12):
        raise ValueError(f"whole-step kernel: gather entry (offset {off}, {count} rows) out of "
                         f"range: the System's scratch is too large for shared memory")
    return kind << 28 | count << 16 | off


def _scratch(t: Dict, rows: Dict) -> Dict[str, int]:
    """Each env's scratch: the snapshot, the actions, the capsules' world
    endpoints, then one region shared by the force records (joints,
    thrusters), the contact records (rows in table order) and, after the
    last substep, the staged Info sums. Sets each row's `rec`; returns the
    offsets and the scratch's size in words."""
    off_act = SNAP_WORDS
    off = off_act + t["n_act"]
    for c in rows["caps"]:
        c["rec"], off = off, off + REC_CAPSULE
    region = off
    for j in rows["joints"]:
        j["rec"], off = off, off + REC_JOINT
    for th in rows["thrusters"]:
        th["rec"], off = off, off + REC_THRUST
    force_end, off = off, region
    for kind in ("pp", "ss", "cc", "cb"):
        for r in rows[kind]:
            moves = r.get("b_moves", 1)
            size = REC_TWO_BODY if moves else REC_FROZEN
            r["rec"], off = off, off + (3 * size if kind == "cb" and moves else size)
    info_end = region + INFO_WORDS * len(t["slots"])
    return dict(off_act=off_act, off_info=region,
                scratch_words=max(force_end, off, info_end))


def _gather(t: Dict, rows: Dict) -> List[Dict[str, List[int]]]:
    """Each slot's gather entries for the forces and the contacts phase, in
    the order in which fused.py adds into the body's accumulators."""
    n_slots = len(t["slots"])
    moves = [t["inv_mass"][b] != 0.0 for b in t["slots"]]  # resolve() skips a massless side
    force = [[] for _ in range(n_slots)]
    contact = [[] for _ in range(n_slots)]
    for j in rows["joints"]:
        kind = G_JOINT_ACT if j["act_idx"] >= 0 else G_JOINT
        force[j["child"]].append(_entry(kind, j["rec"]))
        force[j["parent"]].append(_entry(kind, j["rec"] + REC_JOINT // 2))
    for th in rows["thrusters"]:
        force[th["body"]].append(_entry(G_THRUST, th["rec"]))

    def sides(r, rec):
        for body, off in ((r["a"], rec), (r["b"], rec + REC_TWO_BODY // 2)):
            if moves[body]:
                contact[body].append(_entry(G_SIDE, off))

    def flushes(frozen):  # rows sorted by body a: one flush per body
        for k, r in enumerate(frozen):
            if k == 0 or r["a"] != frozen[k - 1]["a"]:
                count = sum(1 for q in frozen[k:] if q["a"] == r["a"])
                contact[r["a"]].append(_entry(G_FLUSH, r["rec"], count))

    for r in rows["pp"]:
        if r["b_moves"]:
            sides(r, r["rec"])
    flushes([r for r in rows["pp"] if not r["b_moves"]])
    for r in rows["ss"] + rows["cc"]:
        sides(r, r["rec"])
    for r in rows["cb"]:
        if r["b_moves"]:
            for q in range(3):
                sides(r, r["rec"] + q * REC_TWO_BODY)
    flushes([r for r in rows["cb"] if not r["b_moves"]])
    return [dict(force=f, contact=c) for f, c in zip(force, contact)]


def pack(t: Dict) -> np.ndarray:
    """The tables of `build` as the kernel's flat buffer of 32-bit words,
    body indices turned into slots, with each env's scratch laid out and each
    slot's gather lists."""
    slot = {b: i for i, b in enumerate(t["slots"])}
    rows = _rows(t, slot)
    scratch = _scratch(t, rows)
    lists = _gather(t, rows)
    gather, spans = [], []
    for g in lists:
        lo = len(gather)
        gather += g["force"]
        mid = len(gather)
        gather += g["contact"]
        spans.append((lo, mid, mid, len(gather)))
    caps_of = [[k for k, c in enumerate(rows["caps"]) if c["body"] == i] for i in range(len(slot))]
    recs = [_record(HEADER, dict(
        n_bodies=t["n_bodies"], n_slots=len(t["slots"]), info_contact=int(t["info_contact"]),
        n_act=t["n_act"], substeps=t["substeps"], **row_counts(t), n_caps=len(rows["caps"]),
        n_gather=len(gather), **scratch,
        h=t["h"], half_h=0.5 * t["h"], vel_damp=t["vel_damp"], ang_damp=t["ang_damp"],
        gravity=t["gravity"], baumgarte=t["baumgarte"], one_plus_e=1.0 + t["elasticity"],
        friction=t["friction"], servo_gain=t["servo_gain"]))]
    for s, i in enumerate(t["slots"]):
        cap_lo = caps_of[s][0] if caps_of[s] else 0
        recs.append(_record(BODY, dict(
            index=i, inv_mass=t["inv_mass"][i], inv_inertia=t["inv_inertia"][i],
            active_pos=t["active_pos"][i], active_rot=t["active_rot"][i],
            frozen=int(t["frozen"][i]), rot_free=int(np.any(t["active_rot"][i] > 0)),
            default_rot=t["default_rot"][i], force_lo=spans[s][0], force_hi=spans[s][1],
            contact_lo=spans[s][2], contact_hi=spans[s][3], cap_lo=cap_lo,
            cap_hi=cap_lo + len(caps_of[s]))))
    for j in rows["joints"]:
        lim = np.zeros((3, 2))
        lim[:j["dof"]] = j["lim"]
        recs.append(_record(JOINT, {**j, "lim": lim}))
    recs += [_record(THRUSTER, th) for th in rows["thrusters"]]
    recs += [_record(POINT_PLANE, r) for r in rows["pp"]]
    recs += [_record(SPHERE_SPHERE, r) for r in rows["ss"]]
    recs += [_record(CAPSULE_CAPSULE, r) for r in rows["cc"]]
    recs += [_record(CAPSULE_BOX, {**r, "cap": rows["caps"][r["cap"]]["rec"]})
             for r in rows["cb"]]
    recs += [_record(CAPSULE, c) for c in rows["caps"]]
    ints = np.array([slot.get(b, -1) for b in range(t["n_bodies"])] + gather, np.int32)
    return np.concatenate(recs + [ints.view(np.float32)])


def scratch_words(buf: np.ndarray) -> int:
    """The per-env scratch size of a packed buffer, from its Header (every
    field before scratch_words is one int)."""
    return int(buf[:words(HEADER)].view(np.int32)[[n for n, _, _ in HEADER].index("scratch_words")])


def shared_bytes(buf: np.ndarray) -> int:
    """Shared memory one block needs for a packed buffer: the tables, padded
    to 16 bytes, and the scratch of each of its ENVS_PER_BLOCK envs."""
    return 4 * (-(-buf.size // 4) * 4 + ENVS_PER_BLOCK * scratch_words(buf))
