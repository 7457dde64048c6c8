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
structs of `csrc/whole_step.cuh` (Header, then Body x n, Joint x nj,
Thruster x nt, PointPlane x npp, SphereSphere x nss, CapsuleCapsule x ncc,
CapsuleBox x ncb, PassThrough x (n_bodies - n_slots)). The kernel loops
over these rows at run time, so one build of the kernel serves every System.

Slots: only the bodies the step touches — those that move on some axis, and
those a joint, thruster or contact row names — enter the kernel's per-thread
arrays, in body order. Body records are written per slot, with the body's
index in the state arrays; every joint, thruster and row index is a slot.
Every other body (AntGather's 16 apples and bombs) passes through: the
kernel copies its state from input to output with zero Info, which is exact,
since the step gives such a body no force, no impulse and no motion.

Coverage: the whole engine — 1-, 2- and 3-dof joints with torque or
angle-servo actuators, thrusters, per-axis frozen masks, and point-plane,
sphere-sphere, capsule-capsule and capsule-box rows whether or not their
second body is frozen — with full Info or contact Info only. A point-plane or
capsule-box row against a frozen body folds that body's frame into the row;
one against a moving body carries the frame in the body's own coordinates
and is turned into the world each substep. The one limit is `MAX_BODIES`
touched bodies (the kernel's per-thread arrays): `build` raises ValueError
for more.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from pobrax_tpu_torch.physics.joints import ANGLE_SERVO_GAIN

# must equal ws::kMaxBodies in csrc/whole_step.cuh (the per-thread arrays);
# it bounds the touched bodies, not all bodies
MAX_BODIES = 16
INFO_MODES = ("full", "contact")

# C struct layouts of csrc/whole_step.cuh, field by field: (name, kind, count)
# with kind "i" (int32) or "f" (float32). whole_step.py checks the word counts
# against the compiled library's.
HEADER = [("n_bodies", "i", 1), ("n_slots", "i", 1), ("info_contact", "i", 1),
          ("n_act", "i", 1), ("substeps", "i", 1),
          ("n_joints", "i", 1), ("n_thr", "i", 1), ("n_pp", "i", 1), ("n_ss", "i", 1),
          ("n_cc", "i", 1), ("n_cb", "i", 1),
          ("h", "f", 1), ("half_h", "f", 1), ("vel_damp", "f", 1), ("ang_damp", "f", 1),
          ("gravity", "f", 3), ("baumgarte", "f", 1), ("one_plus_e", "f", 1),
          ("friction", "f", 1), ("servo_gain", "f", 1)]
BODY = [("index", "i", 1), ("inv_mass", "f", 1), ("inv_inertia", "f", 3),
        ("active_pos", "f", 3), ("active_rot", "f", 3), ("frozen", "i", 1), ("rot_free", "i", 1),
        ("default_rot", "f", 4)]
JOINT = [("parent", "i", 1), ("child", "i", 1), ("dof", "i", 1), ("act_idx", "i", 1),
         ("act_kind", "i", 1), ("off_p", "f", 3), ("off_c", "f", 3), ("q_j", "f", 4),
         ("lim", "f", 6), ("k", "f", 1), ("kd", "f", 1), ("klim", "f", 1),
         ("kang", "f", 1), ("act_k", "f", 1)]
THRUSTER = [("body", "i", 1), ("act", "i", 1), ("dir", "f", 3), ("strength", "f", 1),
            ("inv_mass", "f", 1)]
POINT_PLANE = [("a", "i", 1), ("b", "i", 1), ("b_moves", "i", 1), ("point", "f", 3),
               ("radius", "f", 1), ("normal", "f", 3), ("off_w", "f", 3), ("invm_a", "f", 1),
               ("inertia_a", "f", 3)]
SPHERE_SPHERE = [("a", "i", 1), ("b", "i", 1), ("pa", "f", 3), ("ra", "f", 1),
                 ("pb", "f", 3), ("rb", "f", 1)]
CAPSULE_CAPSULE = [("a", "i", 1), ("b", "i", 1), ("e0a", "f", 3), ("e1a", "f", 3),
                   ("ra", "f", 1), ("e0b", "f", 3), ("e1b", "f", 3), ("rb", "f", 1)]
CAPSULE_BOX = [("a", "i", 1), ("b", "i", 1), ("cap", "i", 1), ("b_moves", "i", 1),
               ("e0", "f", 3), ("e1", "f", 3), ("radius", "f", 1), ("rot", "f", 9),
               ("box_q", "f", 4), ("box_off_w", "f", 3), ("halfsize", "f", 3),
               ("invm_a", "f", 1), ("inertia_a", "f", 3)]
PASS_THROUGH = [("body", "i", 1)]
STRUCTS = (HEADER, BODY, JOINT, THRUSTER, POINT_PLANE, SPHERE_SPHERE, CAPSULE_CAPSULE,
           CAPSULE_BOX, PASS_THROUGH)


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
                         f"MAX_BODIES={MAX_BODIES} (the per-thread arrays of "
                         f"csrc/whole_step.cuh)")
    return t


def _record(struct, values: Dict) -> np.ndarray:
    out = np.zeros(words(struct), np.float32)
    ints = out.view(np.int32)
    off = 0
    for name, kind, count in struct:
        v = np.asarray(values[name], np.float64).reshape(count)
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


def pack(t: Dict) -> np.ndarray:
    """The tables of `build` as the kernel's flat buffer of 32-bit words, body
    indices turned into slots. Point-plane and capsule-box rows against a
    moving body come first, as fused.py's scalar rows run before its
    vectorised ones; within each table the rows keep fused.py's order, since
    the impulse sums are taken in it."""
    slot = {b: i for i, b in enumerate(t["slots"])}
    recs = [_record(HEADER, dict(
        n_bodies=t["n_bodies"], n_slots=len(t["slots"]), info_contact=int(t["info_contact"]),
        n_act=t["n_act"], substeps=t["substeps"], **row_counts(t),
        h=t["h"], half_h=0.5 * t["h"], vel_damp=t["vel_damp"], ang_damp=t["ang_damp"],
        gravity=t["gravity"], baumgarte=t["baumgarte"], one_plus_e=1.0 + t["elasticity"],
        friction=t["friction"], servo_gain=t["servo_gain"]))]
    for i in t["slots"]:
        recs.append(_record(BODY, dict(
            index=i, inv_mass=t["inv_mass"][i], inv_inertia=t["inv_inertia"][i],
            active_pos=t["active_pos"][i], active_rot=t["active_rot"][i],
            frozen=int(t["frozen"][i]), rot_free=int(np.any(t["active_rot"][i] > 0)),
            default_rot=t["default_rot"][i])))
    for j in t["joints"]:
        lim = np.zeros((3, 2))
        lim[:j["dof"]] = j["lim"]
        recs.append(_record(JOINT, dict(
            parent=slot[j["parent"]], child=slot[j["child"]], dof=j["dof"],
            act_idx=j["act_idx"], act_kind=j["act_kind"], off_p=j["off_p"], off_c=j["off_c"],
            q_j=j["q_j"], lim=lim, k=j["k"], kd=j["kd"], klim=j["klim"], kang=j["kang"],
            act_k=j["act_k"])))
    recs += [_record(THRUSTER, {**th, "body": slot[th["body"]]}) for th in t["thrusters"]]
    for r in t["pp_moving"]:
        recs.append(_record(POINT_PLANE, dict(
            a=slot[r["a"]], b=slot[r["b"]], b_moves=1, point=r["point"], radius=r["radius"],
            normal=_qrot_f((0.0, 0.0, 1.0), tuple(r["plane_quat"])), off_w=r["plane_pos"],
            invm_a=t["inv_mass"][r["a"]], inertia_a=t["inv_inertia"][r["a"]])))
    pv = t["pp_vec"]
    for k, (a, point) in enumerate(pv["points"] if pv else []):
        recs.append(_record(POINT_PLANE, dict(
            a=slot[a], b=slot[pv["uniq_b"][int(np.argmax(pv["b_mask"][:, k]))]], b_moves=0,
            point=point, radius=pv["radius"][k],
            normal=[pv["normal_cols"][c][k] for c in range(3)],
            off_w=pv["off_w"][k], invm_a=pv["invm_a"][k], inertia_a=pv["inertia_a"][k])))
    recs += [_record(SPHERE_SPHERE, {**r, "a": slot[r["a"]], "b": slot[r["b"]]})
             for r in t["ss_rows"]]
    recs += [_record(CAPSULE_CAPSULE, {**r, "a": slot[r["a"]], "b": slot[r["b"]]})
             for r in t["cc_rows"]]
    cv = t["cb_vec"]
    n_caps = len(cv["caps"]) if cv else 0
    for k, r in enumerate(t["cb_moving"]):  # capsule ids after the frozen rows' own
        recs.append(_record(CAPSULE_BOX, dict(
            a=slot[r["a"]], b=slot[r["b"]], cap=n_caps + k, b_moves=1, e0=r["e0"], e1=r["e1"],
            radius=r["radius"], rot=np.zeros(9), box_q=r["box_quat"], box_off_w=r["box_pos"],
            halfsize=r["halfsize"], invm_a=t["inv_mass"][r["a"]],
            inertia_a=t["inv_inertia"][r["a"]])))
    if cv:
        row_cap = np.repeat(np.arange(len(cv["caps"])), cv["cap_repeats"])
        for k in range(len(row_cap)):
            a, e0, e1 = cv["caps"][row_cap[k]]
            recs.append(_record(CAPSULE_BOX, dict(
                a=slot[a], b=slot[cv["uniq_b"][int(np.argmax(cv["b_mask"][:, k, 0]))]],
                cap=row_cap[k], b_moves=0, e0=e0, e1=e1, radius=cv["radius"][k],
                rot=[cv["rot_cols"][i][j][k] for i in range(3) for j in range(3)],
                box_q=np.zeros(4), box_off_w=cv["box_off_w"][k], halfsize=cv["halfsize"][k],
                invm_a=cv["invm_a"][k], inertia_a=cv["inertia_a"][k])))
    recs += [_record(PASS_THROUGH, dict(body=i)) for i in t["pass_through"]]
    return np.concatenate(recs)
