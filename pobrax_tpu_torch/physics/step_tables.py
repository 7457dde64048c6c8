"""The whole-step kernel's constant tables, built on the host from a `System`.

The host half of `pobrax_tpu/physics/fused.py`: the joint table
(fused.py:365-382), the contact row lists (:385-398), frozen bodies and their
static rotations (:405-411), the vectorised capsule-box and point-plane
phases (`compile_cb_vec`, `compile_pp_vec`: fused.py:138-208, :297-340) and
the integrator and contact constants (:352-363). `compile_cb_vec`,
`compile_pp_vec` and `joint_table` return what their fused.py twins return;
tests/test_torch_scene.py holds them equal.

`pack` lays the tables out as one flat buffer of 32-bit words in the C
structs of `csrc/whole_step.cuh` (Header, then Body x n, Joint x nj,
PointPlane x npp, CapsuleBox x ncb). The kernel loops over these rows at run
time, so one build of the kernel serves every System it covers.

Coverage (stages (a) and (b) of the port): 1-dof hinge joints with torque
actuators, point-plane rows against frozen planes, capsule-box rows against
frozen boxes, per-axis frozen masks. Anything else — 2- and 3-dof joints,
angle servos, thrusters, sphere-sphere or capsule-capsule rows, rows against
a moving plane or box, more than `MAX_BODIES` bodies — raises ValueError;
those are stage (c).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

# must equal ws::kMaxBodies in csrc/whole_step.cuh (the per-thread arrays)
MAX_BODIES = 16

# C struct layouts of csrc/whole_step.cuh, field by field: (name, kind, count)
# with kind "i" (int32) or "f" (float32). whole_step.py checks the word counts
# against the compiled library's.
HEADER = [("n_bodies", "i", 1), ("n_act", "i", 1), ("substeps", "i", 1),
          ("n_joints", "i", 1), ("n_pp", "i", 1), ("n_cb", "i", 1),
          ("h", "f", 1), ("half_h", "f", 1), ("vel_damp", "f", 1), ("ang_damp", "f", 1),
          ("gravity", "f", 3), ("baumgarte", "f", 1), ("one_plus_e", "f", 1),
          ("friction", "f", 1)]
BODY = [("inv_mass", "f", 1), ("inv_inertia", "f", 3), ("active_pos", "f", 3),
        ("active_rot", "f", 3), ("frozen", "i", 1), ("rot_free", "i", 1),
        ("default_rot", "f", 4)]
JOINT = [("parent", "i", 1), ("child", "i", 1), ("act_idx", "i", 1),
         ("off_p", "f", 3), ("off_c", "f", 3), ("q_j", "f", 4), ("lim_lo", "f", 1),
         ("lim_hi", "f", 1), ("k", "f", 1), ("kd", "f", 1), ("klim", "f", 1),
         ("kang", "f", 1), ("act_k", "f", 1)]
POINT_PLANE = [("a", "i", 1), ("b", "i", 1), ("point", "f", 3), ("radius", "f", 1),
               ("normal", "f", 3), ("off_w", "f", 3), ("invm_a", "f", 1),
               ("inertia_a", "f", 3)]
CAPSULE_BOX = [("a", "i", 1), ("b", "i", 1), ("cap", "i", 1), ("e0", "f", 3),
               ("e1", "f", 3), ("radius", "f", 1), ("rot", "f", 9), ("box_off_w", "f", 3),
               ("halfsize", "f", 3), ("invm_a", "f", 1), ("inertia_a", "f", 3)]
STRUCTS = (HEADER, BODY, JOINT, POINT_PLANE, CAPSULE_BOX)


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


def build(sys) -> Dict:
    """Every constant the kernel reads, as host values; raises ValueError on
    a feature the kernel does not cover."""
    body, ct = sys.body, sys.contacts
    n = sys.num_bodies
    if n > MAX_BODIES:
        raise ValueError(f"whole-step kernel: {n} bodies exceed MAX_BODIES={MAX_BODIES}")
    joints = joint_table(sys)
    if any(j["dof"] != 1 for j in joints):
        raise ValueError("whole-step kernel: 2- and 3-dof joints are not covered yet "
                         "(ROADMAP kernel stage (c))")
    if any(j["act_idx"] >= 0 and j["act_kind"] != 0 for j in joints):
        raise ValueError("whole-step kernel: angle-servo actuators are not covered yet "
                         "(ROADMAP kernel stage (c))")
    if len(sys.config.thrusters):
        raise ValueError("whole-step kernel: thrusters are not covered yet "
                         "(ROADMAP kernel stage (c))")
    if ct.sphere_sphere is not None or ct.capsule_capsule is not None:
        raise ValueError("whole-step kernel: sphere-sphere and capsule-capsule rows are not "
                         "covered yet (ROADMAP kernel stage (c))")
    frozen = [bool(f) for f in body.frozen]
    pp_rows = contact_rows(ct.point_plane, PP_FIELDS)
    cb_rows = contact_rows(ct.capsule_box, CB_FIELDS)
    if any(not frozen[r["b"]] for r in pp_rows):
        raise ValueError("whole-step kernel: point-plane rows need a frozen plane body")
    if any(not frozen[r["b"]] for r in cb_rows):
        raise ValueError("whole-step kernel: capsule-box rows need a frozen box body "
                         "(ROADMAP kernel stage (c))")

    default_rot = [tuple(float(v) for v in sys._default_pose[1][i]) for i in range(n)]
    inv_mass = [float(m) for m in body.inv_mass]
    inv_inertia = [tuple(float(v) for v in row) for row in body.inv_inertia]
    integ = sys.integrator
    return dict(
        n_bodies=n, n_act=sys.action_size, substeps=integ.substeps,
        h=integ.h, vel_damp=integ.vel_damp, ang_damp=integ.ang_damp,
        gravity=tuple(float(g) for g in integ.gravity),
        baumgarte=ct.baumgarte_erp / ct.h_sub, elasticity=ct.elasticity,
        friction=ct.friction,
        frozen=frozen, default_rot=default_rot, inv_mass=inv_mass, inv_inertia=inv_inertia,
        active_pos=body.active_pos, active_rot=body.active_rot,
        joints=joints,
        pp_vec=compile_pp_vec(pp_rows, default_rot, inv_mass, inv_inertia) if pp_rows else None,
        cb_vec=compile_cb_vec(cb_rows, default_rot, inv_mass, inv_inertia) if cb_rows else None,
    )


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


def pack(t: Dict) -> np.ndarray:
    """The tables of `build` as the kernel's flat buffer of 32-bit words."""
    n = t["n_bodies"]
    recs = [_record(HEADER, dict(
        n_bodies=n, n_act=t["n_act"], substeps=t["substeps"], n_joints=len(t["joints"]),
        n_pp=len(t["pp_vec"]["points"]) if t["pp_vec"] else 0,
        n_cb=int(t["cb_vec"]["cap_repeats"].sum()) if t["cb_vec"] else 0,
        h=t["h"], half_h=0.5 * t["h"], vel_damp=t["vel_damp"], ang_damp=t["ang_damp"],
        gravity=t["gravity"], baumgarte=t["baumgarte"], one_plus_e=1.0 + t["elasticity"],
        friction=t["friction"]))]
    for i in range(n):
        recs.append(_record(BODY, dict(
            inv_mass=t["inv_mass"][i], inv_inertia=t["inv_inertia"][i],
            active_pos=t["active_pos"][i], active_rot=t["active_rot"][i],
            frozen=int(t["frozen"][i]), rot_free=int(np.any(t["active_rot"][i] > 0)),
            default_rot=t["default_rot"][i])))
    for j in t["joints"]:
        recs.append(_record(JOINT, dict(
            parent=j["parent"], child=j["child"], act_idx=j["act_idx"], off_p=j["off_p"],
            off_c=j["off_c"], q_j=j["q_j"], lim_lo=j["lim"][0][0], lim_hi=j["lim"][0][1],
            k=j["k"], kd=j["kd"], klim=j["klim"], kang=j["kang"], act_k=j["act_k"])))
    pv = t["pp_vec"]
    for k, (a, point) in enumerate(pv["points"] if pv else []):
        recs.append(_record(POINT_PLANE, dict(
            a=a, b=pv["uniq_b"][int(np.argmax(pv["b_mask"][:, k]))], point=point,
            radius=pv["radius"][k], normal=[pv["normal_cols"][c][k] for c in range(3)],
            off_w=pv["off_w"][k], invm_a=pv["invm_a"][k], inertia_a=pv["inertia_a"][k])))
    cv = t["cb_vec"]
    if cv:
        row_cap = np.repeat(np.arange(len(cv["caps"])), cv["cap_repeats"])
        for k in range(len(row_cap)):
            a, e0, e1 = cv["caps"][row_cap[k]]
            recs.append(_record(CAPSULE_BOX, dict(
                a=a, b=cv["uniq_b"][int(np.argmax(cv["b_mask"][:, k, 0]))], cap=row_cap[k],
                e0=e0, e1=e1, radius=cv["radius"][k],
                rot=[cv["rot_cols"][i][j][k] for i in range(3) for j in range(3)],
                box_off_w=cv["box_off_w"][k], halfsize=cv["halfsize"][k],
                invm_a=cv["invm_a"][k], inertia_a=cv["inertia_a"][k])))
    return np.concatenate(recs)
