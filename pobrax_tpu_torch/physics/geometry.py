"""Contact generation and one-shot impulse resolution; the port of
`pobrax_tpu/physics/geometry.py`.

Compile time (numpy, identical to the JAX module): `collide_include`
body-name pairs (an empty tuple means NO contacts) expand into typed,
fixed-size candidate rows — the broadphase is static.

Run time (torch, batch-first): each row kind yields (position, normal,
penetration) as (B, K, ...) tensors; one resolver applies Baumgarte-stabilised
inelastic impulses with a friction-clamped tangential drag and sums them per
body with `index_add`. The per-body velocity deltas are the
`Info.contact.vel/.ang` the observations read.

Row kinds: point-plane, sphere-sphere, capsule-capsule (segment-segment
closest points), capsule-box (both end spheres and the segment point nearest
the box centre, against the box SDF).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from pobrax_tpu_torch.ops import quaternion as quat
from pobrax_tpu_torch.ops.vector import cross, dot, safe_norm
from pobrax_tpu_torch.physics import config as pcfg
from pobrax_tpu_torch.physics.bodies import Bodies
from pobrax_tpu_torch.physics.joints import _euler_to_quat_np, scatter_bodies
from pobrax_tpu_torch.physics.state import P, QP


def _rotate_np(v: np.ndarray, q: np.ndarray) -> np.ndarray:
    s, u = q[0], q[1:]
    return 2 * np.dot(u, v) * u + (s * s - np.dot(u, u)) * v + 2 * s * np.cross(u, v)


def _capsule_ends(col: pcfg.Collider) -> Tuple[np.ndarray, np.ndarray]:
    """Local-frame segment endpoints of a capsule collider (on its body)."""
    g = col.geom
    hl = max(g.length / 2.0 - g.radius, 0.0)
    q = _euler_to_quat_np(col.rotation)
    axis = _rotate_np(np.array([0.0, 0.0, 1.0], np.float32), q)
    p = np.asarray(col.position, np.float32)
    return p - hl * axis, p + hl * axis


_SPECS = {
    "point_plane": [("a", np.int32), ("point", np.float32), ("radius", np.float32),
                    ("b", np.int32), ("plane_pos", np.float32), ("plane_quat", np.float32)],
    "sphere_sphere": [("a", np.int32), ("pa", np.float32), ("ra", np.float32),
                      ("b", np.int32), ("pb", np.float32), ("rb", np.float32)],
    "capsule_capsule": [("a", np.int32), ("e0a", np.float32), ("e1a", np.float32),
                        ("ra", np.float32), ("b", np.int32), ("e0b", np.float32),
                        ("e1b", np.float32), ("rb", np.float32)],
    "capsule_box": [("a", np.int32), ("e0", np.float32), ("e1", np.float32),
                    ("radius", np.float32), ("b", np.int32), ("box_pos", np.float32),
                    ("box_quat", np.float32), ("halfsize", np.float32)],
}


class Contacts:
    """All candidate contacts of a scene, compiled to typed numpy row tables
    (`point_plane`, `sphere_sphere`, `capsule_capsule`, `capsule_box`: dicts
    of column arrays, or None when a scene has no row of that kind)."""

    def __init__(self, cfg: pcfg.Config, bodies: Bodies, device: torch.device):
        self.friction = float(cfg.friction)
        self.elasticity = float(cfg.elasticity)
        self.baumgarte_erp = float(cfg.baumgarte_erp)
        self.h_sub = float(cfg.dt) / int(cfg.substeps)
        self._nbody = bodies.count

        pp: List[tuple] = []
        ss: List[tuple] = []
        cc: List[tuple] = []
        cb: List[tuple] = []
        for f, s in cfg.collide_include:
            ia, ib = bodies.index[f], bodies.index[s]
            for col_a in cfg.bodies[ia].colliders:
                for col_b in cfg.bodies[ib].colliders:
                    self._classify(ia, col_a, ib, col_b, pp, ss, cc, cb)

        def pack(rows, spec):
            if not rows:
                return None
            return {k: np.array([r[i] for r in rows], dt) for i, (k, dt) in enumerate(spec)}

        self.point_plane = pack(pp, _SPECS["point_plane"])
        self.sphere_sphere = pack(ss, _SPECS["sphere_sphere"])
        self.capsule_capsule = pack(cc, _SPECS["capsule_capsule"])
        self.capsule_box = pack(cb, _SPECS["capsule_box"])

        def dev(table):
            if table is None:
                return None
            return {k: torch.as_tensor(v, dtype=torch.long if v.dtype == np.int32 else torch.float32,
                                       device=device) for k, v in table.items()}

        self._pp, self._ss = dev(self.point_plane), dev(self.sphere_sphere)
        self._cc, self._cb = dev(self.capsule_capsule), dev(self.capsule_box)
        self._inv_mass = torch.as_tensor(bodies.inv_mass, device=device)
        self._inv_inertia = torch.as_tensor(bodies.inv_inertia, device=device)
        self._z_axis = torch.tensor([0.0, 0.0, 1.0], device=device)

    # ---- compile-time --------------------------------------------------------

    def _classify(self, ia, col_a, ib, col_b, pp, ss, cc, cb):
        ga, gb = col_a.geom, col_b.geom
        # canonicalize: plane always second; box after sphere/capsule
        if isinstance(ga, pcfg.Plane) and not isinstance(gb, pcfg.Plane):
            return self._classify(ib, col_b, ia, col_a, pp, ss, cc, cb)
        if isinstance(ga, pcfg.Plane) and isinstance(gb, pcfg.Plane):
            raise NotImplementedError("contact pair Plane vs Plane not supported")
        if isinstance(ga, pcfg.Box) and isinstance(gb, (pcfg.Sphere, pcfg.Capsule)):
            return self._classify(ib, col_b, ia, col_a, pp, ss, cc, cb)

        if isinstance(gb, pcfg.Plane):
            ppos = np.asarray(col_b.position, np.float32)
            pquat = _euler_to_quat_np(col_b.rotation)
            if isinstance(ga, pcfg.Sphere):
                pp.append((ia, np.asarray(col_a.position, np.float32), ga.radius, ib, ppos, pquat))
            elif isinstance(ga, pcfg.Capsule):
                e0, e1 = _capsule_ends(col_a)
                pp.append((ia, e0, ga.radius, ib, ppos, pquat))
                # degenerate capsules (length <= 2r, e.g. the ant torso) have
                # coincident end spheres; emitting both would double-count
                if not np.allclose(e0, e1):
                    pp.append((ia, e1, ga.radius, ib, ppos, pquat))
            elif isinstance(ga, pcfg.Box):
                h = np.asarray(ga.halfsize, np.float32)
                q = _euler_to_quat_np(col_a.rotation)
                for sx in (-1, 1):
                    for sy in (-1, 1):
                        for sz in (-1, 1):
                            corner = np.asarray(col_a.position, np.float32) + _rotate_np(
                                h * np.array([sx, sy, sz], np.float32), q)
                            pp.append((ia, corner, 0.0, ib, ppos, pquat))
            return
        if isinstance(ga, pcfg.Sphere) and isinstance(gb, pcfg.Sphere):
            ss.append((ia, np.asarray(col_a.position, np.float32), ga.radius,
                       ib, np.asarray(col_b.position, np.float32), gb.radius))
            return
        if isinstance(ga, pcfg.Capsule) and isinstance(gb, pcfg.Capsule):
            e0a, e1a = _capsule_ends(col_a)
            e0b, e1b = _capsule_ends(col_b)
            cc.append((ia, e0a, e1a, ga.radius, ib, e0b, e1b, gb.radius))
            return
        if isinstance(ga, pcfg.Capsule) and isinstance(gb, pcfg.Sphere):
            return self._classify(ib, col_b, ia, col_a, pp, ss, cc, cb)
        if isinstance(ga, pcfg.Sphere) and isinstance(gb, pcfg.Capsule):
            # sphere as zero-length capsule
            c = np.asarray(col_a.position, np.float32)
            e0b, e1b = _capsule_ends(col_b)
            cc.append((ia, c, c, ga.radius, ib, e0b, e1b, gb.radius))
            return
        if isinstance(ga, (pcfg.Sphere, pcfg.Capsule)) and isinstance(gb, pcfg.Box):
            if isinstance(ga, pcfg.Sphere):
                e0 = e1 = np.asarray(col_a.position, np.float32)
            else:
                e0, e1 = _capsule_ends(col_a)
            cb.append((ia, e0, e1, ga.radius, ib,
                       np.asarray(col_b.position, np.float32),
                       _euler_to_quat_np(col_b.rotation),
                       np.asarray(gb.halfsize, np.float32)))
            return
        raise NotImplementedError(
            f"contact pair {type(ga).__name__} vs {type(gb).__name__} not supported yet")

    # ---- runtime -------------------------------------------------------------

    def apply(self, qp: QP) -> P:
        """Narrow phase + impulse resolution; per-body velocity deltas (B, n, 3)."""
        dp = P.zero(qp.pos.shape[0], self._nbody, qp.pos.device)
        for compute in (self._point_plane, self._sphere_sphere, self._capsule_capsule,
                        self._capsule_box):
            out = compute(qp)
            if out is not None:
                dp = dp + self._resolve(qp, *out)
        return dp

    @staticmethod
    def _world_point(qp: QP, body: torch.Tensor, local: torch.Tensor) -> torch.Tensor:
        return qp.pos[:, body] + quat.rotate(local, qp.rot[:, body])

    def _point_plane(self, qp: QP):
        c = self._pp
        if c is None:
            return None
        a, b = c["a"], c["b"]
        p_world = self._world_point(qp, a, c["point"])  # (B, K, 3)
        plane_rot = quat.quat_mul(qp.rot[:, b], c["plane_quat"])
        normal = quat.rotate(self._z_axis.expand_as(p_world), plane_rot)
        plane_pt = self._world_point(qp, b, c["plane_pos"])
        pen = c["radius"] - dot(p_world - plane_pt, normal)
        pos = p_world - normal * c["radius"][:, None]
        return a, b, pos, normal, pen

    def _sphere_sphere(self, qp: QP):
        c = self._ss
        if c is None:
            return None
        a, b = c["a"], c["b"]
        ca = self._world_point(qp, a, c["pa"])
        cb_ = self._world_point(qp, b, c["pb"])
        d = ca - cb_
        dist = safe_norm(d)
        normal = d / torch.clamp(dist, min=1e-8)[..., None]
        pen = c["ra"] + c["rb"] - dist
        pos = cb_ + normal * (c["rb"] - 0.5 * torch.clamp(pen, min=0.0))[..., None]
        return a, b, pos, normal, pen

    def _capsule_capsule(self, qp: QP):
        c = self._cc
        if c is None:
            return None
        a, b = c["a"], c["b"]
        p1 = self._world_point(qp, a, c["e0a"])
        q1 = self._world_point(qp, a, c["e1a"])
        p2 = self._world_point(qp, b, c["e0b"])
        q2 = self._world_point(qp, b, c["e1b"])
        pa, pb = _segment_closest_points(p1, q1, p2, q2)
        d = pa - pb
        dist = safe_norm(d)
        normal = d / torch.clamp(dist, min=1e-8)[..., None]
        pen = c["ra"] + c["rb"] - dist
        pos = pb + normal * (c["rb"] - 0.5 * torch.clamp(pen, min=0.0))[..., None]
        return a, b, pos, normal, pen

    def _capsule_box(self, qp: QP):
        c = self._cb
        if c is None:
            return None
        a, b = c["a"], c["b"]
        box_rot = quat.quat_mul(qp.rot[:, b], c["box_quat"])  # (B, K, 4)
        box_pos = self._world_point(qp, b, c["box_pos"])
        e0 = self._world_point(qp, a, c["e0"])
        e1 = self._world_point(qp, a, c["e1"])
        # segment endpoints in the box frame
        inv = quat.quat_inv(box_rot)
        s0 = quat.rotate(e0 - box_pos, inv)
        s1 = quat.rotate(e1 - box_pos, inv)
        # sample: both ends + the segment point closest to the box centre
        d = s1 - s0
        denom = torch.clamp(dot(d, d), min=1e-8)
        t = torch.clamp(-dot(s0, d) / denom, 0.0, 1.0)
        smid = s0 + t[..., None] * d
        outs = []
        for s in (s0, s1, smid):
            n_local, pen, p_local = _point_box_sdf(s, c["halfsize"], c["radius"])
            normal = quat.rotate(n_local, box_rot)
            pos = box_pos + quat.rotate(p_local, box_rot)
            outs.append((pos, normal, pen))
        return (torch.cat([a, a, a]), torch.cat([b, b, b]),
                torch.cat([o[0] for o in outs], 1), torch.cat([o[1] for o in outs], 1),
                torch.cat([o[2] for o in outs], 1))

    def _resolve(self, qp: QP, a, b, pos, normal, pen) -> P:
        """Baumgarte-stabilised one-shot impulses with friction drag, summed per body."""
        inv_mass, inv_inertia = self._inv_mass, self._inv_inertia
        r_a = pos - qp.pos[:, a]
        r_b = pos - qp.pos[:, b]
        v_a = qp.vel[:, a] + cross(qp.ang[:, a], r_a)
        v_b = qp.vel[:, b] + cross(qp.ang[:, b], r_b)
        v_rel = v_a - v_b
        vn = dot(v_rel, normal)

        ang_a = dot(normal, cross(inv_inertia[a] * cross(r_a, normal), r_a))
        ang_b = dot(normal, cross(inv_inertia[b] * cross(r_b, normal), r_b))
        denom = inv_mass[a] + inv_mass[b] + ang_a + ang_b

        baumgarte = (self.baumgarte_erp / self.h_sub) * torch.clamp(pen, min=0.0)
        imp = (-(1.0 + self.elasticity) * vn + baumgarte) / torch.clamp(denom, min=1e-8)
        live = (pen > 0.0) & (imp > 0.0)
        imp = torch.where(live, imp, 0.0)

        # friction: clamp the tangential drag impulse by mu * normal impulse
        v_t = v_rel - vn[..., None] * normal
        vt_norm = safe_norm(v_t)
        imp_d = torch.minimum(vt_norm / torch.clamp(denom, min=1e-8), self.friction * imp)
        dir_t = v_t / torch.clamp(vt_norm, min=1e-8)[..., None]
        imp_d = torch.where(live & (vt_norm > 1e-8), imp_d, 0.0)

        j_total = imp[..., None] * normal - imp_d[..., None] * dir_t  # on a; -j on b
        dvel = scatter_bodies(self._nbody, a, j_total * inv_mass[a, None],
                              b, -j_total * inv_mass[b, None])
        dang = scatter_bodies(self._nbody, a, inv_inertia[a] * cross(r_a, j_total),
                              b, inv_inertia[b] * cross(r_b, -j_total))
        return P(vel=dvel, ang=dang)


def _segment_closest_points(p1, q1, p2, q2):
    """Closest points between segments [p1,q1] and [p2,q2]; batched (..., 3)."""
    d1 = q1 - p1
    d2 = q2 - p2
    r = p1 - p2
    a = dot(d1, d1)
    e = dot(d2, d2)
    f = dot(d2, r)
    c = dot(d1, r)
    b = dot(d1, d2)
    denom = a * e - b * b
    s = torch.where(denom > 1e-8,
                    torch.clamp((b * f - c * e) / torch.clamp(denom, min=1e-8), 0.0, 1.0), 0.0)
    t = torch.where(e > 1e-8, torch.clamp((b * s + f) / torch.clamp(e, min=1e-8), 0.0, 1.0), 0.0)
    s = torch.where(a > 1e-8, torch.clamp((b * t - c) / torch.clamp(a, min=1e-8), 0.0, 1.0), 0.0)
    return p1 + d1 * s[..., None], p2 + d2 * t[..., None]


def _point_box_sdf(p, h, radius):
    """Sphere (centre p, radius) vs an origin-centred box of halfsize h, in the
    box frame. Returns (normal out of the box toward the sphere, penetration,
    contact point on/in the box surface).

    Inside the box the sphere is pushed out through the nearest face; ties
    take the FIRST minimum, as `jnp.argmin` does."""
    q = torch.minimum(torch.maximum(p, -h), h)
    delta = p - q
    dist = safe_norm(delta)
    outside = dist > 1e-8
    n_out = delta / torch.clamp(dist, min=1e-8)[..., None]
    pen_out = radius - dist

    face_dist = h - torch.abs(p)  # distance to each face
    k = torch.argmin(face_dist, dim=-1)  # first minimum on ties
    onehot = torch.nn.functional.one_hot(k, 3).to(p.dtype)
    sign = torch.sign((p * onehot).sum(-1))
    sign = torch.where(sign == 0.0, torch.ones_like(sign), sign)
    n_in = sign[..., None] * onehot
    pen_in = radius + face_dist.min(-1).values
    h_k = (h.expand_as(p) * onehot).sum(-1)
    q_in = p * (1.0 - onehot) + (sign * h_k)[..., None] * onehot

    normal = torch.where(outside[..., None], n_out, n_in)
    pen = torch.where(outside, pen_out, pen_in)
    pos = torch.where(outside[..., None], q, q_in)
    return normal, pen, pos
