// whole_step.cuh — one full physics control step for one environment.
//
// Replaces the TPU's Pallas whole-step kernel,
// pobrax_tpu/physics/pallas_step.py::make_pallas_batched_step (the
// pl.pallas_call at pallas_step.py:119), which evaluates
// pobrax_tpu/physics/fused.py's scalar-unrolled step_core for a block of
// environments. Each of `substeps` substeps runs, in fused.py's order:
//   joints (spring, alignment, limit, damping; fused.py:859-909)
//   -> torque actuators (:911-922)
//   -> damped semi-implicit Euler with per-axis masks and quaternion
//      renormalisation (:928-949)
//   -> contact impulses on the updated pose: the point-plane phase, then the
//      capsule-box phase against frozen boxes (:526-602, :689-842)
//   -> the contact / joint / actuator Info sums (:960-980).
//
// What bounds it on an H100: operations, not bytes. Per env and substep the
// step does roughly 30k fp32 operations for AntTag (12 bodies, 8 hinges,
// 9 point-plane rows, 36 capsule-box rows; physics/whole_step.py::cost counts
// them from this source), about 1.2e9 per control step at B = 4096, against
// about 9 MB of state and Info read and written once. At 67 TFLOP/s fp32 and
// 3.35 TB/s that is ~18 us of arithmetic against ~3 us of memory traffic. The
// real limit is latency: one thread per env gives only 4096 threads
// (128 warps, under one per SM), each running a long dependent chain.
//
// What this design does about it (the simple, right first version):
//   * one thread per env, the substep loop at run time, blocks of 32 threads
//     so the 128 warps spread over all SMs rather than piling onto a few;
//   * the System enters as data — joint, point-plane and capsule-box rows are
//     loops over constant tables (physics/step_tables.py), so compile time
//     does not grow with the number of wall rows and one build serves every
//     System the kernel covers;
//   * frozen bodies are folded statically: their rotation comes from the
//     table, their velocities are zero, and the plane and box frames are
//     precomputed per row;
//   * state, Info and force sums live in per-thread arrays; with body indices
//     read from the tables they are dynamically indexed and spill to local
//     memory (cached in L1), which is accepted for now.
// A later change makes it fast: a warp per env over the 45 contact rows, and
// CUDA graphs over the rollout.
//
// The same source builds for the host with g++ (no CUDA), which is how the
// test suite checks this arithmetic against the plain PyTorch step without a
// GPU (tests/test_torch_kernel_host.py).
#pragma once

#include <math.h>

#if defined(__CUDACC__)
#define WS_FN __host__ __device__ inline
#else
#define WS_FN inline
#endif

namespace ws {

constexpr int kMaxBodies = 16;  // physics/step_tables.py::MAX_BODIES

// ---- constant tables: 32-bit words, laid out by physics/step_tables.py ----

struct Header {
  int n_bodies, n_act, substeps, n_joints, n_pp, n_cb;
  float h, half_h, vel_damp, ang_damp, gravity[3], baumgarte, one_plus_e, friction;
};

struct Body {
  float inv_mass, inv_inertia[3], active_pos[3], active_rot[3];
  int frozen, rot_free;
  float default_rot[4];
};

struct Joint {  // a 1-dof hinge with an optional torque actuator
  int parent, child, act_idx;
  float off_p[3], off_c[3], q_j[4], lim_lo, lim_hi, k, kd, klim, kang, act_k;
};

struct PointPlane {  // a point on body a against frozen plane body b
  int a, b;
  float point[3], radius, normal[3], off_w[3], invm_a, inertia_a[3];
};

struct CapsuleBox {  // one capsule of body a against one frozen box of body b
  int a, b, cap;
  float e0[3], e1[3], radius, rot[9], box_off_w[3], halfsize[3], invm_a, inertia_a[3];
};

// the size of each struct in 32-bit words, for the loader's layout check
WS_FN int layout_words(int* out) {
  out[0] = sizeof(Header) / 4;
  out[1] = sizeof(Body) / 4;
  out[2] = sizeof(Joint) / 4;
  out[3] = sizeof(PointPlane) / 4;
  out[4] = sizeof(CapsuleBox) / 4;
  return 5;
}

// ---- small vector algebra, written as fused.py writes it ------------------

struct V3 { float x, y, z; };
struct Q4 { float w, x, y, z; };

WS_FN V3 v3(const float* p) { return {p[0], p[1], p[2]}; }
WS_FN Q4 q4(const float* p) { return {p[0], p[1], p[2], p[3]}; }
WS_FN V3 add(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
WS_FN V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
WS_FN V3 scale(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
WS_FN V3 mul(const float* d, V3 a) { return {d[0] * a.x, d[1] * a.y, d[2] * a.z}; }
WS_FN float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
WS_FN V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
WS_FN float& at(V3& v, int k) { return k == 0 ? v.x : (k == 1 ? v.y : v.z); }
WS_FN float clampf(float x, float lo, float hi) { return fminf(fmaxf(x, lo), hi); }

WS_FN Q4 qmul(Q4 a, Q4 b) {
  return {a.w * b.w - a.x * b.x - a.y * b.y - a.z * b.z,
          a.w * b.x + a.x * b.w + a.y * b.z - a.z * b.y,
          a.w * b.y - a.x * b.z + a.y * b.w + a.z * b.x,
          a.w * b.z + a.x * b.y - a.y * b.x + a.z * b.w};
}
WS_FN Q4 qinv(Q4 q) { return {q.w, -q.x, -q.y, -q.z}; }

// rotate v by q: v + w t + q.xyz x t with t = 2 q.xyz x v (fused.py::_qrot)
WS_FN V3 qrot(V3 v, Q4 q) {
  float tx = 2.0f * (q.y * v.z - q.z * v.y);
  float ty = 2.0f * (q.z * v.x - q.x * v.z);
  float tz = 2.0f * (q.x * v.y - q.y * v.x);
  return {v.x + q.w * tx + (q.y * tz - q.z * ty),
          v.y + q.w * ty + (q.z * tx - q.x * tz),
          v.z + q.w * tz + (q.x * ty - q.y * tx)};
}

// R^T v and R v for a row-major 3x3 R (box local <-> world)
WS_FN V3 to_local(const float* R, V3 v) {
  return {R[0] * v.x + R[3] * v.y + R[6] * v.z,
          R[1] * v.x + R[4] * v.y + R[7] * v.z,
          R[2] * v.x + R[5] * v.y + R[8] * v.z};
}
WS_FN V3 to_world(const float* R, V3 v) {
  return {R[0] * v.x + R[1] * v.y + R[2] * v.z,
          R[3] * v.x + R[4] * v.y + R[5] * v.z,
          R[6] * v.x + R[7] * v.y + R[8] * v.z};
}

WS_FN float rsqrt_(float x) {
#if defined(__CUDA_ARCH__)
  return rsqrtf(x);
#else
  return 1.0f / sqrtf(x);
#endif
}

// One-shot impulse of a contact whose other body is frozen (only `a`
// moves): Baumgarte, restitution, friction clamped by mu * normal impulse.
// Returns the impulse j on body a and its torque arm r_a x j.
WS_FN void resolve_a(const Header& H, V3 cpos, V3 pa, V3 va, V3 aa, V3 n, float pen,
                     float invm, const float* inertia, V3* j_out, V3* tq_out) {
  V3 r_a = sub(cpos, pa);
  V3 v_a = add(va, cross(aa, r_a));
  float vn = dot(v_a, n);
  V3 iacra = mul(inertia, cross(r_a, n));
  float ang_term = dot(n, cross(iacra, r_a));
  float denom = fmaxf(invm + ang_term, 1e-8f);
  float imp = (-H.one_plus_e * vn + H.baumgarte * fmaxf(pen, 0.0f)) / denom;
  bool live = (pen > 0.0f) && (imp > 0.0f);
  imp = live ? imp : 0.0f;
  V3 v_t = sub(v_a, scale(n, vn));
  float vt_n = sqrtf(fmaxf(dot(v_t, v_t), 1e-24f));
  float imp_d = fminf(vt_n / denom, H.friction * imp);
  imp_d = (live && vt_n > 1e-8f) ? imp_d : 0.0f;
  float scale_t = imp_d / fmaxf(vt_n, 1e-8f);
  V3 j = sub(scale(n, imp), scale(v_t, scale_t));
  *j_out = j;
  *tq_out = cross(r_a, j);
}

// Per-env state, Info sums and per-substep force sums.
struct EnvState {
  V3 pos[kMaxBodies], vel[kMaxBodies], ang[kMaxBodies];
  Q4 rot[kMaxBodies];
  // Info: contact, joint, actuator (vel, ang) each
  V3 info[6][kMaxBodies];
};

WS_FN Q4 rot_of(const Body* bodies, const EnvState& s, int i) {
  return bodies[i].frozen ? q4(bodies[i].default_rot) : s.rot[i];
}
WS_FN V3 vel_of(const Body* bodies, const EnvState& s, int i) {
  return bodies[i].frozen ? V3{0.0f, 0.0f, 0.0f} : s.vel[i];
}
WS_FN V3 ang_of(const Body* bodies, const EnvState& s, int i) {
  return bodies[i].frozen ? V3{0.0f, 0.0f, 0.0f} : s.ang[i];
}

WS_FN void add_to(V3* acc, int i, V3 v) { acc[i] = add(acc[i], v); }

WS_FN void substep(const Header& H, const Body* bodies, const Joint* joints,
                   const PointPlane* pps, const CapsuleBox* cbs, const float* act,
                   EnvState& s) {
  const int n = H.n_bodies;
  V3 fvel[kMaxBodies], fang[kMaxBodies], avel[kMaxBodies], aang[kMaxBodies];
  for (int i = 0; i < n; ++i) {
    fvel[i] = fang[i] = avel[i] = aang[i] = V3{0.0f, 0.0f, 0.0f};
  }

  // ---- joints and actuators ----
  for (int jn = 0; jn < H.n_joints; ++jn) {
    const Joint& J = joints[jn];
    const int p = J.parent, c = J.child;
    Q4 q_p = rot_of(bodies, s, p), q_c = rot_of(bodies, s, c);
    Q4 qj = q4(J.q_j);
    Q4 q_pj = qmul(q_p, qj);
    Q4 q_cj = qmul(q_c, qj);
    Q4 q_d = qmul(qinv(q_pj), q_cj);
    V3 axis = qrot(V3{1.0f, 0.0f, 0.0f}, q_pj);

    V3 r_p = qrot(v3(J.off_p), q_p);
    V3 r_c = qrot(v3(J.off_c), q_c);
    V3 anchor_p = add(s.pos[p], r_p);
    V3 anchor_c = add(s.pos[c], r_c);
    V3 vel_ap = add(s.vel[p], cross(s.ang[p], r_p));
    V3 vel_ac = add(s.vel[c], cross(s.ang[c], r_c));
    V3 d = sub(anchor_p, anchor_c);
    V3 dv = sub(vel_ap, vel_ac);
    V3 force_c = {J.k * d.x + J.kd * dv.x, J.k * d.y + J.kd * dv.y, J.k * d.z + J.kd * dv.z};

    // alignment: rotation vector of q_d with the free (x) axis zeroed
    float sgn_w = q_d.w >= 0.0f ? 1.0f : -1.0f;
    V3 err = {0.0f, 2.0f * sgn_w * q_d.y, 2.0f * sgn_w * q_d.z};
    V3 t_align = scale(qrot(err, q_pj), -J.k);

    float angle = 2.0f * atan2f(q_d.x, q_d.w);
    float clipped = clampf(angle, J.lim_lo, J.lim_hi);
    V3 t_limit = scale(axis, J.klim * (clipped - angle));
    V3 t_damp = scale(sub(s.ang[c], s.ang[p]), -J.kang);
    V3 torque_c = add(add(t_align, t_limit), t_damp);

    const Body& bc = bodies[c];
    const Body& bp = bodies[p];
    add_to(fvel, c, scale(force_c, bc.inv_mass));
    fvel[p] = sub(fvel[p], scale(force_c, bp.inv_mass));
    V3 tq_c = add(cross(r_c, force_c), torque_c);
    V3 tq_p = sub(cross(r_p, scale(force_c, -1.0f)), torque_c);
    add_to(fang, c, mul(bc.inv_inertia, tq_c));
    add_to(fang, p, mul(bp.inv_inertia, tq_p));

    if (J.act_idx >= 0) {
      float tau = clampf(act[J.act_idx], -1.0f, 1.0f) * J.act_k;
      V3 t_act = scale(axis, tau);
      add_to(aang, c, mul(bc.inv_inertia, t_act));
      aang[p] = sub(aang[p], mul(bp.inv_inertia, t_act));
    }
  }

  // ---- integrate: potential + kinetic, per-axis masks ----
  for (int i = 0; i < n; ++i) {
    const Body& bd = bodies[i];
    V3 tv = add(add(fvel[i], avel[i]), v3(H.gravity));
    V3 ta = add(fang[i], aang[i]);
    for (int k = 0; k < 3; ++k) {
      if (bd.active_pos[k] > 0.0f) at(s.vel[i], k) = H.vel_damp * at(s.vel[i], k) + at(tv, k) * H.h;
      if (bd.active_rot[k] > 0.0f) at(s.ang[i], k) = H.ang_damp * at(s.ang[i], k) + at(ta, k) * H.h;
    }
    for (int k = 0; k < 3; ++k) {
      if (bd.active_pos[k] > 0.0f) at(s.pos[i], k) = at(s.pos[i], k) + at(s.vel[i], k) * H.h;
    }
    if (bd.rot_free) {
      Q4 r = s.rot[i];
      Q4 dq = qmul(Q4{0.0f, s.ang[i].x, s.ang[i].y, s.ang[i].z}, r);
      float nw = r.w + H.half_h * dq.w;
      float nx = r.x + H.half_h * dq.x;
      float ny = r.y + H.half_h * dq.y;
      float nz = r.z + H.half_h * dq.z;
      float inv_n = rsqrt_(nw * nw + nx * nx + ny * ny + nz * nz);
      s.rot[i] = Q4{nw * inv_n, nx * inv_n, ny * inv_n, nz * inv_n};
    }
  }

  // ---- contacts on the updated pose ----
  V3 dvel[kMaxBodies], dang[kMaxBodies];
  for (int i = 0; i < n; ++i) dvel[i] = dang[i] = V3{0.0f, 0.0f, 0.0f};
  // rows come sorted by body a; sums run per body and are flushed, scaled
  // by the body's inverse mass / inertia, when the body changes
  int cur = -1;
  V3 sj = {0.0f, 0.0f, 0.0f}, st = {0.0f, 0.0f, 0.0f};
  auto flush = [&](int next) {
    if (cur >= 0) {
      add_to(dvel, cur, scale(sj, bodies[cur].inv_mass));
      add_to(dang, cur, mul(bodies[cur].inv_inertia, st));
    }
    cur = next;
    sj = st = V3{0.0f, 0.0f, 0.0f};
  };

  for (int k = 0; k < H.n_pp; ++k) {
    const PointPlane& R = pps[k];
    const int a = R.a;
    if (a != cur) flush(a);
    V3 p_w = add(s.pos[a], qrot(v3(R.point), rot_of(bodies, s, a)));
    V3 plane_pt = add(v3(R.off_w), s.pos[R.b]);
    V3 nrm = v3(R.normal);
    float pen = R.radius - dot(sub(p_w, plane_pt), nrm);
    V3 cpos = sub(p_w, scale(nrm, R.radius));
    V3 j, tq;
    resolve_a(H, cpos, s.pos[a], vel_of(bodies, s, a), ang_of(bodies, s, a), nrm, pen,
              R.invm_a, R.inertia_a, &j, &tq);
    sj = add(sj, j);
    st = add(st, tq);
  }
  flush(-1);

  int cur_cap = -1;
  V3 e0w = {0.0f, 0.0f, 0.0f}, e1w = {0.0f, 0.0f, 0.0f};
  for (int k = 0; k < H.n_cb; ++k) {
    const CapsuleBox& R = cbs[k];
    const int a = R.a;
    if (a != cur) flush(a);
    if (R.cap != cur_cap) {  // world endpoints once per capsule
      Q4 qa = rot_of(bodies, s, a);
      e0w = add(s.pos[a], qrot(v3(R.e0), qa));
      e1w = add(s.pos[a], qrot(v3(R.e1), qa));
      cur_cap = R.cap;
    }
    V3 va = vel_of(bodies, s, a), aa = ang_of(bodies, s, a);
    V3 box_pos = add(v3(R.box_off_w), s.pos[R.b]);
    V3 s0 = to_local(R.rot, sub(e0w, box_pos));
    V3 s1 = to_local(R.rot, sub(e1w, box_pos));
    V3 dseg = sub(s1, s0);
    float den = fmaxf(dot(dseg, dseg), 1e-8f);
    float tmid = clampf(-dot(s0, dseg) / den, 0.0f, 1.0f);
    V3 smid = add(s0, scale(dseg, tmid));
    const float hx = R.halfsize[0], hy = R.halfsize[1], hz = R.halfsize[2];
    V3 Jrow = {0.0f, 0.0f, 0.0f}, Trow = {0.0f, 0.0f, 0.0f};
    for (int q = 0; q < 3; ++q) {
      V3 p = q == 0 ? s0 : (q == 1 ? s1 : smid);
      // point-box SDF in the box frame (fused.py:784-809)
      V3 qc = {clampf(p.x, -hx, hx), clampf(p.y, -hy, hy), clampf(p.z, -hz, hz)};
      V3 dl = sub(p, qc);
      float dist = sqrtf(fmaxf(dot(dl, dl), 1e-24f));
      bool outside = dist > 1e-8f;
      float inv_d = 1.0f / fmaxf(dist, 1e-8f);
      V3 n_out = scale(dl, inv_d);
      float pen_out = R.radius - dist;
      float fx = hx - fabsf(p.x), fy = hy - fabsf(p.y), fz = hz - fabsf(p.z);
      // nearest face; ties take the first axis, as argmin does
      bool kx = fx <= fminf(fy, fz);
      bool ky = !kx && (fy <= fz);
      bool kz = !kx && !ky;
      V3 ks = {kx ? 1.0f : 0.0f, ky ? 1.0f : 0.0f, kz ? 1.0f : 0.0f};
      float sgn = dot(p, ks) >= 0.0f ? 1.0f : -1.0f;
      V3 n_in = {sgn * ks.x, sgn * ks.y, sgn * ks.z};
      float pen_in = R.radius + fminf(fx, fminf(fy, fz));
      V3 q_in = {p.x * (1.0f - ks.x) + sgn * hx * ks.x,
                 p.y * (1.0f - ks.y) + sgn * hy * ks.y,
                 p.z * (1.0f - ks.z) + sgn * hz * ks.z};
      V3 nl = outside ? n_out : n_in;
      float pen = outside ? pen_out : pen_in;
      V3 pl = outside ? qc : q_in;
      V3 nrm = to_world(R.rot, nl);
      V3 cpos = add(box_pos, to_world(R.rot, pl));
      V3 j, tq;
      resolve_a(H, cpos, s.pos[a], va, aa, nrm, pen, R.invm_a, R.inertia_a, &j, &tq);
      Jrow = add(Jrow, j);
      Trow = add(Trow, tq);
    }
    sj = add(sj, Jrow);
    st = add(st, Trow);
  }
  flush(-1);

  for (int i = 0; i < n; ++i) {
    const Body& bd = bodies[i];
    for (int k = 0; k < 3; ++k) {
      if (bd.active_pos[k] > 0.0f) at(s.vel[i], k) = at(s.vel[i], k) + at(dvel[i], k);
      if (bd.active_rot[k] > 0.0f) at(s.ang[i], k) = at(s.ang[i], k) + at(dang[i], k);
    }
    add_to(s.info[0], i, dvel[i]);
    add_to(s.info[1], i, dang[i]);
    add_to(s.info[2], i, fvel[i]);
    add_to(s.info[3], i, fang[i]);
    add_to(s.info[4], i, avel[i]);
    add_to(s.info[5], i, aang[i]);
  }
}

// The whole control step of env `b`. Inputs are batch-first: pos/vel/ang
// (B, n, 3), rot (B, n, 4), act (B, A); outputs the same, plus six Info
// arrays (B, n, 3): contact vel/ang, joint vel/ang, actuator vel/ang.
WS_FN void step_env(const void* tables, int b,
                    const float* pos_in, const float* rot_in, const float* vel_in,
                    const float* ang_in, const float* act_in,
                    float* pos_out, float* rot_out, float* vel_out, float* ang_out,
                    float* const* info_out) {
  const Header& H = *static_cast<const Header*>(tables);
  const Body* bodies = reinterpret_cast<const Body*>(&H + 1);
  const Joint* joints = reinterpret_cast<const Joint*>(bodies + H.n_bodies);
  const PointPlane* pps = reinterpret_cast<const PointPlane*>(joints + H.n_joints);
  const CapsuleBox* cbs = reinterpret_cast<const CapsuleBox*>(pps + H.n_pp);
  const int n = H.n_bodies;
  const long long o3 = (long long)b * n * 3, o4 = (long long)b * n * 4;

  EnvState s;
  for (int i = 0; i < n; ++i) {
    s.pos[i] = v3(pos_in + o3 + 3 * i);
    s.vel[i] = v3(vel_in + o3 + 3 * i);
    s.ang[i] = v3(ang_in + o3 + 3 * i);
    s.rot[i] = q4(rot_in + o4 + 4 * i);
    for (int f = 0; f < 6; ++f) s.info[f][i] = V3{0.0f, 0.0f, 0.0f};
  }
  const float* act = act_in + (long long)b * H.n_act;

  for (int step = 0; step < H.substeps; ++step) {
    substep(H, bodies, joints, pps, cbs, act, s);
  }

  for (int i = 0; i < n; ++i) {
    float* p = pos_out + o3 + 3 * i;
    float* v = vel_out + o3 + 3 * i;
    float* w = ang_out + o3 + 3 * i;
    float* r = rot_out + o4 + 4 * i;
    p[0] = s.pos[i].x; p[1] = s.pos[i].y; p[2] = s.pos[i].z;
    v[0] = s.vel[i].x; v[1] = s.vel[i].y; v[2] = s.vel[i].z;
    w[0] = s.ang[i].x; w[1] = s.ang[i].y; w[2] = s.ang[i].z;
    r[0] = s.rot[i].w; r[1] = s.rot[i].x; r[2] = s.rot[i].y; r[3] = s.rot[i].z;
    for (int f = 0; f < 6; ++f) {
      float* o = info_out[f] + o3 + 3 * i;
      o[0] = s.info[f][i].x; o[1] = s.info[f][i].y; o[2] = s.info[f][i].z;
    }
  }
}

}  // namespace ws
