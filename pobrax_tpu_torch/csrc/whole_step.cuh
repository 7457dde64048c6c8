// whole_step.cuh — one full physics control step for one environment.
//
// Replaces the TPU's Pallas whole-step kernel,
// pobrax_tpu/physics/pallas_step.py::make_pallas_batched_step (the
// pl.pallas_call at pallas_step.py:119), which evaluates
// pobrax_tpu/physics/fused.py's scalar-unrolled step_core for a block of
// environments. Each of `substeps` substeps runs, in fused.py's order:
//   joints of 1, 2 or 3 dof (spring, alignment, per-dof limits, damping;
//   fused.py:859-909)
//   -> torque and angle-servo actuators (:911-922), thrusters (:924-926)
//   -> damped semi-implicit Euler with per-axis masks and quaternion
//      renormalisation (:928-949)
//   -> contact impulses on the updated pose, phase by phase: point-plane,
//      sphere-sphere, capsule-capsule, capsule-box (:475-842)
//   -> the contact / joint / actuator Info sums (:960-980), or the contact
//      sums alone (the contact-only Info variant, fused.py's
//      POBRAX_INFO=contact; the kernel then leaves the joint and actuator
//      Info arrays unwritten and the wrapper returns zeros for them).
//
// What bounds it on an H100: operations, not bytes. Per env and substep the
// step does roughly 30k fp32 operations for AntTag (12 bodies, 8 hinges,
// 9 point-plane rows, 36 capsule-box rows; physics/whole_step.py::cost counts
// them from this source), about 1.2e9 per control step at B = 4096, against
// about 9 MB of state and Info read and written once. At 67 TFLOP/s fp32 and
// 3.35 TB/s that is ~18 us of arithmetic against ~3 us of memory traffic.
// Humanoid, grasp, fetch and the double pendulum are operation-bound too; only
// the contact-free arms (ur5e, reacherangle) are bound by their bytes. The
// real limit is latency: one thread per env gives only 4096 threads
// (128 warps, under one per SM), each running a long dependent chain.
//
// What this design does about it (the simple, right first version):
//   * one thread per env, the substep loop at run time, blocks of 32 threads
//     so the 128 warps spread over all SMs rather than piling onto a few;
//   * the System enters as data — joint, thruster and contact rows are loops
//     over constant tables (physics/step_tables.py), so compile time does not
//     grow with the number of rows and one build serves every System;
//   * only the bodies the step touches (that move, or that a joint,
//     thruster or row names) take a slot in the per-thread arrays; the
//     tables index slots, and each slot names its body in the state arrays.
//     Every other body — AntGather's 16 frozen apples and bombs — is copied
//     from input to output with zero Info, so kMaxBodies bounds the touched
//     bodies (11 of AntGather's 27) and no thread's stack grows with them;
//   * frozen bodies are folded statically: their rotation comes from the
//     table, their velocities are zero, and the plane and box frames of rows
//     against them are precomputed per row; their rows take the one-body
//     impulse, summed per body and flushed (fused.py's vectorised phases),
//     while rows whose second body moves take the two-body impulse, written
//     to both bodies at once (fused.py's scalar `resolve`);
//   * state, Info and force sums live in per-thread arrays; with body indices
//     read from the tables they are dynamically indexed and spill to local
//     memory (cached in L1), which is accepted for now.
// A later change makes it fast: a warp per env over the contact rows, and
// CUDA graphs over the rollout.
//
// The same source builds for the host with g++ (no CUDA), which is how the
// test suite checks this arithmetic against the plain PyTorch step without a
// GPU (tests/test_torch_kernel_host.py).
#pragma once

#include <math.h>

#if defined(__CUDACC__)
#define WS_FN __host__ __device__ inline
#define WS_UNROLL _Pragma("unroll")
#else
#define WS_FN inline
#define WS_UNROLL
#endif

namespace ws {

constexpr int kMaxBodies = 16;  // physics/step_tables.py::MAX_BODIES: touched bodies

// ---- constant tables: 32-bit words, laid out by physics/step_tables.py ----

struct Header {
  int n_bodies;      // all bodies: the stride of the state arrays
  int n_slots;       // touched bodies, the Body records
  int info_contact;  // 1: contact Info only (joint / actuator arrays not written)
  int n_act, substeps, n_joints, n_thr, n_pp, n_ss, n_cc, n_cb;
  float h, half_h, vel_damp, ang_damp, gravity[3], baumgarte, one_plus_e, friction;
  float servo_gain;  // physics/joints.py::ANGLE_SERVO_GAIN
};

struct Body {  // one per slot
  int index;  // the body's index in the state arrays
  float inv_mass, inv_inertia[3], active_pos[3], active_rot[3];
  int frozen, rot_free;
  float default_rot[4];
};

struct Joint {  // 1-3 rotational dof, optional torque (0) or angle-servo (1) actuator
  int parent, child, dof, act_idx, act_kind;
  float off_p[3], off_c[3], q_j[4], lim[3][2], k, kd, klim, kang, act_k;
};

struct Thruster {  // a force along a fixed world direction on one body
  int body, act;
  float dir[3], strength, inv_mass;
};

// a point on body a against plane body b. Frozen b: normal and off_w are in
// the world frame; moving b: in b's frame, rotated by b's rotation each substep
struct PointPlane {
  int a, b, b_moves;
  float point[3], radius, normal[3], off_w[3], invm_a, inertia_a[3];
};

struct SphereSphere {
  int a, b;
  float pa[3], ra, pb[3], rb;
};

struct CapsuleCapsule {  // a sphere is a capsule of zero length
  int a, b;
  float e0a[3], e1a[3], ra, e0b[3], e1b[3], rb;
};

// one capsule of body a against one box of body b. Frozen b: rot (box local
// -> world, row-major) and box_off_w fold b's rotation in; moving b: box_q and
// box_off_w are in b's frame
struct CapsuleBox {
  int a, b, cap, b_moves;
  float e0[3], e1[3], radius, rot[9], box_q[4], box_off_w[3], halfsize[3], invm_a,
      inertia_a[3];
};

struct PassThrough {  // a body the step never touches
  int body;
};

// the size of each struct in 32-bit words, for the loader's layout check
WS_FN int layout_words(int* out) {
  out[0] = sizeof(Header) / 4;
  out[1] = sizeof(Body) / 4;
  out[2] = sizeof(Joint) / 4;
  out[3] = sizeof(Thruster) / 4;
  out[4] = sizeof(PointPlane) / 4;
  out[5] = sizeof(SphereSphere) / 4;
  out[6] = sizeof(CapsuleCapsule) / 4;
  out[7] = sizeof(CapsuleBox) / 4;
  out[8] = sizeof(PassThrough) / 4;
  return 9;
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

// row-major rotation matrix (local -> world) of a unit quaternion
WS_FN void quat_mat(Q4 q, float* R) {
  R[0] = 1.0f - 2.0f * (q.y * q.y + q.z * q.z);
  R[1] = 2.0f * (q.x * q.y - q.w * q.z);
  R[2] = 2.0f * (q.x * q.z + q.w * q.y);
  R[3] = 2.0f * (q.x * q.y + q.w * q.z);
  R[4] = 1.0f - 2.0f * (q.x * q.x + q.z * q.z);
  R[5] = 2.0f * (q.y * q.z - q.w * q.x);
  R[6] = 2.0f * (q.x * q.z - q.w * q.y);
  R[7] = 2.0f * (q.y * q.z + q.w * q.x);
  R[8] = 1.0f - 2.0f * (q.x * q.x + q.y * q.y);
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

// intrinsic x-y'-z'' Euler angles of a quaternion (fused.py::_euler_xyz)
WS_FN V3 euler_xyz(Q4 q) {
  float m02 = 2.0f * (q.x * q.z + q.w * q.y);
  float m12 = 2.0f * (q.y * q.z - q.w * q.x);
  float m22 = 1.0f - 2.0f * (q.x * q.x + q.y * q.y);
  float m01 = 2.0f * (q.x * q.y - q.w * q.z);
  float m00 = 1.0f - 2.0f * (q.y * q.y + q.z * q.z);
  return {atan2f(-m12, m22), asinf(clampf(m02, -1.0f, 1.0f)), atan2f(-m01, m00)};
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

// Per-env state and Info sums, indexed by slot.
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
WS_FN V3 world_point(const Body* bodies, const EnvState& s, int i, const float* local) {
  return add(s.pos[i], qrot(v3(local), rot_of(bodies, s, i)));
}

WS_FN void add_to(V3* acc, int i, V3 v) { acc[i] = add(acc[i], v); }

// One-shot impulse between two bodies that may both move (fused.py's scalar
// `resolve`, :475-513): j on a, -j on b, written to both bodies at once.
WS_FN void resolve(const Header& H, const Body* bodies, const EnvState& s, int a, int b,
                   V3 cpos, V3 n, float pen, V3* dvel, V3* dang) {
  const Body& ba = bodies[a];
  const Body& bb = bodies[b];
  V3 r_a = sub(cpos, s.pos[a]);
  V3 r_b = sub(cpos, s.pos[b]);
  V3 v_a = add(vel_of(bodies, s, a), cross(ang_of(bodies, s, a), r_a));
  V3 v_b = add(vel_of(bodies, s, b), cross(ang_of(bodies, s, b), r_b));
  V3 v_rel = sub(v_a, v_b);
  float vn = dot(v_rel, n);
  float ang_a = dot(n, cross(mul(ba.inv_inertia, cross(r_a, n)), r_a));
  float ang_b = dot(n, cross(mul(bb.inv_inertia, cross(r_b, n)), r_b));
  float denom = fmaxf(ba.inv_mass + bb.inv_mass + ang_a + ang_b, 1e-8f);
  float imp = (-H.one_plus_e * vn + H.baumgarte * fmaxf(pen, 0.0f)) / denom;
  bool live = (pen > 0.0f) && (imp > 0.0f);
  imp = live ? imp : 0.0f;
  V3 v_t = sub(v_rel, scale(n, vn));
  float vt_n = sqrtf(fmaxf(dot(v_t, v_t), 1e-24f));
  float imp_d = fminf(vt_n / denom, H.friction * imp);
  imp_d = (live && vt_n > 1e-8f) ? imp_d : 0.0f;
  float scale_t = imp_d / fmaxf(vt_n, 1e-8f);
  V3 j = sub(scale(n, imp), scale(v_t, scale_t));
  if (ba.inv_mass != 0.0f) {
    add_to(dvel, a, scale(j, ba.inv_mass));
    add_to(dang, a, mul(ba.inv_inertia, cross(r_a, j)));
  }
  if (bb.inv_mass != 0.0f) {
    dvel[b] = sub(dvel[b], scale(j, bb.inv_mass));
    add_to(dang, b, mul(bb.inv_inertia, cross(r_b, scale(j, -1.0f))));
  }
}

// the contact of two spheres (centres ca, cb, radii ra, rb) on the line of
// their centres: position on b's surface pushed half the penetration out
WS_FN void sphere_contact(const Header& H, const Body* bodies, const EnvState& s, int a, int b,
                          V3 ca, V3 cb, float ra, float rb, V3* dvel, V3* dang) {
  V3 d = sub(ca, cb);
  float dist = sqrtf(fmaxf(dot(d, d), 1e-24f));
  V3 nrm = scale(d, 1.0f / fmaxf(dist, 1e-8f));
  float pen = ra + rb - dist;
  V3 cpos = add(cb, scale(nrm, rb - 0.5f * fmaxf(pen, 0.0f)));
  resolve(H, bodies, s, a, b, cpos, nrm, pen, dvel, dang);
}

struct Tables {
  const Header* H;
  const Body* bodies;
  const Joint* joints;
  const Thruster* thrusters;
  const PointPlane* pps;
  const SphereSphere* sss;
  const CapsuleCapsule* ccs;
  const CapsuleBox* cbs;
  const PassThrough* passes;
};

WS_FN Tables tables_of(const void* buf) {
  Tables t;
  t.H = static_cast<const Header*>(buf);
  t.bodies = reinterpret_cast<const Body*>(t.H + 1);
  t.joints = reinterpret_cast<const Joint*>(t.bodies + t.H->n_slots);
  t.thrusters = reinterpret_cast<const Thruster*>(t.joints + t.H->n_joints);
  t.pps = reinterpret_cast<const PointPlane*>(t.thrusters + t.H->n_thr);
  t.sss = reinterpret_cast<const SphereSphere*>(t.pps + t.H->n_pp);
  t.ccs = reinterpret_cast<const CapsuleCapsule*>(t.sss + t.H->n_ss);
  t.cbs = reinterpret_cast<const CapsuleBox*>(t.ccs + t.H->n_cc);
  t.passes = reinterpret_cast<const PassThrough*>(t.cbs + t.H->n_cb);
  return t;
}

WS_FN void substep(const Tables& T, const float* act, EnvState& s) {
  const Header& H = *T.H;
  const Body* bodies = T.bodies;
  const int n = H.n_slots;
  V3 fvel[kMaxBodies], fang[kMaxBodies], avel[kMaxBodies], aang[kMaxBodies];
  for (int i = 0; i < n; ++i) {
    fvel[i] = fang[i] = avel[i] = aang[i] = V3{0.0f, 0.0f, 0.0f};
  }

  // ---- joints and their actuators ----
  for (int jn = 0; jn < H.n_joints; ++jn) {
    const Joint& J = T.joints[jn];
    const int p = J.parent, c = J.child, dof = J.dof;
    Q4 q_p = rot_of(bodies, s, p), q_c = rot_of(bodies, s, c);
    Q4 qj = q4(J.q_j);
    Q4 q_pj = qmul(q_p, qj);
    Q4 q_cj = qmul(q_c, qj);
    Q4 q_d = qmul(qinv(q_pj), q_cj);
    // the dof loops run to 3 and test `d < dof`, so that they unroll with
    // constant indices and axes[] stays in registers
    V3 axes[3];
WS_UNROLL
    for (int d = 0; d < 3; ++d) {
      if (d < dof) {
        axes[d] = qrot(V3{d == 0 ? 1.0f : 0.0f, d == 1 ? 1.0f : 0.0f, d == 2 ? 1.0f : 0.0f}, q_pj);
      }
    }

    V3 r_p = qrot(v3(J.off_p), q_p);
    V3 r_c = qrot(v3(J.off_c), q_c);
    V3 anchor_p = add(s.pos[p], r_p);
    V3 anchor_c = add(s.pos[c], r_c);
    V3 vel_ap = add(s.vel[p], cross(s.ang[p], r_p));
    V3 vel_ac = add(s.vel[c], cross(s.ang[c], r_c));
    V3 d = sub(anchor_p, anchor_c);
    V3 dv = sub(vel_ap, vel_ac);
    V3 force_c = {J.k * d.x + J.kd * dv.x, J.k * d.y + J.kd * dv.y, J.k * d.z + J.kd * dv.z};

    // alignment: rotation vector of q_d with the free axes (the first dof)
    // zeroed; a 3-dof joint has none
    V3 t_align = {0.0f, 0.0f, 0.0f};
    if (dof < 3) {
      float sgn_w = q_d.w >= 0.0f ? 1.0f : -1.0f;
      V3 err = {0.0f, dof < 2 ? 2.0f * sgn_w * q_d.y : 0.0f, 2.0f * sgn_w * q_d.z};
      t_align = scale(qrot(err, q_pj), -J.k);
    }

    // per-dof angles: the hinge reads 2 atan2(x, w), 2 and 3 dof the Euler
    // angles. `dof` comes from the table, so the branch is uniform over the
    // warp; a branch (not a select) keeps hinges from paying for the Euler readout
    V3 angles = {0.0f, 0.0f, 0.0f};
    if (dof == 1) {
      angles.x = 2.0f * atan2f(q_d.x, q_d.w);
    } else {
      angles = euler_xyz(q_d);
    }
    V3 t_limit = {0.0f, 0.0f, 0.0f};
WS_UNROLL
    for (int dd = 0; dd < 3; ++dd) {
      if (dd < dof) {
        float angle = at(angles, dd);
        float clipped = clampf(angle, J.lim[dd][0], J.lim[dd][1]);
        t_limit = add(t_limit, scale(axes[dd], J.klim * (clipped - angle)));
      }
    }
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
      V3 t_act = {0.0f, 0.0f, 0.0f};
WS_UNROLL
      for (int dd = 0; dd < 3; ++dd) {
        if (dd < dof) {
          float a_in = act[J.act_idx + dd];
          float tau = J.act_kind == 1
                          ? clampf(H.servo_gain * (a_in - at(angles, dd)), -J.act_k, J.act_k)
                          : clampf(a_in, -1.0f, 1.0f) * J.act_k;
          t_act = add(t_act, scale(axes[dd], tau));
        }
      }
      add_to(aang, c, mul(bc.inv_inertia, t_act));
      aang[p] = sub(aang[p], mul(bp.inv_inertia, t_act));
    }
  }

  for (int t = 0; t < H.n_thr; ++t) {
    const Thruster& R = T.thrusters[t];
    float a_val = clampf(act[R.act], -1.0f, 1.0f) * R.strength;
    add_to(avel, R.body, scale(v3(R.dir), a_val * R.inv_mass));
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
  // rows against a frozen body come sorted by body a; their sums run per
  // body and are flushed, scaled by the body's inverse mass / inertia, when
  // the body changes
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
    const PointPlane& R = T.pps[k];
    const int a = R.a;
    V3 p_w = world_point(bodies, s, a, R.point);
    V3 nrm = v3(R.normal), plane_pt = v3(R.off_w);
    if (R.b_moves) {
      Q4 qb = s.rot[R.b];
      nrm = qrot(nrm, qb);
      plane_pt = qrot(plane_pt, qb);
    }
    plane_pt = add(plane_pt, s.pos[R.b]);
    float pen = R.radius - dot(sub(p_w, plane_pt), nrm);
    V3 cpos = sub(p_w, scale(nrm, R.radius));
    if (R.b_moves) {
      resolve(H, bodies, s, a, R.b, cpos, nrm, pen, dvel, dang);
      continue;
    }
    if (a != cur) flush(a);
    V3 j, tq;
    resolve_a(H, cpos, s.pos[a], vel_of(bodies, s, a), ang_of(bodies, s, a), nrm, pen,
              R.invm_a, R.inertia_a, &j, &tq);
    sj = add(sj, j);
    st = add(st, tq);
  }
  flush(-1);

  for (int k = 0; k < H.n_ss; ++k) {
    const SphereSphere& R = T.sss[k];
    sphere_contact(H, bodies, s, R.a, R.b, world_point(bodies, s, R.a, R.pa),
                   world_point(bodies, s, R.b, R.pb), R.ra, R.rb, dvel, dang);
  }

  for (int k = 0; k < H.n_cc; ++k) {
    const CapsuleCapsule& R = T.ccs[k];
    V3 p1 = world_point(bodies, s, R.a, R.e0a);
    V3 q1 = world_point(bodies, s, R.a, R.e1a);
    V3 p2 = world_point(bodies, s, R.b, R.e0b);
    V3 q2 = world_point(bodies, s, R.b, R.e1b);
    // closest points of the two segments, with guards for zero length
    V3 d1 = sub(q1, p1), d2 = sub(q2, p2), rr = sub(p1, p2);
    float a_ = dot(d1, d1), e_ = dot(d2, d2), f_ = dot(d2, rr), c_ = dot(d1, rr),
          b_ = dot(d1, d2);
    float den = a_ * e_ - b_ * b_;
    float sc = den > 1e-8f ? clampf((b_ * f_ - c_ * e_) / fmaxf(den, 1e-8f), 0.0f, 1.0f) : 0.0f;
    float tc = e_ > 1e-8f ? clampf((b_ * sc + f_) / fmaxf(e_, 1e-8f), 0.0f, 1.0f) : 0.0f;
    sc = a_ > 1e-8f ? clampf((b_ * tc - c_) / fmaxf(a_, 1e-8f), 0.0f, 1.0f) : 0.0f;
    sphere_contact(H, bodies, s, R.a, R.b, add(p1, scale(d1, sc)), add(p2, scale(d2, tc)),
                   R.ra, R.rb, dvel, dang);
  }

  int cur_cap = -1;
  V3 e0w = {0.0f, 0.0f, 0.0f}, e1w = {0.0f, 0.0f, 0.0f};
  for (int k = 0; k < H.n_cb; ++k) {
    const CapsuleBox& R = T.cbs[k];
    const int a = R.a;
    if (!R.b_moves && a != cur) flush(a);
    if (R.cap != cur_cap) {  // world endpoints once per capsule
      e0w = world_point(bodies, s, a, R.e0);
      e1w = world_point(bodies, s, a, R.e1);
      cur_cap = R.cap;
    }
    V3 va = vel_of(bodies, s, a), aa = ang_of(bodies, s, a);
    // the box frame in registers either way (a pointer that may point to
    // the tables or to a local array makes every use a generic load)
    float Rw[9];
    V3 box_pos = v3(R.box_off_w);
    if (R.b_moves) {
      Q4 qb = s.rot[R.b];
      quat_mat(qmul(qb, q4(R.box_q)), Rw);
      box_pos = qrot(box_pos, qb);
    } else {
      for (int e = 0; e < 9; ++e) Rw[e] = R.rot[e];
    }
    box_pos = add(box_pos, s.pos[R.b]);
    V3 s0 = to_local(Rw, sub(e0w, box_pos));
    V3 s1 = to_local(Rw, sub(e1w, box_pos));
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
      V3 nrm = to_world(Rw, nl);
      V3 cpos = add(box_pos, to_world(Rw, pl));
      if (R.b_moves) {
        resolve(H, bodies, s, a, R.b, cpos, nrm, pen, dvel, dang);
        continue;
      }
      V3 j, tq;
      resolve_a(H, cpos, s.pos[a], va, aa, nrm, pen, R.invm_a, R.inertia_a, &j, &tq);
      Jrow = add(Jrow, j);
      Trow = add(Trow, tq);
    }
    if (!R.b_moves) {
      sj = add(sj, Jrow);
      st = add(st, Trow);
    }
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
    if (H.info_contact) continue;  // uniform over the warp: from the tables
    add_to(s.info[2], i, fvel[i]);
    add_to(s.info[3], i, fang[i]);
    add_to(s.info[4], i, avel[i]);
    add_to(s.info[5], i, aang[i]);
  }
}

// The whole control step of env `b`. Inputs are batch-first: pos/vel/ang
// (B, n, 3), rot (B, n, 4), act (B, A); outputs the same, plus six Info
// arrays (B, n, 3): contact vel/ang, joint vel/ang, actuator vel/ang. With
// info_contact set, the joint and actuator arrays (info_out[2..5]) are not
// written and may be null.
WS_FN void step_env(const void* tables, int b,
                    const float* pos_in, const float* rot_in, const float* vel_in,
                    const float* ang_in, const float* act_in,
                    float* pos_out, float* rot_out, float* vel_out, float* ang_out,
                    float* const* info_out) {
  const Tables T = tables_of(tables);
  const int n = T.H->n_bodies, m = T.H->n_slots;
  const int n_info = T.H->info_contact ? 2 : 6;
  const long long o3 = (long long)b * n * 3, o4 = (long long)b * n * 4;

  EnvState s;
  for (int i = 0; i < m; ++i) {
    const int k = T.bodies[i].index;
    s.pos[i] = v3(pos_in + o3 + 3 * k);
    s.vel[i] = v3(vel_in + o3 + 3 * k);
    s.ang[i] = v3(ang_in + o3 + 3 * k);
    s.rot[i] = q4(rot_in + o4 + 4 * k);
    for (int f = 0; f < 6; ++f) s.info[f][i] = V3{0.0f, 0.0f, 0.0f};
  }
  const float* act = act_in + (long long)b * T.H->n_act;

  for (int step = 0; step < T.H->substeps; ++step) {
    substep(T, act, s);
  }

  for (int i = 0; i < m; ++i) {
    const int k = T.bodies[i].index;
    float* p = pos_out + o3 + 3 * k;
    float* v = vel_out + o3 + 3 * k;
    float* w = ang_out + o3 + 3 * k;
    float* r = rot_out + o4 + 4 * k;
    p[0] = s.pos[i].x; p[1] = s.pos[i].y; p[2] = s.pos[i].z;
    v[0] = s.vel[i].x; v[1] = s.vel[i].y; v[2] = s.vel[i].z;
    w[0] = s.ang[i].x; w[1] = s.ang[i].y; w[2] = s.ang[i].z;
    r[0] = s.rot[i].w; r[1] = s.rot[i].x; r[2] = s.rot[i].y; r[3] = s.rot[i].z;
    for (int f = 0; f < n_info; ++f) {
      float* o = info_out[f] + o3 + 3 * k;
      o[0] = s.info[f][i].x; o[1] = s.info[f][i].y; o[2] = s.info[f][i].z;
    }
  }

  // bodies the step never touches: state through, zero Info
  for (int i = 0; i < n - m; ++i) {
    const int k = T.passes[i].body;
    for (int c = 0; c < 3; ++c) {
      pos_out[o3 + 3 * k + c] = pos_in[o3 + 3 * k + c];
      vel_out[o3 + 3 * k + c] = vel_in[o3 + 3 * k + c];
      ang_out[o3 + 3 * k + c] = ang_in[o3 + 3 * k + c];
      for (int f = 0; f < n_info; ++f) info_out[f][o3 + 3 * k + c] = 0.0f;
    }
    for (int c = 0; c < 4; ++c) rot_out[o4 + 4 * k + c] = rot_in[o4 + 4 * k + c];
  }
}

}  // namespace ws
