// whole_step.cuh — one full physics control step for one environment, run by
// kLanes = 16 lanes of a warp (two envs share a warp).
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
// step does roughly 28k fp32 operations for AntTag (11 slots, 8 hinges,
// 9 point-plane rows, 36 capsule-box rows; physics/whole_step.py::cost counts
// them from this source), about 1.2e9 per control step at B = 4096, against
// about 9 MB of state and Info read and written once: ~17 us of arithmetic
// at 67 TFLOP/s fp32 against ~3 us of memory traffic at 3.35 TB/s. The real
// limit is latency. One thread per env (the first version) gave 128 warps,
// one per SM, each walking 45-117 contact rows in series through local
// memory, and reached 1.5-2% of the operation bound.
//
// What this design does about it:
//   * an env per kLanes lanes of a warp, many envs per block: each SM holds
//     many warps and hides one warp's latency behind the others'. kLanes is
//     16 (two envs per warp, 8 per block of 4 warps): 4096 envs are 2048
//     warps, one wave at the 16 warps an SM holds, and the rows of an env
//     fill more of its lanes. A whole warp per env, measured on an H100,
//     took two waves for the same batch with most lanes idle in the narrow
//     phases: 1.3-1.9x slower on the contact Systems, equal on the small
//     ones (PERF.md);
//   * lane i < n_slots owns slot i: the body's pos, rot, vel, ang, its Info
//     sums and its force and impulse accumulators live in that lane's
//     registers (struct Own), with no array indexed by a table value, so
//     nothing goes to local memory. Integration, applying the impulses and
//     the Info sums are work per body and run on all owner lanes at once;
//   * per-env scratch in shared memory (layout by physics/step_tables.py):
//     a snapshot of every slot's pos / rot / vel / ang that owner lanes
//     publish and joint and row lanes read, the actions, each capsule's
//     world endpoints, and one result record per joint, thruster and contact
//     row (the force and contact records share one region, which also
//     stages the Info sums for the final store);
//   * joints, thrusters and contact rows are independent once the pose is
//     known: lanes stride over them, so a substep's rows take
//     ceil(rows / kLanes) rounds instead of one row after another;
//   * each slot has a gather list (physics/step_tables.py) of the records
//     that touch it, in the exact order in which fused.py (and the first
//     version) added them into that body's accumulator: joints in joint
//     order, then point-plane rows against a moving body, the frozen
//     point-plane flush, sphere-sphere, capsule-capsule, capsule-box rows
//     against a moving box and the frozen capsule-box flush. The owner lane
//     walks it in order, so every body sees the same adds in the same order
//     whichever lane computed a record;
//   * phases are separated by __syncwarp alone: envs share nothing but the
//     tables, and lanes talk only through the scratch (no shuffles); the two
//     envs of a warp run the same phases of the same System in step;
//   * the System enters as data: the tables are staged once per block into
//     shared memory with coalesced loads, so one build serves every System
//     and compile time does not grow with its rows;
//   * an env's lanes load and store its contiguous (n, 3) / (n, 4) slices
//     lane by lane; bodies the step never touches (AntGather's apples and
//     bombs) are copied through with zero Info in the same loop.
//
// Each phase is a WS_FN function of (lane, Own, Ctx). The CUDA kernel calls
// it with its own lane and __syncwarp()s after it; the host build
// (whole_step_host.cpp, g++) calls it for lanes 0..kLanes-1 in turn, forward
// or reversed, phase by phase. So tests/test_torch_kernel_host.py checks the
// arithmetic the card runs against the plain PyTorch step without a GPU, and
// a phase in which two lanes write one scratch word, or a lane reads a word
// another lane writes, shows as a difference between the two lane orders.
#pragma once

#include <math.h>

#if defined(__CUDACC__)
#define WS_FN __host__ __device__ __forceinline__
#define WS_UNROLL _Pragma("unroll")
#else
#define WS_FN inline
#define WS_UNROLL
#endif

namespace ws {

constexpr int kMaxBodies = 16;  // physics/step_tables.py::MAX_BODIES: touched bodies
// lanes per env, a half-warp: at least kMaxBodies, since lane i owns slot i
constexpr int kLanes = 16;
static_assert(kLanes >= kMaxBodies && 32 % kLanes == 0, "kLanes must divide a warp");
constexpr int kSnapWords = 13 * kMaxBodies;  // pos 3, rot 4, vel 3, ang 3 per slot

// ---- constant tables: 32-bit words, laid out by physics/step_tables.py ----

struct Header {
  int n_bodies;      // all bodies: the stride of the state arrays
  int n_slots;       // touched bodies, the Body records and owner lanes
  int info_contact;  // 1: contact Info only (joint / actuator arrays not written)
  int n_act, substeps, n_joints, n_thr, n_pp, n_ss, n_cc, n_cb;
  int n_caps, n_gather;
  int scratch_words;  // per-env scratch in shared memory
  int off_act;        // scratch offsets: the actions, the Info staging
  int off_info;
  float h, half_h, vel_damp, ang_damp, gravity[3], baumgarte, one_plus_e, friction;
  float servo_gain;  // physics/joints.py::ANGLE_SERVO_GAIN
};

struct Body {  // one per slot
  int index;  // the body's index in the state arrays
  float inv_mass, inv_inertia[3], active_pos[3], active_rot[3];
  int frozen, rot_free;
  float default_rot[4];
  int force_lo, force_hi;      // its gather entries for the forces phase
  int contact_lo, contact_hi;  // and for the contacts phase
  int cap_lo, cap_hi;          // its capsules, whose world endpoints it computes
};

// `rec` in each row is the scratch offset of the row's result record
struct Joint {  // 1-3 rotational dof, optional torque (0) or angle-servo (1) actuator
  int parent, child, dof, act_idx, act_kind, rec;
  float off_p[3], off_c[3], q_j[4], lim[3][2], k, kd, klim, kang, act_k;
};

struct Thruster {  // a force along a fixed world direction on one body
  int body, act, rec;
  float dir[3], strength, inv_mass, pad;
};

// a point on body a against plane body b. Frozen b: normal and off_w are in
// the world frame; moving b: in b's frame, rotated by b's rotation each substep
struct PointPlane {
  int a, b, b_moves, rec;
  float point[3], radius, normal[3], off_w[3], invm_a, inertia_a[3], pad;
};

struct SphereSphere {
  int a, b, rec;
  float pa[3], ra, pb[3], rb;
};

struct CapsuleCapsule {  // a sphere is a capsule of zero length
  int a, b, rec;
  float e0a[3], e1a[3], ra, e0b[3], e1b[3], rb;
};

// one capsule of body a against one box of body b; `cap` is the scratch
// offset of the capsule's world endpoints. Frozen b: rot (box local -> world,
// row-major) and box_off_w fold b's rotation in; moving b: box_q and
// box_off_w are in b's frame
struct CapsuleBox {
  int a, b, cap, b_moves, rec;
  float radius, rot[9], box_q[4], box_off_w[3], halfsize[3], invm_a, inertia_a[3];
};

struct Capsule {  // a capsule of a box row, in its body's frame
  int body, rec;
  float e0[3], e1[3], pad;
};

// The size of each struct in 32-bit words, for the loader's layout check.
// Row records have an odd size, so lanes reading consecutive rows hit
// different shared-memory banks.
WS_FN int layout_words(int* out) {
  out[0] = sizeof(Header) / 4;
  out[1] = sizeof(Body) / 4;
  out[2] = sizeof(Joint) / 4;
  out[3] = sizeof(Thruster) / 4;
  out[4] = sizeof(PointPlane) / 4;
  out[5] = sizeof(SphereSphere) / 4;
  out[6] = sizeof(CapsuleCapsule) / 4;
  out[7] = sizeof(CapsuleBox) / 4;
  out[8] = sizeof(Capsule) / 4;
  return 9;
}

// Gather entries, one int each: kind << 28 | count << 16 | scratch offset.
//   kJoint     fvel += r[0:3], fang += r[3:6]    (one side of a joint)
//   kJointAct  the same, and aang += r[6:9]      (an actuated joint)
//   kThrust    avel += r[0:3]
//   kSide      dvel += r[0:3], dang += r[3:6]    (one side of a two-body impulse)
//   kFlush     count rows (j, r x j) of 6 words, summed in order, then
//              dvel += sum_j * inv_mass, dang += inv_inertia * sum_t
enum GatherKind { kJoint = 0, kJointAct = 1, kThrust = 2, kSide = 3, kFlush = 4 };
WS_FN int g_kind(int e) { return e >> 28; }
WS_FN int g_count(int e) { return (e >> 16) & 0xfff; }
WS_FN int g_off(int e) { return e & 0xffff; }

// ---- small vector algebra, written as fused.py writes it ------------------

struct V3 { float x, y, z; };
struct Q4 { float w, x, y, z; };

WS_FN V3 v3(const float* p) { return {p[0], p[1], p[2]}; }
WS_FN Q4 q4(const float* p) { return {p[0], p[1], p[2], p[3]}; }
WS_FN void put3(float* p, V3 v) { p[0] = v.x; p[1] = v.y; p[2] = v.z; }
WS_FN void put4(float* p, Q4 q) { p[0] = q.w; p[1] = q.x; p[2] = q.y; p[3] = q.z; }
WS_FN V3 add(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
WS_FN V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
WS_FN V3 neg(V3 a) { return {-a.x, -a.y, -a.z}; }
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

// ---- the tables, the per-env scratch and the lanes' own state -------------

struct Tables {
  const Header* H;
  const Body* bodies;
  const Joint* joints;
  const Thruster* thrusters;
  const PointPlane* pps;
  const SphereSphere* sss;
  const CapsuleCapsule* ccs;
  const CapsuleBox* cbs;
  const Capsule* caps;
  const int* slot_of;  // per body: its slot, or -1 if it passes through
  const int* gather;
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
  t.caps = reinterpret_cast<const Capsule*>(t.cbs + t.H->n_cb);
  t.slot_of = reinterpret_cast<const int*>(t.caps + t.H->n_caps);
  t.gather = t.slot_of + t.H->n_bodies;
  return t;
}

// the snapshot at the start of the scratch: every slot's state as owner
// lanes last published it
struct Snap {
  float pos[3 * kMaxBodies], rot[4 * kMaxBodies], vel[3 * kMaxBodies], ang[3 * kMaxBodies];
};

// one env's inputs and outputs, each pointing at the env's own slice
struct Io {
  const float *pos, *rot, *vel, *ang, *act;
  float *pos_out, *rot_out, *vel_out, *ang_out;
  float* info[6];  // contact, joint, actuator (vel, ang); [2..5] unused with contact Info
  bool store;      // false: the lanes only keep their warp's other env company
};

struct Ctx {
  Tables T;
  float* scr;  // this env's scratch
  Io io;
};

// what an owner lane keeps in registers for its slot
struct Own {
  V3 pos, vel, ang;
  Q4 rot;
  V3 info[6];  // contact, joint, actuator (vel, ang)
};

WS_FN const Snap& snap(const Ctx& c) { return *reinterpret_cast<const Snap*>(c.scr); }
WS_FN Snap& snap_mut(const Ctx& c) { return *reinterpret_cast<Snap*>(c.scr); }
WS_FN V3 spos(const Snap& s, int i) { return v3(s.pos + 3 * i); }
WS_FN V3 svel(const Snap& s, int i) { return v3(s.vel + 3 * i); }
WS_FN V3 sang(const Snap& s, int i) { return v3(s.ang + 3 * i); }
WS_FN Q4 srot(const Snap& s, int i) { return q4(s.rot + 4 * i); }

WS_FN Q4 rot_of(const Body* bodies, const Snap& s, int i) {
  return bodies[i].frozen ? q4(bodies[i].default_rot) : srot(s, i);
}
WS_FN V3 vel_of(const Body* bodies, const Snap& s, int i) {
  return bodies[i].frozen ? V3{0.0f, 0.0f, 0.0f} : svel(s, i);
}
WS_FN V3 ang_of(const Body* bodies, const Snap& s, int i) {
  return bodies[i].frozen ? V3{0.0f, 0.0f, 0.0f} : sang(s, i);
}
WS_FN V3 world_point(const Body* bodies, const Snap& s, int i, const float* local) {
  return add(spos(s, i), qrot(v3(local), rot_of(bodies, s, i)));
}

// ---- contact impulses -------------------------------------------------------

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

// One-shot impulse between two bodies that may both move (fused.py's scalar
// `resolve`, :475-513): j on a, -j on b. Writes each moving side's
// (dvel, dang) terms to the row's record, a at r[0:6] and b at r[6:12].
WS_FN void resolve(const Header& H, const Body* bodies, const Snap& s, int a, int b,
                   V3 cpos, V3 n, float pen, float* r) {
  const Body& ba = bodies[a];
  const Body& bb = bodies[b];
  V3 r_a = sub(cpos, spos(s, a));
  V3 r_b = sub(cpos, spos(s, b));
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
  if (ba.inv_mass != 0.0f) {  // a side without mass has no gather entry
    put3(r, scale(j, ba.inv_mass));
    put3(r + 3, mul(ba.inv_inertia, cross(r_a, j)));
  }
  if (bb.inv_mass != 0.0f) {
    put3(r + 6, neg(scale(j, bb.inv_mass)));
    put3(r + 9, mul(bb.inv_inertia, cross(r_b, scale(j, -1.0f))));
  }
}

// the contact of two spheres (centres ca, cb, radii ra, rb) on the line of
// their centres: position on b's surface pushed half the penetration out
WS_FN void sphere_contact(const Header& H, const Body* bodies, const Snap& s, int a, int b,
                          V3 ca, V3 cb, float ra, float rb, float* r) {
  V3 d = sub(ca, cb);
  float dist = sqrtf(fmaxf(dot(d, d), 1e-24f));
  V3 nrm = scale(d, 1.0f / fmaxf(dist, 1e-8f));
  float pen = ra + rb - dist;
  V3 cpos = add(cb, scale(nrm, rb - 0.5f * fmaxf(pen, 0.0f)));
  resolve(H, bodies, s, a, b, cpos, nrm, pen, r);
}

// ---- rows: each writes its own record and nothing else ---------------------

// a joint's forces and torques on its child (record r[0:9]: fvel, fang,
// aang) and parent (r[9:18]); the parent's force and actuator terms are
// stored negated, as fused.py subtracts them
WS_FN void joint_row(const Ctx& c, int jn) {
  const Header& H = *c.T.H;
  const Body* bodies = c.T.bodies;
  const Snap& s = snap(c);
  const float* act = c.scr + H.off_act;
  const Joint& J = c.T.joints[jn];
  const int p = J.parent, ch = J.child, dof = J.dof;
  Q4 q_p = rot_of(bodies, s, p), q_c = rot_of(bodies, s, ch);
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
  V3 anchor_p = add(spos(s, p), r_p);
  V3 anchor_c = add(spos(s, ch), r_c);
  V3 vel_ap = add(svel(s, p), cross(sang(s, p), r_p));
  V3 vel_ac = add(svel(s, ch), cross(sang(s, ch), r_c));
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
  // angles; a branch (not a select) keeps hinges from paying for the Euler
  // readout
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
  V3 t_damp = scale(sub(sang(s, ch), sang(s, p)), -J.kang);
  V3 torque_c = add(add(t_align, t_limit), t_damp);

  const Body& bc = bodies[ch];
  const Body& bp = bodies[p];
  float* r = c.scr + J.rec;
  V3 tq_c = add(cross(r_c, force_c), torque_c);
  V3 tq_p = sub(cross(r_p, scale(force_c, -1.0f)), torque_c);
  put3(r, scale(force_c, bc.inv_mass));
  put3(r + 3, mul(bc.inv_inertia, tq_c));
  put3(r + 9, neg(scale(force_c, bp.inv_mass)));
  put3(r + 12, mul(bp.inv_inertia, tq_p));

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
    put3(r + 6, mul(bc.inv_inertia, t_act));
    put3(r + 15, neg(mul(bp.inv_inertia, t_act)));
  }
}

WS_FN void thruster_row(const Ctx& c, int k) {
  const Thruster& R = c.T.thrusters[k];
  float a_val = clampf(c.scr[c.T.H->off_act + R.act], -1.0f, 1.0f) * R.strength;
  put3(c.scr + R.rec, scale(v3(R.dir), a_val * R.inv_mass));
}

// frozen plane: (j, r x j) at r[0:6], summed by the body's flush; moving
// plane: the two-body terms
WS_FN void point_plane_row(const Ctx& c, int k) {
  const Header& H = *c.T.H;
  const Body* bodies = c.T.bodies;
  const Snap& s = snap(c);
  const PointPlane& R = c.T.pps[k];
  const int a = R.a;
  V3 p_w = world_point(bodies, s, a, R.point);
  V3 nrm = v3(R.normal), plane_pt = v3(R.off_w);
  if (R.b_moves) {
    Q4 qb = srot(s, R.b);
    nrm = qrot(nrm, qb);
    plane_pt = qrot(plane_pt, qb);
  }
  plane_pt = add(plane_pt, spos(s, R.b));
  float pen = R.radius - dot(sub(p_w, plane_pt), nrm);
  V3 cpos = sub(p_w, scale(nrm, R.radius));
  float* r = c.scr + R.rec;
  if (R.b_moves) {
    resolve(H, bodies, s, a, R.b, cpos, nrm, pen, r);
    return;
  }
  V3 j, tq;
  resolve_a(H, cpos, spos(s, a), vel_of(bodies, s, a), ang_of(bodies, s, a), nrm, pen,
            R.invm_a, R.inertia_a, &j, &tq);
  put3(r, j);
  put3(r + 3, tq);
}

WS_FN void sphere_sphere_row(const Ctx& c, int k) {
  const Body* bodies = c.T.bodies;
  const Snap& s = snap(c);
  const SphereSphere& R = c.T.sss[k];
  sphere_contact(*c.T.H, bodies, s, R.a, R.b, world_point(bodies, s, R.a, R.pa),
                 world_point(bodies, s, R.b, R.pb), R.ra, R.rb, c.scr + R.rec);
}

WS_FN void capsule_capsule_row(const Ctx& c, int k) {
  const Body* bodies = c.T.bodies;
  const Snap& s = snap(c);
  const CapsuleCapsule& R = c.T.ccs[k];
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
  sphere_contact(*c.T.H, bodies, s, R.a, R.b, add(p1, scale(d1, sc)), add(p2, scale(d2, tc)),
                 R.ra, R.rb, c.scr + R.rec);
}

// the capsule's segment against the box, sampled at both ends and at the
// point nearest the box centre. Frozen box: the three samples' (j, r x j)
// summed in sample order at r[0:6]; moving box: sample q's two-body terms at
// r[12 q : 12 q + 12]
WS_FN void capsule_box_row(const Ctx& c, int k) {
  const Header& H = *c.T.H;
  const Body* bodies = c.T.bodies;
  const Snap& s = snap(c);
  const CapsuleBox& R = c.T.cbs[k];
  const int a = R.a;
  V3 e0w = v3(c.scr + R.cap), e1w = v3(c.scr + R.cap + 3);
  V3 va = vel_of(bodies, s, a), aa = ang_of(bodies, s, a);
  float Rw[9];
  V3 box_pos = v3(R.box_off_w);
  if (R.b_moves) {
    Q4 qb = srot(s, R.b);
    quat_mat(qmul(qb, q4(R.box_q)), Rw);
    box_pos = qrot(box_pos, qb);
  } else {
    for (int e = 0; e < 9; ++e) Rw[e] = R.rot[e];
  }
  box_pos = add(box_pos, spos(s, R.b));
  V3 s0 = to_local(Rw, sub(e0w, box_pos));
  V3 s1 = to_local(Rw, sub(e1w, box_pos));
  V3 dseg = sub(s1, s0);
  float den = fmaxf(dot(dseg, dseg), 1e-8f);
  float tmid = clampf(-dot(s0, dseg) / den, 0.0f, 1.0f);
  V3 smid = add(s0, scale(dseg, tmid));
  const float hx = R.halfsize[0], hy = R.halfsize[1], hz = R.halfsize[2];
  float* r = c.scr + R.rec;
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
      resolve(H, bodies, s, a, R.b, cpos, nrm, pen, r + 12 * q);
      continue;
    }
    V3 j, tq;
    resolve_a(H, cpos, spos(s, a), va, aa, nrm, pen, R.invm_a, R.inertia_a, &j, &tq);
    Jrow = add(Jrow, j);
    Trow = add(Trow, tq);
  }
  if (!R.b_moves) {
    put3(r, Jrow);
    put3(r + 3, Trow);
  }
}

// ---- the phases of a control step ------------------------------------------

// lanes stride over the env's contiguous input words: the slots' state into
// the snapshot, the actions into the scratch
WS_FN void phase_load(int lane, Own&, const Ctx& c) {
  const Header& H = *c.T.H;
  Snap& S = snap_mut(c);
  const int n = H.n_bodies;
  for (int w = lane; w < 3 * n; w += kLanes) {
    const int k = w / 3, slot = c.T.slot_of[k];
    if (slot < 0) continue;
    const int e = 3 * slot + (w - 3 * k);
    S.pos[e] = c.io.pos[w];
    S.vel[e] = c.io.vel[w];
    S.ang[e] = c.io.ang[w];
  }
  for (int w = lane; w < 4 * n; w += kLanes) {
    const int slot = c.T.slot_of[w >> 2];
    if (slot >= 0) S.rot[4 * slot + (w & 3)] = c.io.rot[w];
  }
  for (int w = lane; w < H.n_act; w += kLanes) c.scr[H.off_act + w] = c.io.act[w];
}

// owner lanes take their slot's state into registers
WS_FN void phase_adopt(int lane, Own& o, const Ctx& c) {
  if (lane >= c.T.H->n_slots) return;
  const Snap& s = snap(c);
  o.pos = spos(s, lane);
  o.vel = svel(s, lane);
  o.ang = sang(s, lane);
  o.rot = srot(s, lane);
WS_UNROLL
  for (int f = 0; f < 6; ++f) o.info[f] = V3{0.0f, 0.0f, 0.0f};
}

// 1. joints, then thrusters: each lane writes its rows' records
WS_FN void phase_forces(int lane, Own&, const Ctx& c) {
  for (int k = lane; k < c.T.H->n_joints; k += kLanes) joint_row(c, k);
  for (int k = lane; k < c.T.H->n_thr; k += kLanes) thruster_row(c, k);
}

// 2. owner lanes gather their forces in order, integrate (potential +
// kinetic, per-axis masks), publish the new pose and compute their
// capsules' world endpoints
WS_FN void phase_integrate(int lane, Own& o, const Ctx& c) {
  const Header& H = *c.T.H;
  if (lane >= H.n_slots) return;
  const Body& bd = c.T.bodies[lane];
  V3 fv = {0.0f, 0.0f, 0.0f}, fw = fv, av = fv, aw = fv;
  for (int g = bd.force_lo; g < bd.force_hi; ++g) {
    const int e = c.T.gather[g], kind = g_kind(e);
    const float* r = c.scr + g_off(e);
    if (kind == kThrust) {
      av = add(av, v3(r));
      continue;
    }
    fv = add(fv, v3(r));
    fw = add(fw, v3(r + 3));
    if (kind == kJointAct) aw = add(aw, v3(r + 6));
  }
  V3 tv = add(add(fv, av), v3(H.gravity));
  V3 ta = add(fw, aw);
WS_UNROLL
  for (int k = 0; k < 3; ++k) {
    if (bd.active_pos[k] > 0.0f) at(o.vel, k) = H.vel_damp * at(o.vel, k) + at(tv, k) * H.h;
    if (bd.active_rot[k] > 0.0f) at(o.ang, k) = H.ang_damp * at(o.ang, k) + at(ta, k) * H.h;
  }
WS_UNROLL
  for (int k = 0; k < 3; ++k) {
    if (bd.active_pos[k] > 0.0f) at(o.pos, k) = at(o.pos, k) + at(o.vel, k) * H.h;
  }
  if (bd.rot_free) {
    Q4 r = o.rot;
    Q4 dq = qmul(Q4{0.0f, o.ang.x, o.ang.y, o.ang.z}, r);
    float nw = r.w + H.half_h * dq.w;
    float nx = r.x + H.half_h * dq.x;
    float ny = r.y + H.half_h * dq.y;
    float nz = r.z + H.half_h * dq.z;
    float inv_n = rsqrt_(nw * nw + nx * nx + ny * ny + nz * nz);
    o.rot = Q4{nw * inv_n, nx * inv_n, ny * inv_n, nz * inv_n};
  }
  if (!H.info_contact) {  // uniform over the warp: from the tables
    o.info[2] = add(o.info[2], fv);
    o.info[3] = add(o.info[3], fw);
    o.info[4] = add(o.info[4], av);
    o.info[5] = add(o.info[5], aw);
  }
  Snap& S = snap_mut(c);
  put3(S.pos + 3 * lane, o.pos);
  put4(S.rot + 4 * lane, o.rot);
  put3(S.vel + 3 * lane, o.vel);
  put3(S.ang + 3 * lane, o.ang);
  const Q4 q = bd.frozen ? q4(bd.default_rot) : o.rot;
  for (int k = bd.cap_lo; k < bd.cap_hi; ++k) {
    const Capsule& C = c.T.caps[k];
    put3(c.scr + C.rec, add(o.pos, qrot(v3(C.e0), q)));
    put3(c.scr + C.rec + 3, add(o.pos, qrot(v3(C.e1), q)));
  }
}

// 3. contacts on the updated pose: each lane writes its rows' records
WS_FN void phase_contacts(int lane, Own&, const Ctx& c) {
  const Header& H = *c.T.H;
  for (int k = lane; k < H.n_pp; k += kLanes) point_plane_row(c, k);
  for (int k = lane; k < H.n_ss; k += kLanes) sphere_sphere_row(c, k);
  for (int k = lane; k < H.n_cc; k += kLanes) capsule_capsule_row(c, k);
  for (int k = lane; k < H.n_cb; k += kLanes) capsule_box_row(c, k);
}

// 4. owner lanes gather their impulses in order, apply them on the active
// axes, add to the contact Info and publish the new velocities
WS_FN void phase_apply(int lane, Own& o, const Ctx& c) {
  if (lane >= c.T.H->n_slots) return;
  const Body& bd = c.T.bodies[lane];
  V3 dv = {0.0f, 0.0f, 0.0f}, dw = dv;
  for (int g = bd.contact_lo; g < bd.contact_hi; ++g) {
    const int e = c.T.gather[g];
    const float* r = c.scr + g_off(e);
    if (g_kind(e) == kFlush) {
      V3 sj = {0.0f, 0.0f, 0.0f}, st = sj;
      for (int i = 0, n = g_count(e); i < n; ++i, r += 6) {
        sj = add(sj, v3(r));
        st = add(st, v3(r + 3));
      }
      dv = add(dv, scale(sj, bd.inv_mass));
      dw = add(dw, mul(bd.inv_inertia, st));
      continue;
    }
    dv = add(dv, v3(r));
    dw = add(dw, v3(r + 3));
  }
WS_UNROLL
  for (int k = 0; k < 3; ++k) {
    if (bd.active_pos[k] > 0.0f) at(o.vel, k) = at(o.vel, k) + at(dv, k);
    if (bd.active_rot[k] > 0.0f) at(o.ang, k) = at(o.ang, k) + at(dw, k);
  }
  o.info[0] = add(o.info[0], dv);
  o.info[1] = add(o.info[1], dw);
  Snap& S = snap_mut(c);
  put3(S.vel + 3 * lane, o.vel);
  put3(S.ang + 3 * lane, o.ang);
}

// owner lanes stage their Info sums in the scratch for the store
WS_FN void phase_stage(int lane, Own& o, const Ctx& c) {
  const Header& H = *c.T.H;
  if (lane >= H.n_slots) return;
  float* r = c.scr + H.off_info + 18 * lane;
  const int n_info = H.info_contact ? 2 : 6;
WS_UNROLL
  for (int f = 0; f < 6; ++f) {
    if (f < n_info) put3(r + 3 * f, o.info[f]);
  }
}

// lanes stride over the env's contiguous output words: a slot's from the
// snapshot and the staged Info; a body that passes through keeps its input
// state, with zero Info
WS_FN void phase_store(int lane, Own&, const Ctx& c) {
  const Header& H = *c.T.H;
  if (!c.io.store) return;
  const Snap& S = snap(c);
  const int n = H.n_bodies, n_info = H.info_contact ? 2 : 6;
  for (int w = lane; w < 3 * n; w += kLanes) {
    const int k = w / 3, slot = c.T.slot_of[k];
    if (slot < 0) {
      c.io.pos_out[w] = c.io.pos[w];
      c.io.vel_out[w] = c.io.vel[w];
      c.io.ang_out[w] = c.io.ang[w];
WS_UNROLL
      for (int f = 0; f < 6; ++f) {
        if (f < n_info) c.io.info[f][w] = 0.0f;
      }
      continue;
    }
    const int e = 3 * slot + (w - 3 * k);
    c.io.pos_out[w] = S.pos[e];
    c.io.vel_out[w] = S.vel[e];
    c.io.ang_out[w] = S.ang[e];
    const float* info = c.scr + H.off_info + 18 * slot + (w - 3 * k);
WS_UNROLL
    for (int f = 0; f < 6; ++f) {
      if (f < n_info) c.io.info[f][w] = info[3 * f];
    }
  }
  for (int w = lane; w < 4 * n; w += kLanes) {
    const int slot = c.T.slot_of[w >> 2];
    c.io.rot_out[w] = slot < 0 ? c.io.rot[w] : S.rot[4 * slot + (w & 3)];
  }
}

enum Phase { kLoad, kAdopt, kForces, kIntegrate, kContacts, kApply, kStage, kStore };

WS_FN void run_phase(Phase p, int lane, Own& o, const Ctx& c) {
  switch (p) {
    case kLoad: phase_load(lane, o, c); break;
    case kAdopt: phase_adopt(lane, o, c); break;
    case kForces: phase_forces(lane, o, c); break;
    case kIntegrate: phase_integrate(lane, o, c); break;
    case kContacts: phase_contacts(lane, o, c); break;
    case kApply: phase_apply(lane, o, c); break;
    case kStage: phase_stage(lane, o, c); break;
    case kStore: phase_store(lane, o, c); break;
  }
}

// The whole control step of one env. `Lanes::run(phase, ctx)` runs a phase
// on every lane and returns once all lanes are done with it: the CUDA
// kernel's lanes run their own lane each and __syncwarp(), the host build
// runs lanes 0..kLanes-1 one after another.
template <class Lanes>
WS_FN void step_env(Lanes& lanes, const Ctx& c) {
  lanes.run(kLoad, c);
  lanes.run(kAdopt, c);
  for (int step = 0; step < c.T.H->substeps; ++step) {
    lanes.run(kForces, c);
    lanes.run(kIntegrate, c);
    lanes.run(kContacts, c);
    lanes.run(kApply, c);
  }
  lanes.run(kStage, c);
  lanes.run(kStore, c);
}

// env b's slices of the batch-first arrays: pos/vel/ang (B, n, 3), rot
// (B, n, 4), act (B, A), the six Info arrays (B, n, 3); with contact Info
// only, info[2..5] may be null and are not written
WS_FN Io io_of(const Header& H, long long b, const float* pos, const float* rot,
               const float* vel, const float* ang, const float* act, float* pos_out,
               float* rot_out, float* vel_out, float* ang_out, float* const* info) {
  const long long o3 = b * H.n_bodies * 3, o4 = b * H.n_bodies * 4;
  Io io;
  io.pos = pos + o3;
  io.rot = rot + o4;
  io.vel = vel + o3;
  io.ang = ang + o3;
  io.act = act + b * H.n_act;
  io.pos_out = pos_out + o3;
  io.rot_out = rot_out + o4;
  io.vel_out = vel_out + o3;
  io.ang_out = ang_out + o3;
WS_UNROLL
  for (int f = 0; f < 6; ++f) io.info[f] = info[f] ? info[f] + o3 : nullptr;
  io.store = true;
  return io;
}

}  // namespace ws
