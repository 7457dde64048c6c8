"""The whole-step CUDA kernel: its build, its launch wrapper and its cost.

Replaces the TPU's Pallas whole-step kernel
(`pobrax_tpu/physics/pallas_step.py::make_pallas_batched_step`, the
`pl.pallas_call` at pallas_step.py:119): one full control step — every
substep of joints, actuators, integration and contacts, plus the Info sums —
in one launch. The CUDA source is `csrc/whole_step.cuh` (the per-env step as
phases over an env's lanes, also built for the host by the tests) and
`csrc/whole_step.cu` (the kernel and its C launch function).

What bounds it, and the design. The step is operation-bound on every
contact-heavy System (`cost`, `bound_ms`), but what sets its pace is
latency: a chain of dependent arithmetic per env. The kernel therefore runs
each env on 16 lanes of a warp (two envs per warp, ENVS_PER_BLOCK per
block), so 4096 envs give 2048 warps, one wave at 16 warps per SM, and each
SM switches between many. Lane i owns slot i: the body's state, Info sums
and accumulators stay in its registers. Joints, thrusters and contact rows
are spread over the lanes, which write one result record each into the
env's scratch in shared memory; owner lanes then gather their records in the
order fused.py adds them (`step_tables.pack`), so the sums are fused.py's.
The System's tables are staged in shared memory once per block.

`whole_step(sys, qp, act)` is the wrapper `System.step` calls. On CPU
tensors it runs the plain version, `System.step_generic`; on CUDA tensors it
launches the kernel or raises — there is no fallback. A System whose tables
and scratch do not fit one block's shared memory raises ValueError before the
launch. The public layout stays batch-first, as the JAX wrapper's was at its
boundary; each env's lanes read and write its contiguous (n, 3) / (n, 4)
slices lane by lane.

The kernel is built at first use with nvcc into `build/` at the root of the
checkout, as a shared library with a plain C interface loaded by ctypes
(no PyTorch headers, so the build takes seconds), cached by a hash of the
sources and flags. `launches` counts kernel launches and nothing else.

A System built with `info="contact"` steps with the contact-only Info
variant: the kernel skips the joint and actuator sums and leaves those four
arrays unwritten, and the wrapper returns `P.zero_view` for them (one zero,
expanded: no bytes, and torch refuses in-place writes to it).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from pobrax_tpu_torch.physics import step_tables
from pobrax_tpu_torch.physics.state import Info, P, QP

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
SOURCES = ("whole_step.cuh", "whole_step.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# kernel launches since import (or since a caller last set it to 0), and the
# same launches per (substeps, batch) of the launching System
launches = 0
launches_by_shape: dict = {}

_lib: Optional[ctypes.CDLL] = None
_OUT_WIDTHS = (3, 4, 3, 3, 3, 3, 3, 3, 3, 3)  # qp x4, Info contact/joint/actuator


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("whole-step kernel: nvcc not found (set CUDA_HOME or PATH)")


def library_path() -> Path:
    """Where the build of the current sources and flags lives."""
    digest = hashlib.sha256()
    for name in SOURCES:
        digest.update((CSRC / name).read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"whole_step-{digest.hexdigest()[:16]}.so"


def build() -> Tuple[Path, str]:
    """Compile the kernel if this version is not built yet; returns the
    library's path and nvcc's log (ptxas registers, spills)."""
    out = library_path()
    log_path = out.with_suffix(".log")
    if out.exists():
        return out, log_path.read_text() if log_path.exists() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / "whole_step.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"whole-step kernel build failed:\n{' '.join(cmd)}\n{proc.stderr}")
    log_path.write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out, proc.stdout + proc.stderr


def _check_layout(lib: ctypes.CDLL) -> None:
    got = (ctypes.c_int * 16)()
    n = lib.ws_layout_words(got)
    want = [step_tables.words(s) for s in step_tables.STRUCTS]
    if list(got[:n]) != want:
        raise RuntimeError(f"whole-step kernel: table layout {list(got[:n])} in the library "
                           f"!= {want} in step_tables.py")
    if lib.ws_envs_per_block() != step_tables.ENVS_PER_BLOCK:
        raise RuntimeError(f"whole-step kernel: {lib.ws_envs_per_block()} envs per block in the "
                           f"library != {step_tables.ENVS_PER_BLOCK} in step_tables.py")


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, once per process."""
    global _lib
    if _lib is None:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        lib.ws_whole_step.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 3
                                      + [ctypes.c_void_p] * 15 + [ctypes.c_void_p])
        lib.ws_whole_step.restype = ctypes.c_int
        lib.ws_resident_warps.argtypes = [ctypes.c_int, ctypes.c_void_p]
        lib.ws_resident_warps.restype = ctypes.c_int
        lib.ws_envs_per_block.restype = ctypes.c_int
        lib.ws_layout_words.argtypes = [ctypes.c_void_p]
        lib.ws_layout_words.restype = ctypes.c_int
        _check_layout(lib)
        _lib = lib
    return _lib


def _tables(sys) -> Dict:
    """The System's step tables, built once: the packed buffer on the host
    ("host"), its per-env scratch words and the shared memory one block
    needs, and the buffer on each device it was launched on."""
    cache: Dict = sys._step_tables or {}
    if "host" not in cache:
        buf = step_tables.pack(step_tables.build(sys))
        cache.update(host=buf, scratch_words=step_tables.scratch_words(buf),
                     shared_bytes=step_tables.shared_bytes(buf))
        sys._step_tables = cache
    return cache


def packed_tables(sys) -> np.ndarray:
    """The System's packed constant tables on the host, built once."""
    return _tables(sys)["host"]


def shared_bytes(sys) -> int:
    """Shared memory one block of the kernel needs for `sys`: its tables
    plus one scratch for each of the block's envs."""
    return _tables(sys)["shared_bytes"]


def check_fits(sys) -> Dict:
    """The step tables of `sys` (`_tables`); raises ValueError for a System
    the kernel cannot hold (more than MAX_BODIES touched bodies, or more
    shared memory than one block has)."""
    cache = _tables(sys)
    if cache["shared_bytes"] > step_tables.SHARED_LIMIT:
        raise ValueError(f"whole-step kernel: the System needs {cache['shared_bytes']} bytes of "
                         f"shared memory a block (tables + {step_tables.ENVS_PER_BLOCK} env "
                         f"scratches), more than the {step_tables.SHARED_LIMIT} an H100 block has")
    return cache


def device_tables(sys, device: torch.device) -> torch.Tensor:
    """The System's packed constant tables on `device`, built once."""
    cache = _tables(sys)
    if device not in cache:
        cache[device] = torch.from_numpy(cache["host"]).to(device)
    return cache[device]


def resident_warps(sys) -> int:
    """Warps of the kernel one SM holds at once for `sys` (registers and the
    System's shared memory permitting), from the CUDA occupancy calculator."""
    warps = ctypes.c_int(0)
    err = load_library().ws_resident_warps(shared_bytes(sys), ctypes.byref(warps))
    if err != 0:
        raise RuntimeError(f"whole-step kernel: occupancy query failed with CUDA error {err}")
    return warps.value


def _check(name: str, t: torch.Tensor, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"whole-step kernel: {name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise ValueError(f"whole-step kernel: {name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"whole-step kernel: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"whole-step kernel: {name} must be contiguous")


def whole_step(sys, qp: QP, act: torch.Tensor) -> Tuple[QP, Info]:
    """One control step of `sys` for a batch: the kernel on CUDA tensors,
    `sys.step_generic` (the plain version) on CPU tensors."""
    if not qp.pos.is_cuda:
        return sys.step_generic(qp, act)
    return launch(sys, qp, act)


def launch(sys, qp: QP, act: torch.Tensor) -> Tuple[QP, Info]:
    """Launch the kernel on CUDA tensors: pos/vel/ang (B, n, 3), rot (B, n, 4),
    act (B, action_size), all float32 and contiguous."""
    global launches
    cache = check_fits(sys)  # raises ValueError for a System it cannot hold
    dev = qp.pos.device
    if dev.type != "cuda":
        raise ValueError(f"whole-step kernel: tensors must be on a CUDA device, got {dev}")
    B, n = qp.pos.shape[0], sys.num_bodies
    tables = device_tables(sys, dev)
    _check("qp.pos", qp.pos, (B, n, 3), dev)
    _check("qp.rot", qp.rot, (B, n, 4), dev)
    _check("qp.vel", qp.vel, (B, n, 3), dev)
    _check("qp.ang", qp.ang, (B, n, 3), dev)
    _check("act", act, (B, sys.action_size), dev)
    lib = load_library()
    widths = _OUT_WIDTHS[:6] if sys.info_mode == "contact" else _OUT_WIDTHS
    outs = [torch.empty((B, n, k), device=dev) for k in widths]
    ptrs = [o.data_ptr() for o in outs] + [None] * (len(_OUT_WIDTHS) - len(outs))
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.ws_whole_step(tables.data_ptr(), cache["host"].size, cache["scratch_words"], B,
                            qp.pos.data_ptr(), qp.rot.data_ptr(), qp.vel.data_ptr(),
                            qp.ang.data_ptr(), act.data_ptr(), *ptrs, stream)
    if err != 0:
        raise RuntimeError(f"whole-step kernel launch failed with CUDA error {err}")
    launches += 1
    shape = (sys.config.substeps, B)
    launches_by_shape[shape] = launches_by_shape.get(shape, 0) + 1
    return unpack(sys, outs)


def unpack(sys, outs) -> Tuple[QP, Info]:
    """(QP, Info) of the kernel's output arrays: pos, rot, vel, ang, contact
    vel / ang, then joint and actuator vel / ang unless the System keeps
    contact Info only, where those four are zero views."""
    p, r, v, a, cv, ca = outs[:6]
    if sys.info_mode == "contact":
        joint = actuator = P.zero_view(cv)
    else:
        jv, ja, av, aa = outs[6:]
        joint, actuator = P(vel=jv, ang=ja), P(vel=av, ang=aa)
    return QP(pos=p, rot=r, vel=v, ang=a), Info(contact=P(vel=cv, ang=ca), joint=joint,
                                                 actuator=actuator)


# ---- the work one launch must do, for the bound ----------------------------

# fp32 operations of each piece of csrc/whole_step.cuh, counted from the
# source: add, sub, mul, div, min, max, abs, sqrt, rsqrt, atan2 and asin
# count one each (a fused multiply-add two, as in the card's 67 TFLOP/s peak);
# compares, selects and negations are not counted. Building blocks: V3
# add/scale 3, dot 5, cross 9, qmul 28, qrot 30, to_local/to_world 15,
# quat_mat 39, resolve_a 89, resolve 126 plus 21 (body a) and 24 (body b)
# for each side that moves. A row's lane computes its terms and the body's
# owner lane adds them into its accumulators (the gather), so each piece
# below counts both halves: the gather adds are the sums the serial loops
# took, no more. Capsule endpoints are computed once per distinct capsule,
# by its body's owner lane.
OPS_JOINT = 252            # frames, spring, damping, force and torque sums
OPS_JOINT_DOF = 40         # per dof: world axis and limit torque
OPS_ALIGN = {1: 37, 2: 35, 3: 0}     # alignment torque, by dof
OPS_ANGLES = {1: 2, 2: 27, 3: 27}    # hinge atan2, or the Euler readout
OPS_ACTUATOR = 12          # an actuated joint's torque sums
OPS_ACT_DOF = {0: 9, 1: 10}          # per dof: torque (0) or angle servo (1)
OPS_THRUSTER = 10
OPS_BODY_FORCES = 9        # total_v / total_a of a body that moves
OPS_AXIS_VEL, OPS_AXIS_POS, OPS_AXIS_ROT = 3, 2, 3  # per active axis
OPS_ROT_INTEGRATE = 48     # quaternion derivative and renormalisation
OPS_BODY_CONTACT = 1       # per active axis: vel/ang += impulse
OPS_BODY_INFO = 18         # six Info sums per body; 6 with contact Info only
OPS_RESOLVE, OPS_RESOLVE_SIDE = 126, (21, 24)  # two-body impulse; body a, body b
OPS_PP_ROW = 146           # frozen plane: world point, penetration, resolve_a, sums
OPS_PP_MOVING_ROW = 111    # moving plane: the same with the plane turned, plus resolve
OPS_SS_ROW = 92            # two world centres and the contact, plus resolve
OPS_CC_ROW = 226           # four world endpoints, closest points, contact, plus resolve
OPS_CB_CAPSULE = 66        # world endpoints of a capsule, once per capsule
OPS_CB_ROW = 68            # frozen box: box-frame segment and row sums
OPS_CB_MOVING_ROW = 159    # moving box: its frame each substep, box-frame segment
OPS_CB_SAMPLE = 183        # frozen box: point-box SDF, resolve_a, sums; 3 per row
OPS_CB_SDF = 88            # moving box: point-box SDF, plus resolve; 3 per row
OPS_FLUSH = 12             # per body per contact phase


def _resolve_ops(t: Dict, a: int, b: int) -> int:
    moves = [t["inv_mass"][a] != 0.0, t["inv_mass"][b] != 0.0]
    return OPS_RESOLVE + sum(side for side, m in zip(OPS_RESOLVE_SIDE, moves) if m)


def cost(sys, B: int) -> Dict[str, float]:
    """Operations and bytes one launch needs for `B` envs of `sys`: each
    input read once (the tables once, though each block stages its own copy),
    each output written once; the kernel is branch-free in the state (its
    branches follow the tables), so the count does not depend on the data.
    A body that passes through costs its bytes and no operation; the
    contact-only variant drops the 12 joint and actuator Info sums per
    body and those four arrays, which it does not write."""
    t = step_tables.build(sys)
    n = t["n_bodies"]
    info_words = 6 if t["info_contact"] else 18
    ops = 0
    for j in t["joints"]:
        dof = j["dof"]
        ops += OPS_JOINT + dof * OPS_JOINT_DOF + OPS_ALIGN[dof] + OPS_ANGLES[dof]
        if j["act_idx"] >= 0:
            ops += OPS_ACTUATOR + dof * OPS_ACT_DOF[j["act_kind"]]
    ops += len(t["thrusters"]) * OPS_THRUSTER
    for i in t["slots"]:
        ap, ar = t["active_pos"][i] > 0, t["active_rot"][i] > 0
        if ap.any() or ar.any():
            ops += OPS_BODY_FORCES
        ops += ap.sum() * (OPS_AXIS_VEL + OPS_AXIS_POS) + ar.sum() * OPS_AXIS_ROT
        ops += OPS_ROT_INTEGRATE * int(ar.any())
        ops += (ap.sum() + ar.sum()) * OPS_BODY_CONTACT + OPS_BODY_INFO * info_words // 18
    for r in t["pp_moving"]:
        ops += OPS_PP_MOVING_ROW + _resolve_ops(t, r["a"], r["b"])
    if t["pp_vec"]:
        pv = t["pp_vec"]
        ops += len(pv["points"]) * OPS_PP_ROW + len(pv["body_slices"]) * OPS_FLUSH
    for r in t["ss_rows"]:
        ops += OPS_SS_ROW + _resolve_ops(t, r["a"], r["b"])
    for r in t["cc_rows"]:
        ops += OPS_CC_ROW + _resolve_ops(t, r["a"], r["b"])
    ops += len(step_tables.capsules(t)) * OPS_CB_CAPSULE
    for r in t["cb_moving"]:
        ops += OPS_CB_MOVING_ROW + 3 * (OPS_CB_SDF + _resolve_ops(t, r["a"], r["b"]))
    if t["cb_vec"]:
        cv = t["cb_vec"]
        ops += (int(cv["cap_repeats"].sum()) * (OPS_CB_ROW + 3 * OPS_CB_SAMPLE)
                + len(cv["body_slices"]) * OPS_FLUSH)
    ops *= t["substeps"] * B
    words_in = B * (n * (3 + 4 + 3 + 3) + t["n_act"])
    words_out = B * n * (3 + 4 + 3 + 3 + info_words)
    table_bytes = step_tables.pack(t).nbytes
    return {"flops": float(ops), "bytes": float(4 * (words_in + words_out) + table_bytes)}


def bound_ms(sys, B: int, peak_flops: float = 67e12, peak_bytes: float = 3.35e12):
    """(least time in ms, "operations" or "bytes") on an H100 SXM: fp32
    67 TFLOP/s outside the tensor cores, HBM3 3.35 TB/s (NVIDIA data sheet)."""
    c = cost(sys, B)
    t_ops, t_bytes = c["flops"] / peak_flops, c["bytes"] / peak_bytes
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")
