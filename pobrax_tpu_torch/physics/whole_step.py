"""The whole-step CUDA kernel: its build, its launch wrapper and its cost.

Replaces the TPU's Pallas whole-step kernel
(`pobrax_tpu/physics/pallas_step.py::make_pallas_batched_step`, the
`pl.pallas_call` at pallas_step.py:119): one full control step — every
substep of joints, actuators, integration and contacts, plus the Info sums —
in one launch, one thread per environment. The CUDA source is
`csrc/whole_step.cuh` (the per-env step, also built for the host by the
tests) and `csrc/whole_step.cu` (the kernel and its C launch function).

`whole_step(sys, qp, act)` is the wrapper `System.step` calls. On CPU
tensors it runs the plain version, `System.step_generic`; on CUDA tensors it
launches the kernel or raises — there is no fallback. The public layout stays
batch-first, as the JAX wrapper's was at its boundary; each thread reads its
env's contiguous (n, 3) / (n, 4) slices directly.

The kernel is built at first use with nvcc into `build/` at the root of the
checkout, as a shared library with a plain C interface loaded by ctypes
(no PyTorch headers, so the build takes seconds), cached by a hash of the
sources and flags. `launches` counts kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from pobrax_tpu_torch.physics import step_tables
from pobrax_tpu_torch.physics.state import Info, P, QP

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
SOURCES = ("whole_step.cuh", "whole_step.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# kernel launches since import (or since a caller last set it to 0)
launches = 0

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
    got = (ctypes.c_int * 8)()
    n = lib.ws_layout_words(got)
    want = [step_tables.words(s) for s in step_tables.STRUCTS]
    if list(got[:n]) != want:
        raise RuntimeError(f"whole-step kernel: table layout {list(got[:n])} in the library "
                           f"!= {want} in step_tables.py")


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, once per process."""
    global _lib
    if _lib is None:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        lib.ws_whole_step.argtypes = ([ctypes.c_void_p, ctypes.c_int]
                                      + [ctypes.c_void_p] * 15 + [ctypes.c_void_p])
        lib.ws_whole_step.restype = ctypes.c_int
        lib.ws_layout_words.argtypes = [ctypes.c_void_p]
        lib.ws_layout_words.restype = ctypes.c_int
        _check_layout(lib)
        _lib = lib
    return _lib


def device_tables(sys, device: torch.device) -> torch.Tensor:
    """The System's packed constant tables on `device`, built once."""
    cache: Dict = sys._step_tables or {}
    if device not in cache:
        cache[device] = torch.from_numpy(step_tables.pack(step_tables.build(sys))).to(device)
        sys._step_tables = cache
    return cache[device]


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
    outs = [torch.empty((B, n, k), device=dev) for k in _OUT_WIDTHS]
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.ws_whole_step(tables.data_ptr(), B, qp.pos.data_ptr(), qp.rot.data_ptr(),
                            qp.vel.data_ptr(), qp.ang.data_ptr(), act.data_ptr(),
                            *[o.data_ptr() for o in outs], stream)
    if err != 0:
        raise RuntimeError(f"whole-step kernel launch failed with CUDA error {err}")
    launches += 1
    p, r, v, a, cv, ca, jv, ja, av, aa = outs
    return (QP(pos=p, rot=r, vel=v, ang=a),
            Info(contact=P(vel=cv, ang=ca), joint=P(vel=jv, ang=ja), actuator=P(vel=av, ang=aa)))


# ---- the work one launch must do, for the bound ----------------------------

# fp32 operations of each piece of csrc/whole_step.cuh, counted from the
# source: add, sub, mul, div, min, max, abs, sqrt, rsqrt and atan2 count one
# each (a fused multiply-add two, as in the card's 67 TFLOP/s peak); compares
# and selects are not counted. Building blocks: V3 add/scale 3, dot 5,
# cross 9, qmul 28, qrot 30, to_local/to_world 15, resolve_a 89.
OPS_JOINT = 328            # spring, alignment, limit, damping, force sums
OPS_ACTUATOR = 18          # torque actuator on a hinge
OPS_BODY_FORCES = 9        # total_v / total_a of a body that moves
OPS_AXIS_VEL, OPS_AXIS_POS, OPS_AXIS_ROT = 3, 2, 3  # per active axis
OPS_ROT_INTEGRATE = 48     # quaternion derivative and renormalisation
OPS_BODY_CONTACT = 1       # per active axis: vel/ang += impulse
OPS_BODY_INFO = 18         # six Info sums per body
OPS_PP_ROW = 146           # world point, penetration, resolve_a, row sums
OPS_CB_CAPSULE = 66        # world endpoints of a capsule, once per capsule
OPS_CB_ROW = 68            # box-frame segment and row sums
OPS_CB_SAMPLE = 183        # point-box SDF and resolve_a, 3 samples per row
OPS_FLUSH = 12             # per body per contact phase


def cost(sys, B: int) -> Dict[str, float]:
    """Operations and bytes one launch needs for `B` envs of `sys`: each
    input read once, each output written once; the kernel is branch-free in
    the data, so the count does not depend on the state."""
    t = step_tables.build(sys)
    n = t["n_bodies"]
    ops = 0
    for j in t["joints"]:
        ops += OPS_JOINT + (OPS_ACTUATOR if j["act_idx"] >= 0 else 0)
    for i in range(n):
        ap, ar = t["active_pos"][i] > 0, t["active_rot"][i] > 0
        if ap.any() or ar.any():
            ops += OPS_BODY_FORCES
        ops += ap.sum() * (OPS_AXIS_VEL + OPS_AXIS_POS) + ar.sum() * OPS_AXIS_ROT
        ops += OPS_ROT_INTEGRATE * int(ar.any())
        ops += (ap.sum() + ar.sum()) * OPS_BODY_CONTACT + OPS_BODY_INFO
    if t["pp_vec"]:
        pv = t["pp_vec"]
        ops += len(pv["points"]) * OPS_PP_ROW + len(pv["body_slices"]) * OPS_FLUSH
    if t["cb_vec"]:
        cv = t["cb_vec"]
        ops += (len(cv["caps"]) * OPS_CB_CAPSULE
                + int(cv["cap_repeats"].sum()) * (OPS_CB_ROW + 3 * OPS_CB_SAMPLE)
                + len(cv["body_slices"]) * OPS_FLUSH)
    ops *= t["substeps"] * B
    words_in = B * (n * (3 + 4 + 3 + 3) + t["n_act"])
    words_out = B * n * (3 + 4 + 3 + 3 + 6 * 3)
    table_bytes = step_tables.pack(t).nbytes
    return {"flops": float(ops), "bytes": float(4 * (words_in + words_out) + table_bytes)}


def bound_ms(sys, B: int, peak_flops: float = 67e12, peak_bytes: float = 3.35e12):
    """(least time in ms, "operations" or "bytes") on an H100 SXM: fp32
    67 TFLOP/s outside the tensor cores, HBM3 3.35 TB/s (NVIDIA data sheet)."""
    c = cost(sys, B)
    t_ops, t_bytes = c["flops"] / peak_flops, c["bytes"] / peak_bytes
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")
