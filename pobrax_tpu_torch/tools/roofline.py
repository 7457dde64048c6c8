"""How far above the card's roofline the main path's step runs; the port of
`tools/roofline.py`.

Times `pobrax_tpu_torch.bench.rollout` (AntTag at 4096 envs, cached
autoreset, 200 steps: bench.py's program) as the JAX tool does, one warm-up
and the best of three, and sets it against the least time the card needs
for the whole-step kernel's work: `physics/whole_step.py`'s `cost` (fp32
operations, bytes moved) over the H100's published peaks, 67 TFLOP/s fp32
outside the tensor cores and 3.35 TB/s of HBM3 (NVIDIA H100 SXM data
sheet), keyed by `torch.cuda.get_device_name`, with the power limit beside
them. The floor counts the kernel's work only: torch has no cost model for
the rest of a step (task logic, autoreset, threefry draws), which XLA's
`cost_analysis` counted for the JAX tool. So `x_above_roofline` is the
step's time over the kernel's floor, and `kernel_share` is the kernel's
device time (`utils.profiling.device_ms`) over the step's.

Usage: python -m pobrax_tpu_torch.tools.roofline
Env overrides: ROOF_ENV, ROOF_BATCH, ROOF_STEPS, ROOF_AUTORESET. Prints one
JSON line. On the card; with no card and no device named it raises.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

import torch

from pobrax_tpu_torch import bench
from pobrax_tpu_torch import random as jr
from pobrax_tpu_torch.device import resolve
from pobrax_tpu_torch.physics import whole_step
from pobrax_tpu_torch.utils.profiling import device_ms, record_device

# per card: (fp32 TFLOP/s outside the tensor cores, bf16 dense tensor-core
# TFLOP/s, HBM GB/s); NVIDIA's H100 SXM data sheet
_PEAKS = {"NVIDIA H100 80GB HBM3": (67.0, 989.0, 3350.0)}


def peaks_for(kind: str):
    for k, v in _PEAKS.items():
        if kind.lower().startswith(k.lower()):
            return v
    return None


def main(environ: Optional[dict] = None, device=None, repeats: int = 3) -> dict:
    env_vars = os.environ if environ is None else environ
    dev = resolve(device)
    env_name = env_vars.get("ROOF_ENV", "ant_tag")
    batch = int(env_vars.get("ROOF_BATCH", "4096"))
    steps = int(env_vars.get("ROOF_STEPS", "200"))
    mode = env_vars.get("ROOF_AUTORESET", "cached")

    env = bench.make_env(env_name, batch, mode, device=dev)
    key = jr.PRNGKey(0, dev)
    state = env.reset(jr.split(key, batch))
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    state, key = bench.rollout(env, state, key, steps)  # warm-up
    sync()
    best_dt, launches = float("inf"), []
    for _ in range(repeats):
        n0 = whole_step.launches
        t0 = time.perf_counter()
        state, key = bench.rollout(env, state, key, steps)
        sync()
        best_dt = min(best_dt, time.perf_counter() - t0)
        launches.append(whole_step.launches - n0)

    sys_ = env.unwrapped.sys
    cost = whole_step.cost(sys_, batch)
    flops, nbytes = cost["flops"] * steps, cost["bytes"] * steps
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    per_step_dt = best_dt / steps
    out = {
        "env": env_name, "batch": batch, "steps": steps, "autoreset": mode,
        "device_kind": kind,
        "env_steps_per_s": round(batch * steps / best_dt, 1),
        "control_step_us": round(per_step_dt * 1e6, 2),
        "flops_per_env_step": round(flops / (batch * steps), 1),
        "bytes_per_env_step": round(nbytes / (batch * steps), 1),
        "achieved_tflops": round(flops / best_dt / 1e12, 4),
        "achieved_gbps": round(nbytes / best_dt / 1e9, 2),
        "launches_per_rollout": launches,
        "floor_counts": "the whole-step kernel's work only",
        **record_device(dev),
    }
    peaks = peaks_for(kind)
    if peaks:
        peak_f32, _, peak_bw = peaks
        flop_floor = flops / (peak_f32 * 1e12)
        bw_floor = nbytes / (peak_bw * 1e9)
        roof = max(flop_floor, bw_floor)
        qp = state.qp
        act = torch.zeros(batch, sys_.action_size, device=dev)
        kernel_ms = device_ms(lambda: whole_step.launch(sys_, qp, act))
        out.update({
            "peak_tflops_f32": peak_f32, "peak_hbm_gbps": peak_bw,
            "fp32_utilization_pct": round(100 * flops / best_dt / (peak_f32 * 1e12), 4),
            "hbm_utilization_pct": round(100 * nbytes / best_dt / (peak_bw * 1e9), 4),
            "compute_floor_us_per_step": round(flop_floor / steps * 1e6, 3),
            "bandwidth_floor_us_per_step": round(bw_floor / steps * 1e6, 3),
            "x_above_roofline": round(best_dt / roof, 1),
            "kernel_device_us_per_step": round(kernel_ms * 1e3, 3),
            "kernel_share": round(kernel_ms * 1e-3 / per_step_dt, 4),
            "kernel_x_above_roofline": round(kernel_ms * 1e-3 * steps / roof, 1),
            "bound": ("bandwidth" if bw_floor > flop_floor else "compute")
                     if best_dt < 3 * roof else "latency/serial-dependency",
        })
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
