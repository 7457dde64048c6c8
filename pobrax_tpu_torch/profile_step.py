"""Where one env step's time goes on the GPU: `python -m pobrax_tpu_torch.profile_step`.

Runs a main path — `create(env, batch_size=4096, episode_length=1000,
randomized_autoreset=True, autoreset_mode=...)` on CUDA with on-device random
actions, AntTag unless `--env` names another env, under
`MaskedObservationWrapper(hidden=("VELOCITY",))` with `--masked` (`bench.py`'s
masked_<name>) — warms it up, times `--steps` steps without the profiler, then
traces `TRACE_STEPS` more with `torch.profiler` (a naive step launches ~20k
kernels, so the trace stays short) and prints, per env step: host wall time,
summed device kernel time, the device's idle share (1 - kernel time / wall
time), the number of kernel launches, and the kernels that take the most
device time. Also prints the card's name and power limit. Needs a CUDA
device.

    python -m pobrax_tpu_torch.profile_step [--env NAME] [--masked] [--mode cached|naive|both]
                                            [--steps N] [--batch B]
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

from pobrax_tpu_torch import random as jr
from pobrax_tpu_torch.envs import MaskedObservationWrapper, create

TRACE_STEPS = 5


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def profile_mode(env_name: str, masked: bool, mode: str, steps: int, batch: int,
                 warmup: int = 10) -> None:
    dev = torch.device("cuda")
    env = create(env_name, batch_size=batch, episode_length=1000, randomized_autoreset=True,
                 autoreset_mode=mode, device=dev)
    if masked:
        env = MaskedObservationWrapper(env, env_name=env_name, hidden=("VELOCITY",))
    tag = f"{'masked_' if masked else ''}{env_name}:{mode}"
    s = env.reset(jr.PRNGKey(0, dev))
    g = torch.Generator(device=dev).manual_seed(0)

    def run(n):
        nonlocal s
        for _ in range(n):
            s = env.step(s, torch.rand(batch, env.action_size, generator=g, device=dev) * 2 - 1)

    run(warmup)
    torch.cuda.synchronize()
    t0 = time.perf_counter()  # wall time without the profiler's own overhead
    run(steps)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(TRACE_STEPS)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / TRACE_STEPS
    print(f"[profile:{tag}] B={batch}: wall {wall_ms:.4f} ms/step over {steps} steps; device "
          f"kernels {busy_ms:.4f} ms/step over {TRACE_STEPS} traced steps, idle share "
          f"{(1 - busy_ms / wall_ms) if kernels else float('nan'):.4f}, "
          f"{len(kernels) / TRACE_STEPS:.1f} kernel launches/step", flush=True)
    if not kernels:
        print(f"[profile:{tag}] no device events traced: device time not measured", flush=True)
        return
    by_name = {}
    for e in kernels:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    for name, (t_us, n) in top:
        print(f"[profile:{tag}]   {t_us / 1e3 / TRACE_STEPS:9.4f} ms/step  "
              f"{n / TRACE_STEPS:6.1f}/step  {name[:90]}", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--env", default="ant_tag")
    ap.add_argument("--masked", action="store_true")
    ap.add_argument("--mode", choices=("cached", "naive", "both"), default="both")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4096)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_step: no CUDA device available", file=sys.stderr)
        sys.exit(1)
    print(f"[profile] {_card()}", flush=True)
    for mode in (("cached", "naive") if args.mode == "both" else (args.mode,)):
        profile_mode(args.env, args.masked, mode, args.steps, args.batch)


if __name__ == "__main__":
    main()
