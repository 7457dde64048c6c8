#!/usr/bin/env python3
"""Times the whole-step CUDA kernel of a checkout on one NVIDIA GPU:
`python3 time_kernel.py`. Its timing helpers are `pobrax_tpu_torch.utils.profiling`'s,
which `chip_smoke.py` and the benches use too, so that all read the kernel
the same way.

For each System, a batch of B=4096 envs is reset and stepped 20 plain steps
(contacts live), then one control step of random actions is launched for at
least 0.2 s of warm-up (so the SM clock has risen) and `--reps` times under
CUDA events (`cuda_ms`: ms per launch; where the wrapper's host work
outlasts the kernel, this is the host's pace), then 20 times queued behind a
sleep kernel, so that they run back to back (`device_ms`: the kernel's
device time). Prints both per System, the share of envs within pos/rot 1e-5
and vel/ang 1e-3 of the plain step (at B=4096 and on the first 4095 envs, a
ragged batch), and the card's name, power limit and SM clock.

    python3 time_kernel.py [--root DIR] [--systems ant_tag,ant_maze] [--reps 50]

--root DIR times the package of another checkout, say the parent commit
unpacked with `git archive` into a directory that .gitignore lists. Two
checkouts are compared on one card by alternating runs (A, B, B, A).
Imports no jax; needs a CUDA device.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

from pobrax_tpu_torch.utils.profiling import card_line, cuda_ms, device_ms, smi

HERE = Path(__file__).resolve().parent
SYSTEMS = ("ant_tag", "ant_heavenhell", "ant_gather", "ant_maze", "humanoid", "grasp", "fetch",
           "ur5e", "reacherangle", "inverted_double_pendulum")
B, WARM_STEPS = 4096, 20


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--systems", default=",".join(SYSTEMS))
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    if root != HERE:  # the timed package is the other checkout's; the helpers stay this one's
        for name in [m for m in sys.modules if m.split(".")[0] == "pobrax_tpu_torch"]:
            del sys.modules[name]
    sys.path.insert(0, str(root))
    from pobrax_tpu_torch import random as jr
    from pobrax_tpu_torch.envs import create
    from pobrax_tpu_torch.physics import whole_step

    if not torch.cuda.is_available():
        print("time_kernel: no CUDA device available", file=sys.stderr)
        sys.exit(1)
    card = card_line()
    label = "this checkout" if root == HERE else str(root)
    path, log = whole_step.build()
    whole_step.load_library()
    ptxas = [line.strip() for line in log.splitlines()
             if "registers" in line or "stack frame" in line]
    print(f"[time_kernel] {label}: {path.name}: {' | '.join(ptxas)}; {card}", flush=True)
    dev = torch.device("cuda")

    def agree(sys_, qp, act, batch):
        qp = qp.replace(**{f: getattr(qp, f)[:batch].contiguous()
                           for f in ("pos", "rot", "vel", "ang")})
        qk, _ = whole_step.launch(sys_, qp, act[:batch].contiguous())
        qg, _ = sys_.step_generic(qp, act[:batch].contiguous())
        err = lambda a, b: (a - b).abs().flatten(1).max(1).values
        ok = ((err(qk.pos, qg.pos) <= 1e-5) & (err(qk.rot, qg.rot) <= 1e-5)
              & (err(qk.vel, qg.vel) <= 1e-3) & (err(qk.ang, qg.ang) <= 1e-3))
        return 100 * float(ok.float().mean())

    for sys_name in args.systems.split(","):
        env = create(sys_name, episode_length=None, auto_reset=False, batch_size=B, device=dev)
        sys_ = env.sys
        qp = env.reset(jr.PRNGKey(5, dev)).qp
        g = torch.Generator(device=dev).manual_seed(5)
        for _ in range(WARM_STEPS):
            qp, _ = sys_.step_generic(qp, torch.rand(B, sys_.action_size, generator=g,
                                                     device=dev) * 2 - 1)
        act = torch.rand(B, sys_.action_size, generator=g, device=dev) * 2 - 1
        step = lambda: whole_step.launch(sys_, qp, act)
        launch_ms, kernel_ms = cuda_ms(step, args.reps), device_ms(step)
        print(f"[time_kernel:{sys_name}] {label}: {launch_ms:.4f} ms per launch, device "
              f"{kernel_ms:.4f} ms at B={B}; envs within tolerance "
              f"{agree(sys_, qp, act, B):.3f}%, at B={B - 1} {agree(sys_, qp, act, B - 1):.3f}%; "
              f"{card}, SM clock {smi('clocks.sm')}", flush=True)


if __name__ == "__main__":
    main()
