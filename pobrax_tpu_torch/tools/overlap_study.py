"""Can the card overlap a serial rollout chain with matmul work?; the port of
`tools/overlap_study.py`.

The question is the JAX tool's: if a latency-bound chain (the rollout's
shape) and matmul work (the SGD's) can run at once, a one-epoch-stale
pipelined PPO would hide the cheaper phase. Here it is asked of two CUDA
streams on one card:
  * chain — the whole-step kernel at 4096 AntTag envs, launched back to back
    on one stream, each launch stepping the state the last one returned
    (zero actions); on the card the chain must be the kernel: the JAX
    tool's chain of CHAIN_OPS x T_CHAIN separate elementwise ops would be
    ~3M launches of PyTorch ops and time the host, not the card;
  * mm — T_MM serial steps of `tanh(w @ w * 0.01)`, w 1024 x 1024, on a
    second stream;
  * both — the two at once, each on its stream.
Every timing holds its streams behind a sleep kernel while the host
enqueues the work, then releases them, so it is the device's time and not
the launches' (`held_ms`). If both ~= max(chain, mm) the overlap is real; if
both ~= chain + mm the card runs them one after the other.

`chain(x)` and `mm(w)` are the JAX tool's functions written as plain torch,
for the CPU parity test.

Usage: python -m pobrax_tpu_torch.tools.overlap_study [T_KERNEL] [T_MM]
(defaults 10000 launches, 3000 matmul steps). Prints one JSON line with the
device and the card's name and power limit. On the card; with no card and
no device named it raises.
"""

from __future__ import annotations

import json
import sys
from typing import Callable, Dict, Tuple

import torch

from pobrax_tpu_torch import random as jr
from pobrax_tpu_torch.device import resolve
from pobrax_tpu_torch.envs import create
from pobrax_tpu_torch.physics import whole_step
from pobrax_tpu_torch.utils.profiling import record_device

B = 4096  # rollout-like batch width
T_CHAIN = 10_000  # control steps in the chain
CHAIN_OPS = 100  # dependent op-groups per step of the JAX tool's chain
MM = 1024  # matmul size
T_MM = 3_000  # matmul steps


def chain(x: torch.Tensor, t_chain: int = T_CHAIN, chain_ops: int = CHAIN_OPS) -> torch.Tensor:
    """The JAX tool's `chain`: `t_chain` serial steps of `chain_ops`
    dependent elementwise op-groups; the sum."""
    y = x
    for _ in range(t_chain):
        for _ in range(chain_ops):
            y = y * 1.000001 + 0.5
            y = torch.where(y > 1.0, y - 1.0, y)
            y = y * y - 0.25 * y
    return y.sum()


def mm(w: torch.Tensor, t_mm: int = T_MM) -> torch.Tensor:
    """The JAX tool's `mm`: `t_mm` serial steps of tanh(w @ w * 0.01); the sum."""
    for _ in range(t_mm):
        w = torch.tanh(w @ w * 0.01)
    return w.sum()


def held_ms(work: Dict[torch.cuda.Stream, Callable[[], None]],
            cycles: int = 500_000_000) -> Tuple[float, int]:
    """Device ms of `work` (per stream, a function that enqueues its part):
    every stream waits on an event behind a sleep kernel of `cycles` (x4
    until it outlasts the host's enqueueing) while the host enqueues, so all
    parts start together when it ends; the time runs to the last stream's
    end. -> (ms, the cycles that held)."""
    main = torch.cuda.current_stream()
    for _ in range(6):
        go = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        go.record(main)
        ends = []
        for stream, fn in work.items():
            stream.wait_event(go)
            with torch.cuda.stream(stream):
                fn()
                end = torch.cuda.Event(enable_timing=True)
                end.record(stream)
                ends.append(end)
        held = not go.query()
        for end in ends:
            main.wait_event(end)
        torch.cuda.synchronize()
        if held:
            return max(go.elapsed_time(end) for end in ends), cycles
        cycles *= 4
    raise RuntimeError("held_ms: the host did not enqueue the work within the sleep")


def main(argv=None, device=None, reps: int = 3) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    t_kernel = int(argv[0]) if len(argv) > 0 else T_CHAIN
    t_mm = int(argv[1]) if len(argv) > 1 else T_MM
    dev = resolve(device)
    if dev.type != "cuda":
        raise ValueError("overlap_study times two CUDA streams; run it on the card")
    env = create("ant_tag", episode_length=None, auto_reset=False, batch_size=B, device=dev)
    sys_ = env.sys
    qp0 = env.reset(jr.PRNGKey(0, dev)).qp
    act = torch.zeros(B, sys_.action_size, device=dev)
    w0 = torch.eye(MM, device=dev) * 0.5 + 0.01
    s_chain, s_mm = torch.cuda.Stream(dev), torch.cuda.Stream(dev)

    def run_chain():
        qp = qp0
        for _ in range(t_kernel):
            qp = whole_step.launch(sys_, qp, act)[0]

    def run_mm():
        mm(w0, t_mm)

    n0 = whole_step.launches
    times, cycles = {}, 500_000_000
    for name, work in (("chain", {s_chain: run_chain}), ("mm", {s_mm: run_mm}),
                       ("both", {s_chain: run_chain, s_mm: run_mm})):
        _, cycles = held_ms(work, cycles)  # warm-up, and a sleep long enough
        runs = [held_ms(work, cycles)[0] for _ in range(reps)]
        times[name] = sum(runs) / reps
    launches = whole_step.launches - n0
    t_chain, t_mm_ms, t_both = times["chain"], times["mm"], times["both"]
    out = {"chain_ms": round(t_chain, 3), "mm_ms": round(t_mm_ms, 3), "both_ms": round(t_both, 3),
           "sum_ms": round(t_chain + t_mm_ms, 3), "max_ms": round(max(t_chain, t_mm_ms), 3),
           "overlap_fraction": round((t_chain + t_mm_ms - t_both) / min(t_chain, t_mm_ms), 3),
           "chain": f"{t_kernel} whole-step launches, AntTag, B={B}",
           "mm": f"{t_mm} steps of tanh(w @ w * 0.01), {MM}x{MM}",
           "launches": launches, **record_device(dev)}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
