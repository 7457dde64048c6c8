"""Profiling + throughput metering; the port of `pobrax_tpu/utils/profiling.py`.

A steps/s meter that separates the first call (kernel builds, allocator
warm-up) from the steady state, `torch.profiler` trace capture, and
`record_function` scopes for phase attribution in traces. CUDA work is
asynchronous, so every timed call ends in `torch.cuda.synchronize()`.

Also the card's readings and kernel timers that the benches, the tools,
time_kernel.py and chip_smoke.py share: `card_line` (nvidia-smi's name and
power limit), `record_device` (the keys every bench record carries),
`cuda_ms` (back-to-back calls under CUDA events) and `device_ms` (a call's
device time, queued behind a sleep kernel).
"""

from __future__ import annotations

import contextlib
import subprocess
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import torch


def smi(query: str) -> str:
    """One line of `nvidia-smi --query-gpu=<query>` for the first card."""
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return "nvidia-smi failed"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return smi("name,power.limit")


def record_device(device: torch.device) -> dict:
    """What every bench and tool record says of where it ran: the device
    ("cuda" or "cpu") and, on the card, its name and power limit (None on
    the CPU: such a record is no card number)."""
    device = torch.device(device)
    return {"device": device.type, "card": card_line() if device.type == "cuda" else None}


def cuda_ms(fn, reps: int, warm_s: float = 0.2) -> float:
    """Mean time of fn() in ms over `reps` back-to-back calls under CUDA
    events, after at least `warm_s` seconds of calls, so that the SM clock
    has risen from a mostly idle phase before (a short warm-up read the small
    Systems up to 2x slow)."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < warm_s:
        fn()
        torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int = 20) -> float:
    """Mean device time in ms of fn()'s launch, back to back on the device:
    a sleep kernel holds the stream while the host enqueues `reps` calls, so
    the kernel's own time shows even where the wrapper's host work per
    launch outlasts it (the small Systems). Raises unless the sleep outlasted
    the enqueueing."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    cycles = 50_000_000  # ~25 ms at the H100's 1.98 GHz
    for _ in range(4):
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        held = not start.query()  # the sleep still ran when the last call was enqueued
        torch.cuda.synchronize()
        if held:
            return start.elapsed_time(end) / reps
        cycles *= 4
    raise RuntimeError("device_ms: the host did not enqueue the timed launches within the sleep")


@dataclass
class Timing:
    first_call_s: float
    mean_step_s: float
    steps_per_s: float
    samples: List[float] = field(default_factory=list)


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def time_fn(fn: Callable, *args, iters: int = 20, warmup: int = 2) -> Timing:
    """Time `fn(*args)`: the first call on its own, then `warmup` untimed
    calls, then `iters` steady-state samples, each synchronised with the
    card before and after."""
    def run():
        _sync()
        t0 = time.perf_counter()
        fn(*args)
        _sync()
        return time.perf_counter() - t0

    first_call_s = run()
    for _ in range(warmup):
        run()
    samples = [run() for _ in range(iters)]
    mean = sum(samples) / len(samples)
    return Timing(first_call_s=first_call_s, mean_step_s=mean,
                  steps_per_s=1.0 / mean, samples=samples)


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a `torch.profiler` trace (the card's too, where there is one)
    around the with-block into `log_dir` (view in TensorBoard or Perfetto);
    yields the profiler, whose `key_averages()` sum the time by op."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)) as prof:
        yield prof


def scope(name: str):
    """Named scope for phase attribution in a trace."""
    return torch.profiler.record_function(name)


class ThroughputMeter:
    """Running env-steps/s across epochs; excludes the first (warm-up) call."""

    def __init__(self):
        self.t0: Optional[float] = None
        self.steps = 0
        self.calls = 0

    def update(self, env_steps_this_call: int) -> Optional[float]:
        self.calls += 1
        if self.calls == 1:  # the first call builds and warms up — start the clock after it
            self.t0 = time.perf_counter()
            return None
        self.steps += env_steps_this_call
        return self.steps / (time.perf_counter() - self.t0)
