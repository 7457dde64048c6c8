"""Profiling + throughput metering; the port of `pobrax_tpu/utils/profiling.py`.

A steps/s meter that separates the first call (kernel builds, allocator
warm-up) from the steady state, `torch.profiler` trace capture, and
`record_function` scopes for phase attribution in traces. CUDA work is
asynchronous, so every timed call ends in `torch.cuda.synchronize()`.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import torch


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
