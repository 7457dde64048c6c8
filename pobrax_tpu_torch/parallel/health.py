"""Health: a collective ping + a host-side training watchdog; the port of
`pobrax_tpu/parallel/health.py` on `torch.distributed`.

The reference has no failure-detection story (SURVEY.md §5); this is the
framework's. Two mechanisms (no elastic resize — matching the reference's
capability level):

  * `ping()`: each process's device count, all-gathered across the
    processes of an initialized `torch.distributed` group and blocked to
    completion — if any process is dead the call hangs, so running it under
    the Watchdog's deadline converts silent hangs into loud failures.
  * `Watchdog`: a monotonic-deadline heartbeat for the training loop; call
    `beat()` every epoch, and `check()` raises if the gap exceeded the
    deadline (e.g. from a checkpoint/metrics thread).

Restartability is checkpoint-based: a crashed run resumes from its latest
checkpoint (training/checkpoint.py).
"""

from __future__ import annotations

import sys
import threading
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist

from pobrax_tpu_torch.parallel.mesh import local_rank

DEFAULT_DEADLINE_S = 1800.0  # the learners' `train(..., watchdog_deadline_s=)` default


def _distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def _process_index() -> int:
    return dist.get_rank() if _distributed() else 0


def ping() -> int:
    """Cross-process all-gather of each process's device count; returns the
    global device count. Under an initialized process group this is a REAL
    collective (`all_gather_object`), so it blocks until every process
    participates — a dead process turns into a hang, which the Watchdog's
    deadline converts into a loud failure. Without one: the local device
    count, at once."""
    local = torch.cuda.device_count() or 1  # the host counts as one device
    if not _distributed() or dist.get_world_size() == 1:
        return local
    if dist.get_backend() == "nccl":
        torch.cuda.set_device(local_rank())  # all_gather_object stages on the current card
    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, local)
    return int(sum(gathered))


class Watchdog:
    """Host-side heartbeat with a deadline.

    Two ways to consume it:

      * serial — `beat()` each epoch and `check()` from any point in the
        loop; `check()` raises once the gap exceeds the deadline.
      * monitored — `start_monitor()` spawns a daemon thread that polls the
        heartbeat. If the training loop hangs INSIDE a device call (where
        no serial check can run — e.g. a collective blocked on a dead peer,
        see `ping`), the monitor fires `on_stall` and latches
        `self.stalled`, so the stall is loud on stderr immediately and every
        later `beat()`/`check()` raises instead of resuming silently.

    This is the failure-detection half wired into the four learners'
    `train(...)`; the recovery half is checkpoint-restart
    (training/checkpoint.py).
    """

    def __init__(self, deadline_s: float = 300.0,
                 on_stall: Optional[Callable[[float], None]] = None):
        self.deadline_s = deadline_s
        self.stalled = False
        self._last = time.monotonic()
        self._on_stall = on_stall or self._default_on_stall
        self._monitor: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def _default_on_stall(self, elapsed: float) -> None:
        print(
            f"[pobrax_tpu_torch.health] CRITICAL: training heartbeat stalled for "
            f"{elapsed:.0f}s (> {self.deadline_s:.0f}s deadline) on process "
            f"{_process_index()} — a device call is likely hung (dead "
            f"peer / driver wedge). Latest checkpoint remains restartable.",
            file=sys.stderr, flush=True)

    def beat(self) -> None:
        # a monitor-latched stall is permanent: the loop must fail loudly,
        # not silently resume after an hour-long device hang
        if self.stalled:
            raise TimeoutError(
                f"training heartbeat stalled for {self.elapsed():.0f}s "
                f"(> {self.deadline_s:.0f}s deadline); watchdog latched")
        self._last = time.monotonic()

    def elapsed(self) -> float:
        return time.monotonic() - self._last

    def check(self) -> None:
        if self.stalled or self.elapsed() > self.deadline_s:
            raise TimeoutError(
                f"training heartbeat stalled for {self.elapsed():.0f}s "
                f"(> {self.deadline_s:.0f}s deadline)")

    def start_monitor(self, poll_s: Optional[float] = None) -> "Watchdog":
        """Start the daemon poll thread (idempotent). Returns self."""
        if self._monitor is None or not self._monitor.is_alive():
            self._stop.clear()

            def run():
                interval = poll_s or max(0.01, self.deadline_s / 4.0)
                while not self._stop.wait(interval):
                    if not self.stalled and self.elapsed() > self.deadline_s:
                        self.stalled = True
                        self._on_stall(self.elapsed())

            self._monitor = threading.Thread(
                target=run, name="pobrax-watchdog", daemon=True)
            self._monitor.start()
        return self

    def stop_monitor(self) -> None:
        self._stop.set()
        if self._monitor is not None:
            self._monitor.join(timeout=5.0)
            self._monitor = None
