"""Structured metrics writing: stdout / JSONL / optional TensorBoard; the
port of `pobrax_tpu/utils/metrics_writer.py`.

The reference's observability is two-tier (SURVEY.md §5): in-state
State.metrics + host-side aggregation (EvalGymWrapper.get_stats). This module
is the host half for training loops: write scalar dicts per step to JSONL
(always), stdout (optional), and TensorBoard if `torch.utils.tensorboard`
imports. Across processes: `reduce_metrics` means scalars over the processes
of an initialized `torch.distributed` group, so only process 0 needs to
write.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict

import numpy as np
import torch.distributed as dist


def _world() -> tuple:
    """(process index, process count) of the initialized group, else (0, 1)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def reduce_metrics(metrics: Dict[str, float]) -> Dict[str, float]:
    """Mean each scalar across processes (the identity single-process)."""
    _, count = _world()
    if count == 1:
        return {k: float(v) for k, v in metrics.items()}
    keys = sorted(metrics)
    gathered = [None] * count
    dist.all_gather_object(gathered, [float(metrics[k]) for k in keys])
    mean = np.asarray(gathered, np.float32).mean(axis=0)
    return {k: float(v) for k, v in zip(keys, mean)}


class MetricsWriter:
    def __init__(self, log_dir: str, stdout: bool = True,
                 tensorboard: bool = False):
        self.log_dir = log_dir
        self.stdout = stdout
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(log_dir)
            except ImportError:
                pass
        self._t0 = time.time()

    def write(self, step: int, metrics: Dict[str, float]) -> None:
        if _world()[0] != 0:
            return
        row = {"step": int(step), "time": round(time.time() - self._t0, 3),
               **{k: float(v) for k, v in metrics.items()}}
        self._jsonl.write(json.dumps(row) + "\n")
        self._jsonl.flush()
        if self.stdout:
            body = "  ".join(f"{k}={v:.4g}" for k, v in metrics.items())
            print(f"[{row['time']:9.1f}s] step {step:>10,}  {body}")
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(k, v, step)

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
