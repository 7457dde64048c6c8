"""Utility layer: profiling, throughput metering, metrics writing, debug
helpers."""

from pobrax_tpu_torch.utils import profiling
from pobrax_tpu_torch.utils.profiling import ThroughputMeter, time_fn, trace

__all__ = ["profiling", "ThroughputMeter", "time_fn", "trace"]
