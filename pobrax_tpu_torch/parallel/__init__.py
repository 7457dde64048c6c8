"""Distribution layer: health (`ping`, `Watchdog`)."""

from pobrax_tpu_torch.parallel.health import Watchdog, ping

__all__ = ["Watchdog", "ping"]
