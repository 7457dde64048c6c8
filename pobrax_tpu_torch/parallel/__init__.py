"""Distribution layer: the process mesh and its collectives (`mesh`), health
(`ping`, `Watchdog`)."""

from pobrax_tpu_torch.parallel.health import Watchdog, ping
from pobrax_tpu_torch.parallel.mesh import (Mesh, initialize_distributed, make_mesh, pmean,
                                            psum, replicate, shard_batch, spawn)

__all__ = ["Mesh", "Watchdog", "initialize_distributed", "make_mesh", "ping", "pmean", "psum",
           "replicate", "shard_batch", "spawn"]
