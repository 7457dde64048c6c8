"""Multi-process PPO training launcher; the counterpart of
examples/multihost_train.py.

Every process is one rank of one 'data' mesh (`parallel/mesh.py`): it holds
its block of the env batch and a replica of the learner, and the ranks
average their gradients, statistics and metrics (`training/ppo.py`). Run one
process per card with torchrun, which sets RANK, WORLD_SIZE, LOCAL_RANK and
the rendezvous address:

    torchrun --nproc_per_node=<cards> -m pobrax_tpu_torch.multihost_train

on every host (with `--nnodes`, `--node_rank` and `--master_addr` across
hosts), or several ranks on one card over gloo:

    torchrun --nproc_per_node=2 -m pobrax_tpu_torch.multihost_train --backend gloo

Started without torchrun it trains as one process. NUM_TIMESTEPS (default
2,000,000) and NUM_ENVS (global, default 4096) size the run, as in the
example; rank 0 prints the progress.
"""

from __future__ import annotations

import argparse
import os

import torch.distributed as dist

from pobrax_tpu_torch.envs.ant_tag import AntTagEnv
from pobrax_tpu_torch.parallel.mesh import initialize_distributed, make_mesh
from pobrax_tpu_torch.training import ppo


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--backend", default="nccl",
                        help="nccl: a card per rank; gloo: the CPU or ranks sharing a card")
    parser.add_argument("--device", default=None, help="the card unless named")
    args = parser.parse_args(argv)
    initialize_distributed(args.backend)
    try:
        mesh = make_mesh(device=args.device)
        print(f"process {mesh.rank}/{mesh.data} on {mesh.device}, backend {mesh.backend}",
              flush=True)

        def progress(steps, metrics):
            if mesh.rank == 0:
                print(f"steps {steps:>10,}  reward {metrics['mean_reward']:+.3f}  "
                      f"sps {metrics['steps_per_second']:,.0f}", flush=True)

        ppo.train(AntTagEnv(device=mesh.device),
                  num_timesteps=int(os.environ.get("NUM_TIMESTEPS", 2_000_000)),
                  num_envs=int(os.environ.get("NUM_ENVS", 4096)),
                  mesh=mesh, progress_fn=progress)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
