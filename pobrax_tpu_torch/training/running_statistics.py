"""Running observation statistics for input normalisation; the port of
`pobrax_tpu/training/running_statistics.py`.

Welford-style streaming mean and std over every observation seen so far.
Under a mesh (`parallel/mesh.py`) `update` sums the batch's count and
deviations over the ranks, as JAX's `axis_name` psums do, so every rank
folds the same global statistics.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from pobrax_tpu_torch.device import resolve
from pobrax_tpu_torch.parallel.mesh import psum


@dataclass
class RunningStatisticsState:
    count: torch.Tensor            # ()
    mean: torch.Tensor             # (obs_size,)
    summed_variance: torch.Tensor  # (obs_size,)
    std: torch.Tensor              # (obs_size,)


def init_state(obs_size: int, device=None) -> RunningStatisticsState:
    device = resolve(device)
    return RunningStatisticsState(
        count=torch.zeros((), device=device),
        mean=torch.zeros(obs_size, device=device),
        summed_variance=torch.zeros(obs_size, device=device),
        std=torch.ones(obs_size, device=device))


def update(state: RunningStatisticsState, batch: torch.Tensor,
           mesh=None) -> RunningStatisticsState:
    """Fold a batch (..., obs_size) into the running statistics; with a
    `mesh`, the batch is this rank's share of a global one: its count and
    sums add up over the ranks (one all-reduce for the count and the first
    sums, one for the second)."""
    flat = batch.reshape(-1, batch.shape[-1])
    diff_to_old = flat - state.mean
    count_sum = psum(torch.cat([diff_to_old.sum(0), flat.new_full((1,), flat.shape[0])]), mesh)
    count = state.count + count_sum[-1]
    mean = state.mean + count_sum[:-1] / count
    summed_variance = state.summed_variance + psum((diff_to_old * (flat - mean)).sum(0), mesh)
    std = torch.sqrt(torch.clamp(summed_variance / count, min=1e-6))
    return RunningStatisticsState(count=count, mean=mean, summed_variance=summed_variance,
                                  std=std)


def normalize(state: RunningStatisticsState, batch: torch.Tensor) -> torch.Tensor:
    return (batch - state.mean) / state.std
