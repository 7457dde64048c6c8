"""Running observation statistics for input normalisation; the port of
`pobrax_tpu/training/running_statistics.py`.

Welford-style streaming mean and std over every observation seen so far.
One card needs no collectives, so `update` has no `axis_name`.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from pobrax_tpu_torch.device import resolve


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


def update(state: RunningStatisticsState, batch: torch.Tensor) -> RunningStatisticsState:
    """Fold a batch (..., obs_size) into the running statistics."""
    flat = batch.reshape(-1, batch.shape[-1])
    diff_to_old = flat - state.mean
    count = state.count + flat.shape[0]
    mean = state.mean + diff_to_old.sum(0) / count
    summed_variance = state.summed_variance + (diff_to_old * (flat - mean)).sum(0)
    std = torch.sqrt(torch.clamp(summed_variance / count, min=1e-6))
    return RunningStatisticsState(count=count, mean=mean, summed_variance=summed_variance,
                                  std=std)


def normalize(state: RunningStatisticsState, batch: torch.Tensor) -> torch.Tensor:
    return (batch - state.mean) / state.std
