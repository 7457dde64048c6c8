"""Prioritized sequence replay against uniform on the masked pendulum; the
port of `tools/per_study.py`.

Trains GRU-SAC (`training/sac_rnn.py`) on masked_inverted_pendulum
(VELOCITY hidden: the policy must integrate positions) at a ladder of step
budgets, uniform (`per_alpha=0`) and prioritized (R2D2's exponents:
priority 0.9, importance 0.6), over seeds, and reports each deterministic
policy's mean episode length (`train_masked_pendulum.mean_length`, cap
500). `COMMON`, `BUDGETS` and `SEEDS` are the JAX tool's.

Usage: python -m pobrax_tpu_torch.tools.per_study [--device cpu] [--out PATH]
Writes runs/learning_per_study_torch.json (never docs/) with the device and
the card's name and power limit. The card unless a device is named (with no
card and no device named it raises).
"""

from __future__ import annotations

import json
import sys
import time
from typing import Optional, Sequence

import torch

from pobrax_tpu_torch.device import resolve
from pobrax_tpu_torch.examples._common import run_path, split_options, write_json
from pobrax_tpu_torch.examples.train_masked_pendulum import (EPISODE_LENGTH, masked_env,
                                                             mean_length)
from pobrax_tpu_torch.training import sac_rnn
from pobrax_tpu_torch.utils.profiling import record_device

BUDGETS = (100_000, 200_000, 400_000)
SEEDS = (0, 1, 2)
HIDDEN = 64
COMMON = dict(
    num_envs=64, episode_length=EPISODE_LENGTH,
    seq_len=16, burn_in=4, replay_capacity=1024, batch_size=64,
    seqs_per_epoch=4, grad_steps_per_seq=8, min_replay=32,
    learning_rate=3e-4, discounting=0.97,
    encoder_sizes=(64,), hidden_size=HIDDEN, head_sizes=(64,),
    watchdog_deadline_s=None,
)
OUT = run_path("learning_per_study_torch.json")


def run(per: bool, budget: int, seed: int, device=None) -> float:
    kwargs = dict(COMMON)
    if per:
        # R2D2's published exponents (priority 0.9, IS 0.6); eta stays at
        # the config default 0.9
        kwargs.update(per_alpha=0.9, per_beta=0.6)
    inf, params, _ = sac_rnn.train(masked_env(device), num_timesteps=budget, seed=seed, **kwargs)
    eval_env = masked_env(device)
    return mean_length(
        eval_env, lambda h, obs, k: inf(params, h, obs, k, deterministic=True),
        carry_init=lambda n: torch.zeros(n, HIDDEN, device=eval_env.device))


def main(budgets: Sequence[int] = BUDGETS, seeds: Sequence[int] = SEEDS, device=None,
         out: Optional[str] = None) -> dict:
    dev = resolve(device)
    results = {"budgets": list(budgets), "seeds": list(seeds), "uniform": {}, "per": {},
               **record_device(dev)}
    for per in (False, True):
        name = "per" if per else "uniform"
        for budget in budgets:
            scores = []
            for seed in seeds:
                t0 = time.perf_counter()
                s = run(per, budget, seed, dev)
                scores.append(s)
                print(f"{name:8s} budget {budget:>8,} seed {seed}: "
                      f"{s:6.1f}  ({time.perf_counter() - t0:.0f}s)", flush=True)
            results[name][str(budget)] = scores
    write_json(out or OUT, results)
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    args, device, out = split_options(sys.argv[1:])
    main(device=device, out=out)
