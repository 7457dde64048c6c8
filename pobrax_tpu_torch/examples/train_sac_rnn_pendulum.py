"""Recurrent SAC on the masked-pendulum memory task; the port of
examples/train_sac_rnn_pendulum.py.

The PO task of train_masked_pendulum.py (VELOCITY hidden) with the
off-policy memory agent (`training/sac_rnn.py`): reports the deterministic
policy's mean episode length against the cap, then the training's wall
time and trained env-steps/s (and, on the card, its name and power limit).
The JAX example appends its
result to docs/learning_masked_pendulum.json; this one adds
"gru_sac_masked" to the port's own record at `--out`
(runs/learning_masked_pendulum.json unless named), made if missing.

Usage: python -m pobrax_tpu_torch.examples.train_sac_rnn_pendulum [num_timesteps]
       [--device cpu] [--out PATH]
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Optional

import torch

from pobrax_tpu_torch.examples._common import run_path, split_options, write_json
from pobrax_tpu_torch.examples.train_masked_pendulum import EPISODE_LENGTH, masked_env, mean_length
from pobrax_tpu_torch.training import sac_rnn
from pobrax_tpu_torch.utils.profiling import record_device

HIDDEN = 64


def main(num_timesteps: int = 600_000, device=None, out: Optional[str] = None) -> dict:
    trained = [0]

    def progress(steps, m):
        trained[0] = steps
        if steps % 65536 < 4096:
            print(f"steps {steps:>8,}  q_loss {m['q_loss']:.3f}  reward {m['mean_reward']:.3f}  "
                  f"sps {m['steps_per_second']:,.0f}", flush=True)

    t0 = time.perf_counter()
    inf, params, _ = sac_rnn.train(
        masked_env(device), num_timesteps=num_timesteps, num_envs=64,
        episode_length=EPISODE_LENGTH, seq_len=16, burn_in=4, replay_capacity=1024,
        batch_size=64, seqs_per_epoch=4, grad_steps_per_seq=8, min_replay=32,
        learning_rate=3e-4, discounting=0.97, encoder_sizes=(64,), hidden_size=HIDDEN,
        head_sizes=(64,), seed=0, progress_fn=progress)
    wall_s = time.perf_counter() - t0  # the last epoch's metrics waited for the card

    eval_env = masked_env(device)
    score = mean_length(eval_env, lambda h, obs, k: inf(params, h, obs, k, deterministic=True),
                        carry_init=lambda n: torch.zeros(n, HIDDEN, device=eval_env.device))
    print(f"GRU-SAC, masked: {score:.1f} / {EPISODE_LENGTH}", flush=True)
    where = record_device(eval_env.device)
    print(f"train wall {wall_s:.1f} s, {trained[0]:,} env-steps, "
          f"{trained[0] / wall_s:,.0f} trained env-steps/s; {where['card'] or where['device']}",
          flush=True)

    path = out or run_path("learning_masked_pendulum.json")
    results = {}
    if os.path.exists(path):
        with open(path) as f:
            results = json.load(f)
    results["gru_sac_masked"] = score
    results["gru_sac_num_timesteps"] = num_timesteps
    write_json(path, results)
    return results


if __name__ == "__main__":
    args, device, out = split_options(sys.argv[1:])
    main(*[int(a) for a in args[:1]], device=device, out=out)
