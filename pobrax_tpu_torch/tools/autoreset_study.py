"""The cached autoreset's effect on the distribution of episode starts,
against naive; the port of `tools/autoreset_study.py`.

`RandomizedAutoResetWrapperCachedOnDevice` restarts a finished env from its
cached fresh state, and the whole cache re-randomizes every `refresh_every`
steps, so between refreshes a slot that finishes repeatedly restarts from
the SAME state: on AntHeavenHell that freezes the slot's heaven / hell side
until the next refresh. Per mode, over a random-action rollout:
  * swap_rate — share of consecutive episode starts (per slot) whose heaven
    side differs (naive expectation 0.5);
  * heaven_balance — share of episode starts with heaven on the right;
  * distinct_reset_rate — share of resets that load another state than the
    slot's previous one (side or spawn xy moved).
The resets' side and spawn draws are threefry, bit-equal to JAX's, so at a
size where the packages' trajectories agree the counts are JAX's.

Usage: python -m pobrax_tpu_torch.tools.autoreset_study [episode_length] [steps]
(defaults 50 / 1000, 64 envs). Prints one JSON line per mode, each with the
device and the card's name and power limit; the card unless a device is
named (with no card and no device named it raises).
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from pobrax_tpu_torch import random as jr
from pobrax_tpu_torch.device import resolve
from pobrax_tpu_torch.envs import create
from pobrax_tpu_torch.physics import whole_step
from pobrax_tpu_torch.utils.profiling import record_device


@torch.no_grad()
def run_mode(mode: str, episode_length: int, steps: int, batch: int = 64, seed: int = 0,
             device=None) -> dict:
    dev = resolve(device)
    env = create("ant_heavenhell", episode_length=episode_length, batch_size=batch,
                 auto_reset=True, randomized_autoreset=True, autoreset_mode=mode, device=dev)
    tgt, torso = env.unwrapped.target_idx, env.unwrapped.torso_idx
    key = jr.PRNGKey(seed, dev)
    state = env.reset(jr.split(key, batch))
    init_side = np.sign(state.qp.pos[:, tgt, 0].cpu().numpy())
    init_xy = state.qp.pos[:, torso, :2].cpu().numpy()
    n0 = whole_step.launches
    done, side, xy = [], [], []
    for _ in range(steps):
        key, k = jr.split(key, 2).unbind(-2)
        state = env.step(state, jr.uniform(k, (batch, env.action_size), -1.0, 1.0))
        # post-step (post-autoreset-where-done) snapshot
        done.append(state.done)
        side.append(torch.sign(state.qp.pos[:, tgt, 0]))
        xy.append(state.qp.pos[:, torso, :2])
    launches = whole_step.launches - n0
    done = torch.stack(done).cpu().numpy()  # (T, B)
    side = torch.stack(side).cpu().numpy()  # (T, B)
    xy = torch.stack(xy).cpu().numpy()  # (T, B, 2)

    swaps = distinct = resets = 0
    heaven_right = total_eps = 0
    for b in range(batch):
        prev_side, prev_xy = init_side[b], init_xy[b]
        heaven_right += prev_side > 0
        total_eps += 1
        for t in range(done.shape[0]):
            if done[t, b]:
                # step t's post-state IS the new episode's start
                s, p = side[t, b], xy[t, b]
                resets += 1
                total_eps += 1
                heaven_right += s > 0
                swaps += s != prev_side
                if s != prev_side or np.linalg.norm(p - prev_xy) > 1e-5:
                    distinct += 1
                prev_side, prev_xy = s, p
    return {
        "mode": mode, "episode_length": episode_length, "steps": steps,
        "batch": batch, "episodes": int(total_eps), "resets": int(resets),
        "swap_rate": round(int(swaps) / max(resets, 1), 4),
        "heaven_balance": round(int(heaven_right) / max(total_eps, 1), 4),
        "distinct_reset_rate": round(distinct / max(resets, 1), 4),
        "launches": launches, **record_device(dev),
    }


def main(argv=None, device=None, batch: int = 64) -> list:
    argv = sys.argv[1:] if argv is None else argv
    episode_length = int(argv[0]) if len(argv) > 0 else 50
    steps = int(argv[1]) if len(argv) > 1 else 1000
    out = []
    for mode in ("naive", "cached"):
        out.append(run_mode(mode, episode_length, steps, batch, device=device))
        print(json.dumps(out[-1]), flush=True)
    return out


if __name__ == "__main__":
    main()
