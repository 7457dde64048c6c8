"""A trained ant's locomotion budget per episode; the port of
`tools/ant_speed_probe.py`.

Loads an exported checkpoint — by default the committed AntTag GRU-SAC one
(`pobrax_tpu_torch/checkpoints/ant_tag_sac_rnn_phase0_750M.npz`, a strong
pursuit policy, on AntTag at visible radius 20, as the JAX tool) — and
measures the mean torso displacement per control step over live steps:
`episodes` envs under ActionRepeat(6) -> Episode(steps) -> Vmap, reset from
`split(PRNGKey(seed), episodes)`, then per step `key, k = split(key)` from
the same key, the policy's action (stochastic unless `deterministic`), and
|torso xy after - before| where the step did not end the episode. The JAX
tool's run is seed 1, 8 episodes x 300 steps, stochastic.

A GRU-PPO export (`ant_gather_rnn_*`, `ant_maze_rnn_*`, `ant_tag_rnn_*`) is
probed on its own env at the examples' widths: this is how the gather
checkpoints' deterministic gait is compared between the packages.

Usage: python -m pobrax_tpu_torch.tools.ant_speed_probe [npz] [--episodes N]
       [--steps T] [--seeds S ...] [--det] [--device cpu]
Prints one JSON line per seed (with the device and the card's name and power
limit) and returns {seed: m/control-step}. The card unless a device is named
(with no card and no device named it raises).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Optional, Sequence

import torch

from pobrax_tpu_torch import interop
from pobrax_tpu_torch import random as jr
from pobrax_tpu_torch.device import resolve
from pobrax_tpu_torch.envs import HAI_ACTION_REPEAT, _envs, wrappers
from pobrax_tpu_torch.physics import whole_step
from pobrax_tpu_torch.training import checkpoint as ckpt
from pobrax_tpu_torch.training import ppo_rnn, sac_rnn
from pobrax_tpu_torch.utils.profiling import record_device

CKPT_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "checkpoints")
CKPT = os.path.join(CKPT_DIR, "ant_tag_sac_rnn_phase0_750M.npz")
HIDDEN = 128  # GRU-SAC's and the GRU-PPO examples' hidden size


def env_for(npz: str, device) -> object:
    """The core env a checkpoint is probed on: AntTag at radius 20 for the
    GRU-SAC export (the JAX tool's), else the checkpoint's own env."""
    name = os.path.basename(npz)
    if "sac" in name:
        return _envs["ant_tag"](device=device, visible_radius=20.0)
    for env_name in ("ant_gather", "ant_maze", "ant_heavenhell"):
        if name.startswith(env_name):
            return _envs[env_name](device=device)
    return _envs["ant_tag"](device=device)


def load(npz: str, core):
    """(inference_fn, params tuple) of an export: GRU-SAC if its name says
    so, else GRU-PPO at the examples' widths; the checksum must match."""
    if "sac" in os.path.basename(npz):
        cfg = dataclasses.replace(sac_rnn.ANT_TAG, num_envs=1, replay_capacity=1)
        learner = sac_rnn.RSACLearner(core, cfg)
    else:
        learner = ppo_rnn.RNNPPOLearner(core, ppo_rnn.ANT_TAG)
    tree = ckpt.load_npz(npz)
    ts = interop.training_state_from_numpy(tree, learner)
    if interop.params_checksum(interop.params_to_numpy(ts.params)) != tree["params_sha256"]:
        raise RuntimeError(f"{npz}: the loaded parameters do not match their checksum")
    return learner.make_inference_fn(), learner.inference_params(ts)


@torch.no_grad()
def displacement(core, inference_fn, params, episodes: int, steps: int, seed: int,
                 deterministic: bool) -> float:
    """Mean torso displacement (m) per live control step."""
    ti = core.torso_idx
    env = wrappers.VmapWrapper(wrappers.EpisodeWrapper(
        wrappers.ActionRepeatWrapper(core, HAI_ACTION_REPEAT), steps, 1), batch_size=episodes)
    key = jr.PRNGKey(seed, core.device)
    state = env.reset(jr.split(key, episodes))
    h = torch.zeros(episodes, HIDDEN, device=core.device)
    total = torch.zeros((), device=core.device)
    live = torch.zeros((), device=core.device)
    for _ in range(steps):
        key, k = jr.split(key, 2).unbind(-2)
        h, act = inference_fn(params, h, state.obs, k, deterministic=deterministic)
        n = env.step(state, act)
        disp = torch.linalg.norm(n.qp.pos[:, ti, :2] - state.qp.pos[:, ti, :2], dim=-1)
        alive = 1.0 - n.done
        total += (disp * alive).sum()
        live += alive.sum()
        state = n
    return float(total / live)


def main(npz: str = CKPT, episodes: int = 8, steps: int = 300,
         seeds: Optional[Sequence[int]] = None, deterministic: bool = False,
         device=None) -> dict:
    dev = resolve(device)
    where = record_device(dev)
    out = {}
    for seed in ([1] if seeds is None else seeds):
        core = env_for(npz, dev)  # ActionRepeat rescales its core: one a run
        inference_fn, params = load(npz, core)
        n0 = whole_step.launches
        m = displacement(core, inference_fn, params, episodes, steps, seed, deterministic)
        out[seed] = m
        print(json.dumps({"npz": os.path.basename(npz), "seed": seed, "episodes": episodes,
                          "steps": steps, "mode": "det" if deterministic else "stoch",
                          "m_per_control_step": m, "m_per_1000_steps": 1000 * m,
                          "launches": whole_step.launches - n0, **where}), flush=True)
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("npz", nargs="?", default=CKPT)
    parser.add_argument("--episodes", type=int, default=8)
    parser.add_argument("--steps", type=int, default=300)
    parser.add_argument("--seeds", type=int, nargs="+", default=None)
    parser.add_argument("--det", action="store_true", help="the policy's mode, not a sample")
    parser.add_argument("--device", default=None)
    args = parser.parse_args()
    main(args.npz, args.episodes, args.steps, args.seeds, args.det, args.device)
