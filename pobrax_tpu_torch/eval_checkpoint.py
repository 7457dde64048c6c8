"""Replay a committed AntGather, AntMaze or AntHeavenHell GRU-PPO checkpoint,
or the masked-ant arms, with the port.

Loads the numpy export (`tools/export_torch_checkpoint.py`) of
checkpoints/ant_gather_rnn_800M (`--gather`), ant_gather_rnn_bombmem02_1B
(`--gather-bombmem`) or ant_maze_rnn_400M (`--maze`), or a policy the port
itself trained, written by `pobrax_tpu_torch.tools.export_run_checkpoint`:
at examples/train_heavenhell_rnn.py's recipe (ant_heavenhell_rnn_400M,
`--heavenhell`), at examples/train_ant_maze_rnn.py's, seed 0
(ant_maze_rnn_400M_torch, `--maze-port`), or at the sensor-range
curriculum of examples/train_ant_gather_rnn.py, seed 0
(ant_gather_rnn_800M_torch, `--gather-port`), or at its bomb-memory
recipe (14 -> 6 -> 6 m, novelty 0.25 / 0.25 / 0, bomb memory 0.2, 1B),
seed 0, a run whose calls were resumed inside phase 2 and so trained its
last 163.6M env-steps of that phase without the bomb cells it had gathered
(ant_gather_rnn_bombmem02_cut_in_phase2_1B_torch, `--gather-bombmem-port`),
checks the loaded parameters against the checksum stored beside them, and
reports the example's own evaluator on 256 episodes under ActionRepeat(6) ->
Episode(1000) -> Vmap, deterministic and stochastic, as the examples
evaluate them: `gather_eval` of examples/train_ant_gather_rnn.py (apples and
bombs per episode) or `goal_rate_rnn` of examples/train_ant_maze_rnn.py, both
at reset seed 0, or `outcome_rates` of examples/train_heavenhell_rnn.py
(completion and heaven rates), det at seed 0 and stoch at seed 1. `--seeds S
...` runs both at each seed instead (tools/eval_gather_checkpoint_seeds.py is
the JAX package's column). `--html OUT` also writes the deterministic episode
of tools/render_gather_policy.py (500 frames) or tools/render_maze_policy.py
(300 frames); the JAX package has no HeavenHell renderer, so `--heavenhell`
takes no `--html`. `--spread` adds each AntGather mode's per-episode
standard deviation of apples and bombs (`gather_counts`).

`--masked-ant-port` replays the three arms of examples/train_masked_ant.py
that the port trained (MASKED_SEED 0, 100M env-steps each;
masked_ant_{ff_full,ff_masked,gru_masked}_100M_torch, `MASKED_ANT_NPZ`),
each checked against its checksum and run through the example's own
`eval_policy` on its observation regime, deterministic, at reset seed 0 as
the example evaluates it: each arm's mean episode reward and torso
x-displacement (`--modes` does not apply; `--seeds` and `--html` raise).

Usage: python -m pobrax_tpu_torch.eval_checkpoint
       --gather|--gather-port|--gather-bombmem|--gather-bombmem-port|--maze|--maze-port|
       --heavenhell|--masked-ant-port
       [--device cpu] [--episodes N] [--seeds S ...] [--modes det stoch] [--html OUT]
       [--spread]
(the card unless a device is named)
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence

import torch

from pobrax_tpu_torch import interop
from pobrax_tpu_torch import random as jr
from pobrax_tpu_torch.device import resolve
from pobrax_tpu_torch.envs import HAI_ACTION_REPEAT, _envs, wrappers
from pobrax_tpu_torch.examples import train_masked_ant
from pobrax_tpu_torch.examples._common import make_parent, split2
from pobrax_tpu_torch.examples.train_ant_gather_rnn import HIDDEN, gather_counts, gather_eval
from pobrax_tpu_torch.examples.train_ant_maze_rnn import goal_rate_rnn
from pobrax_tpu_torch.examples.train_heavenhell_rnn import gru_policy, outcome_rates
from pobrax_tpu_torch.io import html
from pobrax_tpu_torch.training import checkpoint as ckpt
from pobrax_tpu_torch.training import ppo_rnn

_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "checkpoints")
# name -> (env, npz, frames of the rendered episode (None: no renderer),
#          reset seeds of the det and stoch evaluations, as the example's main)
CHECKPOINTS = {"gather": ("ant_gather", "ant_gather_rnn_800M.npz", 500, (0, 0)),
               "gather_port": ("ant_gather", "ant_gather_rnn_800M_torch.npz", 500, (0, 0)),
               "gather_bombmem": ("ant_gather", "ant_gather_rnn_bombmem02_1B.npz", 500, (0, 0)),
               "gather_bombmem_port": ("ant_gather",
                                       "ant_gather_rnn_bombmem02_cut_in_phase2_1B_torch.npz", 500,
                                       (0, 0)),
               "maze": ("ant_maze", "ant_maze_rnn_400M.npz", 300, (0, 0)),
               "maze_port": ("ant_maze", "ant_maze_rnn_400M_torch.npz", 300, (0, 0)),
               "heavenhell": ("ant_heavenhell", "ant_heavenhell_rnn_400M.npz", None, (0, 1))}


# the port-trained masked-ant arms' exports, by arm (`--masked-ant-port`)
MASKED_ANT_NPZ = "masked_ant_{}_100M_torch.npz"


def npz_path(name: str) -> str:
    return os.path.join(_DIR, CHECKPOINTS[name][1])


def learner_for(name: str, device=None) -> ppo_rnn.RNNPPOLearner:
    """An RNNPPOLearner at the examples' widths (hidden 128, encoder (256,))
    on `name`'s env."""
    return ppo_rnn.RNNPPOLearner(_envs[CHECKPOINTS[name][0]](device=resolve(device)),
                                 ppo_rnn.ANT_TAG)


def load(name: str, device=None, npz: Optional[str] = None):
    """-> (learner, training state, checksum matches): `learner_for(name)`
    with its state loaded on `device` from `npz` (the committed export of
    `name` unless given)."""
    learner = learner_for(name, device)
    tree = ckpt.load_npz(npz or npz_path(name))
    ts = interop.training_state_from_numpy(tree, learner)
    same = interop.params_checksum(interop.params_to_numpy(ts.params)) == tree["params_sha256"]
    return learner, ts, same


def evaluate(name: str, learner, ts, episodes: int = 256,
             seeds: Optional[Sequence[int]] = None,
             modes: Sequence[str] = ("det", "stoch"), spread: bool = False) -> dict:
    """The example's evaluator, det and stoch (or the `modes` named), at
    the checkpoint's reset seeds (`CHECKPOINTS`) or at each of `seeds`:
    {"det_apples": .., "det_bombs": .., "det_net": .., ...},
    {"det_goal_rate": .., ...} or {"det_completion": .., "det_heaven": ..,
    ...} (keys suffixed _s<seed> with `seeds`). With `spread` (AntGather
    only) the same episodes' means come with their per-episode standard
    deviations, "det_apples_sd" and "det_bombs_sd" (ddof 1)."""
    if spread and CHECKPOINTS[name][0] != "ant_gather":
        raise ValueError(f"{name}: --spread reads AntGather's apples and bombs only")
    inference_fn, params = learner.make_inference_fn(), learner.inference_params(ts)
    env_name, _, _, (det_seed, stoch_seed) = CHECKPOINTS[name]
    out = {}
    for seed in ([None] if seeds is None else seeds):
        suffix = "" if seeds is None else f"_s{seed}"
        for mode in modes:
            det = mode == "det"
            core = _envs[env_name](device=learner.device)
            at = (det_seed if det else stoch_seed) if seed is None else seed
            if env_name == "ant_heavenhell":
                c, h = outcome_rates(core, **gru_policy(inference_fn, params, HIDDEN,
                                                        learner.device, det),
                                     episodes=episodes, seed=at, action_repeat=HAI_ACTION_REPEAT)
                out.update({f"{mode}_completion{suffix}": c, f"{mode}_heaven{suffix}": h})
            elif env_name == "ant_maze":
                out[f"{mode}_goal_rate{suffix}"] = goal_rate_rnn(
                    core, inference_fn, params, HIDDEN, episodes, seed=at,
                    action_repeat=HAI_ACTION_REPEAT, deterministic=det)
            elif spread:
                apples, bombs = gather_counts(core, (params, inference_fn, det), episodes,
                                              seed=at, action_repeat=HAI_ACTION_REPEAT,
                                              hidden_size=HIDDEN)
                a, b = float(apples.mean()), float(bombs.mean())
                out.update({f"{mode}_apples{suffix}": a, f"{mode}_bombs{suffix}": b,
                            f"{mode}_net{suffix}": a - b,
                            f"{mode}_apples_sd{suffix}": float(apples.std()),
                            f"{mode}_bombs_sd{suffix}": float(bombs.std())})
            else:
                a, b = gather_eval(core, (params, inference_fn, det), episodes, seed=at,
                                   action_repeat=HAI_ACTION_REPEAT, hidden_size=HIDDEN)
                out.update({f"{mode}_apples{suffix}": a, f"{mode}_bombs{suffix}": b,
                            f"{mode}_net{suffix}": a - b})
    return out


def masked_ant_npz(arm: str) -> str:
    return os.path.join(_DIR, MASKED_ANT_NPZ.format(arm))


def load_masked_ant(arm: str, device=None, npz: Optional[str] = None):
    """-> (learner, training state, checksum matches) of a masked-ant arm
    (`train_masked_ant.learner_for(arm)` on `ant`), its state loaded from
    `npz` (the committed export unless given)."""
    learner = train_masked_ant.learner_for(arm, device, "ant")
    tree = ckpt.load_npz(npz or masked_ant_npz(arm))
    ts = interop.training_state_from_numpy(tree, learner)
    same = interop.params_checksum(interop.params_to_numpy(ts.params)) == tree["params_sha256"]
    return learner, ts, same


def masked_ant_port(device=None, episodes: int = 256) -> dict:
    """{arm: {"epochs", "checksum_ok", "episode_reward", "x_displacement"}}
    of the three committed masked-ant arms: `train_masked_ant.evaluate` of
    each deterministic policy at reset seed 0, as the example evaluates it.
    Raises where a file's parameters do not match their checksum."""
    out = {}
    for arm in train_masked_ant.ARMS:
        learner, ts, same = load_masked_ant(arm, device)
        if not same:
            raise RuntimeError(f"{masked_ant_npz(arm)}: the loaded parameters do not match "
                               "their checksum")
        out[arm] = {"epochs": ts.epochs, "checksum_ok": same, **train_masked_ant.evaluate(
            arm, learner.make_inference_fn(), learner.inference_params(ts), learner.device,
            "ant", episodes=episodes)}
    return out


@torch.no_grad()
def render(name: str, learner, ts, out: str, frames: Optional[int] = None) -> dict:
    """The deterministic episode of tools/render_gather_policy.py /
    render_maze_policy.py (reset key PRNGKey(1), action keys from
    PRNGKey(2)), `frames` control steps (500 / 300 unless given), saved by
    `html.save`; -> what it caught or reached."""
    env_name, _, default_frames = CHECKPOINTS[name][:3]
    frames = frames or default_frames
    core = _envs[env_name](device=learner.device)
    env = wrappers.ActionRepeatWrapper(core, HAI_ACTION_REPEAT)
    env = wrappers.EpisodeWrapper(env, 1000, 1)
    env = wrappers.VmapWrapper(env, batch_size=1)
    inference_fn, params = learner.make_inference_fn(), learner.inference_params(ts)
    state = env.reset(jr.split(jr.PRNGKey(1, core.device), 1))
    key = jr.PRNGKey(2, core.device)
    h = torch.zeros(1, HIDDEN, device=core.device)
    qps, caught, best = [], {"apples": 0.0, "bombs": 0.0}, -float("inf")
    for _ in range(frames):
        key, k = split2(key)
        h, act = inference_fn(params, h, state.obs, k, deterministic=True)
        state = env.step(state, act)
        qps.append(state.qp)
        if env_name == "ant_maze":
            best = max(best, float(state.reward[0]))
        else:
            for m in caught:
                caught[m] += float(state.metrics[m][0])
    html.save(make_parent(out), core.sys, qps)
    result = ({"goal_reached": best > 1.0} if env_name == "ant_maze" else caught)
    print(f"wrote {out} ({frames} frames, {result})", flush=True)
    return result


def main(name: str, device=None, episodes: int = 256, seeds: Optional[Sequence[int]] = None,
         html_out: Optional[str] = None, modes: Sequence[str] = ("det", "stoch"),
         spread: bool = False) -> dict:
    if name == "masked_ant_port":  # `modes` do not apply: the example evaluates det only
        if html_out or seeds or spread:
            raise ValueError("masked_ant_port replays reset seed 0 only, renders nothing and "
                             "gives no spread")
        result = {"episodes": episodes, **masked_ant_port(device, episodes)}
        print(json.dumps(result), flush=True)
        return result
    if html_out and CHECKPOINTS[name][2] is None:
        raise ValueError(f"{name}: the JAX package has no renderer for {CHECKPOINTS[name][0]}")
    learner, ts, same = load(name, device)
    if not same:
        raise RuntimeError(f"{npz_path(name)}: the loaded parameters do not match their "
                           "checksum")
    result = {"npz": os.path.basename(npz_path(name)), "epochs": ts.epochs, "checksum_ok": same,
              "episodes": episodes, **evaluate(name, learner, ts, episodes, seeds, modes, spread)}
    if html_out:
        result["html"] = render(name, learner, ts, html_out)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    which = parser.add_mutually_exclusive_group(required=True)
    for flag in ("--gather", "--gather-port", "--gather-bombmem", "--gather-bombmem-port",
                 "--maze", "--maze-port", "--heavenhell", "--masked-ant-port"):
        which.add_argument(flag, dest="name", action="store_const",
                           const=flag[2:].replace("-", "_"))
    parser.add_argument("--device", default=None)
    parser.add_argument("--episodes", type=int, default=256)
    parser.add_argument("--seeds", type=int, nargs="+", default=None)
    parser.add_argument("--html", default=None, help="write the rendered episode here")
    parser.add_argument("--modes", nargs="+", choices=("det", "stoch"), default=["det", "stoch"])
    parser.add_argument("--spread", action="store_true",
                        help="AntGather: also each mode's per-episode standard deviations")
    args = parser.parse_args()
    main(args.name, args.device, args.episodes, args.seeds, args.html, args.modes, args.spread)
