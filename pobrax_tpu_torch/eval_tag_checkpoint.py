"""Replay a committed AntTag checkpoint with the port.

The counterpart of `tools/eval_tag_checkpoint.py` and of the evaluation in
examples/train_ant_tag_sac_rnn.py: loads the numpy export of
`checkpoints/ant_tag_rnn_900M` (GRU-PPO, the default) or of
`checkpoints/ant_tag_sac_rnn_phase0_750M` (GRU-SAC, `--sac`), written by
`tools/export_torch_checkpoint.py`, or a GRU-PPO state the port trained
(`PORT_NPZ`, `tools/export_run_checkpoint.py --tag`), checks the loaded parameters against the
checksum stored beside them, and reports the TRUE sparse tag rate on 256
episodes of AntTag under ActionRepeat(6) -> Episode(1000) -> Vmap, as
`tag_rate_rnn` of examples/train_ant_tag_rnn.py measures it:
  * GRU-PPO: deterministic at reset seed 0 and stochastic at seed 1, on the
    env's default visible radius (3), as tools/eval_tag_checkpoint.py does;
  * GRU-SAC: deterministic and stochastic at seed 0, at the radius it was
    trained at (20) and at radius 4, as examples/train_ant_tag_sac_rnn.py
    evaluates it.
`--seeds S ...` runs every measurement at each of the seeds instead.

Usage: python -m pobrax_tpu_torch.eval_tag_checkpoint [npz] [--sac] [--device cpu]
[--episodes N] [--seeds S ...] (the card unless a device is named).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Optional, Sequence

from pobrax_tpu_torch import interop
from pobrax_tpu_torch.device import resolve
from pobrax_tpu_torch.envs.ant_tag import AntTagEnv
from pobrax_tpu_torch.examples.train_ant_tag_rnn import tag_rate_rnn
from pobrax_tpu_torch.training import checkpoint as ckpt
from pobrax_tpu_torch.training import ppo_rnn, sac_rnn

_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "checkpoints")
DEFAULT_NPZ = os.path.join(_DIR, "ant_tag_rnn_900M.npz")
SAC_NPZ = os.path.join(_DIR, "ant_tag_sac_rnn_phase0_750M.npz")
# the port's own AntTag curriculum run on the H100 (`train_ant_tag_rnn
# --curriculum --checkpoint-dir`, resumed across calls to its end, 900M): its
# final training state, exported by `tools/export_run_checkpoint.py --tag`,
# with its progress log beside it (`<npz without .npz>.progress.jsonl`), and
# its record; `--resume-from PORT_NPZ` seeds a run dir from them
PORT_NPZ = os.path.join(_DIR, "ant_tag_rnn_curriculum_900M_torch.npz")
PORT_RECORD = os.path.join(os.path.dirname(_DIR), "docs", "learning_ant_tag_curriculum.json")
ACTION_REPEAT = ppo_rnn.ANT_TAG.action_repeat  # the JAX package's HAI_ACTION_REPEAT, 6
HIDDEN = ppo_rnn.ANT_TAG.hidden_size
SAC_RADII = (20.0, 4.0)  # phase 0's radius, then train_ant_tag_sac_rnn.py's "true" one


def load(npz: str = DEFAULT_NPZ, device=None, sac: bool = False):
    """-> (learner, training state, checksum matches): an RNNPPOLearner or,
    with `sac` (a GRU-SAC export), an RSACLearner (no replay buffer) for
    AntTag with the checkpoint's state loaded on `device`."""
    env = AntTagEnv(device=resolve(device))
    if sac:
        cfg = dataclasses.replace(sac_rnn.ANT_TAG, num_envs=1, replay_capacity=1)
        learner = sac_rnn.RSACLearner(env, cfg)
    else:
        learner = ppo_rnn.RNNPPOLearner(env, ppo_rnn.ANT_TAG)
    tree = ckpt.load_npz(npz)
    ts = interop.training_state_from_numpy(tree, learner)
    same = interop.params_checksum(interop.params_to_numpy(ts.params)) == tree["params_sha256"]
    return learner, ts, same


def measurements(sac: bool, seeds: Optional[Sequence[int]] = None):
    """[(name, visible radius or None for the env's default, seed,
    deterministic)] of a checkpoint's report."""
    if sac:
        plan = [(f"r{r:g}_{m}", r, m == "det") for r in SAC_RADII for m in ("det", "stoch")]
        default = {name: 0 for name, _, _ in plan}
    else:
        plan = [("det", None, True), ("stoch", None, False)]
        default = {"det": 0, "stoch": 1}
    if seeds is None:
        return [(name, r, default[name], det) for name, r, det in plan]
    return [(f"{name}_s{s}", r, s, det) for s in seeds for name, r, det in plan]


def main(npz: Optional[str] = None, device: Optional[str] = None, episodes: int = 256,
         seeds: Optional[Sequence[int]] = None, sac: bool = False) -> dict:
    """`npz` defaults to the committed GRU-PPO export, or with `sac` the
    GRU-SAC one."""
    npz = npz or (SAC_NPZ if sac else DEFAULT_NPZ)
    learner, ts, same = load(npz, device, sac)
    if not same:
        raise RuntimeError(f"{npz}: the loaded parameters do not match their checksum")
    inference_fn, params = learner.make_inference_fn(), learner.inference_params(ts)
    result = {"npz": os.path.basename(npz), "epochs": ts.epochs, "checksum_ok": same,
              "episodes": episodes}
    for name, radius, seed, det in measurements(sac, seeds):
        env = AntTagEnv(device=learner.device,
                        **({} if radius is None else {"visible_radius": radius}))
        result[f"true_tag_rate_{name}"] = tag_rate_rnn(
            env, inference_fn, params, HIDDEN, episodes, action_repeat=ACTION_REPEAT, seed=seed,
            deterministic=det)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("npz", nargs="?", default=None)
    parser.add_argument("--sac", action="store_true", help="a GRU-SAC checkpoint")
    parser.add_argument("--device", default=None)
    parser.add_argument("--episodes", type=int, default=256)
    parser.add_argument("--seeds", type=int, nargs="+", default=None)
    args = parser.parse_args()
    main(args.npz, args.device, args.episodes, args.seeds, args.sac)
