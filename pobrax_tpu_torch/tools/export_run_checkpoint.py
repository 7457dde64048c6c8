"""Export a GRU-PPO training state that the port saved to the numpy file
`eval_checkpoint` loads, as tools/export_torch_checkpoint.py does for the
JAX package's orbax checkpoints.

Restores the latest `step_*` directory under CKPT_DIR (the layout of
`training/checkpoint.save_step`: the `--checkpoint-dir` of
`examples.train_heavenhell_rnn`, with `--tag` of
`examples.train_ant_tag_rnn --curriculum`, with `--maze` of
`examples.train_ant_maze_rnn`, with `--gather` of
`examples.train_ant_gather_rnn curriculum`, with `--masked-ant ARM` an
arm's subdirectory of `examples.train_masked_ant`'s) into the learner that
`eval_checkpoint.load("heavenhell")` builds (with `--tag`,
`eval_tag_checkpoint.load`'s AntTag GRU-PPO learner; with `--maze` /
`--gather`, `eval_checkpoint.load("maze")`'s AntMaze / `load("gather")`'s
AntGather one; with `--masked-ant ARM`, `train_masked_ant.learner_for(ARM)`:
PPO for "ff_full" and "ff_masked", GRU-PPO for "gru_masked"), and writes
`interop.training_state_to_numpy` of it, each leaf under its '/'-joined
path (params, opt_state/{count,mu,nu}, normalizer, epochs), plus
`params_sha256` (`interop.params_checksum`). A masked-ant arm's file keeps
params, normalizer and epochs only: Adam's moments would take a
feed-forward arm's file past 3 MB, and a replay needs none of them (the
run's step dirs keep them).

Usage: python -m pobrax_tpu_torch.tools.export_run_checkpoint CKPT_DIR OUT.npz
       [--tag | --maze | --gather | --masked-ant ARM] [--device cpu]   (at most one)
(the card unless a device is named)
"""

from __future__ import annotations

import os
import sys
from typing import Dict, Iterator, Tuple

import numpy as np

from pobrax_tpu_torch import eval_checkpoint, interop
from pobrax_tpu_torch import random as jr
from pobrax_tpu_torch.device import resolve
from pobrax_tpu_torch.envs.ant_tag import AntTagEnv
from pobrax_tpu_torch.examples import train_masked_ant
from pobrax_tpu_torch.examples._common import make_parent, split_options
from pobrax_tpu_torch.training import checkpoint as ckpt
from pobrax_tpu_torch.training import ppo_rnn


def leaves(tree, path: Tuple[str, ...] = ()) -> Iterator[Tuple[str, np.ndarray]]:
    """('/'-joined path, array) for every leaf of a nested dict."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], path + (str(k),))
    else:
        yield "/".join(path), np.asarray(tree)


MASKED_ANT = "masked_ant_"  # + the arm: the `name` of a masked-ant arm's state


def learner_for(name: str, device=None):
    """The learner a run's state restores into, at the examples' widths:
    AntTag's for "tag", a masked-ant arm's for MASKED_ANT + the arm, else
    `eval_checkpoint.learner_for(name)` ("heavenhell", "maze" or
    "gather")."""
    if name.startswith(MASKED_ANT):
        return train_masked_ant.learner_for(name[len(MASKED_ANT):], device, "ant")
    if name == "tag":
        return ppo_rnn.RNNPPOLearner(AntTagEnv(device=resolve(device)), ppo_rnn.ANT_TAG)
    return eval_checkpoint.learner_for(name, device)


def arrays(ckpt_dir: str, device=None, name: str = "heavenhell") -> Dict[str, np.ndarray]:
    """The npz's entries for the latest state saved under `ckpt_dir`."""
    learner = learner_for(name, device)
    ts = ckpt.restore(ckpt.latest_step_dir(ckpt_dir) or ckpt_dir,
                      template=learner.init(jr.PRNGKey(0, learner.device)))
    tree = interop.training_state_to_numpy(ts)
    if name.startswith(MASKED_ANT):
        del tree["opt_state"]
    out = dict(leaves(tree))
    out["params_sha256"] = np.array(interop.params_checksum(tree["params"]))
    return out


def export(ckpt_dir: str, out: str, device=None, name: str = "heavenhell") -> None:
    entries = arrays(ckpt_dir, device, name)
    np.savez(make_parent(out), **entries)
    print(f"wrote {out}: {len(entries) - 1} leaves, epochs {int(entries['epochs'])}, "
          f"{os.path.getsize(out)} bytes, params sha256 {entries['params_sha256']}", flush=True)


if __name__ == "__main__":
    args, device, _, arm = split_options(sys.argv[1:], "--masked-ant")
    flags = ("--tag", "--maze", "--gather")
    names = [a[2:] for a in args if a in flags] + ([MASKED_ANT + arm] if arm else [])
    if len(names) > 1:
        sys.exit("export_run_checkpoint: give at most one of --tag, --maze, --gather and "
                 "--masked-ant")
    if arm is not None and arm not in train_masked_ant.ARMS:
        sys.exit(f"export_run_checkpoint: --masked-ant takes one of {train_masked_ant.ARMS}")
    export(*[a for a in args if a not in flags][:2], device=device,
           name=(names or ["heavenhell"])[0])
