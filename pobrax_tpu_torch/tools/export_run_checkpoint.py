"""Export a GRU-PPO training state that the port saved to the numpy file
`eval_checkpoint` loads, as tools/export_torch_checkpoint.py does for the
JAX package's orbax checkpoints.

Restores the latest `step_*` directory under CKPT_DIR (the layout of
`training/checkpoint.save_step`: the `--checkpoint-dir` of
`examples.train_heavenhell_rnn`, with `--tag` of
`examples.train_ant_tag_rnn --curriculum`, with `--maze` of
`examples.train_ant_maze_rnn`, with `--gather` of
`examples.train_ant_gather_rnn curriculum`) into the learner that
`eval_checkpoint.load("heavenhell")` builds (with `--tag`,
`eval_tag_checkpoint.load`'s AntTag GRU-PPO learner; with `--maze` /
`--gather`, `eval_checkpoint.load("maze")`'s AntMaze / `load("gather")`'s
AntGather one), and writes
`interop.training_state_to_numpy` of it, each leaf under its '/'-joined
path (params, opt_state/{count,mu,nu}, normalizer, epochs), plus
`params_sha256` (`interop.params_checksum`).

Usage: python -m pobrax_tpu_torch.tools.export_run_checkpoint CKPT_DIR OUT.npz
       [--tag | --maze | --gather] [--device cpu]   (at most one of the three)
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


def learner_for(name: str, device=None) -> ppo_rnn.RNNPPOLearner:
    """The learner a run's state restores into, at the examples' widths:
    AntTag's for "tag", else `eval_checkpoint.learner_for(name)` ("heavenhell",
    "maze" or "gather")."""
    if name == "tag":
        return ppo_rnn.RNNPPOLearner(AntTagEnv(device=resolve(device)), ppo_rnn.ANT_TAG)
    return eval_checkpoint.learner_for(name, device)


def arrays(ckpt_dir: str, device=None, name: str = "heavenhell") -> Dict[str, np.ndarray]:
    """The npz's entries for the latest state saved under `ckpt_dir`."""
    learner = learner_for(name, device)
    ts = ckpt.restore(ckpt.latest_step_dir(ckpt_dir) or ckpt_dir,
                      template=learner.init(jr.PRNGKey(0, learner.device)))
    tree = interop.training_state_to_numpy(ts)
    out = dict(leaves(tree))
    out["params_sha256"] = np.array(interop.params_checksum(tree["params"]))
    return out


def export(ckpt_dir: str, out: str, device=None, name: str = "heavenhell") -> None:
    entries = arrays(ckpt_dir, device, name)
    np.savez(make_parent(out), **entries)
    print(f"wrote {out}: {len(entries) - 1} leaves, epochs {int(entries['epochs'])}, "
          f"{os.path.getsize(out)} bytes, params sha256 {entries['params_sha256']}", flush=True)


if __name__ == "__main__":
    args, device, _ = split_options(sys.argv[1:])
    flags = ("--tag", "--maze", "--gather")
    names = [a[2:] for a in args if a in flags]
    if len(names) > 1:
        sys.exit("export_run_checkpoint: give at most one of --tag, --maze and --gather")
    export(*[a for a in args if a not in flags][:2], device=device,
           name=(names or ["heavenhell"])[0])
