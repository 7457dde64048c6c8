"""Export a GRU-PPO training state that the port saved to the numpy file
`eval_checkpoint` loads, as tools/export_torch_checkpoint.py does for the
JAX package's orbax checkpoints.

Restores the latest `step_*` directory under CKPT_DIR (the layout of
`training/checkpoint.save_step`: the `--checkpoint-dir` of
`examples.train_heavenhell_rnn`) into the learner that
`eval_checkpoint.load("heavenhell")` builds, and writes
`interop.training_state_to_numpy` of it, each leaf under its '/'-joined
path (params, opt_state/{count,mu,nu}, normalizer, epochs), plus
`params_sha256` (`interop.params_checksum`).

Usage: python -m pobrax_tpu_torch.tools.export_run_checkpoint CKPT_DIR OUT.npz
       [--device cpu]
(the card unless a device is named)
"""

from __future__ import annotations

import os
import sys
from typing import Dict, Iterator, Tuple

import numpy as np

from pobrax_tpu_torch import eval_checkpoint, interop
from pobrax_tpu_torch import random as jr
from pobrax_tpu_torch.examples._common import make_parent, split_options
from pobrax_tpu_torch.training import checkpoint as ckpt


def leaves(tree, path: Tuple[str, ...] = ()) -> Iterator[Tuple[str, np.ndarray]]:
    """('/'-joined path, array) for every leaf of a nested dict."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], path + (str(k),))
    else:
        yield "/".join(path), np.asarray(tree)


def arrays(ckpt_dir: str, device=None) -> Dict[str, np.ndarray]:
    """The npz's entries for the latest state saved under `ckpt_dir`."""
    learner = eval_checkpoint.learner_for("heavenhell", device)
    ts = ckpt.restore(ckpt.latest_step_dir(ckpt_dir) or ckpt_dir,
                      template=learner.init(jr.PRNGKey(0, learner.device)))
    tree = interop.training_state_to_numpy(ts)
    out = dict(leaves(tree))
    out["params_sha256"] = np.array(interop.params_checksum(tree["params"]))
    return out


def export(ckpt_dir: str, out: str, device=None) -> None:
    entries = arrays(ckpt_dir, device)
    np.savez(make_parent(out), **entries)
    print(f"wrote {out}: {len(entries) - 1} leaves, epochs {int(entries['epochs'])}, "
          f"{os.path.getsize(out)} bytes, params sha256 {entries['params_sha256']}", flush=True)


if __name__ == "__main__":
    args, device, _ = split_options(sys.argv[1:])
    export(*args[:2], device=device)
