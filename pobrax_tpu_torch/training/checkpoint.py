"""Checkpoint and resume of a training state; the port of
`pobrax_tpu/training/checkpoint.py`.

`save` writes a `TrainingState` (parameters, Adam state, normaliser, epoch
count) as plain tensors with `torch.save` into a directory; `restore` loads
it into a template from the same learner's `init`, on the template's
device. `latest_step_dir` / `save_step` keep the JAX package's
`root/step_000001000` layout. `load_npz` reads a JAX training state exported
to numpy (`tools/export_torch_checkpoint.py`); `interop` turns it into the
port's state.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

_FILE = "state.pt"


def _state_dict(ts) -> Dict[str, Any]:
    return {"params": ts.params.state_dict(),
            "opt_state": dataclasses.asdict(ts.opt_state),
            "normalizer": dataclasses.asdict(ts.normalizer),
            "epochs": ts.epochs}


def save(path: str, ts) -> None:
    """Save a TrainingState into the directory `path` (made if missing)."""
    os.makedirs(path, exist_ok=True)
    torch.save(_state_dict(ts), os.path.join(path, _FILE))


def restore(path: str, template):
    """The TrainingState saved at `path`, loaded into `template`'s modules
    and onto its device (pass a `learner.init(key)` result)."""
    device = next(template.params.parameters()).device
    saved = torch.load(os.path.join(path, _FILE), map_location=device, weights_only=True)
    template.params.load_state_dict(saved["params"])
    return dataclasses.replace(
        template,
        opt_state=type(template.opt_state)(**saved["opt_state"]),
        normalizer=type(template.normalizer)(**saved["normalizer"]),
        epochs=int(saved["epochs"]))


def latest_step_dir(root: str) -> Optional[str]:
    """The lexicographically latest `step_*` directory under `root`, or None."""
    if not os.path.isdir(root):
        return None
    steps = sorted(d for d in os.listdir(root) if d.startswith("step_"))
    return os.path.join(root, steps[-1]) if steps else None


def save_step(root: str, step: int, ts) -> str:
    path = os.path.join(root, f"step_{step:012d}")
    save(path, ts)
    return path


def load_npz(path: str) -> Dict[str, Any]:
    """An exported JAX training state: the npz's '/'-joined leaf paths back
    into nested dicts of numpy arrays (e.g. `tree["params"]["params"]
    ["enc_0"]["kernel"]`); string entries (the parameters' checksum) stay as
    Python strings."""
    tree: Dict[str, Any] = {}
    with np.load(path, allow_pickle=False) as z:
        for name in z.files:
            node = tree
            *parents, leaf = name.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            value = z[name]
            node[leaf] = str(value) if value.dtype.kind == "U" else value
    return tree
