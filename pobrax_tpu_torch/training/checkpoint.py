"""Checkpoint and resume of a training state; the port of
`pobrax_tpu/training/checkpoint.py`.

`save` writes a learner's training state as plain tensors with
`torch.save` into a directory: every field of the state dataclass (modules
as state dicts, the Adam and normaliser states as dicts, the epoch count)
except the replay buffer and its priority table, which the off-policy
learners refill on resume, as the JAX package's `_ckpt_slice` leaves them
out. `restore` loads it into a template from the same learner's `init`, on
the template's device. `latest_step_dir` / `save_step` keep the JAX package's
`root/step_000001000` layout; under a mesh only rank 0 writes (as the JAX
package's "only process 0 writes") and every rank waits for it at a barrier,
and every rank restores. `load_npz` reads a JAX training state exported
to numpy (`tools/export_torch_checkpoint.py`); `interop` turns it into the
port's state.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from pobrax_tpu_torch.parallel.mesh import barrier

_FILE = "state.pt"


_NOT_SAVED = ("buffer", "priorities")


def _state_dict(ts) -> Dict[str, Any]:
    out = {}
    for f in dataclasses.fields(ts):
        if f.name in _NOT_SAVED:
            continue
        v = getattr(ts, f.name)
        out[f.name] = (v.state_dict() if isinstance(v, nn.Module)
                       else dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v)
    return out


def save(path: str, ts) -> None:
    """Save a training state into the directory `path` (made if missing)."""
    os.makedirs(path, exist_ok=True)
    torch.save(_state_dict(ts), os.path.join(path, _FILE))


def restore(path: str, template):
    """The training state saved at `path`, loaded into `template`'s modules
    and onto its device (pass a `learner.init(key)` result); the fields that
    are not saved keep the template's."""
    device = next(template.params.parameters()).device
    saved = torch.load(os.path.join(path, _FILE), map_location=device, weights_only=True)
    changes = {}
    for name, v in saved.items():
        old = getattr(template, name)
        if isinstance(old, nn.Module):
            old.load_state_dict(v)
        elif dataclasses.is_dataclass(old):
            changes[name] = type(old)(**v)
        else:
            changes[name] = type(old)(v)
    return dataclasses.replace(template, **changes)


def latest_step_dir(root: str) -> Optional[str]:
    """The lexicographically latest `step_*` directory under `root`, or None."""
    if not os.path.isdir(root):
        return None
    steps = sorted(d for d in os.listdir(root) if d.startswith("step_"))
    return os.path.join(root, steps[-1]) if steps else None


def save_step(root: str, step: int, ts, mesh=None) -> str:
    """Save `ts` under `root/step_<step>`; with a `mesh`, process 0 writes
    and every process meets the others at a barrier after it. The state is
    written beside the step dir and renamed into place, so a process killed
    mid-save leaves no step dir that a resume would pick and fail to load."""
    path = os.path.join(root, f"step_{step:012d}")
    if mesh is None or mesh.process_rank == 0:
        partial = os.path.join(root, f".partial_step_{step:012d}")
        shutil.rmtree(partial, ignore_errors=True)
        save(partial, ts)
        shutil.rmtree(path, ignore_errors=True)
        os.replace(partial, path)
    barrier(mesh)
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
