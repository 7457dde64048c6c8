"""State crossing between the JAX package and the port, through numpy.

`qp_from_numpy` and `state_from_numpy` take a JAX `QP` or env `State` — or
anything shaped like one: objects with the same attributes, or dicts with
the same keys, whose leaves convert with `np.asarray` — and return the
port's tensor dataclasses. JAX keys (uint32 pairs, last axis 2) become the
port's int64 keys with the same words. `state_to_numpy` goes the other way,
to nested dicts of numpy arrays with keys as uint32 again, and
`state_from_numpy(state_to_numpy(s))` rebuilds `s`. Info entries that are
QPs (`first_qp`) or `EvalMetrics` (`eval_metrics`) keep their type; the other
entries (keys, the exploration wrapper's grids, gather's metrics) are
tensors or dicts of them.

Both entry points run on the card unless the caller names another device
(`device.resolve`): with no device and no GPU they raise.

Nothing here imports jax: the leaves are read as numpy arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from pobrax_tpu_torch.device import resolve
from pobrax_tpu_torch.envs.base import State
from pobrax_tpu_torch.envs.wrappers import EvalMetrics
from pobrax_tpu_torch.physics.state import QP

_QP_FIELDS = ("pos", "rot", "vel", "ang")
_STATE_FIELDS = ("qp", "obs", "reward", "done", "metrics", "info")
_EVAL_FIELDS = tuple(f.name for f in dataclasses.fields(EvalMetrics))


def _get(obj, name):
    return obj[name] if isinstance(obj, dict) else getattr(obj, name)


def _has_fields(obj, fields) -> bool:
    if isinstance(obj, dict):
        return set(obj) == set(fields)
    return all(hasattr(obj, f) for f in fields) and not hasattr(obj, "shape")


def _is_qp(obj) -> bool:
    return isinstance(obj, QP) or _has_fields(obj, _QP_FIELDS)


def _tensor(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype == np.uint32:  # a key: int64 words in [0, 2**32)
        return torch.as_tensor(a.astype(np.int64), device=device)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.as_tensor(a.copy(), device=device)


def qp_from_numpy(qp: Any, device=None) -> QP:
    """A QP-shaped object with numpy-convertible leaves -> the port's QP on
    `device` (the card unless the caller names another)."""
    device = resolve(device)
    return QP(**{f: _tensor(_get(qp, f), device) for f in _QP_FIELDS})


def _leaf_from_numpy(x, device):
    if _is_qp(x):
        return qp_from_numpy(x, device)
    if isinstance(x, EvalMetrics) or _has_fields(x, _EVAL_FIELDS):
        return EvalMetrics(**{f: _leaf_from_numpy(_get(x, f), device) for f in _EVAL_FIELDS})
    if isinstance(x, dict):
        return {k: _leaf_from_numpy(v, device) for k, v in x.items()}
    return _tensor(x, device)


def state_from_numpy(state: Any, device=None) -> State:
    """A State-shaped object (qp, obs, reward, done, metrics, info) -> the
    port's State on `device` (the card unless the caller names another).
    Info entries that are QPs (`first_qp`) become QPs; uint32 key arrays
    become int64 keys."""
    device = resolve(device)
    return State(**{f: _leaf_from_numpy(_get(state, f), device) for f in _STATE_FIELDS})


def _to_numpy(x):
    if isinstance(x, QP):
        return {f: _to_numpy(getattr(x, f)) for f in _QP_FIELDS}
    if isinstance(x, EvalMetrics):
        return {f: _to_numpy(getattr(x, f)) for f in _EVAL_FIELDS}
    if isinstance(x, dict):
        return {k: _to_numpy(v) for k, v in x.items()}
    a = x.detach().cpu().numpy()
    return a.astype(np.uint32) if a.dtype == np.int64 else a


def state_to_numpy(state: State) -> Dict[str, Any]:
    """The port's State -> nested dicts of numpy arrays; int64 keys become
    uint32 words as in JAX."""
    return {f: _to_numpy(getattr(state, f)) for f in _STATE_FIELDS}
