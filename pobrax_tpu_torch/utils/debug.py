"""Debug guards: NaN/Inf checking and determinism probes; the port of
`pobrax_tpu/utils/debug.py`.

A step-fn wrapper that raises on a non-finite floating output tensor, and a
determinism probe that re-runs a rollout and compares bit-exactly (same seed
=> same trajectory is this framework's RNG-threading contract).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, Tuple

import numpy as np
import torch

from pobrax_tpu_torch import device as _device
from pobrax_tpu_torch import random as jr


def _leaves(x: Any, path: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    """(path, tensor) for every tensor in nested dataclasses, dicts, lists
    and tuples (State, QP, Info, metrics dicts)."""
    if isinstance(x, torch.Tensor):
        yield path, x
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        for f in dataclasses.fields(x):
            yield from _leaves(getattr(x, f.name), f"{path}.{f.name}")
    elif isinstance(x, dict):
        for k, v in x.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(x, (list, tuple)):
        for i, v in enumerate(x):
            yield from _leaves(v, f"{path}[{i}]")


def nan_guard(fn: Callable, name: str = "step") -> Callable:
    """Wrap `fn` so that any non-finite floating output tensor raises
    FloatingPointError. Each check reads the card's result on the host:
    enable behind your own debug flag, not on the hot path."""
    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        for path, leaf in _leaves(out):
            if leaf.is_floating_point() and not bool(torch.isfinite(leaf).all()):
                raise FloatingPointError(f"{name}: non-finite values at {path or '<output>'}")
        return out

    return wrapped


def assert_deterministic(rollout_fn: Callable[[torch.Tensor], Any], seed: int = 0,
                         device=None) -> None:
    """Run `rollout_fn(key)` twice with the same key (on `device`: the card
    unless given) and assert bit-exact equality of every output tensor."""
    key = jr.PRNGKey(seed, _device.resolve(device))
    a, b = (list(_leaves(rollout_fn(key))) for _ in range(2))
    if [p for p, _ in a] != [p for p, _ in b]:
        raise AssertionError("the two runs returned different structures")
    for (path, la), (_, lb) in zip(a, b):
        np.testing.assert_array_equal(la.detach().cpu().numpy(), lb.detach().cpu().numpy(),
                                      err_msg=path)
