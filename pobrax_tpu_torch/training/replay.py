"""Device-resident ring replay buffer; the port of
`pobrax_tpu/training/replay.py`.

Storage is a dict of (capacity, ...) tensors on the device, allocated once
from one sample; `insert` writes one slot in place. The write position and
the fill level are host integers (the JAX package keeps them as device
scalars): every `insert` is one per epoch step of a host loop, so the host
always knows them, and neither the learners' `min_replay` branch nor a
draw's bound waits on the device.

Prioritized replay over (slot, column) pairs keeps a (capacity, columns)
float32 table beside the buffer: `sample_prioritized` is one categorical
draw over the flattened table, as in JAX. Keys follow jax's threefry
(`pobrax_tpu_torch.random`), so from the same key a draw picks the same
slots and columns as JAX's.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from pobrax_tpu_torch import random as jr


@dataclass
class ReplayState:
    data: Dict[str, torch.Tensor]  # (capacity, ...) per field
    insert_pos: int                # next write slot
    size: int                      # valid slots

    @property
    def capacity(self) -> int:
        return next(iter(self.data.values())).shape[0]

    def replace(self, **changes) -> "ReplayState":
        return dataclasses.replace(self, **changes)


def init(sample: Dict[str, torch.Tensor], capacity: int) -> ReplayState:
    """Zeroed storage shaped (capacity, *x.shape) for every field of one
    sample, on the sample's device."""
    data = {k: torch.zeros((capacity,) + tuple(x.shape), dtype=x.dtype, device=x.device)
            for k, x in sample.items()}
    return ReplayState(data=data, insert_pos=0, size=0)


def insert(state: ReplayState, sample: Dict[str, torch.Tensor]) -> ReplayState:
    """Write one slot (in place) and advance the ring."""
    for k, buf in state.data.items():
        buf[state.insert_pos].copy_(sample[k])
    capacity = state.capacity
    return state.replace(insert_pos=(state.insert_pos + 1) % capacity,
                         size=min(state.size + 1, capacity))


def sample(state: ReplayState, key: torch.Tensor, batch: int) -> Dict[str, torch.Tensor]:
    """Uniform sample of `batch` whole slots, with replacement."""
    idx = jr.randint(key, (batch,), 0, max(state.size, 1)).long()
    return {k: buf[idx] for k, buf in state.data.items()}


def sample_transitions(state: ReplayState, key: torch.Tensor,
                       batch: int) -> Dict[str, torch.Tensor]:
    """Uniform sample of `batch` single transitions, with replacement, from
    (capacity, columns, ...) storage: independent (slot, column) pairs."""
    cols = next(iter(state.data.values())).shape[1]
    k_slot, k_col = jr.split(key, 2).unbind(-2)
    slot = jr.randint(k_slot, (batch,), 0, max(state.size, 1)).long()
    col = jr.randint(k_col, (batch,), 0, cols).long()
    return {k: buf[slot, col] for k, buf in state.data.items()}


# ---- prioritized sampling over (slot, column) pairs -------------------------


def priorities_init(capacity: int, columns: int, device) -> torch.Tensor:
    """Zeroed (capacity, columns) table; 0 marks never-written entries."""
    return torch.zeros(capacity, columns, device=device)


def priorities_on_insert(pri: torch.Tensor, slot: int) -> torch.Tensor:
    """A freshly written slot gets the table's max priority (at least 1), in
    place."""
    pri[slot] = torch.clamp(pri.max(), min=1.0)
    return pri


def sample_prioritized(pri: torch.Tensor, key: torch.Tensor, batch: int, alpha: float,
                       beta: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`batch` (slot, col) pairs drawn with P(i) ∝ p_i^alpha, with
    replacement, and their importance weights (N P(i))^-beta over their max.
    Needs at least one written entry."""
    valid = pri > 0
    pa = torch.where(valid, torch.pow(pri, alpha), torch.zeros_like(pri))
    logits = torch.where(valid, torch.log(torch.clamp(pa, min=1e-30)),
                         torch.full_like(pri, -torch.inf))
    flat = jr.categorical(key, logits.reshape(-1), (batch,))
    columns = pri.shape[1]
    slot, col = flat // columns, flat % columns
    probs = (pa / torch.clamp(pa.sum(), min=1e-30)).reshape(-1)[flat]
    n = torch.clamp(valid.sum().float(), min=1.0)
    w = torch.pow(n * torch.clamp(probs, min=1e-30), -beta)
    return slot, col, w / torch.clamp(w.max(), min=1e-30)


def priorities_update(pri: torch.Tensor, slot: torch.Tensor, col: torch.Tensor,
                      td_abs: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """Write |TD| + eps for the drawn pairs, in place. Where a pair was drawn
    more than once the last draw's value wins, as JAX's scatter gives it on
    the CPU: every write of a pair carries that value, so the order in which
    the device performs the writes does not matter."""
    flat = slot * pri.shape[1] + col
    order = torch.arange(flat.shape[0], device=flat.device)
    last = torch.full((pri.numel(),), -1, dtype=order.dtype, device=flat.device)
    last.scatter_reduce_(0, flat, order, reduce="amax")
    pri.view(-1)[flat] = (td_abs + eps)[last[flat]]
    return pri
