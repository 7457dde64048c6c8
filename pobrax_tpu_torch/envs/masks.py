"""Per-env observation index tables for building PO variants of stock envs;
a copy of `pobrax_tpu/envs/masks.py`, numpy only (the port keeps its own
copy because importing any `pobrax_tpu` module pulls in jax;
tests/test_torch_masks.py holds the two equal).

Re-expression of po-brax's standard_observability_masks.py: index arrays
partitioning each stock env's flat observation vector into semantic segments
(POSITION, VELOCITY, TARGET_POS, OBJECT_POS, HEADINGS, CFRC). Like the
reference, this is a library surface: tables cover the full stock suite,
including envs whose physics models land in later rounds.

Stored as numpy arrays (host-side constants); `segment_mask` compiles a set
of segments into a single boolean keep-mask applied inside the step
(obs = where(mask, obs, 0)) — one elementwise op, no gather.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def _r(a: int, b: int) -> np.ndarray:
    return np.arange(a, b)


def _cat(*parts: np.ndarray) -> np.ndarray:
    return np.concatenate(parts, axis=0)


# qpos-like segments (reference :5-21)
POSITION: Dict[str, np.ndarray] = {
    "acrobot": _r(0, 2),
    "ant": _r(0, 13),
    "fetch": _cat(_r(0, 6), _r(10, 49)),
    "grasp": _r(8, 56),
    "halfcheetah": _r(0, 11),
    "hopper": _r(0, 8),
    "humanoid": _cat(_r(0, 22), _r(45, 144)),
    "humanoidstandup": _cat(_r(0, 22), _r(45, 144)),
    "inverted_pendulum": _r(0, 6),
    "inverted_double_pendulum": _r(0, 5),
    "reacher": _r(4, 6),
    "reacherangle": _r(4, 6),
    "ur5e": _cat(_r(0, 6), _r(10, 34)),
    "walker2d": _r(0, 11),
}

# qvel-like segments (reference :24-39)
VELOCITY: Dict[str, np.ndarray] = {
    "acrobot": _r(2, 4),
    "ant": _r(13, 27),
    "fetch": _r(49, 88),
    "grasp": _cat(_r(56, 104), _r(107, 110)),
    "halfcheetah": _r(11, 23),
    "hopper": _r(8, 14),
    "humanoid": _cat(_r(22, 45), _r(144, 210)),
    "humanoidstandup": _cat(_r(22, 45), _r(144, 210)),
    "inverted_pendulum": _r(6, 10),
    "inverted_double_pendulum": _r(5, 25),
    "reacher": _r(6, 8),
    "reacherangle": _r(6, 8),
    "ur5e": _r(34, 58),
    "walker2d": _r(11, 20),
}

# target-position segments (reference :42-48)
TARGET_POS: Dict[str, np.ndarray] = {
    "fetch": _r(6, 10),
    "grasp": _r(4, 8),
    "reacher": _cat(_r(0, 4), _r(8, 11)),
    "reacherangle": _cat(_r(0, 4), _r(8, 11)),
    "ur5e": _r(6, 10),
}

# movable-object position segments (reference :51-53)
OBJECT_POS: Dict[str, np.ndarray] = {
    "grasp": _r(0, 4),
}

# heading segments (reference :56-58)
HEADINGS: Dict[str, np.ndarray] = {
    "grasp": _cat(_r(104, 107), _r(110, 116)),
}

# contact-force segments (reference :61-68)
CFRC: Dict[str, np.ndarray] = {
    "ant": _r(27, 87),
    "fetch": _r(88, 101),
    "grasp": _r(116, 132),
    "humanoid": _r(210, 299),
    "humanoidstandup": _r(210, 299),
    "ur5e": _r(58, 66),
}

SEGMENTS: Dict[str, Dict[str, np.ndarray]] = {
    "POSITION": POSITION,
    "VELOCITY": VELOCITY,
    "TARGET_POS": TARGET_POS,
    "OBJECT_POS": OBJECT_POS,
    "HEADINGS": HEADINGS,
    "CFRC": CFRC,
}


def segment_indices(env_name: str, segment: str) -> np.ndarray:
    """Index array of `segment` for `env_name`; raises KeyError if absent."""
    return SEGMENTS[segment][env_name]


def segment_mask(env_name: str, obs_size: int, hidden: Sequence[str]) -> np.ndarray:
    """Boolean keep-mask of length obs_size with the given segments hidden."""
    mask = np.ones(obs_size, dtype=bool)
    for seg in hidden:
        idx = SEGMENTS[seg].get(env_name)
        if idx is None:
            raise KeyError(f"env {env_name!r} has no {seg} segment")
        mask[idx] = False
    return mask
