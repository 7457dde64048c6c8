"""Compiled per-body static arrays.

A copy of `pobrax_tpu/physics/bodies.py`, numpy only. The port keeps its own
copy because importing any `pobrax_tpu` module pulls in jax;
tests/test_torch_scene.py holds the two to the same compiled tables.

Host-side compilation of `config.Body` tuples into numpy arrays that the
step functions read as constants. Provides the `sys.body.index`
name->int contract the reference envs rely on
(po-brax po_brax/envs/ant_tag.py:57-58).

Inertia is a body-frame diagonal treated as world-diagonal during dynamics —
the same simplification the legacy-Brax-era engine used (every reference body
carries inertia (1,1,1), making this exact for the suite's models).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from pobrax_tpu_torch.physics import config as pcfg


class Bodies:
    """Static per-body quantities: masses, inertias, frozen masks, name index."""

    def __init__(self, cfg: pcfg.Config):
        n = len(cfg.bodies)
        self.count = n
        self.names = tuple(b.name for b in cfg.bodies)
        self.index: Dict[str, int] = {name: i for i, name in enumerate(self.names)}

        self.mass = np.array([b.mass for b in cfg.bodies], np.float32)
        self.inertia = np.array([b.inertia for b in cfg.bodies], np.float32)
        frozen = np.array([b.frozen for b in cfg.bodies], bool)
        self.frozen = frozen
        # active = 1.0 for dynamic bodies, 0.0 for frozen — multiplied into every update
        self.active = (~frozen).astype(np.float32)[:, None]  # (n, 1) broadcast over xyz

        # per-axis masks: 1.0 where the component may update (planar models
        # freeze y-translation + x/z-rotation; frozen=True freezes all)
        fpos = np.array([b.frozen_position for b in cfg.bodies], np.float32)
        frot = np.array([b.frozen_rotation for b in cfg.bodies], np.float32)
        self.active_pos = self.active * (1.0 - np.clip(fpos, 0.0, 1.0))  # (n, 3)
        self.active_rot = self.active * (1.0 - np.clip(frot, 0.0, 1.0))  # (n, 3)

        inv_mass = np.where(frozen, 0.0, 1.0 / self.mass).astype(np.float32)
        inv_inertia = np.where(frozen[:, None], 0.0, 1.0 / self.inertia).astype(np.float32)
        self.inv_mass = inv_mass  # (n,)
        self.inv_inertia = inv_inertia  # (n, 3)
