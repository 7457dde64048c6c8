"""Batched rigid-body spring physics in PyTorch (the port of `pobrax_tpu.physics`).

Layers:
  * `config`, `ant`, `scene`, `bodies` — numpy scene description (copies)
  * `system`      — compiled System: default_qp FK, step(qp, act), info(qp)
  * `state`       — QP / P / Info tensor dataclasses, batch-first
  * `joints`, `geometry`, `integrator` — the plain batched step
  * `step_tables`, `whole_step` — the whole-step CUDA kernel and its tables
"""

from pobrax_tpu_torch.physics import ant, config, scene
from pobrax_tpu_torch.physics.state import QP, Info, P
from pobrax_tpu_torch.physics.system import System

__all__ = ["ant", "config", "scene", "System", "QP", "P", "Info"]
