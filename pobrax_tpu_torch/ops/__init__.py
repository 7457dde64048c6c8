"""Numeric core ops on tensors, batch-first: quaternion algebra and vector
helpers on the last axis, broadcasting over leading axes; the port of
`pobrax_tpu/ops/`."""

from pobrax_tpu_torch.ops.quaternion import (
    ang_to_quat,
    euler_to_quat,
    inv_rotate,
    quat_inv,
    quat_mul,
    quat_rot_axis,
    quat_to_axis_angle,
    relative_quat,
    rotate,
)
from pobrax_tpu_torch.ops.vector import cross, norm, normalize, safe_norm

__all__ = [
    "ang_to_quat",
    "euler_to_quat",
    "quat_inv",
    "quat_mul",
    "quat_rot_axis",
    "quat_to_axis_angle",
    "relative_quat",
    "rotate",
    "inv_rotate",
    "cross",
    "norm",
    "normalize",
    "safe_norm",
]
