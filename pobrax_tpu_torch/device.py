"""Device selection for the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: "cuda" unless the caller names one.

    With no device given and no GPU present this raises rather than quietly
    running on the CPU; callers that want the CPU path say `device="cpu"`."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "pobrax_tpu_torch runs on CUDA by default and no GPU is "
                "available; pass device='cpu' to run the plain PyTorch path")
        return torch.device("cuda")
    return torch.device(device)
