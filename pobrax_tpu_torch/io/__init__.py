"""IO layer: trajectory visualization (`html`)."""

from pobrax_tpu_torch.io import html

__all__ = ["html"]
