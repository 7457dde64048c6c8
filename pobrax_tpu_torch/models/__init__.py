"""Networks of the port; the counterpart of `pobrax_tpu/models/`."""

from pobrax_tpu_torch.models.networks import MLP, SNMLP, SNDense, make_model, make_models

__all__ = ["MLP", "SNDense", "SNMLP", "make_model", "make_models"]
