"""The port's learners; the counterpart of `pobrax_tpu/training/`.

`ppo` (feed-forward PPO) and `ppo_rnn` (GRU-PPO), the off-policy `sac` and
`sac_rnn` (GRU-SAC) with their `replay` buffer, and their pieces:
`distribution`, `running_statistics`, `optimizer` (optax's clip-by-global-norm
+ Adam, written out over one flat vector) and `checkpoint`. `networks` is the
models layer, re-exported at the reference's `po_brax.training.networks`
path, as the JAX package does.
"""

from pobrax_tpu_torch.models import networks
from pobrax_tpu_torch.training import (distribution, ppo, ppo_rnn, replay,
                                       running_statistics, sac, sac_rnn)

__all__ = ["networks", "distribution", "ppo", "ppo_rnn", "replay",
           "running_statistics", "sac", "sac_rnn"]
