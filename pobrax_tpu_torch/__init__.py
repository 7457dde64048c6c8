"""pobrax_tpu_torch — the PyTorch and CUDA port of `pobrax_tpu`.

A second package beside the JAX one, laid out the same way (`physics/`,
`ops/`, `envs/`) so that each module's counterpart is easy to find. It
imports torch and numpy only: never jax, flax, or any `pobrax_tpu` module
(tests/test_torch_isolation.py enforces this).

Conventions:
  * state is dataclasses of tensors with the batch axis FIRST
    (`QP.pos` is (B, n, 3));
  * every entry point (`System`, `create`, the envs) takes a `device`; it
    defaults to "cuda" and raises where no GPU is present — pass
    `device="cpu"` to run the plain PyTorch path on the CPU;
  * random numbers come from `pobrax_tpu_torch.random`, a threefry2x32 that
    reproduces `jax.random` bit for bit, so seeded resets replay the JAX
    package's fixtures;
  * `System.step` on CUDA tensors runs the hand-written whole-step kernel
    (`physics/whole_step.py`, `csrc/whole_step.cu`); on CPU tensors it runs
    the plain `System.step_generic`.
"""

__version__ = "0.1.0"

from pobrax_tpu_torch import envs, io, models, ops, parallel, physics, training, utils

__all__ = ["envs", "io", "models", "ops", "parallel", "physics", "training",
           "utils", "__version__"]
