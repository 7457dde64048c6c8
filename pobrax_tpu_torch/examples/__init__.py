"""The port's counterparts of the JAX package's `examples/*.py`: one module
under the same name for each (but `multihost_train.py`, which is
`pobrax_tpu_torch.multihost_train`), with the examples' shaped training
wrappers, their evaluators on the true envs, and their main functions at the
examples' recipes. Run one as `python -m pobrax_tpu_torch.examples.<name>
[arguments as the JAX example's] [--device cpu] [--out PATH]`; a run's record
goes under `runs/` (never `docs/`, which holds the JAX package's records).
Importing a module runs nothing.
"""
