"""Export a JAX training checkpoint (orbax) to the numpy file the PyTorch
port loads.

Restores the checkpoint without a template and writes every leaf of the
training state (params, opt_state, normalizer, epochs) under its
'/'-joined tree path — `opt_state/1/0/mu` for the flattened Adam's first
moment — unchanged, plus `params_sha256`, the parameters' checksum
(`pobrax_tpu_torch.interop.params_checksum`). The port reads the file with
`pobrax_tpu_torch.training.checkpoint.load_npz` and
`pobrax_tpu_torch.interop.training_state_from_numpy`; no jax is needed there.

Usage: python tools/export_torch_checkpoint.py [ckpt_dir] [out.npz]
(default: checkpoints/ant_tag_rnn_900M ->
pobrax_tpu_torch/checkpoints/ant_tag_rnn_900M.npz)
"""

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from pobrax_tpu.training import checkpoint as ckpt  # noqa: E402
from pobrax_tpu_torch.interop import params_checksum  # noqa: E402

DEFAULT_CKPT = os.path.join(ROOT, "checkpoints", "ant_tag_rnn_900M")
DEFAULT_OUT = os.path.join(ROOT, "pobrax_tpu_torch", "checkpoints", "ant_tag_rnn_900M.npz")


def leaves(tree, path=()):
    """(path, array) for every leaf of a restored tree; None leaves (optax's
    empty states) are skipped."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves(v, path + (str(i),))
    else:
        yield "/".join(path), np.asarray(tree)


def restore(ckpt_dir: str):
    return ckpt.restore(ckpt.latest_step_dir(ckpt_dir) or ckpt_dir)


def main(ckpt_dir: str = DEFAULT_CKPT, out: str = DEFAULT_OUT) -> None:
    tree = restore(ckpt_dir)
    arrays = dict(leaves(tree))
    arrays["params_sha256"] = np.array(params_checksum(tree["params"]))
    os.makedirs(os.path.dirname(out), exist_ok=True)
    np.savez(out, **arrays)
    print(f"wrote {out}: {len(arrays) - 1} leaves, {os.path.getsize(out)} bytes, "
          f"params sha256 {arrays['params_sha256']}")


if __name__ == "__main__":
    main(*sys.argv[1:3])
