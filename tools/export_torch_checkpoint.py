"""Export a JAX training checkpoint (orbax) to the numpy file the PyTorch
port loads.

Restores the checkpoint without a template and writes every leaf of the
training state under its '/'-joined tree path, unchanged, plus
`params_sha256`, the parameters' checksum
(`pobrax_tpu_torch.interop.params_checksum`): for the GRU-PPO checkpoint
params, opt_state (`opt_state/1/0/mu` for the flattened Adam's first
moment), normalizer and epochs; for the GRU-SAC one its `_ckpt_slice`:
params (policy, q, target_q, log_alpha), policy_opt, q_opt, alpha_opt,
normalizer and epochs. The port reads the file with
`pobrax_tpu_torch.training.checkpoint.load_npz` and
`pobrax_tpu_torch.interop.training_state_from_numpy`; no jax is needed there.

Usage: python tools/export_torch_checkpoint.py [ckpt_dir out.npz]
(default: both committed AntTag checkpoints, checkpoints/<name> ->
pobrax_tpu_torch/checkpoints/<name>.npz; the GRU-SAC one compressed)
"""

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from pobrax_tpu.training import checkpoint as ckpt  # noqa: E402
from pobrax_tpu_torch.interop import params_checksum  # noqa: E402

# name -> whether the npz is written compressed
CHECKPOINTS = {"ant_tag_rnn_900M": False, "ant_tag_sac_rnn_phase0_750M": True}


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


def export(ckpt_dir: str, out: str, compressed: bool = False) -> None:
    tree = restore(ckpt_dir)
    arrays = dict(leaves(tree))
    arrays["params_sha256"] = np.array(params_checksum(tree["params"]))
    os.makedirs(os.path.dirname(out), exist_ok=True)
    (np.savez_compressed if compressed else np.savez)(out, **arrays)
    print(f"wrote {out}: {len(arrays) - 1} leaves, {os.path.getsize(out)} bytes, "
          f"params sha256 {arrays['params_sha256']}")


def main(args) -> None:
    if args:
        export(args[0], args[1])
        return
    for name, compressed in CHECKPOINTS.items():
        export(os.path.join(ROOT, "checkpoints", name),
               os.path.join(ROOT, "pobrax_tpu_torch", "checkpoints", f"{name}.npz"), compressed)


if __name__ == "__main__":
    main(sys.argv[1:3])
