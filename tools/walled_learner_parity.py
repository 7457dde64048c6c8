"""Kernel-vs-plain agreement on the learners' System with every ant walled,
and the JAX package's own fused-vs-generic agreement on the same states.

The learners' System is AntTag under ActionRepeat(6): 60 substeps a control
step. From a reset plus 3 plain steps of seeded random actions, every ant is
pushed against the +x arena wall (torso at x = 5.15, the wall's inner face at
5.5; `walled_learner_state` of tests/test_torch_kernel_host.py). One control step of
random actions is then taken four ways on the CPU:
  * the port's kernel code, through its g++ host build
    (`tests/test_torch_kernel_host.py`), and the port's plain step;
  * the JAX package's scalar-unrolled fused step (`fused.make_fused_step`,
    the code the Pallas kernel runs) and its generic step.
For each pair the share of envs within the fused-vs-generic tolerances of
tests/test_fused.py (pos/rot 1e-5, vel/ang 1e-3) is printed, with the
largest errors, and the envs that part in both pairs.

Usage: python tools/walled_learner_parity.py [--batch 256] [--seed 5]
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from pobrax_tpu.envs import create as jax_create  # noqa: E402
from tests.test_torch_kernel_host import (build_host_lib, host_step,  # noqa: E402
                                          walled_learner_state)

ACTION_REPEAT = 6
TOL_POS, TOL_VEL = 1e-5, 1e-3


def agreement(a, b):
    """(per-env agreement mask, largest |err| per field) of two (qp, info)."""
    errs = {f: np.abs(np.asarray(getattr(a[0], f)) - np.asarray(getattr(b[0], f)))
            .reshape(len(np.asarray(a[0].pos)), -1).max(1) for f in ("pos", "rot", "vel", "ang")}
    ok = ((errs["pos"] <= TOL_POS) & (errs["rot"] <= TOL_POS)
          & (errs["vel"] <= TOL_VEL) & (errs["ang"] <= TOL_VEL))
    return ok, {f: float(v.max()) for f, v in errs.items()}


def main(batch: int, seed: int) -> dict:
    torch.set_num_threads(1)
    sys_, qp, act = walled_learner_state(batch, seed)
    walled = int((sys_.contacts._capsule_box(qp)[4] > 0).any(-1).sum())

    lib = build_host_lib()
    if lib is None:
        raise SystemExit("g++ not found: the host build of the kernel needs it")
    kernel = host_step(lib, sys_, qp, act)
    plain = sys_.step_generic(qp, act)

    os.environ["POBRAX_FUSED"] = "1"
    try:
        jenv = jax_create("ant_tag", episode_length=None, action_repeat=ACTION_REPEAT,
                          auto_reset=False)
    finally:
        del os.environ["POBRAX_FUSED"]
    jsys = jenv.sys
    assert jsys._fused_step is not None and jsys.config.substeps == sys_.config.substeps
    jqp = type(jsys.default_qp())(*(x.numpy() for x in (qp.pos, qp.rot, qp.vel, qp.ang)))
    jact = act.numpy()
    fused = jax.device_get(jax.jit(jax.vmap(jsys._fused_step))(jqp, jact))
    generic = jax.device_get(jax.jit(jax.vmap(jsys.step_generic))(jqp, jact))

    pairs = {"port: kernel (host build) vs plain": (kernel, plain),
             "jax: fused vs generic": (fused, generic),
             "kernel vs jax fused": (kernel, fused),
             "plain vs jax generic": (plain, generic)}
    result = {"batch": batch, "seed": seed, "substeps": sys_.config.substeps,
              "walled": walled}
    masks = {}
    for name, (a, b) in pairs.items():
        ok, worst = agreement(a, b)
        masks[name] = ok
        result[name] = {"agree": int(ok.sum()), "share": float(ok.mean()), "max_err": worst}
        print(f"{name}: {int(ok.sum())}/{batch} envs within pos/rot {TOL_POS:g}, vel/ang "
              f"{TOL_VEL:g} ({ok.mean() * 100:.3f}%); max |err| "
              + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()), flush=True)
    both = ~masks["port: kernel (host build) vs plain"] & ~masks["jax: fused vs generic"]
    result["part_in_both"] = int(both.sum())
    print(f"{walled} of {batch} envs against the wall; envs parting in both pairs: "
          f"{int(both.sum())}", flush=True)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=256)
    parser.add_argument("--seed", type=int, default=5)
    args = parser.parse_args()
    main(args.batch, args.seed)
