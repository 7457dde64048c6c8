#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU: `python3 chip_smoke.py`.

Drives `pobrax_tpu_torch`'s main path — AntTag at 4096 batched envs with the
cached on-device randomised autoreset, every control step one launch of the
hand-written whole-step CUDA kernel — and checks it. Imports no jax and
nothing of `pobrax_tpu`; the fixture is read with numpy. Phases:
  1. card: name and power limit (nvidia-smi) and torch's device name;
  2. build: compile csrc/whole_step.cu with nvcc, print seconds and ptxas
     registers / spills;
  3. kernel against plain at 4096 envs, from an AntTag reset plus 50 plain
     steps (ground contacts active) with 256 of the ants pushed against an
     arena wall (capsule-box contacts active): one control step each way;
  4. fixture replay through the kernel: tests/fixtures/ref_ant_tag_s7.npz at
     batch 1, its 100 recorded actions;
  5. main path: `create("ant_tag", batch_size=4096, episode_length=1000,
     randomized_autoreset=True, autoreset_mode=...)` for "cached" and
     "naive", 10 warm-up steps then 400 timed steps of on-device random
     actions, with the kernel's launch counter set to 0 just before the 400
     and read just after;
  6. times: the kernel's and the plain version's time per control step at
     4096 envs, and the bound.
Then one JSON line for the kernel, the card's name and power limit, and the
last line `{"ok": true, "device": {...}}`. Any failed phase exits non-zero
before that line is printed. Without a CUDA device it exits 1 at once.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from pobrax_tpu_torch import random as jr
from pobrax_tpu_torch.envs import create
from pobrax_tpu_torch.physics import whole_step

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "ref_ant_tag_s7.npz")
B = 4096
MAIN_STEPS = 400
WARMUP_STEPS = 10  # first calls (allocator, table upload) before the timed window
WARM_PLAIN_STEPS = 50
WALL_ENVS, WALL_TORSO_X = 256, 5.15  # the +x arena wall's inner face is at x = 5.5
# kernel vs plain: the kernel sums contact impulses in fused.py's order and
# contracts multiply-adds; both round differently from the plain path, which
# is round-off everywhere except at a contact's onset or release, where the
# `pen > 0` / `imp > 0` switches can flip and one env's velocities jump. So at
# least 99.5% of envs must agree to the fused-vs-generic tolerances of
# tests/test_fused.py (pos/rot 1e-5, vel/ang 1e-3); the rest are such onsets.
TOL_POS, TOL_VEL, MIN_AGREE = 1e-5, 1e-3, 0.995
STEPS_GATED = 20  # fixture obs gated at 1e-3 over the first 20 steps


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of fn() in ms over `reps` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_build() -> None:
    t0 = time.perf_counter()
    path, log = whole_step.build()
    whole_step.load_library()
    print(f"[build] {path.name} ready in {time.perf_counter() - t0:.2f} s", flush=True)
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "stack frame" in line:
            print(f"[build] ptxas: {line.strip()}", flush=True)


def phase_kernel_vs_plain(dev):
    env = create("ant_tag", episode_length=None, auto_reset=False, batch_size=B, device=dev)
    sys_ = env.sys
    qp = env.reset(jr.PRNGKey(0, dev)).qp
    g = torch.Generator(device=dev).manual_seed(1)
    for _ in range(WARM_PLAIN_STEPS):
        act = torch.rand(B, sys_.action_size, generator=g, device=dev) * 2 - 1
        qp, _ = sys_.step_generic(qp, act)
    # random ants rarely reach the arena wall: push the first WALL_ENVS
    # against the +x wall so the capsule-box rows are exercised too
    core = env.unwrapped
    pos = qp.pos.clone()
    torso_x = pos[:WALL_ENVS, core.torso_idx:core.torso_idx + 1, 0]
    pos[:WALL_ENVS, core.ant_slice, 0] += WALL_TORSO_X - torso_x
    qp = qp.replace(pos=pos)
    walled = int((sys_.contacts._capsule_box(qp)[4] > 0).any(-1).sum())
    act = torch.rand(B, sys_.action_size, generator=g, device=dev) * 2 - 1
    qk, ik = whole_step.launch(sys_, qp, act)
    qg, ig = sys_.step_generic(qp, act)
    torch.cuda.synchronize()
    pairs = {"pos": (qk.pos, qg.pos), "rot": (qk.rot, qg.rot), "vel": (qk.vel, qg.vel),
             "ang": (qk.ang, qg.ang), "contact.vel": (ik.contact.vel, ig.contact.vel)}
    errs = {k: (a - b).abs().flatten(1).max(1).values for k, (a, b) in pairs.items()}
    finite = all(bool(torch.isfinite(a).all()) for a, _ in pairs.values())
    agree = ((errs["pos"] <= TOL_POS) & (errs["rot"] <= TOL_POS)
             & (errs["vel"] <= TOL_VEL) & (errs["ang"] <= TOL_VEL))
    frac = float(agree.float().mean())
    contacts = int((ig.contact.vel.abs().flatten(1).max(1).values > 0).sum())
    print("[kernel-vs-plain] B=%d, %d envs in contact, %d against a wall; max |err| %s" % (
        B, contacts, walled, ", ".join(f"{k} {float(v.max()):.3e}" for k, v in errs.items())), flush=True)
    print(f"[kernel-vs-plain] envs within pos/rot {TOL_POS:g} and vel/ang {TOL_VEL:g}: "
          f"{frac * 100:.3f}% (need >= {MIN_AGREE * 100:.1f}%); all finite: {finite}", flush=True)
    if not finite or frac < MIN_AGREE:
        fail("kernel disagrees with the plain step")
    if walled == 0:
        fail("no env touched a wall: the capsule-box rows went unchecked")
    max_err = max(float(errs[k].max()) for k in ("pos", "rot", "vel", "ang"))
    return sys_, qp, act, max_err


def phase_fixture(dev) -> None:
    fx = np.load(FIXTURE)
    meta = json.loads(str(fx["meta"]))
    steps, seed = int(meta["steps"]), int(meta["seed"])
    env = create("ant_tag", episode_length=steps + 1, auto_reset=False, batch_size=1, device=dev)
    s = env.reset(jr.PRNGKey(seed, dev)[None])
    err0 = float(np.abs(s.obs[0].cpu().numpy() - fx["reset_obs"]).max())
    launched = whole_step.launches
    obs, done = [], []
    for t in range(steps):
        s = env.step(s, torch.as_tensor(fx["actions"][t], device=dev)[None])
        obs.append(s.obs[0])
        done.append(s.done[0])
    obs = torch.stack(obs).cpu().numpy()
    done = torch.stack(done).cpu().numpy()
    err = np.abs(obs - fx["obs"]).max(axis=1)
    same_done = bool((done == fx["done"]).all())
    print(f"[fixture] {os.path.basename(FIXTURE)} seed {seed}: reset obs max |err| {err0:.3e}; "
          f"obs max |err| steps 1-{STEPS_GATED} {err[:STEPS_GATED].max():.3e}, "
          f"all {steps} {err.max():.3e}; done equal: {same_done}; kernel launches "
          f"{whole_step.launches - launched}", flush=True)
    if err0 > 1e-5 or not same_done or err[:STEPS_GATED].max() > 1e-3:
        fail("fixture replay through the kernel diverged")
    if whole_step.launches - launched != steps:
        fail("fixture replay did not step through the kernel")


def phase_main(dev, mode: str, card: str) -> int:
    env = create("ant_tag", batch_size=B, episode_length=1000, randomized_autoreset=True,
                 autoreset_mode=mode, device=dev)
    s = env.reset(jr.PRNGKey(0, dev))
    g = torch.Generator(device=dev).manual_seed(0)
    finite = torch.ones((), dtype=torch.bool, device=dev)
    dones = torch.zeros((), device=dev)

    def run(steps):
        nonlocal s, finite, dones
        for _ in range(steps):
            action = torch.rand(B, env.action_size, generator=g, device=dev) * 2 - 1
            s = env.step(s, action)
            finite &= torch.isfinite(s.obs).all() & torch.isfinite(s.reward).all()
            dones += s.done.sum()

    run(WARMUP_STEPS)
    torch.cuda.synchronize()
    whole_step.launches = 0
    t0 = time.perf_counter()
    run(MAIN_STEPS)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = whole_step.launches
    rate = B * MAIN_STEPS / elapsed
    print(f"[main:{mode}] {MAIN_STEPS} steps x {B} envs in {elapsed:.3f} s = {rate:.1f} "
          f"env-steps/s on {card}; kernel launches {launches}; episodes ended "
          f"{int(dones)}; obs/reward finite: {bool(finite)}", flush=True)
    if launches != MAIN_STEPS:
        fail(f"main path ({mode}) launched the kernel {launches} times for {MAIN_STEPS} steps")
    if not bool(finite):
        fail(f"main path ({mode}) produced non-finite obs or rewards")
    return launches


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        sys.exit(1)
    dev = torch.device("cuda")
    card = card_line()
    print(f"[card] {card}; torch device: {torch.cuda.get_device_name(0)}; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    phase_build()
    sys_, qp, act, max_err = phase_kernel_vs_plain(dev)
    phase_fixture(dev)
    launches = phase_main(dev, "cached", card)
    phase_main(dev, "naive", card)

    kernel_ms = cuda_ms(lambda: whole_step.launch(sys_, qp, act), reps=50)
    plain_ms = cuda_ms(lambda: sys_.step_generic(qp, act), reps=5, warmup=1)
    bound, bound_by = whole_step.bound_ms(sys_, B)
    print(f"[times] one control step at B={B}: kernel {kernel_ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {bound:.4f} ms ({bound_by}); {card}", flush=True)

    print(json.dumps({"kernels": [{
        "name": "whole_step", "route": "cuda",
        "source": "pobrax_tpu_torch/csrc/whole_step.cu",
        "replaces": "pobrax_tpu/physics/pallas_step.py:119",
        "launches": launches, "max_abs_err": max_err,
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
        "library_ms": None}]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
