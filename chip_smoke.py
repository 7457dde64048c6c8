#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU: `python3 chip_smoke.py`.

Drives `pobrax_tpu_torch`'s main paths — the PO ant tasks AntTag,
AntHeavenHell, AntGather and AntMaze, the masked stock envs Humanoid and
Grasp, and the planar envs and acrobot, each at 4096 batched envs with the
cached on-device randomised autoreset, every control step one launch of the
hand-written whole-step CUDA kernel (a half-warp per env); the four learners;
PPO on halfcheetah at examples/train_ppo.py's recipe with its HTML
evaluation page — and checks them. Imports no jax and nothing of
`pobrax_tpu`; the fixtures are read with numpy. Phases:
  1. card: name and power limit (nvidia-smi) and torch's device name;
  2. build: compile csrc/whole_step.cu with nvcc, print seconds and ptxas
     registers, stack frame and spills, and per System the kernel's resident
     warps per SM (CUDA's occupancy calculator, with the System's shared
     memory);
  3. kernel against plain at 4096 envs, from an AntTag reset plus 50 plain
     steps (ground contacts active) with 256 of the ants pushed against an
     arena wall (capsule-box contacts active): one control step each way;
     then the same for each stock System (humanoid, grasp, fetch, ur5e,
     reacherangle, inverted_double_pendulum) after a few plain steps from
     reset, with grasp's Object placed against a finger in 256 envs
     (two-body capsule-capsule rows live), the stock `ant` (SAC's env), the
     planar halfcheetah (16 substeps), hopper and walker2d (ground rows on
     bodies with frozen y translation and x/z rotation; each must have live
     ground rows) and acrobot (no contact row at all, zero limit strength);
     prints how many envs have a live row of each kind. Then the PO ant
     Systems: HeavenHell and the maze after
     20 plain steps, with 256 ants pushed against a T-maze or maze wall (the
     capsule-box rows must be live); AntGather after 50 plain steps, whose 16
     pass-through apples and bombs must come out bit-equal to their input
     with zero Info; and AntTag with `info="contact"`, whose joint and
     actuator Info must be exactly 0 and whose state and contact Info must be
     bit-equal to the "full" launch's; last, ragged batches of 4095 envs (the
     last block one env short) cut from the walled AntTag and maze batches
     and from the `ant` and halfcheetah batches, `ant` at SAC's 128 envs,
     and halfcheetah at PPO's 1024 envs and at one env, the batches of
     phases 13 and 14;
  4. fixture replay through the kernel at batch 1, the recorded actions of
     po-brax's tests/fixtures/ref_ant_tag_s7.npz, ref_ant_heavenhell_s7.npz
     and ref_ant_gather_s7.npz, and of the JAX package's
     halfcheetah_s7_ours.npz;
  5. main paths: `create("ant_tag", batch_size=4096, episode_length=1000,
     randomized_autoreset=True, autoreset_mode=...)` for "cached" and
     "naive"; then `MaskedObservationWrapper(create(name, ..., "cached"),
     env_name=name, hidden=("VELOCITY",))` (`bench.py`'s masked_<name>) for
     humanoid and grasp, 400 steps each, and for fetch, ur5e, reacherangle
     and inverted_double_pendulum, 100 steps each; `ant_heavenhell`,
     `ant_gather` and `ant_maze` "cached", 400 steps each, `ant_gather`
     "naive", 100 steps (a batched permutation reset every step),
     `ant_tag` "cached" with `info="contact"`, 100 steps, halfcheetah,
     hopper and walker2d "cached", 400 steps each (hopper and walker2d must
     end episodes), and acrobot "cached", 100 steps. Each runs 10
     warm-up steps then the timed steps of on-device random actions, with the
     kernel's launch counter set to 0 just before the timed steps and read
     just after; AntGather prints the apples and bombs caught;
  6. times: per System (and AntTag's contact-only variant), the kernel's and
     the plain version's time per control step at 4096 envs (`ant` at SAC's
     128, then 4096; the learners' System at GRU-PPO's 2048; halfcheetah
     at 4096, 1024 and 1, an entry each) (CUDA events over
     back-to-back launches, after 0.2 s of warm-up), the kernel's device time
     (launches queued behind a sleep kernel, so they run back to back: the
     two differ where the wrapper's host work per launch outlasts the
     kernel, on the small Systems), and the bound; the timing helpers are
     time_kernel.py's.
  7. GRU-PPO trains AntTag at full width: `ppo_rnn.train` on
     `AntTagEnv` with examples/train_ant_tag_rnn.py's recipe
     (`ppo_rnn.ANT_TAG`: 2048 envs, episode 1000, action_repeat 6, unroll
     32, 8 minibatches, 4 update epochs, lr 3e-4, entropy 3e-3, discount
     0.97, encoder (256,), hidden 128), `autoreset_mode="cached"`, 3
     epochs; per epoch the wall ms, the
     rollout / update split, the whole-step launches (one per control step:
     32, action_repeat folds into the kernel's 60 substeps), env-steps/s
     and the losses; fails on a non-finite loss, unchanged parameters or
     another launch count. Before it the kernel is held against the plain
     step on the action_repeat=6 System at the learners' batches (2048,
     4096, 256, 512 with 1/16 of the ants on a wall, and 256 with every ant
     on a wall, held to the share the JAX package's own fused-vs-generic pair
     reaches there, ALL_WALLED_MIN_AGREE);
  8. feed-forward PPO trains AntTag at full width: `ppo.train` with
     examples/train_ant_tag.py's recipe (`ppo.ANT_TAG`: 4096 envs,
     action_repeat 6, unroll 16, 32 minibatches, 4 update epochs, policy
     32x4, value 256x5), cached, 2 epochs; the same prints and checks (16
     launches an epoch);
  9. the committed checkpoint on the card: pobrax_tpu_torch/checkpoints/
     ant_tag_rnn_900M.npz loaded through `interop` (its parameters' checksum
     must equal the stored one), then the deterministic tag rate on 256
     episodes of the true AntTag (`eval_tag_checkpoint.tag_rate_rnn`), which
     must reach 0.95 (the JAX replay reads 0.9922), and the stochastic one;
 10. SAC trains the stock `ant` at examples/train_sac.py's recipe
     (`sac.ANT`: 128 envs, capacity 4096, batch 64, 32 steps an epoch,
     min_replay 64, hidden (256, 256)), naive autoreset, 4 epochs (epochs
     3-4 take gradient steps); per epoch the wall, the collect / update
     split (CUDA events), ms per grad step, the whole-step launches (32),
     env-steps/s and q_loss, actor_loss, alpha; fails on a non-finite loss,
     unchanged parameters, another launch count or no gradient steps;
 11. GRU-SAC trains the unshaped AntTag at visible radius 20 at
     examples/train_ant_tag_sac_rnn.py's recipe (`sac_rnn.ANT_TAG`: 512
     envs, action_repeat 6, seq 32, burn-in 8, capacity 192, batch 128, 4
     sequences an epoch, 2 grad steps a sequence, min_replay 24, discount
     0.97, reward scale 10, nstep 5, encoder / head 256, GRU 128), cached
     autoreset, 8 epochs (the last two whole epochs take gradient steps;
     128 launches each), the same prints and checks; then 2 epochs with
     prioritized replay (per_alpha 0.6, min_replay 4) through
     `RSACLearner.epoch`, whose priority table must move off its insert
     value and stay finite;
 12. the committed GRU-SAC checkpoint (pobrax_tpu_torch/checkpoints/
     ant_tag_sac_rnn_phase0_750M.npz): the checksum, then the tag rates
     deterministic and stochastic at radius 20 and 4, the stochastic one at
     radius 20 gated at MIN_SAC_TAG_RATE (JAX recorded 0.8125,
     docs/learning_ant_tag_sac_rnn_phase0.json);
 13. PPO trains halfcheetah at examples/train_ppo.py's recipe
     (`ppo.HALFCHEETAH`: 1024 envs, episode 1000, unroll 20, 16 minibatches,
     4 update epochs, PPOConfig's other defaults) with `ppo.train`'s
     default autoreset, naive, and its watchdog at the default deadline, 2
     epochs; phase 8's prints and checks (20 launches an epoch);
 14. the example's evaluation page: HTML_FRAMES deterministic steps of the
     trained policy on one halfcheetah, `html.save`d to a temporary file,
     which must be well-formed with a finite pose of every body in every
     frame (one launch a step). The gym path of examples/rollout_demo.py
     is left out: gymnasium is not installed on the card's machine, so the
     adapters are held by the CPU tests (tests/test_torch_gym_adapter.py).
A `[clock]` line after each phase gives its seconds and the seconds since
the start. Then one JSON line with an entry per System (halfcheetah one per
batch; each with its resident warps per SM), the card's name and power
limit, and the last line
`{"ok": true, "device": {...}}`. Any failed phase exits non-zero before that
line is printed. Without a CUDA device it exits 1
at once.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import sys
import tempfile
import time

import numpy as np
import torch

from pobrax_tpu_torch import eval_tag_checkpoint
from pobrax_tpu_torch import random as jr
from pobrax_tpu_torch.envs import MaskedObservationWrapper, create
from pobrax_tpu_torch.envs.ant import Ant
from pobrax_tpu_torch.envs.ant_tag import AntTagEnv
from pobrax_tpu_torch.envs.masks import VELOCITY
from pobrax_tpu_torch.envs.planar import Halfcheetah
from pobrax_tpu_torch.io import html
from pobrax_tpu_torch.physics import step_tables, whole_step
from pobrax_tpu_torch.physics.ant import ANT_BODY_NAMES
from pobrax_tpu_torch.training import ppo, ppo_rnn, sac, sac_rnn
from time_kernel import card_line, cuda_ms, device_ms

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURES = [os.path.join(ROOT, "tests", "fixtures", name)
            for name in ("ref_ant_tag_s7.npz", "ref_ant_heavenhell_s7.npz",
                         "ref_ant_gather_s7.npz", "halfcheetah_s7_ours.npz")]
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
# stock Systems: plain steps from reset before the comparison, enough for
# contacts to be live (the humanoid's feet land after ~10 steps; the fetch
# dog spawns with its feet in the ground; the planar bodies, with frozen y
# translation and x/z rotation, touch the ground after 5-10; acrobot has no
# contact row)
STOCK_WARM_STEPS = {"humanoid": 20, "grasp": 12, "fetch": 0, "ur5e": 5, "reacherangle": 5,
                    "inverted_double_pendulum": 5, "ant": 10, "halfcheetah": 5, "hopper": 10,
                    "walker2d": 10, "acrobot": 5}
PLANAR = ("halfcheetah", "hopper", "walker2d")  # cached main paths, MAIN_STEPS each
# halfcheetah's other batches: PPO's rollout (examples/train_ppo.py's 1024
# envs) and the HTML evaluation's one env
HALFCHEETAH_BATCHES = (ppo.HALFCHEETAH.num_envs, 1)
ENDS_EPISODES = ("humanoid", "hopper", "walker2d")  # random actions must end episodes
FINGER_ENVS = 256  # grasp envs whose Object is placed against finger f0
MASKED_MAIN = ("humanoid", "grasp")  # the masked main paths, MAIN_STEPS each
MASKED_OTHER, OTHER_STEPS = ("fetch", "ur5e", "reacherangle", "inverted_double_pendulum"), 100
ROW_KINDS = ("point_plane", "sphere_sphere", "capsule_capsule", "capsule_box")
PO_MAIN = ("ant_heavenhell", "ant_gather", "ant_maze")  # cached, MAIN_STEPS each
# PO Systems against the plain step: plain steps from reset, then the torso
# coordinate (axis, value) of the first WALL_ENVS ants, 0.35 m short of a
# wall's inner face (HeavenHell's T-maze stem wall at x = 2.0, the maze's
# corridor wall at y = 1.75); AntGather's ants are not moved
PO_WARM_STEPS = {"ant_heavenhell": 20, "ant_maze": 20, "ant_gather": 50}
PO_WALLS = {"ant_heavenhell": (0, 1.65), "ant_maze": (1, 1.4)}
CONTACT = "ant_tag,info=contact"  # AntTag's System with contact Info only
RAGGED = 4095  # a batch that leaves the last block one env short
# the learners' System: AntTag under ActionRepeat(6), 60 substeps a launch
LEARNER = "ant_tag,action_repeat=6"
ACTION_REPEAT = 6
# GRU-PPO, PPO, the checkpoint evaluations, GRU-SAC
LEARNER_BATCHES = (2048, 4096, 256, 512)
# With every ant of the learners' System on a wall, contact onsets within the
# 60 substeps come 6x as often as at 10, and an onset that the two summation
# orders round to opposite sides parts one env's velocities. The JAX
# package's own pair, fused.make_fused_step against the generic step, parts
# in 250-255 of 256 envs over seeds 5-8 on the CPU (the port's host-built
# kernel against its plain step: 252-254; tools/walled_learner_parity.py).
# So that case alone, here and in tests/test_torch_kernel_host.py, is held
# to 97.5%, just under the reference's lowest share, 97.66%.
ALL_WALLED_MIN_AGREE = 0.975
GRU_EPOCHS, PPO_EPOCHS = 3, 2  # at ppo_rnn.ANT_TAG's and ppo.ANT_TAG's recipes
HTML_FRAMES = 300  # examples/train_ppo.py's evaluation rollout
MIN_TAG_RATE = 0.95  # the JAX replay of the checkpoint reads 0.9922
SAC_EPOCHS, GRU_SAC_EPOCHS, PER_EPOCHS = 4, 8, 2
SAC_RADIUS = 20.0  # GRU-SAC's phase 0 visible radius
# the GRU-SAC checkpoint's stochastic tag rate at radius 20, 256 episodes: JAX
# recorded 0.8125; the binomial spread at 256 episodes is ~0.025
MIN_SAC_TAG_RATE = 0.70


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def phase_build(dev) -> dict:
    """Builds the kernel; returns the resident warps per SM of each System."""
    t0 = time.perf_counter()
    path, log = whole_step.build()
    whole_step.load_library()
    print(f"[build] {path.name} ready in {time.perf_counter() - t0:.2f} s", flush=True)
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "stack frame" in line:
            print(f"[build] ptxas: {line.strip()}", flush=True)
    warps = {}
    for name in ("ant_tag", *STOCK_WARM_STEPS, *PO_MAIN):
        sys_ = create(name, device=dev).sys
        warps[name] = whole_step.resident_warps(sys_)
        print(f"[build] {name}: {whole_step.shared_bytes(sys_)} bytes of shared memory a block "
              f"({step_tables.ENVS_PER_BLOCK} envs), {warps[name]} resident warps per SM",
              flush=True)
    warps[CONTACT] = warps["ant_tag"]
    warps[LEARNER] = whole_step.resident_warps(
        create("ant_tag", action_repeat=ACTION_REPEAT, device=dev).sys)
    if min(warps.values()) < 16:
        fail("fewer than 16 resident warps per SM")
    return warps


def plain_steps(sys_, qp, steps: int, g):
    """`steps` plain steps of random actions drawn from generator `g`."""
    for _ in range(steps):
        qp, _ = sys_.step_generic(qp, torch.rand(qp.pos.shape[0], sys_.action_size, generator=g,
                                                 device=qp.pos.device) * 2 - 1)
    return qp


def compare(tag: str, sys_, qp, act, note: str, min_agree: float = MIN_AGREE):
    """One control step through the kernel and through the plain step from
    `qp`; fails unless `min_agree` of the envs agree and all is finite.
    Returns the largest |err| over pos/rot/vel/ang."""
    batch = qp.pos.shape[0]
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
    worst = ", ".join(f"{k} {float(v.max()):.3e}" for k, v in errs.items())
    print(f"[kernel-vs-plain:{tag}] B={batch}, {contacts} envs in contact{note}; max |err| "
          f"{worst}", flush=True)
    print(f"[kernel-vs-plain:{tag}] envs within pos/rot {TOL_POS:g} and vel/ang {TOL_VEL:g}: "
          f"{frac * 100:.3f}% (need >= {min_agree * 100:.1f}%); all finite: {finite}", flush=True)
    if not finite or frac < min_agree:
        fail(f"kernel disagrees with the plain step on {tag}")
    return max(float(errs[k].max()) for k in ("pos", "rot", "vel", "ang"))


def phase_kernel_vs_plain(dev):
    env = create("ant_tag", episode_length=None, auto_reset=False, batch_size=B, device=dev)
    sys_ = env.sys
    qp = env.reset(jr.PRNGKey(0, dev)).qp
    g = torch.Generator(device=dev).manual_seed(1)
    qp = plain_steps(sys_, qp, WARM_PLAIN_STEPS, g)
    # random ants rarely reach the arena wall: push the first WALL_ENVS
    # against the +x wall so the capsule-box rows are exercised too
    qp = push_ants(env.unwrapped, qp, 0, WALL_TORSO_X)
    walled = int((sys_.contacts._capsule_box(qp)[4] > 0).any(-1).sum())
    act = torch.rand(B, sys_.action_size, generator=g, device=dev) * 2 - 1
    max_err = compare("ant_tag", sys_, qp, act, f", {walled} against a wall")
    if walled == 0:
        fail("no env touched a wall: the capsule-box rows went unchecked")
    return sys_, qp, act, max_err


def push_ants(core, qp, axis: int, value: float, count: int = WALL_ENVS):
    """`qp` with the ant's 9 bodies in the first `count` envs shifted along
    `axis` so that the torso's coordinate is `value`."""
    ant = [core.sys.body.index[n] for n in ANT_BODY_NAMES]
    pos = qp.pos.clone()
    shift = value - pos[:count, core.torso_idx, axis]
    pos[:count, ant[0]:ant[-1] + 1, axis] += shift[:, None]
    return qp.replace(pos=pos)


def phase_po_kernel_vs_plain(dev, name: str):
    """Kernel against plain on a PO ant System after PO_WARM_STEPS plain steps
    from a reset; ants pushed against a wall (PO_WALLS), or, for AntGather, its
    pass-through bodies checked bit-equal with zero Info."""
    env = create(name, episode_length=None, auto_reset=False, batch_size=B, device=dev)
    sys_ = env.sys
    qp = env.reset(jr.PRNGKey(4, dev)).qp
    g = torch.Generator(device=dev).manual_seed(2)
    qp = plain_steps(sys_, qp, PO_WARM_STEPS[name], g)
    if name in PO_WALLS:
        qp = push_ants(env.unwrapped, qp, *PO_WALLS[name])
    live = live_rows(sys_, qp)
    act = torch.rand(B, sys_.action_size, generator=g, device=dev) * 2 - 1
    passes = step_tables.build(sys_)["pass_through"]
    note = (f"; {len(passes)} pass-through bodies; envs with a live row: "
            + ", ".join(f"{k} {v}" for k, v in live.items()))
    max_err = compare(name, sys_, qp, act, note)
    if name in PO_WALLS and live.get("capsule_box", 0) == 0:
        fail(f"{name}: no env touched a wall: the capsule-box rows went unchecked")
    if name == "ant_gather":
        q, i = whole_step.launch(sys_, qp, act)
        same = all(torch.equal(getattr(q, f)[:, passes], getattr(qp, f)[:, passes])
                   for f in ("pos", "rot", "vel", "ang"))
        zero = not any(bool(t[:, passes].any()) for part in (i.contact, i.joint, i.actuator)
                       for t in (part.vel, part.ang))
        print(f"[kernel-vs-plain:{name}] {len(passes)} pass-through bodies bit-equal to their "
              f"input: {same}; their Info all zero: {zero}", flush=True)
        if len(passes) != 16 or not same or not zero:
            fail("ant_gather's pass-through bodies were not passed through")
    return sys_, qp, act, max_err


def phase_contact_info(dev, qp, act):
    """AntTag's System with contact Info only, against the plain step and,
    bit for bit, against the "full" System's launch on the same inputs."""
    full = AntTagEnv(device=dev).sys
    sys_ = AntTagEnv(device=dev, info="contact").sys
    max_err = compare(CONTACT, sys_, qp, act, "")
    (qf, i_f), (qc, ic) = whole_step.launch(full, qp, act), whole_step.launch(sys_, qp, act)
    torch.cuda.synchronize()
    same = (all(torch.equal(getattr(qf, f), getattr(qc, f)) for f in ("pos", "rot", "vel", "ang"))
            and torch.equal(i_f.contact.vel, ic.contact.vel)
            and torch.equal(i_f.contact.ang, ic.contact.ang))
    zero = not any(bool(t.any()) for t in (ic.joint.vel, ic.joint.ang, ic.actuator.vel,
                                            ic.actuator.ang))
    print(f"[kernel-vs-plain:{CONTACT}] state and contact Info bit-equal to the full launch: "
          f"{same}; joint and actuator Info exactly 0: {zero} (full launch's joint Info "
          f"nonzero: {bool(i_f.joint.vel.any())})", flush=True)
    if not same or not zero:
        fail("the contact-only Info variant changed the state or kept joint / actuator Info")
    return sys_, qp, act, max_err


def phase_ragged(tag: str, sys_, qp, act, live_kind: str = "capsule_box") -> None:
    """The first RAGGED envs of a batch, against the plain step; rows of
    `live_kind` (the walls, or the ground) must be live."""
    cut = qp.replace(**{f: getattr(qp, f)[:RAGGED].contiguous()
                        for f in ("pos", "rot", "vel", "ang")})
    live = live_rows(sys_, cut)
    compare(f"{tag},B={RAGGED}", sys_, cut, act[:RAGGED].contiguous(),
            f"; {RAGGED % step_tables.ENVS_PER_BLOCK} envs in the last block; envs with a live "
            "row: " + ", ".join(f"{k} {v}" for k, v in live.items()))
    if live.get(live_kind, 0) == 0:
        fail(f"{tag}: the ragged batch had no live {live_kind} row")


def live_rows(sys_, qp) -> dict:
    """Per contact row kind the System has: envs with a row in penetration."""
    out = {}
    for kind in ROW_KINDS:
        rows = getattr(sys_.contacts, f"_{kind}")(qp)
        if rows is not None:
            out[kind] = int((rows[4] > 0).any(-1).sum())
    return out


def phase_stock_kernel_vs_plain(dev, name: str, batch: int = B):
    """Kernel against plain on one stock System at `batch` envs, after
    STOCK_WARM_STEPS plain steps from a reset; grasp's Object is placed
    against finger f0's distal capsule (1.5 cm into it) in FINGER_ENVS envs."""
    env = create(name, episode_length=None, auto_reset=False, batch_size=batch, device=dev)
    sys_ = env.sys
    qp = env.reset(jr.PRNGKey(3, dev)).qp
    g = torch.Generator(device=dev).manual_seed(0)
    qp = plain_steps(sys_, qp, STOCK_WARM_STEPS[name], g)
    if name == "grasp":
        dist, obj = sys_.body.index["f0_dist"], sys_.body.index["Object"]
        pos = qp.pos.clone()
        pos[:FINGER_ENVS, obj] = pos[:FINGER_ENVS, dist] + torch.tensor([-0.125, 0.0, 0.0],
                                                                         device=dev)
        qp = qp.replace(pos=pos)
    live = live_rows(sys_, qp)
    act = torch.rand(batch, sys_.action_size, generator=g, device=dev) * 2 - 1
    note = "; envs with a live row: " + (", ".join(f"{k} {v}" for k, v in live.items())
                                         or "no contact rows")
    max_err = compare(name if batch == B else f"{name},B={batch}", sys_, qp, act, note)
    if name == "grasp" and live.get("capsule_capsule", 0) == 0:
        fail("grasp had no live capsule-capsule row: the two-body rows went unchecked")
    if name in ("ant", *PLANAR) and live.get("point_plane", 0) == 0:
        fail(f"{name} had no live ground row")
    return sys_, qp, act, max_err


def phase_fixture(dev, path: str) -> None:
    fx = np.load(path)
    meta = json.loads(str(fx["meta"]))
    steps, seed = int(meta["steps"]), int(meta["seed"])
    env = create(meta["env"], episode_length=steps + 1, auto_reset=False, batch_size=1,
                 device=dev)
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
    print(f"[fixture] {os.path.basename(path)} seed {seed}: reset obs max |err| {err0:.3e}; "
          f"obs max |err| steps 1-{STEPS_GATED} {err[:STEPS_GATED].max():.3e}, "
          f"all {steps} {err.max():.3e}; done equal: {same_done}; kernel launches "
          f"{whole_step.launches - launched}", flush=True)
    if err0 > 1e-5 or not same_done or err[:STEPS_GATED].max() > 1e-3:
        fail("fixture replay through the kernel diverged")
    if whole_step.launches - launched != steps:
        fail("fixture replay did not step through the kernel")


def phase_main(dev, name: str, mode: str, card: str, steps: int = MAIN_STEPS,
               masked: bool = False, info: str = "full") -> int:
    env = create(name, batch_size=B, episode_length=1000, randomized_autoreset=True,
                 autoreset_mode=mode, device=dev, info=info)
    if masked:
        env = MaskedObservationWrapper(env, env_name=name, hidden=("VELOCITY",))
    tag = f"{'masked_' if masked else ''}{name}:{mode}{'' if info == 'full' else ',info=' + info}"
    s = env.reset(jr.PRNGKey(0, dev))
    g = torch.Generator(device=dev).manual_seed(0)
    finite = torch.ones((), dtype=torch.bool, device=dev)
    dones = torch.zeros((), device=dev)
    caught = {k: torch.zeros((), device=dev) for k in ("apples", "bombs") if k in s.metrics}

    def run(n):
        nonlocal s, finite, dones
        for _ in range(n):
            action = torch.rand(B, env.action_size, generator=g, device=dev) * 2 - 1
            s = env.step(s, action)
            finite &= torch.isfinite(s.obs).all() & torch.isfinite(s.reward).all()
            dones += s.done.sum()
            for k, v in caught.items():
                v += s.metrics[k].sum()

    run(WARMUP_STEPS)
    torch.cuda.synchronize()
    whole_step.launches = 0
    dones.zero_()
    for v in caught.values():
        v.zero_()
    t0 = time.perf_counter()
    run(steps)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = whole_step.launches
    rate = B * steps / elapsed
    print(f"[main:{tag}] {steps} steps x {B} envs in {elapsed:.3f} s = {rate:.1f} "
          f"env-steps/s on {card}; kernel launches {launches}; episodes ended "
          f"{int(dones)}; obs/reward finite: {bool(finite)}"
          + "".join(f"; {k} caught {int(v)}" for k, v in caught.items()), flush=True)
    if launches != steps:
        fail(f"main path ({tag}) launched the kernel {launches} times for {steps} steps")
    if not bool(finite):
        fail(f"main path ({tag}) produced non-finite obs or rewards")
    if masked and float(s.obs[:, VELOCITY[name]].abs().max()) != 0.0:
        fail(f"main path ({tag}) leaked a hidden VELOCITY entry")
    if name in ENDS_EPISODES and int(dones) == 0:
        fail(f"main path ({tag}) ended no episode: the autoreset select went unexercised")
    return launches


def phase_learner_kernel_vs_plain(dev):
    """Kernel against plain on the learners' System (AntTag, ActionRepeat(6))
    at each batch the learner paths give it, from a reset plus 3 plain steps
    with a sixteenth of the ants against the +x wall (phase 3's share, 256
    of 4096), then at B=256 with every ant against it (held to
    ALL_WALLED_MIN_AGREE). Returns the B=2048 inputs."""
    out = None
    cases = [(b, b * WALL_ENVS // B, MIN_AGREE) for b in LEARNER_BATCHES]
    for batch, walls, min_agree in cases + [(256, 256, ALL_WALLED_MIN_AGREE)]:
        env = create("ant_tag", episode_length=None, action_repeat=ACTION_REPEAT,
                     auto_reset=False, batch_size=batch, device=dev)
        sys_ = env.sys
        qp = env.reset(jr.PRNGKey(5, dev)).qp
        g = torch.Generator(device=dev).manual_seed(5)
        qp = push_ants(env.unwrapped, plain_steps(sys_, qp, 3, g), 0, WALL_TORSO_X, walls)
        act = torch.rand(batch, sys_.action_size, generator=g, device=dev) * 2 - 1
        walled = int((sys_.contacts._capsule_box(qp)[4] > 0).any(-1).sum())
        max_err = compare(f"{LEARNER},B={batch}{',all walled' if walls == batch else ''}", sys_,
                          qp, act, f", {walled} against a wall, {sys_.config.substeps} substeps",
                          min_agree)
        if walled == 0:
            fail(f"{LEARNER},B={batch}: no env touched a wall")
        if out is None:
            out = (sys_, qp, act, max_err)
    return out


def params_vector(module) -> torch.Tensor:
    return torch.cat([p.detach().reshape(-1) for p in module.parameters()])


def _train_case(kind: str, dev):
    """(learner module, config, core-env factory, autoreset mode, epochs):
    "gru" and "ppo" train AntTag at the examples' recipes, cached;
    "ppo_halfcheetah" trains halfcheetah at examples/train_ppo.py's, naive."""
    if kind == "gru":
        return ppo_rnn, ppo_rnn.ANT_TAG, lambda: AntTagEnv(device=dev), "cached", GRU_EPOCHS
    if kind == "ppo":
        return ppo, ppo.ANT_TAG, lambda: AntTagEnv(device=dev), "cached", PPO_EPOCHS
    return ppo, ppo.HALFCHEETAH, lambda: Halfcheetah(device=dev), "naive", PPO_EPOCHS


def phase_train(dev, card: str, kind: str):
    """Trains with `ppo_rnn.train` ("gru") or `ppo.train` ("ppo",
    "ppo_halfcheetah") as `_train_case` says, the watchdog at its default;
    prints and checks each epoch. Returns (whole-step launches of the run,
    inference_fn, params)."""
    rnn = kind == "gru"
    module, cfg, make_env, mode, epochs = _train_case(kind, dev)
    steps_per_epoch = cfg.unroll_length * cfg.num_envs * cfg.action_repeat
    # the initial parameters, as train() makes them from the seed
    probe = (ppo_rnn.RNNPPOLearner if rnn else ppo.PPOLearner)(
        ppo.wrap_for_training(make_env(), cfg, mode), cfg)
    k_init = jr.split(jr.PRNGKey(0, dev), 3)[1]
    initial = probe.make_params(k_init)
    initial = params_vector(initial if rnn else initial.policy)
    rows = []
    last = [time.perf_counter(), 0]

    def progress(steps, m):
        now = time.perf_counter()
        launched = whole_step.launches - last[1]
        rows.append({"wall_ms": (now - last[0]) * 1e3, "launches": launched, **m})
        last[:] = [now, whole_step.launches]
        r = rows[-1]
        print(f"[train:{kind}] epoch {len(rows)}: wall {r['wall_ms']:.1f} ms (rollout "
              f"{m['rollout_ms']:.1f} ms, update {m['update_ms']:.1f} ms), whole-step launches "
              f"{launched}, {steps_per_epoch / (r['wall_ms'] / 1e3):.1f} env-steps/s; "
              f"total_loss {m['total_loss']:.6f}, policy_loss {m['policy_loss']:.6f}, "
              f"value_loss {m['value_loss']:.6f}, entropy {m['entropy']:.6f}, mean_reward "
              f"{m['mean_reward']:.6f}; {card}", flush=True)

    torch.cuda.synchronize()
    whole_step.launches = 0
    last[:] = [time.perf_counter(), 0]
    inference_fn, params, _ = module.train(make_env(), cfg, seed=0, progress_fn=progress,
                                           autoreset_mode=mode,
                                           num_timesteps=epochs * steps_per_epoch)
    torch.cuda.synchronize()
    launches = whole_step.launches
    final = params_vector(params[1])
    changed = float((final - initial).abs().max())
    warm = rows[1:] or rows  # the first epoch also builds and warms up
    print(f"[train:{kind}] {len(rows)} epochs of {cfg.num_envs} envs, {mode} autoreset; "
          f"whole-step launches {launches}; largest parameter change {changed:.6e}; "
          f"env-steps/s after the first epoch "
          f"{steps_per_epoch * len(warm) / sum(r['wall_ms'] / 1e3 for r in warm):.1f}",
          flush=True)
    if len(rows) != epochs:
        fail(f"{kind}: {len(rows)} epochs ran, not {epochs}")
    for r in rows:
        if r["launches"] != cfg.unroll_length:
            fail(f"{kind}: an epoch launched the kernel {r['launches']} times, not "
                 f"{cfg.unroll_length} (one per control step)")
        if not all(np.isfinite(r[k]) for k in ("total_loss", "policy_loss", "value_loss",
                                                "entropy")):
            fail(f"{kind}: a non-finite loss")
    if not np.isfinite(changed) or changed == 0.0:
        fail(f"{kind}: the parameters did not change")
    return launches, inference_fn, params


def phase_html(dev, card: str, inference_fn, params) -> int:
    """examples/train_ppo.py's evaluation: HTML_FRAMES deterministic steps of
    the trained policy on one halfcheetah, saved by `html.save` to a
    temporary file; the page must be well-formed, with a finite pose of
    every body in every frame. Returns the rollout's whole-step launches."""
    env = Halfcheetah(device=dev)
    key = jr.PRNGKey(1, dev)
    state = env.reset(key[None])
    qps = [state.qp]
    torch.cuda.synchronize()
    whole_step.launches = 0
    t0 = time.perf_counter()
    for _ in range(HTML_FRAMES):
        state = env.step(state, inference_fn(params, state.obs, key, deterministic=True))
        qps.append(state.qp)
    launches = whole_step.launches
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "halfcheetah_eval.html")
        html.save(path, env.sys, qps)
        with open(path) as f:
            page = f.read()
    scene = json.loads(re.search(r"const SCENE\s*=\s*(.*?);\n", page, re.DOTALL).group(1))
    frames = json.loads(re.search(r"const FRAMES\s*=\s*(.*?);\n", page, re.DOTALL).group(1))
    n = env.sys.num_bodies
    well_formed = (page.lstrip().lower().startswith("<!doctype html")
                   and page.rstrip().endswith("</html>") and len(scene["bodies"]) == n
                   and len(frames) == HTML_FRAMES + 1
                   and all(len(fr["pos"]) == len(fr["rot"]) == n for fr in frames)
                   and bool(np.isfinite([fr["pos"] for fr in frames]).all()))
    print(f"[html] {HTML_FRAMES} deterministic steps of the trained halfcheetah policy in "
          f"{time.perf_counter() - t0:.3f} s, whole-step launches {launches}; html.save page "
          f"{len(page)} bytes, {len(frames)} frames of {n} bodies, torso x "
          f"{qps[0].pos[0, 0, 0]:.3f} -> {qps[-1].pos[0, 0, 0]:.3f}; well formed: {well_formed}; "
          f"{card}", flush=True)
    if not well_formed or launches != HTML_FRAMES:
        fail("the halfcheetah evaluation page is malformed, or its rollout missed the kernel")
    return launches


def phase_checkpoint(dev, card: str) -> int:
    """The committed AntTag checkpoint through `interop` on the card: the
    checksum, then the deterministic (gated) and stochastic tag rates.
    Returns the deterministic replay's whole-step launches."""
    learner, ts, same = eval_tag_checkpoint.load(device=dev)
    print(f"[checkpoint] {os.path.relpath(eval_tag_checkpoint.DEFAULT_NPZ, ROOT)}: epochs "
          f"{ts.epochs}, Adam count {ts.opt_state.count}, parameters' checksum equal to the "
          f"stored one: {same}", flush=True)
    if not same:
        fail("the loaded checkpoint's parameters do not match their checksum")
    inference_fn, params = learner.make_inference_fn(), learner.inference_params(ts)
    rates = {}
    for name, seed, det in (("det", 0, True), ("stoch", 1, False)):
        torch.cuda.synchronize()
        whole_step.launches = 0
        t0 = time.perf_counter()
        rates[name] = eval_tag_checkpoint.tag_rate_rnn(
            AntTagEnv(device=dev), inference_fn, params, eval_tag_checkpoint.HIDDEN,
            seed=seed, action_repeat=ACTION_REPEAT, deterministic=det)
        launches = whole_step.launches
        if name == "det":
            det_launches = launches
        print(f"[checkpoint] true tag rate {name} {rates[name]:.4f} on 256 episodes in "
              f"{time.perf_counter() - t0:.3f} s, whole-step launches {launches}; {card}",
              flush=True)
    if not rates["det"] >= MIN_TAG_RATE:
        fail(f"the checkpoint's deterministic tag rate {rates['det']} is below {MIN_TAG_RATE}")
    return det_launches


def phase_off_policy(dev, card: str, kind: str, epochs: int, **overrides) -> int:
    """Trains with `sac.train` on `ant` ("sac", naive autoreset) or
    `sac_rnn.train` on AntTag at radius 20 ("gru_sac", cached) at the
    examples' recipes (with `overrides`); prints and checks each epoch.
    Returns the whole-step launches of the run."""
    if kind == "sac":
        module, cfg, mode = sac, dataclasses.replace(sac.ANT, **overrides), "naive"
        make_env = lambda: Ant(device=dev)  # noqa: E731
        per_epoch = cfg.steps_per_epoch * cfg.num_envs
        launches_per_epoch = cfg.steps_per_epoch
        grads_per_epoch = cfg.steps_per_epoch * cfg.grad_steps_per_env_step
        learner = sac.SACLearner(sac.wrap_for_training(make_env(), cfg, mode), cfg)
    else:
        module, cfg, mode = sac_rnn, dataclasses.replace(sac_rnn.ANT_TAG, **overrides), "cached"
        make_env = lambda: AntTagEnv(device=dev, visible_radius=SAC_RADIUS)  # noqa: E731
        per_epoch = cfg.seqs_per_epoch * cfg.seq_len * cfg.num_envs * cfg.action_repeat
        launches_per_epoch = cfg.seqs_per_epoch * cfg.seq_len
        grads_per_epoch = cfg.seqs_per_epoch * cfg.grad_steps_per_seq
        learner = sac_rnn.RSACLearner(sac_rnn.wrap_for_training(make_env(), cfg, mode), cfg)
    tag = kind + ("" if not overrides else ","
                  + ",".join(f"{k}={v}" for k, v in sorted(overrides.items())))
    # the initial state, as train() makes it from the seed: its policy, and
    # the replay buffer's device bytes
    probe = learner.init(jr.split(jr.PRNGKey(0, dev), 3)[1])
    initial = params_vector(probe.params.policy)
    nbytes = sum(t.numel() * t.element_size() for t in probe.buffer.data.values())
    del probe, learner
    rows = []
    last = [time.perf_counter(), 0]

    def progress(steps, m):
        now = time.perf_counter()
        launched = whole_step.launches - last[1]
        rows.append({"wall_ms": (now - last[0]) * 1e3, "launches": launched, **m})
        last[:] = [now, whole_step.launches]
        r = rows[-1]
        print(f"[train:{tag}] epoch {len(rows)}: wall {r['wall_ms']:.1f} ms (collect "
              f"{m['rollout_ms']:.1f} ms, update {m['update_ms']:.1f} ms, "
              f"{m['update_ms'] / grads_per_epoch:.3f} ms per grad step if all "
              f"{grads_per_epoch} ran), whole-step launches {launched}, "
              f"{per_epoch / (r['wall_ms'] / 1e3):.1f} env-steps/s; q_loss {m['q_loss']:.6f}, "
              f"actor_loss {m['actor_loss']:.6f}, alpha {m['alpha']:.6f}, mean_reward "
              f"{m['mean_reward']:.6f}; {card}", flush=True)

    torch.cuda.synchronize()
    whole_step.launches = 0
    last[:] = [time.perf_counter(), 0]
    _, params, _ = module.train(make_env(), cfg, seed=0, progress_fn=progress,
                                autoreset_mode=mode, num_timesteps=epochs * per_epoch)
    torch.cuda.synchronize()
    launches = whole_step.launches
    changed = float((params_vector(params[1]) - initial).abs().max())
    warm = rows[1:] or rows
    print(f"[train:{tag}] {len(rows)} epochs of {cfg.num_envs} envs; replay buffer "
          f"{nbytes} bytes on the card; whole-step launches {launches}; largest policy "
          f"parameter change {changed:.6e}; env-steps/s after the first epoch "
          f"{per_epoch * len(warm) / sum(r['wall_ms'] / 1e3 for r in warm):.1f}", flush=True)
    if len(rows) != epochs:
        fail(f"{tag}: {len(rows)} epochs ran, not {epochs}")
    for r in rows:
        if r["launches"] != launches_per_epoch:
            fail(f"{tag}: an epoch launched the kernel {r['launches']} times, not "
                 f"{launches_per_epoch} (one per control step)")
        if not all(np.isfinite(r[k]) for k in ("q_loss", "actor_loss", "alpha")):
            fail(f"{tag}: a non-finite loss")
    if not all(r["q_loss"] > 0 for r in rows[-2:]):
        fail(f"{tag}: the last two epochs took no gradient step")
    if not np.isfinite(changed) or changed == 0.0:
        fail(f"{tag}: the parameters did not change")
    return launches


def phase_per(dev, card: str, epochs: int) -> int:
    """GRU-SAC at phase 11's recipe with prioritized replay (per_alpha 0.6,
    min_replay 4): `epochs` epochs through `RSACLearner.epoch`, keyed and set
    up as `sac_rnn.train` does it; each must launch the kernel once a control
    step and give finite losses, and the priority table must then hold
    entries moved off their insert value, all finite. Returns the launches."""
    cfg = dataclasses.replace(sac_rnn.ANT_TAG, per_alpha=0.6, min_replay=4)
    env = sac_rnn.wrap_for_training(AntTagEnv(device=dev, visible_radius=SAC_RADIUS), cfg,
                                    "cached")
    learner = sac_rnn.RSACLearner(env, cfg)
    key, k_init, k_reset = jr.split(jr.PRNGKey(0, dev), 3).unbind(-2)
    ts = learner.init(k_init)
    env_state = env.reset(jr.split(k_reset, cfg.num_envs))
    h = learner.h0(cfg.num_envs)
    launches = 0
    for epoch in range(1, epochs + 1):
        key, k_epoch = jr.split(key, 2).unbind(-2)
        torch.cuda.synchronize()
        whole_step.launches = 0
        t0 = time.perf_counter()
        ts, env_state, h, m = learner.epoch(ts, env_state, h, k_epoch)
        torch.cuda.synchronize()
        launched = whole_step.launches
        launches += launched
        pri = ts.priorities[ts.priorities > 0]
        print(f"[train:gru_sac,per_alpha=0.6] epoch {epoch}: wall "
              f"{(time.perf_counter() - t0) * 1e3:.1f} ms, whole-step launches {launched}; "
              f"q_loss {float(m['q_loss']):.6f}, actor_loss {float(m['actor_loss']):.6f}; "
              f"priorities written {pri.numel()}, off 1.0 {int((pri != 1.0).sum())}, mean "
              f"{float(pri.mean()):.6f}, max {float(pri.max()):.6f}; {card}", flush=True)
        if launched != cfg.seqs_per_epoch * cfg.seq_len:
            fail(f"PER: an epoch launched the kernel {launched} times, not "
                 f"{cfg.seqs_per_epoch * cfg.seq_len}")
        if not all(np.isfinite(float(m[k])) for k in ("q_loss", "actor_loss", "alpha")):
            fail("PER: a non-finite loss")
    if not bool(torch.isfinite(ts.priorities).all()) or not bool((pri != 1.0).any()):
        fail("PER: the priorities did not move off their insert value, or are not finite")
    return launches


def phase_sac_checkpoint(dev, card: str) -> int:
    """The committed GRU-SAC checkpoint through `interop` on the card: the
    checksum, then the tag rates at radius 20 and 4, the stochastic one at
    radius 20 gated. Returns the replays' whole-step launches."""
    learner, ts, same = eval_tag_checkpoint.load(eval_tag_checkpoint.SAC_NPZ, device=dev,
                                                 sac=True)
    print(f"[checkpoint:gru_sac] {os.path.relpath(eval_tag_checkpoint.SAC_NPZ, ROOT)}: epochs "
          f"{ts.epochs}, Adam count {ts.q_opt.count}, parameters' checksum equal to the stored "
          f"one: {same}", flush=True)
    if not same:
        fail("the loaded GRU-SAC checkpoint's parameters do not match their checksum")
    inference_fn, params = learner.make_inference_fn(), learner.inference_params(ts)
    rates, launches = {}, 0
    for name, radius, seed, det in eval_tag_checkpoint.measurements(sac=True):
        torch.cuda.synchronize()
        whole_step.launches = 0
        t0 = time.perf_counter()
        rates[name] = eval_tag_checkpoint.tag_rate_rnn(
            AntTagEnv(device=dev, visible_radius=radius), inference_fn, params,
            eval_tag_checkpoint.HIDDEN, seed=seed, action_repeat=ACTION_REPEAT,
            deterministic=det)
        launched = whole_step.launches
        launches += launched
        print(f"[checkpoint:gru_sac] tag rate {name} (radius {radius:g}, seed {seed}) "
              f"{rates[name]:.4f} on 256 episodes in {time.perf_counter() - t0:.3f} s, "
              f"whole-step launches {launched}; {card}", flush=True)
    if not rates["r20_stoch"] >= MIN_SAC_TAG_RATE:
        fail(f"the GRU-SAC checkpoint's stochastic tag rate at radius 20, {rates['r20_stoch']}, "
             f"is below {MIN_SAC_TAG_RATE}")
    return launches


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        sys.exit(1)
    dev = torch.device("cuda")
    card = card_line()
    print(f"[card] {card}; torch device: {torch.cuda.get_device_name(0)}; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    t0 = last = time.perf_counter()

    def lap(label: str) -> None:
        """Prints the seconds `label` took and the seconds since the start."""
        nonlocal last
        now = time.perf_counter()
        print(f"[clock] {label}: {now - last:.1f} s; {now - t0:.1f} s since the start",
              flush=True)
        last = now

    warps = phase_build(dev)
    for batch in HALFCHEETAH_BATCHES:
        warps[f"halfcheetah,B={batch}"] = warps["halfcheetah"]
    lap("build")
    compared = {"ant_tag": phase_kernel_vs_plain(dev)}
    lap("kernel-vs-plain:ant_tag")
    for name in STOCK_WARM_STEPS:
        compared[name] = phase_stock_kernel_vs_plain(dev, name)
        lap(f"kernel-vs-plain:{name}")
    for name in PO_MAIN:
        compared[name] = phase_po_kernel_vs_plain(dev, name)
        lap(f"kernel-vs-plain:{name}")
    compared[CONTACT] = phase_contact_info(dev, *compared["ant_tag"][1:3])
    for name in ("ant_tag", "ant_maze"):
        phase_ragged(name, *compared[name][:3])
    phase_ragged("ant", *compared["ant"][:3], live_kind="point_plane")
    lap("kernel-vs-plain:contact info, ragged ant_tag, ant_maze, ant")
    phase_ragged("halfcheetah", *compared["halfcheetah"][:3], live_kind="point_plane")
    # PPO steps halfcheetah at its 1024 envs and the HTML evaluation at one:
    # each batch is compared, timed and counted as an entry of its own
    for batch in HALFCHEETAH_BATCHES:
        compared[f"halfcheetah,B={batch}"] = phase_stock_kernel_vs_plain(dev, "halfcheetah",
                                                                         batch)
    lap(f"kernel-vs-plain:halfcheetah at B={RAGGED} and {HALFCHEETAH_BATCHES}")
    # SAC steps `ant` at its own batch: the kernels line times `ant` there,
    # and its 4096-env case is timed beside it
    timed_only = {"ant": compared["ant"]}
    compared["ant"] = phase_stock_kernel_vs_plain(dev, "ant", sac.ANT.num_envs)
    compared[LEARNER] = phase_learner_kernel_vs_plain(dev)
    lap("kernel-vs-plain:ant at SAC's batch, the learners' System")
    for path in FIXTURES:
        phase_fixture(dev, path)
        lap(f"fixture:{os.path.basename(path)}")
    launches = {"ant_tag": phase_main(dev, "ant_tag", "cached", card)}
    phase_main(dev, "ant_tag", "naive", card)
    for name in MASKED_MAIN:
        launches[name] = phase_main(dev, name, "cached", card, masked=True)
    for name in MASKED_OTHER:
        launches[name] = phase_main(dev, name, "cached", card, steps=OTHER_STEPS, masked=True)
    for name in PO_MAIN:
        launches[name] = phase_main(dev, name, "cached", card)
    launches["ant_gather"] += phase_main(dev, "ant_gather", "naive", card, steps=OTHER_STEPS)
    launches[CONTACT] = phase_main(dev, "ant_tag", "cached", card, steps=OTHER_STEPS,
                                   info="contact")
    lap("main paths of the ant, masked and PO envs")
    for name in PLANAR:
        launches[name] = phase_main(dev, name, "cached", card)
        lap(f"main:{name}")
    launches["acrobot"] = phase_main(dev, "acrobot", "cached", card, steps=OTHER_STEPS)
    lap("main:acrobot")
    launches[LEARNER] = (phase_train(dev, card, "gru")[0] + phase_train(dev, card, "ppo")[0]
                         + phase_checkpoint(dev, card))
    lap("train:gru, train:ppo, checkpoint")
    trained, inference_fn, params = phase_train(dev, card, "ppo_halfcheetah")
    launches[f"halfcheetah,B={ppo.HALFCHEETAH.num_envs}"] = trained
    lap("train:ppo_halfcheetah")
    launches["halfcheetah,B=1"] = phase_html(dev, card, inference_fn, params)
    lap("html")
    print("[gym] left out: gymnasium is not installed on the card's machine, so the gym "
          "adapters (create_gym_env) are held by the CPU tests, tests/test_torch_gym_adapter.py",
          flush=True)
    launches["ant"] = phase_off_policy(dev, card, "sac", SAC_EPOCHS)
    launches[LEARNER] += (phase_off_policy(dev, card, "gru_sac", GRU_SAC_EPOCHS)
                          + phase_per(dev, card, PER_EPOCHS)
                          + phase_sac_checkpoint(dev, card))
    lap("sac, gru_sac, per, sac checkpoint")

    entries = []
    cases = [(name, case, True) for name, case in compared.items()]
    for name, (sys_, qp, act, max_err), listed in cases + [(n, c, False)
                                                           for n, c in timed_only.items()]:
        kernel_ms = cuda_ms(lambda: whole_step.launch(sys_, qp, act), reps=50)
        kernel_dev_ms = device_ms(lambda: whole_step.launch(sys_, qp, act))
        plain_ms = cuda_ms(lambda: sys_.step_generic(qp, act), reps=5)
        batch = qp.pos.shape[0]
        bound, bound_by = whole_step.bound_ms(sys_, batch)
        print(f"[times:{name}] one control step at B={batch}: kernel {kernel_ms:.4f} ms per launch "
              f"(device {kernel_dev_ms:.4f} ms), plain {plain_ms:.4f} ms, bound {bound:.4f} ms "
              f"({bound_by}), {bound / kernel_dev_ms:.4f} of the bound; {warps[name]} warps per "
              f"SM; {card}", flush=True)
        if not listed:
            continue
        entries.append({
            "name": f"whole_step[{name}]", "route": "cuda",
            "source": "pobrax_tpu_torch/csrc/whole_step.cu",
            "replaces": "pobrax_tpu/physics/pallas_step.py:119",
            "launches": launches[name], "max_abs_err": max_err,
            "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
            "library_ms": None, "warps_per_sm": warps[name], "device_ms": kernel_dev_ms})
    lap("times")
    print(json.dumps({"kernels": entries}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
