#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU: `python3 chip_smoke.py`.

Drives `pobrax_tpu_torch`'s main paths — the PO ant tasks AntTag,
AntHeavenHell, AntGather and AntMaze, the masked stock envs Humanoid and
Grasp, and the planar envs and acrobot, each at 4096 batched envs with the
cached on-device randomised autoreset, every control step one launch of the
hand-written whole-step CUDA kernel (a half-warp per env); the four learners;
PPO on halfcheetah at examples/train_ppo.py's recipe with its HTML
evaluation page; the multi-process half, two ranks of a 'data' mesh
sharing the card over gloo training AntTag with PPO and GRU-SAC; the
examples at their recipes' widths, the AntTag solve's curriculum first; and
the benches and measuring tools through their entry points — and checks
them. Imports no jax and nothing of
`pobrax_tpu`; the fixtures are read with numpy. Phases:
  1. card: name and power limit (nvidia-smi) and torch's device name;
  2. build: compile csrc/whole_step.cu with nvcc, print seconds and ptxas
     registers, stack frame and spills, and per System the kernel's resident
     warps per SM (CUDA's occupancy calculator, with the System's shared
     memory);
  3. kernel against plain at 4096 envs, from an AntTag reset plus 50 plain
     steps (ground contacts active) with 256 of the ants pushed against an
     arena wall (capsule-box contacts active): one control step each way
     (in every comparison the plain steps sum in a fixed order and the
     compared one is run twice and must repeat bit for bit);
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
     randomized_autoreset=True, autoreset_mode=...)` for "cached" (200
     steps) and "naive" (20); then `MaskedObservationWrapper(create(name, ..., "cached"),
     env_name=name, hidden=("VELOCITY",))` (`bench.py`'s masked_<name>) for
     humanoid and grasp, 200 steps each, and for fetch, ur5e, reacherangle
     and inverted_double_pendulum, 100 steps each; `ant_heavenhell`,
     `ant_gather` and `ant_maze` "cached", 200 steps each, `ant_gather`
     "naive", 20 steps (a batched permutation reset every step),
     `ant_tag` "cached" with `info="contact"`, 100 steps, halfcheetah,
     hopper and walker2d "cached", 200 steps each (hopper and walker2d must
     end episodes), and acrobot "cached", 100 steps. Each runs 10
     warm-up steps then the timed steps of on-device random actions, with the
     kernel's launch counter set to 0 just before the timed steps and read
     just after; AntGather prints the apples and bombs caught;
  6. times: per System (and AntTag's contact-only variant), the kernel's and
     the plain version's time per control step at 4096 envs (`ant` at SAC's
     128, then 4096; the learners' System at each batch of LEARNER_BATCHES,
     an entry each; halfcheetah at 4096, 1024 and 1, an entry each; the
     examples' pairs of phase 18) (CUDA events: the kernel over
     back-to-back launches after 0.2 s of warm-up, the plain step over one
     call), the kernel's device time
     (launches queued behind a sleep kernel, so they run back to back: the
     two differ where the wrapper's host work per launch outlasts the
     kernel, on the small Systems), and the bound; the timing helpers are
     `pobrax_tpu_torch.utils.profiling`'s (time_kernel.py's too).
  7. GRU-PPO trains AntTag at full width: `ppo_rnn.train` on
     `AntTagEnv` with examples/train_ant_tag_rnn.py's recipe
     (`ppo_rnn.ANT_TAG`: 2048 envs, episode 1000, action_repeat 6, unroll
     32, 8 minibatches, 4 update epochs, lr 3e-4, entropy 3e-3, discount
     0.97, encoder (256,), hidden 128), `autoreset_mode="cached"`, 2
     epochs; per epoch the wall ms, the
     rollout / update split, the whole-step launches (one per control step:
     32, action_repeat folds into the kernel's 60 substeps), env-steps/s
     and the losses; fails on a non-finite loss, unchanged parameters or
     another launch count. Before it the kernel is held against the plain
     step on the action_repeat=6 System at the learners' batches (2048,
     4096, 256, 512, 128 and 384 with 1/16 of the ants on a wall, and 256
     with every ant on a wall, held to the share the JAX package's own
     fused-vs-generic pair reaches there, ALL_WALLED_MIN_AGREE);
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
     then the same for the AntTag policy the port trained itself
     (`eval_tag_checkpoint.PORT_NPZ`, the curriculum run's final state at
     900M, resumed across calls): the checksum, the det rate gated at its
     record's det rate on the card less PORT_TAG_MARGIN, the stoch rate
     reported, each with its seconds and launches (a solving policy ends
     its episodes early, so the det replay launches fewer than 1,000
     times);
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
     ant_tag_sac_rnn_phase0_750M.npz): the checksum, then the tag rates det
     and stoch at radius 20 and 4, the stochastic one at radius 20 gated at
     MIN_SAC_TAG_RATE (JAX recorded 0.8125,
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
     adapters are held by the CPU tests (tests/test_torch_gym_adapter.py);
 15. the multi-process phase (`phase_mesh`): the parent makes the
     references, then spawns two ranks sharing the card over gloo
     (`parallel.mesh.spawn`; NCCL refuses two ranks on one GPU) that use the
     kernel the parent built: (c) each rank's first control step of its
     2048-env block of the learner's reset, against the single process's
     4096 (obs within 1e-3); (a) `ppo.train(mesh=...)` at ppo.ANT_TAG, 2 x
     2048 envs, cached, 2 epochs with a checkpoint each (rank 0 writes):
     per rank and epoch the wall, rollout / update split and losses,
     parameters bit-equal across the ranks after every epoch, metrics
     equal, 16 launches a rank an epoch, parameters moved; (b) one epoch's
     update on each rank's block of one single-process rollout at 4096 envs,
     against the single process's update with shuffle_blocks=2 (parameters
     within 5e-5, metrics 1e-4); the gloo all-reduce's host ms for PPO's flat
     gradient and GRU-SAC's q / policy / logp; (d) `sac_rnn.train(mesh=...)`
     at sac_rnn.ANT_TAG with PER (per_alpha 0.6, min_replay 4), 2 x 256
     envs, 64 sequences a rank a grad step, 2 epochs: bit-equal parameters,
     rank-local replay (capacity, L, 256, obs) and PER table (capacity,
     256), 128 launches a rank an epoch; then phase 8's PPO once more in the
     parent, beside the ranks' epochs;
 16. `graft_entry.entry()` once and `graft_entry.dryrun_multichip(2)` (its
     five phases, two ranks over gloo on the card);
 17. one PPO epoch at ppo.ANT_TAG through a one-rank NCCL mesh against the
     same epoch with no mesh and shuffle_blocks=1: policy and statistics
     bit-equal (the NCCL code path; two ranks cannot share a card under it).
Each of phases 15-17 prints a `[mesh]` line with its backend and world size.
 18. the examples (`pobrax_tpu_torch/examples/`) at their recipes' widths,
     each through the entry point a user calls: first the kernel against
     the plain step on each (System, batch) they add (with phase 3:
     HeavenHell, Gather, whose 16 pass-through bodies must stay bit-equal,
     and Maze at action_repeat 6 and 2048 envs, HeavenHell at 512 and at 8 x
     6 substeps, `ant` at 2048, the pendulum at 1024 and 64; each of these
     Systems at the evaluators' 256 episodes; AntTag at 1 and 16 envs), then
     what each shaped wrapper adds to a learner's control step (unshaped and
     shaped in turns, device kernels traced), then: (a) the main path,
     `train_ant_tag_rnn.main_curriculum` at 2048 envs with each phase's
     budget cut to one epoch (radius 20 -> 6 -> 4, one checkpoint resumed at
     each boundary, epochs saved 1, 2, 3, 32 launches an epoch, finite
     losses, moved parameters), then its true-env tag rates on 256 episodes,
     det and stoch, reported; (b) `eval_checkpoint.main` of the gather (800M
     and bombmem02 1B) and maze checkpoints and the port-trained HeavenHell,
     maze and gather (800M and bombmem02 1B) ones: checksums, the maze's det
     goal rate gated at 0.95 (the port-trained maze's at its record's less
     PORT_TAG_MARGIN), gather's apples and net (each port-trained gather's at
     its record's less PORT_GATHER_MARGIN) and HeavenHell's completion and
     heaven rates (det seed 0, stoch seed 1) gated at REPLAY_GATES; then
     `eval_checkpoint.main("masked_ant_port")`, the three masked-ant arms the
     port trained: checksums, each det episode reward gated at its record's
     less PORT_MASKED_ANT_MARGIN of it, FF full above both masked arms; (c)
     `train_ant_gather_rnn.main_curriculum` at the bombmem02 recipe (sensor
     14 -> 6 -> 6, novelty 0.25, 0.25, 0, bomb memory 0.2), one call of 8
     epochs a phase, and its gather_eval; (d) `train_ant_maze_rnn.main`: the
     random goal rate, one call of 8 epochs saved under its checkpoint dir,
     the GRU goal rates det and stoch; (e) `train_heavenhell_rnn.main`, an
     epoch at 10 substeps and one under HH_SUBSTEPS=8 (with its transfer
     evaluation on the true 10), and `train_heavenhell_sac_rnn.main` at 512
     envs for HH_SAC_EPOCHS epochs, each with its random and GRU
     `outcome_rates`; (f) `train_ant_tag_sac_rnn.run_phase(0)` past
     min_replay into two epochs of gradient steps, then CARRY_EPOCHS of the
     carry run from the committed phase-0 export at carry_frac 0.25 (its
     replay's [carry | train] columns, the epoch count continuing the
     export's), each with its tag rates det and stoch at two radii; (g) the
     masked ant (three learners, an epoch each, 2048 envs), the masked
     pendulum (1024) and GRU-SAC on it (64), with their evaluators at 256
     episodes; (h) `visualize.main("ant_tag", 300)` and
     `rollout_demo.native_path` (16 envs, NATIVE_DEMO_STEPS steps, twice).
     The steps run in three spawned processes (EXAMPLE_PARTS), each with
     its own counts, started with phase 19's after the build (phase 2) and
     run beside phases 3-4; the parent waits for all four before phase 5. Every train is watched: one launch a control step,
     finite losses, each core env rescaled by ActionRepeat once. Every
     launch is counted under the entry of its (substeps, batch), and a
     launch at a pair that no entry compares fails. Each of (a)-(h) prints
     its wall time, its trained env-steps as JAX counts them and its
     launches, and a `[clock]` line.
 19. the benches and measuring tools (`pobrax_tpu_torch.bench`,
     `bench_scaling` and `tools/`), each through its entry point, in a
     fourth spawned process beside the examples' three: first, in the
     parent's phase 3, the kernel
     against the plain step on each (System, batch) they add (the ablations'
     AntTag without walls, without contacts and at one substep, AntTag at 8
     substeps, the substeps probe's reference and its 8-substep candidate at
     64 envs under ActionRepeat(6) (its candidates at 5 substeps are past the
     integrator's stability edge, where no two float32 steps agree after one
     launch), HeavenHell at 64, AntTag x6 at the speed probe's 8,
     Gather and Maze x6 at the renders' one env, AntTag at 512, 256 and
     2048), then `bench.main` (cached, 200 steps, with BENCH_TRAIN=1; naive,
     10), `tools.bench_train` for PPO, GRU-PPO and GRU-SAC (one call each),
     `bench_scaling` at 1 and 2 ranks (gloo, sharing the card) for `step`
     and `ppo`, `bench_substeps` (10, 8), `ablate_bench`, `roofline`,
     `overlap_study`, `autoreset_study` and `substeps_probe` at 64 envs,
     `ant_speed_probe`, `per_study` at one rung and one seed, and both
     renders; each prints its JSON record (the card's name and power limit
     in it), every rate must be finite, and every launch is counted under
     the entry of its (System, batch): by (substeps, batch), or where two
     Systems share those (the ablations, the probe's candidates) by the
     tool's own count of each.
 20. the port's surface (run after phase 8): (a) `import pobrax_tpu_torch`
     reaches every name its `__all__` and its subpackages' `__all__` export
     (the JAX package's eight subpackages, `training.networks` and the
     learner modules, `ops`' 13 helpers); (b) each `ops` helper, and `norm`
     / `safe_norm` / `normalize` along axis 0 with keepdims, on CUDA tensors
     against the same call on the CPU (rtol 1e-6, atol 1e-6), with the
     identity and |xyz| < 1e-10 quaternions (axis (1, 0, 0)), w < 0 (angles
     in (-pi, pi]) and zero vectors (exactly 0); (c) one PPO epoch at
     `ppo.ANT_TAG` (4096 envs, cached) with `flatten_optimizer=False` (the
     Adam state carried in optax's per-leaf layout) from the same state, env
     reset and key as one with True: every parameter within UPDATE_TOL
     (5e-5), finite losses, moved parameters, 16 launches each; each
     epoch's Adam state through `interop` and back bit for bit, the per-leaf
     moments as trees in the parameters' layout.
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
import hashlib
import json
import multiprocessing
import os
import re
import signal
import sys
import tempfile
import time

import numpy as np
import torch

import pobrax_tpu_torch
from pobrax_tpu_torch import interop, ops
from pobrax_tpu_torch import bench, bench_scaling, eval_checkpoint, eval_tag_checkpoint, graft_entry
from pobrax_tpu_torch import random as jr
from pobrax_tpu_torch.envs import MaskedObservationWrapper, Wrapper, _envs, create, wrappers
from pobrax_tpu_torch.envs.ant import Ant
from pobrax_tpu_torch.envs.ant_tag import AntTagEnv
from pobrax_tpu_torch.envs.masks import VELOCITY
from pobrax_tpu_torch.envs.planar import Halfcheetah
from pobrax_tpu_torch.examples import (rollout_demo, train_ant_gather_rnn, train_ant_maze_rnn,
                                       train_ant_tag, train_ant_tag_rnn, train_ant_tag_sac_rnn,
                                       train_ant_tag_sac_rnn_carry, train_heavenhell_rnn,
                                       train_heavenhell_sac_rnn, train_masked_ant,
                                       train_masked_pendulum, train_sac_rnn_pendulum, visualize)
from pobrax_tpu_torch.io import html
from pobrax_tpu_torch.physics import step_tables, whole_step
from pobrax_tpu_torch.parallel import mesh as pmesh
from pobrax_tpu_torch.physics.ant import ANT_BODY_NAMES
from pobrax_tpu_torch.profile_step import _trace
from pobrax_tpu_torch.tools import (ablate_bench, ant_speed_probe, autoreset_study, bench_substeps,
                                    bench_train, overlap_study, per_study, render_gather_policy,
                                    render_maze_policy, roofline, substeps_probe)
from pobrax_tpu_torch.training import checkpoint as ckpt
from pobrax_tpu_torch.training import ppo, ppo_rnn, sac, sac_rnn
from pobrax_tpu_torch.utils.profiling import card_line, cuda_ms, device_ms

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURES = [os.path.join(ROOT, "tests", "fixtures", name)
            for name in ("ref_ant_tag_s7.npz", "ref_ant_heavenhell_s7.npz",
                         "ref_ant_gather_s7.npz", "halfcheetah_s7_ours.npz")]
B = 4096
MAIN_STEPS = 200  # cut from 400 to fit the examples phase
WARMUP_STEPS = 10  # first calls (allocator, table upload) before the timed window
WARM_PLAIN_STEPS = 50
WALL_ENVS, WALL_TORSO_X = 256, 5.15  # the +x arena wall's inner face is at x = 5.5
# kernel vs plain: the kernel sums contact impulses in fused.py's order and
# contracts multiply-adds; both round differently from the plain path, which
# is round-off everywhere except at a contact's onset or release, where the
# `pen > 0` / `imp > 0` switches can flip and one env's velocities jump. So at
# least 99.5% of envs must agree to the fused-vs-generic tolerances of
# tests/test_fused.py (pos/rot 1e-5, vel/ang 1e-3); the rest are such onsets.
# The plain steps of the comparisons sum in a fixed order (`plain_step`), so
# a batch's share is the same in every run
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
# the naive-autoreset main paths (AntTag, AntGather; a batched reset every
# step, ~0.3 s a step at 4096 envs): cut from 100 steps to fit the examples' phase
NAIVE_STEPS = 10
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
# GRU-PPO, PPO, the evaluations and a GRU-SAC rank, GRU-SAC, and the carry
# run's two stacks (a quarter and three quarters of GRU-SAC's 512 envs); each
# batch is an entry of the kernels line, LEARNER at 2048
LEARNER_BATCHES = (2048, 4096, 256, 512, 128, 384)
# With every ant of the learners' System on a wall, contact onsets within the
# 60 substeps come 6x as often as at 10, and an onset that the two summation
# orders round to opposite sides parts one env's velocities. The JAX
# package's own pair, fused.make_fused_step against the generic step, parts
# in 250-255 of 256 envs over seeds 5-8 on the CPU (the port's host-built
# kernel against its plain step: 252-254; tools/walled_learner_parity.py).
# So that case alone, here and in tests/test_torch_kernel_host.py, is held
# to 97.5%, just under the reference's lowest share, 97.66%.
ALL_WALLED_MIN_AGREE = 0.975
GRU_EPOCHS, PPO_EPOCHS = 2, 2  # at ppo_rnn.ANT_TAG's and ppo.ANT_TAG's recipes
HTML_FRAMES = 300  # examples/train_ppo.py's evaluation rollout
MIN_TAG_RATE = 0.95  # the JAX replay of the checkpoint reads 0.9922
# the port-trained AntTag policy replays the run's own det rate on the card
# (the same 256 episodes): the margin holds a ~0.03 binomial spread, should
# the card's arithmetic part a few episodes
PORT_TAG_MARGIN = 0.05
SAC_EPOCHS, GRU_SAC_EPOCHS, PER_EPOCHS = 4, 8, 2
SAC_RADIUS = 20.0  # GRU-SAC's phase 0 visible radius
# the GRU-SAC checkpoint's stochastic tag rate at radius 20, 256 episodes: JAX
# recorded 0.8125; the binomial spread at 256 episodes is ~0.025
MIN_SAC_TAG_RATE = 0.70
# the multi-process phase: two ranks sharing the card over gloo (NCCL refuses
# two ranks on one GPU); PPO at ppo.ANT_TAG (2 x 2048 envs), GRU-SAC at
# sac_rnn.ANT_TAG (2 x 256 envs, 2 x 64 sequences a grad step) with PER from
# the 4th sequence, as phase_per
MESH_RANKS, MESH_BACKEND = 2, "gloo"
MESH_PPO_EPOCHS, MESH_SAC_EPOCHS = 2, 2  # the first PPO epoch builds and warms up
MESH_SAC = dataclasses.replace(sac_rnn.ANT_TAG, per_alpha=0.6, min_replay=4)
LEARNER_AT = {b: LEARNER if b == 2048 else f"{LEARNER},B={b}" for b in LEARNER_BATCHES}
EVAL_EPISODES = 256  # the batch of every evaluator of the examples
GRU_SAC_RANK = LEARNER_AT[MESH_SAC.num_envs // MESH_RANKS]  # a GRU-SAC rank's batch
UPDATE_TOL = 5e-5  # parameters after an update on the same rollout (the learner tests')
ALLREDUCE_REPS = 50
# the examples phase. The (System, batch) pairs the examples add, held
# against the plain step and timed: the PO ant tasks at the learners'
# action_repeat 6 and GRU-PPO's 2048 envs (HeavenHell also at GRU-SAC's 512
# and retuned to 8 substeps), `ant` masked at 2048, the masked pendulum at
# PPO's 1024 and GRU-SAC's 64; then each of those Systems at the
# evaluators' 256 episodes, and AntTag at visualize's one env and the rollout
# demo's 16
EXAMPLE_PO_SYSTEMS = (("ant_heavenhell,action_repeat=6", "ant_heavenhell", 2048, None),
                      ("ant_gather,action_repeat=6", "ant_gather", 2048, None),
                      ("ant_maze,action_repeat=6", "ant_maze", 2048, None),
                      ("ant_heavenhell,action_repeat=6,B=512", "ant_heavenhell", 512, None),
                      ("ant_heavenhell,substeps=8,action_repeat=6", "ant_heavenhell", 2048, 8),
                      ("ant_heavenhell,action_repeat=6,B=256", "ant_heavenhell", 256, None),
                      ("ant_heavenhell,substeps=8,action_repeat=6,B=256", "ant_heavenhell", 256,
                       8),
                      ("ant_gather,action_repeat=6,B=256", "ant_gather", 256, None),
                      ("ant_maze,action_repeat=6,B=256", "ant_maze", 256, None))
EXAMPLE_STOCK_SYSTEMS = (("ant,B=2048", "ant", 2048),
                         ("inverted_pendulum,B=1024", "inverted_pendulum", 1024),
                         ("inverted_pendulum,B=64", "inverted_pendulum", 64),
                         ("ant,B=256", "ant", 256),
                         ("inverted_pendulum,B=256", "inverted_pendulum", 256),
                         ("ant_tag,B=1", "ant_tag", 1),
                         ("ant_tag,B=16", "ant_tag", 16))
# GRU-SAC epochs: min_replay 24 sequences at 4 an epoch fill in 6, so 7 take
# one epoch of gradient steps and 8 two; the pendulum's min_replay 32 fills in 8
# (the rollout demo's native path: NATIVE_DEMO_STEPS steps of 16 envs, naive,
# twice)
HH_SAC_EPOCHS, SAC_PHASE_EPOCHS, PENDULUM_SAC_EPOCHS = 7, 8, 9
CARRY_EPOCHS = 1  # the carry run: its [carry | train] collection, no gradient step
# the recipes' widths: GRU-PPO's and the masked ant's 2048 envs, GRU-SAC's 512
GRU_ENVS, SAC_ENVS, MASKED_ANT_ENVS = ppo_rnn.ANT_TAG.num_envs, sac_rnn.ANT_TAG.num_envs, 2048
CARRY_FRAC = 0.25
NATIVE_DEMO_STEPS = 20
SHAPING_STEPS = 10  # timed control steps of each side of a shaping pair
# the examples phase's steps, run in three processes (EXAMPLE_PARTS), and the
# benches and tools in a fourth (TOOLS_PART): every step is host-bound, its
# device idle most of the time. On an H100 host where one after another the
# examples took 590 s of a 1051 s script, each of their parts takes ~200 s,
# and the tools ~150 s. So the four start as soon as the kernel is built and
# run beside the parent's comparisons of phases 3 and 4 (~220 s, host-bound
# too, and timing nothing); the parent waits for them before the main paths
# of phase 5, so that phases 5-17 and the times run with the card to
# itself. The rates the parts print are taken beside the other processes
EXAMPLE_STEPS = ("shaping", "a", "b", "c", "d", "e", "f", "g", "h")
EXAMPLE_PARTS = (("shaping", "a", "b", "c"), ("d", "e", "g"), ("f", "h"))
TOOLS_PART = ("tools",)
BACKGROUND_PARTS = (*EXAMPLE_PARTS, TOOLS_PART)
# phase 20: the subpackages `import pobrax_tpu_torch` must reach (the JAX
# package's), the ops inputs' batch, and CUDA against the CPU for the ops
SURFACE_SUBPACKAGES = ("envs", "io", "models", "ops", "parallel", "physics", "training", "utils")
OPS_N = 4096
OPS_RTOL = OPS_ATOL = 1e-6
# the committed checkpoints' replays on 256 episodes. The maze's det goal
# rate: JAX recorded 0.9961 (docs/learning_ant_maze_rnn.json). Gather: each
# gate is the lowest of the JAX package's own values over reset seeds 0-4
# (tools/eval_gather_checkpoint_seeds.py, on the CPU) less 0.5, about three
# standard deviations of that spread, rounded down to 0.1. HeavenHell (the
# policy the port trained): its training run's evaluation read 1.000 for all
# four rates on the H100 (pobrax_tpu_torch/docs/learning_heavenhell_rnn.json,
# det seed 0, stoch seed 1, as the replay runs them); 256 of 256 bounds each
# rate only by the rule of three, p >= 0.988, at which 256 episodes miss 3.1
# +- 1.7; each gate is the maze's 0.95 (12 misses), over 5 such spreads away.
# The maze policy the port trained (seed 0, `export_run_checkpoint --maze`)
# replays the state, episodes and reset seed of its run's own evaluation on
# the card, so its gate is that record's det goal rate less PORT_TAG_MARGIN,
# as the port-trained AntTag policy's is
PORT_MAZE_RECORD = os.path.join(ROOT, "pobrax_tpu_torch", "docs", "learning_ant_maze_rnn.json")
# The gather policy the port trained (the sensor-range curriculum, seed 0,
# `export_run_checkpoint --gather`) replays its run's own evaluation too (the
# same state, 256 episodes and reset seed 0 on the card), so each gate is
# that record's det / stoch apples and net less PORT_GATHER_MARGIN: should
# the card's arithmetic part the episodes, a 256-episode mean moves by about
# an episode's spread over 16 (SD_EPISODE in
# tests/test_torch_gather_checkpoint.py), and the margin is two such moves
PORT_GATHER_RECORD = os.path.join(ROOT, "pobrax_tpu_torch", "docs",
                                  "learning_gather_rnn_curriculum.json")
# the same for the bomb-memory recipe's policy the port trained (seed 0;
# its calls were resumed inside phase 2, which restarted the novelty
# wrapper's bomb-cell grid, so the record is its own and not JAX's recipe's)
PORT_GATHER_BOMBMEM_RECORD = os.path.join(
    ROOT, "pobrax_tpu_torch", "docs", "learning_gather_rnn_bombmem02_cut_in_phase2.json")
PORT_GATHER_MARGIN = 0.3
# The masked-ant arms the port trained (`export_run_checkpoint --masked-ant`)
# replay their run's own evaluations too (each arm's state, 256 episodes of
# up to 1,000 steps, reset seed 0, det, on the card), so each gate is the
# record's episode reward less PORT_MASKED_ANT_MARGIN of it: should the
# card's arithmetic part the episodes, a 256-episode mean moves by about an
# episode's spread over 16; a walking ant's episode rewards spread by up to
# ~25% of their mean (a fall ends an episode early), so a mean by ~1.6%,
# and the margin is two such moves, 3%
PORT_MASKED_ANT_RECORD = os.path.join(ROOT, "pobrax_tpu_torch", "docs",
                                      "learning_masked_ant.json")
PORT_MASKED_ANT_MARGIN = 0.03


def _record_det(path: str) -> float:
    with open(path) as f:
        return json.load(f)["results"]["det"]


def _gather_gates(path: str, margin: float) -> dict:
    """A gather record's det and stoch apples and net, each less `margin`."""
    with open(path) as f:
        results = json.load(f)["results"]
    return {f"{mode}_{k}": v - margin for mode in ("det", "stoch")
            for k, v in (("apples", results[mode]["apples"]),
                         ("net", results[mode]["apples"] - results[mode]["bombs"]))}


REPLAY_GATES = {
    "gather": {"det_apples": 5.3, "det_net": 2.1, "stoch_apples": 5.7, "stoch_net": 2.0},
    "gather_bombmem": {"det_apples": 4.5, "det_net": 1.7, "stoch_apples": 6.0, "stoch_net": 2.2},
    "maze": {"det_goal_rate": 0.95},
    "maze_port": {"det_goal_rate": _record_det(PORT_MAZE_RECORD) - PORT_TAG_MARGIN},
    "gather_port": _gather_gates(PORT_GATHER_RECORD, PORT_GATHER_MARGIN),
    "gather_bombmem_port": _gather_gates(PORT_GATHER_BOMBMEM_RECORD, PORT_GATHER_MARGIN),
    "heavenhell": {"det_completion": 0.95, "det_heaven": 0.95, "stoch_completion": 0.95,
                   "stoch_heaven": 0.95}}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    stop_parts()
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


def plain_step(sys_, qp, act):
    """The plain reference step with its per-body sums (`index_add`) in a
    fixed order: on the card index_add's default kernel adds with atomics in
    no fixed order, so the reference could round differently from run to
    run and move a contact onset past the tolerances."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        return sys_.step_generic(qp, act)
    finally:
        torch.use_deterministic_algorithms(False)


def plain_steps(sys_, qp, steps: int, g):
    """`steps` plain steps of random actions drawn from generator `g`."""
    for _ in range(steps):
        qp, _ = plain_step(sys_, qp, torch.rand(qp.pos.shape[0], sys_.action_size, generator=g,
                                                device=qp.pos.device) * 2 - 1)
    return qp


def compare(tag: str, sys_, qp, act, note: str, min_agree: float = MIN_AGREE):
    """One control step through the kernel and through the plain step from
    `qp`; fails unless a second plain step repeats the first bit for bit,
    `min_agree` of the envs agree and all is finite. Returns the largest
    |err| over pos/rot/vel/ang."""
    batch = qp.pos.shape[0]
    qk, ik = whole_step.launch(sys_, qp, act)
    qg, ig = plain_step(sys_, qp, act)
    again, i_again = plain_step(sys_, qp, act)
    torch.cuda.synchronize()
    fields = ("pos", "rot", "vel", "ang")
    if not (all(torch.equal(getattr(qg, f), getattr(again, f)) for f in fields)
            and torch.equal(ig.contact.vel, i_again.contact.vel)):
        fail(f"{tag}: two plain steps from the same inputs differ: the reference is not "
             "deterministic")
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


def phase_po_kernel_vs_plain(dev, name: str, batch: int = B, action_repeat: int = 1,
                             substeps=None, tag=None):
    """Kernel against plain on a PO ant System (`batch` envs; the integrator
    retuned to `substeps` and scaled by `action_repeat`, the learners'
    Systems) after PO_WARM_STEPS plain steps from a reset (3 at
    action_repeat > 1); a sixteenth of the ants pushed against a wall
    (PO_WALLS), or, for AntGather, its pass-through bodies checked bit-equal
    with zero Info."""
    env = create(name, episode_length=None, action_repeat=action_repeat, auto_reset=False,
                 batch_size=batch, device=dev, substeps=substeps)
    sys_ = env.sys
    tag = tag or name
    qp = env.reset(jr.PRNGKey(4, dev)).qp
    g = torch.Generator(device=dev).manual_seed(2)
    qp = plain_steps(sys_, qp, PO_WARM_STEPS[name] if action_repeat == 1 else 3, g)
    if name in PO_WALLS:
        qp = push_ants(env.unwrapped, qp, *PO_WALLS[name], count=batch * WALL_ENVS // B)
    live = live_rows(sys_, qp)
    act = torch.rand(batch, sys_.action_size, generator=g, device=dev) * 2 - 1
    passes = step_tables.build(sys_)["pass_through"]
    note = (f"; {sys_.config.substeps} substeps; {len(passes)} pass-through bodies; envs with a "
            "live row: " + ", ".join(f"{k} {v}" for k, v in live.items()))
    max_err = compare(tag, sys_, qp, act, note)
    if name in PO_WALLS and live.get("capsule_box", 0) == 0:
        fail(f"{tag}: no env touched a wall: the capsule-box rows went unchecked")
    if name == "ant_gather":
        q, i = whole_step.launch(sys_, qp, act)
        same = all(torch.equal(getattr(q, f)[:, passes], getattr(qp, f)[:, passes])
                   for f in ("pos", "rot", "vel", "ang"))
        zero = not any(bool(t[:, passes].any()) for part in (i.contact, i.joint, i.actuator)
                       for t in (part.vel, part.ang))
        print(f"[kernel-vs-plain:{tag}] {len(passes)} pass-through bodies bit-equal to their "
              f"input: {same}; their Info all zero: {zero}", flush=True)
        if len(passes) != 16 or not same or not zero:
            fail(f"{tag}: the pass-through bodies were not passed through")
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


def phase_stock_kernel_vs_plain(dev, name: str, batch: int = B, tag=None):
    """Kernel against plain on one stock System at `batch` envs, after
    STOCK_WARM_STEPS plain steps from a reset; grasp's Object is placed
    against finger f0's distal capsule (1.5 cm into it) in FINGER_ENVS envs."""
    env = create(name, episode_length=None, auto_reset=False, batch_size=batch, device=dev)
    sys_ = env.sys
    qp = env.reset(jr.PRNGKey(3, dev)).qp
    g = torch.Generator(device=dev).manual_seed(0)
    qp = plain_steps(sys_, qp, STOCK_WARM_STEPS.get(name, 5), g)
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
    max_err = compare(tag or (name if batch == B else f"{name},B={batch}"), sys_, qp, act, note)
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
    ALL_WALLED_MIN_AGREE). Returns each batch's inputs (sys, qp, act, max
    |err|) of its 1/16-walled case."""
    out = {}
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
        out.setdefault(batch, (sys_, qp, act, max_err))
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
    rates, det_launches = _tag_replay(dev, card, "checkpoint", learner, ts)
    if not rates["det"] >= MIN_TAG_RATE:
        fail(f"the checkpoint's deterministic tag rate {rates['det']} is below {MIN_TAG_RATE}")
    return det_launches


def _tag_replay(dev, card: str, tag: str, learner, ts):
    """A GRU-PPO AntTag state's true tag rates on 256 episodes, det at reset
    seed 0 and stoch at seed 1, each line with its seconds and launches ->
    (rates, the det replay's whole-step launches)."""
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
        print(f"[{tag}] true tag rate {name} {rates[name]:.4f} on 256 episodes in "
              f"{time.perf_counter() - t0:.3f} s, whole-step launches {launches}; {card}",
              flush=True)
    return rates, det_launches


def phase_port_checkpoint(dev, card: str) -> int:
    """The AntTag policy the port trained itself (`train_ant_tag_rnn
    --curriculum --checkpoint-dir`, exported by
    `tools/export_run_checkpoint.py --tag`): the checksum, then the det tag
    rate, gated at the run's own det rate on the card (its record) less
    PORT_TAG_MARGIN, and the stoch rate, reported. Returns the det replay's
    whole-step launches."""
    with open(eval_tag_checkpoint.PORT_RECORD) as f:
        record = json.load(f)
    learner, ts, same = eval_tag_checkpoint.load(eval_tag_checkpoint.PORT_NPZ, device=dev)
    print(f"[port checkpoint] {os.path.relpath(eval_tag_checkpoint.PORT_NPZ, ROOT)}: epochs "
          f"{ts.epochs}, parameters' checksum equal to the stored one: {same}; the run's "
          f"record reads det {record['true_tag_rate_det']:.4f} / stoch "
          f"{record['true_tag_rate_stoch']:.4f}", flush=True)
    if not same:
        fail("the port-trained checkpoint's parameters do not match their checksum")
    rates, det_launches = _tag_replay(dev, card, "port checkpoint", learner, ts)
    gate = record["true_tag_rate_det"] - PORT_TAG_MARGIN
    if not rates["det"] >= gate:
        fail(f"the port-trained checkpoint's det tag rate {rates['det']} is below {gate}")
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
    checksum, then the tag rates det and stoch at radius 20 and 4, the
    stochastic one at radius 20 gated. Returns the replays' whole-step
    launches."""
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

# ---- the multi-process phase ------------------------------------------------


def _digest(module) -> str:
    """sha256 of a module's parameters: equal digests are bit-equal parameters."""
    return hashlib.sha256(params_vector(module).cpu().numpy().tobytes()).hexdigest()


class _SaveSpy:
    """Wraps `checkpoint.save_step` (called by every rank after every epoch
    when `checkpoint_every` is one epoch; rank 0 writes) to record each
    save's parameter digest and replay / PER shapes."""

    def __init__(self):
        self.saves = []
        self._save_step = ckpt.save_step

    def __enter__(self):
        def spy(root, step, ts, mesh=None):
            buffer = getattr(ts, "buffer", None)
            pri = getattr(ts, "priorities", None)
            self.saves.append({
                "digest": _digest(ts.params), "epochs": ts.epochs, "step": step, "root": root,
                # per env column, the share of stored steps whose last two
                # observation entries (AntTag's target xy, zero out of
                # sight) are not zero
                "target_seen": None if buffer is None else (
                    buffer.data["obs"][:buffer.size, ..., -2:] != 0).any(-1).float()
                .mean((0, 1)).cpu().tolist(),
                "buffer": None if buffer is None else {k: tuple(v.shape)
                                                       for k, v in buffer.data.items()},
                "priorities": None if pri is None else tuple(pri.shape),
                "priorities_moved": None if pri is None else int((pri[pri > 0] != 1.0).sum())})
            return self._save_step(root, step, ts, mesh)

        ckpt.save_step = spy
        return self

    def __exit__(self, *exc):
        ckpt.save_step = self._save_step


def _digests(rank_result: dict, run: str) -> list:
    """A rank's parameter digests after each epoch of one of its trains."""
    return [save["digest"] for save in rank_result[run][3]]


def _allreduce_ms(numel: int, mesh) -> float:
    """Host ms per `psum` of `numel` float32s on the card over the mesh's
    group (gloo copies through the host): ALLREDUCE_REPS back to back."""
    x = torch.ones(numel, device=mesh.device)
    for _ in range(5):
        pmesh.psum(x, mesh)
    torch.cuda.synchronize()
    pmesh.barrier(mesh)
    t0 = time.perf_counter()
    for _ in range(ALLREDUCE_REPS):
        pmesh.psum(x, mesh)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / ALLREDUCE_REPS


def _timed_train(module, make_env, cfg, mesh, mode, epochs, per_epoch, ckpt_dir):
    """`module.train(...)` on this rank with the launch counter set to 0
    just before and read just after, a checkpoint every epoch (the spy's
    record); -> (launches, per-epoch rows, inference params, saves)."""
    rows, last = [], [0.0]

    def progress(steps, m):
        now = time.perf_counter()
        rows.append({"wall_ms": (now - last[0]) * 1e3, **m})
        last[0] = now

    with _SaveSpy() as spy:
        torch.cuda.synchronize()
        whole_step.launches = 0
        last[0] = time.perf_counter()
        _, params, _ = module.train(make_env(), cfg, seed=0, mesh=mesh, progress_fn=progress,
                                    autoreset_mode=mode, num_timesteps=epochs * per_epoch,
                                    checkpoint_dir=ckpt_dir, checkpoint_every=per_epoch)
        torch.cuda.synchronize()
    return whole_step.launches, rows, [p.detach().cpu() for p in params[1].parameters()], \
        spy.saves


def mesh_rank(mesh, refs_path: str, ckpt_root: str) -> dict:
    """One rank of the multi-process phase (the kernel is already built by
    the parent): (c) its first control step, (a) `ppo.train(mesh=...)` at
    ppo.ANT_TAG, (b) one epoch's update on its block of the parent's
    rollout, the gloo all-reduce times, (d) `sac_rnn.train(mesh=...)` at
    MESH_SAC. Returns what the parent checks."""
    whole_step.load_library()
    dev, cfg = mesh.device, ppo.ANT_TAG
    refs = torch.load(refs_path, weights_only=True)
    out = {"rank": mesh.rank, "world": mesh.data, "backend": mesh.backend,
           "device": str(dev)}
    local = cfg.num_envs // mesh.data
    _, k_init, k_reset = jr.split(jr.PRNGKey(0, dev), 3).unbind(-2)

    # (c) the first control step of this rank's block of the reset
    env = ppo.wrap_for_training(AntTagEnv(device=dev), cfg, "cached", local)
    state = ppo.reset_block(env, k_reset, cfg.num_envs, mesh)
    act = jr.uniform(jr.PRNGKey(9, dev), (local, env.action_size), -1.0, 1.0,
                     block=pmesh.draw_block(mesh))
    out["first_obs"] = env.step(state, act).obs.cpu()

    # (a) PPO on AntTag, the main path
    per_epoch = cfg.unroll_length * cfg.num_envs * cfg.action_repeat
    probe = ppo.PPOLearner(env, cfg, mesh)
    out["ppo_initial"] = params_vector(probe.make_params(k_init).policy).cpu()
    out["ppo"] = _timed_train(ppo, lambda: AntTagEnv(device=dev), cfg, mesh, "cached",
                              MESH_PPO_EPOCHS, per_epoch, os.path.join(ckpt_root, "ppo"))

    # (b) one epoch's update on this rank's block of the parent's rollout
    learner = ppo.PPOLearner(env, cfg, mesh)
    ts = learner.init(k_init)
    blk = mesh.block(cfg.num_envs)
    data = ppo.Transition(**{f: refs["rollout"][f][:, blk].to(dev)
                             for f in ppo.Transition.__dataclass_fields__})
    boot = refs["bootstrap"][blk].to(dev)
    learner._rollout = lambda ts, env_state, key: (env_state, data, boot)
    ts, _, m = learner.epoch(ts, state, refs["k_epoch"].to(dev))
    out["update"] = (params_vector(ts.params).cpu(), {k: float(v) for k, v in m.items()})
    numel = sum(p.numel() for p in ts.params.parameters())
    out["allreduce_ms"] = {"ppo": (numel, _allreduce_ms(numel, mesh))}

    # (d) GRU-SAC on AntTag at radius 20 with PER
    sc = MESH_SAC
    sac_epoch = sc.seqs_per_epoch * sc.seq_len * sc.num_envs * sc.action_repeat
    out["gru_sac"] = _timed_train(sac_rnn, lambda: AntTagEnv(device=dev, visible_radius=SAC_RADIUS),
                                  sc, mesh, "cached", MESH_SAC_EPOCHS, sac_epoch,
                                  os.path.join(ckpt_root, "gru_sac"))
    slearner = sac_rnn.RSACLearner(sac_rnn.wrap_for_training(
        AntTagEnv(device=dev, visible_radius=SAC_RADIUS), sc, "cached", sc.num_envs // mesh.data),
        sc, mesh)
    sts = slearner.init(k_init)
    out["allreduce_ms"]["gru_sac"] = {
        net: (n, _allreduce_ms(n, mesh))
        for net, n in (("q", sum(p.numel() for p in sts.params.q.parameters())),
                       ("policy", sum(p.numel() for p in sts.params.policy.parameters())),
                       ("logp", 1))}
    return out


def nccl_rank(mesh) -> dict:
    """(f) one PPO epoch at ppo.ANT_TAG through a one-rank NCCL mesh and
    without a mesh (shuffle_blocks=1): the policy and statistics must be
    bit-equal."""
    whole_step.load_library()
    dev, cfg = mesh.device, ppo.ANT_TAG
    per_epoch = cfg.unroll_length * cfg.num_envs * cfg.action_repeat
    runs = {}
    for name, m, c in (("plain", None, dataclasses.replace(cfg, shuffle_blocks=1)),
                       ("mesh", mesh, cfg)):
        hist = []
        _, (norm, policy), _ = ppo.train(AntTagEnv(device=dev), c, seed=0, mesh=m,
                                         autoreset_mode="cached", num_timesteps=per_epoch,
                                         progress_fn=lambda s, mm: hist.append(mm))
        runs[name] = (params_vector(policy).cpu(), norm.mean.cpu(), norm.std.cpu(),
                      {k: hist[0][k] for k in ("total_loss", "policy_loss", "value_loss",
                                               "entropy", "mean_reward")})
    return {"backend": mesh.backend, "world": mesh.data, "device": str(dev), **runs}


def phase_mesh(dev, card: str, tmp: str) -> int:
    """The multi-process phase, (a)-(d) in one spawn of MESH_RANKS ranks
    sharing the card over gloo: the parent makes the references (the
    single-process first step at 4096 envs and one single-process epoch's
    rollout and update with shuffle_blocks=2), the ranks run `mesh_rank`,
    and the parent holds their results against the references and each
    other. Returns the whole-step launches of the ranks' PPO trains (B=2048
    each) and GRU-SAC trains (B=256 each)."""
    cfg = ppo.ANT_TAG
    _, k_init, k_reset = jr.split(jr.PRNGKey(0, dev), 3).unbind(-2)
    env = ppo.wrap_for_training(AntTagEnv(device=dev), cfg, "cached")
    state = env.reset(jr.split(k_reset, cfg.num_envs))
    act = jr.uniform(jr.PRNGKey(9, dev), (cfg.num_envs, env.action_size), -1.0, 1.0)
    first_obs = env.step(state, act).obs
    # one single-process epoch with shuffle_blocks=2: its rollout, then its
    # update on that rollout (test_torch_factory's split)
    single = dataclasses.replace(cfg, shuffle_blocks=MESH_RANKS)
    learner = ppo.PPOLearner(env, single)
    ts = learner.init(k_init)
    k_epoch = jr.PRNGKey(11, dev)
    k_roll = jr.split(k_epoch, 3)[1]
    _, data, boot = learner._rollout(ts, state, k_roll)
    learner._rollout = lambda ts, env_state, key: (env_state, data, boot)
    ts, _, want_m = learner.epoch(ts, state, k_epoch)
    want_params = params_vector(ts.params)
    refs_path = os.path.join(tmp, "mesh_refs.pt")
    torch.save({"rollout": {f: getattr(data, f).cpu() for f in ppo.Transition.__dataclass_fields__},
                "bootstrap": boot.cpu(), "k_epoch": k_epoch.cpu()}, refs_path)
    del data, boot, learner, ts, env, state

    t0 = time.perf_counter()
    ranks = pmesh.spawn(mesh_rank, MESH_RANKS, MESH_BACKEND, dev.type, refs_path,
                        os.path.join(tmp, "mesh_ckpt"), timeout=600)
    print(f"[mesh] {MESH_BACKEND}, world {ranks[0]['world']}, ranks on "
          f"{', '.join(r['device'] for r in ranks)} (one card shared): the ranks ran "
          f"(c) first step, (a) PPO, (b) update, (d) GRU-SAC in {time.perf_counter() - t0:.1f} s, "
          f"process start and CUDA set-up included", flush=True)
    local = cfg.num_envs // MESH_RANKS

    # (c)
    err = max(float((r["first_obs"].to(dev) - first_obs[local * d:local * (d + 1)]).abs().max())
              for d, r in enumerate(ranks))
    print(f"[mesh:first-step] each rank's {local} envs against its block of the single "
          f"process's {cfg.num_envs}: max |obs err| {err:.3e} (need <= {TOL_VEL:g})", flush=True)
    if not err <= TOL_VEL:
        fail("a rank's first control step differs from its block of the single process's")

    # (a)
    per_epoch = cfg.unroll_length * cfg.num_envs * cfg.action_repeat
    launches = 0
    for d, r in enumerate(ranks):
        n, rows, policy, saves = r["ppo"]
        launches += n
        for e, row in enumerate(rows, 1):
            print(f"[mesh:ppo] rank {d} epoch {e}: wall {row['wall_ms']:.1f} ms (rollout "
                  f"{row['rollout_ms']:.1f} ms, update {row['update_ms']:.1f} ms), "
                  f"{per_epoch / (row['wall_ms'] / 1e3):.1f} env-steps/s of both ranks' "
                  f"{cfg.num_envs} envs; total_loss {row['total_loss']:.6f}, entropy "
                  f"{row['entropy']:.6f}, mean_reward {row['mean_reward']:.6f}; {card}",
                  flush=True)
        if n != MESH_PPO_EPOCHS * cfg.unroll_length:
            fail(f"mesh PPO: rank {d} launched the kernel {n} times, not "
                 f"{MESH_PPO_EPOCHS * cfg.unroll_length}")
        if len(rows) != MESH_PPO_EPOCHS or not all(
                np.isfinite(row[k]) for row in rows for k in ("total_loss", "policy_loss",
                                                              "value_loss", "entropy")):
            fail(f"mesh PPO: rank {d} ran {len(rows)} epochs, or a loss is not finite")
        moved = float((torch.cat([p.reshape(-1) for p in policy]) - r["ppo_initial"]).abs().max())
        if not np.isfinite(moved) or moved == 0.0:
            fail(f"mesh PPO: rank {d}'s parameters did not move")
    metric = ("total_loss", "policy_loss", "value_loss", "entropy", "mean_reward")
    same_params = all(_digests(r, "ppo") == _digests(ranks[0], "ppo") for r in ranks)
    same_metrics = all([{k: row[k] for k in metric} for row in r["ppo"][1]]
                       == [{k: row[k] for k in metric} for row in ranks[0]["ppo"][1]]
                       for r in ranks)
    warm = [row["wall_ms"] for row in ranks[0]["ppo"][1][1:]]
    print(f"[mesh:ppo] {MESH_RANKS} ranks x {local} envs, {MESH_PPO_EPOCHS} epochs: parameters "
          f"bit-equal across the ranks after every epoch: {same_params}; metrics equal: "
          f"{same_metrics}; whole-step launches {launches}; env-steps/s after the first epoch "
          f"{per_epoch * len(warm) / (sum(warm) / 1e3):.1f}; {card}", flush=True)
    if not (same_params and same_metrics and len(ranks[0]["ppo"][3]) == MESH_PPO_EPOCHS):
        fail("mesh PPO: the ranks' parameters or metrics differ")

    # (b)
    diff = float((ranks[0]["update"][0].to(dev) - want_params).abs().max())
    rank_equal = all(torch.equal(r["update"][0], ranks[0]["update"][0]) for r in ranks)
    rel = max(abs(ranks[0]["update"][1][k] - float(want_m[k])) / max(abs(float(want_m[k])), 1e-6)
              for k in metric)
    print(f"[mesh:update] one epoch's update on the single process's rollout: the ranks' "
          f"parameters against the single process's (shuffle_blocks={MESH_RANKS}) max |diff| "
          f"{diff:.3e} (need <= {UPDATE_TOL:g}); bit-equal across the ranks: {rank_equal}; "
          f"metrics max relative diff {rel:.3e} (need <= 1e-4)", flush=True)
    if not (diff <= UPDATE_TOL and rank_equal and rel <= 1e-4):
        fail("mesh PPO: the ranks' update disagrees with the single process's")

    # the gloo all-reduces, per minibatch / grad step
    n, ms = ranks[0]["allreduce_ms"]["ppo"]
    print(f"[mesh:allreduce] gloo, {MESH_RANKS} ranks on one card: PPO's flat gradient "
          f"({n} float32, {n * 4 / 1e6:.2f} MB) {ms:.4f} ms an all-reduce, one a minibatch "
          f"(+2 scalars for the advantages); {card}", flush=True)
    parts = ranks[0]["allreduce_ms"]["gru_sac"]
    print(f"[mesh:allreduce] GRU-SAC per grad step: " + ", ".join(
        f"{k} {v[0]} float32 {v[1]:.4f} ms" for k, v in parts.items())
        + f"; {sum(v[1] for v in parts.values()):.4f} ms in all; {card}", flush=True)

    # (d)
    sc = MESH_SAC
    sac_launches = 0
    for d, r in enumerate(ranks):
        n, rows, _, saves = r["gru_sac"]
        sac_launches += n
        for e, row in enumerate(rows, 1):
            print(f"[mesh:gru_sac] rank {d} epoch {e}: wall {row['wall_ms']:.1f} ms (collect "
                  f"{row['rollout_ms']:.1f} ms, update {row['update_ms']:.1f} ms); q_loss "
                  f"{row['q_loss']:.6f}, actor_loss {row['actor_loss']:.6f}, alpha "
                  f"{row['alpha']:.6f}; replay {saves[e - 1]['buffer']['obs']}, PER table "
                  f"{saves[e - 1]['priorities']} ({saves[e - 1]['priorities_moved']} moved off "
                  f"1.0); {card}", flush=True)
        cols = sc.num_envs // MESH_RANKS
        want_obs = (sc.replay_capacity, sc.seq_len, cols, first_obs.shape[-1])
        if n != MESH_SAC_EPOCHS * sc.seqs_per_epoch * sc.seq_len:
            fail(f"mesh GRU-SAC: rank {d} launched the kernel {n} times")
        if any(s["buffer"]["obs"] != want_obs or s["priorities"] != (sc.replay_capacity, cols)
               for s in saves):
            fail(f"mesh GRU-SAC: rank {d}'s replay or PER table is not rank-local")
        if not all(np.isfinite(row[k]) for row in rows for k in ("q_loss", "actor_loss")) \
                or not rows[-1]["q_loss"] > 0 or not saves[-1]["priorities_moved"]:
            fail(f"mesh GRU-SAC: rank {d}: a non-finite loss, no gradient step or no PER "
                 f"write-back")
    same = all(_digests(r, "gru_sac") == _digests(ranks[0], "gru_sac") for r in ranks)
    print(f"[mesh:gru_sac] {MESH_RANKS} ranks x {sc.num_envs // MESH_RANKS} envs, "
          f"{sc.batch_size // MESH_RANKS} sequences a rank a grad step, PER: parameters "
          f"bit-equal across the ranks after every epoch: {same}; whole-step launches "
          f"{sac_launches}", flush=True)
    if not same:
        fail("mesh GRU-SAC: the ranks' parameters differ")
    return launches, sac_launches


def phase_dryrun(dev, card: str) -> None:
    """(e) `graft_entry.entry()` once and `dryrun_multichip(2)` on the card."""
    fn, args = graft_entry.entry(dev)
    out = fn(*args)
    torch.cuda.synchronize()
    print(f"[graft] entry ok: obs {tuple(out.obs.shape)}, finite "
          f"{bool(torch.isfinite(out.obs).all())}", flush=True)
    t0 = time.perf_counter()
    results = graft_entry.dryrun_multichip(MESH_RANKS, device=dev.type, backend=MESH_BACKEND,
                                           timeout=300)
    print(f"[mesh] {MESH_BACKEND}, world {MESH_RANKS}: dryrun_multichip's {len(results[0])} "
          f"phases in {time.perf_counter() - t0:.1f} s, metrics equal across the ranks; {card}",
          flush=True)
    if not bool(torch.isfinite(out.obs).all()):
        fail("graft entry: non-finite observations")


def phase_nccl(dev, card: str) -> None:
    """(f) the NCCL code path at world size 1."""
    r = pmesh.spawn(nccl_rank, 1, "nccl", dev.type, timeout=300)[0]
    equal = all(torch.equal(a, b) for a, b in zip(r["plain"][:3], r["mesh"][:3]))
    print(f"[mesh] nccl, world {r['world']} on {r['device']}: one PPO epoch at "
          f"ppo.ANT_TAG through the mesh against no mesh (shuffle_blocks=1): policy and "
          f"statistics bit-equal: {equal} (max |diff| "
          f"{float((r['plain'][0] - r['mesh'][0]).abs().max()):.3e}); metrics equal: "
          f"{r['plain'][3] == r['mesh'][3]}; {card}", flush=True)
    if not equal or r["backend"] != "nccl":
        fail("the one-rank NCCL mesh's epoch differs from the plain one")



# ---- the examples phase ------------------------------------------------------


def _per_epoch(module: str, kw: dict):
    """(env-steps an epoch as JAX counts them, kernel launches an epoch,
    epochs a call) of a learner's `train(**kw)`."""
    cls = {"ppo": ppo.PPOConfig, "ppo_rnn": ppo_rnn.RNNPPOConfig, "sac_rnn": sac_rnn.RSACConfig}
    fields = {f.name for f in dataclasses.fields(cls[module])}
    cfg = cls[module](**{k: v for k, v in kw.items() if k in fields})
    if module == "sac_rnn":
        steps = cfg.seqs_per_epoch * cfg.seq_len
        return steps * cfg.num_envs * cfg.action_repeat, steps, 1
    return (cfg.unroll_length * cfg.num_envs * cfg.action_repeat, cfg.unroll_length,
            max(1, cfg.epochs_per_call))


class _ExampleSpy:
    """Watches the examples as they run, changing nothing: every `train` of
    ppo, ppo_rnn and sac_rnn (wall, whole-step launches, the returned
    history and parameters, the env's wrapper classes and its core's
    substeps before and after), every ActionRepeatWrapper (each core env
    must be rescaled once: a core shared between two stacks would be
    rescaled twice), and, through `_SaveSpy`, every checkpoint save."""

    def __init__(self):
        self.trains, self.rescales = [], []
        self._saves = _SaveSpy()

    @property
    def saves(self):
        return self._saves.saves

    def __enter__(self):
        self._modules = {"ppo": ppo, "ppo_rnn": ppo_rnn, "sac_rnn": sac_rnn}
        self._train = {name: m.train for name, m in self._modules.items()}
        for name, m in self._modules.items():
            m.train = self._wrap(name, self._train[name])
        self._ar_init = wrappers.ActionRepeatWrapper.__init__
        spy, ar_init = self, self._ar_init

        def init(wrapper, env, action_repeat):
            core = env.unwrapped
            before = core.sys.config.substeps
            ar_init(wrapper, env, action_repeat)
            if action_repeat != 1:  # the core itself is kept: ids of freed objects recur
                spy.rescales.append((core, type(core).__name__, before,
                                     core.sys.config.substeps))

        wrappers.ActionRepeatWrapper.__init__ = init
        self._saves.__enter__()
        return self

    def __exit__(self, *exc):
        for name, m in self._modules.items():
            m.train = self._train[name]
        wrappers.ActionRepeatWrapper.__init__ = self._ar_init
        self._saves.__exit__(*exc)

    def _wrap(self, name, train):
        def spied(env, *args, **kw):
            chain, e = [], env
            while isinstance(e, Wrapper):
                chain.append(type(e).__name__)
                e = e.env
            before = e.sys.config.substeps
            torch.cuda.synchronize()
            launched, t0 = whole_step.launches, time.perf_counter()
            out = train(env, *args, **kw)
            torch.cuda.synchronize()
            per_epoch, launches_per_epoch, per_call = _per_epoch(name, kw)
            if kw.get("carry_env") is not None:
                launches_per_epoch *= 2  # the carry columns' env steps apart: two launches
            self.trains.append({
                "learner": name, "wall": time.perf_counter() - t0,
                "launches": whole_step.launches - launched, "history": out[2],
                "params": out[1][1], "chain": chain + [type(e).__name__],
                "substeps": (before, e.sys.config.substeps),
                "epochs": len(out[2]) * per_call, "per_epoch": per_epoch,
                "launches_per_epoch": launches_per_epoch, "num_envs": kw["num_envs"]})
            return out
        return spied

    def take(self):
        """The trains and rescales recorded since the last take."""
        out = (self.trains, self.rescales)
        self.trains, self.rescales = [], []
        return out


def _check_trains(tag: str, trains, card: str, action_repeat=None) -> float:
    """Prints and checks each recorded train: one kernel launch a control
    step, finite losses, the core's substeps scaled once by
    `action_repeat` (ACTION_REPEAT unless given). Returns the trains'
    env-steps."""
    action_repeat = ACTION_REPEAT if action_repeat is None else action_repeat
    steps = 0
    for i, t in enumerate(trains):
        env_steps = t["epochs"] * t["per_epoch"]
        steps += env_steps
        losses = [v for m in t["history"] for k, v in m.items() if "loss" in k or k == "alpha"]
        print(f"[examples:{tag}] train {i + 1} ({t['learner']}, {' > '.join(t['chain'])}, "
              f"{t['num_envs']} envs): {t['epochs']} epochs, {env_steps} env-steps in "
              f"{t['wall']:.3f} s = {env_steps / t['wall']:.1f} env-steps/s, whole-step launches "
              f"{t['launches']}; substeps {t['substeps'][0]} -> {t['substeps'][1]}; last "
              + ", ".join(f"{k} {v:.6f}" for k, v in t["history"][-1].items()
                          if k in ("total_loss", "q_loss", "actor_loss", "mean_reward"))
              + f"; {card}", flush=True)
        if t["launches"] != t["epochs"] * t["launches_per_epoch"]:
            fail(f"{tag}: train {i + 1} launched the kernel {t['launches']} times, not "
                 f"{t['epochs'] * t['launches_per_epoch']} (one a control step)")
        if not losses or not all(np.isfinite(losses)):
            fail(f"{tag}: train {i + 1} has no or a non-finite loss")
        if t["substeps"][1] != t["substeps"][0] * action_repeat:
            fail(f"{tag}: train {i + 1}'s core env went from {t['substeps'][0]} to "
                 f"{t['substeps'][1]} substeps, not x{action_repeat}")
    return steps


def _check_rescales(tag: str, rescales, want_before) -> None:
    """Every core env under an ActionRepeatWrapper was rescaled once, from
    its own substeps (`want_before`: a number or a set of numbers)."""
    ids = [id(r[0]) for r in rescales]
    befores = {r[2] for r in rescales}
    want = {want_before} if isinstance(want_before, int) else set(want_before)
    print(f"[examples:{tag}] ActionRepeatWrapper rescaled {len(ids)} core envs, each once: "
          f"{len(set(ids)) == len(ids)}; substeps before {sorted(befores)} -> after "
          f"{sorted({r[3] for r in rescales})}", flush=True)
    if len(set(ids)) != len(ids) or not befores <= want:
        fail(f"{tag}: a core env was rescaled twice (a shared core), or from {befores}")


def _take_shapes() -> dict:
    """The whole-step launches per (substeps, batch) since the last take."""
    out = dict(whole_step.launches_by_shape)
    whole_step.launches_by_shape.clear()
    return out


def _step_line(tag: str, t0: float, launches: int, train_steps: float, card: str,
               lap) -> None:
    wall = time.perf_counter() - t0
    print(f"[examples:{tag}] wall {wall:.3f} s, trained env-steps {train_steps:.0f} "
          f"({train_steps / wall:.1f} env-steps/s over the whole step, evaluations included), "
          f"whole-step launches {launches}; {card}", flush=True)
    lap(f"examples:{tag}")


def phase_examples(dev, card: str, tmp: str, lap, which=EXAMPLE_STEPS) -> dict:
    """The steps of the examples phase named in `which` ("shaping", then
    (a)-(h) as the module docstring lists them), in that order; -> the
    whole-step launches of each (System, batch) entry."""
    launches = {}

    def count(tag, entries):
        """Adds the launches since `start()` to the entry of their (substeps,
        batch) in `entries`; fails on a launch at a pair that no entry holds
        against the plain step."""
        shapes = _take_shapes()
        stray = sorted(set(shapes) - set(entries))
        print(f"[examples:{tag}] whole-step launches per entry: " + ", ".join(
            f"{entries[k]} {n}" for k, n in sorted(shapes.items()) if k in entries), flush=True)
        if stray:
            fail(f"{tag}: launches at (substeps, batch) {stray}, which no entry compares")
        for shape, n in shapes.items():
            launches[entries[shape]] = launches.get(entries[shape], 0) + n

    def start():
        torch.cuda.synchronize()
        whole_step.launches = 0
        _take_shapes()
        return time.perf_counter()

    # each core env's own substeps (every PO ant task's 10), the learners'
    # 60 and HH_SUBSTEPS=8's 48 under ActionRepeat(6), the evaluators' batch
    sub = {n: _envs[n](device=dev).sys.config.substeps
           for n in ("ant_tag", "ant", "inverted_pendulum")}
    x6, x8, ev = sub["ant_tag"] * ACTION_REPEAT, 8 * ACTION_REPEAT, EVAL_EPISODES

    # the recipes' budgets: a GRU-PPO epoch at GRU_ENVS, a call of 8, a
    # GRU-SAC epoch at SAC_ENVS
    cfg = dataclasses.replace(ppo_rnn.ANT_TAG, num_envs=GRU_ENVS)
    per_epoch = cfg.unroll_length * cfg.num_envs * ACTION_REPEAT
    call = 8 * per_epoch
    sac_cfg = train_ant_tag_sac_rnn.RECIPE
    sac_epoch = sac_cfg["seqs_per_epoch"] * sac_cfg["seq_len"] * SAC_ENVS * ACTION_REPEAT

    if "shaping" in which:
        phase_shaping_overhead(dev, card)
        lap("examples:shaping overhead")
    if "a" in which:
        # (a)'s initial parameters as train() makes them from the seed (its
        # probe's env stack stays out of the spy's rescale count)
        probe = ppo_rnn.RNNPPOLearner(ppo.wrap_for_training(AntTagEnv(device=dev), cfg, "naive"),
                                      cfg)
        initial = params_vector(probe.make_params(jr.split(jr.PRNGKey(0, dev), 3)[1]))
        del probe
    with _ExampleSpy() as spy:
        if "a" in which:
            # (a) the main path: the AntTag curriculum, one epoch a phase
            curriculum = tuple((r, (i + 1) * per_epoch)
                               for i, (r, _) in enumerate(train_ant_tag_rnn.CURRICULUM))
            out = os.path.join(tmp, "tag_curriculum.json")
            t0 = start()
            det = train_ant_tag_rnn.main_curriculum(cfg.num_envs, os.path.join(tmp, "tag_ckpt"),
                                                    curriculum, seed=0, device=dev, out=out)
            n = whole_step.launches
            trains, rescales = spy.take()
            with open(out) as f:
                record = json.load(f)
            steps = _check_trains("tag_curriculum", trains, card)
            _check_rescales("tag_curriculum", rescales, 10)
            saves = [(s["epochs"]) for s in spy.saves[-3:]]
            moved = float((params_vector(trains[-1]["params"]) - initial).abs().max())
            print(f"[examples:tag_curriculum] phases at visible radius "
                  f"{[r for r, _ in curriculum]}, {len(trains)} trains of one epoch, the "
                  f"checkpoint resumed at each boundary: epochs saved {saves}; largest parameter "
                  f"change {moved:.6e}; true-env tag rate on 256 episodes det {det:.4f} / stoch "
                  f"{record['true_tag_rate_stoch']:.4f} (reported, not gated: the policy has "
                  f"trained 3 epochs); evaluation launches "
                  f"{n - sum(t['launches'] for t in trains)}",
                  flush=True)
            if len(trains) != 3 or saves != [1, 2, 3] or not all(t["epochs"] == 1 for t in trains):
                fail("the AntTag curriculum did not resume one checkpoint across its three phases")
            if not np.isfinite(moved) or moved == 0.0 or len(rescales) != 5:
                fail("the AntTag curriculum's parameters did not move, or its envs were not each "
                     "rescaled once")
            count("tag_curriculum", {(x6, cfg.num_envs): LEARNER, (x6, ev): LEARNER_AT[ev]})
            _step_line("tag_curriculum", t0, n, steps, card, lap)

        if "b" in which:
            # (b) the checkpoint replays
            for name in eval_checkpoint.CHECKPOINTS:
                t0 = start()
                got = eval_checkpoint.main(name, device=dev)
                n = whole_step.launches
                env_name = eval_checkpoint.CHECKPOINTS[name][0]
                count(f"replay:{name}", {(x6, ev): f"{env_name},action_repeat=6,B={ev}"})
                gates = REPLAY_GATES[name]
                print(f"[examples:replay:{name}] checksum equal: {got['checksum_ok']}; "
                      + ", ".join(f"{k} {got[k]:.4f} (gate >= {v})" for k, v in gates.items())
                      + f"; whole-step launches {n}", flush=True)
                if not got["checksum_ok"] or not all(got[k] >= v for k, v in gates.items()):
                    fail(f"the {name} checkpoint's replay fails its gates")
                _step_line(f"replay:{name}", t0, n, 0, card, lap)
            # the masked-ant arms the port trained, on `ant` at action_repeat 1
            with open(PORT_MASKED_ANT_RECORD) as f:
                record = json.load(f)
            t0 = start()
            got = eval_checkpoint.main("masked_ant_port", device=dev)
            n = whole_step.launches
            count("replay:masked_ant_port", {(sub["ant"], ev): f"ant,B={ev}"})
            rewards = {arm: got[arm]["episode_reward"] for arm in train_masked_ant.ARMS}
            gates = {arm: (1 - PORT_MASKED_ANT_MARGIN)
                     * record[train_masked_ant.RESULT_KEYS[arm]]["episode_reward"]
                     for arm in rewards}
            print("[examples:replay:masked_ant_port] " + "; ".join(
                f"{arm}: checksum equal {got[arm]['checksum_ok']}, episode reward "
                f"{rewards[arm]:.4f} (gate >= {gates[arm]:.4f}), x-displacement "
                f"{got[arm]['x_displacement']:.4f}" for arm in rewards)
                + f"; whole-step launches {n}", flush=True)
            if (not all(got[arm]["checksum_ok"] and rewards[arm] >= gates[arm] for arm in rewards)
                    or not rewards["ff_full"] > max(rewards["ff_masked"], rewards["gru_masked"])):
                fail("the masked-ant arms' replay fails its gates, or FF full is not above both "
                     "masked arms")
            _step_line("replay:masked_ant_port", t0, n, 0, card, lap)

        if "c" in which:
            # (c) the gather curriculum at the bombmem02 recipe, one call a phase
            knobs = train_ant_gather_rnn.GatherKnobs(
                curriculum=((14.0, call), (6.0, 2 * call), (6.0, 3 * call)),
                novelty=(0.25, 0.25, 0.0), bomb_memory=0.2)
            t0 = start()
            record = train_ant_gather_rnn.main_curriculum(
                cfg.num_envs, os.path.join(tmp, "gather_ckpt"), knobs, device=dev,
                out=os.path.join(tmp, "gather.json"))
            n = whole_step.launches
            trains, rescales = spy.take()
            steps = _check_trains("gather_curriculum", trains, card)
            _check_rescales("gather_curriculum", rescales, 10)
            chain = ["GridNoveltyBonusWrapper", "ShapedAntGather"]
            if ([t["chain"][:2] for t in trains] != [chain] * 3
                    or [t["epochs"] for t in trains] != [8, 8, 8]):
                fail("the gather curriculum did not train 8 epochs a phase on the novelty-wrapped "
                     "shaped env")
            print(f"[examples:gather_curriculum] gather_eval on 256 episodes: "
                  + ", ".join(f"{m} apples {v['apples']:.4f} bombs {v['bombs']:.4f}"
                              for m, v in record["results"].items()), flush=True)
            count("gather_curriculum", {(x6, cfg.num_envs): "ant_gather,action_repeat=6",
                                        (x6, ev): f"ant_gather,action_repeat=6,B={ev}"})
            _step_line("gather_curriculum", t0, n, steps, card, lap)

        if "d" in which:
            # (d) the maze's main: the random policy's goal rate, one call of 8
            # epochs (the checkpoint written under its own directory), then the
            # GRU policy's goal rates det and stoch
            t0 = start()
            maze_ckpt = os.path.join(tmp, "maze_ckpt")
            record = train_ant_maze_rnn.main(call, cfg.num_envs, checkpoint_dir=maze_ckpt,
                                             device=dev, out=os.path.join(tmp, "maze.json"))
            n = whole_step.launches
            trains, rescales = spy.take()
            steps = _check_trains("maze", trains, card)
            _check_rescales("maze", rescales, 10)
            rates = [record["random_goal_rate"], record["results"]["det"],
                     record["results"]["stoch"]]
            print(f"[examples:maze] main at MAZE_SEED {record['seed']}: goal rate on 256 episodes "
                  f"random {rates[0]:.4f}, GRU det {rates[1]:.4f}, stoch {rates[2]:.4f}; saved "
                  f"epochs {spy.saves[-1]['epochs']} under "
                  f"{os.path.relpath(spy.saves[-1]['root'], tmp)}",
                  flush=True)
            if (trains[0]["epochs"] != 8 or spy.saves[-1]["epochs"] != 8
                    or spy.saves[-1]["root"] != maze_ckpt or not all(0 <= r <= 1 for r in rates)):
                fail("the maze did not train one call of 8 epochs into its checkpoint dir, or a "
                     "goal rate is not a rate")
            count("maze", {(x6, cfg.num_envs): "ant_maze,action_repeat=6",
                           (x6, ev): f"ant_maze,action_repeat=6,B={ev}"})
            _step_line("maze", t0, n, steps, card, lap)

        if "e" in which:
            # (e) HeavenHell's main, an epoch at 10 substeps and one at
            # HH_SUBSTEPS=8 (with the transfer evaluation on the true 10), each
            # with the random and GRU outcome rates; then the GRU-SAC recipe's
            t0 = start()
            hh = {}
            hh[10] = train_heavenhell_rnn.main(per_epoch, cfg.num_envs, device=dev,
                                               out=os.path.join(tmp, "hh10.json"))
            saved = os.environ.get("HH_SUBSTEPS")
            os.environ["HH_SUBSTEPS"] = "8"
            try:
                hh[8] = train_heavenhell_rnn.main(per_epoch, cfg.num_envs, device=dev,
                                                  out=os.path.join(tmp, "hh8.json"))
            finally:
                if saved is None:
                    del os.environ["HH_SUBSTEPS"]
                else:
                    os.environ["HH_SUBSTEPS"] = saved
            hh_sac = train_heavenhell_sac_rnn.RECIPE
            hh_epoch = hh_sac["seqs_per_epoch"] * hh_sac["seq_len"] * SAC_ENVS * ACTION_REPEAT
            hh["sac"] = train_heavenhell_sac_rnn.main(HH_SAC_EPOCHS * hh_epoch, SAC_ENVS,
                                                      device=dev,
                                                      out=os.path.join(tmp, "hh_sac.json"))
            n = whole_step.launches
            trains, rescales = spy.take()
            steps = _check_trains("heavenhell", trains, card)
            _check_rescales("heavenhell", rescales, {10, 8})
            outcomes = {f"{run}:{k}": v for run, rec in hh.items() for k, v in rec.items()
                        if isinstance(v, dict) and "completion" in v}
            print(f"[examples:heavenhell] substeps of the trained cores "
                  f"{[t['substeps'] for t in trains]}; outcome_rates on 256 episodes (completion, "
                  f"heaven | completed): " + ", ".join(
                      f"{k} {v['completion']:.4f} / {v['heaven']:.4f}" for k, v in outcomes.items())
                  + f"; GRU-SAC last q_loss {trains[-1]['history'][-1]['q_loss']:.6f}", flush=True)
            if ([t["substeps"] for t in trains] != [(10, x6), (8, x8), (10, x6)]
                    or (hh[10]["substeps"], hh[8]["substeps"]) != (10, 8)
                    or "gru_det_on_true_substeps10" not in hh[8]
                    or "gru_det_on_true_substeps10" in hh[10]
                    or not trains[-1]["history"][-1]["q_loss"] > 0):
                fail("HeavenHell: wrong substeps, no transfer evaluation at HH_SUBSTEPS=8, or "
                     "GRU-SAC took no gradient step")
            if not all(0 <= v[k] <= 1 for v in outcomes.values() for k in ("completion", "heaven")):
                fail("HeavenHell: an outcome rate is not a rate")
            count("heavenhell", {(x6, cfg.num_envs): "ant_heavenhell,action_repeat=6",
                                 (x8, cfg.num_envs): "ant_heavenhell,substeps=8,action_repeat=6",
                                 (x6, SAC_ENVS): f"ant_heavenhell,action_repeat=6,B={SAC_ENVS}",
                                 (x6, ev): f"ant_heavenhell,action_repeat=6,B={ev}",
                                 (x8, ev): f"ant_heavenhell,substeps=8,action_repeat=6,B={ev}"})
            _step_line("heavenhell", t0, n, steps, card, lap)

        if "f" in which:
            # (f) GRU-SAC phase 0 past min_replay, then the carry run, each with
            # its tag rates det and stoch at two radii
            export_epochs = int(ckpt.load_npz(train_ant_tag_sac_rnn_carry.PHASE0)["epochs"])
            t0 = start()
            phase0 = train_ant_tag_sac_rnn.run_phase(0, SAC_ENVS, os.path.join(tmp, "sac_ckpt"),
                                                     budget=SAC_PHASE_EPOCHS * sac_epoch,
                                                     device=dev, out=os.path.join(tmp, "sac0.json"))
            phase0_saves = spy.saves[-1]
            carried = train_ant_tag_sac_rnn_carry.main(
                CARRY_FRAC, 0, SAC_ENVS, os.path.join(tmp, "carry_ckpt"),
                num_timesteps=(export_epochs + CARRY_EPOCHS) * sac_epoch, device=dev,
                out=os.path.join(tmp, "carry.json"))
            carry = spy.saves[-1]
            tag_rates = {**{f"phase0:{k}": v for k, v in phase0["results"].items()},
                         **{f"carry:{k}": v for k, v in carried["results"].items()}}
            n = whole_step.launches
            trains, rescales = spy.take()
            steps = _check_trains("gru_sac", trains, card)
            _check_rescales("gru_sac", rescales, 10)
            seen = np.asarray(carry["target_seen"])
            k = round(CARRY_FRAC * SAC_ENVS)
            print(f"[examples:gru_sac] run_phase(0): {trains[0]['epochs']} epochs, saved epochs "
                  f"{phase0_saves['epochs']}, last q_loss "
                  f"{trains[0]['history'][-1]['q_loss']:.6f}; carry: resumed the phase-0 export "
                  f"({export_epochs} epochs), saved epochs {carry['epochs']}; replay "
                  f"{carry['buffer']['obs']}: the target seen in {seen[:k].mean():.4f} of the "
                  f"carry columns' (radius 20) steps and {seen[k:].mean():.4f} of the train "
                  f"columns' (radius 4); tag rates on 256 episodes: "
                  + ", ".join(f"{name} {v:.4f}" for name, v in tag_rates.items()), flush=True)
            if len(tag_rates) != 8 or not all(0 <= v <= 1 for v in tag_rates.values()):
                fail("GRU-SAC: the drivers did not report their eight tag rates")
            if (phase0_saves["epochs"] != SAC_PHASE_EPOCHS or carry["epochs"]
                    != export_epochs + CARRY_EPOCHS or not trains[0]["history"][-1]["q_loss"] > 0):
                fail("GRU-SAC: the epoch counts or the gradient steps are not as planned")
            if not seen[:k].min() > 0.99 or not seen[k:].mean() < seen[:k].mean() - 0.1:
                fail("the carry run's replay does not hold [carry | train] columns")
            count("gru_sac", {(x6, b): LEARNER_AT[b]
                              for b in (SAC_ENVS, ev, SAC_ENVS - k, k)})
            _step_line("gru_sac", t0, n, steps, card, lap)

        if "g" in which:
            # (g) the masked studies
            t0 = start()
            masked_ant = train_masked_ant.main(32 * MASKED_ANT_ENVS, MASKED_ANT_ENVS, device=dev,
                                               out=os.path.join(tmp, "masked_ant.json"))
            pendulum = train_masked_pendulum.main(32 * 1024, device=dev,
                                                  out=os.path.join(tmp, "pendulum.json"))
            sac_pendulum = train_sac_rnn_pendulum.main(PENDULUM_SAC_EPOCHS * 4 * 16 * 64,
                                                       device=dev,
                                                       out=os.path.join(tmp, "pendulum.json"))
            n = whole_step.launches
            trains, rescales = spy.take()
            steps = _check_trains("masked", trains, card, action_repeat=1)
            print(f"[examples:masked] ant ({MASKED_ANT_ENVS} envs): "
                  + ", ".join(f"{k} {v}" for k, v in masked_ant.items() if isinstance(v, dict))
                  + f"; pendulum (1024 envs): " + ", ".join(
                      f"{k} {pendulum[k]:.2f}" for k in ("feedforward_full_obs",
                                                          "feedforward_masked", "gru_masked"))
                  + f"; GRU-SAC pendulum (64 envs) {sac_pendulum['gru_sac_masked']:.2f}",
                  flush=True)
            if [t["epochs"] for t in trains] != [1] * 6 + [PENDULUM_SAC_EPOCHS] or rescales:
                fail("the masked studies did not train as planned")
            a, p = sub["ant"], sub["inverted_pendulum"]
            count("masked", {(a, MASKED_ANT_ENVS): f"ant,B={MASKED_ANT_ENVS}",
                             (a, ev): f"ant,B={ev}", (p, 1024): "inverted_pendulum,B=1024",
                             (p, 64): "inverted_pendulum,B=64",
                             (p, ev): f"inverted_pendulum,B={ev}"})
            _step_line("masked", t0, n, steps, card, lap)

    if "h" in which:
        # (h) the renderer and the rollout demo's native path
        t0 = start()
        page = visualize.main("ant_tag", HTML_FRAMES, os.path.join(tmp, "ant_tag_random.html"),
                              device=dev)
        with open(page) as f:
            frames = json.loads(re.search(r"const FRAMES\s*=\s*(.*?);\n", f.read(),
                                          re.DOTALL).group(1))
        demo = rollout_demo.native_path("ant_tag", 16, NATIVE_DEMO_STEPS, device=dev)
        n = whole_step.launches
        print(f"[examples:render] visualize: {len(frames)} frames; rollout_demo.native_path "
              f"{demo['env_steps_per_s']:.1f} env-steps/s, mean reward {demo['mean_reward']:.4f}",
              flush=True)
        if len(frames) != HTML_FRAMES or n != HTML_FRAMES + 2 * NATIVE_DEMO_STEPS:
            fail("visualize or the rollout demo missed the kernel")
        count("render", {(sub["ant_tag"], 1): "ant_tag,B=1", (sub["ant_tag"], 16): "ant_tag,B=16"})
        _step_line("render", t0, n, 0, card, lap)

    return launches


def _part(which, tmp: str, out: str) -> None:
    """One background process: the examples' steps `which` (phase 18), or
    with TOOLS_PART the benches and tools (phase 19), on the card, in `tmp`;
    writes the whole-step launches of each entry to `out` (JSON)."""
    # a terminated part exits through its atexit handlers, which stop the
    # ranks bench_scaling spawns
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(1))
    dev = torch.device("cuda")
    t0 = last = time.perf_counter()
    part = "+".join(which)

    def lap(label: str) -> None:
        nonlocal last
        now = time.perf_counter()
        print(f"[clock] {label}: {now - last:.1f} s; {now - t0:.1f} s since part {part} began",
              flush=True)
        last = now

    if which == TOOLS_PART:
        launches = phase_tools(dev, card_line(), tmp, lap)
        print(f"[clock] benches and tools (phase 19): {time.perf_counter() - t0:.1f} s",
              flush=True)
    else:
        launches = phase_examples(dev, card_line(), tmp, lap, which)
    with open(out, "w") as f:
        json.dump(launches, f)


_RUNNING = []  # (process, directory, which) of each background part started


def start_parts(tmp: str) -> None:
    """Starts each part of BACKGROUND_PARTS in a spawned process of its own
    (the parent holds a CUDA context, and the kernel it built is loaded from
    build/), each with its own counts and a directory under `tmp`."""
    ctx = multiprocessing.get_context("spawn")
    for i, which in enumerate(BACKGROUND_PARTS):
        part_dir = os.path.join(tmp, f"part{i}")
        os.makedirs(part_dir)
        proc = ctx.Process(target=_part,
                           args=(which, part_dir, os.path.join(part_dir, "launches.json")))
        proc.start()
        _RUNNING.append((proc, part_dir, which))


def check_parts() -> None:
    """Fails (stopping the other parts) once a background part has failed."""
    failed = [(which, proc.exitcode) for proc, _, which in _RUNNING
              if proc.exitcode not in (None, 0)]
    if failed:
        fail(f"background parts failed (part, exit code): {failed}")


def stop_parts() -> None:
    """Terminates the background parts still running and waits for each."""
    for proc, _, _ in _RUNNING:
        if proc.is_alive():
            proc.terminate()
    for proc, _, _ in _RUNNING:
        proc.join()


def join_parts() -> dict:
    """Waits for every background part; fails if one failed. -> the
    whole-step launches of each entry, summed over the parts."""
    while any(proc.is_alive() for proc, _, _ in _RUNNING):
        check_parts()
        time.sleep(1.0)
    for proc, _, _ in _RUNNING:
        proc.join()
    check_parts()
    launches = {}
    for _, part_dir, _ in _RUNNING:
        with open(os.path.join(part_dir, "launches.json")) as f:
            for key, n in json.load(f).items():
                launches[key] = launches.get(key, 0) + n
    _RUNNING.clear()
    return launches


# phase 19: the benches and the measuring tools, each through its entry
# point, in a process of its own beside the examples' (BACKGROUND_PARTS).
# Depth cut to hold the phase near 150 s (every path, comparison and count
# runs): bench.py's naive mode 200 -> 10 steps,
# the training benches one timed call (3), the scaling sweep 4 steps and one
# timed call, bench_substeps 25 steps (200), ablate_bench 1 step (200),
# roofline 50 steps (200), overlap_study 500 launches / 300 matmul steps
# (10000 / 3000), autoreset_study and substeps_probe at 64 envs (the probe 25
# steps a candidate, 1000, two candidates of four), per_study one rung of 9
# epochs (the last with gradient steps) and one seed
TOOLS_BENCH = {"BENCH_STEPS": "200", "BENCH_SINGLE_MODE": "1", "BENCH_AUTORESET": "cached",
               "BENCH_TRAIN": "1", "TRAIN_EPC": "1", "TRAIN_REPEATS": "1"}
TOOLS_BENCH_NAIVE = {"BENCH_STEPS": "10", "BENCH_SINGLE_MODE": "1", "BENCH_AUTORESET": "naive"}
TOOLS_TRAIN_REPEATS = "1"
TOOLS_SCALING = {"BENCH_SIZES": "1,2", "BENCH_PROGRAMS": "step,ppo", "BENCH_STEPS": "4",
                 "BENCH_REPEATS": "1"}
TOOLS_SUBSTEPS_STEPS, TOOLS_ABLATE_STEPS, TOOLS_ROOF_STEPS = 25, 1, 50
TOOLS_OVERLAP = ("500", "300")
STUDY_ENVS, STUDY_STEPS, STUDY_EPISODE = 64, 100, 20
# the substeps probe runs the reference and the retune the JAX package kept
# (8); its other candidates, 5 substeps at three stiffness scales, are past
# the integrator's stability edge, where one control step amplifies
# round-off beyond any tolerance: the kernel's own host build and the plain
# step part in most envs there (tests/test_torch_tools.py), so no launch of
# them can be held against the plain step
PROBE_CANDIDATES, PROBE_STEPS = ((10, 1.0), (8, 1.0)), 25
PER_BUDGET = 9 * 4 * 16 * 64  # nine GRU-SAC epochs of per_study.COMMON's 64 envs
SPEED_EPISODES = 8  # tools/ant_speed_probe.py's
TOOLS_SUBSTEPS = 8  # bench_substeps' candidate
# the (System, batch) pairs the tools add: (entry, how its core env is made,
# batch, action_repeat, wall (axis, value) or None). Past h_sub =
# STABLE_H_SUB (tools/substeps_probe.py's stability edge; the ablation's one
# substep) the spring joints blow up within a few steps of random actions,
# so such a System is compared one step from a reset
STABLE_H_SUB = 0.00625
TOOL_CORES = (
    ("ant_tag,no_walls", lambda dev: ablate_bench.variant_envs(dev)["no_walls"], B, 1, None),
    ("ant_tag,no_contacts", lambda dev: ablate_bench.variant_envs(dev)["no_contacts"], B, 1,
     None),
    ("ant_tag,substeps=1", lambda dev: ablate_bench.variant_envs(dev)["substeps_1"], B, 1,
     (0, WALL_TORSO_X)),
    (f"ant_tag,substeps={TOOLS_SUBSTEPS}",
     lambda dev: substeps_probe.retuned_env("ant_tag", TOOLS_SUBSTEPS, 1.0, dev), B, 1,
     (0, WALL_TORSO_X)),
    *((f"ant_tag,substeps={ss},stiffness={sc:g},action_repeat=6,B={STUDY_ENVS}"
       if (ss, sc) != (10, 1.0) else f"{LEARNER},B={STUDY_ENVS}",
       (lambda ss, sc: lambda dev: substeps_probe.retuned_env("ant_tag", ss, sc, dev))(ss, sc),
       STUDY_ENVS, ACTION_REPEAT, (0, WALL_TORSO_X))
      for ss, sc in PROBE_CANDIDATES),
    (f"ant_heavenhell,B={STUDY_ENVS}", lambda dev: _envs["ant_heavenhell"](device=dev),
     STUDY_ENVS, 1, PO_WALLS["ant_heavenhell"]),
    (f"{LEARNER},B={SPEED_EPISODES}", lambda dev: ant_speed_probe.env_for(ant_speed_probe.CKPT,
                                                                          dev),
     SPEED_EPISODES, ACTION_REPEAT, (0, WALL_TORSO_X)),
    ("ant_gather,action_repeat=6,B=1", lambda dev: _envs["ant_gather"](device=dev), 1,
     ACTION_REPEAT, None),
    ("ant_maze,action_repeat=6,B=1", lambda dev: _envs["ant_maze"](device=dev), 1, ACTION_REPEAT,
     PO_WALLS["ant_maze"]),
)
# bench_scaling's per-rank batches (strong: 512 in all, one and two ranks)
# and bench_train's GRU-PPO, at AntTag's own 10 substeps
TOOL_ANT_TAG_BATCHES = (512, 256, 2048)


def core_kernel_vs_plain(dev, tag: str, core, batch: int, action_repeat: int = 1, wall=None):
    """Kernel against plain on the System of a core env (under ActionRepeat
    when `action_repeat` > 1) at `batch` envs, from a reset plus a few plain
    steps (none past the integrator's stability edge, a substep longer than
    STABLE_H_SUB: random actions blow it up within a few steps); with `wall`
    = (axis, value) a sixteenth of the ants (at least one) pushed against a
    wall, whose capsule-box rows must be live."""
    if action_repeat > 1:
        wrappers.ActionRepeatWrapper(core, action_repeat)
    sys_ = core.sys
    qp = core.reset(jr.split(jr.PRNGKey(6, dev), batch)).qp
    g = torch.Generator(device=dev).manual_seed(6)
    stable = sys_.config.dt / sys_.config.substeps <= STABLE_H_SUB
    warm = 0 if not stable else 20 if action_repeat == 1 else 3
    qp = plain_steps(sys_, qp, warm, g)
    if wall is not None:
        qp = push_ants(core, qp, *wall, count=max(1, batch * WALL_ENVS // B))
    live = live_rows(sys_, qp)
    act = torch.rand(batch, sys_.action_size, generator=g, device=dev) * 2 - 1
    max_err = compare(tag, sys_, qp, act, f"; {sys_.config.substeps} substeps; envs with a live "
                      "row: " + (", ".join(f"{k} {v}" for k, v in live.items()) or "none"))
    if wall is not None and live.get("capsule_box", 0) == 0:
        fail(f"{tag}: no env touched a wall: the capsule-box rows went unchecked")
    return sys_, qp, act, max_err


def phase_tools_kernel_vs_plain(dev) -> dict:
    """The kernel against the plain step on each (System, batch) the benches
    and tools add: -> {entry: (sys, qp, act, max |err|)}."""
    out = {}
    for tag, make, batch, repeat, wall in TOOL_CORES:
        out[tag] = core_kernel_vs_plain(dev, tag, make(dev), batch, repeat, wall)
    for batch in TOOL_ANT_TAG_BATCHES:
        out[f"ant_tag,B={batch}"] = phase_stock_kernel_vs_plain(dev, "ant_tag", batch)
    return out


def _finite_rates(tag: str, rates) -> None:
    if not rates or not all(np.isfinite(r) and r > 0 for r in rates):
        fail(f"{tag}: a rate that is not finite and positive: {rates}")


def phase_tools(dev, card: str, tmp: str, lap) -> dict:
    """Phase 19: each bench and tool through its entry point (module
    docstring); every launch counted under the entry of its (System,
    batch). -> the whole-step launches of each entry."""
    launches = {}
    x6, ev = 10 * ACTION_REPEAT, EVAL_EPISODES
    sub_p = _envs["inverted_pendulum"](device=dev).sys.config.substeps

    def add(entry: str, n: int) -> None:
        launches[entry] = launches.get(entry, 0) + n

    def run(label: str, call, entries=None):
        """call() with the launches it makes counted under `entries`
        ({(substeps, batch): entry}; None: the caller attributes them)."""
        torch.cuda.synchronize()
        _take_shapes()
        t0 = time.perf_counter()
        out = call()
        torch.cuda.synchronize()
        shapes = _take_shapes()
        if entries is not None:
            stray = sorted(set(shapes) - set(entries))
            if stray:
                fail(f"{label}: launches at (substeps, batch) {stray}, which no entry compares")
            for shape, n in shapes.items():
                add(entries[shape], n)
        print(f"[tools:{label}] {time.perf_counter() - t0:.1f} s, whole-step launches "
              f"{sum(shapes.values())} ({', '.join(f'{k}: {n}' for k, n in sorted(shapes.items()))}"
              f"); {card}", flush=True)
        lap(f"tools:{label}")
        return out

    tag = {(10, B): "ant_tag"}
    rec = run("bench cached + train", lambda: bench.main(TOOLS_BENCH, dev), tag)
    _finite_rates("bench", [rec["value"], rec["train"]["value"], *rec["modes"]["cached"]["runs"]])
    rec = run("bench naive", lambda: bench.main(TOOLS_BENCH_NAIVE, dev), tag)
    _finite_rates("bench naive", rec["modes"]["naive"]["runs"])
    for program, entries in ((None, tag), ("rnn", {(10, 2048): "ant_tag,B=2048"}),
                             ("sac_rnn", {(x6, 512): "ant_heavenhell,action_repeat=6,B=512"})):
        env_vars = {"TRAIN_REPEATS": TOOLS_TRAIN_REPEATS,
                    **({"TRAIN_PROGRAM": program} if program else {})}
        rec = run(f"bench_train {program or 'ppo'}",
                  lambda: bench_train.main([], env_vars, dev), entries)
        _finite_rates(f"bench_train {program}", [rec["value"], *rec["runs"]])
    rec = run("bench_scaling", lambda: bench_scaling.main(TOOLS_SCALING, dev))
    for shape, n in rec["launches_by_shape"].items():
        entry = {(10, 512): "ant_tag,B=512", (10, 256): "ant_tag,B=256"}.get(tuple(shape))
        if entry is None:
            fail(f"bench_scaling: launches at {shape}, which no entry compares")
        add(entry, n)
    _finite_rates("bench_scaling", [r for prog in rec["rates"].values() for r in prog.values()])
    rec = run("bench_substeps", lambda: bench_substeps.main(
        ["ant_tag", str(B), str(TOOLS_SUBSTEPS_STEPS)], {"SUBSTEPS_LIST": f"10,{TOOLS_SUBSTEPS}"},
        dev), {**tag, (TOOLS_SUBSTEPS, B): f"ant_tag,substeps={TOOLS_SUBSTEPS}"})
    _finite_rates("bench_substeps", list(rec.values()))
    rec = run("ablate_bench", lambda: ablate_bench.main(dev, steps=TOOLS_ABLATE_STEPS))
    for variant, entry in (("full", "ant_tag"), ("physics_only", "ant_tag"),
                           ("no_walls", "ant_tag,no_walls"),
                           ("no_contacts", "ant_tag,no_contacts"),
                           ("substeps_1", "ant_tag,substeps=1")):
        if rec["launches"][variant] != 4 * TOOLS_ABLATE_STEPS:
            fail(f"ablate_bench {variant}: {rec['launches'][variant]} launches, not "
                 f"{4 * TOOLS_ABLATE_STEPS}")
        add(entry, rec["launches"][variant])
    _finite_rates("ablate_bench", [*rec["rates"].values(), *rec["kernel_device_ms"].values()])
    rec = run("roofline", lambda: roofline.main({"ROOF_STEPS": str(TOOLS_ROOF_STEPS)}, dev), tag)
    _finite_rates("roofline", [rec["env_steps_per_s"], rec["x_above_roofline"]])
    rec = run("overlap_study", lambda: overlap_study.main(list(TOOLS_OVERLAP), dev), tag)
    _finite_rates("overlap_study", [rec["chain_ms"], rec["mm_ms"], rec["both_ms"]])
    rec = run("autoreset_study", lambda: [autoreset_study.run_mode(
        mode, STUDY_EPISODE, STUDY_STEPS, STUDY_ENVS, device=dev) for mode in ("naive", "cached")],
        {(10, STUDY_ENVS): f"ant_heavenhell,B={STUDY_ENVS}"})
    for r in rec:
        print(json.dumps(r), flush=True)
        if r["resets"] == 0 or r["launches"] != STUDY_STEPS:
            fail(f"autoreset_study {r['mode']}: no reset, or not one launch a step")
    rec = run("substeps_probe", lambda: substeps_probe.main(
        ["ant_tag", str(STUDY_ENVS), str(PROBE_STEPS)], dev, PROBE_CANDIDATES))
    for r, (tag_, *_rest) in zip(rec, TOOL_CORES[4:4 + len(PROBE_CANDIDATES)]):
        if r["launches"] != PROBE_STEPS or r["nan_frac"] != r["nan_frac"]:
            fail(f"substeps_probe {r['substeps']}, {r['stiffness_scale']}: {r['launches']} "
                 f"launches, not {PROBE_STEPS}")
        add(tag_, r["launches"])
    rec = run("ant_speed_probe", lambda: ant_speed_probe.main(episodes=SPEED_EPISODES,
                                                               device=dev),
              {(x6, SPEED_EPISODES): f"{LEARNER},B={SPEED_EPISODES}"})
    _finite_rates("ant_speed_probe", list(rec.values()))
    rec = run("per_study", lambda: per_study.main(
        (PER_BUDGET,), (0,), dev, os.path.join(tmp, "per_study.json")),
        {(sub_p, 64): "inverted_pendulum,B=64", (sub_p, ev): f"inverted_pendulum,B={ev}"})
    _finite_rates("per_study", rec["uniform"][str(PER_BUDGET)] + rec["per"][str(PER_BUDGET)])
    for name, tool, entry in (("gather", render_gather_policy, "ant_gather,action_repeat=6,B=1"),
                              ("maze", render_maze_policy, "ant_maze,action_repeat=6,B=1")):
        page = os.path.join(tmp, f"{name}.html")
        rec = run(f"render {name}", lambda: tool.main(page, device=dev), {(x6, 1): entry})
        with open(page) as f:
            frames = json.loads(re.search(r"const FRAMES\s*=\s*(.*?);\n", f.read(),
                                          re.DOTALL).group(1))
        if len(frames) != rec["frames"] or rec["launches"] != rec["frames"]:
            fail(f"render {name}: {len(frames)} frames, {rec['launches']} launches")
    return launches


def phase_shaping_overhead(dev, card: str) -> None:
    """What each shaped wrapper adds to a control step of the learners'
    stack (ActionRepeat(6) -> Episode(1000) -> Vmap(GRU_ENVS) -> cached
    autoreset, random actions): host ms per step over SHAPING_STEPS steps,
    unshaped and shaped in turns (plain, shaped, shaped, plain), and the
    device kernels launched per step in a traced window of 3."""
    cfg = dataclasses.replace(ppo_rnn.ANT_TAG, num_envs=GRU_ENVS)
    cases = (("ShapedAntTag", "ant_tag", lambda e: train_ant_tag.ShapedAntTag(e, coef=5.0)),
             ("ShapedHeavenHell", "ant_heavenhell",
              lambda e: train_heavenhell_rnn.ShapedHeavenHell(e, coef=5.0)),
             ("ShapedAntGather", "ant_gather",
              lambda e: train_ant_gather_rnn.ShapedAntGather(e, coef=5.0, bomb_coef=0.3)),
             ("ShapedAntMaze", "ant_maze",
              lambda e: train_ant_maze_rnn.ShapedAntMaze(e, coef=5.0)))
    for tag, name, shape in cases:
        stacks = {}
        for kind in ("plain", "shaped"):
            core = _envs[name](device=dev)
            env = ppo.wrap_for_training(shape(core) if kind == "shaped" else core, cfg, "cached")
            stacks[kind] = [env, env.reset(jr.split(jr.PRNGKey(0, dev), cfg.num_envs))]
        g = torch.Generator(device=dev).manual_seed(0)

        def run(kind, n):
            env, state = stacks[kind]
            for _ in range(n):
                state = env.step(state, torch.rand(cfg.num_envs, env.action_size, generator=g,
                                                   device=dev) * 2 - 1)
            stacks[kind][1] = state

        ms = {"plain": [], "shaped": []}
        for kind in ("plain", "shaped", "shaped", "plain"):
            run(kind, 3)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(kind, SHAPING_STEPS)
            torch.cuda.synchronize()
            ms[kind].append((time.perf_counter() - t0) * 1e3 / SHAPING_STEPS)
        kernels = {k: len(_trace(lambda: run(k, 3))) / 3 for k in ("plain", "shaped")}
        print(f"[shaping:{tag}] {name}, {cfg.num_envs} envs, action_repeat {ACTION_REPEAT}, "
              f"cached: host ms a control step unshaped {ms['plain'][0]:.4f} / "
              f"{ms['plain'][1]:.4f}, shaped {ms['shaped'][0]:.4f} / {ms['shaped'][1]:.4f}; "
              f"device kernels a step {kernels['plain']:.1f} -> {kernels['shaped']:.1f} "
              f"(+{kernels['shaped'] - kernels['plain']:.1f}); {card}", flush=True)


def _ops_inputs() -> dict:
    """Phase 20's numpy-seeded inputs: unit quaternions (row 0 the identity,
    row 1 with |xyz| < 1e-10, the first half of the rest with w < 0), a
    partner for each, vectors with every third zero, Euler angles in
    degrees, axes and angles."""
    rng = np.random.default_rng(0)

    def unit(x):
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    q = unit(rng.normal(size=(OPS_N, 4)))
    q[2:OPS_N // 2, 0] = -np.abs(q[2:OPS_N // 2, 0])
    q[0] = (1.0, 0.0, 0.0, 0.0)
    q[1] = (1.0, 1e-12, -1e-12, 1e-12)
    v = rng.normal(size=(OPS_N, 3)) * 2
    v[::3] = 0.0
    arrays = {"q": q, "p": unit(rng.normal(size=(OPS_N, 4))), "v": v,
              "w": rng.normal(size=(OPS_N, 3)), "deg": rng.uniform(-360, 360, (OPS_N, 3)),
              "axis": unit(rng.normal(size=(OPS_N, 3))),
              "angle": rng.uniform(-2 * np.pi, 2 * np.pi, OPS_N)}
    return {k: torch.as_tensor(a.astype(np.float32)) for k, a in arrays.items()}


OPS_CALLS = {
    "quat_mul": lambda t: ops.quat_mul(t["q"], t["p"]),
    "quat_inv": lambda t: ops.quat_inv(t["q"]),
    "rotate": lambda t: ops.rotate(t["v"], t["q"]),
    "inv_rotate": lambda t: ops.inv_rotate(t["w"], t["q"]),
    "ang_to_quat": lambda t: ops.ang_to_quat(t["v"]),
    "euler_to_quat": lambda t: ops.euler_to_quat(t["deg"]),
    "quat_rot_axis": lambda t: ops.quat_rot_axis(t["axis"], t["angle"]),
    "relative_quat": lambda t: ops.relative_quat(t["q"], t["p"]),
    "quat_to_axis_angle": lambda t: ops.quat_to_axis_angle(t["q"]),
    "cross": lambda t: ops.cross(t["v"], t["w"]),
    "norm": lambda t: ops.norm(t["v"]),
    "norm,axis=0,keepdims": lambda t: ops.norm(t["v"], axis=0, keepdims=True),
    "safe_norm": lambda t: ops.safe_norm(t["v"]),
    "safe_norm,axis=0,keepdims": lambda t: ops.safe_norm(t["v"], axis=0, keepdims=True),
    "normalize": lambda t: ops.normalize(t["v"]),
    "normalize,axis=0": lambda t: ops.normalize(t["v"], axis=0),
}


def _tree_items(tree, path=()):
    """(path, array) of each leaf of a nested dict, keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _tree_items(tree[k], path + (k,))
    else:
        yield path, np.asarray(tree)


def check_adam_layout(kind: str, learner, ts) -> None:
    """`ts`'s Adam state through `interop` into the JAX learner's layout and
    back: per-leaf moments must be trees in the parameters' own layout (a
    moment equal to the parameters is their tree, leaf for leaf, bit for
    bit), flat ones one vector; the round trip must give the state back bit
    for bit."""
    adam, out = ts.opt_state, interop.training_state_to_numpy(ts)
    if any(isinstance(out["opt_state"][k], dict) != adam.per_leaf for k in ("mu", "nu")):
        fail(f"{kind}: interop wrote the moments in the other layout")
    if adam.per_leaf:
        moment = dict(_tree_items(interop.tree_to_numpy(ts.params, params_vector(ts.params))))
        want = dict(_tree_items(out["params"]))
        if moment.keys() != want.keys() or not all(np.array_equal(moment[p], want[p])
                                                   for p in want):
            fail(f"{kind}: the per-leaf moments do not take the parameters' layout")
    back = interop.training_state_from_numpy(out, learner).opt_state
    if not (back.count == adam.count and back.per_leaf == adam.per_leaf
            and torch.equal(back.mu, adam.mu) and torch.equal(back.nu, adam.nu)):
        fail(f"{kind}: the Adam state does not cross interop and back bit for bit")
    print(f"[surface:unflat] {kind}: Adam state (count {adam.count}) through interop as "
          f"{'parameter-shaped trees' if adam.per_leaf else 'one flat vector'} and back, bit "
          "for bit", flush=True)


def phase_surface(dev, card: str) -> int:
    """Phase 20: the re-exports, the ops on the card against the CPU, and a
    PPO epoch with `flatten_optimizer=False` against one with True. Returns
    the epochs' whole-step launches."""
    # (a) every exported name, reached from the top package
    subs = [n for n in pobrax_tpu_torch.__all__ if n != "__version__"]
    if tuple(subs) != SURFACE_SUBPACKAGES:
        fail(f"pobrax_tpu_torch exports {subs}, not {SURFACE_SUBPACKAGES}")
    reached = []
    for sub in subs:
        mod = getattr(pobrax_tpu_torch, sub)
        for name in mod.__all__:
            if not hasattr(mod, name):
                fail(f"pobrax_tpu_torch.{sub}.{name} does not resolve")
            reached.append(f"{sub}.{name}")
    for name in ("training.networks", "training.ppo", "training.sac_rnn", "ops.normalize",
                 "ops.quat_to_axis_angle"):
        if name not in reached:
            fail(f"pobrax_tpu_torch.{name} is not exported")
    print(f"[surface] import pobrax_tpu_torch reaches {len(subs)} subpackages and "
          f"{len(reached)} exported names", flush=True)

    # (b) the ops on CUDA tensors against the same calls on the CPU
    cpu_in = _ops_inputs()
    cuda_in = {k: v.to(dev) for k, v in cpu_in.items()}
    out = {}
    for name, call in OPS_CALLS.items():
        got, want = call(cuda_in), call(cpu_in)
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        err = 0.0
        for g, w in zip(got, want):
            g = g.cpu()
            if g.shape != w.shape or not bool(torch.isfinite(g).all()):
                fail(f"ops.{name}: shape {tuple(g.shape)} (CPU {tuple(w.shape)}) or non-finite")
            if not torch.allclose(g, w, rtol=OPS_RTOL, atol=OPS_ATOL):
                fail(f"ops.{name} on the card disagrees with the CPU: max |err| "
                     f"{float((g - w).abs().max()):.3e}")
            err = max(err, float((g - w).abs().max()))
        out[name] = [g.cpu() for g in got]
        print(f"[surface:ops] {name}: CUDA against CPU max |err| {err:.3e} (rtol {OPS_RTOL:g}, "
              f"atol {OPS_ATOL:g})", flush=True)
    axis, angle = out["quat_to_axis_angle"]
    x_axis = torch.tensor([1.0, 0.0, 0.0])
    if not (torch.equal(axis[0], x_axis) and torch.equal(axis[1], x_axis)
            and float(angle[0]) == 0.0):
        fail("quat_to_axis_angle: the identity / |xyz| < 1e-10 branch is not (1, 0, 0)")
    if not bool(((angle > -np.pi) & (angle <= np.float32(np.pi))).all()) \
            or not bool((angle[2:OPS_N // 2] <= 0).all()):
        fail("quat_to_axis_angle: an angle outside (-pi, pi] or a w < 0 angle not wrapped")
    zero = out["normalize"][0][::3]
    if not (bool((zero == 0).all()) and bool((out["safe_norm"][0][::3] == 0).all())):
        fail("normalize / safe_norm: a zero vector did not give exactly 0")
    print("[surface:ops] branches: identity and |xyz| < 1e-10 -> axis (1, 0, 0); w < 0 "
          "angles wrapped into (-pi, pi]; zero vectors -> 0", flush=True)

    # (c) PPO's epoch with the per-leaf Adam state against the flat one
    cfgs = {"flat": ppo.ANT_TAG, "per_leaf": dataclasses.replace(ppo.ANT_TAG,
                                                                 flatten_optimizer=False)}
    key, k_init, k_reset = jr.split(jr.PRNGKey(0, dev), 3).unbind(-2)
    params, launched = {}, 0
    for kind, cfg in cfgs.items():
        env = ppo.wrap_for_training(AntTagEnv(device=dev), cfg, "cached")
        learner = ppo.PPOLearner(env, cfg)
        ts = learner.init(k_init)
        if ts.opt_state.per_leaf == cfg.flatten_optimizer:
            fail(f"{kind}: the optimizer state's layout does not follow flatten_optimizer")
        initial = params_vector(ts.params)
        state = env.reset(jr.split(k_reset, cfg.num_envs))
        torch.cuda.synchronize()
        before, t0 = whole_step.launches, time.perf_counter()
        ts, _, m = learner.epoch(ts, state, key)
        torch.cuda.synchronize()
        n = whole_step.launches - before
        launched += n
        params[kind] = params_vector(ts.params)
        moved = float((params[kind] - initial).abs().max())
        print(f"[surface:unflat] {kind} ({'flatten_optimizer=' + str(cfg.flatten_optimizer)}): "
              f"one epoch of {cfg.num_envs} envs {(time.perf_counter() - t0) * 1e3:.1f} ms, "
              f"whole-step launches {n}, total_loss {float(m['total_loss']):.6f}, largest "
              f"parameter change {moved:.6e}; {card}", flush=True)
        if n != cfg.unroll_length:
            fail(f"{kind}: the epoch launched the kernel {n} times, not {cfg.unroll_length}")
        if not all(np.isfinite(float(m[k])) for k in ("total_loss", "policy_loss",
                                                      "value_loss", "entropy")):
            fail(f"{kind}: a non-finite loss")
        if not np.isfinite(moved) or moved == 0.0:
            fail(f"{kind}: the parameters did not change")
        check_adam_layout(kind, learner, ts)
    diff = float((params["per_leaf"] - params["flat"]).abs().max())
    print(f"[surface:unflat] per-leaf against flat: max |param diff| {diff:.3e} over "
          f"{params['flat'].numel()} parameters (need <= {UPDATE_TOL:g})", flush=True)
    if not diff <= UPDATE_TOL:
        fail("flatten_optimizer=False parts from the flat optimizer's epoch")
    return launched


def phase_examples_kernel_vs_plain(dev) -> dict:
    """The kernel against the plain step on each (System, batch) the examples
    add: -> {entry: (sys, qp, act, max |err|)}."""
    out = {}
    for key, name, batch, substeps in EXAMPLE_PO_SYSTEMS:
        out[key] = phase_po_kernel_vs_plain(dev, name, batch, ACTION_REPEAT, substeps, key)
    for key, name, batch in EXAMPLE_STOCK_SYSTEMS:
        out[key] = phase_stock_kernel_vs_plain(dev, name, batch, key)
    return out


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
        check_parts()

    warps = phase_build(dev)
    for batch in HALFCHEETAH_BATCHES:
        warps[f"halfcheetah,B={batch}"] = warps["halfcheetah"]
    lap("build")
    parts_tmp = tempfile.TemporaryDirectory()
    start_parts(parts_tmp.name)
    print(f"[parts] {len(BACKGROUND_PARTS)} processes started: the examples' parts "
          f"{['+'.join(w) for w in EXAMPLE_PARTS]} and the benches and tools", flush=True)
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
    # the learners' System at each batch it is stepped at (PPO's 4096, the
    # evaluations' and a GRU-SAC rank's 256, ...): an entry each
    for batch, case in phase_learner_kernel_vs_plain(dev).items():
        compared[LEARNER_AT[batch]] = case
        warps[LEARNER_AT[batch]] = warps[LEARNER]
    lap("kernel-vs-plain:ant at SAC's batch, the learners' System")
    examples_cases = phase_examples_kernel_vs_plain(dev)
    compared.update(examples_cases)
    warps.update({k: whole_step.resident_warps(c[0]) for k, c in examples_cases.items()})
    lap("kernel-vs-plain:the examples' Systems")
    tools_cases = phase_tools_kernel_vs_plain(dev)
    compared.update(tools_cases)
    warps.update({k: whole_step.resident_warps(c[0]) for k, c in tools_cases.items()})
    lap("kernel-vs-plain:the benches' and tools' Systems")
    for path in FIXTURES:
        phase_fixture(dev, path)
        lap(f"fixture:{os.path.basename(path)}")
    part_launches = join_parts()
    parts_tmp.cleanup()
    lap(f"waiting for the examples and the tools ({len(BACKGROUND_PARTS)} processes)")
    launches = {"ant_tag": phase_main(dev, "ant_tag", "cached", card)}
    phase_main(dev, "ant_tag", "naive", card, steps=NAIVE_STEPS)
    for name in MASKED_MAIN:
        launches[name] = phase_main(dev, name, "cached", card, masked=True)
    for name in MASKED_OTHER:
        launches[name] = phase_main(dev, name, "cached", card, steps=OTHER_STEPS, masked=True)
    for name in PO_MAIN:
        launches[name] = phase_main(dev, name, "cached", card)
    launches["ant_gather"] += phase_main(dev, "ant_gather", "naive", card, steps=NAIVE_STEPS)
    launches[CONTACT] = phase_main(dev, "ant_tag", "cached", card, steps=OTHER_STEPS,
                                   info="contact")
    lap("main paths of the ant, masked and PO envs")
    for name in PLANAR:
        launches[name] = phase_main(dev, name, "cached", card)
        lap(f"main:{name}")
    launches["acrobot"] = phase_main(dev, "acrobot", "cached", card, steps=OTHER_STEPS)
    lap("main:acrobot")
    ppo_at = LEARNER_AT[ppo.ANT_TAG.num_envs]
    launches[LEARNER] = phase_train(dev, card, "gru")[0]
    launches[ppo_at] = phase_train(dev, card, "ppo")[0]
    launches[GRU_SAC_RANK] = phase_checkpoint(dev, card)  # 256 episodes
    launches[GRU_SAC_RANK] += phase_port_checkpoint(dev, card)
    lap("train:gru, train:ppo, checkpoint, port checkpoint")
    launches[ppo_at] += phase_surface(dev, card)
    lap("surface: exports, ops, flatten_optimizer=False (phase 20)")
    trained, inference_fn, params = phase_train(dev, card, "ppo_halfcheetah")
    launches[f"halfcheetah,B={ppo.HALFCHEETAH.num_envs}"] = trained
    lap("train:ppo_halfcheetah")
    launches["halfcheetah,B=1"] = phase_html(dev, card, inference_fn, params)
    lap("html")
    print("[gym] left out: gymnasium is not installed on the card's machine, so the gym "
          "adapters (create_gym_env) are held by the CPU tests, tests/test_torch_gym_adapter.py",
          flush=True)
    launches["ant"] = phase_off_policy(dev, card, "sac", SAC_EPOCHS)
    sac_at = LEARNER_AT[sac_rnn.ANT_TAG.num_envs]
    launches[sac_at] = (phase_off_policy(dev, card, "gru_sac", GRU_SAC_EPOCHS)
                        + phase_per(dev, card, PER_EPOCHS))
    launches[GRU_SAC_RANK] += phase_sac_checkpoint(dev, card)
    lap("sac, gru_sac, per, sac checkpoint")
    with tempfile.TemporaryDirectory() as tmp:
        mesh_ppo, mesh_sac = phase_mesh(dev, card, tmp)
    launches[LEARNER] += mesh_ppo
    launches[GRU_SAC_RANK] += mesh_sac
    lap("mesh: first step, PPO, update, GRU-SAC (2 ranks, gloo)")
    # the single process again after the ranks: its epochs beside theirs
    launches[ppo_at] += phase_train(dev, card, "ppo")[0]
    lap("train:ppo, after the ranks")
    phase_dryrun(dev, card)
    lap("mesh: graft entry, dryrun_multichip (2 ranks, gloo)")
    phase_nccl(dev, card)
    lap("mesh: one-rank nccl")
    for key, n in part_launches.items():
        launches[key] = launches.get(key, 0) + n

    entries = []
    cases = [(name, case, True) for name, case in compared.items()]
    for name, (sys_, qp, act, max_err), listed in cases + [(n, c, False)
                                                           for n, c in timed_only.items()]:
        kernel_ms = cuda_ms(lambda: whole_step.launch(sys_, qp, act), reps=50)
        kernel_dev_ms = device_ms(lambda: whole_step.launch(sys_, qp, act))
        # the plain step is host-bound (tens to hundreds of ms): one call,
        # the comparison before having run it at this System and batch
        plain_ms = cuda_ms(lambda: sys_.step_generic(qp, act), reps=1, warm_s=0.0)
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
            "launches": launches.get(name, 0), "max_abs_err": max_err,
            "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
            "library_ms": None, "warps_per_sm": warps[name], "device_ms": kernel_dev_ms})
    lap("times")
    print(json.dumps({"kernels": entries}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    try:
        main()
    finally:
        stop_parts()
