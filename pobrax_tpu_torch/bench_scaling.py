"""Scaling efficiency of the port over ranks of a 'data' mesh; the port of
`bench_scaling.py`.

The ranks of a `parallel.mesh` 'data' mesh (started by `parallel.mesh.spawn`)
take the place of the JAX tool's devices: the 'data' axis grows 1 -> 2 ->
... ranks, each holding its block of the env batch. Four programs, at the
JAX tool's shapes and learner configs (`ppo_config`, `rnn_config`,
`sac_rnn_config`):
  * step    — `bench.rollout` of the env (naive randomized autoreset, as the
              JAX tool's `create` default), each rank its block of the batch
              and its rows of the global action draw;
  * ppo     — one PPO epoch (rollout + GAE + minibatch SGD), the gradient
              all-reduced at every minibatch (`Optimizer.step`);
  * rnn     — one GRU-PPO epoch;
  * sac_rnn — one GRU-SAC epoch, replay rank-local, the gradients averaged.
Each size runs one warm-up, then the best of BENCH_REPEATS (3) timed calls;
every timed window opens and closes on a barrier of the ranks, so the rate is
the global batch's env-steps over the slowest rank's time. One rank runs in
this process with no group; more are spawned.

Mode: where every rank owns a card, WEAK scaling (BENCH_PER_DEVICE_ENVS per
rank, default 256; ideal = linear; efficiency = rate_N / (N rate_1)). Where
ranks share a card (one H100: two ranks over gloo) or run on the CPU,
STRONG scaling (BENCH_TOTAL_ENVS in all, default 512; ideal = flat;
efficiency = rate_N / rate_1), as the JAX tool does for virtual CPU devices.
BENCH_SCALING_MODE overrides it. Backend: NCCL where every rank owns a card,
gloo otherwise.

Prints one JSON line per (program, ranks) plus a summary line with the
efficiency at the largest mesh, each with the device and the card's name and
power limit. Env: BENCH_ENV, BENCH_STEPS (100), BENCH_PROGRAMS
("step,ppo,rnn"), BENCH_SIZES (default 1, 2, 4, ... up to the cards, or
1,2 on one card or the CPU), BENCH_SCALING_MODE, BENCH_TOTAL_ENVS,
BENCH_PER_DEVICE_ENVS, BENCH_REPEATS. On the card; with no card and no
device named it raises (`main(device="cpu")` is for the tests only).

Usage: python -m pobrax_tpu_torch.bench_scaling
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional, Sequence

import torch

from pobrax_tpu_torch import bench
from pobrax_tpu_torch import random as jr
from pobrax_tpu_torch.device import resolve
from pobrax_tpu_torch.envs import create
from pobrax_tpu_torch.parallel import mesh as pmesh
from pobrax_tpu_torch.physics import whole_step
from pobrax_tpu_torch.training import ppo, ppo_rnn, sac_rnn
from pobrax_tpu_torch.utils.profiling import record_device

PROGRAMS = ("step", "ppo", "rnn", "sac_rnn")


def ppo_config(num_envs: int) -> ppo.PPOConfig:
    return ppo.PPOConfig(num_envs=num_envs, episode_length=1000, unroll_length=16,
                         num_minibatches=8, num_update_epochs=4)


def rnn_config(num_envs: int) -> ppo_rnn.RNNPPOConfig:
    return ppo_rnn.RNNPPOConfig(num_envs=num_envs, episode_length=1000, unroll_length=32,
                                num_minibatches=8, num_update_epochs=4)


def sac_rnn_config(num_envs: int) -> sac_rnn.RSACConfig:
    return sac_rnn.RSACConfig(num_envs=num_envs, episode_length=1000, seq_len=32, burn_in=8,
                              replay_capacity=64, batch_size=num_envs, seqs_per_epoch=4,
                              grad_steps_per_seq=1, min_replay=1, encoder_sizes=(256,),
                              hidden_size=128, head_sizes=(256,))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed(run, mesh: Optional[pmesh.Mesh], dev, repeats: int, steps: int) -> float:
    """One warm-up call of run(i), then the best env-steps/s of `repeats`;
    each window between barriers of the ranks."""
    run(-1)
    _sync(dev)
    best = 0.0
    for i in range(repeats):
        pmesh.barrier(mesh)
        t0 = time.perf_counter()
        run(i)
        _sync(dev)
        pmesh.barrier(mesh)
        best = max(best, steps / (time.perf_counter() - t0))
    return best


def _env(env_name: str, local: int, dev):
    return create(env_name, episode_length=1000, batch_size=local, auto_reset=True,
                  randomized_autoreset=True, device=dev)


def bench_step(env_name: str, mesh, dev, per_rank: int, steps: int, repeats: int) -> float:
    """The env-stepping rollout; each rank its block of the global batch."""
    n = mesh.data if mesh is not None else 1
    batch = per_rank * n
    env = _env(env_name, per_rank, dev)
    key = jr.PRNGKey(0, dev)
    state = ppo.reset_block(env, key, batch, mesh)
    carry = [state, key]

    def run(_):
        carry[:] = bench.rollout(env, *carry, steps, pmesh.draw_block(mesh))

    return _timed(run, mesh, dev, repeats, batch * steps)


def _bench_epochs(learner, carry: list, mesh, dev, steps_per_epoch: int,
                  repeats: int) -> float:
    key = jr.PRNGKey(0, dev)

    def run(i):
        k = key if i < 0 else jr.fold_in(key, i)
        ts, *rest, metrics = learner.epoch(*carry, k)
        carry[:] = [ts, *rest]
        float(next(iter(metrics.values())))

    return _timed(run, mesh, dev, repeats, steps_per_epoch)


def bench_ppo(env_name: str, mesh, dev, per_rank: int, repeats: int) -> float:
    n = mesh.data if mesh is not None else 1
    cfg = ppo_config(per_rank * n)
    env = _env(env_name, per_rank, dev)
    learner = ppo.PPOLearner(env, cfg, mesh)
    key = jr.PRNGKey(0, dev)
    carry = [learner.init(key), ppo.reset_block(env, key, cfg.num_envs, mesh)]
    return _bench_epochs(learner, carry, mesh, dev, cfg.unroll_length * cfg.num_envs, repeats)


def bench_rnn(env_name: str, mesh, dev, per_rank: int, repeats: int) -> float:
    n = mesh.data if mesh is not None else 1
    cfg = rnn_config(per_rank * n)
    env = _env(env_name, per_rank, dev)
    learner = ppo_rnn.RNNPPOLearner(env, cfg, mesh)
    key = jr.PRNGKey(0, dev)
    carry = [learner.init(key), ppo.reset_block(env, key, cfg.num_envs, mesh),
             learner.h0(per_rank)]
    return _bench_epochs(learner, carry, mesh, dev, cfg.unroll_length * cfg.num_envs, repeats)


def bench_sac_rnn(env_name: str, mesh, dev, per_rank: int, repeats: int) -> float:
    n = mesh.data if mesh is not None else 1
    cfg = sac_rnn_config(per_rank * n)
    env = _env(env_name, per_rank, dev)
    learner = sac_rnn.RSACLearner(env, cfg, mesh)
    key = jr.PRNGKey(0, dev)
    carry = [learner.init(key), ppo.reset_block(env, key, cfg.num_envs, mesh),
             learner.h0(per_rank)]
    return _bench_epochs(learner, carry, mesh, dev,
                         cfg.seqs_per_epoch * cfg.seq_len * cfg.num_envs, repeats)


def run_programs(mesh, programs: Sequence[str], env_name: str, per_rank: int, steps: int,
                 repeats: int, dev=None) -> tuple:
    """Every program at one mesh size, on this rank -> ({program:
    env-steps/s}, this rank's whole-step launches per (substeps, batch)).
    Every rank returns the same window's rate: the windows close on a
    barrier."""
    dev = mesh.device if mesh is not None else resolve(dev)
    before = dict(whole_step.launches_by_shape)
    out = {}
    for prog in programs:
        if prog == "step":
            out[prog] = bench_step(env_name, mesh, dev, per_rank, steps, repeats)
        else:
            fn = {"ppo": bench_ppo, "rnn": bench_rnn, "sac_rnn": bench_sac_rnn}[prog]
            out[prog] = fn(env_name, mesh, dev, per_rank, repeats)
    launched = {k: n - before.get(k, 0) for k, n in whole_step.launches_by_shape.items()
                if n != before.get(k, 0)}
    return out, launched


def main(environ: Optional[dict] = None, device=None) -> dict:
    env_vars = os.environ if environ is None else environ
    dev = resolve(device)
    env_name = env_vars.get("BENCH_ENV", "ant_tag")
    steps = int(env_vars.get("BENCH_STEPS", "100"))
    repeats = int(env_vars.get("BENCH_REPEATS", "3"))
    programs = env_vars.get("BENCH_PROGRAMS", "step,ppo,rnn").split(",")
    for prog in programs:
        if prog not in PROGRAMS:
            raise ValueError(f"unknown program {prog!r} (available: {PROGRAMS})")
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    if env_vars.get("BENCH_SIZES"):
        sizes = [int(s) for s in env_vars["BENCH_SIZES"].split(",")]
    else:
        sizes = [s for s in (1, 2, 4, 8, 16, 32) if s <= max(cards, 2)]
    if sizes[0] != 1:
        sizes = [1] + sizes  # efficiency needs the one-rank anchor
    own_cards = dev.type == "cuda" and cards >= sizes[-1]
    mode = env_vars.get("BENCH_SCALING_MODE", "weak" if own_cards else "strong")
    backend = "nccl" if own_cards else "gloo"
    total = int(env_vars.get("BENCH_TOTAL_ENVS", "512"))
    per_dev_weak = int(env_vars.get("BENCH_PER_DEVICE_ENVS", "256"))
    where = record_device(dev)
    platform = dev.type if own_cards or dev.type == "cpu" else f"{dev.type}, ranks share a card"

    results: Dict[str, Dict[int, float]] = {p: {} for p in programs}
    launches: Dict[tuple, int] = {}
    for n in sizes:
        per_rank = per_dev_weak if mode == "weak" else total // n
        if n == 1:
            ranks = [run_programs(None, programs, env_name, per_rank, steps, repeats, dev)]
        else:
            ranks = pmesh.spawn(run_programs, n, backend, dev.type, programs, env_name,
                                per_rank, steps, repeats, timeout=3000.0)
        rates = ranks[0][0]
        for _, launched in ranks:
            for k, v in launched.items():
                launches[k] = launches.get(k, 0) + v
        for prog in programs:
            rate = rates[prog]
            results[prog][n] = rate
            ideal = n * results[prog][1] if mode == "weak" else results[prog][1]
            print(json.dumps({
                "program": prog, "devices": n, "platform": platform, "mode": mode,
                "env": env_name, "envs_total": per_rank * n, "backend": backend if n > 1 else None,
                "env_steps_per_s": round(rate, 1), "efficiency": round(rate / ideal, 4),
                **where}), flush=True)

    n_max = sizes[-1]
    scale = n_max if mode == "weak" else 1
    summary = {
        "metric": f"{mode}-scaling efficiency @ {n_max} devices ({platform})",
        "value": round(results[programs[0]][n_max] / (scale * results[programs[0]][1]), 4),
        "unit": "fraction", **where,
    }
    for prog in programs[1:]:
        summary[f"{prog}_efficiency"] = round(
            results[prog][n_max] / (scale * results[prog][1]), 4)
    print(json.dumps(summary), flush=True)
    return {"rates": results, "summary": summary, "mode": mode, "launches_by_shape": launches}


if __name__ == "__main__":
    main()
