"""Where one env step's time goes on the GPU: `python -m pobrax_tpu_torch.profile_step`.

Runs a main path — `create(env, batch_size=4096, episode_length=1000,
randomized_autoreset=True, autoreset_mode=...)` on CUDA with on-device random
actions, AntTag unless `--env` names another env, under
`MaskedObservationWrapper(hidden=("VELOCITY",))` with `--masked` (`bench.py`'s
masked_<name>) — warms it up, times `--steps` steps without the profiler, then
traces `TRACE_STEPS` more with `torch.profiler` (a naive step launches ~20k
kernels, so the trace stays short) and prints, per env step: host wall time,
summed device kernel time, the device's idle share (1 - kernel time / wall
time), the number of kernel launches, and the kernels that take the most
device time. Also prints the card's name and power limit. Needs a CUDA
device.

    python -m pobrax_tpu_torch.profile_step [--env NAME] [--masked] [--mode cached|naive|both]
                                            [--steps N] [--batch B]
    python -m pobrax_tpu_torch.profile_step --learner gru|ppo|ppo_halfcheetah|sac|gru_sac
"""

from __future__ import annotations

import argparse
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

from pobrax_tpu_torch import random as jr
from pobrax_tpu_torch.envs import MaskedObservationWrapper, create
from pobrax_tpu_torch.envs.ant_tag import AntTagEnv
from pobrax_tpu_torch.utils.profiling import card_line

TRACE_STEPS = 5


def profile_mode(env_name: str, masked: bool, mode: str, steps: int, batch: int,
                 warmup: int = 10) -> None:
    dev = torch.device("cuda")
    env = create(env_name, batch_size=batch, episode_length=1000, randomized_autoreset=True,
                 autoreset_mode=mode, device=dev)
    if masked:
        env = MaskedObservationWrapper(env, env_name=env_name, hidden=("VELOCITY",))
    tag = f"{'masked_' if masked else ''}{env_name}:{mode}"
    s = env.reset(jr.PRNGKey(0, dev))
    g = torch.Generator(device=dev).manual_seed(0)

    def run(n):
        nonlocal s
        for _ in range(n):
            s = env.step(s, torch.rand(batch, env.action_size, generator=g, device=dev) * 2 - 1)

    run(warmup)
    torch.cuda.synchronize()
    t0 = time.perf_counter()  # wall time without the profiler's own overhead
    run(steps)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    kernels = _trace(lambda: run(TRACE_STEPS))
    report(tag, f"B={batch}: wall {wall_ms:.4f} ms/step over {steps} steps;", wall_ms,
           kernels, TRACE_STEPS, "step")


def _trace(fn):
    """The device kernel events of fn() under torch.profiler."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def report(tag: str, head: str, wall_ms: float, kernels, per: int, unit: str,
           top: int = 8) -> None:
    """Device kernel ms, idle share and launches per `unit` (over `per`
    traced units), then the `top` kernels by device time."""
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / per
    print(f"[profile:{tag}] {head} device kernels {busy_ms:.4f} ms/{unit} over {per} traced, "
          f"idle share {(1 - busy_ms / wall_ms) if kernels else float('nan'):.4f}, "
          f"{len(kernels) / per:.1f} kernel launches/{unit}", flush=True)
    if not kernels:
        print(f"[profile:{tag}] no device events traced: device time not measured", flush=True)
        return
    by_name = {}
    for e in kernels:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), n + 1)
    for name, (t_us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"[profile:{tag}]   {t_us / 1e3 / per:9.4f} ms/{unit}  {n / per:8.1f}/{unit}  "
              f"{name[:90]}", flush=True)


def profile_learner(kind: str) -> None:
    """One training epoch of GRU-PPO ("gru") or PPO ("ppo") on AntTag, cached,
    or of PPO on halfcheetah at examples/train_ppo.py's recipe, naive
    ("ppo_halfcheetah")."""
    from pobrax_tpu_torch.envs.planar import Halfcheetah
    from pobrax_tpu_torch.training import ppo, ppo_rnn

    dev = torch.device("cuda")
    rnn = kind == "gru"
    if kind == "ppo_halfcheetah":
        cfg = ppo.HALFCHEETAH
        env = ppo.wrap_for_training(Halfcheetah(device=dev), cfg, "naive")
    else:
        cfg = (ppo_rnn if rnn else ppo).ANT_TAG
        env = ppo.wrap_for_training(AntTagEnv(device=dev), cfg, "cached")
    learner = (ppo_rnn.RNNPPOLearner if rnn else ppo.PPOLearner)(env, cfg)
    key, k_init, k_reset = jr.split(jr.PRNGKey(0, dev), 3).unbind(-2)
    ts = learner.init(k_init)
    carry = [env.reset(jr.split(k_reset, cfg.num_envs))] + ([learner.h0(cfg.num_envs)] if rnn
                                                            else [])

    def epoch():
        nonlocal ts, carry, key
        key, k = jr.split(key, 2).unbind(-2)
        ts, *carry, _ = learner.epoch(ts, *carry, k)

    epoch()  # warm-up: allocations, the kernel's tables
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    epoch()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    rollout_ms, update_ms = learner.clock.ms()
    tag = f"learner:{kind}"
    k_roll = jr.split(key, 3)[1]
    report(tag, f"B={cfg.num_envs}, rollout of {cfg.unroll_length} control steps "
                f"(untraced {rollout_ms:.4f} ms):", rollout_ms,
           _trace(lambda: learner._rollout_and_targets(ts, carry[0], k_roll, *carry[1:])),
           1, "rollout", top=0)
    report(tag, f"B={cfg.num_envs}: epoch wall {wall_ms:.4f} ms (rollout {rollout_ms:.4f}, "
                f"update {update_ms:.4f});", wall_ms, _trace(epoch), 1, "epoch")


def profile_off_policy(kind: str) -> None:
    """One epoch of SAC ("sac") on `ant` or GRU-SAC ("gru_sac") on AntTag."""
    import dataclasses

    from pobrax_tpu_torch.envs.ant import Ant
    from pobrax_tpu_torch.training import sac, sac_rnn

    dev = torch.device("cuda")
    if kind == "sac":
        cfg = dataclasses.replace(sac.ANT, min_replay=sac.ANT.steps_per_epoch)
        env = sac.wrap_for_training(Ant(device=dev), cfg, "naive")
        learner, carry = sac.SACLearner(env, cfg), []
        grads = cfg.steps_per_epoch * cfg.grad_steps_per_env_step
    else:
        cfg = dataclasses.replace(sac_rnn.ANT_TAG, min_replay=sac_rnn.ANT_TAG.seqs_per_epoch)
        env = sac_rnn.wrap_for_training(AntTagEnv(device=dev, visible_radius=20.0), cfg,
                                        "cached")
        learner = sac_rnn.RSACLearner(env, cfg)
        carry = [learner.h0(cfg.num_envs)]
        grads = cfg.seqs_per_epoch * cfg.grad_steps_per_seq
    key, k_init, k_reset = jr.split(jr.PRNGKey(0, dev), 3).unbind(-2)
    ts = learner.init(k_init)
    carry = [env.reset(jr.split(k_reset, cfg.num_envs))] + carry

    def epoch():
        nonlocal ts, carry, key
        key, k = jr.split(key, 2).unbind(-2)
        ts, *carry, _ = learner.epoch(ts, *carry, k)

    epoch()  # warm-up: fills min_replay, allocations, the kernel's tables
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    epoch()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    collect_ms, update_ms = learner.clock.ms()
    tag = f"learner:{kind}"
    report(tag, f"B={cfg.num_envs}, one grad step alone:", update_ms / grads,
           _trace(lambda: learner.grad_step(ts, key)), 1, "grad step", top=4)
    report(tag, f"B={cfg.num_envs}: epoch wall {wall_ms:.4f} ms (collect {collect_ms:.4f}, "
                f"update {update_ms:.4f}: {grads} grad steps, {update_ms / grads:.4f} ms "
                f"each);", wall_ms, _trace(epoch), 1, "epoch")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--env", default="ant_tag")
    ap.add_argument("--masked", action="store_true")
    ap.add_argument("--mode", choices=("cached", "naive", "both"), default="both")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--learner", choices=("gru", "ppo", "ppo_halfcheetah", "sac", "gru_sac"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_step: no CUDA device available", file=sys.stderr)
        sys.exit(1)
    print(f"[profile] {card_line()}", flush=True)
    if args.learner in ("sac", "gru_sac"):
        profile_off_policy(args.learner)
        return
    if args.learner:
        profile_learner(args.learner)
        return
    for mode in (("cached", "naive") if args.mode == "both" else (args.mode,)):
        profile_mode(args.env, args.masked, mode, args.steps, args.batch)


if __name__ == "__main__":
    main()
