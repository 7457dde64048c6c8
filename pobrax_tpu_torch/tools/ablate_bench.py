"""Phase attribution of the AntTag step by ablation; the port of
`tools/ablate_bench.py`.

Measures AntTag at 4096 envs under the JAX tool's ablations:
  full        — the env under Episode(1000) -> Vmap -> naive randomized
                autoreset (the JAX tool's stack), random actions;
  physics_only — `System.step` alone on a batch of the default pose;
  no_walls    — the arena's wall pairs dropped from `collide_include`;
  no_contacts — `collide_include=()`;
  substeps_1  — the full env at one substep;
each variant's `System` rebuilt from `dataclasses.replace(config, ...)`, and
the JAX tool's shares (1 - t_full_without_phase / t_full, and the 10-vs-1
substeps time ratio) from the wall rates.

On the card the naive step is host-bound (~22k launches a step, mostly the
reset's threefry), so those wall shares attribute host work. Beside them
each variant prints its whole-step kernel's device time at 4096 envs
(`utils.profiling.device_ms`, launches queued back to back behind a sleep
kernel) and the same shares from those: that is what attributes the
physics phases on this card.

Usage: python -m pobrax_tpu_torch.tools.ablate_bench
Prints one JSON line per variant (with its rollouts' kernel launches),
then the shares; each line with the device
and the card's name and power limit. On the card; with no card and no
device named it raises.
"""

from __future__ import annotations

import dataclasses
import json
import time

import torch

from pobrax_tpu_torch import random as jr
from pobrax_tpu_torch.device import resolve
from pobrax_tpu_torch.envs import wrappers
from pobrax_tpu_torch.envs.ant_tag import AntTagEnv
from pobrax_tpu_torch.physics import whole_step
from pobrax_tpu_torch.physics.system import System
from pobrax_tpu_torch.utils.profiling import device_ms, record_device

BATCH = 4096
STEPS = 200
VARIANTS = ("full", "physics_only", "no_walls", "no_contacts", "substeps_1")


def _split2(key: torch.Tensor):
    return jr.split(key, 2).unbind(-2)


def _actions(key: torch.Tensor, batch: int, size: int):
    key, k = _split2(key)
    return key, jr.uniform(k, (batch, size), -1.0, 1.0)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _time_rollouts(rollout, carry, batch: int, steps: int, dev, repeats: int = 3):
    """One warm-up rollout, then the best env-steps/s of `repeats` -> (rate,
    final carry)."""
    carry = rollout(carry)
    _sync(dev)
    best = 0.0
    for _ in range(repeats):
        t0 = time.perf_counter()
        carry = rollout(carry)
        _sync(dev)
        best = max(best, batch * steps / (time.perf_counter() - t0))
    return best, carry


def rebuild(env: AntTagEnv, **cfg_overrides) -> AntTagEnv:
    """`env` with its System rebuilt from its config with `cfg_overrides`
    (the JAX tool's `_rebuild`)."""
    env.sys = System(dataclasses.replace(env.sys.config, **cfg_overrides), env.device,
                     env.sys.info_mode)
    return env


def variant_envs(device=None) -> dict:
    """The ablations' core envs: {"full", "no_walls", "no_contacts",
    "substeps_1"} (physics_only steps the full env's System)."""
    dev = resolve(device)
    full = AntTagEnv(device=dev)
    no_walls = tuple(p for p in full.sys.config.collide_include if "Arena" not in p)
    return {"full": full,
            "no_walls": rebuild(AntTagEnv(device=dev), collide_include=no_walls),
            "no_contacts": rebuild(AntTagEnv(device=dev), collide_include=()),
            "substeps_1": rebuild(AntTagEnv(device=dev), substeps=1)}


def bench_env(env, batch: int = BATCH, steps: int = STEPS, dev=None):
    """The JAX tool's `bench_env` -> (env-steps/s, last qp, last actions)."""
    wrapped = wrappers.EpisodeWrapper(env, 1000, 1)
    wrapped = wrappers.VmapWrapper(wrapped, batch_size=batch)
    wrapped = wrappers.RandomizedAutoResetWrapperNaive(wrapped)
    key = jr.PRNGKey(0, dev)
    state = wrapped.reset(jr.split(key, batch))

    def rollout(carry):
        state, key, _ = carry
        for _ in range(steps):
            key, a = _actions(key, batch, env.action_size)
            state = wrapped.step(state, a)
        return state, key, a

    rate, (state, _, act) = _time_rollouts(rollout, (state, key, None), batch, steps, dev)
    return rate, state.qp, act


def bench_physics_only(sys_, batch: int = BATCH, steps: int = STEPS, dev=None):
    """The JAX tool's `bench_physics_only`: `sys.step` from the default pose
    -> (env-steps/s, last qp, last actions)."""
    qp1 = sys_.default_qp()
    qps = qp1.replace(**{f: getattr(qp1, f).expand(batch, -1, -1).contiguous()
                         for f in ("pos", "rot", "vel", "ang")})

    def rollout(carry):
        qps, key, _ = carry
        for _ in range(steps):
            key, a = _actions(key, batch, sys_.action_size)
            qps, _ = sys_.step(qps, a)
        return qps, key, a

    rate, (qps, _, act) = _time_rollouts(rollout, (qps, jr.PRNGKey(0, dev), None), batch, steps,
                                         dev)
    return rate, qps, act


def shares(rates: dict) -> dict:
    """The JAX tool's shares from per-variant rates (env-steps/s, or the
    inverse of a time)."""
    t_full = 1.0 / rates["full"]
    return {"wall_contact_share": 1 - (1.0 / rates["no_walls"]) / t_full,
            "all_contact_share": 1 - (1.0 / rates["no_contacts"]) / t_full,
            "task_logic_share": 1 - (1.0 / rates["physics_only"]) / t_full,
            "substeps10_vs_1_time_ratio": rates["substeps_1"] / rates["full"]}


def main(device=None, batch: int = BATCH, steps: int = STEPS) -> dict:
    dev = resolve(device)
    where = record_device(dev)
    envs = variant_envs(dev)
    results, inputs, launches = {}, {}, {}
    for name in VARIANTS:
        n0 = whole_step.launches
        if name == "physics_only":
            results[name], *inputs[name] = bench_physics_only(envs["full"].sys, batch, steps, dev)
        else:
            results[name], *inputs[name] = bench_env(envs[name], batch, steps, dev)
        launches[name] = whole_step.launches - n0
    kernel = {}
    for name in VARIANTS:
        sys_ = (envs["full"] if name == "physics_only" else envs[name]).sys
        qp, act = inputs[name]
        if dev.type == "cuda":
            kernel[name] = device_ms(lambda: whole_step.launch(sys_, qp, act))
        print(json.dumps({"variant": name, "env_steps_per_s": round(results[name], 1),
                          "kernel_device_ms": kernel.get(name), "batch": batch,
                          "launches": launches[name], **where}),
              flush=True)
    out = {"wall": {k: round(v, 3) for k, v in shares(results).items()}}
    if kernel:
        # the physics_only kernel is the full System's: its share is 0 by construction
        out["kernel"] = {k: round(v, 3) for k, v in shares(
            {n: 1.0 / ms for n, ms in kernel.items()}).items() if k != "task_logic_share"}
    print(json.dumps({**out, **where}), flush=True)
    return {"rates": results, "kernel_device_ms": kernel, "launches": launches, **out}


if __name__ == "__main__":
    main()
