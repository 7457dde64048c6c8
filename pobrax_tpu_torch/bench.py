"""Throughput benchmark of the port: env-steps/s at 4096 batched envs on one card.

The port of `bench.py`: `python -m pobrax_tpu_torch.bench`. It measures the
main path, `create("ant_tag", batch_size=4096, episode_length=1000,
randomized_autoreset=True, autoreset_mode=...)`, stepped with on-device
uniform random actions: physics (one launch of the whole-step kernel a
control step), task logic, randomized autoreset. `rollout(env, state, key,
steps)` is the stepped loop, with bench.py's key stream: per step `key,
k_act = split(key)` and `uniform(k_act, (batch, action_size), -1, 1)`
(the port's threefry, bit-equal to `jax.random`).

Timing follows bench.py: one warm-up rollout, then the best of `repeats`
rollouts, each window closed by `torch.cuda.synchronize()`. Every run's
rate is kept in the record too (`runs`): host noise moves the host-bound
paths by up to 2x between calls. The kernel's launch counter must read
exactly `steps` per timed rollout, or the bench raises.

Prints exactly one JSON line, bench.py's keys plus where it ran:
  {"metric": ..., "value": N, "unit": "env_steps/s/chip", "vs_baseline": N,
   "autoreset": ..., "modes": {...}, "device": "cuda", "card": "<name>, <limit>"}

Environment knobs, as bench.py's: BENCH_ENV (a registered env, or
masked_<name>: VELOCITY hidden), BENCH_BATCH (4096), BENCH_STEPS (200),
BENCH_AUTORESET (cached | naive: the headline mode; the other is measured
too unless BENCH_SINGLE_MODE=1), BENCH_SUBSTEPS (the integrator retune; 0:
the env's own 10), BENCH_BATCH_SWEEP=1 with BENCH_SWEEP_BATCHES ("8192"),
BENCH_TRAIN=1 (also `tools.bench_train`'s PPO record, TRAIN_EPC epochs a
call, 8 by default). Where bench.py has a TPU knob:
  * BENCH_RNG=rbg draws the action stream from a `torch.Generator` on the
    card (Philox), the card's counterpart of the TPU's hardware RNG; the
    env's own threefry draws are untouched;
  * BENCH_TRACE=<dir> writes a `torch.profiler` trace of one timed rollout;
  * one process runs on one card, so the rate is per chip as it stands.
`vs_baseline` compares with the earliest committed record of the port in the
same autoreset mode (`BENCH_TORCH_r<N>.json` at the root, naming an NVIDIA
card); the TPU's BENCH_r*.json are never read. With none, it is 1.0.

Runs on the card; with no card and no device named it raises
(`device="cpu"` runs the plain step, for the tests only).
"""

from __future__ import annotations

import glob
import json
import os
import re
import sys
import time
from typing import Optional, Union

import torch

from pobrax_tpu_torch import random as jr
from pobrax_tpu_torch.device import resolve
from pobrax_tpu_torch.envs import MaskedObservationWrapper, create
from pobrax_tpu_torch.physics import whole_step
from pobrax_tpu_torch.utils.profiling import record_device, trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def make_env(env_name: str = "ant_tag", batch: int = 4096, autoreset: str = "cached",
             substeps: Optional[int] = None, device=None):
    """bench.py's env: `create(name, episode_length=1000, batch_size=batch,
    auto_reset=True, randomized_autoreset=True, autoreset_mode=autoreset)`,
    under `MaskedObservationWrapper(hidden=("VELOCITY",))` for masked_<name>."""
    hidden = None
    if env_name.startswith("masked_"):
        env_name = env_name[len("masked_"):]
        hidden = ("VELOCITY",)
    extra = {"substeps": substeps} if substeps else {}
    env = create(env_name, episode_length=1000, batch_size=batch, auto_reset=True,
                 randomized_autoreset=True, autoreset_mode=autoreset, device=resolve(device),
                 **extra)
    if hidden is not None:
        env = MaskedObservationWrapper(env, env_name=env_name, hidden=hidden)
    return env


def split2(key: torch.Tensor):
    return jr.split(key, 2).unbind(-2)


def rollout(env, state, key: Union[torch.Tensor, torch.Generator], steps: int,
            block: jr.Block = None):
    """`steps` env steps of uniform random actions in [-1, 1) -> (state,
    key). `key` is a threefry key (bench.py's stream: `key, k_act =
    split(key)` a step) or a `torch.Generator` (BENCH_RNG=rbg), which is
    returned as it advanced. `block` (`parallel.mesh.draw_block`): `state`
    is a rank's block of a global batch, and its actions are its rows of
    the global draw."""
    batch = state.obs.shape[0]
    shape = (batch, env.action_size)
    for _ in range(steps):
        if isinstance(key, torch.Generator):
            action = torch.rand(shape, generator=key, device=state.obs.device) * 2.0 - 1.0
        else:
            key, k_act = split2(key)
            action = jr.uniform(k_act, shape, -1.0, 1.0, block=block)
        state = env.step(state, action)
    return state, key


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bench(env_name: str = "ant_tag", batch: int = 4096, steps: int = 200, repeats: int = 3,
          device=None, autoreset: Optional[str] = None, substeps: Optional[int] = None,
          rng: Optional[str] = None, trace_dir: Optional[str] = None) -> dict:
    """bench.py's `bench`: one warm-up rollout, then `repeats` timed ones
    -> {"value": best env-steps/s, "runs": each run's env-steps/s,
    "launches": kernel launches per timed rollout, "rng"}. `autoreset`,
    `substeps`, `rng` and `trace_dir` default to BENCH_AUTORESET,
    BENCH_SUBSTEPS, BENCH_RNG and BENCH_TRACE. Raises unless every timed
    rollout launched the kernel once a step (on the card)."""
    dev = resolve(device)
    autoreset = autoreset or os.environ.get("BENCH_AUTORESET", "cached")
    if substeps is None:
        substeps = int(os.environ.get("BENCH_SUBSTEPS", "0"))  # 0/unset = default 10
    rng = rng if rng is not None else os.environ.get("BENCH_RNG", "threefry")
    trace_dir = trace_dir if trace_dir is not None else os.environ.get("BENCH_TRACE")
    env = make_env(env_name, batch, autoreset, substeps, dev)
    key = jr.PRNGKey(0, dev)
    state = env.reset(jr.split(key, batch))
    if rng == "rbg":
        if dev.type != "cuda":
            raise ValueError("BENCH_RNG=rbg draws from the card's generator; run it on the card")
        key = torch.Generator(device=dev).manual_seed(0)
    elif rng != "threefry":
        raise ValueError(f"BENCH_RNG must be 'rbg' or unset, got {rng!r}")
    per_step = 1 if dev.type == "cuda" and hasattr(env.unwrapped, "sys") else 0

    state, key = rollout(env, state, key, steps)  # warm-up: the kernel's build, allocations
    _sync(dev)
    runs, launches = [], []
    for _ in range(repeats):
        n0 = whole_step.launches
        t0 = time.perf_counter()
        state, key = rollout(env, state, key, steps)
        _sync(dev)
        dt = time.perf_counter() - t0
        runs.append(batch * steps / dt)
        launches.append(whole_step.launches - n0)
    if any(n != per_step * steps for n in launches):
        raise RuntimeError(f"{env_name}: the timed rollouts launched the kernel {launches} "
                           f"times, not {per_step * steps} each (one a control step)")
    if not bool(torch.isfinite(state.obs).all()):
        raise RuntimeError(f"{env_name}: the rollout produced non-finite observations")
    if trace_dir:
        with trace(trace_dir):
            state, key = rollout(env, state, key, steps)
            _sync(dev)
        print(f"# trace written to {trace_dir}", file=sys.stderr, flush=True)
    return {"value": max(runs), "runs": runs, "launches": launches, "rng": rng}


def _baseline_for_mode(mode: str, root: str = ROOT) -> Optional[float]:
    """The earliest committed record of the port (`BENCH_TORCH_r<N>.json`,
    by the number in the name) whose autoreset mode is `mode` and whose
    card is an NVIDIA one; None without one. A record that cannot be parsed
    is warned about, never silently skipped as "no baseline". bench.py's
    TPU records (BENCH_r*.json) are not the port's and are never read."""
    rounds = []
    for path in glob.glob(os.path.join(root, "BENCH_TORCH_r*.json")):
        m = re.search(r"BENCH_TORCH_r(\d+)\.json$", path)
        if m:
            rounds.append((int(m.group(1)), path))
    for _, path in sorted(rounds):
        try:
            with open(path) as f:
                rec = json.load(f)
            parsed = rec.get("parsed") or rec
            card, value = parsed.get("card") or "", parsed.get("value")
            rec_mode = parsed["autoreset"]
        except Exception as e:  # noqa: BLE001 - reported, then the next record
            print(f"# warning: could not parse baseline record {path}: {e}", file=sys.stderr)
            continue
        if rec_mode == mode and value and "NVIDIA" in card:
            return value
    return None


def main(environ: Optional[dict] = None, device=None) -> dict:
    """bench.py's `main`: both autoreset modes (the headline first), the
    optional batch sweep and training record; prints the record's JSON line
    and returns it. `environ` stands in for os.environ (the knobs)."""
    env_vars = os.environ if environ is None else environ
    dev = resolve(device)
    env_name = env_vars.get("BENCH_ENV", "ant_tag")
    batch = int(env_vars.get("BENCH_BATCH", "4096"))
    steps = int(env_vars.get("BENCH_STEPS", "200"))
    substeps = int(env_vars.get("BENCH_SUBSTEPS", "0"))
    rng = env_vars.get("BENCH_RNG", "threefry")
    trace_dir = env_vars.get("BENCH_TRACE")
    n_chips = 1  # one process, one card

    headline_mode = env_vars.get("BENCH_AUTORESET", "cached")
    modes = [headline_mode]
    if not int(env_vars.get("BENCH_SINGLE_MODE", "0")):
        modes += [m for m in ("cached", "naive") if m != headline_mode]

    results = {}
    for mode in modes:
        r = bench(env_name, batch, steps, device=dev, autoreset=mode, substeps=substeps,
                  rng=rng, trace_dir=trace_dir if mode == headline_mode else "")
        value = r["value"] / n_chips
        baseline = _baseline_for_mode(mode)
        results[mode] = {"value": round(value, 1),
                         "vs_baseline": round(value / baseline, 3) if baseline else 1.0,
                         "runs": [round(v, 1) for v in r["runs"]],
                         "launches_per_rollout": r["launches"]}
        print(f"# {env_name} {mode}: runs {results[mode]['runs']} env-steps/s, launches "
              f"{r['launches']}", file=sys.stderr, flush=True)

    head = results[headline_mode]
    record = {
        "metric": f"{env_name} env-steps/s/chip @ {batch} envs",
        "value": head["value"],
        "unit": "env_steps/s/chip",
        "vs_baseline": head["vs_baseline"],
        "autoreset": headline_mode,
        "modes": results,
        "steps": steps,
        "rng": "rbg (torch.Generator, Philox, on the card)" if rng == "rbg" else "threefry",
        **record_device(dev),
    }

    if int(env_vars.get("BENCH_BATCH_SWEEP", "0")):
        sweep = {}
        for b in [int(x) for x in env_vars.get("BENCH_SWEEP_BATCHES", "8192").split(",")]:
            if b == batch:
                continue
            v = bench(env_name, b, steps, device=dev, autoreset=headline_mode,
                      substeps=substeps, rng=rng, trace_dir="")["value"] / n_chips
            sweep[str(b)] = {"value": round(v, 1),
                             "per_env_speedup_vs_headline": round(v / head["value"], 3)}
        record["batch_sweep"] = sweep

    if int(env_vars.get("BENCH_TRAIN", "0")):
        from pobrax_tpu_torch.tools.bench_train import bench_train

        t = bench_train(env_name, batch=batch, autoreset=headline_mode,
                        epochs_per_call=int(env_vars.get("TRAIN_EPC", "8")),
                        repeats=int(env_vars.get("TRAIN_REPEATS", "3")), device=dev)
        record["train"] = {"value": t["value"], "unit": t["unit"],
                           "config": {k: t[k] for k in ("network_dtype", "unroll", "minibatches",
                                                        "update_epochs", "epochs_per_call")}}
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
