"""Where learning curves first reach reward levels, and each call's pace.

Each FILE is a learning record (a JSON object whose "curve" is
[{"steps", "mean_reward"}], with "calls" when the run resumed across calls:
the examples' `learning_*.json`, the port's and the JAX package's alike) or a
run's `progress.jsonl` (`examples/_common.ProgressLog`). For each file it
prints one JSON line: the first env-step count at which `mean_reward`
reaches each of LEVELS (None if it never does), the last point's reward, and
for each call its epochs (a GRU-PPO epoch of the examples' recipes: 2048
envs x 32 steps x action repeat 6), seconds an epoch and env-steps a second.
With `--ref FILE` each line also holds, per level, its crossing over the
reference's. Each line also holds the mean `mean_reward` of the points in
each of WINDOWS: AntGather's rewards sit near 0.1, under every level, and
the JAX package's gather curriculum records are compared over these two.
No device, no jax.

Usage: python -m pobrax_tpu_torch.tools.curve_levels FILE ... [--ref FILE]
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional, Sequence

from pobrax_tpu_torch.examples._common import merged_calls

LEVELS = (0.5, 1.0, 2.0, 3.0)
STEPS_PER_EPOCH = 2048 * 32 * 6
# M env-steps: the last ~95M of each AntGather curriculum phase (14 m to
# 400M, 6 m to 800M) on the JAX records' every-tenth grid
WINDOWS = ((286, 381), (695, 790))


def read(path: str) -> dict:
    """{"curve": [...], "calls": [...]} of a record or a progress log."""
    with open(path) as f:
        text = f.read()
    if path.endswith(".jsonl"):
        reports = [e for e in map(json.loads, filter(str.strip, text.splitlines()))
                   if "phase_end" not in e]
        return {"curve": [{"steps": e["steps"], "mean_reward": e["mean_reward"]}
                          for e in reports if "call" not in e],
                "calls": merged_calls(reports)}
    record = json.loads(text)
    return {"curve": record["curve"], "calls": record.get("calls", [])}


def crossings(curve: Sequence[dict]) -> Dict[str, Optional[int]]:
    """{level: the first steps whose mean_reward >= level, or None}."""
    return {str(level): next((p["steps"] for p in curve if p["mean_reward"] >= level), None)
            for level in LEVELS}


def window_means(curve: Sequence[dict]) -> Dict[str, Optional[float]]:
    """{"LO:HI": the mean mean_reward of the points with LO <= steps / 1e6
    <= HI, or None if none lies there} for each of WINDOWS."""
    out = {}
    for lo, hi in WINDOWS:
        inside = [p["mean_reward"] for p in curve if lo <= p["steps"] / 1e6 <= hi]
        out[f"{lo}:{hi}"] = sum(inside) / len(inside) if inside else None
    return out


def pace(calls: Sequence[dict]) -> List[dict]:
    """Each call's epochs, seconds an epoch and env-steps a second."""
    out = []
    for c in calls:
        steps, secs = c["to"] - c["from"], c["train_s"]
        out.append({"from": c["from"], "to": c["to"], "train_s": secs,
                    "epochs": steps // STEPS_PER_EPOCH,
                    "s_per_epoch": secs / (steps / STEPS_PER_EPOCH),
                    "env_steps_per_s": steps / secs})
    return out


def summary(path: str, ref: Optional[str] = None) -> dict:
    run = read(path)
    out = {"file": path, "points": len(run["curve"]), "crossings": crossings(run["curve"]),
           "last": run["curve"][-1], "calls": pace(run["calls"]),
           "window_means": window_means(run["curve"])}
    if ref is not None:
        theirs = crossings(read(ref)["curve"])
        out["ref"] = ref
        out["ratio_to_ref"] = {k: (v / theirs[k] if v is not None and theirs[k] else None)
                               for k, v in out["crossings"].items()}
    return out


def main(argv=None) -> List[dict]:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("files", nargs="+")
    parser.add_argument("--ref", default=None)
    args = parser.parse_args(argv)
    out = [summary(p, args.ref) for p in args.files]
    for line in out:
        print(json.dumps(line), flush=True)
    return out


if __name__ == "__main__":
    main()
