"""A/B of the integrator's substeps retune on the card; the port of
`tools/bench_substeps.py`.

Runs `pobrax_tpu_torch.bench.bench` (the headline harness: cached autoreset,
one warm-up rollout, best of three) once per candidate of SUBSTEPS_LIST,
back to back on one card, and prints one JSON line per candidate, then each
candidate's speedup over the first (the reference, 10), each line with the
device and the card's name and power limit.

Usage: python -m pobrax_tpu_torch.tools.bench_substeps [env_name] [batch] [steps]
Env: SUBSTEPS_LIST="10,8" (candidates, first = reference). On the card; with
no card and no device named it raises.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Optional

from pobrax_tpu_torch import bench
from pobrax_tpu_torch.device import resolve
from pobrax_tpu_torch.utils.profiling import record_device


def main(argv=None, environ: Optional[dict] = None, device=None, repeats: int = 3) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    env_vars = os.environ if environ is None else environ
    dev = resolve(device)
    where = record_device(dev)
    env_name = argv[0] if len(argv) > 0 else "ant_tag"
    batch = int(argv[1]) if len(argv) > 1 else 4096
    steps = int(argv[2]) if len(argv) > 2 else 200
    cands = [int(x) for x in env_vars.get("SUBSTEPS_LIST", "10,8").split(",")]
    out = {}
    for ss in cands:
        r = bench.bench(env_name, batch, steps, repeats, device=dev, autoreset="cached",
                        substeps=0 if ss == 10 else ss, rng="threefry", trace_dir="")
        out[str(ss)] = round(r["value"], 1)
        print(json.dumps({"env": env_name, "substeps": ss, "env_steps_per_s": out[str(ss)],
                          "runs": [round(v, 1) for v in r["runs"]], **where}), flush=True)
    ref = out[str(cands[0])]
    for ss in cands[1:]:
        print(json.dumps({"env": env_name, "speedup_vs_substeps10": round(out[str(ss)] / ref, 4),
                          "substeps": ss, **where}), flush=True)
    return out


if __name__ == "__main__":
    main()
