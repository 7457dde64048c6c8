"""Paired comparison over reset seeds of two per-seed columns: the port's
(on the card) against the JAX package's (on the CPU).

Each column is read from a file of JSON lines as the tools print them:
either one line per seed with a "seed" key and the value under `key`
(`tools/eval_gather_checkpoint_seeds.py`, `ant_speed_probe`), or one record
with the value of seed s under `<key>_s<s>` (`eval_checkpoint --seeds`, where
the key is e.g. det_apples). Over the seeds both columns hold, prints the
per-seed differences (port - JAX), their mean and standard deviation, how
many are below zero, and the two-sided p-value of an exact sign-flip
permutation test of the mean difference (every assignment of signs to the
differences, as likely under the hypothesis that the two columns are
exchangeable seed by seed).

Usage: python -m pobrax_tpu_torch.tools.paired_seeds PORT_FILE PORT_KEY JAX_FILE JAX_KEY
       [--jax-files MORE ...]
Prints one JSON line. Numpy only; no device.
"""

from __future__ import annotations

import argparse
import json
import re
from typing import Dict, Sequence

import numpy as np


def column(paths: Sequence[str], key: str) -> Dict[int, float]:
    """{seed: value} of `key` in the JSON lines of `paths`."""
    out: Dict[int, float] = {}
    pattern = re.compile(rf"^{re.escape(key)}_s(\d+)$")
    for path in paths:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line.startswith("{"):
                    continue
                rec = json.loads(line)
                if "seed" in rec and key in rec:
                    out[int(rec["seed"])] = float(rec[key])
                for k, v in rec.items():
                    m = pattern.match(k)
                    if m:
                        out[int(m.group(1))] = float(v)
    return out


def sign_flip_p(diffs: np.ndarray) -> float:
    """Two-sided p-value of the mean of `diffs` under random signs, exact
    over all 2^n assignments (n <= 24)."""
    n = len(diffs)
    if n > 24:
        raise ValueError("exact sign-flip test over more than 24 seeds")
    signs = ((np.arange(2 ** n)[:, None] >> np.arange(n)) & 1) * 2 - 1
    means = np.abs(signs @ diffs) / n
    return float(np.mean(means >= abs(diffs.mean()) - 1e-12))


def compare(port: Dict[int, float], jax: Dict[int, float]) -> dict:
    seeds = sorted(set(port) & set(jax))
    d = np.array([port[s] - jax[s] for s in seeds])
    return {"seeds": seeds, "n": len(seeds),
            "port_mean": float(np.mean([port[s] for s in seeds])),
            "jax_mean": float(np.mean([jax[s] for s in seeds])),
            "diffs": [float(x) for x in d], "mean_diff": float(d.mean()),
            "std_diff": float(d.std(ddof=1)) if len(d) > 1 else 0.0,
            "below_zero": int((d < 0).sum()), "p_sign_flip": sign_flip_p(d)}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("port_file")
    parser.add_argument("port_key")
    parser.add_argument("jax_file")
    parser.add_argument("jax_key")
    parser.add_argument("--jax-files", nargs="*", default=[])
    args = parser.parse_args(argv)
    out = compare(column([args.port_file], args.port_key),
                  column([args.jax_file, *args.jax_files], args.jax_key))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
