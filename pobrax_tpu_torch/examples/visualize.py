"""Render a random-policy trajectory of any registered env to HTML; the port
of examples/visualize.py.

Usage: python -m pobrax_tpu_torch.examples.visualize [env_name] [steps] [out.html]
       [--device cpu]   (out: runs/<env_name>_random.html unless named)
"""

from __future__ import annotations

import sys
from typing import Optional

from pobrax_tpu_torch import random as jr
from pobrax_tpu_torch.envs import _envs
from pobrax_tpu_torch.examples._common import (make_parent, run_path, split_options, split2,
                                               uniform_actions)
from pobrax_tpu_torch.io import html


def main(env_name: str = "ant_tag", steps: int = 300, out: Optional[str] = None,
         device=None) -> str:
    """`steps` uniform random actions on one env from reset seed 0, drawn as
    the JAX example draws them; the page holds the `steps` states after
    each step."""
    env = _envs[env_name](device=device)
    key = jr.PRNGKey(0, env.device)
    state = env.reset(key[None])
    qps = []
    for _ in range(steps):
        key, k = split2(key)
        state = env.step(state, uniform_actions(k, (1, env.action_size)))
        qps.append(state.qp)
    out = out or run_path(f"{env_name}_random.html")
    html.save(make_parent(out), env.sys, qps)
    print(f"wrote {out} ({steps} frames)", flush=True)
    return out


if __name__ == "__main__":
    args, device, _ = split_options(sys.argv[1:])
    main(args[0] if args else "ant_tag", int(args[1]) if len(args) > 1 else 300,
         args[2] if len(args) > 2 else None, device=device)
