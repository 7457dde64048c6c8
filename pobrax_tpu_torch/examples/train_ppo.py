"""Train PPO on a registered env, then render an evaluation trajectory; the
port of examples/train_ppo.py.

Data-parallel over the processes of the default group through a 'data' mesh
(`parallel.mesh.make_mesh`; one process without torchrun). After training,
300 deterministic steps of one env are saved as an HTML page (`io/html.py`)
at `--out` (runs/<env_name>_eval.html unless named).

Usage: python -m pobrax_tpu_torch.examples.train_ppo [env_name] [num_timesteps]
       [--device cpu] [--out PATH]
"""

from __future__ import annotations

import sys
from typing import Optional

from pobrax_tpu_torch import random as jr
from pobrax_tpu_torch.envs import _envs
from pobrax_tpu_torch.examples._common import make_parent, run_path, split_options
from pobrax_tpu_torch.io import html
from pobrax_tpu_torch.parallel.mesh import make_mesh
from pobrax_tpu_torch.training import ppo

EVAL_STEPS = 300


def main(env_name: str = "ant_tag", num_timesteps: int = 500_000, device=None,
         out: Optional[str] = None) -> str:
    env = _envs[env_name](device=device)
    mesh = make_mesh(device=env.device)

    def progress(steps, metrics):
        print(f"steps {steps:>10,}  reward {metrics['mean_reward']:+.3f}  "
              f"sps {metrics['steps_per_second']:,.0f}", flush=True)

    inference_fn, params, _ = ppo.train(
        env, num_timesteps=num_timesteps, num_envs=1024, episode_length=1000, unroll_length=20,
        num_minibatches=16, num_update_epochs=4, mesh=mesh, progress_fn=progress)

    # an evaluation rollout of the deterministic policy, rendered to HTML
    key = jr.PRNGKey(1, env.device)
    state = env.reset(key[None])
    qps = [state.qp]
    for _ in range(EVAL_STEPS):
        state = env.step(state, inference_fn(params, state.obs, key, deterministic=True))
        qps.append(state.qp)
    out = out or run_path(f"{env_name}_eval.html")
    html.save(make_parent(out), env.sys, qps)
    print(f"wrote {out}", flush=True)
    return out


if __name__ == "__main__":
    args, device, out = split_options(sys.argv[1:])
    main(args[0] if args else "ant_tag", int(args[1]) if len(args) > 1 else 500_000,
         device=device, out=out)
