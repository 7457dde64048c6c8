"""Stability of the integrator's substeps retune; the port of
`tools/substeps_probe.py`.

For each candidate (substeps, stiffness_scale) on ant / ant_tag at the HAI
action repeat (6) — the env's base substeps retuned with `retune_substeps`
and, for a scale other than 1, every joint's stiffness x s, spring damping
x sqrt(s) (the damping ratio held) and limit strength x s, as the JAX
tool's `retuned_env` — a random-action rollout under ActionRepeat ->
Episode(1000) -> Vmap -> naive randomized autoreset reports:
  * nan_frac — share of non-finite body positions;
  * torso z mean / p5 / p95 (sagging joints or launch-offs move these);
  * done_rate per step (blow-ups leave the termination band);
  * mean speed and mean |angular velocity| (energy injection).
A candidate is PLAUSIBLE if it has no NaN, its z mean is within 10% of the
reference (the first candidate, substeps 10) and its done rate under 3x.
Key stream as JAX's: `k_reset, key = split(PRNGKey(seed))`, then per step
`key, k = split(key)` and `uniform(k, (batch, action_size), -1, 1)`.

Usage: python -m pobrax_tpu_torch.tools.substeps_probe [env_name] [batch] [steps]
(defaults ant_tag, 64, 1000). Prints one JSON line per candidate (with the
device and the card's name and power limit), then a verdict line each; the
card unless a device is named (with no card and no device named it raises).
"""

from __future__ import annotations

import dataclasses
import json
import sys

import torch

from pobrax_tpu_torch import random as jr
from pobrax_tpu_torch.device import resolve
from pobrax_tpu_torch.envs import HAI_ACTION_REPEAT, _envs, wrappers
from pobrax_tpu_torch.physics import whole_step
from pobrax_tpu_torch.physics.system import System
from pobrax_tpu_torch.utils.profiling import record_device

CANDIDATES = (
    (10, 1.0),  # production reference
    (5, 1.0),  # plain halving (h_sub 0.01)
    (5, 0.5),  # soft retune
    (5, 0.25),  # h*omega-preserving retune
)


def retuned_env(env_name: str, substeps: int, stiffness_scale: float = 1.0, device=None):
    """The core env with base substeps `substeps` and, for a scale other
    than 1, every joint's stiffness and damping rescaled (module docstring)."""
    env = _envs[env_name](device=resolve(device))
    env.retune_substeps(substeps)
    if stiffness_scale != 1.0:
        s = stiffness_scale
        joints = tuple(
            dataclasses.replace(
                j,
                stiffness=j.stiffness * s,
                spring_damping=(None if j.spring_damping is None
                                else j.spring_damping * s ** 0.5),
                limit_strength=(None if j.limit_strength is None
                                else j.limit_strength * s),
            )
            for j in env._cfg.joints)
        env._cfg = dataclasses.replace(env._cfg, joints=joints)
        env.sys = System(env._cfg, env.device, env.sys.info_mode)
    return env


@torch.no_grad()
def probe(env_name: str, substeps: int, stiffness_scale: float, batch: int, steps: int,
          seed: int = 0, device=None) -> dict:
    dev = resolve(device)
    core = retuned_env(env_name, substeps, stiffness_scale, dev)
    torso = getattr(core, "torso_idx", 0)
    env = wrappers.ActionRepeatWrapper(core, HAI_ACTION_REPEAT)
    env = wrappers.EpisodeWrapper(env, 1000, 1)
    env = wrappers.VmapWrapper(env, batch_size=batch)
    env = wrappers.RandomizedAutoResetWrapperNaive(env)
    asz = core.action_size
    k_reset, key = jr.split(jr.PRNGKey(seed, dev), 2).unbind(-2)
    state = env.reset(jr.split(k_reset, batch))
    q = torch.tensor([0.05, 0.95], device=dev)
    n0 = whole_step.launches
    rows = []
    for _ in range(steps):
        key, k = jr.split(key, 2).unbind(-2)
        state = env.step(state, jr.uniform(k, (batch, asz), -1.0, 1.0))
        z = state.qp.pos[:, torso, 2]
        rows.append(torch.stack([
            (~torch.isfinite(state.qp.pos)).float().mean(), z.mean(), *torch.quantile(z, q),
            state.done.float().mean(), torch.linalg.norm(state.qp.vel, dim=-1).mean(),
            state.qp.ang.abs().mean()]))
    launches = whole_step.launches - n0
    nanfrac, zmean, z5, z95, done, speed, ang = torch.stack(rows).mean(0).tolist()
    return {"env": env_name, "substeps": substeps, "stiffness_scale": stiffness_scale,
            "nan_frac": nanfrac, "z_mean": round(zmean, 4), "z_p5": round(z5, 4),
            "z_p95": round(z95, 4), "done_rate": round(done, 5), "speed": round(speed, 4),
            "ang_speed": round(ang, 4), "launches": launches, **record_device(dev)}


def plausible(r: dict, ref: dict) -> bool:
    return (r["nan_frac"] == 0.0
            and abs(r["z_mean"] - ref["z_mean"]) < 0.1 * max(ref["z_mean"], 0.1)
            and r["done_rate"] < 3 * max(ref["done_rate"], 1e-3))


def main(argv=None, device=None, candidates=CANDIDATES) -> list:
    argv = sys.argv[1:] if argv is None else argv
    env_name = argv[0] if len(argv) > 0 else "ant_tag"
    batch = int(argv[1]) if len(argv) > 1 else 64
    steps = int(argv[2]) if len(argv) > 2 else 1000
    out = []
    for substeps, scale in candidates:
        out.append(probe(env_name, substeps, scale, batch, steps, device=device))
        print(json.dumps(out[-1]), flush=True)
    ref = out[0]
    for r in out[1:]:
        r["verdict"] = "PLAUSIBLE" if plausible(r, ref) else "REJECT"
        print(f"# substeps={r['substeps']} scale={r['stiffness_scale']}: {r['verdict']}",
              flush=True)
    return out


if __name__ == "__main__":
    main()
