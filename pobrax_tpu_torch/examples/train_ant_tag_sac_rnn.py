"""GRU-SAC on AntTag through the staged visibility curriculum; the port of
examples/train_ant_tag_sac_rnn.py.

The off-policy memory agent (recurrent SAC with n-step(5) targets) on the
potential-shaped AntTag, one curriculum phase per call, each resuming a
shared checkpoint (the replay re-warms each phase). After the phase the true
sparse tag rate, det and stoch, at the phase's radius and at 4. The JAX
example records that phase 0 (radius 20) learns and every narrowing
continuation collapses the true-env rate; the on-policy curriculum
(train_ant_tag_rnn.py) remains the AntTag solve.

Usage: python -m pobrax_tpu_torch.examples.train_ant_tag_sac_rnn PHASE [num_envs]
       [--device cpu] [--out PATH]
  PHASE indexes CURRICULUM; rerun with the same checkpoint dir to continue.
"""

from __future__ import annotations

import sys
from typing import Optional

from pobrax_tpu_torch.envs import HAI_ACTION_REPEAT, _envs
from pobrax_tpu_torch.examples._common import run_path, split_options, write_json
from pobrax_tpu_torch.examples.train_ant_tag import ShapedAntTag
from pobrax_tpu_torch.examples.train_ant_tag_rnn import tag_rate_rnn
from pobrax_tpu_torch.training import sac_rnn

# (visible_radius, cumulative num_timesteps through the end of the phase)
CURRICULUM = ((20.0, 750_000_000), (6.0, 1_150_000_000), (4.0, 1_550_000_000),
              (4.0, 1_950_000_000))
HIDDEN = 128
# examples/train_ant_tag_sac_rnn.py's sac_rnn.train arguments but the env,
# the budget, the checkpoint dir and the progress function
RECIPE = dict(episode_length=1000, action_repeat=HAI_ACTION_REPEAT, seq_len=32, burn_in=8,
              replay_capacity=192, batch_size=128, seqs_per_epoch=4, grad_steps_per_seq=2,
              min_replay=24, learning_rate=3e-4, discounting=0.97, reward_scaling=10.0, nstep=5,
              hidden_size=HIDDEN, encoder_sizes=(256,), head_sizes=(256,),
              autoreset_mode="cached", seed=0)


def evaluate(inference_fn, params, radii, device) -> dict:
    """The tag rate, det and stoch at reset seed 0, 256 episodes, on the true
    AntTag at each (name, visible radius) of `radii`."""
    results = {}
    for name, env_radius in radii:
        for det in (True, False):
            r = tag_rate_rnn(_envs["ant_tag"](visible_radius=env_radius, device=device),
                             inference_fn, params, HIDDEN, action_repeat=HAI_ACTION_REPEAT,
                             deterministic=det)
            mode = "det" if det else "stoch"
            results[f"{name}_r{env_radius:g}_{mode}"] = r
            print(f"tag rate [{name} r={env_radius:g} {mode}]: {r:.3f}", flush=True)
    return results


def run_phase(phase: int, num_envs: int = 512, checkpoint_dir: Optional[str] = None,
              budget: Optional[int] = None, device=None, out: Optional[str] = None) -> dict:
    """Phase `phase` of CURRICULUM: GRU-SAC at the example's recipe up to the
    phase's cumulative budget (`budget` if given), resuming `checkpoint_dir`
    (runs/ant_tag_sac_rnn_ckpt unless named); then the tag rates. The record
    goes to `out` (runs/learning_ant_tag_sac_rnn_phase<phase>.json)."""
    radius, default_budget = CURRICULUM[phase]
    budget = default_budget if budget is None else budget
    history = []

    def progress(steps, m):
        history.append({"steps": steps, "mean_reward": m.get("mean_reward")})
        if len(history) % 100 == 0:
            print(f"  {steps:>13,}  r={history[-1]['mean_reward']:+.4f}", flush=True)

    inf, params, _ = sac_rnn.train(
        ShapedAntTag(_envs["ant_tag"](visible_radius=radius, device=device), coef=5.0),
        num_timesteps=budget, num_envs=num_envs,
        checkpoint_dir=checkpoint_dir or run_path("ant_tag_sac_rnn_ckpt"),
        checkpoint_every=50_000_000, progress_fn=progress, **RECIPE)
    results = evaluate(inf, params, (("phase", radius), ("true", 4.0)), device)
    payload = {"phase": phase, "radius": radius, "budget": budget, "results": results,
               "curve": history[::10]}
    write_json(out or run_path(f"learning_ant_tag_sac_rnn_phase{phase}.json"), payload)
    return payload


if __name__ == "__main__":
    args, device, out = split_options(sys.argv[1:])
    run_phase(int(args[0]) if args else 0, int(args[1]) if len(args) > 1 else 512,
              device=device, out=out)
