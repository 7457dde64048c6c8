"""The replay carry-over remedy for the off-policy curriculum collapse; the
port of examples/train_ant_tag_sac_rnn_carry.py.

Resumes the committed radius-20 GRU-SAC checkpoint (phase 0, 750M steps:
`pobrax_tpu_torch/checkpoints/ant_tag_sac_rnn_phase0_750M.npz`, the export of
checkpoints/ant_tag_sac_rnn_phase0_750M) and trains DIRECTLY at the true
radius 4, with `carry_env` = the shaped radius-20 env on `carry_frac` of the
env batch (sac_rnn's mixed-env collection: the replay's columns are
[carry | train]), so that the critic keeps on-distribution anchors while
the radius shrinks. Then the tag rates at radius 20 ("anchor") and 4
("true"), det and stoch.

Usage: python -m pobrax_tpu_torch.examples.train_ant_tag_sac_rnn_carry
       [carry_frac] [freeze_epochs] [num_envs] [--device cpu] [--out PATH]
"""

from __future__ import annotations

import os
import sys
from typing import Optional

from pobrax_tpu_torch import eval_tag_checkpoint
from pobrax_tpu_torch.envs import _envs
from pobrax_tpu_torch.examples._common import run_path, split_options, write_json
from pobrax_tpu_torch.examples.train_ant_tag import ShapedAntTag
from pobrax_tpu_torch.examples.train_ant_tag_sac_rnn import RECIPE, evaluate
from pobrax_tpu_torch.training import checkpoint as ckpt
from pobrax_tpu_torch.training import sac_rnn

PHASE0 = eval_tag_checkpoint.SAC_NPZ
PHASE0_STEP = "step_000750000000"
BUDGET = 1_150_000_000  # 750M resumed + 400M new


def seed_resume_dir(checkpoint_dir: str, device=None) -> str:
    """Writes the phase-0 export as `checkpoint_dir/step_000750000000` (the
    JAX script copies the orbax dir there) unless it exists:
    `checkpoint.load_npz` -> `interop.training_state_from_numpy` (through
    `eval_tag_checkpoint.load`, which checks the checksum) ->
    `checkpoint.save`. Returns the step dir."""
    step_dir = os.path.join(checkpoint_dir, PHASE0_STEP)
    if not os.path.isdir(step_dir):
        _, ts, same = eval_tag_checkpoint.load(PHASE0, device, sac=True)
        if not same:
            raise RuntimeError(f"{PHASE0}: the loaded parameters do not match their checksum")
        ckpt.save(step_dir, ts)
        print(f"seeded {step_dir} from {PHASE0}", flush=True)
    return step_dir


def main(carry_frac: float = 0.25, freeze_epochs: int = 0, num_envs: int = 512,
         checkpoint_dir: Optional[str] = None, num_timesteps: int = BUDGET, device=None,
         out: Optional[str] = None) -> dict:
    """`num_timesteps` is the cumulative budget (the 750M resumed included)."""
    checkpoint_dir = checkpoint_dir or run_path("ant_tag_sac_rnn_carry_ckpt")
    seed_resume_dir(checkpoint_dir, device)
    history = []

    def progress(steps, m):
        history.append({"steps": steps, "mean_reward": m.get("mean_reward")})
        if len(history) % 100 == 0:
            print(f"  {steps:>13,}  r={history[-1]['mean_reward']:+.4f}", flush=True)

    inf, params, _ = sac_rnn.train(
        ShapedAntTag(_envs["ant_tag"](visible_radius=4.0, device=device), coef=5.0),
        carry_env=ShapedAntTag(_envs["ant_tag"](visible_radius=20.0, device=device), coef=5.0),
        carry_frac=carry_frac, num_timesteps=num_timesteps, num_envs=num_envs,
        actor_freeze_epochs=freeze_epochs, checkpoint_dir=checkpoint_dir,
        checkpoint_every=100_000_000, progress_fn=progress, **RECIPE)
    results = evaluate(inf, params, (("anchor", 20.0), ("true", 4.0)), device)
    payload = {"carry_frac": carry_frac, "freeze_epochs": freeze_epochs,
               "budget": num_timesteps, "results": results, "curve": history[::10]}
    write_json(out or run_path("learning_ant_tag_sac_rnn_carry.json"), payload)
    return payload


if __name__ == "__main__":
    args, device, out = split_options(sys.argv[1:])
    main(float(args[0]) if args else 0.25, int(args[1]) if len(args) > 1 else 0,
         int(args[2]) if len(args) > 2 else 512, device=device, out=out)
