"""Recurrent SAC on AntHeavenHell; the port of
examples/train_heavenhell_sac_rnn.py.

The off-policy memory agent on the same privileged progress shaping as
train_heavenhell_rnn.py (training time only), the same true-env evaluation
(completion rate, heaven rate among completions); the record also holds
the training's seconds (`wall_s`) and the card (`device`). n-step(5) targets and a
reward scale of 10 are the example's recipe: with 1-step targets or an
unscaled reward the JAX study measured no learning.

Usage: python -m pobrax_tpu_torch.examples.train_heavenhell_sac_rnn [num_timesteps] [num_envs]
       [--device cpu] [--out PATH]
"""

from __future__ import annotations

import sys
import time
from typing import Optional

from pobrax_tpu_torch.envs import HAI_ACTION_REPEAT, _envs
from pobrax_tpu_torch.examples._common import run_path, split_options, write_json
from pobrax_tpu_torch.examples.train_heavenhell_rnn import (ShapedHeavenHell, gru_policy,
                                                            outcome_rates, random_policy)
from pobrax_tpu_torch.training import sac_rnn
from pobrax_tpu_torch.utils.profiling import record_device

HIDDEN = 128
# examples/train_heavenhell_sac_rnn.py's sac_rnn.train arguments but the env,
# the budget, the batch and the progress function
RECIPE = dict(episode_length=1000, action_repeat=HAI_ACTION_REPEAT, seq_len=32, burn_in=8,
              replay_capacity=192, batch_size=128, seqs_per_epoch=4, grad_steps_per_seq=2,
              min_replay=24, learning_rate=3e-4, discounting=0.97, nstep=5, reward_scaling=10.0,
              hidden_size=HIDDEN, encoder_sizes=(256,), head_sizes=(256,),
              autoreset_mode="cached", seed=0)


def main(num_timesteps: int = 400_000_000, num_envs: int = 512, device=None,
         out: Optional[str] = None) -> dict:
    env = _envs["ant_heavenhell"](device=device)
    rand_c, rand_h = outcome_rates(_envs["ant_heavenhell"](device=device),
                                   **random_policy(env.action_size, env.device),
                                   action_repeat=HAI_ACTION_REPEAT)
    print(f"random: completion {rand_c:.3f}, heaven|completed {rand_h:.3f}", flush=True)

    history = []

    def progress(steps, metrics):
        history.append({"steps": steps, "mean_reward": metrics.get("mean_reward"),
                        "q_loss": metrics.get("q_loss")})
        if len(history) % 50 == 0:
            print(f"  {steps:>12,} steps  mean_reward={history[-1]['mean_reward']:+.4f}",
                  flush=True)

    t0 = time.perf_counter()
    inference_fn, params, _ = sac_rnn.train(
        ShapedHeavenHell(_envs["ant_heavenhell"](device=device), coef=5.0),
        num_timesteps=num_timesteps, num_envs=num_envs, progress_fn=progress, **RECIPE)
    wall_s = time.perf_counter() - t0
    card = record_device(env.device)["card"]
    print(f"trained {num_timesteps:,} env-steps in {wall_s:.1f} s; {card or env.device}",
          flush=True)

    det_c, det_h = outcome_rates(_envs["ant_heavenhell"](device=device),
                                 **gru_policy(inference_fn, params, HIDDEN, env.device, True),
                                 action_repeat=HAI_ACTION_REPEAT)
    sto_c, sto_h = outcome_rates(_envs["ant_heavenhell"](device=device),
                                 **gru_policy(inference_fn, params, HIDDEN, env.device),
                                 action_repeat=HAI_ACTION_REPEAT, seed=1)
    print(f"GRU-SAC det:   completion {det_c:.3f}, heaven|completed {det_h:.3f}", flush=True)
    print(f"GRU-SAC stoch: completion {sto_c:.3f}, heaven|completed {sto_h:.3f}", flush=True)
    payload = {"num_timesteps": num_timesteps, "num_envs": num_envs,
               "random": {"completion": rand_c, "heaven": rand_h},
               "gru_sac_det": {"completion": det_c, "heaven": det_h},
               "gru_sac_stoch": {"completion": sto_c, "heaven": sto_h}, "curve": history,
               "wall_s": wall_s, "device": card or str(env.device)}
    write_json(out or run_path("learning_heavenhell_sac_rnn.json"), payload)
    return payload


if __name__ == "__main__":
    args, device, out = split_options(sys.argv[1:])
    main(*[int(a) for a in args[:2]], device=device, out=out)
