"""Replay the committed AntTag GRU-PPO checkpoint with the port.

The counterpart of `tools/eval_tag_checkpoint.py`: loads the numpy export of
`checkpoints/ant_tag_rnn_900M` (`tools/export_torch_checkpoint.py` wrote
`pobrax_tpu_torch/checkpoints/ant_tag_rnn_900M.npz`), checks the loaded
parameters against the checksum stored beside them, and reports the TRUE
sparse tag rate on 256 episodes of AntTag under ActionRepeat(6) ->
Episode(1000) -> Vmap, deterministic and stochastic, as `tag_rate_rnn` of
`examples/train_ant_tag_rnn.py` measures it.

Usage: python -m pobrax_tpu_torch.eval_tag_checkpoint [npz] [--device cpu]
[--episodes N] (the card unless a device is named).
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Callable, Optional

import torch

from pobrax_tpu_torch import interop
from pobrax_tpu_torch import random as jr
from pobrax_tpu_torch.device import resolve
from pobrax_tpu_torch.envs import wrappers
from pobrax_tpu_torch.envs.ant_tag import AntTagEnv
from pobrax_tpu_torch.training import checkpoint as ckpt
from pobrax_tpu_torch.training import ppo_rnn

DEFAULT_NPZ = os.path.join(os.path.dirname(os.path.abspath(__file__)), "checkpoints",
                           "ant_tag_rnn_900M.npz")
ACTION_REPEAT = ppo_rnn.ANT_TAG.action_repeat  # the JAX package's HAI_ACTION_REPEAT, 6
HIDDEN = ppo_rnn.ANT_TAG.hidden_size


def load(npz: str = DEFAULT_NPZ, device=None):
    """-> (learner, training state, checksum matches): an RNNPPOLearner for
    AntTag with the checkpoint's state loaded on `device`."""
    device = resolve(device)
    tree = ckpt.load_npz(npz)
    learner = ppo_rnn.RNNPPOLearner(AntTagEnv(device=device), ppo_rnn.ANT_TAG)
    ts = interop.training_state_from_numpy(tree, learner)
    same = interop.params_checksum(interop.params_to_numpy(ts.params)) == tree["params_sha256"]
    return learner, ts, same


@torch.no_grad()
def tag_rate_rnn(env_core, inference_fn: Callable, params, hidden_size: int,
                 episodes: int = 256, episode_length: int = 1000, seed: int = 0,
                 action_repeat: int = 1, deterministic: bool = True) -> float:
    """True sparse tag rate of a GRU policy: the share of `episodes` parallel
    episodes that end in a tag (a done with reward > 0.5) before any other
    end. Stops once every episode has ended; the rate is then final."""
    env = wrappers.ActionRepeatWrapper(env_core, action_repeat)
    env = wrappers.EpisodeWrapper(env, episode_length, 1)
    env = wrappers.VmapWrapper(env, batch_size=episodes)
    k_reset, key = jr.split(jr.PRNGKey(seed, env.device), 2).unbind(-2)
    state = env.reset(jr.split(k_reset, episodes))
    h = torch.zeros(episodes, hidden_size, device=env.device)
    alive = torch.ones(episodes, device=env.device)
    tagged = torch.zeros_like(alive)
    for t in range(episode_length):
        key, k = jr.split(key, 2).unbind(-2)
        h, act = inference_fn(params, h, state.obs, k, deterministic=deterministic)
        state = env.step(state, act)
        tag = state.done * alive * (state.reward > 0.5)
        tagged = torch.maximum(tagged, tag)
        alive = alive * (1.0 - state.done)
        if t % 10 == 9 and not bool(alive.any()):
            break
    return float(tagged.mean())


def main(npz: str = DEFAULT_NPZ, device: Optional[str] = None, episodes: int = 256) -> dict:
    learner, ts, same = load(npz, device)
    if not same:
        raise RuntimeError(f"{npz}: the loaded parameters do not match their checksum")
    inference_fn = learner.make_inference_fn()
    params = (ts.normalizer, ts.params)
    dev = learner.device
    det = tag_rate_rnn(AntTagEnv(device=dev), inference_fn, params, HIDDEN, episodes,
                       action_repeat=ACTION_REPEAT)
    stoch = tag_rate_rnn(AntTagEnv(device=dev), inference_fn, params, HIDDEN, episodes,
                         action_repeat=ACTION_REPEAT, seed=1, deterministic=False)
    result = {"npz": npz, "epochs": ts.epochs, "checksum_ok": same,
              "true_tag_rate_det": det, "true_tag_rate_stoch": stoch}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("npz", nargs="?", default=DEFAULT_NPZ)
    parser.add_argument("--device", default=None)
    parser.add_argument("--episodes", type=int, default=256)
    args = parser.parse_args()
    main(args.npz, args.device, args.episodes)
