"""The JAX package's evaluation of a committed AntGather or AntMaze GRU-PPO
checkpoint at several reset seeds: the reference column beside the PyTorch
port's (`python -m pobrax_tpu_torch.eval_checkpoint --gather|--gather-bombmem|--maze
--seeds ...`).

Restores the checkpoint as tools/render_gather_policy.py does and measures
exactly what the examples' evaluators measure (the same wrappers, key
splits and per-step policy calls): for AntGather `gather_eval` of
examples/train_ant_gather_rnn.py (mean apples and bombs caught per episode
on the true env), for AntMaze `goal_rate_rnn` of
examples/train_ant_maze_rnn.py (the share of episodes that end at the goal),
deterministic and stochastic, at each seed. The step runs under `jax.jit` in
a host loop that stops once every episode has ended, where the numbers can
no longer change, instead of scanning all 1000 steps. Prints one JSON line
per (seed, mode) and a summary line.

Usage: python tools/eval_gather_checkpoint_seeds.py [--ckpt DIR] [--seeds 0 1 2 3 4]
       [--episodes 256] [--modes det stoch]
(a `--ckpt` whose name holds "maze" is evaluated on AntMaze, any other on
AntGather)
"""

import argparse
import json
import sys
import time

import jax
import jax.numpy as jnp

sys.path.insert(0, ".")

from pobrax_tpu.envs import HAI_ACTION_REPEAT, _envs, wrappers  # noqa: E402
from pobrax_tpu.training import checkpoint as ckpt  # noqa: E402
from pobrax_tpu.training import ppo_rnn  # noqa: E402

HIDDEN = 128  # examples/train_ant_gather_rnn.py's and train_ant_maze_rnn.py's


def env_name(ckpt_dir):
    return "ant_maze" if "maze" in ckpt_dir else "ant_gather"


def load(ckpt_dir):
    """(inference_fn, params_tuple) of a GRU-PPO checkpoint."""
    core = _envs[env_name(ckpt_dir)]()
    env = wrappers.VmapWrapper(wrappers.EpisodeWrapper(
        wrappers.ActionRepeatWrapper(core, HAI_ACTION_REPEAT), 1000, 1), batch_size=8)
    cfg = ppo_rnn.RNNPPOConfig(num_envs=8, num_minibatches=8, hidden_size=HIDDEN,
                               encoder_sizes=(256,))
    learner = ppo_rnn.RNNPPOLearner(env, cfg)
    path = ckpt.latest_step_dir(ckpt_dir) or ckpt_dir
    ts = ckpt.restore(path, template=learner.init(jax.random.PRNGKey(0)))
    return learner.make_inference_fn(), (ts.normalizer, ts.params)


def evaluate(name, inference_fn, params, episodes, seed, deterministic):
    """gather_eval's (apples, bombs) or goal_rate_rnn's (goal rate,), and the
    control steps run."""
    env = wrappers.ActionRepeatWrapper(_envs[name](), HAI_ACTION_REPEAT)
    env = wrappers.EpisodeWrapper(env, 1000, 1)
    env = wrappers.VmapWrapper(env, batch_size=episodes)
    z = jnp.zeros(episodes)

    @jax.jit
    def start(key):
        k_reset, k_act = jax.random.split(key)
        state = env.reset(jax.random.split(k_reset, episodes))
        return state, jnp.zeros((episodes, HIDDEN)), jnp.ones(episodes), z, z, k_act

    @jax.jit
    def body(carry):
        state, h, alive, a, b, key = carry
        key, k = jax.random.split(key)
        h, act = inference_fn(params, h, state.obs, k, deterministic=deterministic)
        state = env.step(state, act)
        if name == "ant_maze":
            a = jnp.maximum(a, state.done * alive * (state.reward > 1.0))
        else:
            a = a + alive * state.metrics["apples"]
            b = b + alive * state.metrics["bombs"]
        return state, h, alive * (1.0 - state.done), a, b, key

    carry = start(jax.random.PRNGKey(seed))
    steps = 0
    for steps in range(1, 1001):
        carry = body(carry)
        if steps % 10 == 0 and not bool(carry[2].any()):
            break
    if name == "ant_maze":
        return {"goal_rate": float(carry[3].mean())}, steps
    apples, bombs = float(carry[3].mean()), float(carry[4].mean())
    return {"apples": apples, "bombs": bombs, "net": apples - bombs}, steps


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ckpt", default="checkpoints/ant_gather_rnn_800M")
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    parser.add_argument("--episodes", type=int, default=256)
    parser.add_argument("--modes", nargs="+", choices=("det", "stoch"), default=["det", "stoch"])
    args = parser.parse_args()
    name = env_name(args.ckpt)
    inference_fn, params = load(args.ckpt)
    values = {}
    for seed in args.seeds:
        for mode in args.modes:
            t0 = time.perf_counter()
            got, steps = evaluate(name, inference_fn, params, args.episodes, seed, mode == "det")
            for k, v in got.items():
                values.setdefault(f"{mode}_{k}", []).append(v)
            print(json.dumps({"ckpt": args.ckpt, "env": name, "seed": seed, "mode": mode,
                              "episodes": args.episodes, **got, "control_steps": steps,
                              "seconds": round(time.perf_counter() - t0, 1)}), flush=True)
    print(json.dumps({"ckpt": args.ckpt, "env": name, "seeds": args.seeds,
                      "episodes": args.episodes, **{
                          f"{k}_{s}": f(v) for k, v in values.items()
                          for s, f in (("mean", lambda x: sum(x) / len(x)),
                                       ("min", min), ("max", max))}}), flush=True)


if __name__ == "__main__":
    main()
