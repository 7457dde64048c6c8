"""The JAX package's tag rates of a committed AntTag checkpoint at several
reset seeds: the reference column beside the PyTorch port's
(`python -m pobrax_tpu_torch.eval_tag_checkpoint --seeds ...`).

Restores the checkpoint as tools/eval_tag_checkpoint.py does and measures
the true sparse tag rate exactly as `tag_rate_rnn` of
examples/train_ant_tag_rnn.py does (the same wrappers, key splits and
per-step policy calls), deterministic and stochastic, at each seed. The
step runs under `jax.jit` in a host loop that stops once every episode has
ended, where the rate can no longer change, instead of scanning all 1000
steps: on the CPU a step of 256 envs at 60 substeps takes a large part of a
second. Prints one JSON line per (seed, mode) and a summary line.

Usage: python tools/eval_tag_checkpoint_seeds.py [--ckpt DIR] [--seeds 0 1 2 3 4]
       [--episodes 256] [--radius R] [--modes det stoch]
(--radius: default the env's own visible radius, as
tools/eval_tag_checkpoint.py evaluates ant_tag_rnn_900M; a `--ckpt` whose
name holds "sac" loads a GRU-SAC checkpoint, e.g.
--ckpt checkpoints/ant_tag_sac_rnn_phase0_750M --radius 20 --modes stoch)
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
from pobrax_tpu.training import ppo_rnn, sac_rnn  # noqa: E402

HIDDEN = 128


def load(ckpt_dir):
    """(inference_fn, params_tuple) of a GRU-PPO or a GRU-SAC checkpoint."""
    core = _envs["ant_tag"]()
    env = wrappers.VmapWrapper(wrappers.EpisodeWrapper(
        wrappers.ActionRepeatWrapper(core, HAI_ACTION_REPEAT), 1000, 1), batch_size=8)
    path = ckpt.latest_step_dir(ckpt_dir) or ckpt_dir
    if "sac" in ckpt_dir:
        cfg = sac_rnn.RSACConfig(num_envs=8, replay_capacity=1, hidden_size=HIDDEN,
                                 encoder_sizes=(256,), head_sizes=(256,))
        learner = sac_rnn.RSACLearner(env, cfg)
        ts = learner.init(jax.random.PRNGKey(0), jax.jit(env.reset)(
            jax.random.split(jax.random.PRNGKey(0), 8)))
        ts = ts.replace(**ckpt.restore(path, template=sac_rnn._ckpt_slice(ts)))
        return learner.make_inference_fn(), (ts.normalizer, ts.params.policy)
    cfg = ppo_rnn.RNNPPOConfig(num_envs=8, num_minibatches=8, hidden_size=HIDDEN,
                               encoder_sizes=(256,))
    learner = ppo_rnn.RNNPPOLearner(env, cfg)
    ts = ckpt.restore(path, template=learner.init(jax.random.PRNGKey(0)))
    return learner.make_inference_fn(), (ts.normalizer, ts.params)


def tag_rate(inference_fn, params, radius, episodes, seed, deterministic):
    """tag_rate_rnn's measurement, stepping until every episode has ended."""
    core = _envs["ant_tag"](**({} if radius is None else {"visible_radius": radius}))
    env = wrappers.ActionRepeatWrapper(core, HAI_ACTION_REPEAT)
    env = wrappers.EpisodeWrapper(env, 1000, 1)
    env = wrappers.VmapWrapper(env, batch_size=episodes)

    @jax.jit
    def start(key):
        k_reset, k_act = jax.random.split(key)
        state = env.reset(jax.random.split(k_reset, episodes))
        return (state, jnp.zeros((episodes, HIDDEN)), jnp.ones(episodes), jnp.zeros(episodes),
                k_act)

    @jax.jit
    def body(carry):
        state, h, alive, tagged, key = carry
        key, k = jax.random.split(key)
        h, act = inference_fn(params, h, state.obs, k, deterministic=deterministic)
        state = env.step(state, act)
        tag = state.done * alive * (state.reward > 0.5)
        return state, h, alive * (1.0 - state.done), jnp.maximum(tagged, tag), key

    carry = start(jax.random.PRNGKey(seed))
    steps = 0
    for steps in range(1, 1001):
        carry = body(carry)
        if steps % 10 == 0 and not bool(carry[2].any()):
            break
    return float(carry[3].mean()), steps


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ckpt", default="checkpoints/ant_tag_rnn_900M")
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    parser.add_argument("--episodes", type=int, default=256)
    parser.add_argument("--radius", type=float, default=None)
    parser.add_argument("--modes", nargs="+", choices=("det", "stoch"), default=["det", "stoch"])
    args = parser.parse_args()
    inference_fn, params = load(args.ckpt)
    rates = {m: [] for m in args.modes}
    for seed in args.seeds:
        for mode in args.modes:
            t0 = time.perf_counter()
            rate, steps = tag_rate(inference_fn, params, args.radius, args.episodes, seed,
                                   mode == "det")
            rates[mode].append(rate)
            print(json.dumps({"ckpt": args.ckpt, "radius": args.radius, "seed": seed,
                              "mode": mode, "episodes": args.episodes, "tag_rate": rate,
                              "control_steps": steps,
                              "seconds": round(time.perf_counter() - t0, 1)}), flush=True)
    print(json.dumps({"ckpt": args.ckpt, "radius": args.radius, "seeds": args.seeds,
                      "episodes": args.episodes, **{
                          f"{m}_{k}": f(v) for m, v in rates.items()
                          for k, f in (("mean", lambda x: sum(x) / len(x)),
                                       ("min", min), ("max", max))}}), flush=True)


if __name__ == "__main__":
    main()
