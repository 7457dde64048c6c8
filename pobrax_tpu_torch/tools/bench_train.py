"""Steady-state TRAINING throughput of the port: env-steps/s through whole
learner epochs on one card; the port of `tools/bench_train.py`.

Three programs, each at the JAX tool's recorded config (the learner configs
equal its field for field, `ppo_config`, `rnn_config`, `sac_rnn_config`):
  * `bench_train`: PPO on AntTag at 4096 envs, unroll 16, 32 minibatches x
    4 update epochs, cached autoreset, bfloat16 networks;
  * `bench_train_rnn` (TRAIN_PROGRAM=rnn): GRU-PPO at 2048 envs, unroll 32,
    8 minibatches x 4;
  * `bench_train_sac_rnn` (TRAIN_PROGRAM=sac_rnn): GRU-SAC on AntHeavenHell
    at 512 envs, action_repeat 6, naive autoreset.
Each runs one warm-up call (kernel build, allocations: the record's
`compile_s`), then the best of `repeats` timed calls of `epochs_per_call`
epochs, each call closed by reading its losses (which waits for the card).
Env-steps a call = unroll x envs x action_repeat x epochs, as JAX counts them.

TRAIN_FLATTEN=0 passes `flatten_optimizer=False` to PPO, as the JAX tool
does: the same update, with the Adam state in optax's per-leaf layout
(`training/optimizer.py`).

Usage: python -m pobrax_tpu_torch.tools.bench_train [env_name]
Env overrides, as the JAX tool's: TRAIN_BATCH, TRAIN_UNROLL, TRAIN_MB,
TRAIN_EPOCHS, TRAIN_AUTORESET, TRAIN_DTYPE, TRAIN_REPEATS, TRAIN_EPC,
TRAIN_FLATTEN, TRAIN_SUBSTEPS, TRAIN_PROGRAM (rnn | sac_rnn | all);
TRAIN_PROGRAM=all writes the three records to TRAINBENCH_OUT
(runs/trainbench_torch.json by default). Every record carries the device
and the card's name and power limit. On the card; with no card and no
device named it raises.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Callable, Optional

import torch

from pobrax_tpu_torch import random as jr
from pobrax_tpu_torch.device import resolve
from pobrax_tpu_torch.envs import HAI_ACTION_REPEAT, _envs
from pobrax_tpu_torch.examples._common import make_parent, run_path
from pobrax_tpu_torch.training import ppo, ppo_rnn, sac_rnn
from pobrax_tpu_torch.utils.profiling import record_device

DEFAULT_OUT = run_path("trainbench_torch.json")


def ppo_config(batch: int = 4096, unroll: int = 16, minibatches: int = 32,
               update_epochs: int = 4, dtype: str = "bfloat16",
               epochs_per_call: int = 1, flatten: bool = True) -> ppo.PPOConfig:
    return ppo.PPOConfig(num_envs=batch, episode_length=1000, unroll_length=unroll,
                         num_minibatches=minibatches, num_update_epochs=update_epochs,
                         network_dtype=dtype, flatten_optimizer=flatten,
                         epochs_per_call=epochs_per_call)


def rnn_config(batch: int = 2048, unroll: int = 32, minibatches: int = 8, update_epochs: int = 4,
               epochs_per_call: int = 1) -> ppo_rnn.RNNPPOConfig:
    return ppo_rnn.RNNPPOConfig(num_envs=batch, episode_length=1000, unroll_length=unroll,
                                num_minibatches=minibatches, num_update_epochs=update_epochs,
                                epochs_per_call=epochs_per_call)


def sac_rnn_config(batch: int = 512, seq_len: int = 32, burn_in: int = 8, batch_size: int = 128,
                   seqs_per_epoch: int = 4, grad_steps: int = 2) -> sac_rnn.RSACConfig:
    return sac_rnn.RSACConfig(num_envs=batch, episode_length=1000,
                              action_repeat=HAI_ACTION_REPEAT, seq_len=seq_len, burn_in=burn_in,
                              replay_capacity=192, batch_size=batch_size,
                              seqs_per_epoch=seqs_per_epoch, grad_steps_per_seq=grad_steps,
                              min_replay=1, nstep=5, hidden_size=128, encoder_sizes=(256,),
                              head_sizes=(256,))


def _core(env_name: str, dev: torch.device, substeps: int = 0):
    env = _envs[env_name](device=dev)
    if substeps:
        env.retune_substeps(substeps)
    return env


def _split2(key: torch.Tensor):
    return jr.split(key, 2).unbind(-2)


def time_calls(run_call: Callable, key: torch.Tensor, repeats: int,
               steps_per_call: int) -> tuple:
    """One warm-up call, then `repeats` timed ones; `run_call(key) -> key`
    must end by reading a value of its last epoch to the host. -> (first
    call's seconds, best env-steps/s, each call's env-steps/s)."""
    t0 = time.perf_counter()
    key = run_call(key)
    first_s = time.perf_counter() - t0
    runs = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        key = run_call(key)
        runs.append(steps_per_call / (time.perf_counter() - t0))
    return first_s, max(runs), runs


def _epochs_call(learner, carry: list, epc: int, loss: str) -> Callable:
    """`run_call` of `epc` epochs of `learner` on `carry` = [ts, env_state,
    (h)], with JAX's key stream (`key, k = split(key)` an epoch)."""
    def run_call(key):
        for _ in range(epc):
            key, k = _split2(key)
            ts, *rest, metrics = learner.epoch(*carry, k)
            carry[:] = [ts, *rest]
        float(metrics[loss])  # waits for the card
        return key
    return run_call


def bench_train(env_name: str = "ant_tag", batch: int = 4096, unroll: int = 16,
                minibatches: int = 32, update_epochs: int = 4, autoreset: str = "cached",
                dtype: str = "bfloat16", repeats: int = 3, flatten: bool = True,
                epochs_per_call: int = 1, device=None, substeps: Optional[int] = None) -> dict:
    """PPO's epochs at the JAX tool's recorded config -> its record."""
    dev = resolve(device)
    if substeps is None:
        substeps = int(os.environ.get("TRAIN_SUBSTEPS", "0"))
    epc = max(1, epochs_per_call)
    cfg = ppo_config(batch, unroll, minibatches, update_epochs, dtype, epc, flatten)
    wrapped = ppo.wrap_for_training(_core(env_name, dev, substeps), cfg, autoreset)
    learner = ppo.PPOLearner(wrapped, cfg)
    key, k_init, k_reset = jr.split(jr.PRNGKey(0, dev), 3).unbind(-2)
    carry = [learner.init(k_init), wrapped.reset(jr.split(k_reset, batch))]
    steps_per_call = unroll * batch * cfg.action_repeat * epc
    first_s, best, runs = time_calls(_epochs_call(learner, carry, epc, "total_loss"), key,
                                     repeats, steps_per_call)
    return {"metric": f"{env_name} TRAIN env-steps/s/chip @ {batch} envs",
            "value": round(best, 1), "unit": "env_steps/s/chip",
            "autoreset": autoreset, "network_dtype": dtype,
            "unroll": unroll, "minibatches": minibatches,
            "update_epochs": update_epochs, "flatten_optimizer": flatten,
            "epochs_per_call": epc, "compile_s": round(first_s, 1),
            "runs": [round(r, 1) for r in runs], **record_device(dev)}


def bench_train_rnn(env_name: str = "ant_tag", batch: int = 2048, unroll: int = 32,
                    minibatches: int = 8, update_epochs: int = 4, autoreset: str = "cached",
                    repeats: int = 3, epochs_per_call: int = 1, device=None) -> dict:
    """GRU-PPO's epochs (TRAIN_PROGRAM=rnn) -> its record."""
    dev = resolve(device)
    epc = max(1, epochs_per_call)
    cfg = rnn_config(batch, unroll, minibatches, update_epochs, epc)
    wrapped = ppo.wrap_for_training(_core(env_name, dev), cfg, autoreset)
    learner = ppo_rnn.RNNPPOLearner(wrapped, cfg)
    key, k_init, k_reset = jr.split(jr.PRNGKey(0, dev), 3).unbind(-2)
    carry = [learner.init(k_init), wrapped.reset(jr.split(k_reset, batch)), learner.h0(batch)]
    steps_per_call = unroll * batch * cfg.action_repeat * epc
    first_s, best, runs = time_calls(_epochs_call(learner, carry, epc, "total_loss"), key,
                                     repeats, steps_per_call)
    return {"metric": f"{env_name} RNN TRAIN env-steps/s/chip @ {batch} envs",
            "value": round(best, 1), "unit": "env_steps/s/chip",
            "autoreset": autoreset, "unroll": unroll,
            "minibatches": minibatches, "update_epochs": update_epochs,
            "epochs_per_call": epc, "compile_s": round(first_s, 1),
            "runs": [round(r, 1) for r in runs], **record_device(dev)}


def bench_train_sac_rnn(env_name: str = "ant_heavenhell", batch: int = 512, seq_len: int = 32,
                        burn_in: int = 8, batch_size: int = 128, seqs_per_epoch: int = 4,
                        grad_steps: int = 2, autoreset: str = "naive", repeats: int = 3,
                        device=None) -> dict:
    """GRU-SAC's epochs (TRAIN_PROGRAM=sac_rnn) -> its record; env-steps an
    epoch = seqs_per_epoch x seq_len x envs x action_repeat."""
    dev = resolve(device)
    cfg = sac_rnn_config(batch, seq_len, burn_in, batch_size, seqs_per_epoch, grad_steps)
    wrapped = sac_rnn.wrap_for_training(_core(env_name, dev), cfg, autoreset)
    learner = sac_rnn.RSACLearner(wrapped, cfg)
    key, k_init, k_reset = jr.split(jr.PRNGKey(0, dev), 3).unbind(-2)
    env_state = wrapped.reset(jr.split(k_reset, batch))
    carry = [learner.init(k_init), env_state, learner.h0(batch)]
    steps_per_call = seqs_per_epoch * seq_len * batch * cfg.action_repeat
    first_s, best, runs = time_calls(_epochs_call(learner, carry, 1, "q_loss"), key, repeats,
                                     steps_per_call)
    return {"metric": f"{env_name} SAC-RNN TRAIN env-steps/s/chip @ {batch} envs",
            "value": round(best, 1), "unit": "env_steps/s/chip",
            "autoreset": autoreset, "seq_len": seq_len, "burn_in": burn_in,
            "batch_size": batch_size, "seqs_per_epoch": seqs_per_epoch,
            "grad_steps_per_seq": grad_steps, "nstep": 5,
            "compile_s": round(first_s, 1), "runs": [round(r, 1) for r in runs],
            **record_device(dev)}


def main_all(out_path: str = DEFAULT_OUT, device=None, epochs_per_call: Optional[int] = None,
             repeats: int = 3) -> dict:
    """All three programs back to back on one card; writes their record to
    `out_path` (runs/, never the JAX package's TRAINBENCH_r05.json) and
    prints each program's rate."""
    epc = epochs_per_call or int(os.environ.get("TRAIN_EPC", "32"))
    results = {"ppo": bench_train(epochs_per_call=epc, repeats=repeats, device=device),
               "ppo_rnn": bench_train_rnn(epochs_per_call=epc, repeats=repeats, device=device),
               "sac_rnn": bench_train_sac_rnn(repeats=repeats, device=device)}
    record = {"unit": "env_steps/s/chip", **record_device(resolve(device)),
              "programs": {k: {"value": v["value"], "metric": v["metric"],
                               "config": {kk: vv for kk, vv in v.items()
                                          if kk not in ("value", "metric", "unit")}}
                           for k, v in results.items()}}
    with open(make_parent(out_path), "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps({k: v["value"] for k, v in results.items()}))
    print(f"# wrote {out_path}", flush=True)
    return record


def main(argv=None, environ: Optional[dict] = None, device=None) -> dict:
    """The JAX tool's command line: TRAIN_PROGRAM picks the program; prints
    its JSON record and returns it."""
    argv = sys.argv[1:] if argv is None else argv
    env_vars = os.environ if environ is None else environ
    program = env_vars.get("TRAIN_PROGRAM")
    if program == "all":
        return main_all(env_vars.get("TRAINBENCH_OUT", DEFAULT_OUT), device)
    if program == "sac_rnn":
        out = bench_train_sac_rnn(
            env_name=argv[0] if argv else "ant_heavenhell",
            batch=int(env_vars.get("TRAIN_BATCH", "512")),
            repeats=int(env_vars.get("TRAIN_REPEATS", "3")), device=device)
    elif program == "rnn":
        out = bench_train_rnn(
            env_name=argv[0] if argv else "ant_tag",
            batch=int(env_vars.get("TRAIN_BATCH", "2048")),
            unroll=int(env_vars.get("TRAIN_UNROLL", "32")),
            minibatches=int(env_vars.get("TRAIN_MB", "8")),
            update_epochs=int(env_vars.get("TRAIN_EPOCHS", "4")),
            autoreset=env_vars.get("TRAIN_AUTORESET", "cached"),
            repeats=int(env_vars.get("TRAIN_REPEATS", "3")),
            epochs_per_call=int(env_vars.get("TRAIN_EPC", "1")), device=device)
    else:
        out = bench_train(
            env_name=argv[0] if argv else "ant_tag",
            batch=int(env_vars.get("TRAIN_BATCH", "4096")),
            unroll=int(env_vars.get("TRAIN_UNROLL", "16")),
            minibatches=int(env_vars.get("TRAIN_MB", "32")),
            update_epochs=int(env_vars.get("TRAIN_EPOCHS", "4")),
            autoreset=env_vars.get("TRAIN_AUTORESET", "cached"),
            dtype=env_vars.get("TRAIN_DTYPE", "bfloat16"),
            repeats=int(env_vars.get("TRAIN_REPEATS", "3")),
            flatten=env_vars.get("TRAIN_FLATTEN", "1") == "1",
            epochs_per_call=int(env_vars.get("TRAIN_EPC", "1")), device=device,
            substeps=int(env_vars.get("TRAIN_SUBSTEPS", "0")))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
