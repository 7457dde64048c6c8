"""Entry points: a one-card forward step and a multi-rank dry run; the
counterparts of `__graft_entry__.py`'s `entry()` and `dryrun_multichip`.

`entry()` returns the framework's hottest step: a policy forward, a sample
and one `env.step` of a 256-env AntTag batch (the whole-step kernel on the
card). `dryrun_multichip(n)` runs JAX's five dry-run phases on n local ranks
of a 'data' mesh (`parallel.mesh.spawn`) at the same tiny shapes, each
rank holding its block of the env batch: PPO on AntTag, PPO on
inverted_pendulum (JAX's "fused path" phase; here the kernel is the only
step there is), GRU-PPO, two epochs a call, and GRU-SAC with prioritized
replay. Each phase prints a `dryrun_multichip ok (...)` line with its
metrics on rank 0 and checks that every rank holds bit-equal parameters.

    python -m pobrax_tpu_torch.graft_entry [--device cpu]   # entry(), then dryrun_multichip(2)
"""

from __future__ import annotations

import argparse
from typing import Dict, List

import torch
import torch.distributed as dist

from pobrax_tpu_torch import random as jr
from pobrax_tpu_torch.parallel.mesh import Mesh, replicate, spawn

BATCH = 256


def entry(device=None):
    """(forward_step, (policy, state, key)): `forward_step(policy, state, key)`
    samples an action from the policy MLP and steps a 256-env AntTag batch
    (autoreset, randomised) on `device`, the card unless named."""
    from pobrax_tpu_torch.envs import create
    from pobrax_tpu_torch.models import networks
    from pobrax_tpu_torch.training.distribution import NormalTanhDistribution

    env = create("ant_tag", episode_length=1000, batch_size=BATCH, auto_reset=True,
                 randomized_autoreset=True, device=device)
    dist_ = NormalTanhDistribution(event_size=env.action_size)
    key = jr.PRNGKey(0, env.device)
    policy = networks.make_model([32, 32, 32, 32, dist_.param_size], env.observation_size,
                                 key=key, device=env.device)
    state = env.reset(jr.split(key, BATCH))

    @torch.no_grad()
    def forward_step(policy, state, key):
        return env.step(state, dist_.sample(policy(state.obs), key))

    return forward_step, (policy, state, key)


def assert_replicated(module: torch.nn.Module, mesh: Mesh, what: str) -> None:
    """Raises unless every rank holds bit-equal parameters in `module`."""
    flat = torch.cat([p.detach().reshape(-1) for p in module.parameters()])
    if mesh.group is None:
        return
    gathered = [torch.empty_like(flat) for _ in range(mesh.data)]
    dist.all_gather(gathered, flat, group=mesh.group)
    for rank, other in enumerate(gathered):
        if not torch.equal(other, flat):
            raise AssertionError(f"{what}: rank {rank}'s parameters differ from rank "
                                 f"{mesh.rank}'s")


def _report(mesh: Mesh, label: str, metrics, out: Dict[str, Dict[str, float]]) -> None:
    floats = {k: float(v) for k, v in metrics.items()}
    out[label] = floats
    if mesh.rank == 0:
        print(f"dryrun_multichip ok ({label}):", floats, flush=True)


def _dryrun_rank(mesh: Mesh) -> Dict[str, Dict[str, float]]:
    """The five phases on this rank; returns each phase's metrics."""
    from pobrax_tpu_torch.envs import create, wrappers
    from pobrax_tpu_torch.envs.ant_tag import AntTagEnv
    from pobrax_tpu_torch.training import ppo, ppo_rnn, sac_rnn

    if mesh.device.type == "cpu":
        torch.set_num_threads(1)
    dev, n = mesh.device, mesh.data
    num_envs = 2 * n
    local = num_envs // n
    cfg = ppo.PPOConfig(num_envs=num_envs, episode_length=16, unroll_length=4,
                        num_minibatches=2, num_update_epochs=1)

    def wrapped_ant_tag():
        env = wrappers.EpisodeWrapper(AntTagEnv(device=dev), cfg.episode_length, 1)
        return wrappers.RandomizedAutoResetWrapperNaive(wrappers.VmapWrapper(env, local))

    key = jr.PRNGKey(0, dev)
    _, k_init, k_reset, k_epoch = jr.split(key, 4).unbind(-2)
    out: Dict[str, Dict[str, float]] = {}

    # 1. PPO on AntTag: env batch on 'data', the training state replicated
    env = wrapped_ant_tag()
    learner = ppo.PPOLearner(env, cfg, mesh)
    ts = replicate(learner.init(k_init), mesh)
    state = ppo.reset_block(env, k_reset, num_envs, mesh)
    ts, state, metrics = learner.epoch(ts, state, k_epoch)
    assert_replicated(ts.params, mesh, "PPO on ant_tag")
    _report(mesh, "PPO, ant_tag", metrics, out)

    # 2. PPO on inverted_pendulum through the factory's wrapper stack
    fenv = create("inverted_pendulum", episode_length=cfg.episode_length, batch_size=local,
                  auto_reset=True, randomized_autoreset=True, device=dev)
    flearner = ppo.PPOLearner(fenv, cfg, mesh)
    fts = replicate(flearner.init(k_init), mesh)
    fstate = ppo.reset_block(fenv, k_reset, num_envs, mesh)
    fts, fstate, metrics = flearner.epoch(fts, fstate, k_epoch)
    assert_replicated(fts.params, mesh, "PPO on inverted_pendulum")
    _report(mesh, "PPO, inverted_pendulum", metrics, out)

    # 3. GRU-PPO: the env batch and the hidden state on 'data'
    rcfg = ppo_rnn.RNNPPOConfig(num_envs=num_envs, episode_length=16, unroll_length=4,
                                num_minibatches=2, num_update_epochs=1, encoder_sizes=(16,),
                                hidden_size=8)
    renv = wrapped_ant_tag()
    rlearner = ppo_rnn.RNNPPOLearner(renv, rcfg, mesh)
    rts = replicate(rlearner.init(k_init), mesh)
    rstate = ppo.reset_block(renv, k_reset, num_envs, mesh)
    rts, rstate, _, metrics = rlearner.epoch(rts, rstate, rlearner.h0(local), k_epoch)
    assert_replicated(rts.params, mesh, "GRU-PPO")
    _report(mesh, "RNN-PPO, ant_tag", metrics, out)

    # 4. two epochs a call, the key threaded through them (`run_epochs`)
    history: List[dict] = []
    sts = replicate(learner.init(k_init), mesh)
    sstate = ppo.reset_block(env, k_reset, num_envs, mesh)
    sts, _, _ = ppo.run_epochs(learner, sts, (sstate,), k_epoch, 1, 0,
                               lambda s, m: history.append(m), None, 0,
                               watchdog_deadline_s=None, epochs_per_call=2)
    assert_replicated(sts.params, mesh, "epochs_per_call=2")
    _report(mesh, "epochs_per_call=2, ant_tag",
            {k: v for k, v in history[0].items() if k not in ("rollout_ms", "update_ms",
                                                               "steps_per_second")}, out)

    # 5. GRU-SAC: env batch, hidden states, replay columns and the PER table
    # on 'data'; the learner replicated through the gradient means
    qcfg = sac_rnn.RSACConfig(num_envs=num_envs, episode_length=16, seq_len=4, burn_in=1,
                              replay_capacity=8, batch_size=num_envs, seqs_per_epoch=2,
                              min_replay=1, per_alpha=0.9, encoder_sizes=(16,), hidden_size=8,
                              head_sizes=(16,))
    qenv = wrapped_ant_tag()
    qlearner = sac_rnn.RSACLearner(qenv, qcfg, mesh)
    qts = replicate(qlearner.init(k_init), mesh)
    qstate = ppo.reset_block(qenv, k_reset, num_envs, mesh)
    qh = qlearner.h0(local)
    for _ in range(2):
        qts, qstate, qh, metrics = qlearner.epoch(qts, qstate, qh, k_epoch)
    assert_replicated(qts.params, mesh, "GRU-SAC")
    if tuple(qts.priorities.shape) != (qcfg.replay_capacity, local):
        raise AssertionError(f"GRU-SAC: PER table {tuple(qts.priorities.shape)}, not "
                             f"{(qcfg.replay_capacity, local)}")
    _report(mesh, "GRU-SAC + PER, ant_tag", metrics, out)
    return out


def dryrun_multichip(n_ranks: int, device=None, backend: str = "gloo",
                     timeout: float = 900.0) -> List[Dict[str, Dict[str, float]]]:
    """The five phases on `n_ranks` local ranks (`device`: the card unless
    named; "gloo" lets the ranks share one card or run on the CPU, "nccl"
    needs a card per rank). Returns each rank's metrics per phase; raises if
    a rank fails, the ranks' parameters or metrics differ, or they outlast
    `timeout` seconds."""
    if device is None:
        from pobrax_tpu_torch.device import resolve
        device = str(resolve(None))
    results = spawn(_dryrun_rank, n_ranks, backend, device, timeout=timeout)
    for rank, r in enumerate(results[1:], 1):
        if r != results[0]:
            raise AssertionError(f"rank {rank}'s metrics differ from rank 0's: {r} != "
                                 f"{results[0]}")
    return results


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None, help="the card unless named")
    args = parser.parse_args(argv)
    fn, call_args = entry(args.device)
    out = fn(*call_args)
    print("entry ok:", tuple(out.obs.shape), flush=True)
    dryrun_multichip(2, device=args.device)


if __name__ == "__main__":
    main()
