"""Soft Actor-Critic; the port of `pobrax_tpu/training/sac.py`.

Twin Q critics (two independent MLPs), a tanh-normal actor, a learned
entropy temperature and a device-resident ring replay buffer
(`training/replay.py`). One epoch: `steps_per_epoch` env steps, each
inserting one transition slot (num_envs columns) and, once the buffer holds
`min_replay` slots, taking `grad_steps_per_env_step` gradient steps on
`batch_size` single transitions.

Keys follow the JAX learner's splits one for one:
  * per env step `key, k_act, k_grad = split(key, 3)`;
  * grad step i draws from `fold_in(k_grad, i)` -> `k1, k2, k3 = split(., 3)`:
    k1 the transitions (`sample_transitions` splits it into slot and
    column), k2 the critic target's next action, k3 the actor's action.
Below `min_replay` no grad step runs (JAX's `lax.cond` skips them; the key
was split all the same).

The actor and the temperature read the critic as it was before this step's
critic update, as in JAX, where every loss takes the step's old parameters;
the target critics move by `t * (1 - tau) + o * tau` after the update. The
observation statistics take each step's observations after its transition
is stored and before its gradient steps.

Parameters live in `nn.Module`s and are updated in place; the three Adam
states are flat vectors (`training/optimizer.py`, no clipping), which
`pobrax_tpu_torch.interop` maps to and from JAX's `optax.flatten(adam)`
states. Beyond JAX's `sac.train`, `train` checkpoints and resumes as the
recurrent learner does (`checkpoint_dir`; the replay buffer is not saved and
refills through `min_replay`).

Data parallelism (`mesh`, `parallel/mesh.py`): JAX runs the epoch under
`shard_map`, so the semantics are per shard, and so are the port's ranks.
Rank d holds `num_envs / D` envs (its block of the global reset) and their
replay columns; it folds d into the epoch key (`fold_in(key, d)`), steps its
envs, fills its own buffer and draws `batch_size / D` of its own
transitions. The only collectives are the mean of the q, actor and
temperature gradients (`Optimizer.step(..., mesh)`), the statistics' sums
(`running_statistics.update(..., mesh)`) and, once an epoch, the mean of
q_loss, actor_loss and mean_reward over the ranks.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from pobrax_tpu_torch import random as jr
from pobrax_tpu_torch.envs.base import Env, State
from pobrax_tpu_torch.models import networks
from pobrax_tpu_torch.parallel import health
from pobrax_tpu_torch.parallel.mesh import Mesh, pmean
from pobrax_tpu_torch.training import replay, running_statistics
from pobrax_tpu_torch.training.distribution import NormalTanhDistribution
from pobrax_tpu_torch.training.optimizer import AdamState, Optimizer
from pobrax_tpu_torch.training.ppo import _split2, reset_block, resume, run_epochs


class Scalar(nn.Module):
    """One learnable scalar (the log temperature), so the flat Adam can step
    it like any module."""

    def __init__(self, value: float = 0.0, device=None):
        super().__init__()
        self.value = nn.Parameter(torch.full((), float(value), device=device))


class TwinMLP(nn.Module):
    """Two independent MLP critics on the same input; (..., 2), the critic
    axis last (JAX: stacked parameters, vmapped apply)."""

    def __init__(self, layer_sizes: Sequence[int], in_size: int, keys, device=None):
        super().__init__()
        self.critics = nn.ModuleList(networks.MLP(layer_sizes, in_size, F.relu, key=k,
                                                  device=device) for k in keys)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.stack([c(x).squeeze(-1) for c in self.critics], dim=-1)


class SACParams(nn.Module):
    """policy, q, target_q (no gradient) and log_alpha, as JAX's SACParams."""

    def __init__(self, policy: nn.Module, q: nn.Module, target_q: nn.Module, log_alpha: Scalar):
        super().__init__()
        self.policy = policy
        self.q = q
        self.target_q = target_q.requires_grad_(False)
        self.log_alpha = log_alpha


def copy_module(make: Callable[[], nn.Module], src: nn.Module) -> nn.Module:
    """A second module from `make` holding `src`'s values."""
    out = make()
    out.load_state_dict(src.state_dict())
    return out


@dataclass
class SACTrainingState:
    params: SACParams
    policy_opt: AdamState
    q_opt: AdamState
    alpha_opt: AdamState
    normalizer: running_statistics.RunningStatisticsState
    buffer: replay.ReplayState
    # epochs, not env-steps: env-steps are epochs * steps_per_epoch * num_envs
    epochs: int
    # the recurrent learner's (capacity, num_envs) PER table, when it has one
    priorities: Optional[torch.Tensor] = None


@dataclasses.dataclass(frozen=True)
class SACConfig:
    num_timesteps: int = 1_000_000
    num_envs: int = 128
    episode_length: int = 1000
    replay_capacity: int = 8192  # slots; each slot holds one (num_envs, ...) batch
    batch_size: int = 256  # single transitions per gradient step
    steps_per_epoch: int = 16
    grad_steps_per_env_step: int = 1
    min_replay: int = 64
    learning_rate: float = 3e-4
    discounting: float = 0.99
    tau: float = 0.005
    reward_scaling: float = 1.0
    normalize_observations: bool = True
    hidden: Tuple[int, ...] = (256, 256)


# examples/train_sac.py's recipe (ant by default)
ANT = SACConfig(num_envs=128, episode_length=1000, replay_capacity=4096, batch_size=64,
                steps_per_epoch=32, min_replay=64)


@contextlib.contextmanager
def frozen(module: nn.Module):
    """No gradient reaches `module`'s parameters inside (JAX differentiates
    each loss in one argument only); gradients still flow through it."""
    flags = [p.requires_grad for p in module.parameters()]
    module.requires_grad_(False)
    try:
        yield
    finally:
        for p, f in zip(module.parameters(), flags):
            p.requires_grad_(f)


def soft_update(target: nn.Module, online: nn.Module, tau: float) -> None:
    """target <- target * (1 - tau) + online * tau, JAX's order of operations."""
    with torch.no_grad():
        t, o = list(target.parameters()), list(online.parameters())
        torch._foreach_mul_(t, 1.0 - tau)
        torch._foreach_add_(t, torch._foreach_mul(o, tau))


class SplitClock:
    """Sums the time of an epoch's collect and update phases: CUDA events on
    the card (no host wait), `perf_counter` on the CPU. `mark(phase)` closes
    the running interval and charges it to the phase that was running;
    `ms()` reads (collect ms, update ms) of the last epoch."""

    PHASES = ("collect", "update")

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.intervals = []
        self._last = None

    def _now(self):
        if self.cuda:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            return event
        return time.perf_counter()

    def start(self) -> None:
        self.intervals = []
        self._last = self._now()

    def mark(self, phase: str) -> None:
        now = self._now()
        self.intervals.append((phase, self._last, now))
        self._last = now

    def ms(self) -> Tuple[float, float]:
        out = dict.fromkeys(self.PHASES, 0.0)
        if self.cuda and self.intervals:
            self.intervals[-1][2].synchronize()
        for phase, a, b in self.intervals:
            out[phase] += a.elapsed_time(b) if self.cuda else (b - a) * 1e3
        return out["collect"], out["update"]


# the metrics the ranks average (JAX's pmeans); alpha is replicated already
AVERAGED = ("q_loss", "actor_loss", "mean_reward")


def epoch_metrics(metrics, mesh: Optional[Mesh]) -> Dict[str, torch.Tensor]:
    """An epoch's mean metrics; under a mesh `AVERAGED` are averaged over
    the ranks in one all-reduce (the mean of the per-step means JAX pmeans)."""
    out = {k: torch.stack([m[k] for m in metrics]).mean() for k in metrics[0]}
    if mesh is not None:
        out.update(zip(AVERAGED, pmean(torch.stack([out[k] for k in AVERAGED]), mesh).unbind()))
    return out


def shard_sizes(cfg, mesh: Optional[Mesh]) -> Tuple[int, int]:
    """(envs, transitions or sequences a grad step draws) of one rank."""
    n = mesh.data if mesh is not None else 1
    if cfg.num_envs % n or cfg.batch_size % n:
        raise ValueError("num_envs and batch_size must divide the mesh 'data' axis")
    return cfg.num_envs // n, cfg.batch_size // n


class SACLearner:
    def __init__(self, env: Env, cfg: SACConfig, mesh: Optional[Mesh] = None):
        self.mesh = mesh
        self.local_envs, self.local_bs = shard_sizes(cfg, mesh)
        self.env = env
        self.cfg = cfg
        self.device = env.device
        self.obs_size = env.observation_size
        self.action_size = env.action_size
        self.dist = NormalTanhDistribution(event_size=self.action_size)
        self.optimizer = Optimizer(cfg.learning_rate)  # optax.adam: no clipping
        self.target_entropy = -0.5 * self.action_size
        self.clock = SplitClock(self.device)

    @property
    def steps_per_epoch(self) -> int:
        return self.cfg.steps_per_epoch * self.cfg.num_envs

    # ---- init -----------------------------------------------------------------

    def make_params(self, key: torch.Tensor) -> SACParams:
        """Drawn from the port's own stream (not flax's key derivation)."""
        kp, kq = _split2(key.cpu())
        cfg, dev = self.cfg, self.device
        policy = networks.make_model(list(cfg.hidden) + [self.dist.param_size], self.obs_size,
                                     key=kp, device=dev)
        keys = jr.split(kq, 2)

        def make_q():
            return TwinMLP(list(cfg.hidden) + [1], self.obs_size + self.action_size, keys,
                           device=dev)

        q = make_q()
        return SACParams(policy, q, copy_module(make_q, q), Scalar(device=dev))

    def init(self, key: torch.Tensor) -> SACTrainingState:
        params = self.make_params(key)
        B, dev = self.local_envs, self.device
        zeros = torch.zeros(B, device=dev)
        obs = torch.zeros(B, self.obs_size, device=dev)
        sample = {"obs": obs, "action": torch.zeros(B, self.action_size, device=dev),
                  "reward": zeros, "next_obs": obs, "done": zeros, "truncation": zeros}
        return SACTrainingState(
            params=params, policy_opt=self.optimizer.init(params.policy),
            q_opt=self.optimizer.init(params.q), alpha_opt=self.optimizer.init(params.log_alpha),
            normalizer=running_statistics.init_state(self.obs_size, dev),
            buffer=replay.init(sample, self.cfg.replay_capacity), epochs=0)

    # ---- pieces ---------------------------------------------------------------

    def _norm(self, normalizer, obs):
        if self.cfg.normalize_observations:
            return running_statistics.normalize(normalizer, obs)
        return obs

    def _q_values(self, q: nn.Module, normalizer, obs, action):
        return q(torch.cat([self._norm(normalizer, obs), action], dim=-1))

    def _critic_loss(self, params: SACParams, normalizer, batch, key):
        """Differentiates through `params.q` only."""
        cfg = self.cfg
        alpha = torch.exp(params.log_alpha.value.detach())
        with torch.no_grad():
            dist_params = params.policy(self._norm(normalizer, batch["next_obs"]))
            next_pre = self.dist.sample_no_postprocess(dist_params, key)
            next_action = self.dist.postprocess(next_pre)
            next_logp = self.dist.log_prob(dist_params, next_pre)
            next_q = self._q_values(params.target_q, normalizer, batch["next_obs"], next_action)
            next_v = next_q.min(dim=-1).values - alpha * next_logp
            # bootstrap through truncation, not through termination: next_obs
            # is the pre-autoreset final observation
            not_terminal = 1.0 - batch["done"] * (1.0 - batch["truncation"])
            target = batch["reward"] * cfg.reward_scaling + cfg.discounting * not_terminal * next_v
        q = self._q_values(params.q, normalizer, batch["obs"], batch["action"])
        return 0.5 * torch.mean(torch.sum(torch.square(q - target[..., None]), dim=-1))

    def _actor_loss(self, params: SACParams, normalizer, batch, key):
        """Differentiates through `params.policy` only -> (loss, logp)."""
        alpha = torch.exp(params.log_alpha.value.detach())
        dist_params = params.policy(self._norm(normalizer, batch["obs"]))
        pre = self.dist.sample_no_postprocess(dist_params, key)
        action = self.dist.postprocess(pre)
        logp = self.dist.log_prob(dist_params, pre)
        with frozen(params.q):
            q = self._q_values(params.q, normalizer, batch["obs"], action)
        return torch.mean(alpha * logp - q.min(dim=-1).values), logp

    def _alpha_loss(self, log_alpha: torch.Tensor, logp: torch.Tensor):
        return torch.mean(-torch.exp(log_alpha) * (logp + self.target_entropy).detach())

    # ---- the epoch --------------------------------------------------------------

    def grad_step(self, ts: SACTrainingState, key: torch.Tensor) -> Dict[str, torch.Tensor]:
        """One gradient step of critics, actor and temperature, in place."""
        k1, k2, k3 = jr.split(key, 3).unbind(-2)
        batch = replay.sample_transitions(ts.buffer, k1, self.local_bs)
        params = ts.params
        params.zero_grad(set_to_none=True)
        with torch.enable_grad():
            q_loss = self._critic_loss(params, ts.normalizer, batch, k2)
            q_loss.backward()
            a_loss, logp = self._actor_loss(params, ts.normalizer, batch, k3)
            a_loss.backward()
            self._alpha_loss(params.log_alpha.value, logp).backward()
        ts.q_opt = self.optimizer.step(params.q, ts.q_opt, self.mesh)
        ts.policy_opt = self.optimizer.step(params.policy, ts.policy_opt, self.mesh)
        ts.alpha_opt = self.optimizer.step(params.log_alpha, ts.alpha_opt, self.mesh)
        soft_update(params.target_q, params.q, self.cfg.tau)
        return {"q_loss": q_loss.detach(), "actor_loss": a_loss.detach(),
                "alpha": torch.exp(params.log_alpha.value.detach())}

    def _skipped(self, ts) -> Dict[str, torch.Tensor]:
        zero = torch.zeros((), device=self.device)
        return {"q_loss": zero, "actor_loss": zero,
                "alpha": torch.exp(ts.params.log_alpha.value.detach())}

    @torch.no_grad()
    def epoch(self, ts: SACTrainingState, env_state: State, key: torch.Tensor):
        """One epoch -> (ts, env_state, mean metrics); `self.clock.ms()` then
        reads its collect / update split."""
        cfg = self.cfg
        self.clock.start()
        if self.mesh is not None:
            key = jr.fold_in(key, self.mesh.rank)  # each rank its own stream
        metrics = []
        for _ in range(cfg.steps_per_epoch):
            key, k_act, k_grad = jr.split(key, 3).unbind(-2)
            dist_params = ts.params.policy(self._norm(ts.normalizer, env_state.obs))
            action = self.dist.postprocess(self.dist.sample_no_postprocess(dist_params, k_act))
            nstate = self.env.step(env_state, action)
            ts.buffer = replay.insert(ts.buffer, {
                "obs": env_state.obs, "action": action, "reward": nstate.reward,
                "next_obs": nstate.info.get("final_obs", nstate.obs), "done": nstate.done,
                "truncation": nstate.info.get("truncation", torch.zeros_like(nstate.done))})
            if cfg.normalize_observations:
                ts.normalizer = running_statistics.update(ts.normalizer, env_state.obs,
                                                          self.mesh)
            self.clock.mark("collect")
            m = self._skipped(ts)
            if ts.buffer.size >= cfg.min_replay:
                for i in range(cfg.grad_steps_per_env_step):
                    m = self.grad_step(ts, jr.fold_in(k_grad, i))
            m["mean_reward"] = nstate.reward.mean()
            metrics.append(m)
            self.clock.mark("update")
            env_state = nstate
        ts.epochs += 1
        return ts, env_state, epoch_metrics(metrics, self.mesh)

    def inference_params(self, ts: SACTrainingState) -> tuple:
        """The params tuple `make_inference_fn`'s policy takes."""
        return ts.normalizer, ts.params.policy

    def make_inference_fn(self) -> Callable:
        """`policy(params_tuple, obs, key, deterministic=False) -> action`,
        params_tuple = (normalizer, policy module)."""

        @torch.no_grad()
        def policy(params_tuple, obs, key, deterministic: bool = False):
            normalizer, policy_net = params_tuple
            dist_params = policy_net(self._norm(normalizer, obs))
            if deterministic:
                return self.dist.mode(dist_params)
            return self.dist.sample(dist_params, key)

        return policy


def wrap_for_training(env: Env, cfg: SACConfig, autoreset_mode: str,
                      batch: Optional[int] = None) -> Env:
    """Episode -> Vmap (`batch` envs, cfg.num_envs unless named) ->
    randomised autoreset, as JAX's `sac.train` stacks them (no action
    repeat)."""
    from pobrax_tpu_torch.envs import wrappers

    wrapped = wrappers.EpisodeWrapper(env, cfg.episode_length, 1)
    wrapped = wrappers.VmapWrapper(wrapped, batch_size=batch or cfg.num_envs)
    return wrappers.randomized_autoreset(wrapped, autoreset_mode)


def train(env: Env, cfg: Optional[SACConfig] = None, seed: int = 0,
          mesh: Optional[Mesh] = None,
          progress_fn: Optional[Callable[[int, Dict[str, float]], None]] = None,
          autoreset_mode: str = "naive", checkpoint_dir: Optional[str] = None,
          checkpoint_every: int = 1_000_000,
          watchdog_deadline_s: Optional[float] = health.DEFAULT_DEADLINE_S,
          **cfg_overrides):
    """Train SAC on a core env (built on its device: the card unless named)
    -> (inference_fn, (normalizer, policy), history). The env is wrapped
    Episode -> Vmap -> randomised autoreset (`autoreset_mode` 'naive' or
    'cached'); `progress_fn` gets the epoch's mean losses, `rollout_ms` /
    `update_ms` (the collect / update split) and `steps_per_second`. With
    `mesh` this process is one rank of the data-parallel run (module
    docstring); `num_envs`, `batch_size` and the env-steps stay global.
    `watchdog_deadline_s`: see `ppo.run_epochs`."""
    cfg = dataclasses.replace(cfg or SACConfig(), **cfg_overrides)
    wrapped = wrap_for_training(env, cfg, autoreset_mode, shard_sizes(cfg, mesh)[0])
    learner = SACLearner(wrapped, cfg, mesh)
    key, k_init, k_reset = jr.split(jr.PRNGKey(seed, wrapped.device), 3).unbind(-2)
    env_state = reset_block(wrapped, k_reset, cfg.num_envs, mesh)
    ts = learner.init(k_init)
    per_epoch = learner.steps_per_epoch
    ts, key, resumed_steps = resume(ts, key, checkpoint_dir, per_epoch)
    # JAX's floor of the budget, at least one epoch on a fresh start
    num_epochs = max(0 if resumed_steps else 1,
                     max(0, cfg.num_timesteps - resumed_steps) // per_epoch)
    ts, _, history = run_epochs(learner, ts, (env_state,), key, num_epochs, resumed_steps,
                                progress_fn, checkpoint_dir, checkpoint_every,
                                watchdog_deadline_s=watchdog_deadline_s)
    return learner.make_inference_fn(), learner.inference_params(ts), history
