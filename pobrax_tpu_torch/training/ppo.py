"""PPO; the port of `pobrax_tpu/training/ppo.py`.

One training epoch: `unroll_length` env steps (the rollout, without
gradient), GAE with its truncation mask, the running observation statistics,
then `num_update_epochs x num_minibatches` clipped-PPO updates of the policy
and value MLPs. Rollout buffers are time-major (T, B, ...), as in JAX.

Keys follow the JAX learner's splits one for one (`pobrax_tpu_torch.random`
is jax's threefry), so from the same state, env and key an epoch draws the
same samples, minibatches and entropy noise as JAX's:
  * per epoch `key, k_roll, k_sgd = split(key, 3)`;
  * per rollout step `key, k_sample = split(key)`;
  * per update epoch `key, k_perm, k_mb = split(key, 3)` and a
    `permutation` of the T*B samples (`minibatch_indices`);
  * per minibatch `key, k_loss = split(key)`; `k_loss` draws the entropy's
    sample.
`train` runs its epochs in a host loop (`epochs_per_call` groups them for
metrics and checkpoints only) with the same key stream as JAX's scan, and
resumes from `checkpoint_dir` by folding the epoch count into the key.

The learner runs on its env's device (the envs resolve `device`: the card
unless named). Parameters live in `nn.Module`s and are updated in place.

Data parallelism (`mesh`, `parallel/mesh.py`): JAX jits the epoch with the
env batch on 'data' and everything else replicated, one global program, so a
D-device run computes what one device computes with `shuffle_blocks=D`.
The port keeps those global semantics with each rank holding
`num_envs / D` envs (its block of the global batch, reset from its block of
`split(k_reset, num_envs)`):
  * every draw is the global draw: the rollout's action noise and the
    entropy's sample are the rank's rows of the global normal draw
    (`random`'s `block`), the minibatch indices the global
    `minibatch_indices` with `shuffle_blocks = D`, of which rank d takes
    columns [d S, (d + 1) S) of each row, all from its own env block;
  * advantage normalisation uses the global minibatch's mean and population
    std (two all-reduces a minibatch), the observation statistics the global
    rollout (`running_statistics.update(..., mesh)`);
  * each rank's loss is the mean over its equal share of the minibatch, so
    the mean of the ranks' gradients (`Optimizer.step(..., mesh)`, one
    all-reduce before the clip) is the global loss's gradient, and the
    parameters stay bit-equal across ranks;
  * the metrics are averaged over the ranks once an epoch.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from pobrax_tpu_torch import random as jr
from pobrax_tpu_torch.envs.base import Env, State
from pobrax_tpu_torch.models import networks
from pobrax_tpu_torch.parallel import health
from pobrax_tpu_torch.parallel.mesh import Mesh, draw_block, pmean
from pobrax_tpu_torch.training import checkpoint as ckpt
from pobrax_tpu_torch.training import running_statistics
from pobrax_tpu_torch.training.distribution import NormalTanhDistribution
from pobrax_tpu_torch.training.optimizer import AdamState, Optimizer


class PPOParams(nn.Module):
    """The policy and value networks (JAX's `PPOParams(policy, value)`)."""

    def __init__(self, policy: nn.Module, value: nn.Module):
        super().__init__()
        self.policy = policy
        self.value = value


@dataclass
class TrainingState:
    params: nn.Module
    opt_state: AdamState
    normalizer: running_statistics.RunningStatisticsState
    # epochs, not env-steps: env-steps are epochs * steps_per_epoch
    epochs: int


@dataclass
class Transition:
    """One rollout, time-major (T, B, ...)."""

    obs: torch.Tensor
    action: torch.Tensor  # pre-tanh sample
    log_prob: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor
    truncation: torch.Tensor
    value: torch.Tensor

    def replace(self, **changes) -> "Transition":
        return dataclasses.replace(self, **changes)


def compute_gae(rewards: torch.Tensor, dones: torch.Tensor, truncation: torch.Tensor,
                values: torch.Tensor, bootstrap_value: torch.Tensor, discount: float,
                gae_lambda: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Generalised advantage estimation over a (T, B) rollout.

    A terminal `done` cuts the bootstrap. At a truncated step the stored
    next observation already belongs to the next episode, so both the TD
    delta and the accumulator are masked by (1 - truncation), as brax v0
    PPO does; the truncated step itself carries zero advantage."""
    values_tp1 = torch.cat([values[1:], bootstrap_value[None]], dim=0)
    tmask = 1.0 - truncation
    term = dones * (1.0 - truncation)
    delta = (rewards + discount * (1.0 - term) * values_tp1 - values) * tmask
    carry = discount * gae_lambda * (1.0 - term) * tmask
    gae = torch.zeros_like(bootstrap_value)
    advantages = []
    for t in range(rewards.shape[0] - 1, -1, -1):
        gae = delta[t] + carry[t] * gae
        advantages.append(gae)
    advantages = torch.stack(advantages[::-1])
    return advantages, advantages + values


def minibatch_indices(k_perm: torch.Tensor, T: int, B: int, M: int,
                      blocks: Optional[int]) -> torch.Tensor:
    """(M, T*B/M) indices into the (T*B)-flattened rollout.

    blocks=None: one permutation of the T*B samples. blocks=D: a permutation
    within each of D env blocks, every minibatch taking an equal slice of
    each block (the JAX learner's shard-local shuffle)."""
    if blocks:
        D = blocks
        Bd = B // D
        perms = jr.permutation(jr.split(k_perm, D), T * Bd)  # (D, T*Bd)
        # local index l in block d is (t = l // Bd, b' = l % Bd) -> t*B + d*Bd + b'
        d_col = torch.arange(D, device=perms.device)[:, None]
        flat = (perms // Bd) * B + d_col * Bd + perms % Bd
        return flat.reshape(D, M, -1).transpose(0, 1).reshape(M, -1)
    return jr.permutation(k_perm, T * B).reshape(M, -1)


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    num_timesteps: int = 1_000_000
    num_envs: int = 2048
    episode_length: int = 1000
    action_repeat: int = 1
    unroll_length: int = 20
    num_minibatches: int = 32
    num_update_epochs: int = 4
    learning_rate: float = 3e-4
    entropy_cost: float = 1e-2
    discounting: float = 0.97
    gae_lambda: float = 0.95
    clipping_epsilon: float = 0.3
    reward_scaling: float = 1.0
    normalize_observations: bool = True
    normalize_advantages: bool = True
    max_grad_norm: Optional[float] = 0.5
    # True: optax.flatten's one flat vector; False: optax's per-leaf chain.
    # The update is the same (training/optimizer.py); only the Adam state's
    # layout on the JAX side differs (interop)
    flatten_optimizer: bool = True
    policy_hidden: Tuple[int, ...] = (32, 32, 32, 32)
    value_hidden: Tuple[int, ...] = (256, 256, 256, 256, 256)
    # None: one permutation of the rollout; D: a permutation within each of
    # D env blocks (see minibatch_indices)
    shuffle_blocks: Optional[int] = None
    # "bfloat16" runs the policy / value matmuls in bfloat16 (parameters
    # stay float32; outputs cast back to float32 before the loss)
    network_dtype: Optional[str] = None
    # epochs between progress reports and checkpoint checks; the key stream
    # is that of single epochs
    epochs_per_call: int = 1


# examples/train_ant_tag.py:115-129's recipe: feed-forward PPO on AntTag
ANT_TAG = PPOConfig(num_envs=4096, episode_length=1000, action_repeat=6, unroll_length=16,
                    num_minibatches=32, num_update_epochs=4, learning_rate=3e-4,
                    entropy_cost=3e-3, discounting=0.97, reward_scaling=1.0)
# examples/train_ppo.py's recipe (halfcheetah in the port's chip_smoke.py);
# its autoreset is `train`'s default, naive
HALFCHEETAH = PPOConfig(num_envs=1024, episode_length=1000, unroll_length=20,
                        num_minibatches=16, num_update_epochs=4)


def _split2(key: torch.Tensor):
    a, b = jr.split(key, 2).unbind(-2)
    return a, b


class _PhaseClock:
    """Marks rollout / update boundaries: CUDA events on the card (no host
    wait), `perf_counter` on the CPU. `ms()` reads the last epoch's split."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def mark(self, first: bool = False) -> None:
        if first:
            self.marks = []
        if self.cuda:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            self.marks.append(event)
        else:
            self.marks.append(time.perf_counter())

    def ms(self) -> Tuple[float, float]:
        """(rollout ms, update ms) of the last epoch; waits for it on the card."""
        a, b, c = self.marks
        if self.cuda:
            c.synchronize()
            return a.elapsed_time(b), b.elapsed_time(c)
        return (b - a) * 1e3, (c - b) * 1e3


class LearnerBase:
    """What both learners share: the env, the distribution, the optimizer,
    the training state's init, observation normalisation, one minibatch
    update and the rollout's targets. `env` holds this rank's envs under a
    `mesh` (`cfg.num_envs / D` of them), all of them without one."""

    # the axis of a minibatch's policy outputs that holds its envs (the
    # entropy's draw is sliced there under a mesh)
    env_axis = 0

    def __init__(self, env: Env, cfg, mesh: Optional[Mesh] = None):
        self.env = env
        self.cfg = cfg
        self.mesh = mesh
        self.n_shards = mesh.data if mesh is not None else 1
        if cfg.num_envs % self.n_shards:
            raise ValueError("num_envs must divide over the mesh 'data' axis")
        self.device = env.device
        self.action_size = env.action_size
        self.obs_size = env.observation_size
        self.dist = NormalTanhDistribution(event_size=self.action_size)
        self.optimizer = Optimizer(cfg.learning_rate, cfg.max_grad_norm,
                                   per_leaf=not cfg.flatten_optimizer)
        self.clock = _PhaseClock(self.device)

    @property
    def steps_per_epoch(self) -> int:
        cfg = self.cfg
        return cfg.unroll_length * cfg.num_envs * cfg.action_repeat

    def make_params(self, key: torch.Tensor) -> nn.Module:
        raise NotImplementedError

    def inference_params(self, ts: TrainingState) -> tuple:
        """The params tuple `make_inference_fn`'s policy takes."""
        return ts.normalizer, ts.params.policy

    def init(self, key: torch.Tensor) -> TrainingState:
        params = self.make_params(key)
        return TrainingState(params=params, opt_state=self.optimizer.init(params),
                             normalizer=running_statistics.init_state(self.obs_size,
                                                                      self.device),
                             epochs=0)

    def _normalize(self, normalizer, obs):
        """`normalizer=None` means `obs` is already normalised."""
        if normalizer is not None and self.cfg.normalize_observations:
            return running_statistics.normalize(normalizer, obs)
        return obs

    def _objective(self, dist_params, value, data: Transition, advantages, returns, key):
        """The clipped PPO loss from the new policy outputs and values ->
        (total, metrics); the entropy's sample draws from `key`."""
        cfg = self.cfg
        log_prob = self.dist.log_prob(dist_params, data.action)
        ratio = torch.exp(log_prob - data.log_prob)
        if cfg.normalize_advantages:
            # the global minibatch's mean and population std (jnp.std's two
            # passes); the ranks' shares are equal, so means of means
            mean = pmean(advantages.mean(), self.mesh)
            std = torch.sqrt(pmean(torch.square(advantages - mean).mean(), self.mesh))
            advantages = (advantages - mean) / (std + 1e-8)
        unclipped = ratio * advantages
        clipped = torch.clamp(ratio, 1.0 - cfg.clipping_epsilon,
                              1.0 + cfg.clipping_epsilon) * advantages
        policy_loss = -torch.mean(torch.minimum(unclipped, clipped))
        value_loss = 0.5 * torch.mean(torch.square(returns - value))
        entropy = torch.mean(self.dist.entropy(dist_params, key,
                                               draw_block(self.mesh, self.env_axis)))
        total = policy_loss + value_loss - cfg.entropy_cost * entropy
        return total, {"total_loss": total, "policy_loss": policy_loss,
                       "value_loss": value_loss, "entropy": entropy}

    def grad_step(self, ts: TrainingState, loss_args, key: torch.Tensor) -> Dict:
        """One minibatch: loss, gradients, optimizer update (in place)."""
        ts.params.zero_grad(set_to_none=True)
        total, metrics = self._loss(ts.params, *loss_args, key)
        total.backward()
        ts.opt_state = self.optimizer.step(ts.params, ts.opt_state, self.mesh)
        return {k: v.detach() for k, v in metrics.items()}

    def _rollout_and_targets(self, ts, env_state, k_roll, *rollout_args):
        """Rollout, GAE, then the statistics updated with the rollout and the
        rollout normalised once with them -> (rollout carry, data,
        advantages, returns, normalizer)."""
        out = self._rollout(ts, env_state, *rollout_args, k_roll)
        data, bootstrap_value = out[-2], out[-1]
        advantages, returns = compute_gae(data.reward, data.done, data.truncation, data.value,
                                          bootstrap_value, self.cfg.discounting,
                                          self.cfg.gae_lambda)
        normalizer = ts.normalizer
        if self.cfg.normalize_observations:
            normalizer = running_statistics.update(normalizer, data.obs, self.mesh)
            data = data.replace(obs=running_statistics.normalize(normalizer, data.obs))
        return out[:-2], data, advantages, returns, normalizer


class PPOLearner(LearnerBase):
    """The epoch of feed-forward PPO for a wrapped (batched) env."""

    def __init__(self, env: Env, cfg: PPOConfig, mesh: Optional[Mesh] = None):
        super().__init__(env, cfg, mesh)
        self.net_dtype = torch.bfloat16 if cfg.network_dtype == "bfloat16" else None
        self.shuffle_blocks = cfg.shuffle_blocks
        if mesh is not None:
            if self.shuffle_blocks not in (None, mesh.data):
                raise ValueError("under a mesh shuffle_blocks must be the 'data' axis size, "
                                 "so that every rank's minibatch share is its own envs'")
            self.shuffle_blocks = mesh.data
        if self.shuffle_blocks is not None:
            per_block = cfg.unroll_length * cfg.num_envs // self.shuffle_blocks
            if cfg.num_envs % self.shuffle_blocks or per_block % cfg.num_minibatches:
                raise ValueError("num_envs must divide by shuffle_blocks and "
                                 "unroll*envs/blocks by num_minibatches")

    def make_params(self, key: torch.Tensor) -> PPOParams:
        kp, kv = _split2(key.cpu())
        return PPOParams(
            policy=networks.make_model(list(self.cfg.policy_hidden) + [self.dist.param_size],
                                       self.obs_size, dtype=self.net_dtype, key=kp,
                                       device=self.device),
            value=networks.make_model(list(self.cfg.value_hidden) + [1], self.obs_size,
                                      dtype=self.net_dtype, key=kv, device=self.device))

    # ---- policy --------------------------------------------------------------

    def _policy_params_fn(self, params: PPOParams, normalizer, obs):
        return params.policy(self._normalize(normalizer, obs)).float()

    def _value_fn(self, params: PPOParams, normalizer, obs):
        return params.value(self._normalize(normalizer, obs)).squeeze(-1).float()

    def make_inference_fn(self) -> Callable:
        """`policy(params_tuple, obs, key, deterministic=False) -> action in
        [-1, 1]`, params_tuple = (normalizer, policy module)."""

        @torch.no_grad()
        def policy(params_tuple, obs, key, deterministic: bool = False):
            normalizer, policy_net = params_tuple
            obs = (running_statistics.normalize(normalizer, obs)
                   if self.cfg.normalize_observations else obs)
            dist_params = policy_net(obs).float()
            if deterministic:
                return self.dist.mode(dist_params)
            return self.dist.sample(dist_params, key)

        return policy

    # ---- rollout + loss ------------------------------------------------------

    @torch.no_grad()
    def _rollout(self, ts: TrainingState, env_state: State, key: torch.Tensor):
        """The serial loop runs only what the trajectory needs (normalise,
        policy, sample, step); the value net and the log-prob run after it
        over the whole (T, B) rollout, as in JAX."""
        obs, pre, dist_params, reward, done, trunc = [], [], [], [], [], []
        for _ in range(self.cfg.unroll_length):
            key, k_sample = _split2(key)
            dp = self._policy_params_fn(ts.params, ts.normalizer, env_state.obs)
            pre_tanh = self.dist.sample_no_postprocess(dp, k_sample, draw_block(self.mesh))
            nstate = self.env.step(env_state, self.dist.postprocess(pre_tanh))
            obs.append(env_state.obs)
            pre.append(pre_tanh)
            dist_params.append(dp)
            reward.append(nstate.reward * self.cfg.reward_scaling)
            done.append(nstate.done)
            trunc.append(nstate.info.get("truncation", torch.zeros_like(nstate.done)))
            env_state = nstate
        obs, pre, dist_params = torch.stack(obs), torch.stack(pre), torch.stack(dist_params)
        data = Transition(obs=obs, action=pre, log_prob=self.dist.log_prob(dist_params, pre),
                          reward=torch.stack(reward), done=torch.stack(done),
                          truncation=torch.stack(trunc),
                          value=self._value_fn(ts.params, ts.normalizer, obs))
        bootstrap_value = self._value_fn(ts.params, ts.normalizer, env_state.obs)
        return env_state, data, bootstrap_value

    def _loss(self, params: PPOParams, normalizer, data: Transition,
              advantages: torch.Tensor, returns: torch.Tensor, key: torch.Tensor):
        return self._objective(self._policy_params_fn(params, normalizer, data.obs),
                               self._value_fn(params, normalizer, data.obs), data,
                               advantages, returns, key)

    # ---- the epoch -----------------------------------------------------------

    def epoch(self, ts: TrainingState, env_state: State, key: torch.Tensor):
        """One epoch -> (ts, env_state, mean metrics); updates `ts.params` in
        place. `self.clock.ms()` then reads its rollout / update split."""
        cfg = self.cfg
        self.clock.mark(first=True)
        key, k_roll, k_sgd = jr.split(key, 3).unbind(-2)
        (env_state,), data, advantages, returns, normalizer = self._rollout_and_targets(
            ts, env_state, k_roll)
        self.clock.mark()
        T, B = data.reward.shape
        M = cfg.num_minibatches
        payload = [x.reshape((T * B,) + x.shape[2:])
                   for x in (data.obs, data.action, data.log_prob, data.reward, data.done,
                             data.truncation, data.value, advantages, returns)]
        metrics = []
        with torch.enable_grad():
            for _ in range(cfg.num_update_epochs):
                k_sgd, k_perm, k_mb = jr.split(k_sgd, 3).unbind(-2)
                idx = minibatch_indices(k_perm, T, B * self.n_shards, M, self.shuffle_blocks)
                if self.mesh is not None:
                    idx = local_indices(idx, B, self.mesh)
                for m in range(M):
                    k_mb, k_loss = _split2(k_mb)
                    mb = [x[idx[m]] for x in payload]
                    metrics.append(self.grad_step(
                        ts, (None, Transition(*mb[:7]), mb[7], mb[8]), k_loss))
        self.clock.mark()
        ts = TrainingState(params=ts.params, opt_state=ts.opt_state, normalizer=normalizer,
                           epochs=ts.epochs + 1)
        return ts, env_state, _mean_metrics(metrics, data.reward, cfg.reward_scaling,
                                            self.mesh)


def local_indices(idx: torch.Tensor, B: int, mesh: Mesh) -> torch.Tensor:
    """This rank's share of global minibatch indices into a (T, B * D)
    rollout made with `blocks = D`: columns [d S, (d + 1) S) of each row,
    which all lie in env block d, as indices into the rank's own (T, B)
    rollout."""
    cols = idx[:, mesh.block(idx.shape[1])]
    return (cols // (B * mesh.data)) * B + cols % (B * mesh.data) - mesh.rank * B


def _mean_metrics(metrics, reward, reward_scaling, mesh=None) -> Dict[str, torch.Tensor]:
    """The epoch's mean metrics; under a mesh averaged over the ranks (one
    all-reduce: every rank's share of each minibatch is equal)."""
    names = list(metrics[0])
    out = torch.stack([torch.stack([m[k] for m in metrics]).mean() for k in names]
                      + [reward.mean() / reward_scaling])
    return dict(zip(names + ["mean_reward"], pmean(out, mesh).unbind()))


def evaluate(env: Env, inference_fn: Callable, params_tuple, num_episodes: int = 32,
             episode_length: int = 1000, seed: int = 0,
             deterministic: bool = True) -> Dict[str, float]:
    """Mean return and length of `num_episodes` parallel episodes of a core
    env, summing rewards until each episode's first done (the stock
    EvalWrapper's semantics). Stops once every episode has ended, which
    leaves the sums as they would be after `episode_length` steps."""
    from pobrax_tpu_torch.envs import wrappers

    wrapped = wrappers.EpisodeWrapper(env, episode_length, 1)
    wrapped = wrappers.VmapWrapper(wrapped, batch_size=num_episodes)
    k_reset, key = _split2(jr.PRNGKey(seed, env.device))
    state = wrapped.reset(jr.split(k_reset, num_episodes))
    ret = torch.zeros(num_episodes, device=env.device)
    length = torch.zeros_like(ret)
    alive = torch.ones_like(ret)
    for t in range(episode_length):
        key, k = _split2(key)
        state = wrapped.step(state, inference_fn(params_tuple, state.obs, k,
                                                 deterministic=deterministic))
        ret = ret + state.reward * alive
        length = length + alive
        alive = alive * (1.0 - state.done)
        if t % 10 == 9 and not bool(alive.any()):
            break
    return {"eval/mean_return": float(ret.mean()),
            "eval/std_return": float(ret.std(correction=0)),
            "eval/mean_length": float(length.mean())}


def wrap_for_training(env: Env, cfg, autoreset_mode: str, batch: Optional[int] = None) -> Env:
    """ActionRepeat -> Episode -> Vmap (`batch` envs, cfg.num_envs unless
    named) -> randomised autoreset, as the JAX `train`s stack them."""
    from pobrax_tpu_torch.envs import wrappers

    wrapped = wrappers.ActionRepeatWrapper(env, cfg.action_repeat)
    wrapped = wrappers.EpisodeWrapper(wrapped, cfg.episode_length, 1)
    wrapped = wrappers.VmapWrapper(wrapped, batch_size=batch or cfg.num_envs)
    return wrappers.randomized_autoreset(wrapped, autoreset_mode)


def local_batch(cfg, mesh: Optional[Mesh]) -> int:
    """This rank's envs: cfg.num_envs over the mesh's 'data' axis."""
    return cfg.num_envs // (mesh.data if mesh is not None else 1)


def reset_block(env: Env, key: torch.Tensor, num_envs: int, mesh: Optional[Mesh]) -> State:
    """`env.reset` of this rank's block of `split(key, num_envs)`: its envs
    of the single-process reset."""
    keys = jr.split(key, num_envs)
    return env.reset(keys if mesh is None else keys[mesh.block(num_envs)])


def resume(ts, key: torch.Tensor, checkpoint_dir: Optional[str],
           per_epoch: int) -> Tuple[object, torch.Tensor, int]:
    """(ts, key, resumed env-steps): the latest step dir's state, and the key
    with the epoch count folded in, so the stream continues rather than
    replays; unchanged without a checkpoint. `per_epoch` is the learner's
    `steps_per_epoch`."""
    latest = ckpt.latest_step_dir(checkpoint_dir) if checkpoint_dir is not None else None
    if latest is None:
        return ts, key, 0
    ts = ckpt.restore(latest, template=ts)
    return ts, jr.fold_in(key, ts.epochs), ts.epochs * per_epoch


def run_epochs(learner, ts, carry: tuple, key: torch.Tensor, num_calls: int,
               resumed_steps: int, progress_fn, checkpoint_dir: Optional[str],
               checkpoint_every: int, *, watchdog_deadline_s: Optional[float],
               epochs_per_call: int = 1):
    """The host loop of every `train`: `num_calls` calls of `epochs_per_call`
    epochs of `learner.steps_per_epoch` env-steps, `key, k_epoch =
    split(key)` before each epoch (JAX's stream);
    after each call the mean metrics go to `progress_fn` (with env-steps/s
    and the last epoch's rollout / update ms) and, every `checkpoint_every`
    env-steps and at the end, the state to `checkpoint_dir`.
    `learner.epoch(ts, *carry, key)` returns (ts, *carry, metrics).

    Failure detection, as JAX's `train`: a `health.Watchdog` whose monitor
    thread runs for the loop, beaten after each call; a call that outlasts
    `watchdog_deadline_s` (None disables it) is reported on stderr at once
    and raises at the next beat. The beat follows the read of the call's
    metrics to host floats, which waits for the card, as JAX's beat follows
    `block_until_ready(metrics)`: one sync a call, the one `progress_fn`
    needs anyway, made also without a `progress_fn` while the watchdog runs.
    Under a mesh of more than one rank every rank `health.ping()`s at the
    start and before each checkpoint (a dead peer becomes a hang the
    watchdog reports), and only rank 0 writes the checkpoint.
    -> (ts, carry, history)."""
    mesh = learner.mesh
    several = mesh is not None and mesh.world > 1
    per_call = learner.steps_per_epoch * epochs_per_call
    history = []
    t0 = time.perf_counter()
    last_ckpt = resumed_steps
    wd = (health.Watchdog(deadline_s=watchdog_deadline_s).start_monitor()
          if watchdog_deadline_s else None)
    try:
        if several:
            health.ping()  # startup liveness barrier: all peers present
        for i in range(num_calls):
            call_metrics = []
            for _ in range(epochs_per_call):
                key, k_epoch = _split2(key)
                ts, *carry, metrics = learner.epoch(ts, *carry, k_epoch)
                call_metrics.append(metrics)
            total_steps = resumed_steps + (i + 1) * per_call
            if progress_fn is not None or wd is not None:
                # float() waits for the card: the call's completion
                metrics = {k: float(torch.stack([m[k] for m in call_metrics]).mean())
                           for k in call_metrics[0]}
            if wd is not None:
                wd.beat()  # raises if the monitor latched a stall
            if progress_fn is not None:
                metrics["rollout_ms"], metrics["update_ms"] = learner.clock.ms()
                metrics["steps_per_second"] = (i + 1) * per_call / (time.perf_counter() - t0)
                history.append(metrics)
                progress_fn(total_steps, metrics)
            if checkpoint_dir is not None and (total_steps - last_ckpt >= checkpoint_every
                                               or i == num_calls - 1):
                if several:
                    health.ping()  # peers alive before the save's barrier
                ckpt.save_step(checkpoint_dir, total_steps, ts, mesh)
                last_ckpt = total_steps
    finally:
        if wd is not None:
            wd.stop_monitor()
    return ts, tuple(carry), history


def train(env: Env, cfg: Optional[PPOConfig] = None, seed: int = 0,
          mesh: Optional[Mesh] = None,
          progress_fn: Optional[Callable[[int, Dict[str, float]], None]] = None,
          checkpoint_dir: Optional[str] = None, checkpoint_every: int = 1_000_000,
          autoreset_mode: str = "naive",
          watchdog_deadline_s: Optional[float] = health.DEFAULT_DEADLINE_S,
          **cfg_overrides):
    """Train PPO on a core env (built on its device: the card unless named)
    -> (inference_fn, (normalizer, policy), metrics history).

    `autoreset_mode` 'naive' (a fresh reset every step, reference parity) or
    'cached'. With `checkpoint_dir` the state is saved every
    `checkpoint_every` env-steps and at the end, and training resumes from
    the latest step dir there. With `mesh` this process trains its block of
    `num_envs` as one rank of the data-parallel run (module docstring);
    `num_envs` and the reported env-steps stay global.
    `watchdog_deadline_s`: see `run_epochs`."""
    cfg = dataclasses.replace(cfg or PPOConfig(), **cfg_overrides)
    wrapped = wrap_for_training(env, cfg, autoreset_mode, local_batch(cfg, mesh))
    learner = PPOLearner(wrapped, cfg, mesh)
    key, k_init, k_reset = jr.split(jr.PRNGKey(seed, wrapped.device), 3).unbind(-2)
    ts = learner.init(k_init)
    ts, key, resumed_steps = resume(ts, key, checkpoint_dir, learner.steps_per_epoch)
    env_state = reset_block(wrapped, k_reset, cfg.num_envs, mesh)
    epc = max(1, cfg.epochs_per_call)
    # ceil of the remaining budget: zero calls once the checkpoint covers it
    num_calls = -(-max(0, cfg.num_timesteps - resumed_steps) // (learner.steps_per_epoch * epc))
    ts, _, history = run_epochs(learner, ts, (env_state,), key, num_calls, resumed_steps,
                                progress_fn, checkpoint_dir, checkpoint_every,
                                watchdog_deadline_s=watchdog_deadline_s, epochs_per_call=epc)
    return learner.make_inference_fn(), learner.inference_params(ts), history
