"""Recurrent Soft Actor-Critic with R2D2-style sequence replay; the port of
`pobrax_tpu/training/sac_rnn.py`.

  * actor: obs -> MLP encoder -> GRU -> tanh-normal head (`ActorGRU`);
  * critics: obs -> MLP encoder -> GRU trunk, then (features, action) ->
    MLP -> q (`CriticGRU`); the action joins after the recurrence, so one
    trunk roll serves any action. Two independent critics (`TwinCriticGRU`);
  * replay: each slot holds a whole (seq_len, num_envs, ...) sequence and
    the actor's hidden state at its start; a gradient step draws
    `batch_size` (slot, env column) pairs, uniformly or, with `per_alpha` >
    0, by priority (`replay.sample_prioritized`, importance weights on the
    critic loss, |TD| written back);
  * burn-in: the first `burn_in` steps of a sampled sequence only warm the
    hidden states (masked out of the losses); the critics start from zero,
    the actor from the stored h0; hidden states are zeroed after a done;
  * targets: n-step (`nstep_targets`), the last step bootstrapping from the
    stored pre-reset final observation through one more actor and target
    trunk step.
One epoch: `seqs_per_epoch` x (seq_len env steps -> one sequence insert ->
`grad_steps_per_seq` gradient steps once the buffer holds `min_replay`).

Keys follow the JAX learner's splits one for one: per sequence `key, k_seq,
k_grad = split(key, 3)`; per collection step `key, k_act = split(key)`; grad
step i draws from `fold_in(k_grad, i)` -> `k1, k2, k3 = split(., 3)`, k1 ->
(k_slot, k_col), k2 the critic loss's samples, k3 the actor loss's; inside a
loss `k1, k2 = split(key)` draw the sequence's actions and the final
observation's. JAX evaluates the whole `_losses` twice a grad step and
differentiates one part each time; the port computes, for each call, only
the part that call differentiates (the critic's with k2, the actor's with
k3), from the same parameters (the actor reads the critic before this
step's update). The GRU cells follow `ppo_rnn.gru_cell`'s conventions.

`train` checkpoints and resumes (`checkpoint_dir`: parameters, the three
Adam states, the normaliser and the epoch count; the key folded with the
epoch count; `actor_freeze_epochs` counted from the resumed epoch) and
collects with a `carry_env` in the first columns (`[carry | train]`).

Under a `mesh` the semantics are per shard, as JAX's `shard_map` epoch and
`sac.py`: rank d folds d into the epoch key, steps its `num_envs / D` envs
with their GRU hidden states, fills its own replay columns and PER table and
draws `batch_size / D` of its own sequences. The collectives: the mean of
the q and actor gradients, the mean of the actor loss's `logp` before the
temperature's loss (so the temperature's gradient is the same on every rank
and is not averaged again), the statistics' sums, and the epoch's mean
q_loss, actor_loss and mean_reward. With a carry env the layout is per
shard too: `carry_envs` is a multiple of D and every rank's columns are
`[carry / D | train]`, its block of JAX's interleaved global batch.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from pobrax_tpu_torch import random as jr
from pobrax_tpu_torch.envs.base import Env, State
from pobrax_tpu_torch.models.networks import lecun_normal, linear
from pobrax_tpu_torch.parallel import health
from pobrax_tpu_torch.parallel.mesh import Mesh, pmean, tree_map
from pobrax_tpu_torch.training import replay, running_statistics
from pobrax_tpu_torch.training.distribution import NormalTanhDistribution
from pobrax_tpu_torch.training.optimizer import Optimizer
from pobrax_tpu_torch.training.ppo import _split2, resume, run_epochs
from pobrax_tpu_torch.training.ppo_rnn import gru_cell
from pobrax_tpu_torch.training.sac import (SACParams, SACTrainingState, Scalar, SplitClock,
                                           copy_module, epoch_metrics, frozen, shard_sizes,
                                           soft_update)


class ActorGRU(nn.Module):
    """enc_i (swish) -> GRU -> head, one step: (h, obs) -> (h', dist params)."""

    def __init__(self, obs_size: int, encoder_sizes, hidden_size: int, out_size: int,
                 key: torch.Tensor):
        super().__init__()
        keys = jr.split(key.cpu(), len(encoder_sizes) + 7)
        sizes = [obs_size] + list(encoder_sizes)
        self.enc = nn.ModuleList(linear(keys[i], sizes[i], sizes[i + 1], init=lecun_normal)
                                 for i in range(len(encoder_sizes)))
        k = keys[len(encoder_sizes):]
        self.gru = gru_cell(k[:6], sizes[-1], hidden_size)
        self.head = linear(k[6], hidden_size, out_size, init=lecun_normal)

    def forward(self, h: torch.Tensor, obs: torch.Tensor):
        x = obs
        for layer in self.enc:
            x = F.silu(layer(x))
        h = self.gru(x, h)
        return h, self.head(h)


class CriticGRU(nn.Module):
    """Recurrent trunk on the observation; the action joins at the head."""

    def __init__(self, obs_size: int, action_size: int, encoder_sizes, hidden_size: int,
                 head_sizes, key: torch.Tensor):
        super().__init__()
        n_enc, n_head = len(encoder_sizes), len(head_sizes)
        keys = jr.split(key.cpu(), n_enc + 6 + n_head + 1)
        sizes = [obs_size] + list(encoder_sizes)
        self.enc = nn.ModuleList(linear(keys[i], sizes[i], sizes[i + 1], init=lecun_normal)
                                 for i in range(n_enc))
        self.gru = gru_cell(keys[n_enc:n_enc + 6], sizes[-1], hidden_size)
        k = keys[n_enc + 6:]
        heads = [hidden_size + action_size] + list(head_sizes)
        self.head = nn.ModuleList(linear(k[i], heads[i], heads[i + 1], init=lecun_normal)
                                  for i in range(n_head))
        self.q = linear(k[n_head], heads[-1], 1, init=lecun_normal)

    def trunk(self, h: torch.Tensor, obs: torch.Tensor):
        x = obs
        for layer in self.enc:
            x = F.silu(layer(x))
        h = self.gru(x, h)
        return h, h

    def q_head(self, y: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
        x = torch.cat([y, action], dim=-1)
        for layer in self.head:
            x = F.silu(layer(x))
        return self.q(x).squeeze(-1)


class TwinCriticGRU(nn.Module):
    """Two independent `CriticGRU`s; hidden states and features carry the
    critic axis (2, ...) as JAX's stacked, vmapped critics do."""

    def __init__(self, keys, **kwargs):
        super().__init__()
        self.critics = nn.ModuleList(CriticGRU(key=k, **kwargs) for k in keys)

    def trunk(self, h: torch.Tensor, obs: torch.Tensor):
        """h (2, B, H), obs (B, O) -> (h', y), both (2, B, H)."""
        out = [c.trunk(h[i], obs) for i, c in enumerate(self.critics)]
        return torch.stack([o[0] for o in out]), torch.stack([o[1] for o in out])

    def q_head(self, y: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
        """y (..., 2, B, H), action (..., B, A) -> (..., B, 2)."""
        return torch.stack([c.q_head(y[..., i, :, :], action)
                            for i, c in enumerate(self.critics)], dim=-1)


@dataclasses.dataclass(frozen=True)
class RSACConfig:
    num_timesteps: int = 1_000_000
    num_envs: int = 64
    episode_length: int = 1000
    action_repeat: int = 1
    seq_len: int = 16  # stored sequence length (burn_in + trained steps)
    burn_in: int = 4
    replay_capacity: int = 512  # sequence slots
    batch_size: int = 64  # sequences per gradient step
    seqs_per_epoch: int = 4
    grad_steps_per_seq: int = 1
    min_replay: int = 16  # sequence slots before training starts
    learning_rate: float = 3e-4
    discounting: float = 0.99
    tau: float = 0.005
    reward_scaling: float = 1.0
    nstep: int = 1  # n-step TD targets within the sequence; 1 = one-step SAC
    # prioritized sequence replay: P ∝ p^alpha, p = eta max|TD| + (1 - eta)
    # mean|TD| over the trained segment; 0 keeps uniform sampling
    per_alpha: float = 0.0
    per_beta: float = 0.4
    per_eta: float = 0.9
    # critic-only updates for the first N epochs of this run
    actor_freeze_epochs: int = 0
    normalize_observations: bool = True
    encoder_sizes: Tuple[int, ...] = (128,)
    hidden_size: int = 64
    head_sizes: Tuple[int, ...] = (128,)


# examples/train_ant_tag_sac_rnn.py's recipe (phase 0, radius 20) on the
# unshaped AntTag; the example trains the potential-shaped one,
# examples/train_ant_tag.py's `ShapedAntTag`
ANT_TAG = RSACConfig(num_envs=512, episode_length=1000, action_repeat=6, seq_len=32, burn_in=8,
                     replay_capacity=192, batch_size=128, seqs_per_epoch=4,
                     grad_steps_per_seq=2, min_replay=24, learning_rate=3e-4,
                     discounting=0.97, reward_scaling=10.0, nstep=5, hidden_size=128,
                     encoder_sizes=(256,), head_sizes=(256,))


def nstep_targets(r, not_terminal, v_boot, gamma: float, n: int):
    """(L, B) n-step TD targets within a sequence: G_t = r_t + gamma nt_t
    G_{t+1}, n levels deep; the last row keeps its one-step target and a
    terminal cuts the recursion. n = 1 is the plain TD target."""
    g1 = r + gamma * not_terminal * v_boot
    target = g1
    for _ in range(n - 1):
        new = r[:-1] + gamma * not_terminal[:-1] * target[1:]
        target = torch.cat([new, g1[-1:]], dim=0)
    return target


def tree_concat(a, b):
    """Two trees of the same structure joined along the batch axis."""
    if isinstance(a, torch.Tensor):
        return torch.cat([a, b], dim=0)
    if isinstance(a, dict):
        return {k: tree_concat(v, b[k]) for k, v in a.items()}
    if dataclasses.is_dataclass(a):
        return type(a)(**{f.name: tree_concat(getattr(a, f.name), getattr(b, f.name))
                          for f in dataclasses.fields(a)})
    return a


class RSACLearner:
    def __init__(self, env: Env, cfg: RSACConfig, mesh: Optional[Mesh] = None,
                 carry_env: Optional[Env] = None, carry_envs: int = 0):
        if cfg.burn_in >= cfg.seq_len:
            raise ValueError("burn_in must be < seq_len")
        self.mesh = mesh
        self.local_envs, self.local_bs = shard_sizes(cfg, mesh)
        n_shards = mesh.data if mesh is not None else 1
        self.carry_env = carry_env
        if carry_env is not None:
            if not 0 < carry_envs < cfg.num_envs:
                raise ValueError("carry_envs must be in (0, num_envs)")
            if carry_envs % n_shards:
                raise ValueError("the mesh 'data' axis size must divide carry_envs")
            if (carry_env.observation_size != env.observation_size
                    or carry_env.action_size != env.action_size):
                raise ValueError("carry_env must match obs/action sizes")
        self._carry = carry_envs // n_shards  # this rank's carry columns
        self.env = env
        self.cfg = cfg
        self.device = env.device
        self.obs_size = env.observation_size
        self.action_size = env.action_size
        self.dist = NormalTanhDistribution(event_size=self.action_size)
        self.optimizer = Optimizer(cfg.learning_rate)
        self.target_entropy = -0.5 * self.action_size
        self.clock = SplitClock(self.device)
        mask = torch.zeros(cfg.seq_len, 1, device=self.device)
        mask[cfg.burn_in:] = 1.0
        self._mask = mask

    @property
    def steps_per_epoch(self) -> int:
        cfg = self.cfg
        return cfg.seqs_per_epoch * cfg.seq_len * cfg.num_envs * cfg.action_repeat

    def h0(self, batch: int) -> torch.Tensor:
        return torch.zeros(batch, self.cfg.hidden_size, device=self.device)

    def _step_envs(self, env_state: State, action: torch.Tensor) -> State:
        """One collection step; with a carry_env its columns [0, carry) step
        in the old-phase env and the rest in the training env."""
        if self.carry_env is None:
            return self.env.step(env_state, action)
        k = self._carry
        n_old = self.carry_env.step(tree_map(lambda x: x[:k], env_state), action[:k])
        n_new = self.env.step(tree_map(lambda x: x[k:], env_state), action[k:])
        return tree_concat(n_old, n_new)

    # ---- init -----------------------------------------------------------------

    def make_params(self, key: torch.Tensor) -> SACParams:
        """Drawn from the port's own stream (not flax's key derivation)."""
        cfg, dev = self.cfg, self.device
        kp, kq = _split2(key.cpu())
        policy = ActorGRU(self.obs_size, cfg.encoder_sizes, cfg.hidden_size,
                          self.dist.param_size, kp).to(dev)
        keys = jr.split(kq, 2)

        def make_q():
            return TwinCriticGRU(keys, obs_size=self.obs_size, action_size=self.action_size,
                                 encoder_sizes=cfg.encoder_sizes, hidden_size=cfg.hidden_size,
                                 head_sizes=cfg.head_sizes).to(dev)

        q = make_q()
        return SACParams(policy, q, copy_module(make_q, q), Scalar(device=dev))

    def init(self, key: torch.Tensor) -> SACTrainingState:
        cfg, dev = self.cfg, self.device
        params = self.make_params(key)
        L, B = cfg.seq_len, self.local_envs
        seq = {"obs": torch.zeros(L, B, self.obs_size, device=dev),
               "action": torch.zeros(L, B, self.action_size, device=dev),
               "reward": torch.zeros(L, B, device=dev),
               "done": torch.zeros(L, B, device=dev),
               "truncation": torch.zeros(L, B, device=dev),
               "final_obs": torch.zeros(L, B, self.obs_size, device=dev),
               "h0": torch.zeros(B, cfg.hidden_size, device=dev)}
        return SACTrainingState(
            params=params, policy_opt=self.optimizer.init(params.policy),
            q_opt=self.optimizer.init(params.q), alpha_opt=self.optimizer.init(params.log_alpha),
            normalizer=running_statistics.init_state(self.obs_size, dev),
            buffer=replay.init(seq, cfg.replay_capacity), epochs=0,
            priorities=(replay.priorities_init(cfg.replay_capacity, B, dev)
                        if cfg.per_alpha > 0 else None))

    # ---- pieces ---------------------------------------------------------------

    def _norm(self, normalizer, obs):
        if self.cfg.normalize_observations:
            return running_statistics.normalize(normalizer, obs)
        return obs

    @staticmethod
    def _actor_roll(policy: ActorGRU, h, obs_seq, done_seq):
        """(T, B, ...) -> (final h, dist params (T, B, P)); h zeroed after a
        done step."""
        dps = []
        for t in range(obs_seq.shape[0]):
            nh, dp = policy(h, obs_seq[t])
            h = nh * (1.0 - done_seq[t][:, None])
            dps.append(dp)
        return h, torch.stack(dps)

    @staticmethod
    def _critic_roll(q: TwinCriticGRU, h, obs_seq, done_seq):
        """Both critics' trunks over (T, B, obs) from h (2, B, H) -> (final
        h, features (T, 2, B, H))."""
        ys = []
        for t in range(obs_seq.shape[0]):
            nh, y = q.trunk(h, obs_seq[t])
            h = nh * (1.0 - done_seq[t][None, :, None])
            ys.append(y)
        return h, torch.stack(ys)

    def _losses(self, params: SACParams, normalizer, seq, key, critic: bool = True,
                actor: bool = True) -> Dict[str, torch.Tensor]:
        """The losses of a sampled sequence batch with burn-in masking; the
        critic part differentiates through `params.q` only, the actor part
        through `params.policy` only. -> {critic_loss, td_seq} and / or
        {actor_loss, logp} (logp: the masked mean, detached)."""
        cfg = self.cfg
        alpha = torch.exp(params.log_alpha.value.detach())
        obs = self._norm(normalizer, seq["obs"])
        done = seq["done"]
        B = obs.shape[1]
        mask = self._mask
        denom = torch.clamp(mask.sum() * B, min=1.0)
        k1, k2 = _split2(key)
        out = {}
        with torch.set_grad_enabled(actor and torch.is_grad_enabled()):
            h_a_end, dp = self._actor_roll(params.policy, seq["h0"].detach(), obs, done)
            pre = self.dist.sample_no_postprocess(dp, k1)
            a_pi = self.dist.postprocess(pre)
            logp = self.dist.log_prob(dp, pre)  # (L, B)
        hq = torch.zeros(2, B, cfg.hidden_size, device=obs.device)
        y = None
        if critic:
            _, y = self._critic_roll(params.q, hq, obs, done)
            with torch.no_grad():
                h_qt_end, y_tgt = self._critic_roll(params.target_q, hq, obs, done)
                q_next = params.target_q.q_head(y_tgt, a_pi)  # (L, B, 2)
                v_next = q_next.min(dim=-1).values - alpha * logp
                # the last step bootstraps from the stored pre-reset final
                # observation: one more actor and target trunk step
                fin = self._norm(normalizer, seq["final_obs"][-1])
                _, dp_fin = params.policy(h_a_end, fin)
                pre_fin = self.dist.sample_no_postprocess(dp_fin, k2)
                a_fin = self.dist.postprocess(pre_fin)
                logp_fin = self.dist.log_prob(dp_fin, pre_fin)
                _, y_fin = params.target_q.trunk(h_qt_end, fin)
                q_fin = params.target_q.q_head(y_fin, a_fin)  # (B, 2)
                v_fin = q_fin.min(dim=-1).values - alpha * logp_fin
                v_boot = torch.cat([v_next[1:], v_fin[None]], dim=0)
                not_terminal = 1.0 - seq["done"] * (1.0 - seq["truncation"])
                target = nstep_targets(seq["reward"] * cfg.reward_scaling, not_terminal, v_boot,
                                       cfg.discounting, cfg.nstep)
            q_taken = params.q.q_head(y, seq["action"])  # (L, B, 2)
            err = q_taken - target[..., None]
            w = seq["is_weight"][:, None] if "is_weight" in seq else 1.0
            out["critic_loss"] = 0.5 * torch.sum(w * mask[..., None] * torch.square(err)) / denom
            with torch.no_grad():
                abs_err = torch.mean(torch.abs(err), dim=-1)
                td_mean = torch.sum(mask * abs_err, dim=0) / torch.clamp(mask.sum(), min=1.0)
                td_max = torch.max(mask * abs_err, dim=0).values
                out["td_seq"] = cfg.per_eta * td_max + (1.0 - cfg.per_eta) * td_mean
        if actor:
            if y is None:
                with torch.no_grad():
                    _, y = self._critic_roll(params.q, hq, obs, done)
            with frozen(params.q):
                q_pi = params.q.q_head(y.detach(), a_pi)
            out["actor_loss"] = torch.sum(
                mask * (alpha * logp - q_pi.min(dim=-1).values)) / denom
            out["logp"] = (torch.sum(mask * logp) / denom).detach()
        return out

    def _alpha_loss(self, log_alpha: torch.Tensor, logp: torch.Tensor):
        return -torch.exp(log_alpha) * (logp + self.target_entropy)

    # ---- the epoch -------------------------------------------------------------

    def sample_seq(self, ts: SACTrainingState, key: torch.Tensor):
        """The grad step's draw -> (seq (L, batch, ...) with h0 and, under PER,
        is_weight; slot; col)."""
        cfg = self.cfg
        k_slot, k_col = _split2(key)
        data = ts.buffer.data
        if cfg.per_alpha > 0:
            slot, col, is_w = replay.sample_prioritized(ts.priorities, k_slot, self.local_bs,
                                                        cfg.per_alpha, cfg.per_beta)
        else:
            slot = jr.randint(k_slot, (self.local_bs,), 0, max(ts.buffer.size, 1)).long()
            col = jr.randint(k_col, (self.local_bs,), 0, data["h0"].shape[1]).long()
            is_w = None
        # (slot, col) pairs index around the time axis: (batch, L, ...) -> (L, batch, ...)
        seq = {"h0": data["h0"][slot, col],
               **{f: data[f][slot, :, col].movedim(0, 1)
                  for f in ("obs", "action", "reward", "done", "truncation", "final_obs")}}
        if is_w is not None:
            seq["is_weight"] = is_w
        return seq, slot, col

    def grad_step(self, ts: SACTrainingState, key: torch.Tensor,
                  freeze_until: int = 0) -> Dict[str, torch.Tensor]:
        """One gradient step, in place: critics always; actor and temperature
        unless the epoch count is below `freeze_until`."""
        cfg = self.cfg
        k1, k2, k3 = jr.split(key, 3).unbind(-2)
        seq, slot, col = self.sample_seq(ts, k1)
        params = ts.params
        params.zero_grad(set_to_none=True)
        do_actor = freeze_until <= 0 or ts.epochs >= freeze_until
        with torch.enable_grad():
            c = self._losses(params, ts.normalizer, seq, k2, critic=True, actor=False)
            c["critic_loss"].backward()
            if do_actor:
                a = self._losses(params, ts.normalizer, seq, k3, critic=False, actor=True)
                a["actor_loss"].backward()
                # the ranks' mean logp: one temperature gradient for all
                self._alpha_loss(params.log_alpha.value, pmean(a["logp"], self.mesh)).backward()
        ts.q_opt = self.optimizer.step(params.q, ts.q_opt, self.mesh)
        if do_actor:
            ts.policy_opt = self.optimizer.step(params.policy, ts.policy_opt, self.mesh)
            ts.alpha_opt = self.optimizer.step(params.log_alpha, ts.alpha_opt)
        soft_update(params.target_q, params.q, cfg.tau)
        if cfg.per_alpha > 0:
            replay.priorities_update(ts.priorities, slot, col, c["td_seq"])
        return {"q_loss": c["critic_loss"].detach(),
                "actor_loss": (a["actor_loss"].detach() if do_actor
                               else torch.zeros((), device=self.device)),
                "alpha": torch.exp(params.log_alpha.value.detach())}

    @torch.no_grad()
    def collect_seq(self, ts: SACTrainingState, env_state: State, h: torch.Tensor,
                    key: torch.Tensor):
        """seq_len acting steps -> (env_state, h, normalizer, sequence + h0).
        The actor reads the statistics as they are updated step by step."""
        cfg = self.cfg
        h_start = h
        normalizer = ts.normalizer
        rows = []
        for _ in range(cfg.seq_len):
            key, k_act = _split2(key)
            nh, dp = ts.params.policy(h, self._norm(normalizer, env_state.obs))
            action = self.dist.postprocess(self.dist.sample_no_postprocess(dp, k_act))
            nstate = self._step_envs(env_state, action)
            h = nh * (1.0 - nstate.done[:, None])
            if cfg.normalize_observations:
                normalizer = running_statistics.update(normalizer, env_state.obs, self.mesh)
            rows.append((env_state.obs, action, nstate.reward, nstate.done,
                         nstate.info.get("truncation", torch.zeros_like(nstate.done)),
                         nstate.info.get("final_obs", nstate.obs)))
            env_state = nstate
        names = ("obs", "action", "reward", "done", "truncation", "final_obs")
        seq = {k: torch.stack(v) for k, v in zip(names, zip(*rows))}
        seq["h0"] = h_start
        return env_state, h, normalizer, seq

    def epoch(self, ts: SACTrainingState, env_state: State, h: torch.Tensor, key: torch.Tensor,
              freeze_until: int = 0):
        """One epoch -> (ts, env_state, h, mean metrics); updates `ts` in
        place. `self.clock.ms()` then reads its collect / update split."""
        cfg = self.cfg
        self.clock.start()
        if self.mesh is not None:
            key = jr.fold_in(key, self.mesh.rank)  # each rank its own stream
        metrics = []
        for _ in range(cfg.seqs_per_epoch):
            key, k_seq, k_grad = jr.split(key, 3).unbind(-2)
            env_state, h, ts.normalizer, seq = self.collect_seq(ts, env_state, h, k_seq)
            if cfg.per_alpha > 0:
                replay.priorities_on_insert(ts.priorities, ts.buffer.insert_pos)
            ts.buffer = replay.insert(ts.buffer, seq)
            self.clock.mark("collect")
            m = {"q_loss": torch.zeros((), device=self.device),
                 "actor_loss": torch.zeros((), device=self.device),
                 "alpha": torch.exp(ts.params.log_alpha.value.detach())}
            if ts.buffer.size >= cfg.min_replay:
                for i in range(cfg.grad_steps_per_seq):
                    m = self.grad_step(ts, jr.fold_in(k_grad, i), freeze_until)
            m["mean_reward"] = seq["reward"].mean()
            metrics.append(m)
            self.clock.mark("update")
        ts.epochs += 1
        return ts, env_state, h, epoch_metrics(metrics, self.mesh)

    def inference_params(self, ts: SACTrainingState) -> tuple:
        """The params tuple `make_inference_fn`'s policy takes."""
        return ts.normalizer, ts.params.policy

    def make_inference_fn(self) -> Callable:
        """`h, action = policy(params_tuple, h, obs, key, deterministic=False)`,
        params_tuple = (normalizer, ActorGRU): ppo_rnn's recurrent contract."""

        @torch.no_grad()
        def policy(params_tuple, h, obs, key, deterministic: bool = False):
            normalizer, policy_net = params_tuple
            nh, dp = policy_net(h, self._norm(normalizer, obs))
            if deterministic:
                return nh, self.dist.mode(dp)
            return nh, self.dist.sample(dp, key)

        return policy


class _Epochs:
    """`run_epochs`' view of the learner: its epoch with `freeze_until` bound."""

    def __init__(self, learner: RSACLearner, freeze_until: int):
        self.learner, self.freeze_until = learner, freeze_until
        self.steps_per_epoch, self.clock = learner.steps_per_epoch, learner.clock
        self.mesh = learner.mesh

    def epoch(self, ts, env_state, h, key):
        return self.learner.epoch(ts, env_state, h, key, self.freeze_until)


def wrap_for_training(env: Env, cfg: RSACConfig, autoreset_mode: str,
                      batch: Optional[int] = None) -> Env:
    """ActionRepeat -> Episode -> Vmap (`batch` envs, cfg.num_envs unless
    named) -> randomised autoreset, as JAX's `sac_rnn.train` stacks them."""
    from pobrax_tpu_torch.envs import wrappers

    batch = batch or cfg.num_envs
    wrapped = wrappers.ActionRepeatWrapper(env, cfg.action_repeat)
    wrapped = wrappers.EpisodeWrapper(wrapped, cfg.episode_length, 1)
    wrapped = wrappers.VmapWrapper(wrapped, batch_size=batch)
    return wrappers.randomized_autoreset(wrapped, autoreset_mode)


def train(env: Env, cfg: Optional[RSACConfig] = None, seed: int = 0,
          mesh: Optional[Mesh] = None,
          progress_fn: Optional[Callable[[int, Dict[str, float]], None]] = None,
          autoreset_mode: str = "naive", checkpoint_dir: Optional[str] = None,
          checkpoint_every: int = 1_000_000, carry_env: Optional[Env] = None,
          carry_frac: float = 0.25,
          watchdog_deadline_s: Optional[float] = health.DEFAULT_DEADLINE_S,
          **cfg_overrides):
    """Train recurrent SAC on a core env (built on its device: the card
    unless named) -> (inference_fn, (normalizer, ActorGRU), history).

    With `checkpoint_dir` the parameters, optimizers, normaliser and epoch
    count are saved every `checkpoint_every` env-steps and at the end, and
    training resumes from the latest step dir (the replay buffer refills
    through `min_replay`). With `carry_env` (a curriculum's previous-phase
    env), a `carry_frac` share of the columns, rounded to at least one,
    keeps collecting from it: the batch is [carry | train]. With `mesh` this
    process is one rank of the data-parallel run (module docstring): the
    carry share is rounded to at least one column per rank and each rank's
    batch is [its carry | its train] columns.
    `watchdog_deadline_s`: see `ppo.run_epochs`."""
    cfg = dataclasses.replace(cfg or RSACConfig(), **cfg_overrides)
    n_shards = mesh.data if mesh is not None else 1
    local = shard_sizes(cfg, mesh)[0]
    wrapped = wrap_for_training(env, cfg, autoreset_mode, local)
    if carry_env is not None and carry_frac <= 0.0:
        carry_env = None  # carry_frac <= 0: pure-env collection
    carry_envs, carry_wrapped = 0, None
    if carry_env is not None:
        if not 0.0 < carry_frac < 1.0:
            raise ValueError("carry_frac must be in (0, 1)")
        carry_envs = max(1, round(carry_frac * cfg.num_envs / n_shards)) * n_shards
        carry_wrapped = wrap_for_training(carry_env, cfg, autoreset_mode,
                                          carry_envs // n_shards)
    learner = RSACLearner(wrapped, cfg, mesh, carry_env=carry_wrapped, carry_envs=carry_envs)
    key, k_init, k_reset = jr.split(jr.PRNGKey(seed, wrapped.device), 3).unbind(-2)
    keys = jr.split(k_reset, cfg.num_envs)
    # the global batch: the carry block's keys first, then the train block's;
    # rank d takes its block of each, so its columns are [carry | train]
    d = mesh.rank if mesh is not None else 0
    k_carry = carry_envs // n_shards
    k_train = local - k_carry
    train_keys = keys[carry_envs + d * k_train:carry_envs + (d + 1) * k_train]
    if carry_wrapped is None:
        env_state = wrapped.reset(train_keys)
    else:
        env_state = tree_concat(carry_wrapped.reset(keys[d * k_carry:(d + 1) * k_carry]),
                                wrapped.reset(train_keys))
    ts = learner.init(k_init)
    per_epoch = learner.steps_per_epoch
    ts, key, resumed_steps = resume(ts, key, checkpoint_dir, per_epoch)
    h = learner.h0(local)
    # the actor freeze counts from this run's first epoch
    freeze_until = ts.epochs + cfg.actor_freeze_epochs if cfg.actor_freeze_epochs else 0
    num_epochs = max(0 if resumed_steps else 1,
                     -(-max(0, cfg.num_timesteps - resumed_steps) // per_epoch))
    ts, _, history = run_epochs(_Epochs(learner, freeze_until), ts, (env_state, h), key,
                                num_epochs, resumed_steps, progress_fn, checkpoint_dir,
                                checkpoint_every, watchdog_deadline_s=watchdog_deadline_s)
    return learner.make_inference_fn(), learner.inference_params(ts), history
