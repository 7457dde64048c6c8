"""Recurrent PPO, a GRU policy and value for the PO tasks; the port of
`pobrax_tpu/training/ppo_rnn.py`.

  * network: obs -> MLP encoder -> GRU cell -> (policy head, value head),
    one shared trunk (`GRUNet`);
  * rollout: the hidden state rides along the env loop and is zeroed where
    an episode ended (the autoreset's fresh episode gets fresh memory);
  * update: minibatches are strided slices of the ENV axis (env b goes to
    minibatch b % M) with time kept whole; each replays its unroll through
    the GRU from the rollout's starting hidden state, detached, with the
    same done-masked resets.
GAE, the clipped objective, observation normalisation, the optimizer and
the key stream are those of `ppo.py`; here the minibatch key runs on across
update epochs (there is no permutation).

Under a `mesh` the semantics are global, as in `ppo.py`, and the hidden
state is sharded with the envs. Rank d holds envs [d B/D, (d + 1) B/D);
with B/D a multiple of M, env b's minibatch b % M is the same globally and
locally, and rank d owns positions [d B/(D M), (d + 1) B/(D M)) of every
minibatch's env axis, so the entropy's (T, B/M, A) draw is sliced along
that axis.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from pobrax_tpu_torch import random as jr
from pobrax_tpu_torch.device import resolve
from pobrax_tpu_torch.envs.base import Env, State
from pobrax_tpu_torch.models.networks import lecun_normal, linear
from pobrax_tpu_torch.parallel import health
from pobrax_tpu_torch.parallel.mesh import Mesh, draw_block
from pobrax_tpu_torch.training.ppo import (LearnerBase, TrainingState, Transition, _mean_metrics,
                                           _split2, local_batch, reset_block, resume, run_epochs,
                                           wrap_for_training)

def orthogonal(key: torch.Tensor, n: int) -> torch.Tensor:
    """An (n, n) orthogonal matrix as flax's `orthogonal()` draws it: the Q
    of a QR of a standard normal matrix, columns signed by diag(R)."""
    q, r = torch.linalg.qr(jr.normal(key, (n, n)))
    return q * torch.sign(torch.diagonal(r))[None, :]


def gru_cell(keys: torch.Tensor, in_size: int, hidden_size: int) -> nn.GRUCell:
    """An `nn.GRUCell` drawn as flax's GRUCell: input kernels (ir, iz, in)
    lecun-normal from keys[0:3], recurrent kernels (hr, hz, hn) orthogonal
    from keys[3:6], zero biases. Flax's cell has no bias on the r and z
    recurrent terms; torch's has one, so `bias_hh`'s r and z thirds start at
    zero and a gradient hook keeps them there (the n third is flax's `hn`
    bias). On the CPU; the caller moves it."""
    cell = nn.GRUCell(in_size, hidden_size)
    with torch.no_grad():
        # flax names ir, iz, in / hr, hz, hn; torch stacks (r, z, n)
        cell.weight_ih.copy_(torch.cat([lecun_normal(keys[i], in_size, hidden_size)
                                        for i in range(3)]))
        cell.weight_hh.copy_(torch.cat([orthogonal(keys[3 + i], hidden_size).t()
                                        for i in range(3)]))
        cell.bias_ih.zero_()
        cell.bias_hh.zero_()

    def rz_bias_grad_zero(grad: torch.Tensor) -> torch.Tensor:
        grad = grad.clone()
        grad[:2 * hidden_size] = 0
        return grad

    cell.bias_hh.register_hook(rz_bias_grad_zero)
    return cell


class GRUNet(nn.Module):
    """Encoder MLP -> `nn.GRUCell` (`gru_cell`) -> policy and value heads,
    one step at a time."""

    def __init__(self, obs_size: int, encoder_sizes: Tuple[int, ...], hidden_size: int,
                 policy_size: int, key: Optional[torch.Tensor] = None, device=None):
        super().__init__()
        key = jr.PRNGKey(0) if key is None else key.cpu()
        keys = jr.split(key, len(encoder_sizes) + 8)
        sizes = [obs_size] + list(encoder_sizes)
        self.enc = nn.ModuleList(linear(keys[i], sizes[i], sizes[i + 1], init=lecun_normal)
                                 for i in range(len(encoder_sizes)))
        k = keys[len(encoder_sizes):]
        self.gru = gru_cell(k[:6], sizes[-1], hidden_size)
        self.hidden_size = hidden_size
        self.policy_head = linear(k[6], hidden_size, policy_size, init=lecun_normal)
        self.value_head = linear(k[7], hidden_size, 1, init=lecun_normal)
        self.to(resolve(device))

    def forward(self, h: torch.Tensor, obs: torch.Tensor):
        x = obs
        for layer in self.enc:
            x = F.silu(layer(x))
        h = self.gru(x, h)
        return h, self.policy_head(h), self.value_head(h).squeeze(-1)


@dataclasses.dataclass(frozen=True)
class RNNPPOConfig:
    num_timesteps: int = 1_000_000
    num_envs: int = 2048
    episode_length: int = 1000
    action_repeat: int = 1
    unroll_length: int = 32
    num_minibatches: int = 8  # slices of the ENV axis (time kept whole)
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
    flatten_optimizer: bool = True  # JAX's Adam state layout (see ppo.py)
    encoder_sizes: Tuple[int, ...] = (256,)
    hidden_size: int = 128
    epochs_per_call: int = 1


# examples/train_ant_tag_rnn.py's recipe: the GRU-PPO that solves AntTag
ANT_TAG = RNNPPOConfig(num_envs=2048, episode_length=1000, action_repeat=6, unroll_length=32,
                       num_minibatches=8, num_update_epochs=4, learning_rate=3e-4,
                       entropy_cost=3e-3, discounting=0.97, reward_scaling=1.0,
                       encoder_sizes=(256,), hidden_size=128)


class RNNPPOLearner(LearnerBase):
    env_axis = 1  # a minibatch's policy outputs are (T, B/M, P)

    def __init__(self, env: Env, cfg: RNNPPOConfig, mesh: Optional[Mesh] = None):
        super().__init__(env, cfg, mesh)
        if cfg.num_envs % (cfg.num_minibatches * self.n_shards):
            raise ValueError("num_envs must divide into num_minibatches (per rank under a mesh)")

    def h0(self, batch: int) -> torch.Tensor:
        return torch.zeros(batch, self.cfg.hidden_size, device=self.device)

    def inference_params(self, ts: TrainingState) -> tuple:
        return ts.normalizer, ts.params

    def make_params(self, key: torch.Tensor) -> GRUNet:
        return GRUNet(self.obs_size, tuple(self.cfg.encoder_sizes), self.cfg.hidden_size,
                      self.dist.param_size, key=key, device=self.device)

    def _apply(self, params, normalizer, h, obs):
        """`normalizer=None` means `obs` is already normalised."""
        return params(h, self._normalize(normalizer, obs))

    def make_inference_fn(self) -> Callable:
        """`policy(params_tuple, h, obs, key, deterministic=False) -> (h',
        action)`; thread `h` yourself (zeros at the start, zeroed where an
        episode resets)."""

        @torch.no_grad()
        def policy(params_tuple, h, obs, key, deterministic: bool = False):
            normalizer, params = params_tuple
            h, pol, _ = self._apply(params, normalizer, h, obs)
            if deterministic:
                return h, self.dist.mode(pol)
            return h, self.dist.sample(pol, key)

        return policy

    @torch.no_grad()
    def _rollout(self, ts: TrainingState, env_state: State, h: torch.Tensor, key: torch.Tensor):
        """The hidden state is not stored per step: the loss replays it from
        the rollout's starting h."""
        steps = []
        for _ in range(self.cfg.unroll_length):
            key, k_sample = _split2(key)
            nh, pol, value = self._apply(ts.params, ts.normalizer, h, env_state.obs)
            pre_tanh = self.dist.sample_no_postprocess(pol, k_sample, draw_block(self.mesh))
            log_prob = self.dist.log_prob(pol, pre_tanh)
            nstate = self.env.step(env_state, self.dist.postprocess(pre_tanh))
            h = nh * (1.0 - nstate.done[:, None])
            steps.append((env_state.obs, pre_tanh, log_prob,
                          nstate.reward * self.cfg.reward_scaling, nstate.done,
                          nstate.info.get("truncation", torch.zeros_like(nstate.done)), value))
            env_state = nstate
        data = Transition(*(torch.stack(x) for x in zip(*steps)))
        _, _, bootstrap_value = self._apply(ts.params, ts.normalizer, h, env_state.obs)
        return env_state, h, data, bootstrap_value

    def _loss(self, params, h0, data: Transition, advantages, returns, key):
        """Replays the unroll from `h0`; `data.obs` arrives normalised."""
        h, pols, values = h0, [], []
        for t in range(data.obs.shape[0]):
            nh, pol, val = self._apply(params, None, h, data.obs[t])
            h = nh * (1.0 - data.done[t][:, None])
            pols.append(pol)
            values.append(val)
        return self._objective(torch.stack(pols), torch.stack(values), data, advantages,
                               returns, key)

    def epoch(self, ts: TrainingState, env_state: State, h: torch.Tensor, key: torch.Tensor):
        """One epoch -> (ts, env_state, h, mean metrics); updates `ts.params`
        in place. `self.clock.ms()` then reads its rollout / update split."""
        cfg = self.cfg
        M = cfg.num_minibatches
        self.clock.mark(first=True)
        key, k_roll, k_sgd = jr.split(key, 3).unbind(-2)
        h0_roll = h.detach()
        (env_state, h), data, advantages, returns, normalizer = self._rollout_and_targets(
            ts, env_state, k_roll, h)
        self.clock.mark()

        def shape_mb(x):
            # (T, B, ...) -> (T, B/M, M, ...) -> (M, T, B/M, ...): env b -> minibatch b % M
            x = x.reshape(x.shape[:1] + (-1, M) + x.shape[2:])
            return x.movedim((2, 0), (0, 1))

        payload = [shape_mb(x) for x in (data.obs, data.action, data.log_prob, data.reward,
                                         data.done, data.truncation, data.value, advantages,
                                         returns)]
        h0_mb = h0_roll.reshape(-1, M, cfg.hidden_size).movedim(1, 0)
        metrics = []
        with torch.enable_grad():
            for _ in range(cfg.num_update_epochs):
                for m in range(M):
                    k_sgd, k_loss = _split2(k_sgd)
                    mb = [x[m] for x in payload]
                    metrics.append(self.grad_step(
                        ts, (h0_mb[m], Transition(*mb[:7]), mb[7], mb[8]), k_loss))
        self.clock.mark()
        ts = TrainingState(params=ts.params, opt_state=ts.opt_state, normalizer=normalizer,
                           epochs=ts.epochs + 1)
        return ts, env_state, h, _mean_metrics(metrics, data.reward, cfg.reward_scaling,
                                               self.mesh)


def train(env: Env, cfg: Optional[RNNPPOConfig] = None, seed: int = 0,
          mesh: Optional[Mesh] = None,
          progress_fn: Optional[Callable[[int, Dict[str, float]], None]] = None,
          checkpoint_dir: Optional[str] = None, checkpoint_every: int = 1_000_000,
          autoreset_mode: str = "naive",
          watchdog_deadline_s: Optional[float] = health.DEFAULT_DEADLINE_S,
          **cfg_overrides):
    """Train GRU-PPO on a core env (built on its device: the card unless
    named) -> (inference_fn, (normalizer, GRUNet), history); the inference
    function threads the hidden state: `h, action = inference_fn(params_tuple,
    h, obs, key)`. Checkpoints and resume as `ppo.train`; the env and hidden
    state restart fresh on resume. `mesh`: see `ppo.train`.
    `watchdog_deadline_s`: see `ppo.run_epochs`."""
    cfg = dataclasses.replace(cfg or RNNPPOConfig(), **cfg_overrides)
    batch = local_batch(cfg, mesh)
    wrapped = wrap_for_training(env, cfg, autoreset_mode, batch)
    learner = RNNPPOLearner(wrapped, cfg, mesh)
    key, k_init, k_reset = jr.split(jr.PRNGKey(seed, wrapped.device), 3).unbind(-2)
    ts = learner.init(k_init)
    ts, key, resumed_steps = resume(ts, key, checkpoint_dir, learner.steps_per_epoch)
    env_state = reset_block(wrapped, k_reset, cfg.num_envs, mesh)
    h = learner.h0(batch)
    epc = max(1, cfg.epochs_per_call)
    # at least one call on a fresh start, as JAX's
    num_calls = max(0 if resumed_steps else 1,
                    -(-max(0, cfg.num_timesteps - resumed_steps)
                      // (learner.steps_per_epoch * epc)))
    ts, _, history = run_epochs(learner, ts, (env_state, h), key, num_calls, resumed_steps,
                                progress_fn, checkpoint_dir, checkpoint_every,
                                watchdog_deadline_s=watchdog_deadline_s, epochs_per_call=epc)
    return learner.make_inference_fn(), learner.inference_params(ts), history
