"""The examples' evaluators against the JAX examples', on the CPU.

Each evaluator runs in both packages on the same env arguments, seeds and
policy (random, or a feed-forward / GRU policy whose JAX initial parameters
are carried into the port with `interop.training_state_from_numpy`), at 16
episodes of 30 control steps, action_repeat 1: the port's plain step and
JAX's part closed-loop within a few control steps at 60 substeps, so
short episodes at 10 substeps keep the two trajectories together. The env
arguments make the counted event happen in some episodes and not in all,
so that no comparison is 0 = 0 by construction: AntTag with tag_radius 2.5
and spawns from 1 m, HeavenHell with both goals' radius 7.6 (some ants
start inside one), the corridor maze 3 of length 0 at scaling 1.05 (a goal
one cell away), and the masked pendulum at 100 steps, which falls. Counts and rates
must be equal; returns, displacements and lengths within rtol 1e-4.
`gather_eval` and `goal_rate_rnn` with the committed policies are in
tests/test_torch_examples_checkpoints.py.
"""

import jax
import jax.numpy as jnp
import pytest
import torch

import examples.train_ant_maze_rnn as jmaze
import examples.train_ant_tag as jtag
import examples.train_ant_tag_rnn as jtag_rnn
import examples.train_heavenhell_rnn as jhh
import examples.train_masked_ant as jmasked_ant
import examples.train_masked_pendulum as jpendulum
from pobrax_tpu.envs import _envs as jenvs
from pobrax_tpu.envs.masked import MaskedObservationWrapper as JMasked
from pobrax_tpu.training import ppo as jppo
from pobrax_tpu.training import ppo_rnn as jrnn
from pobrax_tpu_torch import interop
from pobrax_tpu_torch.envs import _envs
from pobrax_tpu_torch.examples import (train_ant_maze_rnn, train_ant_tag, train_ant_tag_rnn,
                                       train_heavenhell_rnn, train_masked_ant,
                                       train_masked_pendulum)
from pobrax_tpu_torch.training import ppo, ppo_rnn

torch.set_num_threads(1)

EPISODES, LENGTH, HIDDEN = 16, 30, 16
TAG = dict(tag_radius=2.5, min_spawn_distance=1.0)
HH = dict(visible_radius=7.6)
MAZE = dict(maze_id=3, length=0, scaling=1.05)
RTOL = 1e-4
PENDULUM_LENGTH = 100  # a cheap env: long enough for every policy to drop a pole


def _jrandom(action_size):
    return lambda obs, k: jax.random.uniform(k, obs.shape[:-1] + (action_size,), minval=-1.0,
                                             maxval=1.0)


def _policies(jcore, core, rnn):
    """(JAX inference fn, JAX params tuple, port inference fn, port params
    tuple) of a freshly initialised GRU-PPO (hidden 16) or PPO learner."""
    if rnn:
        sizes = dict(num_envs=8, hidden_size=HIDDEN, encoder_sizes=(32,))
        jl = jrnn.RNNPPOLearner(jcore, jrnn.RNNPPOConfig(**sizes))
        tl = ppo_rnn.RNNPPOLearner(core, ppo_rnn.RNNPPOConfig(**sizes))
    else:
        jl = jppo.PPOLearner(jcore, jppo.PPOConfig(num_envs=8))
        tl = ppo.PPOLearner(core, ppo.PPOConfig(num_envs=8))
    jts = jax.device_get(jl.init(jax.random.PRNGKey(3)))
    ts = interop.training_state_from_numpy(jts, tl)
    jparams = (jts.normalizer, jts.params if rnn else jts.params.policy)
    return jl.make_inference_fn(), jparams, tl.make_inference_fn(), tl.inference_params(ts)


def test_tag_rate_random():
    core = _envs["ant_tag"](device="cpu", **TAG)
    kw = dict(episodes=EPISODES, episode_length=LENGTH, seed=2)
    want = jtag.tag_rate(jenvs["ant_tag"](**TAG), _jrandom(core.action_size), **kw)
    got = train_ant_tag.tag_rate(core, train_ant_tag.random_act(core.action_size), **kw)
    assert 0 < want < 1
    assert got == want


@pytest.mark.parametrize("deterministic", [True, False], ids=["det", "stoch"])
def test_tag_rate_rnn(deterministic):
    core = _envs["ant_tag"](device="cpu", **TAG)
    jcore = jenvs["ant_tag"](**TAG)
    jinf, jparams, inf, params = _policies(jcore, core, rnn=True)
    kw = dict(episodes=EPISODES, episode_length=LENGTH, seed=1, deterministic=deterministic)
    want = jtag_rnn.tag_rate_rnn(jcore, jinf, jparams, HIDDEN, **kw)
    got = train_ant_tag_rnn.tag_rate_rnn(core, inf, params, HIDDEN, **kw)
    assert 0 < want < 1
    assert got == want


@pytest.mark.parametrize("policy", ["random", "gru"])
def test_outcome_rates(policy):
    core = _envs["ant_heavenhell"](device="cpu", **HH)
    jcore = jenvs["ant_heavenhell"](**HH)
    kw = dict(episodes=EPISODES, episode_length=LENGTH, seed=3)
    if policy == "random":
        want = jhh.outcome_rates(
            jcore, lambda c, obs, k: (c, _jrandom(core.action_size)(obs, k)),
            carry_init=lambda n: jnp.zeros(n), **kw)
        got = train_heavenhell_rnn.outcome_rates(
            core, **train_heavenhell_rnn.random_policy(core.action_size, "cpu"), **kw)
    else:
        jinf, jparams, inf, params = _policies(jcore, core, rnn=True)
        want = jhh.outcome_rates(
            jcore, lambda h, obs, k: jinf(jparams, h, obs, k, deterministic=True),
            carry_init=lambda n: jnp.zeros((n, HIDDEN)), **kw)
        got = train_heavenhell_rnn.outcome_rates(
            core, **train_heavenhell_rnn.gru_policy(inf, params, HIDDEN, "cpu", True), **kw)
    assert 0 < want[0] < 1 and 0 < want[1] < 1  # some complete, in both outcomes
    assert got == pytest.approx(want, rel=1e-6)


def test_goal_rate_random():
    kw = dict(episodes=EPISODES, episode_length=LENGTH, seed=0)
    want = jmaze.goal_rate_random(jenvs["ant_maze"](**MAZE), **kw)
    got = train_ant_maze_rnn.goal_rate_random(_envs["ant_maze"](device="cpu", **MAZE), **kw)
    assert 0 < want < 1
    assert got == want


@pytest.mark.parametrize("rnn", [False, True], ids=["ppo", "gru"])
def test_eval_policy_masked_ant(monkeypatch, rnn):
    monkeypatch.setattr(jmasked_ant, "EPISODE_LENGTH", LENGTH)
    monkeypatch.setattr(train_masked_ant, "EPISODE_LENGTH", LENGTH)
    jcore = JMasked(jenvs["ant"](), env_name="ant", hidden=("VELOCITY",))
    core = train_masked_ant.masked_env("cpu", "ant")
    jinf, jparams, inf, params = _policies(jcore, core, rnn)
    if rnn:
        want = jmasked_ant.eval_policy(
            jcore, lambda h, obs, k: jinf(jparams, h, obs, k, deterministic=True),
            carry_init=lambda n: jnp.zeros((n, HIDDEN)), episodes=EPISODES)
        got = train_masked_ant.eval_policy(
            core, lambda h, obs, k: inf(params, h, obs, k, deterministic=True),
            carry_init=lambda n: torch.zeros(n, HIDDEN), episodes=EPISODES)
    else:
        want = jmasked_ant.eval_policy(
            jcore, lambda c, obs, k: (c, jinf(jparams, obs, k, deterministic=True)),
            episodes=EPISODES)
        got = train_masked_ant.eval_policy(
            core, lambda c, obs, k: (c, inf(params, obs, k, deterministic=True)),
            episodes=EPISODES)
    assert want["episode_reward"] != 0 and want["x_displacement"] != 0
    assert got == pytest.approx(want, rel=RTOL)


@pytest.mark.parametrize("rnn", [False, True], ids=["ppo", "gru"])
def test_mean_length_masked_pendulum(monkeypatch, rnn):
    monkeypatch.setattr(jpendulum, "EPISODE_LENGTH", PENDULUM_LENGTH)
    monkeypatch.setattr(train_masked_pendulum, "EPISODE_LENGTH", PENDULUM_LENGTH)
    jcore, core = jpendulum.masked_env(), train_masked_pendulum.masked_env("cpu")
    jinf, jparams, inf, params = _policies(jcore, core, rnn)
    if rnn:
        want = jpendulum.mean_length(
            jcore, lambda h, obs, k: jinf(jparams, h, obs, k, deterministic=True),
            carry_init=lambda n: jnp.zeros((n, HIDDEN)), episodes=EPISODES, seed=4)
        got = train_masked_pendulum.mean_length(
            core, lambda h, obs, k: inf(params, h, obs, k, deterministic=True),
            carry_init=lambda n: torch.zeros(n, HIDDEN), episodes=EPISODES, seed=4)
    else:
        want = jpendulum.mean_length(
            jcore, lambda c, obs, k: (c, jinf(jparams, obs, k, deterministic=True)),
            episodes=EPISODES, seed=4)
        got = train_masked_pendulum.mean_length(
            core, lambda c, obs, k: (c, inf(params, obs, k, deterministic=True)),
            episodes=EPISODES, seed=4)
    assert 1 < want < PENDULUM_LENGTH  # some episodes end before the cap
    assert got == pytest.approx(want, rel=RTOL)
