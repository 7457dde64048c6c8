"""The examples' shaped training wrappers against the JAX examples', on the CPU.

For `ShapedAntTag` (shaping gamma 1 and 0.97), `ShapedHeavenHell`,
`ShapedAntGather` (bomb_coef 0 and 0.3) and `ShapedAntMaze`, a batch of JAX
states (seeded resets, then random steps) is carried into the port with
`interop.state_from_numpy`:
  * the potential (or distance) of every env equals the JAX example's, to
    1e-6 relative;
  * one shaped step from JAX's state: the port's shaped reward equals
    JAX's within the physics tolerance (pos 1e-5, tests/test_fused.py)
    times coef, and the shaping term alone (shaped minus the core env's
    reward) likewise;
  * AntGather: with whole ants teleported onto a live apple, the catch steps
    are masked (shaped reward == true reward exactly) in both packages;
  * AntMaze: the clipped bilinear lookup at subcell centres and edges, at
    points between them, and clipped beyond every corner of the field.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from examples.train_ant_gather_rnn import ShapedAntGather as JShapedAntGather
from examples.train_ant_maze_rnn import ShapedAntMaze as JShapedAntMaze
from examples.train_ant_tag import ShapedAntTag as JShapedAntTag
from examples.train_heavenhell_rnn import ShapedHeavenHell as JShapedHeavenHell
from pobrax_tpu.envs import _envs as jenvs
from pobrax_tpu_torch import interop
from pobrax_tpu_torch.envs import _envs
from pobrax_tpu_torch.examples.train_ant_gather_rnn import ShapedAntGather
from pobrax_tpu_torch.examples.train_ant_maze_rnn import ShapedAntMaze
from pobrax_tpu_torch.examples.train_ant_tag import ShapedAntTag
from pobrax_tpu_torch.examples.train_heavenhell_rnn import ShapedHeavenHell

torch.set_num_threads(1)

B = 16
TOL_POS = 1e-5  # tests/test_fused.py's pos tolerance, per control step
ANT_BODIES = 9


@functools.lru_cache(maxsize=None)
def _jax_core(name):
    """A JAX core env and its jitted batched reset and step, built once."""
    jcore = jenvs[name]()
    return jcore, jax.jit(jax.vmap(jcore.reset)), jax.jit(jax.vmap(jcore.step))


def _jax_states(name, warm, seed=0):
    """B seeded JAX resets, then `warm` steps of random actions."""
    jcore, reset, step = _jax_core(name)
    state = reset(jax.random.split(jax.random.PRNGKey(seed), B))
    rng = np.random.default_rng(seed)
    for _ in range(warm):
        state = step(state, jnp.asarray(rng.uniform(-1, 1, (B, jcore.action_size)), jnp.float32))
    return state


def _port(x):
    return interop.state_from_numpy(jax.device_get(x), device="cpu")


def _step_both(name, jshaped, shaped, jstate, seed=1):
    """One shaped step and one core step from JAX's state in each package:
    -> (JAX shaped, JAX core, port shaped, port core) rewards, JAX's and the
    port's shaped states."""
    act = np.random.default_rng(seed).uniform(-1, 1, (B, shaped.action_size)).astype(np.float32)
    js = jax.jit(jax.vmap(jshaped.step))(jstate, jnp.asarray(act))
    jc = _jax_core(name)[2](jstate, jnp.asarray(act))
    ps = shaped.step(_port(jstate), torch.as_tensor(act))
    pc = shaped.unwrapped.step(_port(jstate), torch.as_tensor(act))
    return (np.asarray(js.reward), np.asarray(jc.reward), ps.reward.numpy(), pc.reward.numpy(),
            js, ps)


def _check_step(name, jshaped, shaped, jstate, coef):
    jr_, jc, pr, pc, _, _ = _step_both(name, jshaped, shaped, jstate)
    tol = 2 * TOL_POS * abs(coef)
    np.testing.assert_allclose(pr - pc, jr_ - jc, rtol=0, atol=tol)
    np.testing.assert_allclose(pr, jr_, rtol=0, atol=tol + 1e-6)
    assert np.abs(jr_ - jc).max() > 10 * tol  # the shaping term is well above the tolerance


@pytest.mark.parametrize("gamma", [1.0, 0.97])
def test_shaped_ant_tag(gamma):
    jshaped = JShapedAntTag(_jax_core("ant_tag")[0], coef=5.0, gamma=gamma)
    shaped = ShapedAntTag(_envs["ant_tag"](device="cpu"), coef=5.0, gamma=gamma)
    jstate = _jax_states("ant_tag", warm=5)
    want = np.asarray(jax.vmap(jshaped._dist)(jstate.qp))
    np.testing.assert_allclose(shaped._dist(_port(jstate).qp).numpy(), want, rtol=1e-6, atol=0)
    _check_step("ant_tag", jshaped, shaped, jstate, 5.0)


def test_shaped_heavenhell():
    jshaped = JShapedHeavenHell(_jax_core("ant_heavenhell")[0], coef=5.0)
    shaped = ShapedHeavenHell(_envs["ant_heavenhell"](device="cpu"), coef=5.0)
    jstate = _jax_states("ant_heavenhell", warm=5, seed=2)
    want = np.asarray(jax.vmap(jshaped._dist)(jstate.qp))
    np.testing.assert_allclose(shaped._dist(_port(jstate).qp).numpy(), want, rtol=1e-6, atol=0)
    _check_step("ant_heavenhell", jshaped, shaped, jstate, 5.0)


@pytest.mark.parametrize("bomb_coef", [0.0, 0.3])
def test_shaped_ant_gather(bomb_coef):
    jshaped = JShapedAntGather(_jax_core("ant_gather")[0], coef=5.0, bomb_coef=bomb_coef)
    shaped = ShapedAntGather(_envs["ant_gather"](device="cpu"), coef=5.0, bomb_coef=bomb_coef)
    ju = jshaped.unwrapped
    jstate = _jax_states("ant_gather", warm=3, seed=3)
    # half the envs: the whole ant moved onto its nearest apple, so the step
    # catches it; one apple of the other half lifted to the sky (not live)
    pos = np.array(jstate.qp.pos)
    objects = np.asarray(ju.object_indices)
    torso = ju.torso_idx
    for b in range(B):
        apple = objects[np.argmin(np.linalg.norm(pos[b, objects[:ju.n_apples], :2]
                                                 - pos[b, torso, :2], axis=1))]
        if b < B // 2:
            pos[b, torso:torso + ANT_BODIES, :2] += pos[b, apple, :2] - pos[b, torso, :2]
        else:
            pos[b, apple, 2] += 12.0
    jstate = jstate.replace(qp=jstate.qp.replace(pos=jnp.asarray(pos)))
    want = np.asarray(jax.vmap(jshaped._phi)(jstate.qp))
    np.testing.assert_allclose(shaped._phi(_port(jstate).qp).numpy(), want, rtol=1e-6, atol=0)
    jr_, jc, pr, pc, js, ps = _step_both("ant_gather", jshaped, shaped, jstate)
    caught = np.asarray(js.metrics["apples"] + js.metrics["bombs"]) > 0
    np.testing.assert_array_equal((ps.metrics["apples"] + ps.metrics["bombs"]).numpy() > 0,
                                  caught)
    assert caught[:B // 2].all() and not caught[B // 2:].any()
    # the catch steps: the true reward alone, in both packages
    np.testing.assert_array_equal(jr_[caught], jc[caught])
    np.testing.assert_array_equal(pr[caught], pc[caught])
    np.testing.assert_array_equal(pr[caught], jr_[caught])
    tol = 2 * TOL_POS * 5.0
    np.testing.assert_allclose(pr - pc, jr_ - jc, rtol=0, atol=tol)
    assert np.abs(jr_ - jc)[~caught].max() > 10 * tol


def test_shaped_ant_maze_bilinear_lookup_and_step():
    jshaped = JShapedAntMaze(_jax_core("ant_maze")[0], coef=5.0)
    shaped = ShapedAntMaze(_envs["ant_maze"](device="cpu"), coef=5.0)
    np.testing.assert_array_equal(shaped._field.numpy(), np.asarray(jshaped._field))
    assert (shaped._x0, shaped._y0, shaped._res) == (jshaped._x0, jshaped._y0, jshaped._res)
    rows, cols = shaped._field.shape
    x0, y0, res = shaped._x0, shaped._y0, shaped._res
    # grid coordinates (a, b): subcell centres (integers), half-way points,
    # the last cell's far edge, and points beyond each side and corner
    a = np.array([0, 0, 3, 7.5, rows - 1, rows - 1.001, rows - 1, -2, rows + 3, -5, rows + 5,
                  12.25, 0.5, rows / 2, -1, rows + 1], np.float64)
    b = np.array([0, cols - 1, 4, 2.5, 0, cols - 1.001, cols - 1, 3, 3, -5, cols + 5, 17.75,
                  cols + 2, -3, cols + 1, -1], np.float64)
    xy = np.stack([x0 + b * res, y0 - a * res], -1).astype(np.float32)
    jstate = _jax_states("ant_maze", warm=0, seed=4)
    pos = np.array(jstate.qp.pos)
    pos[:, jshaped.unwrapped.torso_idx, :2] = xy
    qp = jstate.qp.replace(pos=jnp.asarray(pos))
    want = np.asarray(jax.vmap(jshaped._phi)(qp))
    got = shaped._phi(interop.qp_from_numpy(jax.device_get(qp), device="cpu")).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # beyond the field the lookup is the clipped edge's value
    assert got[9] == pytest.approx(-shaped._field[0, 0].item(), abs=1e-6)
    # one shaped step from JAX's state after a few random steps
    _check_step("ant_maze", jshaped, shaped, _jax_states("ant_maze", warm=5, seed=5), 5.0)
