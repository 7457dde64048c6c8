"""The whole-step kernel's wrapper: dispatch, input checks, cost, and — on a
GPU — the kernel itself against the plain step.

Imports no jax, so the card tests run on a machine with only PyTorch:
    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_whole_step.py
The `cuda` tests skip where `torch.cuda.is_available()` is false.
"""

import pytest
import torch

from pobrax_tpu_torch import random as jr
from pobrax_tpu_torch.envs import create
from pobrax_tpu_torch.envs.ant_tag import AntTagEnv
from pobrax_tpu_torch.physics import config as c
from pobrax_tpu_torch.physics import whole_step
from pobrax_tpu_torch.physics.system import System


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _batch(env, B, steps, dev):
    qp = env.reset(jr.split(jr.PRNGKey(2, dev), B)).qp
    g = torch.Generator(device=dev).manual_seed(0)
    for _ in range(steps):
        qp, _ = env.sys.step_generic(qp, torch.rand(B, 8, generator=g, device=dev) * 2 - 1)
    return qp, torch.rand(B, 8, generator=g, device=dev) * 2 - 1


def test_cpu_tensors_run_the_plain_step():
    env = AntTagEnv(device="cpu")
    qp, act = _batch(env, 4, 2, torch.device("cpu"))
    before = whole_step.launches
    q1, i1 = whole_step.whole_step(env.sys, qp, act)
    q2, i2 = env.sys.step_generic(qp, act)
    assert whole_step.launches == before
    torch.testing.assert_close(q1.pos, q2.pos, rtol=0, atol=0)
    torch.testing.assert_close(i1.contact.vel, i2.contact.vel, rtol=0, atol=0)


def test_launch_refuses_cpu_tensors():
    env = AntTagEnv(device="cpu")
    qp, act = _batch(env, 2, 0, torch.device("cpu"))
    with pytest.raises(ValueError, match="CUDA"):
        whole_step.launch(env.sys, qp, act)


def test_cost_of_ant_tag_is_operation_bound():
    sys_ = AntTagEnv(device="cpu").sys
    cost = whole_step.cost(sys_, 4096)
    # state + act in, state + six Info arrays out, float32, plus the tables
    assert cost["bytes"] == 4 * 4096 * (12 * 13 + 8 + 12 * 31) + 4 * 1556
    assert cost["flops"] > 1e9
    ms, by = whole_step.bound_ms(sys_, 4096)
    assert by == "operations" and 0.01 < ms < 0.03
    assert whole_step.cost(sys_, 8)["flops"] * 512 == cost["flops"]


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(cuda):
    env = AntTagEnv(device=cuda)
    B = 512
    qp, act = _batch(env, B, 30, cuda)
    before = whole_step.launches
    qk, ik = whole_step.launch(env.sys, qp, act)
    qg, ig = env.sys.step_generic(qp, act)
    torch.cuda.synchronize()
    assert whole_step.launches == before + 1
    err = lambda a, b: (a - b).abs().flatten(1).max(1).values
    agree = ((err(qk.pos, qg.pos) <= 1e-5) & (err(qk.rot, qg.rot) <= 1e-5)
             & (err(qk.vel, qg.vel) <= 1e-3) & (err(qk.ang, qg.ang) <= 1e-3))
    # contact onsets may flip in a few envs (see chip_smoke.py)
    assert float(agree.float().mean()) >= 0.995
    for t in (qk.pos, qk.rot, qk.vel, qk.ang, ik.contact.vel, ik.joint.ang):
        assert bool(torch.isfinite(t).all())


@pytest.mark.cuda
def test_kernel_checks_its_inputs_on_card(cuda):
    env = AntTagEnv(device=cuda)
    qp, act = _batch(env, 8, 0, cuda)
    with pytest.raises(ValueError, match="float32"):
        whole_step.launch(env.sys, qp.replace(pos=qp.pos.double()), act)
    with pytest.raises(ValueError, match="contiguous"):
        whole_step.launch(env.sys, qp, act.t().contiguous().t())
    with pytest.raises(ValueError, match="shape"):
        whole_step.launch(env.sys, qp, act[:, :4])


@pytest.mark.cuda
def test_uncovered_system_raises_on_card(cuda):
    cfg = c.Config(bodies=(c.Body(name="cart"),),
                   thrusters=(c.Thruster(name="t", body="cart", strength=1.0),))
    sys_ = System(cfg, device=cuda)
    qp = sys_.default_qp()
    with pytest.raises(ValueError, match="thrusters"):
        sys_.step(qp, torch.zeros(1, 1, device=cuda))


@pytest.mark.cuda
def test_env_steps_launch_the_kernel_on_card(cuda):
    env = create("ant_tag", batch_size=64, randomized_autoreset=True, autoreset_mode="cached",
                 device=cuda)
    s = env.reset(jr.PRNGKey(0, cuda))
    before = whole_step.launches
    for _ in range(5):
        s = env.step(s, torch.zeros(64, 8, device=cuda))
    assert whole_step.launches == before + 5
    assert bool(torch.isfinite(s.obs).all())
