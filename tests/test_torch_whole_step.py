"""The whole-step kernel's wrapper: dispatch, input checks, cost, and — on a
GPU — the kernel itself against the plain step.

Imports no jax, so the card tests run on a machine with only PyTorch:
    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_whole_step.py
The `cuda` tests skip where `torch.cuda.is_available()` is false.
"""

import numpy as np
import pytest
import torch

from pobrax_tpu_torch import random as jr
from pobrax_tpu_torch.envs import create
from pobrax_tpu_torch.envs.ant_tag import AntTagEnv
from pobrax_tpu_torch.physics import config as c
from pobrax_tpu_torch.physics import step_tables, whole_step
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
    before, by_shape = whole_step.launches, dict(whole_step.launches_by_shape)
    q1, i1 = whole_step.whole_step(env.sys, qp, act)
    q2, i2 = env.sys.step_generic(qp, act)
    assert whole_step.launches == before
    assert whole_step.launches_by_shape == by_shape
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
    assert cost["bytes"] == 4 * 4096 * (12 * 13 + 8 + 12 * 31) + 4 * 1834
    assert cost["flops"] > 1e9
    ms, by = whole_step.bound_ms(sys_, 4096)
    assert by == "operations" and 0.01 < ms < 0.03
    assert whole_step.cost(sys_, 8)["flops"] * 512 == cost["flops"]


@pytest.mark.parametrize("name", ["humanoid", "grasp"])
def test_cost_of_stock_systems(name):
    """Every System the kernel covers gets a bound; which of the two holds
    follows from its rows (humanoid's 17 dofs and 20 ground rows, grasp's 9
    two-body capsule rows over 16 substeps are both operation-bound)."""
    sys_ = create(name, device="cpu").sys
    cost = whole_step.cost(sys_, 4096)
    assert cost["flops"] > 0 and cost["bytes"] > 0
    ms, by = whole_step.bound_ms(sys_, 4096)
    assert ms > 0 and by == "operations"
    assert whole_step.cost(sys_, 8)["flops"] * 512 == cost["flops"]


def test_cost_of_pass_through_and_contact_info():
    """AntGather has AntTag's rows and 15 more bodies that pass through: the
    same operations, and their bytes (13 words in, 31 out each). The
    contact-only variant drops the 12 joint and actuator Info sums of each of
    AntTag's 11 slots per substep and 12 words out per body."""
    tag_sys = AntTagEnv(device="cpu").sys
    gather_sys = create("ant_gather", device="cpu").sys
    tag, gather = whole_step.cost(tag_sys, 4096), whole_step.cost(gather_sys, 4096)
    contact = whole_step.cost(AntTagEnv(device="cpu", info="contact").sys, 4096)
    table_bytes = [step_tables.pack(step_tables.build(s)).nbytes for s in (tag_sys, gather_sys)]
    assert gather["flops"] == tag["flops"]
    assert (gather["bytes"] - tag["bytes"]
            == 4 * 4096 * 15 * (13 + 31) + table_bytes[1] - table_bytes[0])
    assert tag["flops"] - contact["flops"] == 12 * 11 * 10 * 4096
    assert tag["bytes"] - contact["bytes"] == 4 * 4096 * 12 * 12
    assert whole_step.bound_ms(create("ant_maze", device="cpu").sys, 4096)[1] == "operations"


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(cuda):
    env = AntTagEnv(device=cuda)
    B = 512
    qp, act = _batch(env, B, 30, cuda)
    before = whole_step.launches
    shape = (env.sys.config.substeps, B)
    shape_before = whole_step.launches_by_shape.get(shape, 0)
    qk, ik = whole_step.launch(env.sys, qp, act)
    qg, ig = env.sys.step_generic(qp, act)
    torch.cuda.synchronize()
    assert whole_step.launches == before + 1
    assert whole_step.launches_by_shape[shape] == shape_before + 1
    err = lambda a, b: (a - b).abs().flatten(1).max(1).values
    agree = ((err(qk.pos, qg.pos) <= 1e-5) & (err(qk.rot, qg.rot) <= 1e-5)
             & (err(qk.vel, qg.vel) <= 1e-3) & (err(qk.ang, qg.ang) <= 1e-3))
    # contact onsets may flip in a few envs (see chip_smoke.py)
    assert float(agree.float().mean()) >= 0.995
    for t in (qk.pos, qk.rot, qk.vel, qk.ang, ik.contact.vel, ik.joint.ang):
        assert bool(torch.isfinite(t).all())


def _agree(qk, qg):
    err = lambda a, b: (a - b).abs().flatten(1).max(1).values
    return ((err(qk.pos, qg.pos) <= 1e-5) & (err(qk.rot, qg.rot) <= 1e-5)
            & (err(qk.vel, qg.vel) <= 1e-3) & (err(qk.ang, qg.ang) <= 1e-3))


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 5, 4095])
def test_ragged_batch_on_card(cuda, B):
    """Batches that leave the last block partly idle (the block holds
    ENVS_PER_BLOCK envs, two per warp): a warp with no env leaves, the idle
    half of a warp steps along and stores nothing, every env is written and
    agrees with the plain step; 256 of the 4095 ants lean on an arena wall."""
    env = AntTagEnv(device=cuda)
    qp, act = _batch(env, B, 30, cuda)
    if B > 256:
        pos = qp.pos.clone()
        pos[:256, env.ant_slice, 0] += 5.15 - pos[:256, env.torso_idx:env.torso_idx + 1, 0]
        qp = qp.replace(pos=pos)
        assert bool((env.sys.contacts._capsule_box(qp)[4] > 0).any())
    assert B % step_tables.ENVS_PER_BLOCK != 0 or B == 1
    qk, ik = whole_step.launch(env.sys, qp, act)
    qg, _ = env.sys.step_generic(qp, act)
    torch.cuda.synchronize()
    assert float(_agree(qk, qg).float().mean()) >= 0.995
    for t in (qk.pos, qk.rot, qk.vel, qk.ang, ik.contact.vel, ik.joint.ang):
        assert bool(torch.isfinite(t).all())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ant_tag", "ant_maze", "humanoid"])
def test_resident_warps_on_card(cuda, name):
    """At least 16 warps (32 envs) per SM, so that each of the SM's four
    schedulers has warps to switch between, and 4096 envs fit one wave."""
    assert whole_step.resident_warps(create(name, device=cuda).sys) >= 16


def many_spheres(n):
    """Two bodies of n spheres each that collide: n * n sphere-sphere rows."""
    balls = tuple(c.Collider(geom=c.Sphere(0.1), position=(0.01 * k, 0.0, 0.0))
                  for k in range(n))
    return c.Config(bodies=(c.Body(name="a", colliders=balls), c.Body(name="b", colliders=balls)),
                    collide_include=(("a", "b"),))


def overlapping(sys_, B, seed, device):
    """Both bodies at the origin, jittered by 3 cm so their spheres overlap
    with well-defined normals, with random velocities and actions."""
    rs = np.random.RandomState(seed)
    qp0 = sys_.default_qp()
    n = sys_.num_bodies
    as_t = lambda a: torch.from_numpy(a.astype(np.float32)).to(device)
    qp = qp0.replace(pos=qp0.pos + as_t(0.03 * rs.randn(B, n, 3)),
                     rot=qp0.rot.expand(B, n, 4).contiguous(),
                     vel=as_t(0.3 * rs.randn(B, n, 3)), ang=as_t(0.3 * rs.randn(B, n, 3)))
    return qp, as_t(rs.uniform(-1, 1, (B, sys_.action_size)))


@pytest.mark.cuda
def test_kernel_above_48_kb_of_shared_memory_on_card(cuda):
    """15 x 15 = 225 two-body rows: a block needs more than the 48 KB of
    shared memory a kernel gets by default, so the launch first lifts the
    kernel's limit (cudaFuncSetAttribute). The occupancy calculator then
    finds at least one block a SM, and the step agrees with the plain one."""
    sys_ = System(many_spheres(15), device=cuda)
    assert 48 * 1024 < whole_step.shared_bytes(sys_) <= step_tables.SHARED_LIMIT
    qp, act = overlapping(sys_, 1001, 3, cuda)
    before = whole_step.launches
    qk, ik = whole_step.launch(sys_, qp, act)
    qg, ig = sys_.step_generic(qp, act)
    torch.cuda.synchronize()
    assert whole_step.launches == before + 1
    assert bool((ig.contact.vel.abs().flatten(1).max(1).values > 0).all()), "contacts live"
    assert float(_agree(qk, qg).float().mean()) >= 0.995
    for t in (qk.pos, qk.rot, qk.vel, qk.ang, ik.contact.vel):
        assert bool(torch.isfinite(t).all())
    assert whole_step.resident_warps(sys_) >= 4


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
    """More bodies than the kernel holds: System.step raises on CUDA tensors
    and never falls back to the plain step."""
    cfg = c.Config(bodies=tuple(c.Body(name=f"b{i}") for i in range(17)))
    sys_ = System(cfg, device=cuda)
    qp = sys_.default_qp()
    before = whole_step.launches
    with pytest.raises(ValueError, match="MAX_BODIES"):
        sys_.step(qp, torch.zeros(1, 0, device=cuda))
    assert whole_step.launches == before


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
