"""The port stands alone: no jax (nor flax, optax, orbax), no `pobrax_tpu`,
and no silent CPU fallback.

A fresh interpreter imports every module of `pobrax_tpu_torch` and
chip_smoke.py's module-level imports; neither jax nor `pobrax_tpu` may be
loaded after. `import pobrax_tpu_torch` alone (which imports its eight
subpackages, as the JAX package does) loads no jax and touches no device:
CUDA stays uninitialised and the kernel library unbuilt. Every name of each
JAX `__init__`'s `__all__` resolves in the port's counterpart, but for the
by-design exceptions (`BY_DESIGN`). Entry points given no device raise on a
CPU-only torch rather than running on the CPU.
"""

import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
sys.path.insert(0, {root!r})
import pobrax_tpu_torch
names = [m.name for m in pkgutil.walk_packages(pobrax_tpu_torch.__path__, "pobrax_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke  # its module-level imports; main() does not run on import
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax", "pobrax_tpu"))
print(len(names), bad)
assert not bad, bad
missing = ({{"pobrax_tpu_torch.envs." + m for m in
            ("ant", "ant_heavenhell", "ant_gather", "ant_maze", "maze_utils", "exploration",
             "fast", "planar", "acrobot", "gym_adapter")}}
           | {{"pobrax_tpu_torch.physics.planar", "pobrax_tpu_torch.io.html",
               "pobrax_tpu_torch.parallel.health", "pobrax_tpu_torch.parallel.mesh",
               "pobrax_tpu_torch.graft_entry", "pobrax_tpu_torch.multihost_train"}}
           | {{"pobrax_tpu_torch.utils." + m for m in ("profiling", "metrics_writer", "debug")}}
           | {{"pobrax_tpu_torch.training." + m for m in
              ("ppo", "ppo_rnn", "distribution", "running_statistics", "optimizer",
               "checkpoint", "replay", "sac", "sac_rnn")}}
           | {{"pobrax_tpu_torch.models.networks", "pobrax_tpu_torch.eval_tag_checkpoint",
               "pobrax_tpu_torch.eval_checkpoint", "pobrax_tpu_torch.bench",
               "pobrax_tpu_torch.bench_scaling"}}
           | {{"pobrax_tpu_torch.tools." + m for m in
              ("bench_train", "bench_substeps", "ablate_bench", "roofline", "autoreset_study",
               "substeps_probe", "overlap_study", "ant_speed_probe", "per_study",
               "render_gather_policy", "render_maze_policy", "paired_seeds")}}
           | {{"pobrax_tpu_torch.examples." + m for m in
              ("train_ant_tag", "train_ant_tag_rnn", "train_ant_tag_sac_rnn",
               "train_ant_tag_sac_rnn_carry", "train_heavenhell_rnn", "train_heavenhell_sac_rnn",
               "train_ant_gather_rnn", "train_ant_maze_rnn", "train_masked_ant",
               "train_masked_pendulum", "train_sac_rnn_pendulum", "train_ppo", "train_sac",
               "rollout_demo", "visualize")}}) \
    - set(names)
assert not missing, missing
"""


def test_port_and_chip_smoke_import_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE.format(root=ROOT)], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 20


_IMPORT_PROBE = r"""
import sys
sys.path.insert(0, {root!r})
import pobrax_tpu_torch
import torch
from pobrax_tpu_torch.physics import whole_step
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax", "pobrax_tpu",
                                    "triton"))
assert not bad, bad
assert not torch.cuda.is_initialized()
assert whole_step._lib is None
print(sorted(pobrax_tpu_torch.__all__))
"""


def test_import_of_the_package_loads_no_jax_and_touches_no_device():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _IMPORT_PROBE.format(root=ROOT)], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "'training'" in out.stdout


# JAX names the port leaves out by design (ROADMAP.md): `FeedForwardModel`
# (a flax module's init / apply pair: the port's nets are nn.Modules), and
# `data_sharding` / `replicated` (jax.sharding placements: a rank of the
# port's 'data' mesh holds its block itself)
BY_DESIGN = {"models": {"FeedForwardModel"}, "parallel": {"data_sharding", "replicated"}}


@pytest.mark.parametrize("sub", ["", "envs", "io", "models", "ops", "parallel", "physics",
                                 "training", "utils"])
def test_every_jax_export_resolves_in_the_port(sub):
    import importlib

    jmod = importlib.import_module("pobrax_tpu" + (f".{sub}" if sub else ""))
    mod = importlib.import_module("pobrax_tpu_torch" + (f".{sub}" if sub else ""))
    missing = {n for n in jmod.__all__ if not hasattr(mod, n)}
    assert missing == BY_DESIGN.get(sub, set()), missing
    for n in jmod.__all__:
        if n in missing:
            continue
        got = getattr(mod, n)
        if isinstance(got, type(os)):  # a re-exported module is the port's own
            assert got.__name__.startswith("pobrax_tpu_torch."), got.__name__


def test_entry_points_without_device_raise_on_cpu_only_torch(monkeypatch):
    from pobrax_tpu_torch.envs import _envs, create, create_gym_env
    from pobrax_tpu_torch.envs.ant_tag import AntTagEnv, extend_ant_cfg
    from pobrax_tpu_torch.physics import System

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in sorted(_envs):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            create(name, batch_size=2)
    for batch_size in (None, 4):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            create_gym_env("walker2d", batch_size=batch_size)
    with pytest.raises(RuntimeError):
        AntTagEnv()
    with pytest.raises(RuntimeError):
        System(extend_ant_cfg())
    # the learners and the checkpoint replay resolve the card the same way
    from pobrax_tpu_torch import eval_checkpoint, eval_tag_checkpoint, graft_entry
    from pobrax_tpu_torch.examples import train_ant_tag_rnn, visualize
    from pobrax_tpu_torch.parallel import mesh
    from pobrax_tpu_torch.envs.fast import Fast
    from pobrax_tpu_torch.models import networks
    from pobrax_tpu_torch.envs.ant import Ant
    from pobrax_tpu_torch.envs.planar import Halfcheetah, Hopper, Walker2d
    from pobrax_tpu_torch.envs.acrobot import Acrobot
    from pobrax_tpu_torch.training import ppo, ppo_rnn, running_statistics, sac, sac_rnn
    from pobrax_tpu_torch.utils import debug
    for call in (lambda: ppo.train(Fast(), num_timesteps=1),
                 lambda: ppo_rnn.train(Fast(), num_timesteps=1),
                 lambda: sac.train(Fast(), num_timesteps=1),
                 lambda: sac_rnn.train(Fast(), num_timesteps=1),
                 lambda: Ant(),
                 lambda: Halfcheetah(), lambda: Hopper(), lambda: Walker2d(), lambda: Acrobot(),
                 lambda: debug.assert_deterministic(lambda key: key),
                 lambda: eval_tag_checkpoint.load(eval_tag_checkpoint.SAC_NPZ, sac=True),
                 lambda: networks.make_model([4], 3),
                 lambda: running_statistics.init_state(3),
                 lambda: eval_tag_checkpoint.load(),
                 lambda: graft_entry.entry(),
                 lambda: eval_checkpoint.load("maze"),
                 lambda: train_ant_tag_rnn.main(1, 8),
                 lambda: visualize.main("ant_tag", 1),
                 lambda: mesh.make_mesh()):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    # asking for the CPU works
    assert create("ant_tag", batch_size=2, device="cpu").unwrapped.sys.device.type == "cpu"


def test_chip_smoke_refuses_to_run_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
