"""The port stands alone: no jax, no `pobrax_tpu`, and no silent CPU fallback.

A fresh interpreter imports every module of `pobrax_tpu_torch` and
chip_smoke.py's module-level imports; neither jax nor `pobrax_tpu` may be
loaded after. Entry points given no device raise on a CPU-only torch rather
than running on the CPU.
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
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "pobrax_tpu"))
print(len(names), bad)
assert not bad, bad
"""


def test_port_and_chip_smoke_import_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE.format(root=ROOT)], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 20


def test_entry_points_without_device_raise_on_cpu_only_torch(monkeypatch):
    from pobrax_tpu_torch.envs import create
    from pobrax_tpu_torch.envs.ant_tag import AntTagEnv, extend_ant_cfg
    from pobrax_tpu_torch.physics import System

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create("ant_tag", batch_size=2)
    with pytest.raises(RuntimeError):
        AntTagEnv()
    with pytest.raises(RuntimeError):
        System(extend_ant_cfg())
    # asking for the CPU works
    assert create("ant_tag", batch_size=2, device="cpu").unwrapped.sys.device.type == "cpu"


def test_chip_smoke_refuses_to_run_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
