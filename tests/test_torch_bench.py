"""The port's benches (`pobrax_tpu_torch/bench.py`, `bench_scaling.py`,
`tools/bench_train.py`) against the JAX package's, on the CPU at small sizes.

  * `bench.rollout` at 8 envs x 4 steps against the same loop written over
    `pobrax_tpu.envs.create` (bench.py's: `key, k_act = split(key)`, a
    uniform draw, a step): actions and keys bit-equal, the state within
    the physics tolerances of tests/test_fused.py (pos/rot 1e-5, vel/ang
    1e-3), obs 1e-3, done equal; AntTag cached and naive, masked Humanoid;
  * `bench.main`'s record: bench.py's keys, the device, no card on the CPU,
    one rate per timed run; `vs_baseline` from the port's own records only
    (an NVIDIA card's), never bench.py's TPU records;
  * `bench_train`'s three programs and `bench_scaling`'s three learners
    build their configs field for field as the JAX tools do (recorded from
    the tools themselves: the learner's constructor is replaced by a
    recorder in both packages), `flatten` (TRAIN_FLATTEN) passed through to
    PPO's `flatten_optimizer` for both values;
  * `bench_scaling` over two gloo ranks on the CPU in strong mode (a
    jax-free worker): the per-size lines and the summary.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

import bench_scaling as jbench_scaling
from pobrax_tpu.envs import MaskedObservationWrapper as JMasked
from pobrax_tpu.envs import create as jcreate
from pobrax_tpu.training import ppo as jppo
from pobrax_tpu.training import ppo_rnn as jppo_rnn
from pobrax_tpu.training import sac_rnn as jsac_rnn
from pobrax_tpu_torch import bench
from pobrax_tpu_torch import bench_scaling
from pobrax_tpu_torch import random as jr
from pobrax_tpu_torch.tools import bench_train
from pobrax_tpu_torch.training import ppo, ppo_rnn, sac_rnn
from tools import bench_train as jbench_train
from torch_mesh_util import run_worker

torch.set_num_threads(1)

B, STEPS = 8, 4


def _jax_env(name: str, mode: str):
    hidden = None
    if name.startswith("masked_"):
        name, hidden = name[len("masked_"):], ("VELOCITY",)
    env = jcreate(name, episode_length=1000, batch_size=B, auto_reset=True,
                  randomized_autoreset=True, autoreset_mode=mode)
    return env if hidden is None else JMasked(env, env_name=name, hidden=hidden)


@pytest.mark.parametrize("name,mode", [("ant_tag", "cached"), ("ant_tag", "naive"),
                                       ("masked_humanoid", "cached")])
def test_rollout_matches_the_jax_loop(name, mode):
    jenv = _jax_env(name, mode)
    key = jax.random.PRNGKey(0)
    js = jax.jit(jenv.reset)(jax.random.split(key, B))
    jstep = jax.jit(jenv.step)
    jacts = []
    for _ in range(STEPS):
        key, k_act = jax.random.split(key)
        a = jax.random.uniform(k_act, (B, jenv.action_size), minval=-1.0, maxval=1.0)
        js = jstep(js, a)
        jacts.append(np.asarray(a))

    env = bench.make_env(name, B, mode, device="cpu")
    tacts = []
    step = env.step
    env.step = lambda s, a: (tacts.append(a.numpy().copy()), step(s, a))[1]
    ts = env.reset(jr.split(jr.PRNGKey(0), B))
    ts, tkey = bench.rollout(env, ts, jr.PRNGKey(0), STEPS)

    assert len(tacts) == STEPS
    for t, (a, b) in enumerate(zip(tacts, jacts)):
        np.testing.assert_array_equal(a, b, err_msg=f"action {t}")
    np.testing.assert_array_equal(tkey.numpy(), np.asarray(jax.random.key_data(key))
                                  if jax.dtypes.issubdtype(key.dtype, jax.dtypes.prng_key)
                                  else np.asarray(key))
    for f, tol in (("pos", 1e-5), ("rot", 1e-5), ("vel", 1e-3), ("ang", 1e-3)):
        np.testing.assert_allclose(getattr(ts.qp, f).numpy(), np.asarray(getattr(js.qp, f)),
                                   rtol=0, atol=tol, err_msg=f)
    np.testing.assert_allclose(ts.obs.numpy(), np.asarray(js.obs), rtol=0, atol=1e-3)
    np.testing.assert_array_equal(ts.done.numpy(), np.asarray(js.done))


def test_bench_record_on_the_cpu(tmp_path, monkeypatch):
    rec = bench.main({"BENCH_BATCH": "4", "BENCH_STEPS": "2", "BENCH_SINGLE_MODE": "1"},
                     device="cpu")
    for k in ("metric", "value", "unit", "vs_baseline", "autoreset", "modes"):
        assert k in rec, k
    assert (rec["device"], rec["card"], rec["vs_baseline"]) == ("cpu", None, 1.0)
    assert list(rec["modes"]) == ["cached"] and len(rec["modes"]["cached"]["runs"]) == 3
    assert rec["modes"]["cached"]["launches_per_rollout"] == [0, 0, 0]  # the plain step
    with pytest.raises(ValueError, match="rbg"):
        bench.bench("ant_tag", 4, 1, device="cpu", rng="rbg")


def test_baseline_reads_only_the_ports_nvidia_records(tmp_path):
    def write(name, rec):
        (tmp_path / name).write_text(json.dumps(rec))

    write("BENCH_r01.json", {"value": 5.0, "autoreset": "cached"})  # a TPU record
    assert bench._baseline_for_mode("cached", str(tmp_path)) is None
    write("BENCH_TORCH_r10.json", {"value": 7.0, "autoreset": "cached",
                                   "card": "NVIDIA H100 80GB HBM3, 700.00 W"})
    write("BENCH_TORCH_r2.json", {"parsed": {"value": 3.0, "autoreset": "cached",
                                             "card": "NVIDIA H100 80GB HBM3, 700.00 W"}})
    write("BENCH_TORCH_r1.json", {"value": 2.0, "autoreset": "cached", "card": None})
    assert bench._baseline_for_mode("cached", str(tmp_path)) == 3.0
    assert bench._baseline_for_mode("naive", str(tmp_path)) is None


class _Seen(Exception):
    pass


def _record_config(monkeypatch, module, cls_name):
    """Replaces `module.<cls_name>` by a recorder that raises with the config."""
    def recorder(env, cfg, *args, **kwargs):
        raise _Seen(cfg)
    monkeypatch.setattr(module, cls_name, recorder)


def _config(fn, *args, **kwargs):
    with pytest.raises(_Seen) as seen:
        fn(*args, **kwargs)
    return seen.value.args[0]


def _same_fields(port_cfg, jax_cfg):
    assert dataclasses.asdict(port_cfg) == dataclasses.asdict(jax_cfg)


def test_bench_train_configs_equal_the_jax_tools(monkeypatch):
    for mod, name in ((jppo, "PPOLearner"), (jppo_rnn, "RNNPPOLearner"),
                      (jsac_rnn, "RSACLearner"), (ppo, "PPOLearner"),
                      (ppo_rnn, "RNNPPOLearner"), (sac_rnn, "RSACLearner")):
        _record_config(monkeypatch, mod, name)
    for epc in (1, 8):
        _same_fields(_config(bench_train.bench_train, epochs_per_call=epc, device="cpu"),
                     _config(jbench_train.bench_train, epochs_per_call=epc))
        _same_fields(_config(bench_train.bench_train_rnn, epochs_per_call=epc, device="cpu"),
                     _config(jbench_train.bench_train_rnn, epochs_per_call=epc))
    _same_fields(_config(bench_train.bench_train_sac_rnn, device="cpu"),
                 _config(jbench_train.bench_train_sac_rnn))
    assert _config(bench_train.bench_train, device="cpu") == bench_train.ppo_config()
    for flatten in (True, False):
        got = _config(bench_train.bench_train, flatten=flatten, device="cpu")
        assert got.flatten_optimizer is flatten
        _same_fields(got, _config(jbench_train.bench_train, flatten=flatten))


def test_bench_scaling_configs_equal_the_jax_tool(monkeypatch):
    for mod, name in ((jppo, "PPOLearner"), (jppo_rnn, "RNNPPOLearner"),
                      (jsac_rnn, "RSACLearner"), (ppo, "PPOLearner"),
                      (ppo_rnn, "RNNPPOLearner"), (sac_rnn, "RSACLearner")):
        _record_config(monkeypatch, mod, name)
    devices = jax.devices()[:1]
    for prog in ("ppo", "rnn", "sac_rnn"):
        want = _config(jbench_scaling._PROGRAMS[prog], "ant_tag", devices, 64)
        port = {"ppo": bench_scaling.bench_ppo, "rnn": bench_scaling.bench_rnn,
                "sac_rnn": bench_scaling.bench_sac_rnn}[prog]
        _same_fields(_config(port, "ant_tag", None, torch.device("cpu"), 64, 1), want)


_SCALING_WORKER = """
    from pobrax_tpu_torch import bench_scaling

    if __name__ == "__main__":
        torch.set_num_threads(1)
        os.environ["OMP_NUM_THREADS"] = "1"  # the spawned ranks' torch threads
        finish(bench_scaling.main({"BENCH_SIZES": "1,2", "BENCH_TOTAL_ENVS": "8",
                                   "BENCH_STEPS": "2", "BENCH_PROGRAMS": "step,ppo",
                                   "BENCH_REPEATS": "1"}, device="cpu"))
"""


def test_bench_scaling_over_two_gloo_ranks(tmp_path):
    out = run_worker(tmp_path, _SCALING_WORKER)
    assert out["mode"] == "strong"
    for prog in ("step", "ppo"):
        assert sorted(out["rates"][prog]) == [1, 2]
        assert all(np.isfinite(v) and v > 0 for v in out["rates"][prog].values())
    summary = out["summary"]
    assert summary["metric"] == "strong-scaling efficiency @ 2 devices (cpu)"
    assert summary["value"] == round(out["rates"]["step"][2] / out["rates"]["step"][1], 4)
    assert "ppo_efficiency" in summary and summary["device"] == "cpu"
    assert out["launches_by_shape"] == {}  # the plain step on the CPU
