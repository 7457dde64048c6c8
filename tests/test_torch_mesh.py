"""The port's process mesh (`pobrax_tpu_torch/parallel/mesh.py`), its
collectives and the multi-process entry points, on the CPU over gloo.

  * `make_mesh` validates as JAX's (`data * model` must tile the processes),
    two processes also make a 1x2 mesh (each its own 'data' axis, at model
    index = its rank; its psum is its own value), one process makes a 1x1 mesh whose
    collectives return their input, and `initialize_distributed` is False
    with no rendezvous configured;
  * across two processes (a jax-free worker): `shard_batch` keeps each
    rank's contiguous block (JAX's `P('data')`), `replicate` gives every
    rank rank 0's tensors and module, `psum` / `pmean` add up / average,
    `health.ping()` all-gathers each process's device count, and
    `running_statistics.update(..., mesh)` equals JAX's `update` with its
    `axis_name` psums over two devices (1e-6);
  * `spawn` raises when a rank fails or the ranks outlast their deadline,
    and leaves no rank behind;
  * `graft_entry.entry()` steps 256 AntTag envs, `dryrun_multichip(2)` runs
    its five phases with bit-equal parameters and equal metrics on both
    ranks, and `torchrun` runs `multihost_train` as two ranks.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from pobrax_tpu.training import running_statistics as jrs
from pobrax_tpu_torch.parallel import mesh as pm
from torch_mesh_util import REPO, run_worker

torch.set_num_threads(1)

OBS = np.random.RandomState(0).randn(2, 5, 3, 4).astype(np.float32)  # (ranks, T, B/2, obs)

_WORKER = """
    import time
    from pobrax_tpu_torch import graft_entry
    from pobrax_tpu_torch.envs.base import State
    from pobrax_tpu_torch.parallel import health
    from pobrax_tpu_torch.training import running_statistics

    OBS = np.asarray(__OBS__, np.float32)


    def basics(mesh):
        torch.set_num_threads(1)
        out = {"shape": mesh.shape, "rank": mesh.rank, "world": mesh.data,
               "backend": mesh.backend}
        errors = []
        try:
            pm.make_mesh(device="cpu", data=3)
        except ValueError as e:
            errors.append(str(e))
        out["errors"] = errors
        wide = pm.make_mesh(device="cpu", data=1, model=2)
        out["model_mesh"] = (wide.shape, wide.rank, wide.model_rank, wide.process_rank,
                             pm.psum(torch.tensor([mesh.rank + 1.0]), wide).numpy())
        batch = torch.arange(8 * 3).reshape(8, 3)
        state = State(qp=None, obs=batch.float(), reward=torch.arange(8.0), done=torch.zeros(8),
                      metrics={}, info={"rng": torch.arange(16).reshape(8, 2)})
        shard = pm.shard_batch({"x": batch, "state": state}, mesh)
        out["shard"] = {"x": shard["x"].numpy(), "obs": shard["state"].obs.numpy(),
                        "reward": shard["state"].reward.numpy(),
                        "rng": shard["state"].info["rng"].numpy()}
        t = torch.full((3,), float(mesh.rank + 1))
        lin = torch.nn.Linear(2, 2)
        with torch.no_grad():
            lin.weight.fill_(mesh.rank + 1.0)
        pm.replicate({"t": t, "m": [lin]}, mesh)
        out["replicated"] = (t.numpy(), lin.weight.detach().numpy())
        x = torch.tensor([1.0, 2.0]) * (mesh.rank + 1)
        out["psum"], out["pmean"] = pm.psum(x, mesh).numpy(), pm.pmean(x, mesh).numpy()
        out["ping"] = health.ping()
        stats = running_statistics.update(running_statistics.init_state(4, "cpu"),
                                          torch.as_tensor(OBS[mesh.rank]), mesh)
        stats = running_statistics.update(stats, torch.as_tensor(OBS[mesh.rank] * 2 + 1), mesh)
        out["stats"] = {k: getattr(stats, k).numpy()
                        for k in ("count", "mean", "summed_variance", "std")}
        return out


    def boom(mesh):
        if mesh.rank == 1:
            raise RuntimeError("rank 1 fails on purpose")
        pm.psum(torch.ones(1), mesh)  # rank 0 waits in a collective for the dead rank


    def hang(mesh):
        time.sleep(600)


    if __name__ == "__main__":
        results = {"basics": pm.spawn(basics, 2, "gloo", "cpu", timeout=60)}
        for name, fn, timeout in (("boom", boom, 60), ("hang", hang, 3)):
            t0 = time.monotonic()
            try:
                pm.spawn(fn, 2, "gloo", "cpu", timeout=timeout)
                results[name] = None
            except (RuntimeError, TimeoutError) as e:
                results[name] = (type(e).__name__, str(e), time.monotonic() - t0)
        results["dryrun"] = graft_entry.dryrun_multichip(2, device="cpu", timeout=60)
        finish(results)
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_worker(tmp_path_factory.mktemp("mesh"),
                      _WORKER.replace("__OBS__", repr(OBS.tolist())))


def test_one_process_mesh_is_1x1_and_validates():
    mesh = pm.make_mesh(device="cpu")
    assert (mesh.shape, mesh.rank, mesh.world, mesh.group) == ({"data": 1, "model": 1}, 0, 1,
                                                               None)
    x = torch.arange(3.0)
    assert pm.psum(x, mesh) is x and pm.pmean(x, mesh) is x
    assert pm.shard_batch(x, mesh) is not None and torch.equal(pm.shard_batch(x, mesh), x)
    with pytest.raises(ValueError, match="does not tile"):
        pm.make_mesh(data=2, device="cpu")
    with pytest.raises(ValueError, match="does not tile"):
        pm.make_mesh(model=2, device="cpu")
    with pytest.raises(ValueError, match="split"):
        pm.Mesh(2, 1, 0, None, torch.device("cpu"), None).block(5)


def test_initialize_distributed_without_rendezvous_is_false(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR"):
        monkeypatch.delenv(k, raising=False)
    assert pm.initialize_distributed("gloo") is False
    assert not torch.distributed.is_initialized()


def test_two_ranks_make_a_2x1_mesh_and_refuse_other_shapes(ranks):
    for d, r in enumerate(ranks["basics"]):
        assert (r["shape"], r["rank"], r["world"], r["backend"]) == (
            {"data": 2, "model": 1}, d, 2, "gloo")
        assert "does not tile 2 processes" in r["errors"][0]
        shape, rank, model_rank, process_rank, own = r["model_mesh"]
        assert (shape, rank, model_rank, process_rank) == ({"data": 1, "model": 2}, 0, d, d)
        np.testing.assert_array_equal(own, [d + 1.0])  # a 'data' axis of one: its own value


def test_shard_batch_keeps_each_ranks_block(ranks):
    for d, r in enumerate(ranks["basics"]):
        rows = np.arange(4 * d, 4 * d + 4)
        s = r["shard"]
        np.testing.assert_array_equal(s["x"], np.arange(24).reshape(8, 3)[rows])
        np.testing.assert_array_equal(s["obs"], np.arange(24.0).reshape(8, 3)[rows])
        np.testing.assert_array_equal(s["reward"], rows.astype(np.float32))
        np.testing.assert_array_equal(s["rng"], np.arange(16).reshape(8, 2)[rows])


def test_replicate_and_the_reductions(ranks):
    for r in ranks["basics"]:
        t, w = r["replicated"]
        np.testing.assert_array_equal(t, np.ones(3))
        np.testing.assert_array_equal(w, np.ones((2, 2)))
        np.testing.assert_array_equal(r["psum"], [3.0, 6.0])
        np.testing.assert_array_equal(r["pmean"], [1.5, 3.0])


def test_ping_gathers_every_process(ranks):
    assert [r["ping"] for r in ranks["basics"]] == [2, 2]


def test_running_statistics_over_two_ranks_match_jax_axis_name(ranks):
    def two(batch):
        s = jrs.update(jrs.init_state(4), batch, axis_name="i")
        return jrs.update(s, batch * 2 + 1, axis_name="i")

    want = jax.pmap(two, axis_name="i", devices=jax.devices()[:2])(OBS)
    for d, r in enumerate(ranks["basics"]):
        for k, v in r["stats"].items():
            np.testing.assert_allclose(v, np.asarray(getattr(want, k))[d], rtol=1e-6,
                                       atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(ranks["basics"][0]["stats"]["mean"],
                                  ranks["basics"][1]["stats"]["mean"])


def test_spawn_raises_when_a_rank_fails_or_hangs(ranks):
    kind, msg, seconds = ranks["boom"]
    assert kind == "RuntimeError" and "exited with code 1" in msg and seconds < 30
    kind, msg, seconds = ranks["hang"]
    assert kind == "TimeoutError" and seconds < 15


def test_entry_steps_256_ant_tag_envs():
    from pobrax_tpu_torch import graft_entry
    fn, args = graft_entry.entry("cpu")
    out = fn(*args)
    assert tuple(out.obs.shape) == (256, args[1].obs.shape[1])
    assert bool(torch.isfinite(out.obs).all())


def test_dryrun_multichip_two_ranks(ranks):
    results = ranks["dryrun"]
    assert len(results) == 2 and results[0] == results[1]
    assert list(results[0]) == ["PPO, ant_tag", "PPO, inverted_pendulum", "RNN-PPO, ant_tag",
                                "epochs_per_call=2, ant_tag", "GRU-SAC + PER, ant_tag"]
    for metrics in results[0].values():
        assert all(np.isfinite(v) for v in metrics.values())
    assert results[0]["GRU-SAC + PER, ant_tag"]["q_loss"] > 0


def test_torchrun_runs_multihost_train_as_two_ranks(tmp_path):
    env = {**os.environ, "NUM_TIMESTEPS": "1", "NUM_ENVS": "32", "OMP_NUM_THREADS": "1"}
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node=2",
           "--master_port", str(pm.free_port()), "-m", "pobrax_tpu_torch.multihost_train",
           "--backend", "gloo", "--device", "cpu"]
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=110)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        out, _ = proc.communicate()
        pytest.fail(f"torchrun outlasted 110 s:\n{out[-3000:]}")
    assert proc.returncode == 0, out[-3000:]
    assert "process 0/2 on cpu, backend gloo" in out and "process 1/2" in out
    progress = [line for line in out.splitlines() if line.startswith("steps")]
    assert len(progress) == 1, out[-3000:]  # rank 0 prints, rank 1 does not
