"""The port's 'model' mesh axis (`parallel/mesh.py`), on the CPU over gloo.

JAX's mesh reshapes the devices to (data, model), row-major; the batch is
sharded over 'data' and replicated over 'model' and the parameters are
replicated, so a 2x2 mesh computes what a 2x1 mesh computes. Four gloo
ranks make `make_mesh(data=2, model=2)` in a jax-free worker and train the
four learners on `fast` (PPO, GRU-PPO) and the pendulum (SAC on `fast`,
GRU-SAC on the pendulum) for two epochs each; two ranks do the same on a
2x1 mesh. Checked:
  * rank r sits at (r // 2, r % 2), process rank r;
  * every 2x2 rank's parameters and metrics are bit-equal to the 2x1 rank
    of its 'data' index (so the two 'model' replicas agree);
  * `psum` adds over the rank's 'data' axis only, `replicate` reaches every
    rank;
  * only process 0 writes the checkpoints.
"""

import numpy as np
import pytest
import torch

from torch_mesh_util import run_worker

torch.set_num_threads(1)

PPO = dict(num_envs=8, episode_length=8, unroll_length=4, num_minibatches=2,
           num_update_epochs=2)
SAC = dict(num_envs=8, episode_length=5, replay_capacity=6, batch_size=16, steps_per_epoch=8,
           min_replay=3, hidden=(16, 16))
GRU = dict(num_envs=8, episode_length=12, seq_len=6, burn_in=2, replay_capacity=4,
           batch_size=4, seqs_per_epoch=2, grad_steps_per_seq=2, min_replay=1, nstep=3,
           encoder_sizes=(16,), hidden_size=8, head_sizes=(16,))
# case -> (learner module, env, config, env-steps an epoch)
CASES = {"ppo": ("ppo", "fast", PPO, 4 * 8),
         "gru_ppo": ("ppo_rnn", "fast", dict(PPO, hidden_size=16, encoder_sizes=(32,)), 4 * 8),
         "sac": ("sac", "fast", SAC, 8 * 8),
         "gru_sac": ("sac_rnn", "inverted_pendulum", GRU, 2 * 6 * 8)}

_WORKER = """
    from pobrax_tpu_torch.envs import _envs
    from pobrax_tpu_torch.training import checkpoint as ckpt
    from pobrax_tpu_torch.training import ppo, ppo_rnn, sac, sac_rnn

    CASES = __CASES__


    def work(mesh, root):
        torch.set_num_threads(1)
        wrote = []
        save = ckpt.save

        def spy_save(path, ts):
            wrote.append(path)
            return save(path, ts)

        ckpt.save = spy_save
        out = {"mesh": (mesh.shape, mesh.rank, mesh.model_rank, mesh.process_rank)}
        x = torch.tensor([mesh.process_rank + 1.0])
        out["psum"] = pm.psum(x, mesh).numpy()
        t = torch.full((2,), float(mesh.process_rank))
        pm.replicate(t, mesh)
        out["replicated"] = t.numpy()
        for case, (module, env_name, kw, per_epoch) in CASES.items():
            mod = {"ppo": ppo, "ppo_rnn": ppo_rnn, "sac": sac, "sac_rnn": sac_rnn}[module]
            hist = []
            _, params, _ = mod.train(
                _envs[env_name](device="cpu"), seed=0, mesh=mesh,
                checkpoint_dir=os.path.join(root, f"{mesh.data}x{mesh.model}", case),
                num_timesteps=2 * per_epoch, progress_fn=lambda s, m: hist.append(m),
                watchdog_deadline_s=None, **kw)
            policy = params[1]
            out[case] = {"params": torch.cat([p.detach().reshape(-1)
                                              for p in policy.parameters()]).numpy(),
                         "metrics": [{k: v for k, v in m.items() if "_ms" not in k
                                      and k != "steps_per_second"} for m in hist]}
        out["wrote"] = wrote
        return out


    if __name__ == "__main__":
        finish({"2x1": pm.spawn(work, 2, "gloo", "cpu", OUT, timeout=90),
                "2x2": pm.spawn(work, 4, "gloo", "cpu", OUT, timeout=90, model=2)})
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_worker(tmp_path_factory.mktemp("mesh_model"),
                      _WORKER.replace("__CASES__", repr(CASES)))


def test_ranks_sit_row_major_on_data_model(ranks):
    for r, out in enumerate(ranks["2x2"]):
        assert out["mesh"] == ({"data": 2, "model": 2}, r // 2, r % 2, r)
    for r, out in enumerate(ranks["2x1"]):
        assert out["mesh"] == ({"data": 2, "model": 1}, r, 0, r)


def test_psum_adds_over_the_data_axis_and_replicate_reaches_every_rank(ranks):
    for r, out in enumerate(ranks["2x2"]):
        m = r % 2  # the 'data' axis of model index m holds processes m and 2 + m
        np.testing.assert_array_equal(out["psum"], [(m + 1.0) + (2 + m + 1.0)])
        np.testing.assert_array_equal(out["replicated"], [0.0, 0.0])


@pytest.mark.parametrize("case", list(CASES))
def test_2x2_mesh_trains_bit_equal_to_2x1(ranks, case):
    """Each rank of the 2x2 mesh ends with the parameters and metrics of the
    2x1 rank at its 'data' index, bit for bit."""
    for r, out in enumerate(ranks["2x2"]):
        want = ranks["2x1"][r // 2][case]
        np.testing.assert_array_equal(out[case]["params"], want["params"], err_msg=case)
        assert out[case]["metrics"] == want["metrics"], case
        assert len(want["metrics"]) == 2


def test_only_process_0_writes_checkpoints(ranks):
    for mesh in ("2x1", "2x2"):
        writers = [r for r, out in enumerate(ranks[mesh]) if out["wrote"]]
        assert writers == [0], mesh
        assert len(ranks[mesh][0]["wrote"]) == len(CASES)
