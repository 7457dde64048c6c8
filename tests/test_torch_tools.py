"""The port's study tools (`pobrax_tpu_torch/tools/`) against the JAX
package's `tools/`, on the CPU at small sizes.

  * `autoreset_study.run_mode` at batch 16, episode 20, 100 steps: the
    counts equal JAX's in both modes (the resets' draws are threefry);
  * `ablate_bench`'s Systems (no walls, no contacts, one substep): configs,
    contact tables and joint tables equal the JAX tool's `_rebuild` of the
    same overrides;
  * `substeps_probe`: every candidate's retuned config equals the JAX
    tool's, and a retuned candidate's statistics over 3 control steps of 8
    envs (where the packages still agree) are JAX's within 1e-4 (nan share
    equal); past the stability edge (5 substeps) one control step parts the
    kernel's host build from the plain step in most envs, at 10 and 8 in
    none;
  * `per_study`'s COMMON, BUDGETS, SEEDS equal JAX's;
  * `overlap_study`'s `chain` and `mm` equal JAX's at a small size;
  * `paired_seeds` reads both column layouts and its sign-flip p-value is
    the exact share of sign assignments;
  * `curve_levels` reads a record and a progress log of two calls (one cut
    after its save) into the same crossings, ratios and per-call pace;
  * every timing entry point raises without a card when no device is named.
"""

import dataclasses
import itertools
import json
import os

import jax
import numpy as np
import pytest
import torch

from pobrax_tpu.envs.ant_tag import AntTagEnv as JAntTag
from pobrax_tpu_torch import bench, bench_scaling
from pobrax_tpu_torch import random as jr
from pobrax_tpu_torch.envs import HAI_ACTION_REPEAT, wrappers
from pobrax_tpu_torch.examples._common import ProgressLog
from pobrax_tpu_torch.tools import (ablate_bench, ant_speed_probe, autoreset_study,
                                    bench_substeps, bench_train, curve_levels, overlap_study,
                                    paired_seeds, per_study,
                                    render_gather_policy, render_maze_policy, roofline,
                                    substeps_probe)
from tests.test_torch_kernel_host import host_lib, host_step  # noqa: F401
from tests.test_torch_scene import _fused_joint_table, assert_same
from tools import ablate_bench as jablate
from tools import autoreset_study as jautoreset
from tools import overlap_study as joverlap
from tools import per_study as jper
from tools import substeps_probe as jsubsteps

torch.set_num_threads(1)


@pytest.mark.parametrize("mode", ["naive", "cached"])
def test_autoreset_study_counts_equal_jax(mode):
    want = jautoreset.run_mode(mode, 20, 100, batch=16)
    got = autoreset_study.run_mode(mode, 20, 100, batch=16, device="cpu")
    assert got["resets"] > 0
    for k, v in want.items():
        assert got[k] == v, k
    assert (got["device"], got["card"], got["launches"]) == ("cpu", None, 0)


def _systems_equal(jsys, tsys):
    assert dataclasses.asdict(jsys.config) == dataclasses.asdict(tsys.config)
    for kind in ("point_plane", "sphere_sphere", "capsule_capsule", "capsule_box"):
        a, b = getattr(jsys.contacts, kind), getattr(tsys.contacts, kind)
        assert (a is None) == (b is None), kind
        if a is not None:
            assert_same(a, b, kind)
    assert jsys.contacts.h_sub == tsys.contacts.h_sub
    assert_same(_fused_joint_table(jsys), _fused_joint_table(tsys), "joints")


def test_ablation_systems_equal_jax():
    envs = ablate_bench.variant_envs("cpu")
    jfull = JAntTag()
    no_walls = tuple(p for p in jfull.sys.config.collide_include if "Arena" not in p)
    want = {"full": jfull,
            "no_walls": jablate._rebuild(JAntTag(), collide_include=no_walls),
            "no_contacts": jablate._rebuild(JAntTag(), collide_include=()),
            "substeps_1": jablate._rebuild(JAntTag(), substeps=1)}
    for name, jenv in want.items():
        _systems_equal(jenv.sys, envs[name].sys)
    assert envs["no_contacts"].sys.contacts.capsule_box is None
    assert envs["substeps_1"].sys.config.substeps == 1
    assert set(ablate_bench.VARIANTS) == set(want) | {"physics_only"}


@pytest.mark.parametrize("candidate", substeps_probe.CANDIDATES)
def test_substeps_candidates_equal_jax(candidate):
    core = substeps_probe.retuned_env("ant_tag", *candidate, device="cpu")
    jcore = jsubsteps.retuned_env("ant_tag", *candidate)
    assert dataclasses.asdict(core._cfg) == dataclasses.asdict(jcore._cfg)
    assert_same(_fused_joint_table(jcore.sys), _fused_joint_table(core.sys), "joints")


def test_substeps_probe_statistics_equal_jax():
    want = jsubsteps.probe("ant_tag", 5, 0.5, batch=8, steps=3)
    got = substeps_probe.probe("ant_tag", 5, 0.5, batch=8, steps=3, device="cpu")
    assert got["nan_frac"] == want["nan_frac"] == 0.0
    for k in ("z_mean", "z_p5", "z_p95", "done_rate", "speed", "ang_speed"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4, err_msg=k)
    assert substeps_probe.plausible(got, got)


def _host_share(lib, core, batch: int = 64) -> float:
    """Share of envs whose one control step through the kernel's host build
    agrees with the plain step (pos/rot 1e-5, vel/ang 1e-3), from a reset."""
    wrappers.ActionRepeatWrapper(core, HAI_ACTION_REPEAT)
    qp = core.reset(jr.split(jr.PRNGKey(6), batch)).qp
    act = torch.rand(batch, core.action_size, generator=torch.Generator().manual_seed(6)) * 2 - 1
    (qk, _), (qg, _) = host_step(lib, core.sys, qp, act), core.sys.step_generic(qp, act)
    err = {f: (getattr(qk, f) - getattr(qg, f)).abs().flatten(1).max(1).values
           for f in ("pos", "rot", "vel", "ang")}
    ok = ((err["pos"] <= 1e-5) & (err["rot"] <= 1e-5) & (err["vel"] <= 1e-3)
          & (err["ang"] <= 1e-3))
    return float(ok.float().mean())


def test_probe_candidates_past_the_stability_edge_amplify_round_off(host_lib):
    """Why chip_smoke.py's phase 19 probes (10, 1.0) and (8, 1.0) only: at 5
    substeps (h_sub 0.01 s, past the 0.00625 s edge) one control step at the
    HAI action repeat amplifies the round-off between the kernel's own host
    build and the plain step in most envs, while at 10 and 8 every env agrees."""
    shares = {c: _host_share(host_lib, substeps_probe.retuned_env("ant_tag", *c, device="cpu"))
              for c in ((10, 1.0), (8, 1.0), (5, 1.0), (5, 0.5))}
    assert shares[(10, 1.0)] == shares[(8, 1.0)] == 1.0, shares
    assert shares[(5, 1.0)] < 0.5 and shares[(5, 0.5)] < 0.5, shares


def test_per_study_constants_equal_jax():
    assert per_study.COMMON == jper.COMMON
    assert (per_study.BUDGETS, per_study.SEEDS, per_study.HIDDEN) == (jper.BUDGETS, jper.SEEDS,
                                                                      jper.HIDDEN)
    assert per_study.OUT.endswith("runs/learning_per_study_torch.json")


def test_overlap_chain_and_mm_equal_jax(monkeypatch):
    monkeypatch.setattr(joverlap, "T_CHAIN", 3)
    monkeypatch.setattr(joverlap, "CHAIN_OPS", 5)
    monkeypatch.setattr(joverlap, "T_MM", 4)
    x = np.linspace(0.0, 1.0, 64, dtype=np.float32)
    w = (np.random.RandomState(0).randn(32, 32) * 2.0).astype(np.float32)
    np.testing.assert_allclose(float(overlap_study.chain(torch.from_numpy(x), 3, 5)),
                               float(joverlap.chain(jax.numpy.asarray(x))), rtol=1e-5)
    np.testing.assert_allclose(float(overlap_study.mm(torch.from_numpy(w), 4)),
                               float(joverlap.mm(jax.numpy.asarray(w))), rtol=1e-5)


def test_paired_seeds_reads_both_layouts_and_tests_exactly(tmp_path):
    port = tmp_path / "port.log"
    port.write_text('# a comment line\n' + json.dumps(
        {"npz": "x", **{f"det_apples_s{s}": 5.0 + 0.1 * s for s in range(4)}}) + "\n")
    jaxf = tmp_path / "jax.jsonl"
    jaxf.write_text("".join(json.dumps({"seed": s, "apples": 5.0 + 0.1 * s - d}) + "\n"
                            for s, d in zip(range(5), (0.2, 0.1, -0.3, 0.4, 9.0))))
    out = paired_seeds.compare(paired_seeds.column([str(port)], "det_apples"),
                               paired_seeds.column([str(jaxf)], "apples"))
    assert out["seeds"] == [0, 1, 2, 3]  # seed 4 is in one column only
    np.testing.assert_allclose(out["diffs"], [0.2, 0.1, -0.3, 0.4], atol=1e-12)
    assert out["below_zero"] == 1
    # |mean| 0.1: of the 16 sign assignments, those with |sum| >= 0.4
    sums = [abs(sum(sg * d for sg, d in zip(signs, (0.2, 0.1, -0.3, 0.4))))
            for signs in itertools.product((-1, 1), repeat=4)]
    assert out["p_sign_flip"] == pytest.approx(np.mean([x >= 0.4 - 1e-12 for x in sums]))


def test_curve_levels_reads_records_and_progress_logs(tmp_path):
    per_epoch = curve_levels.STEPS_PER_EPOCH
    rewards = [0.1, 0.6, 0.4, 1.2, 2.5, 3.1]
    root = str(tmp_path / "run")
    log = ProgressLog(root, "card", seed=0)
    for i, r in enumerate(rewards[:4]):
        log((i + 1) * per_epoch, {"mean_reward": r})
    os.makedirs(os.path.join(root, f"step_{3 * per_epoch:012d}"))  # the call is cut after 300
    log = ProgressLog(root, "card", seed=0)
    for i, r in enumerate(rewards[3:], start=3):
        log((i + 1) * per_epoch, {"mean_reward": r})
    calls = log.calls()
    record = tmp_path / "record.json"
    record.write_text(json.dumps({"curve": log.curve(), "calls": calls}))
    ref = tmp_path / "ref.json"
    ref.write_text(json.dumps({"curve": [{"steps": per_epoch // 2, "mean_reward": 0.5},
                                         {"steps": 4 * per_epoch, "mean_reward": 3.0}]}))
    out = curve_levels.main([str(record), log.path, "--ref", str(ref)])
    assert out[0]["crossings"] == out[1]["crossings"] == {
        "0.5": 2 * per_epoch, "1.0": 4 * per_epoch, "2.0": 5 * per_epoch, "3.0": 6 * per_epoch}
    assert out[0]["ratio_to_ref"] == {"0.5": 4.0, "1.0": 1.0, "2.0": 1.25, "3.0": 1.5}
    assert out[0]["last"] == {"steps": 6 * per_epoch, "mean_reward": 3.1}
    assert out[0]["calls"] == out[1]["calls"]
    assert [(c["from"], c["to"], c["epochs"]) for c in out[1]["calls"]] == [
        (0, 3 * per_epoch, 3), (3 * per_epoch, 6 * per_epoch, 3)]
    for got, c in zip(out[1]["calls"], calls):
        assert got["s_per_epoch"] == pytest.approx(c["train_s"] / 3)
        assert got["env_steps_per_s"] == pytest.approx(3 * per_epoch / c["train_s"])


ENTRY_POINTS = {
    "bench": lambda: bench.bench("ant_tag", 4, 1),
    "bench.main": lambda: bench.main({}),
    "bench_scaling": lambda: bench_scaling.main({}),
    "bench_train": lambda: bench_train.bench_train(),
    "bench_train_rnn": lambda: bench_train.bench_train_rnn(),
    "bench_train_sac_rnn": lambda: bench_train.bench_train_sac_rnn(),
    "bench_substeps": lambda: bench_substeps.main([], {}),
    "ablate_bench": lambda: ablate_bench.main(),
    "roofline": lambda: roofline.main({}),
    "autoreset_study": lambda: autoreset_study.run_mode("naive", 5, 1),
    "substeps_probe": lambda: substeps_probe.probe("ant_tag", 10, 1.0, 4, 1),
    "overlap_study": lambda: overlap_study.main([]),
    "ant_speed_probe": lambda: ant_speed_probe.main(),
    "per_study": lambda: per_study.main(),
    "render_gather_policy": lambda: render_gather_policy.main(),
    "render_maze_policy": lambda: render_maze_policy.main(),
}


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_entry_points_raise_without_a_card(name):
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no GPU"):
        ENTRY_POINTS[name]()
