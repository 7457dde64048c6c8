"""The port's periphery on the CPU: the HTML renderer against the JAX
package's, the watchdog and ping, the metrics writer, the debug guards and
the profiling helpers (tests/test_aux.py, test_html.py and test_debug.py's
cases on the port).

The HTML page is compared character for character with the JAX renderer's
for the same scene and frames, then checked well-formed and self-contained.
"""

import json
import os
import re
import threading
import time

import numpy as np
import pytest
import torch

from pobrax_tpu.envs import _envs as jax_envs
from pobrax_tpu.io import html as jhtml
from pobrax_tpu.physics.state import QP as JQP
from pobrax_tpu_torch import random as jr
from pobrax_tpu_torch.envs import _envs, create
from pobrax_tpu_torch.envs.fast import Fast
from pobrax_tpu_torch.io import html
from pobrax_tpu_torch.parallel import health
from pobrax_tpu_torch.parallel.health import Watchdog, ping
from pobrax_tpu_torch.physics.state import QP
from pobrax_tpu_torch.training import ppo, ppo_rnn, sac, sac_rnn
from pobrax_tpu_torch.utils.debug import assert_deterministic, nan_guard
from pobrax_tpu_torch.utils.metrics_writer import MetricsWriter, reduce_metrics
from pobrax_tpu_torch.utils.profiling import ThroughputMeter, scope, time_fn, trace

FRAMES, B = 6, 3


def _poses(n, rs):
    """FRAMES frames of B envs of seeded poses: (pos, rot) numpy arrays."""
    pos = rs.randn(FRAMES, B, n, 3).astype(np.float32)
    rot = rs.randn(FRAMES, B, n, 4).astype(np.float32)
    return pos, rot / np.linalg.norm(rot, axis=-1, keepdims=True)


@pytest.mark.parametrize("name", ["ant_tag", "halfcheetah"])
def test_page_equals_jax(name):
    """Env 1's frames, as one env's QPs and as batches of one, give the JAX
    page for them exactly; a wider batch raises; the page is well-formed and
    self-contained."""
    sys_, jsys = _envs[name](device="cpu").sys, jax_envs[name]().sys
    pos, rot = _poses(sys_.num_bodies, np.random.RandomState(0))
    zero = torch.zeros(B, sys_.num_bodies, 3)
    batched = [QP(pos=torch.from_numpy(p), rot=torch.from_numpy(r), vel=zero, ang=zero)
               for p, r in zip(pos, rot)]
    single = [QP(pos=q.pos[1], rot=q.rot[1], vel=zero[1], ang=zero[1]) for q in batched]
    of_one = [QP(pos=q.pos[1:2], rot=q.rot[1:2], vel=zero[1:2], ang=zero[1:2]) for q in batched]
    want = jhtml.render(jsys, [JQP(pos=p[1], rot=r[1], vel=None, ang=None)
                               for p, r in zip(pos, rot)])
    page = html.render(sys_, single)
    assert page == want
    assert html.render(sys_, of_one) == want
    with pytest.raises(ValueError, match="batch of one"):
        html.render(sys_, batched)

    scene = json.loads(re.search(r"const SCENE\s*=\s*(.*?);\n", page, re.DOTALL).group(1))
    frames = json.loads(re.search(r"const FRAMES\s*=\s*(.*?);\n", page, re.DOTALL).group(1))
    assert len(scene["bodies"]) == sys_.num_bodies and len(frames) == FRAMES
    assert all(len(f["pos"]) == len(f["rot"]) == sys_.num_bodies for f in frames)
    low = page.lower()
    assert low.lstrip().startswith("<!doctype html") and "</html>" in low
    for needle in ("http://", "https://", "<script src", "import("):
        assert needle not in low, f"network fetch found: {needle}"
    assert "getcontext('webgl'" in low


def test_save_writes_the_page(tmp_path):
    env = create("acrobot", episode_length=None, auto_reset=False, batch_size=1, device="cpu")
    s = env.reset(jr.PRNGKey(0)[None])
    qps = [s.qp]
    for _ in range(3):
        s = env.step(s, torch.zeros(1, env.action_size))
        qps.append(s.qp)
    path = tmp_path / "acrobot.html"
    html.save(str(path), env.sys, qps)
    assert path.read_text() == html.render(env.sys, qps)


def test_metrics_writer_jsonl(tmp_path):
    w = MetricsWriter(str(tmp_path), stdout=False)
    w.write(10, {"a": 1.0, "b": 2.5})
    w.write(20, {"a": 3.0, "b": torch.tensor(4.5)})
    w.close()
    rows = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    assert [r["step"] for r in rows] == [10, 20]
    assert rows[1]["b"] == 4.5
    assert all("time" in r for r in rows)


def test_reduce_metrics_single_process_identity():
    assert reduce_metrics({"x": 2.0, "y": torch.tensor(-1.0)}) == {"x": 2.0, "y": -1.0}


def test_ping_counts_devices():
    assert ping() == (torch.cuda.device_count() or 1)


def test_watchdog_deadline():
    wd = Watchdog(deadline_s=0.01)
    time.sleep(0.03)
    with pytest.raises(TimeoutError):
        wd.check()
    wd.beat()
    wd.check()  # fresh beat passes


def test_watchdog_monitor_latches_stall():
    """Once the deadline passes with no beat, the monitor flips `stalled`
    and every later beat()/check() raises (no silent resume)."""
    fired = []
    wd = Watchdog(deadline_s=0.05, on_stall=lambda el: fired.append(el))
    wd.start_monitor(poll_s=0.01)
    try:
        deadline = time.monotonic() + 5.0
        while not wd.stalled and time.monotonic() < deadline:
            time.sleep(0.01)
        assert wd.stalled and fired, "monitor never latched the stall"
        with pytest.raises(TimeoutError):
            wd.beat()
        with pytest.raises(TimeoutError):
            wd.check()
    finally:
        wd.stop_monitor()


class _SlowFast(Fast):
    """`fast` with every step 20 ms long: an epoch outlasts a 10 ms deadline.
    While a watchdog's monitor runs (`_Monitored`), each step also lasts
    until that monitor has latched the stall: a loaded host may leave the
    monitor thread unscheduled for the whole 20 ms, and the epoch's beat
    would then come before any poll saw the deadline pass."""

    def step(self, state, action):
        time.sleep(0.02)
        give_up = time.monotonic() + 30.0
        while (any(not wd.stalled for wd in _Monitored.running)
               and time.monotonic() < give_up):
            time.sleep(0.005)
        return super().step(state, action)


class _Monitored(health.Watchdog):
    """The learners' Watchdog, keeping the ones whose monitor runs."""

    running = []

    def start_monitor(self, poll_s=None):
        _Monitored.running.append(self)
        return super().start_monitor(poll_s)

    def stop_monitor(self):
        super().stop_monitor()
        if self in _Monitored.running:
            _Monitored.running.remove(self)


_SMALL = {
    "ppo": (ppo, dict(num_envs=4, episode_length=8, unroll_length=2, num_minibatches=1,
                      num_update_epochs=1)),
    "ppo_rnn": (ppo_rnn, dict(num_envs=4, episode_length=8, unroll_length=2, num_minibatches=1,
                              num_update_epochs=1, hidden_size=8, encoder_sizes=(8,))),
    "sac": (sac, dict(num_envs=4, episode_length=8, steps_per_epoch=2, replay_capacity=64,
                      batch_size=4, min_replay=4, hidden=(8,))),
    "sac_rnn": (sac_rnn, dict(num_envs=4, episode_length=8, seq_len=4, burn_in=1,
                              replay_capacity=8, batch_size=2, seqs_per_epoch=1, min_replay=1,
                              hidden_size=8, encoder_sizes=(8,), head_sizes=(8,))),
}


def _watchdog_threads():
    return [t for t in threading.enumerate() if t.name == "pobrax-watchdog" and t.is_alive()]


@pytest.mark.parametrize("learner", sorted(_SMALL))
def test_train_raises_on_stalled_epoch(learner, monkeypatch):
    """Each learner's `train` wires the watchdog: an epoch slower than the
    deadline raises at its beat, and the monitor thread is stopped; with
    `watchdog_deadline_s=None` the same run completes with no monitor. The
    epoch lasts until the monitor has latched the stall (`_SlowFast`), so
    the outcome does not hang on when the host schedules that thread."""
    monkeypatch.setattr(health, "Watchdog", _Monitored)
    module, kw = _SMALL[learner]
    with pytest.raises(TimeoutError):
        module.train(_SlowFast(device="cpu"), num_timesteps=1, watchdog_deadline_s=0.01,
                     progress_fn=lambda s, m: None, **kw)
    assert not _watchdog_threads() and not _Monitored.running
    seen = []
    module.train(_SlowFast(device="cpu"), num_timesteps=1, watchdog_deadline_s=None,
                 progress_fn=lambda s, m: seen.append(_watchdog_threads()), **kw)
    assert seen == [[]]


def test_nan_guard_passes_finite():
    f = nan_guard(lambda x: {"y": x * 2.0, "n": torch.arange(3)})
    assert float(f(torch.ones(4))["y"][0]) == 2.0


def test_nan_guard_raises_on_nan_inside_a_state():
    env = _envs["hopper"](device="cpu")
    s = env.reset(jr.split(jr.PRNGKey(0), 2))

    def poison(state):
        pos = state.qp.pos.clone()
        pos[1, 2, 0] = float("nan")
        return state.replace(qp=state.qp.replace(pos=pos))

    assert nan_guard(lambda st: st)(s) is s
    with pytest.raises(FloatingPointError, match=r"poison: non-finite values at \.qp\.pos"):
        nan_guard(poison, name="poison")(s)


def test_assert_deterministic_on_env_rollout():
    env = create("hopper", batch_size=2, episode_length=16, randomized_autoreset=True,
                 device="cpu")

    def roll(key):
        s = env.reset(key)
        obs = []
        for _ in range(5):
            s = env.step(s, torch.full((2, env.action_size), 0.3))
            obs.append(s.obs)
        return torch.stack(obs), s

    assert_deterministic(roll, seed=11, device="cpu")
    with pytest.raises(AssertionError):
        assert_deterministic(lambda key: torch.rand(3), device="cpu")


def test_time_fn_and_throughput_meter():
    calls = []
    timing = time_fn(lambda x: calls.append(x) or x.sum(), torch.ones(8), iters=5, warmup=1)
    assert len(calls) == 1 + 1 + 5 and len(timing.samples) == 5
    assert timing.first_call_s > 0 and timing.mean_step_s > 0
    assert timing.steps_per_s == pytest.approx(1.0 / timing.mean_step_s)
    meter = ThroughputMeter()
    assert meter.update(100) is None  # the first (warm-up) call starts the clock
    time.sleep(0.01)
    rate = meter.update(100)
    assert 0 < rate < 100 / 0.01


def test_trace_writes_a_trace_with_the_scope(tmp_path):
    with trace(str(tmp_path)) as prof:
        with scope("pobrax_scope"):
            torch.ones(16).cumsum(0)
    assert "pobrax_scope" in {e.key for e in prof.key_averages()}
    assert any(f.endswith(".json") for f in os.listdir(tmp_path))
