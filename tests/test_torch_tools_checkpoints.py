"""The port's checkpoint tools (`tools/ant_speed_probe.py`, the two render
tools) against the JAX package's, on the CPU.

  * `ant_speed_probe` on the committed GRU-SAC AntTag export, 2 episodes x
    20 control steps, stochastic (the JAX tool's run, shortened): the mean
    torso displacement per control step within 1e-4 of the JAX tool's
    `main` on the orbax checkpoint;
  * the same probe on the bombmem02 gather export, deterministic, against
    `jax_speed_probe` (the JAX tool's loop over a GRU-PPO checkpoint, below)
    at 2 episodes x 5 steps, within 1e-5;
  * `render_gather_policy` / `render_maze_policy` over 3 frames: the page's
    scene equals the JAX tool's page's and each frame's poses agree to the
    page's 4 decimals (one unit of the last place for a value rounded the
    other way).

`jax_speed_probe` is also the JAX column of the bombmem02 gait comparison:
`python tests/test_torch_tools_checkpoints.py --ckpt checkpoints/
ant_gather_rnn_bombmem02_1B --seeds 0 1 ... --episodes 64 --steps 300 --det`
prints one JSON line per seed (CPU, one process a few seeds).
"""

import argparse
import json
import os
import re
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from pobrax_tpu.envs import HAI_ACTION_REPEAT, _envs, wrappers  # noqa: E402
from pobrax_tpu_torch.tools import (ant_speed_probe, render_gather_policy,  # noqa: E402
                                    render_maze_policy)
from tools import ant_speed_probe as jprobe  # noqa: E402
from tools import eval_gather_checkpoint_seeds as jseeds  # noqa: E402
from tools import render_gather_policy as jrender_gather  # noqa: E402
from tools import render_maze_policy as jrender_maze  # noqa: E402

torch.set_num_threads(1)

BOMBMEM = "checkpoints/ant_gather_rnn_bombmem02_1B"
BOMBMEM_NPZ = os.path.join(ant_speed_probe.CKPT_DIR, "ant_gather_rnn_bombmem02_1B.npz")


def jax_speed_probe(ckpt_dir: str, episodes: int, steps: int, seed: int,
                    deterministic: bool) -> float:
    """The JAX tool's probe loop (tools/ant_speed_probe.py) over a GRU-PPO
    gather or maze checkpoint, loaded as tools/eval_gather_checkpoint_seeds.py
    loads it: reset from split(PRNGKey(seed)), the same key's stream for the
    actions, mean torso displacement per live control step."""
    inf, params = jseeds.load(ckpt_dir)
    core = _envs[jseeds.env_name(ckpt_dir)]()
    env = wrappers.VmapWrapper(wrappers.EpisodeWrapper(
        wrappers.ActionRepeatWrapper(core, HAI_ACTION_REPEAT), steps, 1), batch_size=episodes)
    ti = core.torso_idx

    def run(key):
        state = env.reset(jax.random.split(key, episodes))
        h = jnp.zeros((episodes, jseeds.HIDDEN))

        def body(carry, _):
            state, h, key = carry
            key, k = jax.random.split(key)
            h, act = inf(params, h, state.obs, k, deterministic=deterministic)
            n = env.step(state, act)
            disp = jnp.linalg.norm(n.qp.pos[:, ti, :2] - state.qp.pos[:, ti, :2], axis=-1)
            return (n, h, key), (disp, 1.0 - n.done)

        return jax.lax.scan(body, (state, h, key), None, length=steps)[1]

    disp, alive = jax.jit(run)(jax.random.PRNGKey(seed))
    disp, alive = np.asarray(disp), np.asarray(alive)
    return float((disp * alive).sum() / alive.sum())


@pytest.fixture
def at_repo(monkeypatch):
    monkeypatch.chdir(REPO)  # the JAX tools restore checkpoints/ relative to the root


def test_speed_probe_equals_the_jax_tool(at_repo):
    want = jprobe.main(episodes=2, steps=20)
    got = ant_speed_probe.main(episodes=2, steps=20, device="cpu")
    assert list(got) == [1]
    np.testing.assert_allclose(got[1], want, rtol=0, atol=1e-4)


def test_speed_probe_on_the_gather_export_equals_jax(at_repo):
    want = jax_speed_probe(BOMBMEM, 2, 5, 3, True)
    got = ant_speed_probe.main(BOMBMEM_NPZ, episodes=2, steps=5, seeds=[3], deterministic=True,
                               device="cpu")
    np.testing.assert_allclose(got[3], want, rtol=0, atol=1e-5)


def _page(path):
    text = open(path).read()
    scene = json.loads(re.search(r"const SCENE\s*=\s*(.*?);\n", text, re.DOTALL).group(1))
    frames = json.loads(re.search(r"const FRAMES\s*=\s*(.*?);\n", text, re.DOTALL).group(1))
    return scene, frames


@pytest.mark.parametrize("tool", ["gather", "maze"])
def test_render_page_equals_jax(tool, at_repo, tmp_path):
    port, jax_tool = {"gather": (render_gather_policy, jrender_gather),
                      "maze": (render_maze_policy, jrender_maze)}[tool]
    jax_tool.main(str(tmp_path / "jax.html"), jax_tool.main.__defaults__[1], steps=3)
    rec = port.main(str(tmp_path / "port.html"), device="cpu", steps=3)
    assert (rec["frames"], rec["device"], rec["launches"]) == (3, "cpu", 0)
    (jscene, jframes), (scene, frames) = _page(tmp_path / "jax.html"), _page(tmp_path /
                                                                             "port.html")
    assert scene == jscene
    assert len(frames) == len(jframes) == 3
    for f, jf in zip(frames, jframes):
        for k in ("pos", "rot"):
            np.testing.assert_allclose(np.asarray(f[k]), np.asarray(jf[k]), rtol=0,
                                       atol=1.01e-4, err_msg=k)


def main(argv=None):
    """The JAX column of the gait comparison: `jax_speed_probe` per seed."""
    parser = argparse.ArgumentParser(description=main.__doc__)
    parser.add_argument("--ckpt", default=BOMBMEM)
    parser.add_argument("--seeds", type=int, nargs="+", default=[0])
    parser.add_argument("--episodes", type=int, default=64)
    parser.add_argument("--steps", type=int, default=300)
    parser.add_argument("--det", action="store_true")
    args = parser.parse_args(argv)
    os.chdir(REPO)
    for seed in args.seeds:
        t0 = time.perf_counter()
        m = jax_speed_probe(args.ckpt, args.episodes, args.steps, seed, args.det)
        print(json.dumps({"ckpt": args.ckpt, "seed": seed, "episodes": args.episodes,
                          "steps": args.steps, "mode": "det" if args.det else "stoch",
                          "m_per_control_step": m, "device": "cpu",
                          "seconds": round(time.perf_counter() - t0, 1)}), flush=True)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    main()
