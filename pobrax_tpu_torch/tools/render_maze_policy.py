"""Render the trained AntMaze GRU policy to an offline HTML page; the port
of `tools/render_maze_policy.py`.

Loads the export of checkpoints/ant_maze_rnn_400M
(`pobrax_tpu_torch/checkpoints/ant_maze_rnn_400M.npz`) and rolls one
deterministic episode on the unshaped env (reset key PRNGKey(1), action
keys from PRNGKey(2)), saved by `io/html.py`, reporting whether the goal
was reached (`eval_checkpoint.render`).

Usage: python -m pobrax_tpu_torch.tools.render_maze_policy [out.html] [npz]
       [--device cpu]
(default out: runs/samples/ant_maze_trained.html). The card unless a device
is named (with no card and no device named it raises).
"""

from __future__ import annotations

import sys

from pobrax_tpu_torch.tools import _render

NAME, STEPS = "maze", 300


def main(out: str = _render.default_out("ant_maze_trained.html"), npz=None, device=None,
         steps: int = STEPS) -> dict:
    return _render.render(NAME, out, npz, device, steps)


if __name__ == "__main__":
    main(*_render.command_line(sys.argv[1:], main))
