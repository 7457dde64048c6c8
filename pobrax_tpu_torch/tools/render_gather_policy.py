"""Render the trained AntGather GRU policy to an offline HTML page; the
port of `tools/render_gather_policy.py`.

Loads the export of checkpoints/ant_gather_rnn_800M
(`pobrax_tpu_torch/checkpoints/ant_gather_rnn_800M.npz`) and rolls one
deterministic episode on the true env (reset key PRNGKey(1), action keys
from PRNGKey(2)), saved by `io/html.py`, reporting the apples and bombs
caught in the rendered window (`eval_checkpoint.render`).

Usage: python -m pobrax_tpu_torch.tools.render_gather_policy [out.html] [npz]
       [--device cpu]
(default out: runs/samples/ant_gather_trained.html). The card unless a
device is named (with no card and no device named it raises).
"""

from __future__ import annotations

import sys

from pobrax_tpu_torch.tools import _render

NAME, STEPS = "gather", 500


def main(out: str = _render.default_out("ant_gather_trained.html"), npz=None, device=None,
         steps: int = STEPS) -> dict:
    return _render.render(NAME, out, npz, device, steps)


if __name__ == "__main__":
    main(*_render.command_line(sys.argv[1:], main))
