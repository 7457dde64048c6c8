"""What the two render tools share: loading an export, the rendered episode
(`eval_checkpoint.render`), the record, the command line."""

from __future__ import annotations

import json
from typing import Optional

from pobrax_tpu_torch import eval_checkpoint
from pobrax_tpu_torch.device import resolve
from pobrax_tpu_torch.examples._common import run_path, split_options
from pobrax_tpu_torch.physics import whole_step
from pobrax_tpu_torch.utils.profiling import record_device


def default_out(page: str) -> str:
    """runs/samples/<page> (the JAX tools write docs/samples/)."""
    return run_path(f"samples/{page}")


def render(name: str, out: str, npz: Optional[str], device, steps: int) -> dict:
    """One deterministic episode of `steps` frames of checkpoint `name`
    (eval_checkpoint.CHECKPOINTS; its committed export unless `npz`) to the
    page `out` -> {what it caught or reached, the page, its kernel launches,
    the device and card}."""
    dev = resolve(device)
    learner, ts, same = eval_checkpoint.load(name, dev, npz)
    if not same:
        raise RuntimeError(f"{npz or eval_checkpoint.npz_path(name)}: the loaded parameters do "
                           "not match their checksum")
    n0 = whole_step.launches
    result = eval_checkpoint.render(name, learner, ts, out, steps)
    record = {**result, "html": out, "frames": steps, "launches": whole_step.launches - n0,
              **record_device(dev)}
    print(json.dumps(record), flush=True)
    return record


def command_line(argv, main) -> tuple:
    """(out, npz, device) from `[out.html] [npz] [--device D]`."""
    args, device, _ = split_options(argv)
    defaults = main.__defaults__
    return (args[0] if len(args) > 0 else defaults[0], args[1] if len(args) > 1 else None,
            device)
