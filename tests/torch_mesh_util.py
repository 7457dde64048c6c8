"""Helpers of the port's mesh tests (tests/test_torch_mesh*.py).

The torch ranks run in a jax-free worker script: the test writes it to its
tmp_path and runs it with `subprocess` in a session of its own; the script
starts its ranks with `pobrax_tpu_torch.parallel.mesh.spawn` over gloo on the
CPU and pickles what they return to `results.pkl` beside itself. A worker
that outlasts its deadline is killed with its whole session, ranks included.
"""

import os
import pickle
import signal
import subprocess
import sys
import textwrap

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# every worker's head: the repo on the path, one torch thread a rank
HEAD = textwrap.dedent("""
    import os, pickle, sys
    sys.path.insert(0, os.environ["REPO"])
    import numpy as np
    import torch
    from pobrax_tpu_torch.parallel import mesh as pm
    OUT = os.environ["OUT"]

    def finish(results):
        with open(os.path.join(OUT, "results.pkl"), "wb") as f:
            pickle.dump(results, f)
""")


def run_worker(tmp_path, body: str, timeout: float = 110.0):
    """Run HEAD + `body` (which calls `finish(results)` under its
    `__main__` check) and return the unpickled results."""
    script = tmp_path / "worker.py"
    script.write_text(HEAD + textwrap.dedent(body))
    env = {**os.environ, "REPO": REPO, "OUT": str(tmp_path)}
    proc = subprocess.Popen([sys.executable, str(script)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env, cwd=str(tmp_path),
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        pytest.fail(f"the torch ranks outlasted {timeout:.0f} s:\n{out[-4000:]}")
    assert proc.returncode == 0, out[-4000:]
    with open(tmp_path / "results.pkl", "rb") as f:
        return pickle.load(f)


def plain(x):
    """A JAX pytree (struct dataclasses, optax's named tuples, dicts, arrays)
    as nested dicts, lists and numpy arrays, which a jax-free process can
    unpickle and `pobrax_tpu_torch.interop` reads."""
    if hasattr(x, "_asdict"):
        return {k: plain(v) for k, v in x._asdict().items()}
    if hasattr(x, "__dataclass_fields__"):
        return {k: plain(getattr(x, k)) for k in x.__dataclass_fields__}
    if hasattr(x, "items"):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    return np.asarray(x)


def leaves(tree, path=()):
    """(path, array) for every leaf of nested dicts, in sorted key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], path + (k,))
    else:
        yield path, np.asarray(tree)


def assert_trees_equal(a, b, what: str) -> None:
    """Bit-equal leaves (the ranks' replicated state)."""
    la, lb = dict(leaves(a)), dict(leaves(b))
    assert la.keys() == lb.keys(), what
    for path, x in la.items():
        np.testing.assert_array_equal(x, lb[path], err_msg=f"{what} {path}")
