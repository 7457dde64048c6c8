"""State crossing between the JAX package and the port, through numpy.

`qp_from_numpy` and `state_from_numpy` take a JAX `QP` or env `State` — or
anything shaped like one: objects with the same attributes, or dicts with
the same keys, whose leaves convert with `np.asarray` — and return the
port's tensor dataclasses. JAX keys (uint32 pairs, last axis 2) become the
port's int64 keys with the same words. `state_to_numpy` goes the other way,
to nested dicts of numpy arrays with keys as uint32 again, and
`state_from_numpy(state_to_numpy(s))` rebuilds `s`. Info entries that are
QPs (`first_qp`) or `EvalMetrics` (`eval_metrics`) keep their type; the other
entries (keys, the exploration wrapper's grids, gather's metrics) are
tensors or dicts of them.

Both entry points run on the card unless the caller names another device
(`device.resolve`): with no device and no GPU they raise.

Training states cross the same way: `training_state_from_numpy` takes a JAX
learner's state (a restored orbax tree, `checkpoint.load_npz`'s tree, or the
JAX objects themselves) and gives the port learner's state — PPO and GRU-PPO
(params / opt_state / normalizer / epochs), SAC and GRU-SAC (policy, twin q
and target_q stacked on a leading axis of 2, log_alpha, the policy, q and
alpha Adam states, normalizer, epochs, and the replay buffer and PER table
where present) — with flax's (in, out) kernels transposed into torch
weights, the GRU's (r, z, n) gates stacked as `nn.GRUCell` stacks them, and
Adam's moments (one flat vector under `optax.flatten`, parameter-shaped
trees under the per-leaf chain of `flatten_optimizer=False`) re-sliced from
JAX's leaf order into the port's flat vector in parameter order;
`training_state_to_numpy` is the inverse,
`shard_training_state` cuts a state into one rank's piece of a 'data' mesh,
and `params_checksum` fingerprints a JAX parameter tree.

Nothing here imports jax: the leaves are read as numpy arrays.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from pobrax_tpu_torch import random as jr
from pobrax_tpu_torch.device import resolve
from pobrax_tpu_torch.envs.base import State
from pobrax_tpu_torch.envs.wrappers import EvalMetrics
from pobrax_tpu_torch.physics.state import QP

_QP_FIELDS = ("pos", "rot", "vel", "ang")
_STATE_FIELDS = ("qp", "obs", "reward", "done", "metrics", "info")
_EVAL_FIELDS = tuple(f.name for f in dataclasses.fields(EvalMetrics))


def _get(obj, name):
    return obj[name] if isinstance(obj, dict) else getattr(obj, name)


def _has_fields(obj, fields) -> bool:
    if isinstance(obj, dict):
        return set(obj) == set(fields)
    return all(hasattr(obj, f) for f in fields) and not hasattr(obj, "shape")


def _is_qp(obj) -> bool:
    return isinstance(obj, QP) or _has_fields(obj, _QP_FIELDS)


def _tensor(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype == np.uint32:  # a key: int64 words in [0, 2**32)
        return torch.as_tensor(a.astype(np.int64), device=device)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.as_tensor(a.copy(), device=device)


def qp_from_numpy(qp: Any, device=None) -> QP:
    """A QP-shaped object with numpy-convertible leaves -> the port's QP on
    `device` (the card unless the caller names another)."""
    device = resolve(device)
    return QP(**{f: _tensor(_get(qp, f), device) for f in _QP_FIELDS})


def _leaf_from_numpy(x, device):
    if _is_qp(x):
        return qp_from_numpy(x, device)
    if isinstance(x, EvalMetrics) or _has_fields(x, _EVAL_FIELDS):
        return EvalMetrics(**{f: _leaf_from_numpy(_get(x, f), device) for f in _EVAL_FIELDS})
    if isinstance(x, dict):
        return {k: _leaf_from_numpy(v, device) for k, v in x.items()}
    return _tensor(x, device)


def state_from_numpy(state: Any, device=None) -> State:
    """A State-shaped object (qp, obs, reward, done, metrics, info) -> the
    port's State on `device` (the card unless the caller names another).
    Info entries that are QPs (`first_qp`) become QPs; uint32 key arrays
    become int64 keys."""
    device = resolve(device)
    return State(**{f: _leaf_from_numpy(_get(state, f), device) for f in _STATE_FIELDS})


def _to_numpy(x):
    if isinstance(x, QP):
        return {f: _to_numpy(getattr(x, f)) for f in _QP_FIELDS}
    if isinstance(x, EvalMetrics):
        return {f: _to_numpy(getattr(x, f)) for f in _EVAL_FIELDS}
    if isinstance(x, dict):
        return {k: _to_numpy(v) for k, v in x.items()}
    a = x.detach().cpu().numpy()
    return a.astype(np.uint32) if a.dtype == np.int64 else a


def state_to_numpy(state: State) -> Dict[str, Any]:
    """The port's State -> nested dicts of numpy arrays; int64 keys become
    uint32 words as in JAX."""
    return {f: _to_numpy(getattr(state, f)) for f in _STATE_FIELDS}


# ---- training states ---------------------------------------------------------
#
# A JAX training state's parameters are a flax tree of (in, out) kernels and
# biases; its optimizer state (optax.flatten(chain(clip, adam))) holds Adam's
# moments as ONE flat vector over the tree's leaves in jax.tree_util order
# (dict keys sorted). The port keeps torch (out, in) weights in nn.Modules and
# its moments as one flat vector in `parameters()` order. The layout below
# names, per port parameter, the flax leaves stacked along its first axis.

def _layout(params: torch.nn.Module) -> List[Tuple[str, List[Optional[Tuple]], bool]]:
    """(port parameter name, flax leaf paths stacked along axis 0 — None for
    rows the flax model does not have, which stay zero — and whether each
    leaf is the transpose), in `named_parameters()` order. A twin critic's
    paths end in the critic's index: JAX stacks the two critics' leaves
    along a leading axis of 2."""
    from pobrax_tpu_torch.models.networks import MLP
    from pobrax_tpu_torch.training.ppo_rnn import GRUNet
    from pobrax_tpu_torch.training.sac import TwinMLP
    from pobrax_tpu_torch.training.sac_rnn import ActorGRU, TwinCriticGRU

    out = []

    def dense(port: str, path: Tuple, sfx: Tuple = ()):
        out.append((f"{port}.weight", [path + ("kernel",) + sfx], True))
        out.append((f"{port}.bias", [path + ("bias",) + sfx], False))

    def gru(port: str, g: Tuple, sfx: Tuple = ()):
        out.append((f"{port}.weight_ih", [g + (n, "kernel") + sfx for n in ("ir", "iz", "in")],
                    True))
        out.append((f"{port}.weight_hh", [g + (n, "kernel") + sfx for n in ("hr", "hz", "hn")],
                    True))
        out.append((f"{port}.bias_ih", [g + (n, "bias") + sfx for n in ("ir", "iz", "in")],
                    False))
        out.append((f"{port}.bias_hh", [None, None, g + ("hn", "bias") + sfx], False))

    def mlp(port: str, net, path: Tuple, sfx: Tuple = ()):
        for i in range(len(net.hidden)):
            dense(f"{port}hidden.{i}", path + (f"hidden_{i}",), sfx)

    p = ("params",)
    if isinstance(params, (GRUNet, ActorGRU)):
        for i in range(len(params.enc)):
            dense(f"enc.{i}", p + (f"enc_{i}",))
        gru("gru", p + ("gru",))
        for head in (("policy_head", "value_head") if isinstance(params, GRUNet) else ("head",)):
            dense(head, p + (head,))
    elif isinstance(params, TwinCriticGRU):
        for c, critic in enumerate(params.critics):
            for i in range(len(critic.enc)):
                dense(f"critics.{c}.enc.{i}", p + (f"enc_{i}",), (c,))
            gru(f"critics.{c}.gru", p + ("gru",), (c,))
            for i in range(len(critic.head)):
                dense(f"critics.{c}.head.{i}", p + (f"head_{i}",), (c,))
            dense(f"critics.{c}.q", p + ("q",), (c,))
    elif isinstance(params, TwinMLP):
        for c, critic in enumerate(params.critics):
            mlp(f"critics.{c}.", critic, p, (c,))
    elif isinstance(params, MLP):
        mlp("", params, p)
    else:  # PPOParams: policy and value MLPs
        for net in ("policy", "value"):
            mlp(f"{net}.", getattr(params, net), (net, "params"))
    names = [n for n, _ in params.named_parameters()]
    assert names == [n for n, _, _ in out], (names, [n for n, _, _ in out])
    return out


def _as_tree(x) -> Any:
    """Objects (flax struct dataclasses) and dicts -> nested dicts of numpy."""
    if isinstance(x, dict):
        return {k: _as_tree(v) for k, v in x.items()}
    if dataclasses.is_dataclass(x):
        return {f.name: _as_tree(getattr(x, f.name)) for f in dataclasses.fields(x)}
    return np.asarray(x)


def _leaf(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def _pieces(params: torch.nn.Module):
    """Every flax leaf: (path, port parameter name, chunk, chunks, transposed,
    flax shape), sorted by path (jax's leaf order)."""
    shapes = dict(params.named_parameters())
    out = []
    for name, paths, transposed in _layout(params):
        shape = tuple(shapes[name].shape)
        chunk = (shape[0] // len(paths),) + shape[1:]
        for i, path in enumerate(paths):
            if path is not None:
                out.append((path, name, i, len(paths), transposed,
                            chunk[::-1] if transposed else chunk))
    return sorted(out, key=lambda p: p[0])


def _port_arrays(params: torch.nn.Module, leaves: Dict[Tuple[str, ...], np.ndarray]):
    """flax leaves by path -> the port's parameter arrays by name (numpy)."""
    out = {}
    shapes = {n: tuple(p.shape) for n, p in params.named_parameters()}
    for name, paths, transposed in _layout(params):
        shape = shapes[name]
        rows = shape[0] // len(paths)
        parts = [np.zeros((rows,) + shape[1:], np.float32) if p is None
                 else (np.asarray(leaves[p], np.float32).T if transposed
                       else np.asarray(leaves[p], np.float32))
                 for p in paths]
        out[name] = np.concatenate(parts, axis=0)
    return out


def _flax_leaves(params: torch.nn.Module, arrays: Dict[str, np.ndarray]):
    """The port's parameter arrays by name -> flax leaves by path (sorted)."""
    out = {}
    for path, name, i, n, transposed, _ in _pieces(params):
        part = np.split(arrays[name], n, axis=0)[i]
        out[path] = np.ascontiguousarray(part.T if transposed else part)
    return out


def _nest(leaves: Dict[Tuple, np.ndarray]) -> Dict[str, Any]:
    """Leaves by path -> nested dicts; paths ending in a critic index stack
    into one leaf with a leading critic axis."""
    twins: Dict[Tuple, list] = {}
    flat: Dict[Tuple, np.ndarray] = {}
    for path, v in leaves.items():
        if isinstance(path[-1], int):
            twins.setdefault(path[:-1], []).append((path[-1], v))
        else:
            flat[path] = v
    for path, parts in twins.items():
        flat[path] = np.stack([v for _, v in sorted(parts, key=lambda x: x[0])])
    tree: Dict[str, Any] = {}
    for path, v in flat.items():
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = v
    return tree


_SAC_NETS = ("policy", "q", "target_q")
_SAC_OPTS = (("policy_opt", "policy"), ("q_opt", "q"), ("alpha_opt", "log_alpha"))


def params_from_numpy(params: torch.nn.Module, flax_params) -> None:
    """Copy a JAX learner's parameters (numpy leaves: a `PPOParams` or its
    dict, a GRUNet's `{'params': ...}`, or SAC's params with policy, q,
    target_q and log_alpha) into the port's module."""
    from pobrax_tpu_torch.training.sac import SACParams

    if isinstance(params, SACParams):
        for f in _SAC_NETS:
            params_from_numpy(getattr(params, f), _get(flax_params, f))
        with torch.no_grad():
            params.log_alpha.value.copy_(
                torch.as_tensor(np.array(_get(flax_params, "log_alpha"), np.float32)))
        return
    tree = _as_tree(flax_params)
    leaves = {p[0]: _leaf(tree, p[0]) for p in _pieces(params)}
    arrays = _port_arrays(params, leaves)
    with torch.no_grad():
        for name, p in params.named_parameters():
            p.copy_(torch.as_tensor(arrays[name]))


def params_to_numpy(params: torch.nn.Module) -> Dict[str, Any]:
    """The port's module -> the JAX learner's parameter tree (numpy)."""
    from pobrax_tpu_torch.training.sac import SACParams

    if isinstance(params, SACParams):
        out = {f: params_to_numpy(getattr(params, f)) for f in _SAC_NETS}
        out["log_alpha"] = params.log_alpha.value.detach().cpu().numpy()
        return out
    arrays = {n: p.detach().cpu().numpy() for n, p in params.named_parameters()}
    return _nest(_flax_leaves(params, arrays))


def flat_from_numpy(params: torch.nn.Module, flat: np.ndarray) -> torch.Tensor:
    """A JAX flat vector over the parameter leaves (Adam's mu or nu) -> the
    port's flat vector in `parameters()` order, on the parameters' device."""
    pieces = _pieces(params)
    sizes = [int(np.prod(p[5])) for p in pieces]
    chunks = np.split(np.asarray(flat, np.float32), np.cumsum(sizes)[:-1])
    leaves = {p[0]: c.reshape(p[5]) for p, c in zip(pieces, chunks)}
    arrays = _port_arrays(params, leaves)
    device = next(params.parameters()).device
    return torch.as_tensor(np.concatenate([arrays[n].reshape(-1)
                                           for n, _ in params.named_parameters()]),
                           device=device)


def _flat_leaves(params: torch.nn.Module, flat: torch.Tensor) -> Dict[Tuple, np.ndarray]:
    """The port's flat vector -> flax leaves by path (sorted)."""
    named = list(params.named_parameters())
    values = np.split(flat.detach().cpu().numpy(),
                      np.cumsum([p.numel() for _, p in named])[:-1])
    return _flax_leaves(params, {n: v.reshape(p.shape) for (n, p), v in zip(named, values)})


def flat_to_numpy(params: torch.nn.Module, flat: torch.Tensor) -> np.ndarray:
    """The port's flat vector -> the JAX flat vector (leaf order)."""
    leaves = _flat_leaves(params, flat)
    return np.concatenate([leaves[p[0]].reshape(-1) for p in _pieces(params)])


def tree_from_numpy(params: torch.nn.Module, tree) -> torch.Tensor:
    """A parameter-shaped JAX tree (Adam's mu or nu under the per-leaf
    chain) -> the port's flat vector in `parameters()` order."""
    tree = _as_tree(tree)
    arrays = _port_arrays(params, {p[0]: _leaf(tree, p[0]) for p in _pieces(params)})
    return torch.as_tensor(np.concatenate([arrays[n].reshape(-1)
                                           for n, _ in params.named_parameters()]),
                           device=next(params.parameters()).device)


def tree_to_numpy(params: torch.nn.Module, flat: torch.Tensor) -> Dict[str, Any]:
    """The port's flat vector -> the parameter-shaped JAX tree."""
    return _nest(_flat_leaves(params, flat))


def _find_adam(x):
    """The node of an optax state that holds Adam's `mu`, `nu` and `count`."""
    if x is None:
        return None
    if (isinstance(x, dict) and "mu" in x) or hasattr(x, "mu"):
        return x
    items = x.values() if isinstance(x, dict) else x if isinstance(x, (list, tuple)) else ()
    for v in items:
        found = _find_adam(v)
        if found is not None:
            return found
    return None


def _maybe(obj, name):
    """obj's field or key `name`, or None where it has none."""
    if isinstance(obj, dict):
        return obj.get(name)
    return getattr(obj, name, None)


def _flat_in(module: torch.nn.Module, moment) -> torch.Tensor:
    """A JAX moment -> the port's flat vector: one flat vector (optax.flatten)
    or a parameter-shaped tree (the per-leaf chain)."""
    from pobrax_tpu_torch.training.sac import Scalar

    if isinstance(module, Scalar):  # optax.adam on a scalar: () moments
        return torch.as_tensor(np.array(moment, np.float32).reshape(1),
                               device=module.value.device)
    if isinstance(moment, dict) or dataclasses.is_dataclass(moment):
        return tree_from_numpy(module, moment)
    return flat_from_numpy(module, moment)


def _flat_out(module: torch.nn.Module, flat: torch.Tensor, per_leaf: bool):
    from pobrax_tpu_torch.training.sac import Scalar

    if isinstance(module, Scalar):
        return flat.detach().cpu().numpy().reshape(())
    return tree_to_numpy(module, flat) if per_leaf else flat_to_numpy(module, flat)


def _adam_from_numpy(module: torch.nn.Module, opt_state, per_leaf: bool = False):
    """JAX's Adam state (either layout) -> the port's; `per_leaf` (the
    learner's own, from its `init`) is the layout it is written back in."""
    from pobrax_tpu_torch.training.optimizer import AdamState

    adam = _find_adam(opt_state)
    return AdamState(count=int(np.asarray(_get(adam, "count"))),
                     mu=_flat_in(module, _get(adam, "mu")), nu=_flat_in(module, _get(adam, "nu")),
                     per_leaf=per_leaf)


def _adam_to_numpy(module: torch.nn.Module, adam) -> Dict[str, Any]:
    """The port's Adam state -> JAX's: flat moments, or parameter-shaped
    trees where the state runs the per-leaf chain."""
    return {"count": np.int32(adam.count), "mu": _flat_out(module, adam.mu, adam.per_leaf),
            "nu": _flat_out(module, adam.nu, adam.per_leaf)}


def _off_policy(ts) -> bool:
    """SAC's and GRU-SAC's state (three Adam states, the replay buffer, the
    PER table) rather than PPO's (one Adam state)."""
    from pobrax_tpu_torch.training.sac import SACTrainingState

    return isinstance(ts, SACTrainingState)


def training_state_from_numpy(state: Any, learner, key: Optional[torch.Tensor] = None):
    """A JAX training state (objects or dicts with numpy-convertible leaves,
    e.g. `checkpoint.load_npz`'s tree or a restored orbax tree) -> the
    learner's training state on its device. `learner` is built for the same
    sizes: a `PPOLearner` or an `RNNPPOLearner` (params, opt_state,
    normalizer, epochs), or a `SACLearner` or an `RSACLearner` (params with
    policy, q, target_q and log_alpha; policy_opt, q_opt, alpha_opt;
    normalizer; epochs; and, where the state has them, the replay buffer and
    the PER table; a checkpoint slice has neither)."""
    from pobrax_tpu_torch.training.running_statistics import RunningStatisticsState

    ts = learner.init(key if key is not None else jr.PRNGKey(0))
    dev = learner.device
    params_from_numpy(ts.params, _get(state, "params"))
    if _off_policy(ts):
        for opt, net in _SAC_OPTS:
            setattr(ts, opt, _adam_from_numpy(getattr(ts.params, net), _get(state, opt)))
        buffer = _maybe(state, "buffer")
        if buffer is not None:
            data = _get(buffer, "data")
            ts.buffer = ts.buffer.replace(
                data={k: torch.as_tensor(np.array(data[k], np.float32), device=dev)
                      for k in ts.buffer.data},
                insert_pos=int(np.asarray(_get(buffer, "insert_pos"))),
                size=int(np.asarray(_get(buffer, "size"))))
        pri = _maybe(state, "priorities")
        if pri is not None and np.size(pri):
            ts.priorities = torch.as_tensor(np.array(pri, np.float32), device=dev)
    elif _find_adam(_maybe(state, "opt_state")) is not None:
        ts.opt_state = _adam_from_numpy(ts.params, _get(state, "opt_state"),
                                        ts.opt_state.per_leaf)
    norm = _get(state, "normalizer")
    ts.normalizer = RunningStatisticsState(**{
        f.name: torch.as_tensor(np.array(_get(norm, f.name), np.float32), device=dev)
        for f in dataclasses.fields(RunningStatisticsState)})
    ts.epochs = int(np.asarray(_get(state, "epochs")))
    return ts


def shard_training_state(state: Any, rank: int, n: int) -> Dict[str, Any]:
    """Rank `rank` of `n`'s piece of a JAX training state (as
    `training_state_from_numpy` takes it), laid out as the JAX learners lay
    it on a 'data' mesh of n devices: parameters, optimizer states, the
    normaliser and the epoch count replicated (as they are); the replay
    buffer's env-column axis and the PER table's column axis cut to block
    `rank` (SAC's `P(None, 'data')` over (capacity, B, ...); GRU-SAC's
    `P(None, None, 'data')` over (capacity, L, B, ...), its h0 and PER table
    `P(None, 'data')` over (capacity, B, ...))."""
    def block(x, axis):
        x = np.asarray(x)
        size = x.shape[axis] // n
        return np.take(x, np.arange(rank * size, (rank + 1) * size), axis=axis)

    out = (dict(state) if isinstance(state, dict)
           else {f.name: getattr(state, f.name) for f in dataclasses.fields(state)})
    buffer = out.get("buffer")
    if buffer is not None:
        data = _get(buffer, "data")
        sequences = "h0" in data  # GRU-SAC: (capacity, L, B, ...) but h0 (capacity, B, H)
        out["buffer"] = {"data": {k: block(v, 2 if sequences and k != "h0" else 1)
                                  for k, v in data.items()},
                         "insert_pos": _get(buffer, "insert_pos"),
                         "size": _get(buffer, "size")}
    pri = out.get("priorities")
    if pri is not None and np.size(pri):
        out["priorities"] = block(pri, 1)
    return out


def training_state_to_numpy(ts) -> Dict[str, Any]:
    """The port's training state -> numpy in the JAX learner's layout: PPO's
    {"params", "opt_state": {"count", "mu", "nu"}, "normalizer", "epochs"},
    mu and nu flat, or parameter-shaped trees under the per-leaf chain;
    SAC's {"params": {policy, q, target_q, log_alpha}, "policy_opt",
    "q_opt", "alpha_opt" (each {"count", "mu", "nu"}), "normalizer",
    "epochs", "buffer": {"data", "insert_pos", "size"}} and "priorities"
    where the learner keeps a PER table."""
    out = {"params": params_to_numpy(ts.params),
           "normalizer": {k: v.detach().cpu().numpy()
                          for k, v in dataclasses.asdict(ts.normalizer).items()},
           "epochs": np.int32(ts.epochs)}
    if _off_policy(ts):
        for opt, net in _SAC_OPTS:
            out[opt] = _adam_to_numpy(getattr(ts.params, net), getattr(ts, opt))
        out["buffer"] = {"data": {k: v.detach().cpu().numpy() for k, v in ts.buffer.data.items()},
                         "insert_pos": np.int32(ts.buffer.insert_pos),
                         "size": np.int32(ts.buffer.size)}
        if ts.priorities is not None:
            out["priorities"] = ts.priorities.detach().cpu().numpy()
        return out
    out["opt_state"] = _adam_to_numpy(ts.params, ts.opt_state)
    return out


def params_checksum(flax_params) -> str:
    """sha256 over a JAX parameter tree's leaves in jax's order: each leaf's
    '/'-joined path, then its float32 bytes."""
    tree = _as_tree(flax_params)
    digest = hashlib.sha256()

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (k,))
        else:
            digest.update("/".join(path).encode())
            digest.update(np.ascontiguousarray(node, np.float32).tobytes())

    walk(tree, ())
    return digest.hexdigest()
