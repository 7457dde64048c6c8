"""The process mesh and its collectives on `torch.distributed`; the port of
`pobrax_tpu/parallel/mesh.py`.

JAX lays a ('data', 'model') mesh over devices (the device list reshaped
to (data, model), row-major) and lets XLA insert the collectives. Here
every process of a `torch.distributed` group is one position of that grid,
process r at (r // model, r % model), and holds its own device; the learners
call the collectives below themselves:
  * `shard_batch` keeps a process's contiguous block of a leading batch
    axis, JAX's `P('data')` layout: rank d of D holds rows
    [d * B / D, (d + 1) * B / D);
  * `replicate` broadcasts tensors from rank 0 (JAX's `P()`);
  * `psum` / `pmean` are one `all_reduce` of a tensor over the 'data' axis:
    the processes of this one's 'model' index (a group each, made by
    `make_mesh`; the whole group where 'model' is 1);
  * `draw_block` names the rank's block of a draw whose shape is global, so
    `random` can give each rank its rows of the single-process draw.
A `Mesh` with no process group (one process, `torch.distributed` not
initialised) is a 1x1 mesh whose collectives return their input.

The backend is the caller's choice and is never switched after a failure:
"nccl" where every rank owns a card (`torch.cuda.set_device(LOCAL_RANK)`
before the group comes up), "gloo" for the CPU and for several ranks
sharing one card (NCCL refuses two ranks on one GPU; gloo's `all_reduce`
and `broadcast` take CUDA tensors through the host). The 'model' axis has
JAX's semantics: the batch is sharded over 'data' and replicated over
'model', parameters are replicated everywhere (JAX reserves the axis for
parameter sharding, which no caller does), so the processes of one 'data'
position compute the same thing; process 0 writes checkpoints.

`spawn` runs a function on n local ranks (the `spawn` start method, a free
TCP port, a deadline; every rank is killed when one fails) for the tests,
`chip_smoke.py` and `graft_entry.dryrun_multichip`.
"""

from __future__ import annotations

import dataclasses
import multiprocessing
import os
import pickle
import socket
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch
import torch.distributed as dist
from torch import nn

from pobrax_tpu_torch.device import resolve


@dataclass(frozen=True)
class Mesh:
    """A ('data', 'model') mesh over the processes of a group: this process
    is position `rank` of `data` on the 'data' axis and `model_rank` of
    `model` on the 'model' axis, and runs on `device`."""

    data: int
    model: int
    rank: int
    group: Optional[Any]  # its 'data' axis's process group; None: no group (one process)
    device: torch.device
    backend: Optional[str]
    model_rank: int = 0

    @property
    def process_rank(self) -> int:
        """This process's rank in the whole group (row-major over (data, model))."""
        return self.rank * self.model + self.model_rank

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data, "model": self.model}

    @property
    def world(self) -> int:
        """The processes the mesh spans."""
        return self.data * self.model

    def block(self, n: int) -> slice:
        """This rank's contiguous block of `n` items along 'data'."""
        if n % self.data:
            raise ValueError(f"{n} items do not split over a 'data' axis of {self.data}")
        size = n // self.data
        return slice(self.rank * size, (self.rank + 1) * size)


def local_rank() -> int:
    """This process's card on its host (torchrun's and `spawn`'s LOCAL_RANK)."""
    return int(os.environ.get("LOCAL_RANK", 0))


def initialize_distributed(backend: str = "nccl", init_method: Optional[str] = None,
                           **kwargs) -> bool:
    """Bring up the default process group (`torch.distributed.init_process_group`
    with `backend`, `init_method` and `kwargs` such as `rank` and
    `world_size`). Returns False when no rendezvous is configured (no
    `init_method` and none of RANK, WORLD_SIZE, MASTER_ADDR in the
    environment: a single-process run), True once the group is up; raises
    when one was asked for and could not come up. With "nccl" the process
    first takes its card, LOCAL_RANK."""
    if dist.is_initialized():
        return True
    if init_method is None and not any(k in os.environ
                                       for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR")):
        return False
    if backend == "nccl":
        torch.cuda.set_device(local_rank())
    dist.init_process_group(backend, init_method=init_method, **kwargs)
    return True


def make_mesh(data: Optional[int] = None, model: int = 1,
              device: Optional[Union[str, torch.device]] = None) -> Mesh:
    """A ('data', 'model') mesh over the processes of the default group (one
    process when none is initialised). `data * model` must tile them;
    process r sits at (r // model, r % model). With 'model' > 1 every
    process must call this together: it makes one process group per 'model'
    index, that index's 'data' axis. The device is the card unless the
    caller names another; under NCCL it is this process's card, LOCAL_RANK."""
    if dist.is_available() and dist.is_initialized():
        world, rank, backend = dist.get_world_size(), dist.get_rank(), dist.get_backend()
        group = dist.group.WORLD
    else:
        world, rank, backend, group = 1, 0, None, None
    if data is None:
        data = world // model
    if data * model != world:
        raise ValueError(f"mesh {data}x{model} does not tile {world} processes")
    rank, model_rank = divmod(rank, model)
    if group is not None and model > 1:
        groups = [dist.new_group([d * model + m for d in range(data)]) for m in range(model)]
        group = groups[model_rank]
    device = resolve(device)
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError(f"NCCL needs CUDA tensors, not {device}")
        device = torch.device("cuda", local_rank())
    return Mesh(data=data, model=model, rank=rank, group=group, device=device, backend=backend,
                model_rank=model_rank)


def tree_map(fn: Callable[[torch.Tensor], Any], x):
    """`fn` on every tensor of a tree of dicts, lists, tuples and dataclasses
    (State, QP, the training states); other leaves stay as they are."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, dict):
        return {k: tree_map(fn, v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(tree_map(fn, v) for v in x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return type(x)(**{f.name: tree_map(fn, getattr(x, f.name))
                          for f in dataclasses.fields(x)})
    return x


def shard_batch(tree, mesh: Mesh):
    """This rank's block of every tensor's leading (batch) axis."""
    return tree_map(lambda x: x[mesh.block(x.shape[0])], tree)


def replicate(tree, mesh: Mesh):
    """Every tensor of `tree` (modules: their parameters and buffers) set to
    process 0's values on every process of the mesh, in place; returns
    `tree`. Host values (ints, floats) are left as they are: the caller keeps
    them equal."""
    if mesh.group is None:
        return tree

    def bcast(t: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            dist.broadcast(t, src=0)
        return t

    if isinstance(tree, nn.Module):
        for t in tree.state_dict().values():
            bcast(t)
        return tree
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            replicate(getattr(tree, f.name), mesh)
        return tree
    if isinstance(tree, dict):
        for v in tree.values():
            replicate(v, mesh)
        return tree
    if isinstance(tree, (list, tuple)):
        for v in tree:
            replicate(v, mesh)
        return tree
    if isinstance(tree, torch.Tensor):
        bcast(tree)
    return tree


def psum(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The sum of `x` over the mesh's 'data' axis (one `all_reduce`); `x`
    itself without a mesh or a group."""
    if mesh is None or mesh.group is None:
        return x
    out = x.detach().clone()
    dist.all_reduce(out, group=mesh.group)
    return out


def pmean(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The mean of `x` over the mesh's 'data' axis (one `all_reduce`)."""
    if mesh is None or mesh.group is None:
        return x
    return psum(x, mesh) / mesh.data


def draw_block(mesh: Optional[Mesh], axis: int = 0) -> Optional[Tuple[int, int, int]]:
    """(axis, rank, data): a local tensor is block `rank` of `data` along
    `axis` of the global one (`random`'s `block`); None without a mesh."""
    return None if mesh is None else (axis, mesh.rank, mesh.data)


def barrier(mesh: Optional[Mesh]) -> None:
    """Every process of the mesh meets here."""
    if mesh is not None and mesh.group is not None:
        dist.barrier()


# ---- local ranks -------------------------------------------------------------


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank: int, nprocs: int, backend: str, device, port: int, model: int, args,
               results):
    os.environ["LOCAL_RANK"] = str(rank)
    initialize_distributed(backend, init_method=f"tcp://localhost:{port}", rank=rank,
                           world_size=nprocs)
    try:
        # pickled here by value: the queue's own pickler would pass tensors as
        # shared-memory handles, which die with this process
        results.put((rank, pickle.dumps(fn(make_mesh(model=model, device=device), *args))))
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, nprocs: int, backend: str, device, *args,
          timeout: float = 600.0, model: int = 1) -> List[Any]:
    """Run `fn(mesh, *args)` on `nprocs` local ranks of a new process group
    (`backend` over tcp://localhost and a free port; `device` as
    `make_mesh` takes it, each NCCL rank on its own card; the mesh is
    `nprocs / model` x `model`) and return each rank's result, in rank
    order. `fn` must be importable by name (the
    `spawn` start method: the parent may hold a CUDA context) and return a
    picklable value (tensors on the CPU). If a rank exits non-zero or the
    ranks outlast `timeout` seconds, every rank is killed and this raises."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.SimpleQueue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, nprocs, backend, device, port, model, args, results))
             for r in range(nprocs)]
    for p in procs:
        p.start()
    out: Dict[int, Any] = {}
    deadline = time.monotonic() + timeout
    try:
        while True:
            while not results.empty():  # drain before the ranks can exit
                rank, value = results.get()
                out[rank] = pickle.loads(value)
            codes = [p.exitcode for p in procs]
            failed = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
            if failed:
                raise RuntimeError(f"of {nprocs} ranks, " + ", ".join(
                    f"rank {r} exited with code {c}" for r, c in failed))
            if all(c == 0 for c in codes):
                while not results.empty():
                    rank, value = results.get()
                    out[rank] = pickle.loads(value)
                break
            if time.monotonic() > deadline:
                raise TimeoutError(f"{nprocs} ranks did not finish within {timeout:.0f} s")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
    if sorted(out) != list(range(nprocs)):
        raise RuntimeError(f"ranks {sorted(set(range(nprocs)) - set(out))} returned nothing")
    return [out[r] for r in range(nprocs)]
