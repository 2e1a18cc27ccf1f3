"""Data parallelism over ``torch.distributed`` (port of
``rgqa_tpu/parallel/mesh.py``; the JAX names are kept so that each
counterpart is found by its name).

The JAX package shards every batch over the ``data`` axis of a mesh that
spans all local devices, and XLA inserts the gradient all-reduce.  Here
each process (a *rank*) holds the whole model and this rank's contiguous
rows of each global batch; the collectives are explicit:

- :func:`make_mesh` gives a :class:`Mesh` record (world, rank, device,
  process group).  With no process group it is a 1-rank mesh, and every
  function below is then the identity (or the one-process operation, as
  :func:`roll_rows`), so one code path serves both cases, as JAX's 1x1
  mesh does.
- :func:`shard_batch` / :meth:`Mesh.rows`: this rank's rows of a padded
  global batch; :func:`pad_batch_to` is the feed's.
- :func:`shard_params` broadcasts rank 0's weights after init or load.
- :func:`reduce_gradients` averages the gradients with one all-reduce
  over a flat buffer (the loss values of the step ride in it), before the
  global clip: JAX clips the global gradient.
- :func:`all_sum` (global counts and sums), :func:`gather_rows` (the
  global batch's rows, in rank order) and :func:`roll_rows` (a roll of
  the global batch, which may bring a row from another rank).
- :func:`gather_objects` (every rank's host object) and
  :func:`broadcast_objects` (rank 0's: the serving waves that rank 0
  alone reads).

The convention that makes an N-rank step equal the one-process step at
the same global batch: each rank's loss is a local term whose mean over
the ranks is the global loss.  A mean over rows is that already (every
rank has as many rows); a ratio of sums takes its denominator from
:func:`all_sum` and is scaled by the world size; a loss that every rank
computes alike from :func:`gather_rows` gets the world size from the
gather's backward.  :func:`reduce_gradients`' average then gives the
global gradient.

Tensor parallelism (JAX ``param_partition_spec``) is not ported: every
model of the repository fits one card.  ``make_mesh(model=N)`` with N
other than 1 raises, naming it.

The gloo backend takes CPU tensors for every collective used here; a
CUDA tensor is staged through pinned host memory for gloo (two ranks on
one card), never for NCCL.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Iterable, Optional, Sequence

import torch
import torch.distributed as dist

from rgqa_tpu_torch.data.batching import pad_batch_to

__all__ = [
    "Mesh",
    "SINGLE",
    "make_mesh",
    "check_batch_size",
    "env_world",
    "shard_batch",
    "shard_params",
    "pad_batch_to",
    "reduce_gradients",
    "all_sum",
    "gather_rows",
    "roll_rows",
    "gather_objects",
    "broadcast_objects",
    "barrier",
    "on_main",
]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in the data-parallel world: ``world`` ranks,
    this one ``rank``, its ``device``, the ``backend`` and process
    ``group`` (None: the default group) of the collectives."""

    world: int = 1
    rank: int = 0
    device: Optional[torch.device] = None
    backend: Optional[str] = None
    group: Any = None

    @property
    def is_main(self) -> bool:
        """Rank 0: the one rank that writes files and prints."""
        return self.rank == 0

    def rows(self, n: int) -> slice:
        """This rank's contiguous rows of a global batch of ``n`` rows."""
        if n % self.world:
            raise ValueError(
                f"a global batch of {n} rows over WORLD_SIZE {self.world}: the world must divide it"
            )
        per = n // self.world
        return slice(self.rank * per, (self.rank + 1) * per)


SINGLE = Mesh()


def _mesh(mesh: Optional[Mesh]) -> Mesh:
    return SINGLE if mesh is None else mesh


def env_world() -> int:
    """``WORLD_SIZE`` of this process's launch (1 without one)."""
    return int(os.environ.get("WORLD_SIZE", "1") or 1)


def make_mesh(device: Optional[torch.device | str] = None, *, model: int = 1) -> Mesh:
    """The data-parallel mesh of this process: over the process group when
    one is initialized (:func:`~rgqa_tpu_torch.parallel.distributed.
    initialize_distributed`), else one rank.  ``model`` other than 1
    (``--model_axis``) raises: tensor parallelism is not ported.  A
    process launched as one of several ranks (``WORLD_SIZE`` > 1) without
    a process group raises too, so that it never carries on alone."""
    if model != 1:
        raise NotImplementedError(
            f"--model_axis {model}: tensor parallelism (the JAX package's param_partition_spec) is not "
            "ported; every model here fits one card, so the port runs data parallel only (--model_axis 1)"
        )
    device = None if device is None else torch.device(device)
    if dist.is_available() and dist.is_initialized():
        return Mesh(world=dist.get_world_size(), rank=dist.get_rank(), device=device,
                    backend=str(dist.get_backend()))
    world = env_world()
    if world > 1:
        raise RuntimeError(
            f"WORLD_SIZE is {world} but no process group is initialized: call "
            "rgqa_tpu_torch.parallel.initialize_distributed() first (the CLIs do)"
        )
    return Mesh(device=device)


def check_batch_size(mesh: Optional[Mesh], batch_size: int, flag: str = "--batchSize") -> None:
    """Raise unless the world divides the global batch ``batch_size``."""
    mesh = _mesh(mesh)
    if batch_size % mesh.world:
        raise ValueError(
            f"{flag} {batch_size} is the global batch and WORLD_SIZE {mesh.world} does not divide it: "
            f"give a multiple of {mesh.world}"
        )


def shard_batch(mesh: Optional[Mesh], batch: dict) -> dict:
    """This rank's rows of every array of a padded global ``batch``."""
    mesh = _mesh(mesh)
    if mesh.world == 1:
        return batch
    rows = mesh.rows(next(iter(batch.values())).shape[0])
    return {k: v[rows] for k, v in batch.items()}


# ---------------------------------------------------------------------------
# Collectives (the identity on one rank).
# ---------------------------------------------------------------------------


def _staged(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """``t`` where the backend can take it: a pinned host copy for gloo
    when ``t`` lies on a card, else ``t`` itself."""
    if mesh.backend == "gloo" and t.is_cuda:
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        return host
    return t


def all_sum(mesh: Optional[Mesh], x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ranks (a new tensor; no gradient)."""
    mesh = _mesh(mesh)
    if mesh.world == 1:
        return x
    buf = _staged(mesh, x.detach().clone())
    dist.all_reduce(buf, group=mesh.group)
    return buf.to(x.device, non_blocking=True)


class _GatherRows(torch.autograd.Function):
    """All-gather along dim 0; backward: this rank's rows of the gradient
    times the world size (see the module's convention)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, mesh: Mesh):
        ctx.mesh = mesh
        src = _staged(mesh, x.detach().contiguous())
        parts = [torch.empty_like(src) for _ in range(mesh.world)]
        dist.all_gather(parts, src, group=mesh.group)
        return torch.cat(parts, 0).to(x.device, non_blocking=True)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        mesh = ctx.mesh
        return grad[mesh.rows(grad.shape[0])] * mesh.world, None


def gather_rows(mesh: Optional[Mesh], x: torch.Tensor) -> torch.Tensor:
    """The global batch of a per-row tensor: every rank's rows in rank
    order.  Differentiable: a loss that every rank computes alike from the
    gathered rows gets, after :func:`reduce_gradients`, its own
    gradient."""
    mesh = _mesh(mesh)
    if mesh.world == 1:
        return x
    return _GatherRows.apply(x, mesh)


def roll_rows(mesh: Optional[Mesh], x: torch.Tensor, shift: int) -> torch.Tensor:
    """This rank's rows of ``torch.roll(global x, shift, 0)``: each row
    takes the global row ``shift`` before it, which may lie on another
    rank."""
    mesh = _mesh(mesh)
    if mesh.world == 1:
        return torch.roll(x, shift, 0)
    full = gather_rows(mesh, x)
    return torch.roll(full, shift, 0)[mesh.rows(full.shape[0])]


def reduce_gradients(mesh: Optional[Mesh], params: Iterable[torch.nn.Parameter],
                     extras: Sequence[torch.Tensor] = ()) -> list:
    """Average the ``.grad`` of ``params`` over the ranks in place, with
    one all-reduce over a flat f32 buffer that also carries ``extras``
    (a step's loss values, returned averaged, in their shapes).  A
    parameter without a gradient on every rank keeps none; one with a
    gradient on some rank gets the average.  On one rank it returns
    ``extras`` (detached) and touches nothing."""
    mesh = _mesh(mesh)
    extras = [e.detach() for e in extras]
    if mesh.world == 1:
        return extras
    params = list(params)
    device = params[0].device if params else extras[0].device
    has = torch.tensor([p.grad is not None for p in params], dtype=torch.float32, device=device)
    flat = torch.cat(
        [(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1).float() for p in params]
        + [e.reshape(-1).float().to(device) for e in extras] + [has]
    )
    buf = _staged(mesh, flat)
    dist.all_reduce(buf, group=mesh.group)
    flat = buf.to(device, non_blocking=True) if buf is not flat else flat
    flat.div_(mesh.world)
    n_grads = sum(p.numel() for p in params)
    flags = flat[flat.numel() - len(params):] > 0
    offset = 0
    for p, on in zip(params, flags.tolist()):
        n = p.numel()
        if on:
            p.grad = flat[offset: offset + n].view_as(p).to(p.dtype)
        offset += n
    out, offset = [], n_grads
    for e in extras:
        out.append(flat[offset: offset + e.numel()].view_as(e).to(e.dtype))
        offset += e.numel()
    return out


def shard_params(mesh: Optional[Mesh], module: torch.nn.Module) -> torch.nn.Module:
    """Give every rank rank 0's parameters and buffers (after init or
    load), in place; ``module`` on one rank as it is."""
    mesh = _mesh(mesh)
    if mesh.world == 1:
        return module
    with torch.no_grad():
        for t in module.state_dict().values():
            buf = _staged(mesh, t)
            dist.broadcast(buf, 0, group=mesh.group)
            if buf is not t:
                t.copy_(buf)
    return module


def gather_objects(mesh: Optional[Mesh], obj) -> list:
    """Every rank's picklable ``obj``, in rank order."""
    mesh = _mesh(mesh)
    if mesh.world == 1:
        return [obj]
    out = [None] * mesh.world
    dist.all_gather_object(out, obj, group=mesh.group)
    return out


def broadcast_objects(mesh: Optional[Mesh], obj):
    """Rank 0's picklable ``obj`` on every rank (``obj`` of the other
    ranks is ignored); ``obj`` itself on one rank."""
    mesh = _mesh(mesh)
    if mesh.world == 1:
        return obj
    box = [obj if mesh.is_main else None]
    # NCCL carries the pickle on this rank's card, gloo on the host.
    device = mesh.device if mesh.backend == "nccl" else None
    dist.broadcast_object_list(box, src=0, group=mesh.group, device=device)
    return box[0]


def barrier(mesh: Optional[Mesh]) -> None:
    """Wait for every rank (after rank 0 writes what the others read)."""
    mesh = _mesh(mesh)
    if mesh.world > 1:
        dist.barrier(group=mesh.group)


def on_main(mesh: Optional[Mesh], write, *args, **kw):
    """``write(*args, **kw)`` on rank 0 alone (its result there, None
    elsewhere); every rank then waits at a barrier, so that the others
    may read what rank 0 wrote."""
    mesh = _mesh(mesh)
    out = write(*args, **kw) if mesh.is_main else None
    barrier(mesh)
    return out
