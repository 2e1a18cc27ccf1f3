"""Joining the ranks of a data-parallel run (port of
``rgqa_tpu/parallel/distributed.py``'s ``initialize_multihost`` and
``global_mesh``).

A run of N ranks starts with ``torchrun``, which ships with PyTorch::

    python -m torch.distributed.run --nproc_per_node N \\
        -m rgqa_tpu_torch.cli.train ...

and gives each process ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR`` and ``MASTER_PORT``.  :func:`initialize_distributed`
reads them and joins the group: NCCL on the card ``cuda:LOCAL_RANK``,
gloo under ``--device cpu``.  Without them it does nothing and the run
is one process, as before.  A failed join raises; nothing carries on as
one process.  Every join has a time limit (``JOIN_SECONDS`` unless the
caller gives one), which is also the limit of each collective after it:
a rank whose peers never come fails by name instead of waiting for
ever.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from rgqa_tpu_torch.device import resolve_device
from rgqa_tpu_torch.parallel.mesh import Mesh, make_mesh

__all__ = ["initialize_distributed", "join_group", "global_mesh", "JOIN_SECONDS"]

ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
# The join's and every collective's time limit under torchrun: torch's
# own default (30 minutes for gloo), which a rank waiting on rank 0's
# host work (a fit, a dataset written once, a service's idle stdin) may
# need.
JOIN_SECONDS = 1800.0


def join_group(backend: str, rank: int, world: int, init_method: Optional[str] = None, *,
               store=None, timeout: float = JOIN_SECONDS) -> None:
    """Join the process group (``init_process_group``) at ``init_method``
    or through a ``store`` that another process hosts; the join and each
    later collective fail after ``timeout`` seconds.  Raises on
    failure."""
    dist.init_process_group(backend=backend, init_method=init_method, store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout))


def initialize_distributed(device: Optional[torch.device | str] = None) -> Optional[torch.device]:
    """Join the ranks that torchrun's environment describes; return this
    rank's device (``cuda:LOCAL_RANK`` or the CPU), or None without the
    environment (one process: nothing is done).  ``device`` is the run's
    ``--device`` (default the card).  Raises when the environment is
    incomplete, when ``LOCAL_RANK`` is not below the number of cards (no
    two ranks share a card), or when the join fails."""
    present = [k for k in ENV if k in os.environ]
    if not present:
        return None
    missing = [k for k in ENV if k not in os.environ]
    if missing:
        raise RuntimeError(f"a data-parallel launch sets {', '.join(ENV)}; {', '.join(missing)} missing")
    rank, world, local = (int(os.environ[k]) for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"))
    dev = resolve_device(device)
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        if local >= cards:
            raise ValueError(
                f"LOCAL_RANK {local} but this host has {cards} card(s): each rank takes a card of its own "
                f"(--nproc_per_node at most {cards})"
            )
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
        backend = "nccl"
    else:
        backend = "gloo"
    if not dist.is_initialized():
        join_group(backend, rank, world, f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}")
    return dev


def global_mesh(model: int = 1) -> Mesh:
    """The mesh over every rank; ``model`` > 1 raises (tensor parallelism
    is not ported)."""
    return make_mesh(model=model)
