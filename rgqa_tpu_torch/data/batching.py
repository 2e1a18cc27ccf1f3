"""Host batches and their copy to the device (port of
``rgqa_tpu/data/batching.py``'s ``batch_indices``, ``batch_iterator`` and
``device_prefetch``).

``batch_indices`` draws the same order as the JAX package from the same
``np.random.Generator`` (the training shuffle).  ``batch_iterator`` pads
the final partial batch to the batch size (repeat-last-row) and reports
how many rows are real, as in the JAX package.  ``device_prefetch`` stands in for the JAX feed: on CUDA it
copies each batch from pinned host memory on a side stream, a few
batches ahead of the consumer, so the copies overlap the forward.
Chunked dispatch and the int8 feed are not ported.

Under N data-parallel ranks (``mesh``, a :class:`~rgqa_tpu_torch.
parallel.Mesh`) every rank draws the same global indices from the same
shuffle generator, pads the global batch as one process would, and
gathers only its own contiguous rows from the pack: the batch's
``question_ids`` and ``real`` stay the global batch's.
"""

from __future__ import annotations

import collections
from typing import Iterable, Iterator, Optional

import numpy as np
import torch

__all__ = ["batch_indices", "batch_iterator", "pad_batch_to", "to_device", "device_prefetch"]

Item = tuple[list, dict, int]  # (question_ids, batch, real row count)


def pad_batch_to(batch: dict, size: int) -> tuple[dict, int]:
    """Pad every array's leading axis to ``size`` by repeating the last
    row; returns (padded batch, original length)."""
    n = next(iter(batch.values())).shape[0]
    if n == size:
        return batch, n
    if n > size:
        raise ValueError(f"batch {n} larger than pad target {size}")
    reps = np.concatenate([np.arange(n), np.full(size - n, n - 1, dtype=np.int64)])
    return {k: np.asarray(v)[reps] for k, v in batch.items()}, n


def batch_indices(
    n: int,
    batch_size: int,
    *,
    shuffle: bool = False,
    rng: Optional[np.random.Generator] = None,
    drop_last: bool = False,
) -> Iterator[np.ndarray]:
    """Yield index arrays of (at most) ``batch_size``."""
    order = np.arange(n)
    if shuffle:
        (rng or np.random.default_rng()).shuffle(order)
    for start in range(0, n, batch_size):
        chunk = order[start : start + batch_size]
        if drop_last and len(chunk) < batch_size:
            return
        yield chunk


def batch_iterator(
    encoded,
    batch_size: int,
    *,
    shuffle: bool = False,
    rng: Optional[np.random.Generator] = None,
    drop_last: bool = False,
    with_target: bool = False,
    mesh=None,
) -> Iterator[Item]:
    """Yield ``(question_ids, host_batch, real_count)``, in dataset order
    or shuffled by ``rng``; a final partial batch is dropped
    (``drop_last``) or padded to ``batch_size``.  ``with_target`` adds
    the training targets (``EncodedGQA.gather_batch``).  With a ``mesh``
    of several ranks ``host_batch`` holds this rank's rows of the padded
    global batch (the world must divide ``batch_size``)."""
    world = 1 if mesh is None else mesh.world
    for idx in batch_indices(
        len(encoded), batch_size, shuffle=shuffle, rng=rng, drop_last=drop_last
    ):
        qids = [encoded.question_ids[i] for i in idx]
        real = len(idx)
        if world > 1:
            padded = np.concatenate([idx, np.full(batch_size - real, idx[-1], idx.dtype)])
            yield qids, encoded.gather_batch(padded[mesh.rows(batch_size)], with_target=with_target), real
            continue
        batch = encoded.gather_batch(idx, with_target=with_target)
        if real < batch_size:
            batch, real = pad_batch_to(batch, batch_size)
        yield qids, batch, real


def to_device(batch: dict, device: torch.device | str) -> dict:
    """numpy batch -> tensors on ``device`` (synchronous)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}


_PREFETCH_DEPTH = 2  # batches in flight on the copy stream


def device_prefetch(items: Iterable[Item], device: torch.device | str) -> Iterator[Item]:
    """Move each item's batch to ``device``, two batches ahead.

    On CUDA the host arrays are pinned and copied with ``non_blocking``
    on a side stream; the consumer's stream waits on each batch's copy
    before it gets the tensors (and ``record_stream`` keeps the caching
    allocator from reusing them early).  Elsewhere it copies in line."""
    device = torch.device(device)
    if device.type != "cuda":
        for qids, batch, real in items:
            yield qids, to_device(batch, device), real
        return

    copy_stream = torch.cuda.Stream(device)

    def issue(item):
        qids, batch, real = item
        with torch.cuda.stream(copy_stream):
            dev = {
                k: torch.from_numpy(np.ascontiguousarray(v))
                .pin_memory()
                .to(device, non_blocking=True)
                for k, v in batch.items()
            }
            done = torch.cuda.Event()
            done.record(copy_stream)
        return qids, dev, real, done

    it = iter(items)
    pending = collections.deque()
    for item in it:
        pending.append(issue(item))
        if len(pending) >= _PREFETCH_DEPTH:
            break
    while pending:
        qids, dev, real, done = pending.popleft()
        consumer = torch.cuda.current_stream(device)
        consumer.wait_event(done)
        for t in dev.values():
            t.record_stream(consumer)
        nxt = next(it, None)
        if nxt is not None:
            pending.append(issue(nxt))
        yield qids, dev, real
