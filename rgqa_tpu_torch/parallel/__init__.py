"""Data parallelism over ``torch.distributed`` (port of
``rgqa_tpu/parallel/``): the ranks of a run, each on its own device,
each holding the whole model and its rows of every global batch.

Tensor parallelism (the JAX ``model`` axis and ``param_partition_spec``)
is not ported: every model here fits one card.
"""

from rgqa_tpu_torch.parallel.distributed import (
    global_mesh,
    initialize_distributed,
    join_group,
)
from rgqa_tpu_torch.parallel.mesh import (
    SINGLE,
    Mesh,
    all_sum,
    barrier,
    broadcast_objects,
    check_batch_size,
    gather_objects,
    gather_rows,
    make_mesh,
    on_main,
    pad_batch_to,
    reduce_gradients,
    roll_rows,
    shard_batch,
    shard_params,
)

__all__ = [
    "Mesh",
    "SINGLE",
    "make_mesh",
    "check_batch_size",
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
    "initialize_distributed",
    "join_group",
    "global_mesh",
]
