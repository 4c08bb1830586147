"""Data parallelism over explicit ``torch.distributed`` groups (port of
``object_detection_destr_tpu/parallel``)."""

from .mesh import (
    Mesh,
    auto_mesh,
    batch_sharding,
    group_from_store,
    launched,
    make_mesh,
    replicated_sharding,
    shard_batch,
)

__all__ = ["Mesh", "auto_mesh", "batch_sharding", "group_from_store", "launched", "make_mesh",
           "replicated_sharding", "shard_batch"]
