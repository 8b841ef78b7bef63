"""Parallel layouts over ``torch.distributed`` (twin of
``ganode_tpu.parallel``): meshes and placements (``mesh.py``), the N-way
training step (``step.py``), the pipeline schedule (``pipeline.py``) and
the transport (``comm.py``)."""
from .mesh import (
    Sharding,
    data_parallel_apply,
    data_sharding,
    init_distributed,
    make_mesh,
    make_parallel_step,
    replicate,
    shard_batch,
    shard_batch_seq,
    shard_params_ep,
    shard_params_tp,
)
from .pipeline import pipeline_apply

__all__ = [
    "Sharding",
    "data_parallel_apply",
    "data_sharding",
    "init_distributed",
    "make_mesh",
    "make_parallel_step",
    "pipeline_apply",
    "replicate",
    "shard_batch",
    "shard_batch_seq",
    "shard_params_ep",
    "shard_params_tp",
]
