"""Data and tensor parallelism over `torch.distributed` (port of
`optispeech_tpu/parallel/`): one process per device."""

from .mesh import (
    all_reduce_grads,
    data_rank,
    data_size,
    init_distributed,
    make_hybrid_mesh,
    make_mesh,
    reduce_logs,
    replicate_state,
    shard_batch,
)
from .tp import make_2d_mesh, replicate_tp, shard_params_tp

__all__ = ["all_reduce_grads", "data_rank", "data_size", "init_distributed", "make_2d_mesh",
           "make_hybrid_mesh", "make_mesh", "reduce_logs", "replicate_state", "replicate_tp",
           "shard_batch", "shard_params_tp"]
