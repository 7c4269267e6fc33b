"""Multi-card parallelism: ranks and groups (``mesh``), sequence-sharded
attention (``seq``), tensor-parallel encoders (``sharding``), the rank
launcher (``spawn``) and the CPU dry run (``python -m
mipheivit_tpu_torch.parallel.dryrun``)."""

from .mesh import (LocalMesh, Mesh, average_gradients, init_distributed, make_data_mesh,
                   make_mesh, rank, replicate, require_process_group, shard_batch, world_size)
from .seq import current_seq_scope, seq_shard_scope, seq_sharded_attention

__all__ = ["LocalMesh", "Mesh", "average_gradients", "init_distributed", "make_data_mesh",
           "make_mesh", "rank", "replicate", "require_process_group", "shard_batch",
           "world_size", "current_seq_scope", "seq_shard_scope", "seq_sharded_attention",
           "encoder_param_specs", "shard_opt_state", "shard_params"]

# the tensor-parallel twins subclass the models' modules, whose modules import
# parallel.seq: ``sharding`` loads at first use, after the models
_SHARDING = ("encoder_param_specs", "shard_opt_state", "shard_params")


def __getattr__(name):
    if name in _SHARDING:
        from . import sharding

        return getattr(sharding, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
