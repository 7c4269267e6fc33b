"""Multi-card parallelism: ranks and groups (``mesh``), sequence-sharded
attention (``seq``), tensor-parallel encoders (``sharding``), the rank
launcher (``spawn``) and the CPU dry run (``python -m
mipheivit_tpu_torch.parallel.dryrun``)."""

from .mesh import (LocalMesh, Mesh, average_gradients, init_distributed, make_data_mesh,
                   make_mesh, rank, replicate, require_process_group, shard_batch, world_size)
from .seq import current_seq_scope, seq_shard_scope, seq_sharded_attention
from .sharding import encoder_param_specs, shard_opt_state, shard_params

__all__ = ["LocalMesh", "Mesh", "average_gradients", "init_distributed", "make_data_mesh",
           "make_mesh", "rank", "replicate", "require_process_group", "shard_batch",
           "world_size", "current_seq_scope", "seq_shard_scope", "seq_sharded_attention",
           "encoder_param_specs", "shard_opt_state", "shard_params"]
