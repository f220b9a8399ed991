from dorado_tpu_torch.parallel.sharding import (
    Mesh,
    ShardedModel,
    make_mesh,
    make_sharded_basecall_step,
    shard_params,
)

__all__ = ["Mesh", "ShardedModel", "make_mesh", "make_sharded_basecall_step", "shard_params"]
