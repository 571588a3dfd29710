from pngloss_tpu_torch.parallel.mesh import (
    data_mesh,
    optimize_batch_sharded,
    resolve_mesh,
    shard_bounds,
)

__all__ = ["data_mesh", "optimize_batch_sharded", "resolve_mesh",
           "shard_bounds"]
