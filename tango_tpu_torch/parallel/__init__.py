from tango_tpu_torch.parallel.mesh import (
    init_distributed,
    make_mesh,
    param_shardings,
    shard_batch,
    shard_params,
)

__all__ = ["init_distributed", "make_mesh", "param_shardings", "shard_batch", "shard_params"]
