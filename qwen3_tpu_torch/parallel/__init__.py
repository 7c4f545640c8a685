from qwen3_tpu_torch.parallel.sharding import (  # noqa: F401
    kv_partition_spec,
    make_mesh,
    param_partition_specs,
    shard_kv_cache,
    shard_params,
)
