from ics_tpu_torch.parallel.mesh import (  # noqa: F401
    batch_sharding,
    make_mesh,
    replicated_sharding,
    shard_head_for_tp,
)
