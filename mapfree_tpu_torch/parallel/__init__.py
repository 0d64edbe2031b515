from mapfree_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    batch_sharding,
    make_mesh,
    pad_to_multiple,
    replicated,
    shard_batch,
)
from mapfree_tpu_torch.parallel.multihost import (
    default_barrier,
    host_topology,
    merge_submissions,
    run_sharded_sweep,
    shard_scenes,
)
