from mapfree_tpu_torch.parallel.multihost import (
    default_barrier,
    host_topology,
    merge_submissions,
    run_sharded_sweep,
    shard_scenes,
)
