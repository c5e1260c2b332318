"""Device-mesh and multi-process sharding of the N x N pair grid."""

from acoss_jax.parallel.distributed import (  # noqa: F401
    assign_block_rows,
    initialize,
    merge_partials,
    run_process_shard,
)
from acoss_jax.parallel.mesh import (  # noqa: F401
    make_pair_mesh,
    sharded_pair_scores,
    sharded_pair_scores_triangular,
)
