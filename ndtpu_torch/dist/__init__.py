"""ndtpu_torch.dist (port of ndtpu.dist): meshes of ranks, the slab-sharded
map, sharded registration, the distributed Schur solve and multi-session
SLAM."""

from ndtpu_torch.dist.mesh import (batch_mesh, grid_mesh, multihost_mesh,
                                   space_mesh)
from ndtpu_torch.dist.registration import match_batch_sharded
from ndtpu_torch.dist.gridmap import (SlabMap, SlabStats, build_slab_stats,
                                      build_slab_stats_psharded,
                                      finalize_slab, match_slab)
from ndtpu_torch.dist.schur import (SchurPlan, ShardData, optimize_schur,
                                    plan_partition, schur_delta,
                                    shard_factor_data,
                                    shard_factor_data_local)
from ndtpu_torch.dist.slam_dp import (run_sessions, run_sessions_sharded,
                                      run_sessions_stacked, serving_config,
                                      vmap_cond_hazards)

__all__ = [
    "batch_mesh", "grid_mesh", "multihost_mesh", "space_mesh",
    "match_batch_sharded",
    "SlabMap", "SlabStats", "build_slab_stats", "build_slab_stats_psharded",
    "finalize_slab", "match_slab",
    "SchurPlan", "ShardData", "optimize_schur", "plan_partition",
    "schur_delta", "shard_factor_data", "shard_factor_data_local",
    "run_sessions", "run_sessions_sharded", "run_sessions_stacked",
    "serving_config", "vmap_cond_hazards",
]
