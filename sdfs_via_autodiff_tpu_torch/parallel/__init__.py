"""Multi-device grid sharding on ``torch.distributed`` (port of the JAX
package's ``parallel/``): meshes and placements (:mod:`.mesh`), the
sharded operators with hand-placed collectives (:mod:`.shard_ops`) and
the solvers' local form of a single-device operator on a DTensor
iterate (:mod:`.gspmd`)."""

from ..ops.dtensor import is_dtensor
from .gspmd import local_operator
from .mesh import (grid_sharding, make_mesh, mesh_device,
                   replicated_sharding, shard_grid_array)
from .shard_ops import (ShardedOperator, StreamedShardPlan,
                        T_ssy_shard_map_factory, check_shard_layouts,
                        streamed_shard_map_factory, streamed_shard_plan,
                        two_phase_shard_map_factory)

__all__ = ["make_mesh", "grid_sharding", "replicated_sharding",
           "shard_grid_array", "mesh_device", "ShardedOperator",
           "StreamedShardPlan", "T_ssy_shard_map_factory",
           "two_phase_shard_map_factory", "streamed_shard_map_factory",
           "streamed_shard_plan", "check_shard_layouts", "is_dtensor",
           "local_operator"]
