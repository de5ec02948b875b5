"""Mesh-sliced serving instances: tensor parallelism over a
``torch.distributed`` world (counterpart of ``repro/distributed``, its
serving subset)."""
from repro_torch.distributed.context import (  # noqa: F401
    active_axes,
    axis_size,
    current_mesh,
    has_axis,
    init_world,
    mesh_context,
    pick_backend,
)
from repro_torch.distributed.meshslice import MeshSlicer, make_slice_mesh  # noqa: F401
from repro_torch.distributed.sharding import (  # noqa: F401
    ShardingPolicy,
    default_policy,
    param_pspecs,
    place_serving_state,
    serving_cache_pspecs,
    shard_params,
)
