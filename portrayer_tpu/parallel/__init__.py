from .sharding import (
    make_mesh, trace_sharded, train_step, split_params, DIFF_FIELDS, RAY_AXIS,
    render_tiles_sharded, frame_rays,
)
from .distributed import (
    initialize, global_mesh, make_global_rays, fetch_replicated,
    render_frame_distributed,
)
