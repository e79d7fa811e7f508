"""Map / mesh / point-cloud outputs (port of `bundleadjustment_tpu.vis`)."""

from bundleadjustment_tpu_torch.vis.mesh import (
    camera_frustum_glyph,
    create_map_mesh,
    write_off,
    write_ply,
)
from bundleadjustment_tpu_torch.vis.pointcloud import (
    backproject_depth,
    depth_normals,
)

__all__ = [
    "camera_frustum_glyph",
    "create_map_mesh",
    "write_off",
    "write_ply",
    "backproject_depth",
    "depth_normals",
]
