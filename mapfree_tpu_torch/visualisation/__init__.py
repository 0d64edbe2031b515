from mapfree_tpu_torch.visualisation.lazy_camera import LazyCamera
from mapfree_tpu_torch.visualisation.raster import Rasterizer, frustum_mesh
from mapfree_tpu_torch.visualisation.render_scene import (
    error_color,
    frustum_points,
    render_frames,
    render_scene,
)
