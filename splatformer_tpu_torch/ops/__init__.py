from splatformer_tpu_torch.ops.types import Camera, GaussianScene, RasterizeConfig
from splatformer_tpu_torch.ops.render import (
    activate_gaussians,
    render_images,
    render_images_stats,
)
