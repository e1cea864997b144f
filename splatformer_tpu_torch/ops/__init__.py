from splatformer_tpu_torch.ops.types import Camera, GaussianScene, RasterizeConfig
from splatformer_tpu_torch.ops.projection import activate_gaussians
from splatformer_tpu_torch.ops.render import (
    render_images,
    render_images_stats,
)
