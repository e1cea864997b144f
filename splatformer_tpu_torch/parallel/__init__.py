"""Parallelism (port of splatformer_tpu/parallel/): process meshes over
torch.distributed, the multi-process utilities, differentiable collectives
and the gauss-axis sharded renderer. The 2-D (data x gauss) train step is
parallel/train2d.py."""
from splatformer_tpu_torch.parallel.distributed import (
    maybe_initialize_distributed, reduce_metric_sums, sync_processes)
from splatformer_tpu_torch.parallel.gauss_shard import (
    GAUSS_AXIS, LocalShards, render_images_gauss_sharded)
from splatformer_tpu_torch.parallel.mesh import (
    DATA_AXIS, make_mesh, replicate_to_mesh, replicated, shard_batch)

__all__ = [
    "DATA_AXIS", "GAUSS_AXIS", "LocalShards", "make_mesh",
    "maybe_initialize_distributed", "reduce_metric_sums", "replicate_to_mesh",
    "replicated", "render_images_gauss_sharded", "shard_batch",
    "sync_processes",
]
