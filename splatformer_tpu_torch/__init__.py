"""PyTorch + CUDA port of splatformer_tpu for NVIDIA Hopper (H100).

The JAX package ``splatformer_tpu`` is the reference; this package mirrors its
layout (ops/, models/, training/, data/, configs/, utils/) and replaces each
Pallas kernel with a hand-written CUDA kernel (kernels/ wrappers, csrc/
sources). Entry points: ``python -m splatformer_tpu_torch.train`` and
``python -m splatformer_tpu_torch.bench``. It imports torch and numpy only.

Float32 matmuls and convolutions run in full float32 here, deliberately: by
default cuDNN convolutions on Ampere/Hopper use TF32 (about three decimal
digits), which is the same class of bug as the TPU's default-bf16 matmuls
that once turned SSIM's conv(x^2) - mu^2 variance negative and produced a
per-image SSIM of 7.14. The SSIM window conv and every matmul in the model
need f32.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
