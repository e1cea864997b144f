"""The benchmark of splatformer_tpu_torch, the PyTorch + CUDA port: a
harness driven by BENCHMARK.json and the data files beside it
(README.md)."""
