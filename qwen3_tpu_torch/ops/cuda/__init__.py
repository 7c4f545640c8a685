"""Hand-written CUDA kernels (sources in qwen3_tpu_torch/csrc/), the build step and the wrappers."""
