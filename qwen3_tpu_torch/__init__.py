"""qwen3-tpu-torch: the PyTorch/CUDA port of `qwen3_tpu`, for NVIDIA Hopper.

Same module layout and contracts as the JAX package; plain tensor code is
PyTorch, and the TPU's Pallas kernels become hand-written CUDA kernels under
`csrc/`, built with nvcc at first use (`ops/cuda/build.py`). Entry points run
on the CUDA device unless the caller asks for the CPU, where every kernel
wrapper takes its plain PyTorch version.
"""

__version__ = "0.1.0"

from qwen3_tpu_torch.config import ModelConfig  # noqa: F401
