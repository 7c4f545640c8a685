"""Host utilities of the port (qwen3_tpu/utils/'s counterparts)."""

from qwen3_tpu_torch.utils.logging import log  # noqa: F401
from qwen3_tpu_torch.utils.profiling import profile_trace  # noqa: F401
