"""Host utilities of the port (qwen3_tpu/utils/'s counterparts)."""
