"""Measurement tools of the port (qwen3_tpu/tools/'s counterparts)."""
