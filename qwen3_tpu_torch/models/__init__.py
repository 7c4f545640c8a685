"""Qwen3 model: parameters and forward passes."""
