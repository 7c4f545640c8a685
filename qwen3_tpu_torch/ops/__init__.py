"""Tensor ops: quantization, norms, RoPE, activations, attention."""
