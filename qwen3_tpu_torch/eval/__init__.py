from qwen3_tpu_torch.eval.perplexity import perplexity, sequence_nll  # noqa: F401
