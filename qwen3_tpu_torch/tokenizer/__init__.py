from qwen3_tpu_torch.tokenizer.bpe import Tokenizer  # noqa: F401
