"""`python -m qwen3_tpu_torch` — the runq-compatible CLI on the CUDA port."""
from qwen3_tpu_torch.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
