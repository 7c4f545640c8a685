"""Perplexity evaluator CLI of the CUDA port.

    python -m qwen3_tpu_torch.eval <model.bin> [--text FILE|-] [--qmode MODE]
        [--kv-dtype DTYPE] [-c CTX] [--device cuda|cpu]

Token-level NLL and perplexity of the model on the given text (stdin by
default), with qwen3_tpu.eval's flags, choices and output, plus --device
(default cuda; cpu runs the kernels' plain versions). QWEN3_TPU_FUSE=1 runs
the matmuls of modes pallas and pallas-fast through the prologue-fused
kernel, as in the JAX package.
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m qwen3_tpu_torch.eval")
    ap.add_argument("checkpoint")
    ap.add_argument("--text", default="-",
                    help="file with evaluation text ('-' = stdin)")
    ap.add_argument("--qmode", default="pallas",
                    choices=["exact", "bf16", "pallas", "pallas-fast"])
    ap.add_argument("--kv-dtype", default="float32",
                    choices=["float32", "bfloat16", "int8"])
    ap.add_argument("-c", "--ctx", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default) or cpu")
    args = ap.parse_args(argv)

    text = (sys.stdin.read() if args.text == "-"
            else open(args.text, encoding="utf-8").read())

    import numpy as np

    from qwen3_tpu_torch.config import fuse_from_env
    from qwen3_tpu_torch.eval.perplexity import sequence_nll
    from qwen3_tpu_torch.io.checkpoint import read_header
    from qwen3_tpu_torch.models.qwen3 import load_params
    from qwen3_tpu_torch.tokenizer import Tokenizer

    cfg = read_header(args.checkpoint)
    if args.ctx:
        cfg = cfg.with_seq_len(args.ctx)
    tok = Tokenizer.from_file(args.checkpoint)
    ids = tok.encode(text)
    if len(ids) < 2:
        print("[eval] need at least 2 tokens", file=sys.stderr)
        return 1
    ids = ids[: cfg.seq_len]
    _, params = load_params(args.checkpoint, mode=args.qmode,
                            max_seq_len=cfg.seq_len, device=args.device)
    nlls = sequence_nll(params, cfg, ids, mode=args.qmode,
                        kv_dtype=args.kv_dtype, fuse=fuse_from_env())
    nll = float(np.mean(nlls))
    ppl = float(np.exp(nlls.mean()))
    print(f"[eval] tokens={len(ids)} nll/token={nll:.4f} ppl={ppl:.4f}",
          file=sys.stderr)
    print(f'{{"tokens": {len(ids)}, "nll": {nll:.6f}, "ppl": {ppl:.6f}}}')
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
