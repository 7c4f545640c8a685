"""CLI entrypoint — `runq`-compatible flags (examples/qwen.c:59-143), the
same flags and defaults as qwen3_tpu/cli.py, running on the CUDA port.

Usage:  python -m qwen3_tpu_torch.cli <checkpoint.bin> [options]
  -t <float>   temperature (default 1.0)
  -p <float>   top-p nucleus sampling (default 0.9)
  -s <int>     RNG seed (default: time)
  -c <int>     context window (0 = checkpoint max, capped at 32768)
  -m <str>     mode: completion|chat (default chat)
  -i <str>     input prompt
  -y <str>     system prompt (chat mode)
  -r <int>     reasoning: 0=off, 1=thinking (default 1)
  --qmode      quantized math path (default pallas: the reference-exact
               Q8_0 x Q8_0 kernel; pallas-fast: bf16 activations x bf16-
               dequantized weights; pallas-int8: the int8 requantized
               kernel; exact: the reference's integer math as plain
               products; bf16: weights dequantized once to bf16)
  --kv-dtype   float32|bfloat16|int8 KV cache dtype (default int8)
  --attn       auto|dense|flash (default auto: dense attention below depth
               8192, the flash kernels from there on)
  --max-tokens cap on generated tokens (completion mode)
  --device     torch device (default cuda; cpu runs the kernels' plain
               versions)
  --profile DIR
               trace the run with torch.profiler into DIR (a Chrome trace)
  --tp, --coordinator/--num-processes/--process-id
               accepted for compatibility; not ported yet (they raise)

QWEN3_TPU_FUSE=1 in the environment runs the matmuls of modes pallas and
pallas-fast through the prologue-fused kernel, as it does in the JAX package
(the other modes ignore it).

Generated text streams to stdout; diagnostics go to stderr with
[Component] prefixes.
"""

from __future__ import annotations

import argparse
import contextlib
import sys
import time

from qwen3_tpu_torch.config import fuse_from_env, native_tokenizer_from_env
from qwen3_tpu_torch.runtime.chat import ChatSession
from qwen3_tpu_torch.runtime.engine import Engine, EngineConfig


def _stdout_bytes(piece: bytes) -> None:
    sys.stdout.buffer.write(piece)
    sys.stdout.flush()


def build_engine(args) -> Engine:
    cfg = EngineConfig(
        path=args.checkpoint,
        think=bool(args.r),
        seed=args.s if args.s else int(time.time()),
        temperature=args.t,
        top_p=args.p,
        seq_len=args.c,
        mode=args.qmode,
        attn=args.attn,
        kv_dtype=args.kv_dtype,
        tp=args.tp,
        device=args.device,
        fuse=fuse_from_env(),
        native_tokenizer=native_tokenizer_from_env(),
    )
    print(f"[Engine] loading {cfg.path} (mode={cfg.mode}, "
          f"device={cfg.device}, fuse={int(cfg.fuse)})", file=sys.stderr)
    eng = Engine(cfg)
    mc = eng.model_cfg
    print(f"[Params] dim={mc.dim} hidden={mc.hidden_dim} layers={mc.n_layers} "
          f"heads={mc.n_heads}/{mc.n_kv_heads} vocab={mc.vocab_size} "
          f"seq_len={mc.seq_len} group_size={mc.group_size} "
          f"tied={int(mc.shared_classifier)}", file=sys.stderr)
    print(f"[Sampler] temperature={eng.sampler.temperature} "
          f"top_p={eng.sampler.top_p} seed={cfg.seed}", file=sys.stderr)
    return eng


def run_completion(eng: Engine, args) -> None:
    if not args.i:
        print("[Completion] Error: missing prompt (-i).", file=sys.stderr)
        raise SystemExit(1)
    res = eng.generate(args.i, stream_cb=_stdout_bytes,
                       max_tokens=args.max_tokens)
    print()
    print(f"\n[pp {res.prompt_ms:.0f}ms] [tg {res.generate_ms:.0f}ms] "
          f"[t/ms {res.ms_per_token:.3f}] "
          f"[tok/s {1000.0 / max(res.ms_per_token, 1e-9):.2f}]",
          file=sys.stderr)


def run_chat(eng: Engine, args) -> None:
    session = ChatSession(eng, system_prompt=args.y)
    while True:
        try:
            user = input("\n> ")
        except EOFError:
            break
        if not user:
            break
        for _ in session.stream(user, stream_cb=_stdout_bytes):
            pass
        print()
        m = session.last_metrics
        if m:
            print(f"\n[pp {m.prompt_ms:.0f}ms] [tg {m.generate_ms:.0f}ms] "
                  f"[t/ms {m.ms_per_token:.3f}]", file=sys.stderr)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="qwen3-tpu-torch", add_help=True)
    ap.add_argument("checkpoint")
    ap.add_argument("-t", type=float, default=1.0)
    ap.add_argument("-p", type=float, default=0.9)
    ap.add_argument("-s", type=int, default=0)
    ap.add_argument("-c", type=int, default=0)
    ap.add_argument("-m", default="chat", choices=["completion", "chat"])
    ap.add_argument("-i", default=None)
    ap.add_argument("-y", default=None)
    ap.add_argument("-r", type=int, default=1)
    ap.add_argument("--qmode", default="pallas",
                    choices=["exact", "bf16", "pallas", "pallas-fast",
                             "pallas-int8"])
    ap.add_argument("--attn", default="auto",
                    choices=["auto", "dense", "flash"])
    ap.add_argument("--kv-dtype", default="int8",
                    choices=["float32", "bfloat16", "int8"])
    ap.add_argument("--max-tokens", type=int, default=None)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--profile", default=None, metavar="DIR")
    ap.add_argument("--coordinator", default=None, metavar="ADDR:PORT")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default) or cpu")
    args = ap.parse_args(argv)

    if (args.coordinator is not None or args.num_processes is not None
            or args.process_id is not None):
        raise NotImplementedError("multi-host (--coordinator) is not ported "
                                  "yet")

    eng = build_engine(args)
    ctx = contextlib.nullcontext()
    if args.profile:
        from qwen3_tpu_torch.utils.profiling import profile_trace

        print(f"[Profile] tracing to {args.profile}", file=sys.stderr)
        ctx = profile_trace(args.profile, device=args.device)
    with ctx:
        if args.m == "completion":
            run_completion(eng, args)
        else:
            run_chat(eng, args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
