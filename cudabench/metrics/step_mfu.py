"""step_mfu: the model FLOPs the measured window's tokens need (two a
matmul parameter for each prompt and generated token, the classifier for
each generated token and each admitted prompt's last row, and attention's
products at each token's depth) over the window's seconds at the card's
bf16 peak (metrics/_roofline.py). Taken over the window, which runs
without the profiler, it bounds every kernel's share: work a later change
takes off the path leaves its roofline silent, not this."""

from cudabench.metrics import _roofline as rl


def read(run):
    loop = run.loop
    if loop.b_end is None or loop.t_end <= loop.t0:
        return None
    positions = run.positions(loop.b0, loop.b_end)
    admitted = run.admitted(loop.b0, loop.b_end)
    if not positions and not admitted:
        return None
    p_layers, p_cls = rl.matmul_params(run.sizes)
    flops = (2 * p_layers * (len(positions) + sum(admitted))
             + 2 * p_cls * (len(positions) + len(admitted))
             + rl.decode_attention_work(run.sizes, positions)[0]
             + rl.prefill_attention_flops(run.sizes, admitted))
    return 100.0 * flops / ((loop.t_end - loop.t0) * rl.PEAK_FLOPS)
