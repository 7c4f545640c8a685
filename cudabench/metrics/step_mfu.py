"""step_mfu: the model FLOPs the measured window's tokens need (the sum
over the model's kernel families, models/<model>.py: for the dense block
two a matmul parameter for each prompt and generated token, the
classifier for each generated token and each admitted prompt's last row,
and attention's products at each token's depth) over the window's seconds
at the card's bf16 peak (metrics/_roofline.py). Taken over the window,
which runs without the profiler, it bounds every kernel's share: work a
later change takes off the path leaves its roofline silent, not this."""

from cudabench.metrics import _roofline as rl


def read(run):
    loop = run.loop
    if loop.b_end is None or loop.t_end <= loop.t0:
        return None
    positions = run.positions(loop.b0, loop.b_end)
    admitted = run.admitted(loop.b0, loop.b_end)
    if not positions and not admitted:
        return None
    flops = sum(f.flops(run.sizes, positions, admitted)
                for f in run.model.FAMILIES.values())
    return 100.0 * flops / ((loop.t_end - loop.t0) * rl.PEAK_FLOPS)
