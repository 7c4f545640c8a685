"""kernels_per_step: kernels launched in the traced sub-window over its
decode steps (models/qwen3.py's CALLS): the host's launches a step, which
a captured graph or a fused step would cut. Prefill blocks' kernels at the
chunk boundaries count too."""


def read(run):
    tr = run.trace
    if tr is None or tr.steps <= 0 or tr.kernels() == 0:
        return None
    return tr.kernels() / tr.steps
