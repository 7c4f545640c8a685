"""setup_s: from the process's start to the window's: imports and CUDA,
the kernels' library, the weights from the seed, the engine, the first
wave prefilled and one decode chunk."""


def read(run):
    return run.setup_s
