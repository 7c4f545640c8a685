"""tok_s: every output token that reached the clients in the window, over
the window's seconds. The window holds whole decode chunks (core/loop.py),
so the tokens are those of its bursts after the first and the seconds run
from the first burst to the closing one."""


def read(run):
    loop = run.loop
    if loop.b_end is None:
        return None
    return run.tokens(loop.b0, loop.b_end) / (loop.t_end - loop.t0)
