"""ttft_p95_ms: the 95th percentile, over every request submitted in the
window, of the time from its submit to its first token reaching the
client. A request that finished without a token, or had none when the run
stopped, is missing and counts as infinitely late."""

import math

from cudabench.core.stats import percentile


def read(run):
    if run.loop.b_end is None:
        return None
    late = [r.deliveries[0][0] - r.submit_t if r.deliveries else math.inf
            for r in run.window_records()]
    p = percentile(late, 0.95)
    return None if p is None or math.isinf(p) else p * 1e3
