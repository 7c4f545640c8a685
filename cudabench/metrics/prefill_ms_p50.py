"""prefill_ms_p50: the median of the engine's own span of admission
(Request.prompt_ms: the prompt encoded and prefilled, its first token
sampled) over the requests submitted in the window and admitted."""

import statistics


def read(run):
    spans = [r.req.prompt_ms for r in run.window_records() if r.deliveries]
    return statistics.median(spans) if spans else None
