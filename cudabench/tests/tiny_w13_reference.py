"""The reference of the test-only stacked model (tests/tiny_w13_model.py):
reference/qwen3.py over the dense block's w1 and w3, which it reads as the
two halves of the stacked family `w13`."""

from __future__ import annotations

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "tiny_w13_reference_base", Path(__file__).with_name("qwen3.py"))
base = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(base)
coins, pick_rows, fp8_rows = base.coins, base.pick_rows, base.fp8_rows


def _dense(w: dict, s: dict) -> dict:
    H, out = s["hidden_dim"], dict(w)
    for part in ("_q", "_s"):
        w13 = out.pop("w13" + part)
        out["w1" + part], out["w3" + part] = w13[:, :H], w13[:, H:]
    return out


def gaps(w, s, *args, **kwargs):
    return base.gaps(_dense(w, s), s, *args, **kwargs)


def picks(w, s, *args, **kwargs):
    return base.picks(_dense(w, s), s, *args, **kwargs)
