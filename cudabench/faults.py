"""Faults planted under the timed path, each of which must make `correct`
false: the tests plant them at the tiny stand-in's size, and
cudabench/control.py (`--faults`) at a cell's own.

Each fault takes a `setattr(obj, name, value)` (pytest's
monkeypatch.setattr, or `planted`'s, which undoes it) and wraps one
function of the port that the serving loop calls. One card has no
exchange between chips to leave out.
"""

from __future__ import annotations

import contextlib


def state_unchanged(setattr_) -> None:
    """A decode chunk that returns the cache as it found it."""
    import qwen3_tpu_torch.runtime.batched as batched
    orig = batched.batched_decode_chunk

    def chunk(params, cfg, k, v, *a, **kw):
        def flat(c):
            return list(c) if isinstance(c, tuple) else [c]
        keep = [t.clone() for side in (k, v) for t in flat(side)]
        out = orig(params, cfg, k, v, *a, **kw)
        for t, old in zip(flat(out[1]) + flat(out[2]), keep):
            t.copy_(old)
        return out
    setattr_(batched, "batched_decode_chunk", chunk)


def half_batch(setattr_) -> None:
    """A decode step that leaves half of its rows out, their logits the
    other half's: the second half on even steps, the first on odd ones,
    so that every slot's stream meets the fault."""
    import qwen3_tpu_torch.runtime.decode_loop as dl
    orig = dl.decode_forward
    calls = [0]

    def step(*a, **kw):
        logits, k, v = orig(*a, **kw)
        b, h = logits.shape[0], logits.shape[0] // 2
        logits = logits.clone()
        if calls[0] % 2:
            logits[:h] = logits[b - h:]
        else:
            logits[b - h:] = logits[:h]
        calls[0] += 1
        return logits, k, v
    setattr_(dl, "decode_forward", step)


def token_altered(setattr_) -> None:
    """Every token a decode step samples altered where it is produced."""
    import qwen3_tpu_torch.runtime.decode_loop as dl
    orig = dl.sample_tokens

    def sample(logits, *a, **kw):
        return (orig(logits, *a, **kw) + 1) % logits.shape[-1]
    setattr_(dl, "sample_tokens", sample)


def temperature_off(setattr_) -> None:
    """The decode steps sample at 1.1 times the request's temperature (a
    greedy row stays greedy: its mask is made before)."""
    import qwen3_tpu_torch.runtime.decode_loop as dl
    orig = dl.sample_tokens

    def sample(logits, coin, temperature, *a, **kw):
        return orig(logits, coin, temperature * 1.1, *a, **kw)
    setattr_(dl, "sample_tokens", sample)


FAULTS = {"state": state_unchanged, "half": half_batch,
          "token": token_altered, "temperature": temperature_off}


@contextlib.contextmanager
def planted(name: str):
    """FAULTS[name] planted for the body of a `with`, then undone."""
    undo = []

    def setattr_(obj, attr, value):
        undo.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, value)
    try:
        FAULTS[name](setattr_)
        yield
    finally:
        for obj, attr, old in reversed(undo):
            setattr(obj, attr, old)
