"""The one traffic generator: a mix's parameters and a seed give the
sequence of requests its clients send.

Sizes are stratified: every `block` consecutive requests (in the order the
clients submit them) take the `block` midpoint quantiles of each length
distribution, in an order drawn from the seed. So every seed sends the same
set of sizes, in another order, and the work a window holds does not swing
with the seed. The first `clients` requests are the first wave; each
first-wave cap is a stratified share of a full cap (among the greedy
requests and among the others), so that completions and admissions run
from the window's start, near the closed loop's steady state. The prompt
bytes and each request's sampler seed are drawn from the seed.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass
class Spec:
    """One request as the client sends it."""
    index: int
    prompt: bytes
    max_tokens: int
    temperature: float
    top_p: float
    seed: int
    greedy: bool


def quantiles(dist: dict, n: int) -> np.ndarray:
    """The n midpoint quantiles of a length distribution, as whole
    numbers: {"dist": "uniform" | "loguniform", "low": a, "high": b}."""
    u = (np.arange(n) + 0.5) / n
    lo, hi = float(dist["low"]), float(dist["high"])
    if dist["dist"] == "uniform":
        v = lo + u * (hi - lo)
    elif dist["dist"] == "loguniform":
        v = np.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))
    else:
        raise ValueError(f"unknown distribution {dist['dist']!r}")
    return np.rint(v).astype(np.int64)


def alphabet(spec: dict) -> np.ndarray:
    """The bytes prompts are drawn from: [low, high] without `except`."""
    skip = {ord(c) for c in spec.get("except", "")}
    return np.array([b for b in range(spec["low"], spec["high"] + 1)
                     if b not in skip], dtype=np.uint8)


class RequestStream:
    """The mix's requests in submit order, made a block at a time."""

    def __init__(self, mix: dict, seed: int):
        self.mix = mix
        self.rng = np.random.default_rng([seed, 0x7a11])
        self.block = int(mix["block"])
        self.clients = int(mix["clients"])
        self._bytes = alphabet(mix["prompt_bytes"])
        self._prompt_q = quantiles(mix["prompt_tokens"], self.block)
        self._cap_q = quantiles(mix["output_tokens"], self.block)
        n_greedy = round(float(mix["greedy_share"]) * self.block)
        self._greedy = np.arange(self.block) < n_greedy
        self._made: list[Spec] = []

    def _extend(self) -> None:
        rng, n = self.rng, self.block
        base = len(self._made)
        prompts = rng.permutation(self._prompt_q)
        caps = rng.permutation(self._cap_q)
        greedy = rng.permutation(self._greedy)
        if base < self.clients:
            # greedy and sampled requests each take the whole spread of
            # shares, so that some greedy ones finish early in every run
            share = np.empty(n)
            for part in (greedy, ~greedy):
                k = int(part.sum())
                share[part] = rng.permutation((np.arange(k) + 0.5) / k)
            caps = np.maximum(1, np.rint(caps * share)).astype(np.int64)
        for i in range(n):
            raw = rng.choice(self._bytes, size=int(prompts[i]))
            self._made.append(Spec(
                index=base + i, prompt=raw.tobytes(),
                max_tokens=int(caps[i]),
                temperature=0.0 if greedy[i] else float(
                    self.mix["temperature"]),
                top_p=float(self.mix["top_p"]),
                seed=int(rng.integers(0, 2**63, dtype=np.int64)),
                greedy=bool(greedy[i])))

    def __getitem__(self, i: int) -> Spec:
        while i >= len(self._made):
            self._extend()
        return self._made[i]
