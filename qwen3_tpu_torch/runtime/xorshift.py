"""xorshift64* RNG, bit-identical to the reference (src/xorshift.c:7-16):

    state ^= state >> 12; state ^= state << 25; state ^= state >> 27
    u32 = (state * 0x2545F4914F6CDD1D) >> 32        (high 32 bits of u64 product)
    float = (u32 >> 8) / 2^24                        (top 24 bits -> [0, 1))

The port draws every coin on the host: the stream does not depend on device
data, so the decode loop hands each step's coins to the device sampler as a
small tensor and advances a slot's state only on steps that slot is live.
(The JAX package keeps the state on the device as uint32 halves because its
whole decode loop runs there.)
"""

from __future__ import annotations

import numpy as np

_M64 = (1 << 64) - 1
_MULT = 0x2545F4914F6CDD1D


def xorshift_step(state: int) -> tuple[int, int]:
    """Advance the state; return (new_state, uint32 output)."""
    state &= _M64
    state ^= state >> 12
    state ^= (state << 25) & _M64
    state ^= state >> 27
    out = ((state * _MULT) & _M64) >> 32
    return state, out


def xorshift_float(state: int) -> tuple[int, float]:
    """Advance the state; return (new_state, float32 coin in [0, 1))."""
    state, u32 = xorshift_step(state)
    coin = np.float32(u32 >> 8) / np.float32(16777216.0)
    return state, float(coin)


class XorshiftRng:
    """Stateful wrapper mirroring the C engine's `Sampler.seed` usage."""

    def __init__(self, seed: int):
        self.state = seed & _M64

    def next_u32(self) -> int:
        self.state, out = xorshift_step(self.state)
        return out

    def next_float(self) -> float:
        self.state, coin = xorshift_float(self.state)
        return coin
