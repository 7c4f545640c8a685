"""xorshift64* RNG, bit-identical to the reference (src/xorshift.c:7-16):

    state ^= state >> 12; state ^= state << 25; state ^= state >> 27
    u32 = (state * 0x2545F4914F6CDD1D) >> 32        (high 32 bits of u64 product)
    float = (u32 >> 8) / 2^24                        (top 24 bits -> [0, 1))

Two forms of the state, converted exactly into each other:
- a host int: the serving loop (decode_loop.py::batched_decode_chunk) draws
  its coins on the host, since the stream does not depend on device data,
  and hands each step's coins to the device sampler as a small tensor;
- a (hi, lo) pair of tensors on the device: the B = 1 chunk
  (decode_loop.py::decode_chunk) keeps its whole loop on the device, as the
  JAX package's does with uint32 halves.

The device form keeps each 32-bit half in an int64 tensor (CUDA's uint32
shifts and products are partial in PyTorch) and masks every shift and
product with 0xFFFFFFFF. Two traps: `>>` on int64 is arithmetic, harmless
here because a half is never negative; and a 32 x 32 product exceeds 2^63,
so products go through 16-bit limbs, each partial product below 2^49.
"""

from __future__ import annotations

import numpy as np
import torch

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


# -- device implementation ---------------------------------------------------

_M32 = 0xFFFFFFFF
_MULT_HI = (_MULT >> 32) & _M32
_MULT_LO = _MULT & _M32


def _mul_lo32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for a half a < 2^32 and a constant c < 2^32: only
    the low 16 bits of a * (c >> 16) reach the low word, so no partial
    product passes 2^49."""
    return (a * (c & 0xFFFF) + (((a * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _mulhi32(a: torch.Tensor, c: int) -> torch.Tensor:
    """The high 32 bits of a * c (a < 2^32, c < 2^32 constant):
    floor((a * c_hi + floor(a * c_lo / 2^16)) / 2^16), partial products
    below 2^49."""
    return (a * (c >> 16) + ((a * (c & 0xFFFF)) >> 16)) >> 16


def xorshift_step_device(hi: torch.Tensor, lo: torch.Tensor):
    """One xorshift64* step on (hi, lo) int64 tensors of 32-bit halves (any
    shape). Returns (new_hi, new_lo, u32 output as int64), bit-identical to
    xorshift_step."""
    # s ^= s >> 12
    hi, lo = hi ^ (hi >> 12), lo ^ ((lo >> 12) | ((hi << 20) & _M32))
    # s ^= s << 25
    hi, lo = hi ^ (((hi << 25) & _M32) | (lo >> 7)), lo ^ ((lo << 25) & _M32)
    # s ^= s >> 27
    hi, lo = hi ^ (hi >> 27), lo ^ ((lo >> 27) | ((hi << 5) & _M32))
    # bits 32..63 of s * MULT: mulhi(lo, ml) + lo * mh + hi * ml (mod 2^32)
    out = (_mulhi32(lo, _MULT_LO) + _mul_lo32(lo, _MULT_HI)
           + _mul_lo32(hi, _MULT_LO)) & _M32
    return hi, lo, out


def xorshift_coin_device(hi: torch.Tensor, lo: torch.Tensor):
    """One step; returns (hi, lo, f32 coin in [0, 1)) matching
    xorshift_float: (out >> 8) / 2^24, both exact in f32."""
    hi, lo, out = xorshift_step_device(hi, lo)
    return hi, lo, (out >> 8).to(torch.float32) / 16777216.0


def to_device_state(state: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """A host state as (hi, lo) 0-dim int64 tensors on `device`, made by
    fills (no host-to-device copy)."""
    state &= _M64
    return (torch.full((), state >> 32, dtype=torch.int64, device=device),
            torch.full((), state & _M32, dtype=torch.int64, device=device))


# a 64-bit seed as (hi, lo) on a device, under the JAX package's name
seed_to_device = to_device_state


def from_device_state(hi: torch.Tensor, lo: torch.Tensor) -> int:
    """The host int of a (hi, lo) device state (a read from the device)."""
    return (int(hi) << 32) | int(lo)


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
