"""The benchmark's own inputs of a model: Q8_0 tensor families made from
the seed on the device, and their way to the host for the hand-over.

A configuration's model module (models/<model>.py) names its families,
their shapes and the order they are filled in; this module fills one
family at a time from one seeded torch.Generator on the card, in one call
a family, so that the same seed gives the same bytes and the reference
makes them again after the program has gone. Their magnitudes are the
port's synthetic ones: int8 in [-127, 127], scales
(scale / 127) * (0.5 + U[0, 1)), norm weights 1 + 0.1 N(0, 1).
"""

from __future__ import annotations

import torch


def generator(seed: int, device) -> torch.Generator:
    """The one generator a run's tensors are filled from."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    return gen


def q8(shape: tuple[int, ...], group: int, scale: float,
       gen: torch.Generator, device) -> tuple[torch.Tensor, torch.Tensor]:
    """One Q8_0 family [..., out, in]: int8 values, then float32 scales
    over groups of `group` along `in`."""
    q = torch.randint(-127, 128, shape, dtype=torch.int8, device=device,
                      generator=gen)
    s = (scale / 127.0) * (0.5 + torch.rand(
        shape[:-1] + (shape[-1] // group,), device=device, generator=gen))
    return q, s


def norm(shape: tuple[int, ...], gen: torch.Generator,
         device) -> torch.Tensor:
    """One family of float32 norm weights."""
    return 1.0 + 0.1 * torch.randn(shape, device=device, generator=gen)


def to_host(w: dict[str, torch.Tensor], device) -> dict:
    """The tensors as host arrays, one array for tensors that are one (a
    tied classifier is the embedding); `w` is emptied, so that its device
    copies are freed before the port's are made."""
    host, seen = {}, {}
    for key in list(w):
        t = w.pop(key)
        if id(t) not in seen:
            seen[id(t)] = t.cpu().numpy()
        host[key] = seen[id(t)]
        del t
    seen.clear()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return host
