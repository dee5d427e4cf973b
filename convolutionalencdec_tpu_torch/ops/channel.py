"""Channel models.

Port of `convolutionalencdec_tpu/ops/channel.py`, so far only the binary
symmetric channel on packed segments.  Randomness comes from an explicit
`torch.Generator`; its numbers differ from `jax.random`'s, so the channel
is held to the JAX package statistically, never bit for bit.
"""

from __future__ import annotations

import torch


def bsc_segments(segments: torch.Tensor, n: int, p: float,
                 generator: torch.Generator | None = None) -> torch.Tensor:
    """Flip each of the n coded bits of every uint8 segment IID with
    probability p.  Returns uint8 segments of the same shape, on the same
    device; `generator` must live on that device."""
    segments = torch.as_tensor(segments, dtype=torch.uint8)
    flips = torch.rand(segments.shape + (n,), generator=generator,
                       device=segments.device) < p
    weights = 1 << torch.arange(n, dtype=torch.uint8, device=segments.device)
    # Distinct powers of two below 2^n <= 128: the uint8 sum is exact.
    mask = (flips.to(torch.uint8) * weights).sum(dim=-1, dtype=torch.uint8)
    return segments ^ mask
