"""Channel models and modulation.

Port of `convolutionalencdec_tpu/ops/channel.py`: the binary symmetric
channel on bit streams and on packed segments, and BPSK over AWGN with
soft outputs (LLRs).  Randomness comes from an explicit `torch.Generator`;
its numbers differ from `jax.random`'s, so the channels are held to the
JAX package statistically, never bit for bit.

Conventions: generator j's coded bit sits at position j within a segment
(and is sent j-th), and a positive LLR favours bit 0.

Every function takes `device=None`: a tensor input keeps its device, any
other input goes to `device` (default: the CUDA card).
"""

from __future__ import annotations

import math

import torch

from .._device import as_tensor


def bsc(segment_bits, p: float, generator: torch.Generator | None = None,
        device=None) -> torch.Tensor:
    """Binary symmetric channel on 0/1 bits: flip each bit IID with
    probability p.  `generator` must live on the bits' device."""
    segment_bits = as_tensor(segment_bits, device=device)
    flips = torch.rand(segment_bits.shape, generator=generator,
                       device=segment_bits.device) < p
    return segment_bits ^ flips.to(segment_bits.dtype)


def bsc_segments(segments, n: int, p: float,
                 generator: torch.Generator | None = None,
                 device=None) -> torch.Tensor:
    """Flip each of the n coded bits of every uint8 segment IID with
    probability p.  Returns uint8 segments of the same shape, on the same
    device; `generator` must live on that device."""
    segments = as_tensor(segments, torch.uint8, device)
    flips = torch.rand(segments.shape + (n,), generator=generator,
                       device=segments.device) < p
    weights = 1 << torch.arange(n, dtype=torch.uint8, device=segments.device)
    # Distinct powers of two below 2^n <= 128: the uint8 sum is exact.
    mask = (flips.to(torch.uint8) * weights).sum(dim=-1, dtype=torch.uint8)
    return segments ^ mask


def uncoded_ber_bpsk(snr_db: float, oversample: int = 4) -> float:
    """Uncoded BPSK bit error rate Q(sqrt(2 Eb/N0)) at an SNR with
    oversampling (Eb/N0 = SNR + 10 log10(oversample))."""
    ebn0_db = snr_db + 10.0 * math.log10(oversample)
    ebn0 = 10.0 ** (ebn0_db / 10.0)
    return 0.5 * math.erfc(math.sqrt(ebn0))


def bpsk_modulate(bits, device=None) -> torch.Tensor:
    """Map bit b -> float32 symbol 1 - 2b: 0 -> +1, 1 -> -1."""
    return 1.0 - 2.0 * as_tensor(bits, torch.float32, device)


def awgn(symbols, ebn0_db: float, rate: float, bits_per_symbol: int = 1,
         generator: torch.Generator | None = None,
         device=None) -> torch.Tensor:
    """Add white Gaussian noise at the given Eb/N0 for a code of the given
    rate: Es/N0 = Eb/N0 * rate * bits_per_symbol, noise variance N0/2 per
    real dimension with Es = 1.  `generator` must live on the symbols'
    device."""
    symbols = as_tensor(symbols, torch.float32, device)
    esn0 = 10.0 ** (ebn0_db / 10.0) * rate * bits_per_symbol
    sigma = math.sqrt(1.0 / (2.0 * esn0))
    noise = torch.randn(symbols.shape, generator=generator,
                        device=symbols.device)
    return symbols + noise * sigma


def bpsk_llr(received, ebn0_db: float, rate: float,
             device=None) -> torch.Tensor:
    """Exact channel LLRs for BPSK over AWGN: L = 4 Es/N0 y (positive
    favours bit 0).  Input float [..., n_coded_bits]."""
    esn0 = 10.0 ** (ebn0_db / 10.0) * rate
    return 4.0 * esn0 * as_tensor(received, torch.float32, device)


def hard_decision(llr, device=None) -> torch.Tensor:
    """LLR -> uint8 hard bit (a negative LLR means bit 1)."""
    return (as_tensor(llr, device=device) < 0).to(torch.uint8)


def segments_to_bits(segments, n: int, device=None) -> torch.Tensor:
    """Unpack n-bit segments [..., T] into the coded bit stream
    [..., T * n], generator 0's bit first within each segment."""
    segments = as_tensor(segments, torch.uint8, device)
    j = torch.arange(n, dtype=torch.uint8, device=segments.device)
    bits = (segments[..., None] >> j) & 1
    return bits.reshape(*segments.shape[:-1], segments.shape[-1] * n)


def bits_to_segments(bits, n: int, device=None) -> torch.Tensor:
    """Pack a coded bit stream [..., T * n] back into n-bit segments
    [..., T] (the inverse of `segments_to_bits`)."""
    bits = as_tensor(bits, torch.uint8, device)
    grouped = bits.reshape(*bits.shape[:-1], bits.shape[-1] // n, n)
    j = torch.arange(n, dtype=torch.uint8, device=bits.device)
    # Distinct powers of two below 2^n <= 128: the uint8 sum is exact.
    return (grouped << j).sum(dim=-1, dtype=torch.uint8)
