"""Bit packing/unpacking along the last axis, MSb-first.

Port of `convolutionalencdec_tpu/ops/bits.py`: within a byte the MSb is
sent/encoded first, and decoded bytes are filled MSb-first.
"""

from __future__ import annotations

import torch


def _shifts(device) -> torch.Tensor:
    return torch.arange(7, -1, -1, dtype=torch.uint8, device=device)


def unpack_bits(data: torch.Tensor) -> torch.Tensor:
    """Unpack uint8 bytes [..., N] into 0/1 bits [..., 8N]."""
    data = torch.as_tensor(data, dtype=torch.uint8)
    bits = (data[..., :, None] >> _shifts(data.device)) & 1
    return bits.reshape(*data.shape[:-1], data.shape[-1] * 8)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """Pack 0/1 bits [..., 8N] (last axis a multiple of 8) into uint8
    bytes [..., N]."""
    bits = torch.as_tensor(bits, dtype=torch.uint8)
    if bits.shape[-1] % 8 != 0:
        raise ValueError(f"bit count {bits.shape[-1]} not a multiple of 8")
    grouped = bits.reshape(*bits.shape[:-1], bits.shape[-1] // 8, 8)
    # Each byte is a sum of distinct powers of two, so the uint8 sum is
    # exact.
    return (grouped << _shifts(bits.device)).sum(
        dim=-1, dtype=torch.uint8)
