"""Bit packing/unpacking along the last axis, MSb-first, and word parity.

Port of `convolutionalencdec_tpu/ops/bits.py`: within a byte the MSb is
sent/encoded first, and decoded bytes are filled MSb-first.  `pack_bits`
and `unpack_bits` take `device=None` as every entry point does: a tensor
keeps its device, any other input goes to the card unless `device="cpu"`.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import as_tensor


def _shifts(device) -> torch.Tensor:
    return torch.arange(7, -1, -1, dtype=torch.uint8, device=device)


def unpack_bits(data, device=None) -> torch.Tensor:
    """Unpack uint8 bytes [..., N] into 0/1 bits [..., 8N]."""
    data = as_tensor(data, torch.uint8, device)
    bits = (data[..., :, None] >> _shifts(data.device)) & 1
    return bits.reshape(*data.shape[:-1], data.shape[-1] * 8)


def pack_bits(bits, device=None) -> torch.Tensor:
    """Pack 0/1 bits [..., 8N] (last axis a multiple of 8) into uint8
    bytes [..., N]."""
    bits = as_tensor(bits, torch.uint8, device)
    if bits.shape[-1] % 8 != 0:
        raise ValueError(f"bit count {bits.shape[-1]} not a multiple of 8")
    grouped = bits.reshape(*bits.shape[:-1], bits.shape[-1] // 8, 8)
    # Each byte is a sum of distinct powers of two, so the uint8 sum is
    # exact.
    return (grouped << _shifts(bits.device)).sum(
        dim=-1, dtype=torch.uint8)


def parity32_np(x: np.ndarray) -> np.ndarray:
    """Parity (0/1) of each 32-bit word of a numpy array: the XOR of its
    bits, folded by halves."""
    x = np.asarray(x)
    x = x ^ (x >> 16)
    x = x ^ (x >> 8)
    x = x ^ (x >> 4)
    x = x ^ (x >> 2)
    x = x ^ (x >> 1)
    return x & 1
