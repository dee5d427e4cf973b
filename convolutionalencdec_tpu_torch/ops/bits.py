"""Bit packing/unpacking along the last axis, and word parity and popcount.

Port of `convolutionalencdec_tpu/ops/bits.py`: within a byte the MSb is
sent/encoded first ("big" order, the default), and decoded bytes are filled
MSb-first.  `pack_bits` and `unpack_bits` take `device=None` after the JAX
parameters, as every entry point does: a tensor keeps its device, any other
input goes to the card unless `device="cpu"`.  The `_np` functions are the
host-side twins, for oracles and tests.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import as_tensor


def _shifts(bit_order: str, device) -> torch.Tensor:
    """Shift of each bit of a byte, in the order the bits are laid out:
    "little" puts the LSb first, any other order the MSb (as JAX does)."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=device)
    return shifts.flip(0) if bit_order == "little" else shifts


def unpack_bits(data, bit_order: str = "big", device=None) -> torch.Tensor:
    """Unpack uint8 bytes [..., N] into 0/1 bits [..., 8N]; "big" order
    emits the MSb of each byte first."""
    data = as_tensor(data, torch.uint8, device)
    bits = (data[..., :, None] >> _shifts(bit_order, data.device)) & 1
    return bits.reshape(*data.shape[:-1], data.shape[-1] * 8)


def pack_bits(bits, bit_order: str = "big", device=None) -> torch.Tensor:
    """Pack 0/1 bits [..., 8N] (last axis a multiple of 8) into uint8
    bytes [..., N]."""
    bits = as_tensor(bits, torch.uint8, device)
    if bits.shape[-1] % 8 != 0:
        raise ValueError(f"bit count {bits.shape[-1]} not a multiple of 8")
    grouped = bits.reshape(*bits.shape[:-1], bits.shape[-1] // 8, 8)
    # Each byte is a sum of distinct powers of two, so the uint8 sum is
    # exact.
    return (grouped << _shifts(bit_order, bits.device)).sum(
        dim=-1, dtype=torch.uint8)


def unpack_bits_np(data: np.ndarray, bit_order: str = "big") -> np.ndarray:
    """Numpy twin of `unpack_bits`."""
    return np.unpackbits(np.asarray(data, dtype=np.uint8), axis=-1,
                         bitorder="big" if bit_order == "big" else "little")


def pack_bits_np(bits: np.ndarray, bit_order: str = "big") -> np.ndarray:
    """Numpy twin of `pack_bits`."""
    return np.packbits(np.asarray(bits, dtype=np.uint8), axis=-1,
                       bitorder="big" if bit_order == "big" else "little")


def int_to_bits(value: int, width: int, newest_first: bool = False
                ) -> np.ndarray:
    """`width` bits of an integer, uint8.  In time order by default:
    element 0 is the oldest bit (bit width - 1 of the integer), the last
    is the newest (bit 0), as a state's delay bits shift in at the LSb."""
    idx = np.arange(width) if newest_first else np.arange(width - 1, -1, -1)
    return ((value >> idx) & 1).astype(np.uint8)


def parity32(x, device=None) -> torch.Tensor:
    """Parity (0/1) of each 32-bit word: the XOR of its bits, folded by
    halves.  Keeps the input's dtype."""
    x = as_tensor(x, device=device)
    for shift in (16, 8, 4, 2, 1):
        x = x ^ (x >> shift)
    return x & 1


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


def popcount32(x, device=None) -> torch.Tensor:
    """Set bits of each 32-bit word, as int32 (the word is read as
    uint32, so a negative int32 counts its sign bit)."""
    x = as_tensor(x, device=device).to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) & 0xFFFFFFFF) >> 24).to(torch.int32)
