"""Batched CRC over GF(2): the outer code of the tail-biting receive chain.

Port of `convolutionalencdec_tpu/ops/crc.py`.  A non-reflected MSb-first CRC
is linear over GF(2) in the message bits, so a batch of CRCs is one matrix
product:

    remainder(m) = (m @ M) mod 2 ^ c,   M[i] = x^(L-1-i+W) mod p(x)

with c folding in the `init` register and `xor_out`.  The matrix is built in
numpy (the same code as the JAX package's, copied: the port imports nothing
of it) and kept per (crc, L, device); the product is `torch.matmul` in
float32, which is exact: the inputs are 0 and 1 and every sum is at most
L < 2^24.  The serial LFSR survives only as the numpy oracle
`crc_remainder_np`.

Bit order is the transport order: `bits[..., 0]` is sent first, and the
parity bits come out MSb-first (out[..., 0] is the coefficient of x^(W-1)),
as 3GPP attaches them.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from .._device import as_tensor


@dataclass(frozen=True)
class CrcSpec:
    """A cyclic redundancy check: x^width + (poly bits), MSb-first.

    Attributes:
      width: parity length W in bits, 1..32.
      poly: generator polynomial without the leading x^W term (CCITT CRC-16
        is 0x1021).
      init: initial LFSR register value (the 3GPP CRCs use 0).
      xor_out: final XOR applied to the remainder.
    """
    width: int
    poly: int
    init: int = 0
    xor_out: int = 0

    def __post_init__(self):
        if not 1 <= self.width <= 32:
            raise ValueError(f"CRC width {self.width} out of range [1, 32]")
        mask = (1 << self.width) - 1
        for name in ("poly", "init", "xor_out"):
            v = getattr(self, name)
            if v & ~mask:
                raise ValueError(f"{name}=0x{v:x} exceeds width {self.width}")


# 3GPP polynomials (TS 36.212 / 38.212 5.1) and the CCITT classic.
CRC24A = CrcSpec(24, 0x864CFB)        # LTE/NR transport-block CRC
CRC24B = CrcSpec(24, 0x800063)        # LTE/NR code-block CRC
CRC16_CCITT = CrcSpec(16, 0x1021)     # LTE gCRC16 (PDCCH payload, DL-SCH)
CRC11_NR = CrcSpec(11, 0x621)         # NR uplink control
CRC8_LTE = CrcSpec(8, 0x9B)           # LTE gCRC8 (CQI)
CRC6_NR = CrcSpec(6, 0x21)            # NR short UCI (x^6 + x^5 + 1)


def crc_remainder_np(crc: CrcSpec, bits) -> int:
    """Serial LFSR oracle: the remainder register after shifting `bits` (1-D,
    transmit order first) through the MSb-first CRC LFSR, then `xor_out`."""
    W = crc.width
    mask = (1 << W) - 1
    reg = crc.init
    for b in np.asarray(bits, np.uint8).reshape(-1):
        fb = ((reg >> (W - 1)) & 1) ^ int(b)
        reg = (reg << 1) & mask
        if fb:
            reg ^= crc.poly
    return reg ^ crc.xor_out


def _int_to_bits(v: int, width: int) -> np.ndarray:
    return np.array([(v >> (width - 1 - j)) & 1 for j in range(width)],
                    np.uint8)


@functools.lru_cache(maxsize=64)
def _crc_matrix(crc: CrcSpec, L: int) -> tuple[np.ndarray, np.ndarray]:
    """(M int8 [L, W], c uint8 [W]): remainder(m) = (m @ M) & 1 ^ c.

    M[i] = x^(L-1-i+W) mod p(x), built back to front with one multiply-by-x
    reduction per row; c is the remainder of the all-zero length-L message
    under `init` (init x^L mod p), then `xor_out`."""
    W = crc.width
    mask = (1 << W) - 1
    M = np.empty((L, W), np.int8)
    r = crc.poly                       # x^W mod p
    for i in range(L - 1, -1, -1):
        M[i] = _int_to_bits(r, W)
        r <<= 1                        # multiply by x, reduce mod p
        if r >> W:
            r = (r & mask) ^ crc.poly
    zero_rem = 0
    if crc.init:
        zero_rem = crc.init
        for _ in range(L):
            fb = (zero_rem >> (W - 1)) & 1
            zero_rem = (zero_rem << 1) & mask
            if fb:
                zero_rem ^= crc.poly
    return M, _int_to_bits(zero_rem ^ crc.xor_out, W)


@functools.lru_cache(maxsize=64)
def _crc_tensors(crc: CrcSpec, L: int, device: torch.device):
    """(M float32 [L, W], c int32 [W]) resident on `device`."""
    M, c = _crc_matrix(crc, L)
    return (torch.as_tensor(M, dtype=torch.float32, device=device),
            torch.as_tensor(c, dtype=torch.int32, device=device))


def crc_bits(crc: CrcSpec, bits, device=None) -> torch.Tensor:
    """Batched CRC parity: 0/1 bits [..., L] -> uint8 [..., W] parity bits
    in transmit (MSb-first) order; one matrix product for the batch.
    `device` as everywhere in the port: a tensor keeps its own."""
    bits = as_tensor(bits, device=device)
    L = bits.shape[-1]
    if L >= 1 << 24:
        raise ValueError(f"L = {L} bits: float32 sums are exact below 2^24")
    M, c = _crc_tensors(crc, L, bits.device)
    acc = torch.matmul(bits.to(torch.float32), M).to(torch.int32)
    return ((acc & 1) ^ c).to(torch.uint8)


def crc_append(crc: CrcSpec, bits, device=None) -> torch.Tensor:
    """[..., L] message bits -> uint8 [..., L + W] CRC-attached block (parity
    appended MSb-first, the 3GPP attachment)."""
    bits = as_tensor(bits, torch.uint8, device)
    return torch.cat([bits, crc_bits(crc, bits)], dim=-1)


def crc_check(crc: CrcSpec, block, device=None) -> torch.Tensor:
    """[..., L + W] CRC-attached block -> bool [...]: is the parity
    consistent?"""
    block = as_tensor(block, torch.uint8, device)
    msg, parity = block[..., :-crc.width], block[..., -crc.width:]
    return torch.all(parity == crc_bits(crc, msg), dim=-1)
