"""3GPP LTE rate matching for tail-biting convolutionally coded channels.

Port of `convolutionalencdec_tpu/ops/ratematch.py` (36.212 5.1.4.2): each
of the n coded streams passes through a 32-column sub-block interleaver
with NULL front padding, the interleaved streams are concatenated into a
circular buffer, and E bits are read from it, puncturing when E < n D and
repeating when E > n D.  The receiver adds the LLRs of repeated copies and
leaves never-sent bits at zero (an erasure).

For a fixed (n, D, E) the whole procedure is a static index map, computed
in numpy (copied from the JAX package, which the port does not import) and
kept per device: rate matching is one gather and de-rate-matching one
`index_add_`.  On integer LLRs the accumulator is int32, whose atomic adds
on the card give the same sum in any order.

Coded bits and LLRs are step-major (trellis step t, generator j at position
t n + j), the order of `ops.channel.segments_to_bits`; generator j is the
standard's stream d^(j).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .._device import as_tensor
from ..params import CodeSpec

#: 36.212 Table 5.1.4-2: inter-column permutation of the convolutional-code
#: sub-block interleaver (C = 32 columns).
SUBBLOCK_PERM = (
    1, 17, 9, 25, 5, 21, 13, 29, 3, 19, 11, 27, 7, 23, 15, 31,
    0, 16, 8, 24, 4, 20, 12, 28, 2, 18, 10, 26, 6, 22, 14, 30,
)

NCOLS = 32


@functools.lru_cache(maxsize=None)
def subblock_interleave_map(D: int) -> np.ndarray:
    """Sub-block interleaver of one length-D stream, as an index map.

    Prepend ND = R 32 - D NULLs, write the padded stream row by row into an
    R x 32 matrix, permute the columns by `SUBBLOCK_PERM`, read column by
    column.  Returns int32 [R 32]: the source index (0..D-1) of each
    interleaved position, or -1 for a NULL."""
    if D <= 0:
        raise ValueError("stream length D must be positive")
    R = -(-D // NCOLS)
    ND = R * NCOLS - D
    r = np.arange(R)
    out = np.empty(R * NCOLS, dtype=np.int32)
    for j, c in enumerate(SUBBLOCK_PERM):
        out[j * R:(j + 1) * R] = r * NCOLS + c - ND
    out[out < 0] = -1
    return out


@functools.lru_cache(maxsize=None)
def circular_buffer_map(n: int, D: int) -> np.ndarray:
    """The circular buffer with its NULLs removed, as step-major codeword
    positions: int32 [n D], entry m the position (t n + j) sent m-th in one
    cycle of the buffer."""
    v = subblock_interleave_map(D)
    streams = []
    for j in range(n):
        s = v.copy()
        live = s >= 0
        s[live] = s[live] * n + j
        streams.append(s)
    w = np.concatenate(streams)
    return w[w >= 0].astype(np.int32)


@functools.lru_cache(maxsize=None)
def ratematch_indices(n: int, D: int, E: int) -> np.ndarray:
    """Source index (step-major, 0..n D - 1) of each of the E output bits."""
    if E <= 0:
        raise ValueError("output length E must be positive")
    wnn = circular_buffer_map(n, D)
    return wnn[np.arange(E) % wnn.size].astype(np.int32)


@functools.lru_cache(maxsize=64)
def _indices(n: int, D: int, E: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(ratematch_indices(n, D, E), dtype=torch.long,
                           device=device)


def rate_match(coded, spec: CodeSpec, D: int, E: int,
               device=None) -> torch.Tensor:
    """Select the E channel bits (or values) of codewords [..., D n] in
    transmission order: [..., E]."""
    coded = as_tensor(coded, device=device)
    return torch.index_select(coded, -1, _indices(spec.n, D, E, coded.device))


def rate_match_segments(segments, spec: CodeSpec, E: int,
                        device=None) -> torch.Tensor:
    """`rate_match` of segment-form codewords [..., D, n]."""
    seg = as_tensor(segments, device=device)
    D = seg.shape[-2]
    return rate_match(seg.reshape(seg.shape[:-2] + (D * spec.n,)), spec, D, E)


def derate_match(llrs, spec: CodeSpec, D: int, qmax: int | None = None,
                 device=None) -> torch.Tensor:
    """Invert rate matching with repetition soft combining.

    Adds the E received LLRs onto their n D codeword slots: repeated copies
    accumulate, never-sent bits stay 0.  To combine several transmissions of
    one codeword, add the outputs before clipping.

    Args:
      llrs: [..., E] received LLRs in transmission order, int or float.
      qmax: if given, clip to [-qmax, qmax] and cast to int8 for the soft
        kernels; else the accumulator is returned (int32, or the float type).
    Returns:
      [..., D, n] segment-form LLRs of the codeword.
    """
    llrs = as_tensor(llrs, device=device)
    E = llrs.shape[-1]
    idx = _indices(spec.n, D, E, llrs.device)
    acc = llrs.dtype if llrs.dtype.is_floating_point else torch.int32
    out = torch.zeros(llrs.shape[:-1] + (D * spec.n,), dtype=acc,
                      device=llrs.device)
    out.index_add_(-1, idx, llrs.to(acc))
    if qmax is not None:
        out = torch.clamp(out, -qmax, qmax).to(torch.int8)
    return out.reshape(llrs.shape[:-1] + (D, spec.n))
