"""Trellis derivation (numpy only).

The port's copy of `convolutionalencdec_tpu/ops/trellis.py`.  The tables are
derived from the encoder, so encoder and decoder can never disagree.  They
are tiny, computed once per CodeSpec on the host, and moved to a device by
the callers that need them there.

State/edge index conventions:
  * a trellis step from src state s with input u lands in
    dst = ((s << k) | u) & (num_states - 1);
  * the input bits of every edge entering dst are u = dst % 2^k;
  * the 2^k candidate sources of dst are src = dst//2^k + e * 2^((S-1)k)
    for decision index e (the k oldest, shifted-out bits of src).
"""

from __future__ import annotations

import functools

import numpy as np

from ..params import CodeSpec


def _parity_np(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.int64)
    for shift in (32, 16, 8, 4, 2, 1):
        x ^= x >> shift
    return (x & 1).astype(np.uint8)


@functools.lru_cache(maxsize=None)
def edge_coded_bits(spec: CodeSpec) -> np.ndarray:
    """Coded segment for every (input u, src state s): uint8 [2^k, NS]."""
    u = np.arange(spec.num_edges_per_state, dtype=np.int64)[:, None]
    s = np.arange(spec.num_states, dtype=np.int64)[None, :]
    delay = ((s << spec.k) | u) & ((1 << spec.delay_width) - 1)
    seg = np.zeros(delay.shape, dtype=np.uint8)
    for j, grev in enumerate(spec.g_reversed):
        seg |= _parity_np(delay & grev) << j
    return seg


@functools.lru_cache(maxsize=None)
def butterfly_coded_bits(spec: CodeSpec) -> np.ndarray:
    """Coded segment of the input-0 edge of each butterfly's first node:
    uint8 [NS // 2]; entry [b] is the segment for (src=b, u=0) -> dst=2b.
    With poly symmetry the other three butterfly edges carry this segment
    or its bitwise complement."""
    spec.validate_for_butterfly()
    return edge_coded_bits(spec)[0, : spec.num_states // 2].copy()


@functools.lru_cache(maxsize=None)
def next_state_table(spec: CodeSpec) -> np.ndarray:
    """dst state for every (input u, src state s): int32 [2^k, NS]."""
    u = np.arange(spec.num_edges_per_state, dtype=np.int64)[:, None]
    s = np.arange(spec.num_states, dtype=np.int64)[None, :]
    return (((s << spec.k) | u) & (spec.num_states - 1)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def prev_state_table(spec: CodeSpec) -> np.ndarray:
    """src state for every (decision e, dst state d): int32 [2^k, NS],
    src = d // 2^k + e * 2^((S-1)*k)."""
    e = np.arange(spec.num_edges_per_state, dtype=np.int64)[:, None]
    d = np.arange(spec.num_states, dtype=np.int64)[None, :]
    return ((d >> spec.k) + (e << ((spec.S - 1) * spec.k))).astype(np.int32)
