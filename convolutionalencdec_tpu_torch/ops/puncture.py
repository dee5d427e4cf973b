"""Puncturing and depuncturing.

Port of `convolutionalencdec_tpu/ops/puncture.py`.  Higher rates come from
deleting coded bits by a periodic pattern at the transmitter and putting
back erasures (zero LLRs) at the receiver, so the same mother-code decoder
serves rates 2/3, 3/4 and 5/6 unchanged.

A pattern is an (n, period) 0/1 matrix: column p, row j says whether coded
bit j of trellis step t (t mod period == p) is sent.  The mask is numpy
code (static per pattern and T); the gathers are torch.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import as_tensor
from ..params import CodeSpec

# Standard puncturing patterns for rate-1/2 mother codes (n = 2), e.g. the
# DVB / IEEE 802.11 family.
PUNCTURE_2_3 = ((1, 1), (1, 0))            # rate 2/3
PUNCTURE_3_4 = ((1, 1, 0), (1, 0, 1))      # rate 3/4
PUNCTURE_5_6 = ((1, 1, 0, 1, 0), (1, 0, 1, 0, 1))  # rate 5/6


def _pattern_array(pattern) -> np.ndarray:
    pat = np.asarray(pattern, dtype=np.uint8)
    if pat.ndim != 2:
        raise ValueError("pattern must be (n, period)")
    return pat


def check_pattern_rows(spec: CodeSpec, pattern) -> None:
    """A pattern's row count must equal the code's n: a mismatched pattern
    would build a keep-mask over the wrong stream width and silently select
    bits from the wrong (step, generator) pairs."""
    pat = _pattern_array(pattern)
    if pat.shape[0] != spec.n:
        raise ValueError(
            f"puncture pattern has {pat.shape[0]} rows but the code emits "
            f"n={spec.n} bits per step")


def punctured_rate(spec: CodeSpec, pattern) -> float:
    """Effective code rate after puncturing."""
    check_pattern_rows(spec, pattern)
    pat = _pattern_array(pattern)
    return (spec.k * pat.shape[1]) / int(pat.sum())


def puncture_mask(pattern, T: int) -> np.ndarray:
    """Boolean keep-mask over the coded bit stream of T segments, step-major
    with generator j at position j within each step (the order of
    `ops.channel.segments_to_bits`)."""
    pat = _pattern_array(pattern)
    n, period = pat.shape
    reps = -(-T // period)
    return np.tile(pat.T, (reps, 1)).reshape(-1)[: T * n].astype(bool)


def _kept_positions(pattern, T: int, device) -> torch.Tensor:
    return torch.as_tensor(np.nonzero(puncture_mask(pattern, T))[0],
                           device=device)


def puncture_bits(coded_bits, pattern, T: int, device=None) -> torch.Tensor:
    """Delete the punctured positions of a coded bit stream (or LLRs)
    [..., T * n]; returns the surviving positions [..., kept], in order."""
    coded_bits = as_tensor(coded_bits, device=device)
    idx = _kept_positions(pattern, T, coded_bits.device)
    return torch.index_select(coded_bits, -1, idx)


def depuncture_llrs(llrs, pattern, T: int, device=None) -> torch.Tensor:
    """Put zero-LLR erasures back at the punctured positions: [..., kept]
    received LLRs of the sent bits -> [..., T * n], same dtype."""
    llrs = as_tensor(llrs, device=device)
    positions = _kept_positions(pattern, T, llrs.device)
    n_total = puncture_mask(pattern, T).size
    out = torch.zeros(llrs.shape[:-1] + (n_total,), dtype=llrs.dtype,
                      device=llrs.device)
    out[..., positions] = llrs
    return out
