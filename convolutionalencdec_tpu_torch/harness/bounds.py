"""Analytic BER bounds from the code's distance spectrum.

Port of `convolutionalencdec_tpu/harness/bounds.py`, numpy only, on the
port's own `params` and `ops.trellis`.  The reference codebase anchors its
Eb/N0 curve analytically (MATLAB `distspec` + `bercoding`,
berCurveCoded.m:46-51, 127-153); this module derives the same from
`CodeSpec`'s trellis tables: enumerate all first-error events (paths that
diverge from the zero state and first remerge), bucketed by output Hamming
distance d, accumulating path counts a_d and total input-bit weights c_d;
then the classic union bounds

    soft (unquantized ML):  Pb <= (1/k) * sum_d c_d * Q(sqrt(2 d R Eb/N0))
    hard (BSC ML):          Pb <= (1/k) * sum_d c_d * P2(d),  p = Q(sqrt(2 R Eb/N0))

with P2(d) the pairwise error probability of a weight-d codeword over a
BSC (ties at even d count half).  The sums stop at `dmax`: they bound the
BER above the knee of the curve, where the omitted terms are small; on a
noisy channel the truncated sum can fall below the measured BER.

Deterministic: `tests/test_torch_harness.py` holds every value equal to
the JAX package's.
"""

from __future__ import annotations

import functools
import math

import numpy as np

from ..ops.trellis import edge_coded_bits, next_state_table
from ..params import CodeSpec


@functools.lru_cache(maxsize=None)
def _distance_spectrum_cached(spec: CodeSpec, dmax: int):
    """Cached worker for `distance_spectrum` (which returns copies).

    First-error-event spectrum up to output distance `dmax`: (dfree, a, c)
    with `a[d]` the number of paths that diverge from the all-zero path and
    first remerge with output Hamming weight d, `c[d]` their total input-bit
    weight (the BER bound's coefficients), both of length dmax + 1, and
    `dfree` the smallest d with a[d] > 0.

    Breadth-first transfer-function expansion over the trellis: in-flight
    mass N[s][d] (path count) and W[s][d] (summed input weight) over
    nonzero states, extended one step at a time; remerges to state 0 are
    collected, entries past dmax pruned.  A non-catastrophic code gains
    distance on every nonzero loop, so the in-flight mass empties in
    bounded steps; a catastrophic code (zero-distance loop) is rejected.
    """
    NS = spec.num_states
    NE = spec.num_edges_per_state
    seg = edge_coded_bits(spec)                  # [NE, NS] coded segments
    nxt = next_state_table(spec)                 # [NE, NS]
    wt = np.array([bin(x).count("1") for x in range(1 << spec.n)])
    dseg = wt[seg]                               # output weight per edge
    uw = np.array([bin(u).count("1") for u in range(NE)])  # input weight

    # Python-int (object) arrays: path counts grow ~2^d and must not
    # overflow.
    N = np.zeros((NS, dmax + 1), dtype=object)
    W = np.zeros((NS, dmax + 1), dtype=object)
    a = np.zeros(dmax + 1, dtype=object)
    c = np.zeros(dmax + 1, dtype=object)

    # Divergence step: nonzero inputs from state 0.
    for u in range(1, NE):
        d0, s0 = int(dseg[u, 0]), int(nxt[u, 0])
        if d0 <= dmax:
            if s0 == 0:
                raise ValueError("degenerate code: 1-step zero loop")
            N[s0, d0] += 1
            W[s0, d0] += int(uw[u])

    # Each loop adds >= 1 distance for a non-catastrophic code, so
    # (dmax + 1) * NS steps is a safe ceiling.
    for _ in range((dmax + 1) * NS):
        if not N.any():
            break
        N2 = np.zeros_like(N)
        W2 = np.zeros_like(W)
        for s in range(1, NS):
            for d in range(dmax + 1):
                n_ = N[s, d]
                if not n_:
                    continue
                w_ = W[s, d]
                for u in range(NE):
                    d2 = d + int(dseg[u, s])
                    if d2 > dmax:
                        continue
                    s2 = int(nxt[u, s])
                    wadd = w_ + n_ * int(uw[u])
                    if s2 == 0:                  # first remerge: collect
                        a[d2] += n_
                        c[d2] += wadd
                    else:
                        N2[s2, d2] += n_
                        W2[s2, d2] += wadd
        N, W = N2, W2
    else:
        raise ValueError(
            "catastrophic code: zero-distance loop keeps paths in "
            "flight; the distance spectrum diverges")

    nz = [d for d in range(dmax + 1) if a[d]]
    if not nz:
        raise ValueError(f"no remerging path within dmax={dmax}")
    return nz[0], a, c


def distance_spectrum(spec: CodeSpec, dmax: int = 24):
    """First-error-event spectrum up to output distance `dmax`:
    (dfree, a, c), see `_distance_spectrum_cached`.  Returns copies of the
    cached arrays, so a caller's changes cannot reach later bounds."""
    dfree, a, c = _distance_spectrum_cached(spec, dmax)
    return dfree, a.copy(), c.copy()


def qfunc(x: float) -> float:
    """Gaussian tail Q(x) = P(N(0,1) > x)."""
    return 0.5 * math.erfc(x / math.sqrt(2.0))


def _pairwise_bsc(d: int, p: float) -> float:
    """P2(d): the probability that a weight-d codeword beats the sent one
    over a BSC(p) under minimum-distance decoding; even-d ties count half."""
    total = 0.0
    half = d / 2.0
    for e in range(d // 2, d + 1):
        if e < half:
            continue
        term = math.comb(d, e) * (p ** e) * ((1.0 - p) ** (d - e))
        total += 0.5 * term if e == half else term
    return total


def union_bound_ber(spec: CodeSpec, ebn0_db, decision: str = "hard",
                    dmax: int = 24) -> float:
    """Union-bound BER at one Eb/N0 point (dB).

    `decision`: "hard" (a BSC of crossover p = Q(sqrt(2 R Eb/N0)), the
    hard decoders' channel model) or "soft" (unquantized ML, which the
    3-bit soft path approaches within its quantizer loss).
    """
    _, _, c = distance_spectrum(spec, dmax)
    ebn0 = 10.0 ** (ebn0_db / 10.0)
    r = spec.rate
    total = 0.0
    if decision == "soft":
        for d in range(dmax + 1):
            if c[d]:
                total += int(c[d]) * qfunc(math.sqrt(2.0 * d * r * ebn0))
    elif decision == "hard":
        p = qfunc(math.sqrt(2.0 * r * ebn0))
        for d in range(dmax + 1):
            if c[d]:
                total += int(c[d]) * _pairwise_bsc(d, p)
    else:
        raise ValueError("decision must be 'hard' or 'soft'")
    return total / spec.k


def bound_curve(spec: CodeSpec, ebn0_points, dmax: int = 24):
    """Analytic hard + soft bound rows for a list of Eb/N0 points."""
    return [{
        "ebn0_db": float(e),
        "hard_ber_bound": union_bound_ber(spec, e, "hard", dmax),
        "soft_ber_bound": union_bound_ber(spec, e, "soft", dmax),
    } for e in ebn0_points]
