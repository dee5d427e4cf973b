"""Max-log-MAP (min-sum BCJR) soft-output decoding, batched over channels.

Port of `convolutionalencdec_tpu/ops/maxlogmap.py`.  In the min-sum cost
domain of `ops.metrics.soft_step_metrics`:

    alpha_{t+1}(d) = min_e [ alpha_t(src(e, d)) + bm_t(u(d), src(e, d)) ]
    beta_t(s)      = min_u [ bm_t(u, s) + beta_{t+1}(next(u, s)) ]
    L_t(bit j)     = min over edges with u_j = 1 of
                         [ alpha_t(s) + bm_t(u, s) + beta_{t+1}(next) ]
                   - the same min over edges with u_j = 0

so a positive LLR favours bit 0, as the input LLRs do.  All arithmetic is
int32 on the quantized-LLR costs, never renormalised, so the outputs are
exact integers.  This is the plain version of the CUDA kernel
(`kernels/maxlogmap.py`) and the decoder of every spec that kernel does
not take.  The LLRs are used as they are: -128 is not floored here (the
kernel entry floors it, as the JAX kernel entry does).
"""

from __future__ import annotations

import torch

from .._device import as_tensor
from ..params import CodeSpec
from .metrics import soft_step_metrics
from .trellis import next_state_table, prev_state_table
from .viterbi import one_packet

#: Exclusion constant for impossible states: the value of a state that
#: cannot start (or end) the packet.  Path costs stay far below it
#: (T n 128 < 2^28 is the kernel's envelope), and alpha + beta + branch
#: sums stay inside int32.
BIG = 1 << 28


@one_packet(3)
def maxlogmap_llrs(spec: CodeSpec, qllrs, terminated: bool = True,
                   device=None) -> torch.Tensor:
    """A-posteriori per-bit LLRs of a batch of packets via max-log-MAP.

    Args:
      qllrs: int [B, T, n] quantized channel LLRs (positive favours coded
        bit 0); erasures are 0.
      terminated: the packets end in the S termination steps that drive
        the encoder back to `starting_state`; the backward pass is then
        anchored there.  False leaves the final state free.

    Returns:
      int32 [B, T * k] a-posteriori LLRs, one per input bit, the bits of a
      symbol MSb-first.  For a terminated packet the first (T - S) k are
      the message bits' (the termination steps' follow, strongly biased to
      their known zeros).
    """
    qllrs = as_tensor(qllrs, torch.int32, device)
    B, T, _ = qllrs.shape
    NS, E, k = spec.num_states, spec.num_edges_per_state, spec.k
    dev = qllrs.device
    bm = soft_step_metrics(spec, qllrs)                       # [B, T, E, NS]
    prev = torch.as_tensor(prev_state_table(spec), dtype=torch.long,
                           device=dev)                        # [E, NS]
    nxt = torch.as_tensor(next_state_table(spec), dtype=torch.long,
                          device=dev)                         # [E, NS]
    u_of_dst = torch.arange(NS, device=dev) & (E - 1)
    # bm_in[b, t, e, d]: the cost of the e-th edge into d.
    bm_in = bm.reshape(B, T, E * NS)[:, :, u_of_dst[None, :] * NS + prev]

    def anchored() -> torch.Tensor:
        m = torch.full((B, NS), BIG, dtype=torch.int32, device=dev)
        m[:, spec.starting_state] = 0
        return m

    alphas = torch.empty((B, T, NS), dtype=torch.int32, device=dev)
    m = anchored()
    for t in range(T):
        alphas[:, t] = m
        m = torch.amin(m[:, prev] + bm_in[:, t], dim=1)

    b = (anchored() if terminated
         else torch.zeros((B, NS), dtype=torch.int32, device=dev))
    per_u = torch.empty((B, T, E), dtype=torch.int32, device=dev)
    for t in range(T - 1, -1, -1):
        cand = bm[:, t] + b[:, nxt]                           # [B, E(u), NS(s)]
        per_u[:, t] = torch.amin(alphas[:, t, None, :] + cand, dim=2)
        b = torch.amin(cand, dim=1)

    u_vals = torch.arange(E, device=dev)
    excluded = torch.tensor(BIG * 4, dtype=torch.int32, device=dev)
    llrs = []
    for j in range(k - 1, -1, -1):                            # MSb first
        one = ((u_vals >> j) & 1) == 1
        c1 = torch.amin(torch.where(one, per_u, excluded), dim=2)
        c0 = torch.amin(torch.where(one, excluded, per_u), dim=2)
        llrs.append(c1 - c0)
    return torch.stack(llrs, dim=2).reshape(B, T * k)


@one_packet(3)
def maxlogmap_decode(spec: CodeSpec, qllrs, terminated: bool = True,
                     device=None) -> torch.Tensor:
    """Hard bitwise-MAP decisions from `maxlogmap_llrs` (a negative LLR is
    bit 1): uint8 [B, (T - S) k] message bits of terminated packets (the
    termination steps stripped), or all [B, T k] when `terminated=False`.
    Bitwise MAP may differ from Viterbi's sequence ML on rare near-tie
    bits; both are right under their own criterion."""
    qllrs = as_tensor(qllrs, torch.int32, device)
    bits = (maxlogmap_llrs(spec, qllrs, terminated) < 0).to(torch.uint8)
    if not terminated:
        return bits
    return bits[:, :(qllrs.shape[1] - spec.S) * spec.k]


def maxlogmap_llrs_batch(spec: CodeSpec, qllrs, terminated: bool = True,
                         device=None) -> torch.Tensor:
    """The JAX package's batched name ([B, T, n] -> [B, T k]); the port's
    `maxlogmap_llrs` is batched already."""
    return maxlogmap_llrs(spec, qllrs, terminated, device)
