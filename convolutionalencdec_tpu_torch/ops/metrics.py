"""Soft-decision branch metrics (quantized LLRs) and the plain soft decoders.

Port of `convolutionalencdec_tpu/ops/metrics.py`, batched over a leading B
dimension.  Channel LLRs (`ops.channel.bpsk_llr`) are quantized to small
signed integers; the cost of assuming coded bit b given quantized LLR q is
0 when the sign of q agrees with b, else |q|: cost-if-1 is relu(q) and
cost-if-0 is relu(-q).  Hard inputs mapped to q = +-1 give the Hamming
metric exactly, and q = 0 is an erasure that costs neither hypothesis.

The butterfly complement identity survives: with Q = sum_j |q_j| per step,
the complement edge costs emc = Q - em.

Every function takes `device=None`: a tensor input keeps its device, any
other input goes to `device` (default: the CUDA card).
"""

from __future__ import annotations

import torch

from .._device import as_tensor
from ..params import CodeSpec
from .trellis import butterfly_coded_bits, edge_coded_bits
from .viterbi import (_initial_metrics, one_packet, ragged_epilogue,
                      traceback_terminated, viterbi_forward)

#: Default quantizer ceiling: 3-bit magnitudes, which give up only
#: ~0.1-0.2 dB against unquantized soft decoding.
DEFAULT_QMAX = 7


def quantize_llrs(llrs, qmax: int = DEFAULT_QMAX, scale: float | None = None,
                  device=None) -> torch.Tensor:
    """Quantize float LLRs to int32 in [-qmax, qmax].

    Args:
      llrs: float [..., n_bits]; positive favours bit 0.
      scale: LLR units per quantizer step.  Default: 3 sigma of the incoming
        LLRs mapped onto qmax, 3 sqrt(mean(llr^2)) / qmax in float32,
        floored at 1e-9.
    Rounds half to even, then clips; a NaN becomes 0 (so with the default
    scale one NaN or +-inf among the LLRs makes every output 0), as the
    JAX package's cast gives it.
    """
    llrs = as_tensor(llrs, torch.float32, device)
    if scale is None:
        scale = 3.0 * torch.sqrt(torch.mean(torch.square(llrs))) / qmax
        scale = torch.clamp_min(scale, 1e-9)
    q = torch.nan_to_num(torch.round(llrs / scale), nan=0.0)
    return torch.clamp(q, -qmax, qmax).to(torch.int32)


def soft_step_metrics(spec: CodeSpec, qllrs, device=None) -> torch.Tensor:
    """Per-step branch metrics from quantized LLRs, for `viterbi_forward`.

    Args:
      qllrs: int [..., T, n] quantized LLRs, coded bit j of each segment at
        position j.
    Returns int32 [..., T, 2^k, NS] additive branch costs.
    """
    qllrs = as_tensor(qllrs, torch.int32, device)
    dev = qllrs.device
    ec = torch.as_tensor(edge_coded_bits(spec).astype("int32"), device=dev)
    out = torch.zeros(qllrs.shape[:-1] + ec.shape, dtype=torch.int32,
                      device=dev)
    for j in range(spec.n):
        bit_j = (ec >> j) & 1                                      # [2^k, NS]
        q = qllrs[..., j][..., None, None]
        out += torch.where(bit_j == 1, torch.clamp_min(q, 0),
                           torch.clamp_min(-q, 0))
    return out


@one_packet(3)
def viterbi_forward_butterfly_soft(spec: CodeSpec, qllrs,
                                   initial_metrics=None, device=None):
    """k=1 butterfly ACS on quantized LLRs.

    Same wiring as `viterbi_forward_butterfly`, with em[b] the sum of the
    generators' costs for butterfly b's coded bits and the complement
    emc = Q - em.

    Args:
      qllrs: int [B, T, n] quantized LLRs (used as they are: no floor, no
        clip).
      initial_metrics: optional int32 [NS] or [B, NS] starting metrics
        (default 0 at state 0 and `init_metric_value(spec)` elsewhere).

    Returns (decisions uint8 [B, T, NS], final_metrics int32 [B, NS]).
    """
    spec.validate_for_butterfly()
    qllrs = as_tensor(qllrs, torch.int32, device)
    B, T, n = qllrs.shape
    NS, half = spec.num_states, spec.num_states // 2
    dev = qllrs.device
    bfly = torch.as_tensor(butterfly_coded_bits(spec).astype("int32"),
                           device=dev)
    cbits = [((bfly >> j) & 1) == 1 for j in range(n)]             # [half]

    m = _initial_metrics(spec, B, initial_metrics, dev)
    decisions = torch.empty((B, T, NS), dtype=torch.uint8, device=dev)
    for t in range(T):
        q_t = qllrs[:, t]                                          # [B, n]
        Q = q_t.abs().sum(dim=1, keepdim=True)
        em = torch.zeros((B, half), dtype=torch.int32, device=dev)
        for j in range(n):
            q = q_t[:, j:j + 1]
            em += torch.where(cbits[j], torch.clamp_min(q, 0),
                              torch.clamp_min(-q, 0))
        emc = Q - em
        m_lo, m_hi = m[:, :half], m[:, half:]
        a0, a1 = m_lo + em, m_hi + emc
        b0, b1 = m_lo + emc, m_hi + em
        decisions[:, t] = torch.stack([a0 > a1, b0 > b1], dim=2).reshape(B, NS)
        m = torch.stack([torch.minimum(a0, a1), torch.minimum(b0, b1)],
                        dim=2).reshape(B, NS)
    return decisions, m


def _soft_decisions(spec: CodeSpec, qllrs: torch.Tensor) -> torch.Tensor:
    """uint8 [B, T, NS] decisions: the butterfly when k == 1 with poly
    symmetry, else the generic ACS over `soft_step_metrics`."""
    if spec.k == 1 and spec.has_poly_symmetry:
        decisions, _ = viterbi_forward_butterfly_soft(spec, qllrs)
    else:
        decisions, _ = viterbi_forward(spec, soft_step_metrics(spec, qllrs))
    return decisions


@one_packet(3)
def viterbi_decode_soft(spec: CodeSpec, qllrs, device=None) -> torch.Tensor:
    """Soft-decision block decode of terminated packets.

    Args:
      qllrs: int [B, T, n] quantized LLRs (`quantize_llrs` of channel LLRs;
        hard bits map to q = 1 - 2 bit).
    Returns uint8 [B, (T - S) * k] decoded message bits.
    """
    qllrs = as_tensor(qllrs, torch.int32, device)
    return traceback_terminated(spec, _soft_decisions(spec, qllrs))


def viterbi_decode_ragged_soft(spec: CodeSpec, qllrs, seg_lengths,
                               device=None) -> torch.Tensor:
    """Soft-decision batched decode with per-channel lengths: the soft twin
    of `ops.viterbi.viterbi_decode_ragged` (same masked-decision walk).

    Args:
      qllrs: int [B, Tmax, n] quantized LLRs, cast to int8 first.
      seg_lengths: int32 [B] valid segment counts.
    Returns uint8 [B, (Tmax - S) * k]; positions >= (t_b - S) * k are zero.
    """
    qllrs = as_tensor(qllrs, device=device).to(torch.int8)
    lens = as_tensor(seg_lengths, torch.int32, qllrs.device)
    decisions = _soft_decisions(spec, qllrs.to(torch.int32))
    return ragged_epilogue(spec, decisions, lens, qllrs.shape[1])


def hard_bits_to_qllrs(segment_bits, device=None) -> torch.Tensor:
    """Map hard coded bits to int32 +-1 pseudo-LLRs (bit 0 -> +1, bit 1 ->
    -1).  Soft decoding of these is decision-identical to Hamming-metric
    hard decoding."""
    return 1 - 2 * as_tensor(segment_bits, torch.int32, device)
