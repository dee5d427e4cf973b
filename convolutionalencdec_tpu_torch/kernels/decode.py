"""Batched decode entry points and the one place that chooses a kernel.

Ports of the JAX package's batch entry points
(convolutionalencdec_tpu/kernels/acs_pallas.py): the hard block decodes
(`viterbi_decode_batch`, `viterbi_decode_batch_bytes`), the soft ones
(`viterbi_decode_batch_soft`, `viterbi_decode_batch_soft_bytes`), the
one-call punctured decoders, the ragged decoders with per-channel lengths,
and the generic-k decodes (`viterbi_decode_batch_generic`,
`viterbi_decode_batch_k2`).  The JAX package re-derives its kernel choice
in several places; here `select_kernel` is the only rule, and every entry
point asks it.  Its routes:

  * BUTTERFLY (hard), SOFT8 and SOFT (soft): k = 1 poly-symmetric codes,
    the forward of the code's size (kernels/acs.py) then the walk;
  * SINGLE_PASS: such codes that the JAX package's SWAR kernels do not
    take (in practice n >= 5) at NS >= 64, where a packet is short enough
    that its decisions fit on chip (`use_single_pass`): forward and walk
    in one launch (kernels/single_pass.py);
  * K2 and GENERIC_K (hard): every other code, on the generic-k kernels
    (kernels/generic.py);
  * GENERIC: the codes left, on the plain decoder (CPU tensors only).

Every entry point takes `device=None`: a tensor input keeps its own device,
any other input goes to `device` (default: the CUDA card).  On the card an
entry point runs the CUDA kernels or raises; on a CPU tensor it runs their
plain versions.
"""

from __future__ import annotations

import torch

from .._device import as_tensor
from ..ops.metrics import (DEFAULT_QMAX, hard_bits_to_qllrs,
                           viterbi_decode_ragged_soft, viterbi_decode_soft)
from ..ops.puncture import check_pattern_rows, depuncture_llrs
from ..ops.viterbi import (init_metric_value, pad_and_pack, viterbi_decode,
                           viterbi_decode_ragged)
from ..params import CodeSpec
from .acs import (MAX_STATES, acs_forward_batch, acs_forward_batch_soft,
                  condition_qllrs, kernel_supports, traceback_batch,
                  traceback_batch_ragged)
from .generic import (acs_forward_batch_generic, acs_forward_batch_k2,
                      generic_kernel_supports, k2_supported,
                      traceback_batch_generic, traceback_batch_k2)
from .single_pass import block_decode_1p, use_single_pass

#: Route names of `select_kernel`.  The butterfly routes launch the kernel
#: of the code's size (kernels/acs.py): csrc/acs_small.cu at NS <= 32,
#: csrc/acs_soft_k1.cu (hard and soft) at 64..256, csrc/acs_wide.cu at
#: 512..16384, then csrc/traceback_k1.cu.
BUTTERFLY = "butterfly"  # hard
SOFT8 = "soft8"          # soft, LLRs clipped to +-qmax
SOFT = "soft"            # soft, any int8 LLR (floored at -127)
SINGLE_PASS = "single_pass"  # hard or soft, one launch: csrc/block_1p.cu
K2 = "k2"                # hard, k = 2 and NS = 64: csrc/acs_generic.cu <2, 64>
GENERIC_K = "generic_k"  # hard, any other code: csrc/acs_generic.cu
GENERIC = "generic"      # no CUDA kernel yet: plain decoder on a CPU tensor


def swar_layout_supported(spec: CodeSpec) -> bool:
    """The JAX package's rule for its SWAR kernels' layout
    (acs_swar.swar_layout_supported): k = 1 poly-symmetric butterfly with
    NS >= 64 and n <= 4."""
    return (spec.k == 1 and spec.num_states >= 64 and spec.n <= 4
            and spec.has_poly_symmetry)


def swar_supported(spec: CodeSpec) -> bool:
    """The JAX package's rule for its hard SWAR kernels
    (acs_swar.swar_supported): the layout, and 8-bit metric fields under
    one of its two renorm cadences (every 24 steps: init + 25 n <= 127;
    every 3 steps: max(init, S n) + 3 n <= 127)."""
    init = init_metric_value(spec)
    sparse = init + 25 * spec.n <= 127
    dense = max(init, spec.S * spec.n) + 3 * spec.n <= 127
    return swar_layout_supported(spec) and (sparse or dense)


def swar8_soft_supported(spec: CodeSpec, qmax: int) -> bool:
    """The JAX package's rule for its 8-bit soft kernel
    (acs_swar.swar8_soft_supported): soft metrics fit 8-bit fields with a
    renorm every 3 steps, max(init_hi, S n qmax) + 3 n qmax <= 127.  Where
    it holds, that kernel's pack clips every LLR to +-qmax."""
    growth = 3 * spec.n * qmax
    spread = max(init_metric_value(spec), spec.S * spec.n * qmax)
    return (swar_layout_supported(spec) and qmax <= 31
            and spread + growth <= 127)


def soft_qclip(spec: CodeSpec, qmax: int) -> int:
    """The clip the JAX package applies to int8 LLRs on its soft route:
    qmax on the 8-bit kernel's route, else none (127, the floored int8
    range)."""
    return qmax if swar8_soft_supported(spec, qmax) else 127


def select_kernel(spec: CodeSpec, mode: str = "hard",
                  qmax: int | None = None, T: int | None = None) -> str:
    """The route that decodes `spec` in `mode` ("hard" or "soft") at T
    steps (None: a length-free answer, as the ragged and stream decodes
    need).

    BUTTERFLY (hard) and SOFT8 / SOFT (soft): k = 1 poly-symmetric codes
    with 2 <= NS <= 16384 (every preset; hard decodes need n <= 8) run the
    hand-written forward ACS and traceback kernels.  SOFT8 is the route of
    the JAX package's 8-bit soft kernel (`swar8_soft_supported(spec,
    qmax)`, qmax default DEFAULT_QMAX), whose LLRs are clipped to +-qmax;
    SOFT takes any int8 LLR.  SINGLE_PASS, given T: the JAX package's
    single-pass branch (acs_pallas.py:371-372, :550-551), for such a code
    that its SWAR kernels reject (hard: not `swar_supported`; soft: not
    `swar_layout_supported`) where `use_single_pass(spec, T)` holds.
    Hard decodes of every other code take the JAX package's order: K2 (the
    generic kernels at k = 2, NS = 64) first, then GENERIC_K (the generic
    kernels, `generic_kernel_supports`: TOY_K3, rate-k/n codes).  GENERIC:
    the codes left (butterfly codes with NS > 16384, non-butterfly codes
    past the generic kernels' limits, soft decodes of non-butterfly codes)
    decode through the plain decoder on a CPU tensor and raise on a CUDA
    tensor.
    """
    if mode not in ("hard", "soft"):
        raise ValueError(f"mode must be 'hard' or 'soft', got {mode!r}")
    if not kernel_supports(spec, mode):
        if mode == "hard" and generic_kernel_supports(spec):
            return K2 if k2_supported(spec) else GENERIC_K
        return GENERIC
    single = T is not None and use_single_pass(spec, T)
    if mode == "hard":
        return (SINGLE_PASS if single and not swar_supported(spec)
                else BUTTERFLY)
    qmax = DEFAULT_QMAX if qmax is None else qmax
    if swar8_soft_supported(spec, qmax):
        return SOFT8
    return (SINGLE_PASS if single and not swar_layout_supported(spec)
            else SOFT)


def _no_kernel(spec: CodeSpec, t: torch.Tensor) -> None:
    """The GENERIC route: the plain decoder, for a CPU tensor only; raise
    for any other."""
    if t.device.type == "cpu":
        return
    if spec.k == 1 and spec.has_poly_symmetry:
        reason = (f"the butterfly kernels take NS <= {MAX_STATES} (their "
                  "metrics live in one block's shared memory) and hard "
                  "segments of n <= 8 bits")
    elif generic_kernel_supports(spec):
        # Only the ragged entries get here: the JAX package scans there
        # (acs_pallas.py:1721-1722).
        reason = ("its ragged decodes have no kernel: the generic-k "
                  "traceback walks one length for the whole batch")
    else:
        reason = ("the generic-k kernels take NS <= 1024, k <= 8 and "
                  "n <= 8")
    raise NotImplementedError(f"no CUDA kernel decodes {spec}: {reason} "
                              "(later work, ROADMAP.md queue 2)")


def _message_bits(spec: CodeSpec, T: int, message_bits: int | None) -> int:
    """The decoded bit count L: default and upper bound (T - S) * k."""
    full = (T - spec.S) * spec.k
    L = full if message_bits is None else message_bits
    if not 0 <= L <= full:
        raise ValueError(f"message_bits = {L} outside [0, (T - S) * k = "
                         f"{full}]")
    return L


def _emit(bits: torch.Tensor, out: str) -> torch.Tensor:
    return pad_and_pack(bits) if out == "bytes" else bits


#: The forward and traceback wrappers of the generic-k routes.
_GENERIC_ROUTES = {
    GENERIC_K: (acs_forward_batch_generic, traceback_batch_generic),
    K2: (acs_forward_batch_k2, traceback_batch_k2),
}


def _decode(spec: CodeSpec, segments, message_bits: int | None, out: str,
            device, route: str | None = None) -> torch.Tensor:
    """The hard block decodes' shared body, on `route` (default
    `select_kernel(spec)`)."""
    segments = as_tensor(segments, torch.uint8, device)
    if segments.dim() != 2:
        raise ValueError("segments must be uint8 [B, T]")
    B, T = segments.shape
    L = _message_bits(spec, T, message_bits)
    route = select_kernel(spec, T=T) if route is None else route
    if route == SINGLE_PASS:
        return block_decode_1p(spec, segments, T, False, out, L)
    if route == BUTTERFLY:
        decisions, _ = acs_forward_batch(spec, segments)
        return traceback_batch(spec, decisions, T, L, out=out)
    if route in _GENERIC_ROUTES:
        forward, traceback = _GENERIC_ROUTES[route]
        planes, _ = forward(spec, segments)
        return traceback(spec, planes, T, L, out=out)
    _no_kernel(spec, segments)
    return _emit(viterbi_decode(spec, segments)[:, :L], out)


def viterbi_decode_batch(spec: CodeSpec, segments,
                         message_bits: int | None = None,
                         device=None) -> torch.Tensor:
    """Hard-decision block decode of a batch of terminated packets.

    Args:
      segments: uint8 [B, T] hard segments, T = L/k + S.
      message_bits: decoded bit count L; defaults to (T - S) * k.
      device: where a non-tensor `segments` goes (default the CUDA card).
    Returns uint8 [B, L] decoded message bits, bit-identical to the
    reference decoder `ops.viterbi.viterbi_decode`.
    """
    return _decode(spec, segments, message_bits, "bits", device)


def viterbi_decode_batch_bytes(spec: CodeSpec, segments,
                               message_bits: int | None = None,
                               device=None) -> torch.Tensor:
    """Byte twin of `viterbi_decode_batch`: uint8 [B, ceil(L/8)], filled
    MSb-first with a zero-padded trailing byte.  On the BUTTERFLY and
    SINGLE_PASS routes the kernel emits the bytes itself."""
    return _decode(spec, segments, message_bits, "bytes", device)


def viterbi_decode_batch_generic(spec: CodeSpec, segments,
                                 message_bits: int | None = None,
                                 device=None) -> torch.Tensor:
    """Hard block decode through the generic-k kernels (any code of
    `generic_kernel_supports`, k2 codes included): port of
    acs_pallas.viterbi_decode_batch_generic (:2060).  Returns uint8
    [B, L] bits, L default (T - S) * k, each k-bit symbol MSb first;
    bit-identical to `ops.viterbi.viterbi_decode`."""
    return _decode(spec, segments, message_bits, "bits", device, GENERIC_K)


def viterbi_decode_batch_k2(spec: CodeSpec, segments,
                            message_bits: int | None = None,
                            device=None) -> torch.Tensor:
    """Hard block decode of a k = 2, 64-state code through the generic
    kernels' k2 instantiation: port of acs_k2.viterbi_decode_batch_k2
    (:552).  Raises ValueError for other codes.  Returns uint8 [B, L]
    bits, as `viterbi_decode_batch_generic`."""
    return _decode(spec, segments, message_bits, "bits", device, K2)


def _as_qllrs(spec: CodeSpec, qllrs, device) -> torch.Tensor:
    """The int8 cast of every soft entry point (the -127 floor and the
    route's clip follow in the kernel or in `condition_qllrs`)."""
    qllrs = as_tensor(qllrs, device=device).to(torch.int8)
    if qllrs.dim() != 3 or qllrs.shape[2] != spec.n:
        raise ValueError(f"qllrs must be [B, T, n = {spec.n}]")
    return qllrs


def _decode_soft(spec: CodeSpec, qllrs, message_bits: int | None,
                 qmax: int | None, out: str, device) -> torch.Tensor:
    spec.validate_for_butterfly()
    qllrs = _as_qllrs(spec, qllrs, device)
    B, T, _ = qllrs.shape
    L = _message_bits(spec, T, message_bits)
    qmax = DEFAULT_QMAX if qmax is None else qmax
    qclip = soft_qclip(spec, qmax)
    route = select_kernel(spec, "soft", qmax, T)
    if route == SINGLE_PASS:  # qclip is 127 off the 8-bit route
        return block_decode_1p(spec, qllrs, T, True, out, L)
    if route != GENERIC:
        decisions, _ = acs_forward_batch_soft(spec, qllrs, qclip)
        return traceback_batch(spec, decisions, T, L, out=out)
    _no_kernel(spec, qllrs)
    bits = viterbi_decode_soft(spec, condition_qllrs(qllrs, qclip))
    return _emit(bits[:, :L], out)


def viterbi_decode_batch_soft(spec: CodeSpec, qllrs,
                              message_bits: int | None = None,
                              qmax: int | None = None,
                              device=None) -> torch.Tensor:
    """Soft-decision block decode of a batch of terminated packets.

    Port of acs_pallas.viterbi_decode_batch_soft (:505).  Bit-identical to
    `ops.metrics.viterbi_forward_butterfly_soft` plus the terminated
    traceback on the conditioned LLRs: each input is cast to int8 and
    floored at -127, and on the SOFT8 route (NASA_K7 at the default
    qmax = 7, say) clipped to +-qmax; on the SOFT route it is not clipped.

    Args:
      qllrs: int [B, T, n] quantized LLRs (see ops.metrics.quantize_llrs).
      message_bits: decoded bit count L; defaults to T - S.
      qmax: the quantizer's bound (default DEFAULT_QMAX); it picks the route
        and so the clip (`select_kernel`).
    Returns uint8 [B, L] decoded message bits.
    """
    return _decode_soft(spec, qllrs, message_bits, qmax, "bits", device)


def viterbi_decode_batch_soft_bytes(spec: CodeSpec, qllrs,
                                    message_bits: int | None = None,
                                    qmax: int | None = None,
                                    device=None) -> torch.Tensor:
    """Byte twin of `viterbi_decode_batch_soft` (acs_pallas.py:1585):
    uint8 [B, ceil(L/8)], MSb-first with a zero-padded trailing byte."""
    return _decode_soft(spec, qllrs, message_bits, qmax, "bytes", device)


def viterbi_decode_batch_punctured(spec: CodeSpec, rx_bits, pattern, T: int,
                                   message_bits: int | None = None,
                                   device=None) -> torch.Tensor:
    """One-call batched decode of hard punctured streams
    (acs_pallas.py:1624).

    Received bits become +-1 pseudo-LLRs, punctured positions zero-LLR
    erasures, and the soft decode runs with qmax = 1.

    Args:
      rx_bits: uint8 [B, kept] received coded bits in transmission order
        (the order of `ops.puncture.puncture_bits`).
      pattern: (n, period) 0/1 puncture pattern.
      T: mother-code trellis steps (kept = puncture_mask(pattern, T).sum()).
    Returns uint8 [B, L] decoded message bits.
    """
    check_pattern_rows(spec, pattern)
    rx_bits = as_tensor(rx_bits, device=device)
    q = depuncture_llrs(hard_bits_to_qllrs(rx_bits), pattern, T)
    return viterbi_decode_batch_soft(
        spec, q.reshape(rx_bits.shape[0], T, spec.n), message_bits, qmax=1)


def viterbi_decode_batch_punctured_soft(spec: CodeSpec, qllrs, pattern,
                                        T: int,
                                        message_bits: int | None = None,
                                        qmax: int | None = None,
                                        device=None) -> torch.Tensor:
    """One-call batched soft decode of punctured streams
    (acs_pallas.py:1659).

    Args:
      qllrs: int [B, kept] quantized LLRs of the sent bits, in transmission
        order; cast to int8, then the punctured positions are put back as
        zero-LLR erasures.
      pattern, T: as `viterbi_decode_batch_punctured`.
    Returns uint8 [B, L] decoded message bits.
    """
    check_pattern_rows(spec, pattern)
    qllrs = as_tensor(qllrs, device=device).to(torch.int8)
    full = depuncture_llrs(qllrs, pattern, T)
    return viterbi_decode_batch_soft(
        spec, full.reshape(qllrs.shape[0], T, spec.n), message_bits, qmax)


def _lengths(seg_lengths, B: int, device: torch.device) -> torch.Tensor:
    """int32 [B] lengths on the decoded inputs' device."""
    lens = torch.as_tensor(seg_lengths, dtype=torch.int32, device=device)
    if lens.shape != (B,):
        raise ValueError(f"seg_lengths must have shape [B = {B}]")
    return lens


def _check_ragged_T(spec: CodeSpec, T: int) -> None:
    if T < spec.S:
        raise ValueError(f"Tmax = {T} below the S = {spec.S} termination "
                         "steps")


def _decode_ragged(spec: CodeSpec, segments, seg_lengths, out: str,
                   device) -> torch.Tensor:
    segments = as_tensor(segments, torch.uint8, device)
    if segments.dim() != 2:
        raise ValueError("segments must be uint8 [B, Tmax]")
    B, T = segments.shape
    _check_ragged_T(spec, T)
    lens = _lengths(seg_lengths, B, segments.device)
    if select_kernel(spec) == BUTTERFLY:
        decisions, _ = acs_forward_batch(spec, segments)
        return traceback_batch_ragged(spec, decisions, lens, T - spec.S, out)
    _no_kernel(spec, segments)
    return _emit(viterbi_decode_ragged(spec, segments, lens), out)


def viterbi_decode_batch_ragged(spec: CodeSpec, segments, seg_lengths,
                                device=None) -> torch.Tensor:
    """Ragged-batch hard decode, per-channel packet lengths in one call
    (acs_pallas.py:1685).

    Args:
      segments: uint8 [B, Tmax]; rows may hold anything past t_b.
      seg_lengths: int32 [B] valid segment counts, t_b = l_b / k + S.
    Returns uint8 [B, (Tmax - S) * k]; positions >= (t_b - S) * k are zero.
    """
    return _decode_ragged(spec, segments, seg_lengths, "bits", device)


def viterbi_decode_batch_bytes_ragged(spec: CodeSpec, segments, seg_lengths,
                                      device=None) -> torch.Tensor:
    """Ragged-batch hard decode to packed bytes (acs_pallas.py:1725):
    MSb-first, each row zero past its channel's message.  Returns uint8
    [B, ceil((Tmax - S) * k / 8)]."""
    return _decode_ragged(spec, segments, seg_lengths, "bytes", device)


def viterbi_decode_batch_soft_bytes_ragged(spec: CodeSpec, qllrs, seg_lengths,
                                           qmax: int | None = None,
                                           device=None) -> torch.Tensor:
    """Soft-decision ragged-batch byte decode (acs_pallas.py:1753): the
    byte twin of `viterbi_decode_batch_bytes_ragged` over quantized LLRs,
    conditioned as in `viterbi_decode_batch_soft`.  Returns uint8
    [B, ceil((Tmax - S) * k / 8)]."""
    qllrs = _as_qllrs(spec, qllrs, device)
    B, T, _ = qllrs.shape
    _check_ragged_T(spec, T)
    lens = _lengths(seg_lengths, B, qllrs.device)
    qmax = DEFAULT_QMAX if qmax is None else qmax
    qclip = soft_qclip(spec, qmax)
    if select_kernel(spec, "soft", qmax) != GENERIC:
        decisions, _ = acs_forward_batch_soft(spec, qllrs, qclip)
        return traceback_batch_ragged(spec, decisions, lens, T - spec.S,
                                      "bytes")
    _no_kernel(spec, qllrs)
    return pad_and_pack(viterbi_decode_ragged_soft(
        spec, condition_qllrs(qllrs, qclip), lens))
