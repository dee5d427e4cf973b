"""Batched tail-biting decodes on the CUDA kernels: wrap decode, list decode
and the CRC-aided receive chains.

Port of `convolutionalencdec_tpu/kernels/tailbiting.py`.  Each packet is
extended circularly (the wrap steps are real observations: the packet's
own tail and head), the forward ACS runs from all-zero (uniform) metrics,
and the traceback starts from the best end state with every step live:

  * the wrap decode: `acs_forward_batch` (K1) or `acs_forward_batch_soft`
    (K3/K4's kernel; the wide forward at NS >= 512, K11's) over
    [wl ++ packet ++ wr], the lowest state of least final metric,
    `traceback_batch_masked` (K2m), the steps [wl, wl + T);
  * the list decode: the same forward over [wl ++ packet], the `list_size`
    best end states by (final metric, state), all walked in one
    `traceback_batch_multi` (K6) launch that returns the message window;
  * the CRC chains: the wrap decode and the list candidates, the outer CRC
    (`ops.crc`) picks the winner (`_crc_select`), behind an optional
    depuncture or 36.212 de-rate-matching (`ops.ratematch`).

The wrap lengths are the JAX package's (`kernel_wraps`, `list_wrap`, with
its PACK = 8 and CHUNK_F = 48): wherever survivors fail to merge the wrap
changes the decoded bits, so equal wraps are what makes the outputs equal.

Every entry point takes `device=None`: a tensor input keeps its device, any
other input goes to `device` (default the card).  Codes the kernels take
(`kernel_supports`: NS <= 16384; hard decodes n <= 8) run the kernels of
their size on the card and their plain versions on a CPU tensor; other
k = 1 poly-symmetric codes with NS >= 64 decode through the plain scans of
`ops/tailbiting.py` on a CPU tensor and raise NotImplementedError on the
card.
"""

from __future__ import annotations

import torch

from .._device import as_tensor
from ..ops.crc import CrcSpec, crc_check
from ..ops.metrics import DEFAULT_QMAX
from ..ops.puncture import depuncture_llrs
from ..ops.ratematch import derate_match
from ..ops.tailbiting import (check_list_size, circular_extend, default_wrap,
                              list_candidates, viterbi_decode_tailbiting,
                              viterbi_decode_tailbiting_list,
                              viterbi_decode_tailbiting_list_soft,
                              viterbi_decode_tailbiting_soft)
from ..ops.viterbi import pad_and_pack
from ..params import CodeSpec
from .acs import (MAX_STATES, acs_forward_batch, acs_forward_batch_soft,
                  condition_qllrs, kernel_supports, traceback_batch_masked,
                  traceback_batch_multi)
from .decode import _as_qllrs, soft_qclip, swar_layout_supported

#: Byte group of the JAX package's traceback emit, and its forward chunk.
PACK = 8
CHUNK_F = 48


def kernel_wraps(spec: CodeSpec, T: int, wrap: int | None = None
                 ) -> tuple[int, int]:
    """(wl, wr) of the wrap decode: `wrap` steps each side (default
    `default_wrap`), the left rounded up to a multiple of PACK so that the
    message starts on a byte, the right stretched so that wl + T + wr is a
    multiple of CHUNK_F (extra wrap steps are more observations, never
    padding)."""
    wl = default_wrap(spec) if wrap is None else int(wrap)
    wl = -(-wl // PACK) * PACK
    wr = wl + (-(T + 2 * wl) % CHUNK_F)
    return wl, wr


def list_wrap(spec: CodeSpec, T: int, wrap: int | None = None) -> int:
    """The left wrap of the list decode: `wrap` warm-up steps stretched so
    that wl + T is a multiple of CHUNK_F.  The trellis must end at the
    message end to keep the candidates distinct, so all the slack goes
    left."""
    wl = default_wrap(spec) if wrap is None else int(wrap)
    return wl + (-(T + wl) % CHUNK_F)


def _check_wrap_spec(spec: CodeSpec, mode: str) -> None:
    spec.validate_for_butterfly()
    if spec.num_states < 64:
        raise ValueError("kernel tail-biting decode requires NS >= 64; use "
                         f"ops.tailbiting.viterbi_decode_tailbiting{mode}")


def _on_kernels(spec: CodeSpec, x: torch.Tensor) -> bool:
    """Whether `spec` runs the kernel route (their plain versions on a CPU
    tensor) for `x`, hard segments [B, T] or LLRs [B, T, n]; False means
    the plain scans, which only a CPU tensor takes."""
    if kernel_supports(spec, "soft" if x.dim() == 3 else "hard"):
        return True
    if x.device.type != "cpu":
        raise NotImplementedError(
            f"no CUDA kernel decodes {spec} tail-biting: the k=1 butterfly "
            f"kernels take poly-symmetric codes with NS <= {MAX_STATES} "
            "(later work, ROADMAP.md queue 2)")
    return False


def _soft_route(spec: CodeSpec, qmax: int | None):
    """(qclip, floor) of the JAX package's soft tail-biting routes: its 8-bit
    kernel clips to +-qmax; its 16-bit kernel (n <= 4) uses every int8 as it
    is, -128 included; its int32 kernel (n > 4) floors -128 at -127."""
    qclip = soft_qclip(spec, DEFAULT_QMAX if qmax is None else qmax)
    return qclip, qclip != 127 or not swar_layout_supported(spec)


def _uniform(spec: CodeSpec, B: int, device) -> torch.Tensor:
    return torch.zeros((B, spec.num_states), dtype=torch.int32, device=device)


def _forward(spec: CodeSpec, ext: torch.Tensor, soft: bool, qmax):
    """Uniform-start forward of an extended batch: (words, final metrics)."""
    init = _uniform(spec, ext.shape[0], ext.device)
    if soft:
        qclip, floor = _soft_route(spec, qmax)
        return acs_forward_batch_soft(spec, ext, qclip, init, floor)
    return acs_forward_batch(spec, ext, init)


def _wrap_decode(spec: CodeSpec, x: torch.Tensor, wrap, soft: bool, qmax,
                 out: str) -> torch.Tensor:
    """The wrap decode of hard segments [B, T] or int8 LLRs [B, T, n] on the
    kernel route: bits [B, T], or bytes [B, ceil(T/8)] straight from the
    traceback's MSb-first emit (wl is a multiple of 8)."""
    B, T = x.shape[:2]
    wl, wr = kernel_wraps(spec, T, wrap)
    ext = circular_extend(x, wl, wr, axis=1)
    words, fm = _forward(spec, ext, soft, qmax)
    start = torch.argmin(fm, dim=1).to(torch.int32)   # ties -> lowest state
    rows = traceback_batch_masked(spec, words, start, ext.shape[1], wl + T,
                                  out)
    return rows[:, wl // PACK:] if out == "bytes" else rows[:, wl:]


def _list_decode(spec: CodeSpec, x: torch.Tensor, list_size: int, wrap,
                 soft: bool, qmax):
    """The list decode on the kernel route: (bits [B, list_size, T],
    metrics [B, list_size] less each channel's least final metric)."""
    B, T = x.shape[:2]
    wl = list_wrap(spec, T, wrap)
    ext = circular_extend(x, wl, 0, axis=1)
    words, fm = _forward(spec, ext, soft, qmax)
    states, metrics = list_candidates(fm, list_size)
    bits = traceback_batch_multi(spec, words, states, ext.shape[1], wl, T)
    least = fm.min(dim=1, keepdim=True).values
    return bits, (metrics - least).to(torch.int32)


def _hard_segments(segments, device) -> torch.Tensor:
    segments = as_tensor(segments, torch.uint8, device)
    if segments.dim() != 2:
        raise ValueError("segments must be uint8 [B, T]")
    return segments


def viterbi_decode_batch_tailbiting(spec: CodeSpec, segments,
                                    wrap: int | None = None,
                                    device=None) -> torch.Tensor:
    """Batched hard-decision tail-biting wrap decode.

    Args:
      segments: uint8 [B, T] hard n-bit segments (T = L: no termination).
      wrap: wrap in steps (default `default_wrap`), stretched by
        `kernel_wraps`.
    Returns uint8 [B, T] decoded message bits: the JAX package's output,
    equal to `ops.tailbiting.viterbi_decode_tailbiting` at wrap
    `kernel_wraps(spec, T, wrap)`.
    """
    _check_wrap_spec(spec, "")
    segments = _hard_segments(segments, device)
    if _on_kernels(spec, segments):
        return _wrap_decode(spec, segments, wrap, False, None, "bits")
    return viterbi_decode_tailbiting(spec, segments,
                                     kernel_wraps(spec, segments.shape[1],
                                                  wrap))


def viterbi_decode_batch_tailbiting_bytes(spec: CodeSpec, segments,
                                          wrap: int | None = None,
                                          device=None) -> torch.Tensor:
    """Byte twin of `viterbi_decode_batch_tailbiting`: uint8 [B, ceil(T/8)],
    MSb-first with a zero-padded trailing byte."""
    _check_wrap_spec(spec, "")
    segments = _hard_segments(segments, device)
    if _on_kernels(spec, segments):
        return _wrap_decode(spec, segments, wrap, False, None, "bytes")
    return pad_and_pack(viterbi_decode_batch_tailbiting(spec, segments, wrap))


def viterbi_decode_batch_tailbiting_soft(spec: CodeSpec, qllrs,
                                         wrap: int | None = None,
                                         qmax: int | None = None,
                                         device=None) -> torch.Tensor:
    """Batched soft-decision tail-biting wrap decode.

    Args:
      qllrs: int [B, T, n] quantized LLRs (cast to int8; zero = erasure).
      wrap: as `viterbi_decode_batch_tailbiting`.
      qmax: the quantizer's bound (default DEFAULT_QMAX).  It picks the JAX
        package's route and so the conditioning: on its 8-bit kernel's route
        (NASA_K7 at qmax 7) every LLR is clipped to +-qmax; on its 16-bit
        route (LTE_TBCC_K7 at qmax 7, any n <= 4) the LLRs are used as they
        are, -128 included; for n > 4, -128 is floored at -127.
    Returns uint8 [B, T] decoded message bits, equal to
    `ops.tailbiting.viterbi_decode_tailbiting_soft` on the conditioned
    LLRs at wrap `kernel_wraps(spec, T, wrap)`.
    """
    _check_wrap_spec(spec, "_soft")
    qllrs = _as_qllrs(spec, qllrs, device)
    if _on_kernels(spec, qllrs):
        return _wrap_decode(spec, qllrs, wrap, True, qmax, "bits")
    return viterbi_decode_tailbiting_soft(
        spec, _conditioned(spec, qllrs, qmax),
        kernel_wraps(spec, qllrs.shape[1], wrap))


def viterbi_decode_batch_tailbiting_soft_bytes(spec: CodeSpec, qllrs,
                                               wrap: int | None = None,
                                               qmax: int | None = None,
                                               device=None) -> torch.Tensor:
    """Byte twin of `viterbi_decode_batch_tailbiting_soft`: uint8
    [B, ceil(T/8)], MSb-first with a zero-padded trailing byte."""
    _check_wrap_spec(spec, "_soft")
    qllrs = _as_qllrs(spec, qllrs, device)
    if _on_kernels(spec, qllrs):
        return _wrap_decode(spec, qllrs, wrap, True, qmax, "bytes")
    return pad_and_pack(viterbi_decode_batch_tailbiting_soft(spec, qllrs,
                                                             wrap, qmax))


def _conditioned(spec: CodeSpec, qllrs: torch.Tensor, qmax) -> torch.Tensor:
    """int8 LLRs as the route uses them (see `_soft_route`), as int32."""
    qclip, floor = _soft_route(spec, qmax)
    return condition_qllrs(qllrs, qclip, floor)


def _check_list_args(spec: CodeSpec, list_size: int, mode: str) -> None:
    _check_wrap_spec(spec, mode)
    check_list_size(spec, list_size)


def viterbi_decode_batch_tailbiting_list(spec: CodeSpec, segments,
                                         list_size: int = 4,
                                         wrap: int | None = None,
                                         device=None):
    """Batched hard-decision list wrap decode: the `list_size` best circular
    paths of each packet by (final metric, state), over a left-only
    extension (`list_wrap`); candidate 0 is the wrap decode at wrap
    (list_wrap(spec, T, wrap), 0).

    Returns (uint8 [B, list_size, T] candidate bits, int32 [B, list_size]
    final metrics less the channel's least, ascending: as in the JAX
    package, only their differences mean anything).
    """
    _check_list_args(spec, list_size, "")
    segments = _hard_segments(segments, device)
    if _on_kernels(spec, segments):
        return _list_decode(spec, segments, list_size, wrap, False, None)
    bits, metrics = viterbi_decode_tailbiting_list(
        spec, segments, list_size, list_wrap(spec, segments.shape[1], wrap))
    return bits, (metrics - metrics[:, :1]).to(torch.int32)


def viterbi_decode_batch_tailbiting_list_soft(spec: CodeSpec, qllrs,
                                              list_size: int = 4,
                                              wrap: int | None = None,
                                              qmax: int | None = None,
                                              device=None):
    """Soft-decision twin of `viterbi_decode_batch_tailbiting_list`
    (quantized LLRs [B, T, n], conditioned as in
    `viterbi_decode_batch_tailbiting_soft`)."""
    _check_list_args(spec, list_size, "_soft")
    qllrs = _as_qllrs(spec, qllrs, device)
    if _on_kernels(spec, qllrs):
        return _list_decode(spec, qllrs, list_size, wrap, True, qmax)
    bits, metrics = viterbi_decode_tailbiting_list_soft(
        spec, _conditioned(spec, qllrs, qmax), list_size,
        list_wrap(spec, qllrs.shape[1], wrap))
    return bits, (metrics - metrics[:, :1]).to(torch.int32)


def _crc_select(crc: CrcSpec, plain: torch.Tensor, cands: torch.Tensor):
    """The CRC's winner among {the two-sided wrap decode} ++ {the list
    candidates, in metric order}: the wrap decode when it passes (it sees
    the right wrap the list trellis gives up), else the first passing
    candidate, else the wrap decode; so the block error rate is never worse
    than the wrap decode's.

    Returns (bits [B, T], ok bool [B], chosen int32 [B]: 0 = the wrap decode,
    also when nothing passes; l >= 1 = candidate l - 1)."""
    allb = torch.cat([plain[:, None], cands], dim=1)       # [B, 1 + L, T]
    ok = crc_check(crc, allb)                               # [B, 1 + L]
    any_ok = ok.any(dim=1)
    chosen = torch.argmax(ok.to(torch.uint8), dim=1)        # first pass
    chosen = torch.where(any_ok, chosen, 0).to(torch.int32)
    out = torch.take_along_dim(allb, chosen.long()[:, None, None], dim=1)
    return out[:, 0], any_ok, chosen


def viterbi_decode_batch_tailbiting_crc(spec: CodeSpec, crc: CrcSpec,
                                        segments, list_size: int = 4,
                                        wrap: int | None = None,
                                        device=None):
    """CRC-aided list decode of hard tail-biting packets (the LTE
    PDCCH/PBCH receive chain): the wrap decode and the `list_size` list
    candidates, the outer CRC picks the winner (`_crc_select`).  Channels
    with ok = False carry the wrap decode and are erasures to the caller.

    Args:
      crc: the outer code; each packet's bits are payload ++ parity
        (`ops.crc.crc_append`).
      segments: uint8 [B, T] hard segments.
    Returns (uint8 [B, T] bits, bool [B] CRC pass, int32 [B] chosen).
    """
    segments = _hard_segments(segments, device)
    plain = viterbi_decode_batch_tailbiting(spec, segments, wrap)
    cands, _ = viterbi_decode_batch_tailbiting_list(spec, segments,
                                                    list_size, wrap)
    return _crc_select(crc, plain, cands)


def viterbi_decode_batch_tailbiting_crc_soft(spec: CodeSpec, crc: CrcSpec,
                                             qllrs, list_size: int = 4,
                                             wrap: int | None = None,
                                             qmax: int | None = None,
                                             device=None):
    """Soft-decision twin of `viterbi_decode_batch_tailbiting_crc`:
    quantized demodulator LLRs [B, T, n] in."""
    qllrs = _as_qllrs(spec, qllrs, device)
    plain = viterbi_decode_batch_tailbiting_soft(spec, qllrs, wrap, qmax)
    cands, _ = viterbi_decode_batch_tailbiting_list_soft(spec, qllrs,
                                                         list_size, wrap,
                                                         qmax)
    return _crc_select(crc, plain, cands)


def viterbi_decode_batch_tailbiting_punctured_crc(
        spec: CodeSpec, crc: CrcSpec, rx_qllrs, pattern, T: int,
        list_size: int = 8, wrap: int | None = None, qmax: int | None = None,
        device=None):
    """Depuncture (zero-LLR erasures), then
    `viterbi_decode_batch_tailbiting_crc_soft`.

    Args:
      rx_qllrs: int [B, kept] quantized LLRs of the sent bits in
        transmission order, cast to int8.
      pattern: (n, period) puncture pattern.
      T: trellis steps (message bits for k = 1) per packet.
    Returns (uint8 [B, T] bits, bool [B] CRC pass, int32 [B] chosen).
    """
    q = depuncture_llrs(as_tensor(rx_qllrs, device=device).to(torch.int8),
                        pattern, T)
    q = q.reshape(q.shape[0], T, spec.n)
    return viterbi_decode_batch_tailbiting_crc_soft(spec, crc, q, list_size,
                                                    wrap, qmax)


def viterbi_decode_batch_tailbiting_ratematched_crc(
        spec: CodeSpec, crc: CrcSpec, rx_qllrs, D: int, list_size: int = 8,
        wrap: int | None = None, qmax: int | None = None, device=None):
    """The LTE control-channel receive chain: 36.212 5.1.4.2
    de-rate-matching (repeated copies' LLRs added, never-sent bits zero),
    clipped to +-qmax, then `viterbi_decode_batch_tailbiting_crc_soft`.

    Args:
      rx_qllrs: int [B, E] quantized LLRs in transmission order; E is any
        channel-bit count (E < n D punctures, E > n D repeats).
      D: trellis steps (payload + CRC bits for k = 1) per block.
    Returns (uint8 [B, D] bits, bool [B] CRC pass, int32 [B] chosen).
    """
    qm = DEFAULT_QMAX if qmax is None else qmax
    q = derate_match(as_tensor(rx_qllrs, device=device), spec, D, qmax=qm)
    return viterbi_decode_batch_tailbiting_crc_soft(spec, crc, q, list_size,
                                                    wrap, qmax)
