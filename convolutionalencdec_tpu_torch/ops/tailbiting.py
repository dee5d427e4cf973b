"""Tail-biting convolutional codes: encoder and plain decoders.

Port of `convolutionalencdec_tpu/ops/tailbiting.py`, batched over a leading
B.  A tail-biting encoder starts in the state formed by the message's last
k S bits, so it ends in the same state and the trellis path is circular:
no termination steps, rate exactly k/n (LTE PBCH/PDCCH, IEEE 802.16).

Decoders:

* `viterbi_decode_tailbiting(_soft)`: the wrap decode.  One forward pass
  over the circular extension [last wl steps ++ packet ++ first wr steps]
  from all-zero (uniform) metrics, traceback from the lowest state of least
  final metric, keep the middle.  Survivors merge within ~5K steps, so it
  differs from the ML decoder only where they fail to merge in the wrap.
* `viterbi_decode_tailbiting_list(_soft)`: the list decode over a left-only
  extension, one candidate per end state in (final metric, state) order.
* `viterbi_decode_tailbiting_exact`: the ML oracle, one constrained Viterbi
  per start state; a test reference.

These are the plain versions behind the kernel routes of
`kernels/tailbiting.py` and the decoders of the codes the kernels do not
take (k > 1, NS < 64).  Every function takes `device=None`: a tensor input
keeps its device, any other input goes to `device` (default the card).
"""

from __future__ import annotations

import torch

from .._device import as_tensor
from ..params import CodeSpec
from .encode import encode_bits
from .metrics import soft_step_metrics
from .viterbi import (hard_step_metrics, one_packet, traceback_terminated,
                      viterbi_forward, viterbi_forward_butterfly)

#: Exclusion metric of the exact oracle: above any real path metric while
#: T n < 2^20.
_EXACT_BIG = 1 << 20


def tail_state(spec: CodeSpec, bits, device=None) -> torch.Tensor:
    """Tail-biting initial (= final) state of bits [..., L]: the last k S
    bits, the newest at bit 0.  Returns int32 [...]."""
    bits = as_tensor(bits, device=device)
    kS = spec.k * spec.S
    tail = bits[..., bits.shape[-1] - kS:].to(torch.int32)
    w = 1 << torch.arange(kS - 1, -1, -1, dtype=torch.int32,
                          device=bits.device)
    return (tail * w).sum(dim=-1, dtype=torch.int32)


def default_wrap(spec: CodeSpec) -> int:
    """Default circular wrap in trellis steps: 6K, past the ~5K
    survivor-merge rule (and always > S)."""
    return 6 * spec.K


def encode_tailbiting(spec: CodeSpec, bits, device=None) -> torch.Tensor:
    """Tail-biting encode of bits [..., L] (L a multiple of k, at least
    k S): no flush, the encoder starts in the tail state and so ends there.
    Returns uint8 [..., L/k] segments."""
    bits = as_tensor(bits, torch.uint8, device)
    L = bits.shape[-1]
    if L % spec.k:
        raise ValueError(f"bit count {L} not a multiple of k={spec.k}")
    if L < spec.k * spec.S:
        raise ValueError(
            f"tail-biting needs at least k*S={spec.k * spec.S} message bits "
            f"to define the wrap state; got {L}")
    seg, _ = encode_bits(spec, bits, terminate=False,
                         initial_state=tail_state(spec, bits))
    return seg


def normalize_wrap(spec: CodeSpec, wrap) -> tuple[int, int]:
    """(wl, wr) of a wrap given as None (`default_wrap` both sides), an int
    (both sides) or a pair."""
    if wrap is None:
        w = default_wrap(spec)
        return w, w
    if isinstance(wrap, int):
        return wrap, wrap
    wl, wr = wrap
    return int(wl), int(wr)


def circular_extend(x: torch.Tensor, wl: int, wr: int,
                    axis: int = -1) -> torch.Tensor:
    """[..., T, ...] -> the circular extension along `axis`: `wl` wrapped
    steps before and `wr` after (indices taken mod T when a wrap exceeds
    T)."""
    T = x.shape[axis]
    if 0 <= wl <= T and 0 <= wr <= T:
        return torch.cat([x.narrow(axis, T - wl, wl), x,
                          x.narrow(axis, 0, wr)], dim=axis)
    idx = torch.arange(-wl, T + wr, device=x.device) % T
    return torch.index_select(x, axis, idx)


def _uniform(spec: CodeSpec, device) -> torch.Tensor:
    return torch.zeros(spec.num_states, dtype=torch.int32, device=device)


def _hard_forward(spec: CodeSpec, ext: torch.Tensor, initial_metrics):
    """Decisions and final metrics of hard segments [B, T]: the butterfly
    for k = 1 poly-symmetric codes, the generic ACS otherwise."""
    if spec.k == 1 and spec.has_poly_symmetry:
        return viterbi_forward_butterfly(spec, ext, initial_metrics)
    return viterbi_forward(spec, hard_step_metrics(spec, ext),
                           initial_metrics=initial_metrics)


def _wrap_traceback(spec: CodeSpec, decisions, fm, wl: int, T: int):
    """Traceback of every channel from its lowest state of least final
    metric, every step live; the bits of steps [wl, wl + T)."""
    start = torch.argmin(fm, dim=1)                # ties -> lowest state
    bits = traceback_terminated(spec, decisions, num_pad=0,
                                start_states=start)
    return bits[:, wl * spec.k:(wl + T) * spec.k]


@one_packet(2)
def viterbi_decode_tailbiting(spec: CodeSpec, segments, wrap=None,
                              device=None) -> torch.Tensor:
    """Circular wrap decode of tail-biting packets (hard decision).

    Args:
      segments: uint8 [B, T] hard n-bit segments (T = L/k).
      wrap: wrap length in steps, an int (both sides) or (wl, wr); default
        `default_wrap(spec)`.
    Returns uint8 [B, T k] decoded message bits.
    """
    segments = as_tensor(segments, torch.uint8, device)
    T = segments.shape[-1]
    wl, wr = normalize_wrap(spec, wrap)
    ext = circular_extend(segments, wl, wr)
    decisions, fm = _hard_forward(spec, ext, _uniform(spec, ext.device))
    return _wrap_traceback(spec, decisions, fm, wl, T)


@one_packet(3)
def viterbi_decode_tailbiting_soft(spec: CodeSpec, qllrs, wrap=None,
                                   device=None) -> torch.Tensor:
    """Circular wrap decode of quantized LLRs [B, T, n] (used as they are:
    no floor, no clip; zero is an erasure).  Returns uint8 [B, T k]."""
    qllrs = as_tensor(qllrs, torch.int32, device)
    T = qllrs.shape[-2]
    wl, wr = normalize_wrap(spec, wrap)
    ext = circular_extend(qllrs, wl, wr, axis=-2)
    decisions, fm = viterbi_forward(spec, soft_step_metrics(spec, ext),
                                    initial_metrics=_uniform(spec,
                                                             ext.device))
    return _wrap_traceback(spec, decisions, fm, wl, T)


def list_candidates(fm: torch.Tensor, list_size: int):
    """The `list_size` best end states of each channel by (final metric,
    state): (states int32 [B, list_size], their metrics).  A stable sort
    keeps the lowest state first among equal metrics, as argmin does, so
    candidate 0 is the wrap decode's start."""
    metrics, states = torch.sort(fm, dim=1, stable=True)
    return (states[:, :list_size].to(torch.int32),
            metrics[:, :list_size])


def check_list_size(spec: CodeSpec, list_size: int) -> None:
    if not 1 <= list_size <= spec.num_states:
        raise ValueError(f"list_size {list_size} must be in "
                         f"[1, num_states={spec.num_states}]: there is one "
                         "candidate per trellis end state")


def _list_from_forward(spec: CodeSpec, decisions, fm, list_size: int,
                       wl: int, T: int):
    """Shared list epilogue: each of the `list_size` best end states traced
    back on its own.

    The list decodes extend on the left only: with observations past the
    message end, tracebacks from different end states would merge inside a
    right wrap and every candidate would decode the same message.  Ending
    the trellis at the message end keeps them distinct over the last ~5K
    bits, the region an outer CRC decides.

    Returns (bits uint8 [B, list_size, T k], metrics int32 [B, list_size]).
    """
    B, Te, NS = decisions.shape
    states, metrics = list_candidates(fm, list_size)
    dec = decisions.repeat_interleave(list_size, dim=0)
    bits = traceback_terminated(spec, dec, num_pad=0,
                                start_states=states.reshape(-1))
    bits = bits[:, wl * spec.k:(wl + T) * spec.k]
    return bits.reshape(B, list_size, T * spec.k), metrics


@one_packet(2)
def viterbi_decode_tailbiting_list(spec: CodeSpec, segments,
                                   list_size: int = 4, wrap: int | None = None,
                                   device=None):
    """List wrap decode (hard decision): the `list_size` best circular
    paths of each packet, one per end state in (final metric, state) order.
    Candidate 0 is the wrap decode at wrap (wl, 0).

    Args:
      segments: uint8 [B, T] hard segments.
      wrap: the left wrap (warm-up) in steps, default `default_wrap`; the
        trellis ends at the message end (see `_list_from_forward`).
    Returns (uint8 [B, list_size, T k] candidate bits, int32 [B, list_size]
    final metrics, ascending).
    """
    check_list_size(spec, list_size)
    segments = as_tensor(segments, torch.uint8, device)
    T = segments.shape[-1]
    wl = default_wrap(spec) if wrap is None else int(wrap)
    ext = circular_extend(segments, wl, 0)
    decisions, fm = _hard_forward(spec, ext, _uniform(spec, ext.device))
    return _list_from_forward(spec, decisions, fm, list_size, wl, T)


@one_packet(3)
def viterbi_decode_tailbiting_list_soft(spec: CodeSpec, qllrs,
                                        list_size: int = 4,
                                        wrap: int | None = None,
                                        device=None):
    """Soft-decision twin of `viterbi_decode_tailbiting_list`: quantized
    LLRs [B, T, n] in, `list_size` candidates out; `wrap` is the left
    wrap."""
    check_list_size(spec, list_size)
    qllrs = as_tensor(qllrs, torch.int32, device)
    T = qllrs.shape[-2]
    wl = default_wrap(spec) if wrap is None else int(wrap)
    ext = circular_extend(qllrs, wl, 0, axis=-2)
    decisions, fm = viterbi_forward(spec, soft_step_metrics(spec, ext),
                                    initial_metrics=_uniform(spec,
                                                             ext.device))
    return _list_from_forward(spec, decisions, fm, list_size, wl, T)


@one_packet(2)
def viterbi_decode_tailbiting_exact(spec: CodeSpec, segments,
                                    device=None) -> torch.Tensor:
    """ML tail-biting decode (a test oracle): the best circular path over
    NS constrained Viterbi passes, pass s starting at 0 in state s and at
    2^20 elsewhere and scored by its final metric in state s; ties go to the
    lowest s.  Returns uint8 [B, T k]."""
    segments = as_tensor(segments, torch.uint8, device)
    B, T = segments.shape
    if T * spec.n >= _EXACT_BIG:
        # The exclusion constant must exceed every real path metric, or a
        # path from an excluded start could undercut a true circular one.
        raise ValueError(
            f"packet too long for the exact oracle: T*n = {T * spec.n} "
            f">= 2^20 exclusion scale (use the wrap decoder)")
    bm = hard_step_metrics(spec, segments)
    NS = spec.num_states
    dev = segments.device
    rows = torch.arange(B, device=dev)
    scores = torch.empty((B, NS), dtype=torch.int32, device=dev)
    for s in range(NS):
        init = torch.full((NS,), _EXACT_BIG, dtype=torch.int32, device=dev)
        init[s] = 0
        _, fm = viterbi_forward(spec, bm, initial_metrics=init)
        scores[:, s] = fm[:, s]
    best = torch.argmin(scores, dim=1)
    # Run each channel's winning pass again for its decisions.
    init = torch.full((B, NS), _EXACT_BIG, dtype=torch.int32, device=dev)
    init[rows, best] = 0
    decisions, _ = viterbi_forward(spec, bm, initial_metrics=init)
    return traceback_terminated(spec, decisions, num_pad=0,
                                start_states=best)
