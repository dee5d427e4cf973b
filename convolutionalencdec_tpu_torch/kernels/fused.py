"""The JAX package's names of its fused butterfly kernels (TPU kernel K11),
on the port's butterfly wrappers.

`convolutionalencdec_tpu.kernels` exports `acs_forward_batch_fused`,
`acs_forward_batch_fused_soft`, `traceback_batch_fused` and
`traceback_batch_fused_masked` (acs_pallas.py:976-1152): the int32
3-stage kernels for NS >= 64.  Here they are thin entries over
`kernels.acs`, which launches the kernel of the code's size (K1 / K4 at
NS 64..256, the wide forward and walk beyond), with the JAX parameters in
the JAX order (less `interpret`).  Two things differ, by design:

  * decisions are the port's int32 words [B, T, ceil(NS/32)]
    (`kernels.acs`), not the TPU kernels' per-stage bytes [T/8, NS, B];
    only these functions read them;
  * final metrics are int32 [B, NS] less each channel's minimum: the TPU
    kernel's [NS, B], transposed (it renormalises at every chunk end, so
    its minimum is 0 too).

What JAX's `init_chunk` means is kept: 0 starts from the standard metrics
(0 at state 0, `init_metric_value` elsewhere), -1 (any negative) from
uniform (all-zero) metrics, and c > 0 from uniform metrics with the
standard ones applied at step CHUNK_F * c (the first block of a
time-sharded stream, whose left halo is discarded).
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import as_tensor
from ..params import CodeSpec
from .acs import (_check_words, acs_forward_batch, acs_forward_batch_soft,
                  traceback_batch_masked)

#: The TPU kernels' forward chunk (steps) and emit group (steps per byte).
CHUNK_F = 48
PACK = 8


def _check_fused_spec(spec: CodeSpec) -> None:
    spec.validate_for_butterfly()
    if spec.num_states < 64:
        raise ValueError("fused kernel requires >= 64 states")


def _fused_forward(spec: CodeSpec, x: torch.Tensor, init_chunk: int,
                   forward):
    """`forward(x, initial_metrics)` under JAX's `init_chunk` rule; the
    final metrics less each channel's minimum."""
    _check_fused_spec(spec)
    B, T = x.shape[:2]
    init_chunk = int(init_chunk)
    if init_chunk == 0:
        words, fm = forward(x, None)
    else:
        cut = T if init_chunk < 0 else min(CHUNK_F * init_chunk, T)
        uniform = torch.zeros((B, spec.num_states), dtype=torch.int32,
                              device=x.device)
        words, fm = forward(x[:, :cut], uniform)
        if cut < T:
            rest, fm = forward(x[:, cut:], None)
            words = torch.cat([words, rest], dim=1)
    if B:
        fm = fm - fm.min(dim=1, keepdim=True).values
    return words, fm


def acs_forward_batch_fused(spec: CodeSpec, segments, init_chunk=0,
                            device=None):
    """Forward ACS of hard segments under JAX's start rule.

    Port of acs_pallas.acs_forward_batch_fused (:976, pallas_call :1004).

    Args:
      segments: uint8 [B, T] hard segments, any T (JAX pads T to a multiple
        of CHUNK_F).
      init_chunk: 0 (standard start), negative (uniform start) or c > 0
        (uniform, the standard metrics applied at step CHUNK_F * c).
      device: where a non-tensor `segments` goes (default the card).

    Returns:
      (decisions int32 [B, T, ceil(NS/32)] words of `kernels.acs`,
      final_metrics int32 [B, NS] less each channel's minimum).
    """
    segments = as_tensor(segments, torch.uint8, device)
    return _fused_forward(
        spec, segments, init_chunk,
        lambda x, init: acs_forward_batch(spec, x.contiguous(), init))


def acs_forward_batch_fused_soft(spec: CodeSpec, qllrs, init_chunk=0,
                                 device=None):
    """Soft twin of `acs_forward_batch_fused`: int8 [B, T, n] quantized
    LLRs, any n, -128 floored at -127 and no other clip, as JAX's
    `_as_int8_qllrs` (acs_pallas.py:1123).  Port of
    acs_pallas.acs_forward_batch_fused_soft (:1109, pallas_call :1134)."""
    qllrs = as_tensor(qllrs, device=device).to(torch.int8)
    return _fused_forward(
        spec, qllrs, init_chunk,
        lambda x, init: acs_forward_batch_soft(spec, x.contiguous(), 127,
                                               init))


def _rows(bits: torch.Tensor) -> torch.Tensor:
    """uint8 bits [B, T], T % 8 == 0 -> JAX's packed rows uint8 [T/8, B]:
    bit j of row g is step 8g + j."""
    B, T = bits.shape
    weights = torch.tensor([1 << j for j in range(PACK)], dtype=torch.int32,
                           device=bits.device)
    packed = (bits.reshape(B, T // PACK, PACK).to(torch.int32)
              * weights).sum(dim=-1)
    return packed.to(torch.uint8).T.contiguous()


def _check_rows(spec: CodeSpec, decisions: torch.Tensor) -> tuple[int, int]:
    _check_fused_spec(spec)
    B, T = _check_words(spec, decisions, "bits")
    if T % PACK:
        raise ValueError(f"T = {T} is not a multiple of {PACK}: the rows "
                         "pack 8 steps each")
    return B, T


def live_prefix(gmask, TG: int) -> int:
    """The live steps of JAX's per-group byte masks int32 [TG, 1]: 0xFF
    for TG0 groups, at most one partial 2^r - 1 (r < 8), then 0, as every
    JAX caller builds them (`_group_masks`, acs_pallas.py:1025;
    kernels/tailbiting.py:116; parallel/sharding.py:389-392).  Any other
    mask raises ValueError."""
    gm = (gmask.cpu().numpy() if isinstance(gmask, torch.Tensor)
          else np.asarray(gmask)).astype(np.int64).reshape(-1)
    if gm.shape != (TG,):
        raise ValueError(f"gmask must hold one mask per 8-step group: "
                         f"[{TG}, 1]")
    full = int(np.argmin(gm == 0xFF)) if (gm != 0xFF).any() else TG
    live = PACK * full
    rest = gm[full:]
    if rest.size and rest[0] != 0:
        r = int(rest[0]).bit_length()
        if rest[0] != (1 << r) - 1 or r >= PACK:
            raise ValueError(f"gmask group {full} = {int(rest[0])} is not a "
                             "live prefix 2^r - 1")
        live += r
        rest = rest[1:]
    if rest.any():
        raise ValueError("gmask must be a live prefix: 0xFF groups, at most "
                         "one partial 2^r - 1, then 0")
    return live


def traceback_batch_fused_masked(spec: CodeSpec, decisions, gmask,
                                 h_init) -> torch.Tensor:
    """Traceback from a one-hot start over a live prefix of the steps.

    Port of acs_pallas.traceback_batch_fused_masked (:1038, pallas_call
    :1069), on `kernels.acs.traceback_batch_masked`.

    Args:
      decisions: int32 [B, T, ceil(NS/32)] words from
        `acs_forward_batch_fused(_soft)`, T a multiple of 8.
      gmask: int32 [T/8, 1] per-group byte masks, a live prefix
        (`live_prefix`); steps past it count as decision 0.
      h_init: uint8 [NS, B] one-hot walk start at step T - 1 (a tensor on
        the decisions' device, or an array, which goes there).

    Returns uint8 [T/8, B]: bit j of row g is the bit of step 8g + j.
    """
    B, T = _check_rows(spec, decisions)
    live = live_prefix(gmask, T // PACK)
    h = as_tensor(h_init, device=decisions.device)
    if h.device != decisions.device:
        raise ValueError("h_init must be on the decisions' device")
    if h.shape != (spec.num_states, B):
        raise ValueError(f"h_init must be [NS = {spec.num_states}, B = {B}]")
    if B and not (((h == 0) | (h == 1)).all() and (h.sum(dim=0) == 1).all()):
        raise ValueError("h_init must be one-hot in every column")
    start = torch.argmax(h.to(torch.int32), dim=0).to(torch.int32)
    bits = traceback_batch_masked(spec, decisions, start, live, T, "bits")
    return _rows(bits)


def traceback_batch_fused(spec: CodeSpec, decisions,
                          t_actual: int) -> torch.Tensor:
    """Traceback of terminated packets from state 0: port of
    acs_pallas.traceback_batch_fused (:1092), the masked walk with the
    first `t_actual` steps live (0 < t_actual <= T).  Returns uint8
    [T/8, B] rows as `traceback_batch_fused_masked`."""
    B, T = _check_rows(spec, decisions)
    if not 0 < t_actual <= T:
        raise ValueError(f"t_actual={t_actual} outside (0, {T}]")
    start = torch.zeros(B, dtype=torch.int32, device=decisions.device)
    bits = traceback_batch_masked(spec, decisions, start, int(t_actual), T,
                                  "bits")
    return _rows(bits)
