"""Batched decode entry points and the one place that chooses a kernel.

Port of `viterbi_decode_batch` and `viterbi_decode_batch_bytes`
(convolutionalencdec_tpu/kernels/acs_pallas.py:329-384, :1556-1582).  The
JAX package re-derives its kernel choice in several places; here
`select_kernel` is the only rule, and every entry point asks it.
"""

from __future__ import annotations

import torch

from ..ops.viterbi import pad_and_pack, viterbi_decode
from ..params import CodeSpec
from .acs import acs_forward_batch, kernel_supports, traceback_batch

#: Route names of `select_kernel`.
BUTTERFLY = "butterfly"  # csrc/acs_k1.cu + csrc/traceback_k1.cu
GENERIC = "generic"      # no CUDA kernel yet: plain decoder on a CPU tensor


def select_kernel(spec: CodeSpec, mode: str = "hard") -> str:
    """The route that decodes `spec` in `mode`.

    BUTTERFLY: k = 1 poly-symmetric codes with 64 <= NS <= 256 (NASA_K7,
    REF_K7, NASA_K7_R13, LTE_TBCC_K7, K9_561_753) run the hand-written
    forward ACS and traceback kernels.  GENERIC: every other code decodes
    through the plain generic decoder on a CPU tensor and raises on a CUDA
    tensor until its kernel is ported.
    """
    if mode != "hard":
        raise NotImplementedError(
            f"mode {mode!r} is not ported yet (ROADMAP.md queue 1 item 6, "
            "soft decode)")
    return BUTTERFLY if kernel_supports(spec) else GENERIC


def _message_bits(spec: CodeSpec, T: int, message_bits: int | None) -> int:
    """The decoded bit count L: default and upper bound (T - S) * k."""
    full = (T - spec.S) * spec.k
    L = full if message_bits is None else message_bits
    if not 0 <= L <= full:
        raise ValueError(f"message_bits = {L} outside [0, (T - S) * k = "
                         f"{full}]")
    return L


def _decode(spec: CodeSpec, segments: torch.Tensor,
            message_bits: int | None, out: str) -> torch.Tensor:
    segments = torch.as_tensor(segments, dtype=torch.uint8)
    if segments.dim() != 2:
        raise ValueError("segments must be uint8 [B, T]")
    B, T = segments.shape
    if select_kernel(spec) == BUTTERFLY:
        L = _message_bits(spec, T, message_bits)
        decisions, _ = acs_forward_batch(spec, segments)
        return traceback_batch(spec, decisions, T, L, out=out)
    if segments.device.type != "cpu":
        raise NotImplementedError(
            f"no CUDA kernel decodes {spec} yet: it waits for the generic-k "
            "kernel (ROADMAP.md queue 1 item 12, TPU kernel K9) or the "
            "NS < 64 butterfly instantiation (queue 2, K12)")
    L = _message_bits(spec, T, message_bits)
    bits = viterbi_decode(spec, segments)[:, :L]
    return pad_and_pack(bits) if out == "bytes" else bits


def viterbi_decode_batch(spec: CodeSpec, segments: torch.Tensor,
                         message_bits: int | None = None) -> torch.Tensor:
    """Hard-decision block decode of a batch of terminated packets.

    Args:
      segments: uint8 [B, T] hard segments, T = L/k + S.
      message_bits: decoded bit count L; defaults to (T - S) * k.
    Returns uint8 [B, L] decoded message bits, bit-identical to the
    reference decoder `ops.viterbi.viterbi_decode`.
    """
    return _decode(spec, segments, message_bits, "bits")


def viterbi_decode_batch_bytes(spec: CodeSpec, segments: torch.Tensor,
                               message_bits: int | None = None
                               ) -> torch.Tensor:
    """Byte twin of `viterbi_decode_batch`: uint8 [B, ceil(L/8)], filled
    MSb-first with a zero-padded trailing byte.  On the BUTTERFLY route the
    traceback kernel emits the bytes itself."""
    return _decode(spec, segments, message_bits, "bytes")
