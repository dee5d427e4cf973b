"""Batched max-log-MAP LLRs of k=1 butterfly codes on the CUDA kernel.

`maxlogmap_llrs_batch_kernel` launches `maxlogmap_k1` in
`csrc/maxlogmap_k1.cu`, which replaces both TPU kernels of
`convolutionalencdec_tpu/kernels/maxlogmap_pallas.py` (the forward at
pallas_call :328 and the backward at :347) in one launch.  Its plain
version `maxlogmap_llrs_batch_plain` floors -128 at -127 and runs the scan
of `ops/maxlogmap.py`.  A CPU tensor takes the plain version; a CUDA tensor
launches the kernel or raises.  `LAUNCHES` counts the launches.

The kernel does the scan's arithmetic (BIG = 2^28, no renormalisation, beta
anchored at `starting_state`) less each step's sum of relu(-q), the same
for every edge of the step, whose total cancels in every LLR (the kernel
source's header), so it equals its plain version on every entry.  Against the JAX kernel it is equal on the message bits and on all
T entries when `terminated=False`; on the S termination steps of a
terminated packet the JAX kernel's 2^20 input penalties give other values
of the same sign.
"""

from __future__ import annotations

import torch

from .._device import as_tensor
from ..ops.maxlogmap import BIG, maxlogmap_llrs
from ..params import CodeSpec
from .acs import _butterfly_table, _check_device

#: Launches of the kernel since the count was last set to 0.
LAUNCHES = {"maxlogmap_k1": 0}

#: Steps per alpha checkpoint in the kernel (csrc/maxlogmap_k1.cu kChunk).
CHUNK = 32


def maxlogmap_supported(spec: CodeSpec) -> bool:
    """The JAX kernel's gate: k = 1, NS >= 64, poly symmetry."""
    return spec.k == 1 and spec.num_states >= 64 and spec.has_poly_symmetry


def _check_envelope(T: int, n: int) -> None:
    """int32 holds the scan's sums while every path cost stays below BIG:
    T n 128 < 2^28 (alpha, beta < 2^29, their sums < 2^30)."""
    if T * n * 128 >= BIG:
        raise ValueError(f"T = {T} steps of n = {n} LLRs leave the int32 "
                         "envelope of max-log-MAP (T n 128 < 2^28)")


def maxlogmap_llrs_batch_plain(spec: CodeSpec, qllrs: torch.Tensor,
                               terminated: bool = True) -> torch.Tensor:
    """Plain version of `maxlogmap_llrs_batch_kernel`: the -127 floor of
    the kernel entry, then the scan of `ops/maxlogmap.py`."""
    return maxlogmap_llrs(spec, torch.clamp_min(qllrs.to(torch.int32), -127),
                          terminated)


def maxlogmap_llrs_batch_kernel(spec: CodeSpec, qllrs,
                                terminated: bool = True,
                                device=None) -> torch.Tensor:
    """Batched max-log-MAP a-posteriori LLRs.

    Replaces `maxlogmap_llrs_batch_kernel` of
    convolutionalencdec_tpu/kernels/maxlogmap_pallas.py (pallas_calls :328
    and :347).

    Args:
      qllrs: int8 [B, T, n] quantized channel LLRs (other integer types
        are cast to int8); -128 is floored at -127, as the JAX kernel
        entry does.
      terminated: anchor beta at `starting_state` (the packets end in the
        S termination steps); False leaves the final state free.

    Returns:
      int32 [B, T] per-bit LLRs, positive favours bit 0; [:, :T - S] are
      the message bits' of a terminated packet.
    """
    if not maxlogmap_supported(spec):
        raise ValueError("max-log-MAP kernels require k=1, NS >= 64, poly "
                         "symmetry (use ops.maxlogmap for the rest)")
    qllrs = as_tensor(qllrs, device=device).to(torch.int8)
    if qllrs.dim() != 3:
        raise ValueError("qllrs must be [B, T, n]")
    B, T, n = qllrs.shape
    if n != spec.n:
        raise ValueError(f"qllrs last dim {n} != spec.n {spec.n}")
    _check_envelope(T, n)
    if not _check_device(qllrs):
        return maxlogmap_llrs_batch_plain(spec, qllrs, terminated)
    NS = spec.num_states
    if NS > 256 or n > 8:
        raise NotImplementedError(
            f"no CUDA kernel runs max-log-MAP of {spec}: the kernel takes "
            "NS = 64, 128, 256 and n <= 8")
    qllrs = qllrs.contiguous()
    out = torch.empty((B, T), dtype=torch.int32, device=qllrs.device)
    if B == 0 or T == 0:
        return out
    ckpt = torch.empty((B, -(-T // CHUNK), NS), dtype=torch.int32,
                       device=qllrs.device)
    from . import _build
    lib = _build.library()
    cb = _butterfly_table(spec, qllrs.device)
    code = lib.maxlogmap_k1(
        qllrs.data_ptr(), cb.data_ptr(), ckpt.data_ptr(), out.data_ptr(),
        B, T, NS, n, spec.starting_state, int(terminated),
        torch.cuda.current_stream(qllrs.device).cuda_stream)
    LAUNCHES["maxlogmap_k1"] += 1
    _build.check("maxlogmap_k1", code)
    return out
