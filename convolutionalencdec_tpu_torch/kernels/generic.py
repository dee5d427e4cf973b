"""Forward ACS and traceback of the generic-k block decode.

Every hard block decode of a code that is not a k = 1 poly-symmetric
butterfly (any rate-k/n code, and asymmetric k = 1 codes such as TOY_K3)
runs here.  Four wrappers, each with its plain PyTorch version beside it
(TPU kernels named by their function in convolutionalencdec_tpu/kernels/):

  * `acs_forward_batch_generic` launches `acs_generic_forward` in
    `csrc/acs_generic.cu` (replaces `acs_pallas.acs_forward_batch_generic`,
    pallas_call at acs_pallas.py:2004, kernel `_fwd_kernel_generic`);
  * `traceback_batch_generic` launches `traceback_generic`, same file
    (replaces `acs_pallas.traceback_batch_generic`, pallas_call :2039,
    kernel `_tb_kernel_generic`);
  * `acs_forward_batch_k2` launches `acs_generic_k2_forward`, same file
    (replaces `acs_k2.acs_forward_batch_k2`, pallas_call acs_k2.py:345);
  * `traceback_batch_k2` launches `traceback_generic_k2`, same file
    (replaces `acs_k2.traceback_batch_k2`, pallas_call acs_k2.py:531).

The k2 kernels are the generic kernels at k = 2 and NS = 64: on the TPU
the JAX package wrote a second kernel family for those codes to avoid a
per-step row interleave; on Hopper no interleave exists.  Both forward
entries launch one template instantiated at compile time for each admitted
(k, NS), so `acs_generic_k2_forward` runs the same kernel as
`acs_generic_forward` on a k = 2, 64-state code; so do the two traceback
entries with the walk template.

A wrapper takes its plain version only for a tensor on the CPU.  For a
CUDA tensor it launches its kernel or raises: nothing falls back.
`LAUNCHES` counts the launches of each kernel.

Decision planes: int32 [B, T, k, W] with W = ceil(NS / 32).  Bit b of the
decision index e chosen for state d at step t (the k shifted-out bits of
its source, the lowest e winning ties) is bit d % 32 of word d // 32 of
plane b; the bits of words past NS are 0.  For NS >= 32 that is one bit
per state, step and input bit, the reference's decision economy; for
NS < 32 each step's word holds NS live bits and 32 - NS zeros (TOY_K3: 4
of 32), where the reference packs 32 steps per word.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops.trellis import edge_coded_bits
from ..ops.viterbi import (hard_step_metrics, init_metric_value, pad_and_pack,
                           traceback_terminated, viterbi_forward)
from ..params import CodeSpec
from .acs import _check_device, bits_to_words

#: Launches of each kernel since the count was last set to 0.
LAUNCHES = {"acs_generic_forward": 0, "traceback_generic": 0,
            "acs_generic_k2_forward": 0, "traceback_generic_k2": 0}

#: The generic kernel's limits: the metrics of NS states sit in shared
#: memory; decision indices are uint8 in the reference decoders (k <= 8);
#: a hard segment is one byte (n <= 8).
MAX_STATES = 1024
MAX_K = 8


def generic_kernel_supports(spec: CodeSpec) -> bool:
    """Whether the generic kernels decode this spec: any code but a k = 1
    poly-symmetric butterfly (those are the butterfly kernels' codes), with
    NS <= 1024, k <= 8 and n <= 8."""
    return (not (spec.k == 1 and spec.has_poly_symmetry)
            and spec.num_states <= MAX_STATES and spec.k <= MAX_K
            and spec.n <= 8)


def k2_supported(spec: CodeSpec) -> bool:
    """The JAX package's rule for its k = 2 kernels (acs_k2.k2_supported):
    k = 2 and 64 states."""
    return spec.k == 2 and spec.num_states == 64


def _words(spec: CodeSpec) -> int:
    return (spec.num_states + 31) // 32


def pack_decisions_generic(spec: CodeSpec,
                           decisions: torch.Tensor) -> torch.Tensor:
    """uint8 [B, T, NS] decision indices -> int32 [B, T, k, W] decision
    planes (the layout in the module docstring)."""
    B, T, NS = decisions.shape
    W = _words(spec)
    d = torch.nn.functional.pad(decisions.to(torch.int32), (0, W * 32 - NS))
    shifts = torch.arange(spec.k, dtype=torch.int32, device=d.device)
    bits = ((d[:, :, None, :] >> shifts[:, None]) & 1).reshape(
        B, T, spec.k, W, 32)
    return bits_to_words(bits)


def unpack_decisions_generic(spec: CodeSpec,
                             planes: torch.Tensor) -> torch.Tensor:
    """int32 [B, T, k, W] decision planes -> uint8 [B, T, NS] decision
    indices."""
    B, T, k, W = planes.shape
    shifts = torch.arange(32, dtype=torch.int32, device=planes.device)
    bits = ((planes[..., None] >> shifts) & 1).reshape(B, T, k, W * 32)
    weights = 1 << torch.arange(k, dtype=torch.int32, device=planes.device)
    e = (bits[..., :spec.num_states] * weights[:, None]).sum(dim=2)
    return e.to(torch.uint8)


@functools.lru_cache(maxsize=None)
def edge_tables(spec: CodeSpec) -> tuple[np.ndarray, np.ndarray]:
    """(seg_d uint8 [NS], seg_e uint8 [2^k]): the coded segment of the edge
    from source (d >> k) | e << (S - 1) k into destination d is
    seg_d[d] ^ seg_e[e].

    The edge's delay register is d | e << S k, and each coded bit is the
    parity of the register under a generator mask, which is linear over
    XOR: so the segment splits into the destination's part (e = 0) and the
    decision's part (d = 0).  The kernels keep NS + 2^k bytes, not the
    2^k NS of the whole edge table."""
    ec = edge_coded_bits(spec)
    E = spec.num_edges_per_state
    d = np.arange(spec.num_states)
    e = np.arange(E)
    return ec[d & (E - 1), d >> spec.k], ec[0, e << ((spec.S - 1) * spec.k)]


@functools.lru_cache(maxsize=None)
def _edge_table(spec: CodeSpec, device: torch.device) -> torch.Tensor:
    """uint8 [NS + 2^k]: seg_d then seg_e, resident on `device`."""
    return torch.as_tensor(np.concatenate(edge_tables(spec)),
                           dtype=torch.uint8, device=device)


def _check_spec(spec: CodeSpec) -> None:
    if not generic_kernel_supports(spec):
        raise NotImplementedError(
            f"the generic-k kernels do not decode {spec}: they take codes "
            f"other than k = 1 poly-symmetric butterflies, with NS <= "
            f"{MAX_STATES}, k <= {MAX_K} and n <= 8 (butterfly codes decode "
            "on the butterfly kernels, kernels/acs.py)")


def _check_k2(spec: CodeSpec) -> None:
    if not k2_supported(spec):
        raise ValueError(f"the k = 2 kernels require k = 2 and 64 states, "
                         f"got k = {spec.k}, NS = {spec.num_states}")


def acs_forward_batch_generic_plain(spec: CodeSpec, segments: torch.Tensor):
    """Plain version of `acs_forward_batch_generic`: the reference any-k
    scan, its decisions packed into planes."""
    decisions, final_metrics = viterbi_forward(
        spec, hard_step_metrics(spec, segments))
    return pack_decisions_generic(spec, decisions), final_metrics


def _forward(spec: CodeSpec, segments: torch.Tensor, name: str):
    """The forward wrappers' shared body; `name` is the C entry point."""
    if segments.dtype != torch.uint8 or segments.dim() != 2:
        raise ValueError("segments must be uint8 [B, T]")
    _check_spec(spec)
    if not _check_device(segments):
        return acs_forward_batch_generic_plain(spec, segments)
    B, T = segments.shape
    NS, k = spec.num_states, spec.k
    init = init_metric_value(spec)
    if T * spec.n + init >= 2 ** 31:
        raise ValueError(f"T = {T} overflows int32 path metrics")
    segments = segments.contiguous()
    planes = torch.empty((B, T, k, _words(spec)), dtype=torch.int32,
                         device=segments.device)
    final_metrics = torch.empty((B, NS), dtype=torch.int32,
                                device=segments.device)
    if B == 0:
        return planes, final_metrics
    from . import _build
    lib = _build.library()
    table = _edge_table(spec, segments.device)
    code = getattr(lib, name)(
        segments.data_ptr(), table.data_ptr(), planes.data_ptr(),
        final_metrics.data_ptr(), B, T, k, NS, spec.n, (spec.S - 1) * k,
        init, torch.cuda.current_stream(segments.device).cuda_stream)
    LAUNCHES[name] += 1
    _build.check(name, code)
    return planes, final_metrics


def acs_forward_batch_generic(spec: CodeSpec, segments: torch.Tensor):
    """Forward 2^k-way ACS of a batch of hard-decision packets, any code of
    `generic_kernel_supports`.

    Replaces the TPU kernel `acs_forward_batch_generic`
    (convolutionalencdec_tpu/kernels/acs_pallas.py:1988, pallas_call
    :2004).  Destination d takes the least of m[(d >> k) | e << (S-1) k]
    plus the Hamming distance of the edge's coded bits to the received
    segment over e = 0 .. 2^k - 1; the lowest e wins ties.  Metrics start
    at 0 in state 0 and `init_metric_value(spec)` elsewhere and are int32,
    never renormalised.

    Args:
      segments: uint8 [B, T] hard n-bit segments.

    Returns:
      (decision planes int32 [B, T, k, ceil(NS/32)], final_metrics int32
      [B, NS] in natural state order).
    """
    return _forward(spec, segments, "acs_generic_forward")


def acs_forward_batch_k2_plain(spec: CodeSpec, segments: torch.Tensor):
    """Plain version of `acs_forward_batch_k2`."""
    _check_k2(spec)
    return acs_forward_batch_generic_plain(spec, segments)


def acs_forward_batch_k2(spec: CodeSpec, segments: torch.Tensor):
    """`acs_forward_batch_generic` for k = 2, 64-state codes, through the
    kernel instantiated for them.

    Replaces the TPU kernel `acs_forward_batch_k2`
    (convolutionalencdec_tpu/kernels/acs_k2.py:328, pallas_call :345).
    Raises ValueError unless `k2_supported(spec)`, as that kernel does.
    """
    _check_k2(spec)
    return _forward(spec, segments, "acs_generic_k2_forward")


def _check_planes(spec: CodeSpec, planes: torch.Tensor, out: str):
    """Validate a traceback's decision planes and output format; returns
    (B, T)."""
    if out not in ("bytes", "bits"):
        raise ValueError(f"out must be 'bytes' or 'bits', got {out!r}")
    if planes.dtype != torch.int32 or planes.dim() != 4:
        raise ValueError("decision planes must be int32 [B, T, k, W]")
    B, T, k, W = planes.shape
    if k != spec.k or W != _words(spec):
        raise ValueError(f"planes [.., .., {k}, {W}] do not match k = "
                         f"{spec.k}, NS = {spec.num_states}")
    return B, T


def traceback_batch_generic_plain(spec: CodeSpec, planes: torch.Tensor,
                                  t_actual: int, message_bits: int,
                                  out: str = "bytes") -> torch.Tensor:
    """Plain version of `traceback_batch_generic`: unpack the planes and
    run the reference traceback."""
    dec = unpack_decisions_generic(spec, planes[:, :t_actual])
    bits = traceback_terminated(spec, dec)[:, :message_bits]
    return pad_and_pack(bits) if out == "bytes" else bits


def _traceback(spec: CodeSpec, planes: torch.Tensor, t_actual: int,
               message_bits: int, out: str, name: str) -> torch.Tensor:
    """The traceback wrappers' shared body; `name` is the C entry point."""
    B, T = _check_planes(spec, planes, out)
    if not 0 <= t_actual <= T:
        raise ValueError(f"t_actual = {t_actual} outside [0, {T}]")
    full = (t_actual - spec.S) * spec.k
    if not 0 <= message_bits <= full:
        raise ValueError(f"message_bits = {message_bits} outside "
                         f"[0, (t_actual - S) * k = {full}]")
    _check_spec(spec)
    if not _check_device(planes):
        return traceback_batch_generic_plain(spec, planes, t_actual,
                                             message_bits, out)
    planes = planes.contiguous()
    width = (message_bits + 7) // 8 if out == "bytes" else message_bits
    result = torch.empty((B, width), dtype=torch.uint8, device=planes.device)
    if B == 0:
        return result
    from . import _build
    lib = _build.library()
    code = getattr(lib, name)(
        planes.data_ptr(), result.data_ptr(), B, T, t_actual, spec.k,
        spec.num_states, spec.S, message_bits, int(out == "bytes"),
        torch.cuda.current_stream(planes.device).cuda_stream)
    LAUNCHES[name] += 1
    _build.check(name, code)
    return result


def traceback_batch_generic(spec: CodeSpec, planes: torch.Tensor,
                            t_actual: int, message_bits: int,
                            out: str = "bytes") -> torch.Tensor:
    """Traceback from terminal state 0 over decision planes.

    Replaces the TPU kernel `traceback_batch_generic`
    (convolutionalencdec_tpu/kernels/acs_pallas.py:2021, pallas_call
    :2039) and the symbol expansion of `viterbi_decode_batch_generic`
    (:2073-2077).  The walk starts in state 0 at step t_actual - 1; at step
    t it emits the k input bits of the current state, MSb first, and moves
    to (cur >> k) | e << (S - 1) k.

    Args:
      planes: int32 [B, T, k, ceil(NS/32)] from `acs_forward_batch_generic`.
      t_actual: steps of the packet (<= T).
      message_bits: decoded bits to keep, at most (t_actual - S) * k.
      out: "bytes" for uint8 [B, ceil(message_bits/8)] (MSb-first, trailing
        byte zero-padded) or "bits" for uint8 [B, message_bits].
    """
    return _traceback(spec, planes, t_actual, message_bits, out,
                      "traceback_generic")


def traceback_batch_k2_plain(spec: CodeSpec, planes: torch.Tensor,
                             t_actual: int, message_bits: int,
                             out: str = "bytes") -> torch.Tensor:
    """Plain version of `traceback_batch_k2`."""
    _check_k2(spec)
    return traceback_batch_generic_plain(spec, planes, t_actual,
                                         message_bits, out)


def traceback_batch_k2(spec: CodeSpec, planes: torch.Tensor, t_actual: int,
                       message_bits: int, out: str = "bytes") -> torch.Tensor:
    """`traceback_batch_generic` for k = 2, 64-state codes, through the
    kernel instantiated for them.

    Replaces the TPU kernel `traceback_batch_k2`
    (convolutionalencdec_tpu/kernels/acs_k2.py:517, pallas_call :531) and
    the symbol expansion of `viterbi_decode_batch_k2` (:563-566).  Raises
    ValueError unless `k2_supported(spec)`.
    """
    _check_k2(spec)
    return _traceback(spec, planes, t_actual, message_bits, out,
                      "traceback_generic_k2")
