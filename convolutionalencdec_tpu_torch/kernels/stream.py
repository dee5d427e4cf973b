"""Streaming register-exchange decode of a chunk with carried state.

Two wrappers, each with its plain PyTorch version beside it, for one CUDA
kernel, `stream_k1_decode` in `csrc/stream_k1.cu`.  It replaces the TPU
kernel of `stream_decode_batch` and `stream_decode_batch_soft`
(convolutionalencdec_tpu/kernels/acs_pallas.py:1422 and :1487, pallas_calls
at :1457 and :1524).  The plain versions are the batched scan
`ops.viterbi.stream_scan` with the carried state converted to its
registers.

A wrapper takes its plain version only for a tensor on the CPU.  For a CUDA
tensor it launches the kernel or raises: nothing falls back.  The launches
are counted in `kernels.acs.LAUNCHES["stream_k1_decode"]`.

Carried state (`StreamState`): int32 metrics [B, NS] in natural state order,
and one int64 survivor register per state, bit j the symbol decoded j steps
ago along that state's survivor path, bits W and above zero (W <= 64).  One
64-bit word per state, instead of the TPU kernel's two int32 planes, keeps
a register in one value (the kernel reads the carried registers once and
builds the new ones from its decisions); the conversions to and from the
JAX package's two layouts are `stream_state_from_reference` and
`stream_state_to_reference`.  Every call returns the metrics minus each
channel's minimum, as the TPU kernel's renormalisation leaves them, so a
stream of any length stays inside int32.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .._device import as_tensor
from ..ops.metrics import soft_step_metrics
from ..ops.viterbi import (_initial_metrics, hard_metric_table,
                           stream_scan)
from ..params import CodeSpec
from .acs import LAUNCHES, _butterfly_table, _check_device, condition_qllrs

#: Carried metrics stay below this: each call leaves them with minimum 0
#: and a spread of at most max(init_metric_value, S n 127) < 2^14.  The
#: wrappers' overflow check counts on it.
STATE_METRIC_BOUND = 1 << 24


class StreamState(NamedTuple):
    """Carried decoder state of `stream_decode_batch(_soft)`."""
    metrics: torch.Tensor    # int32 [B, NS]
    registers: torch.Tensor  # int64 [B, NS], bit j = symbol j steps old


def _stream_code(spec: CodeSpec) -> bool:
    """The codes `stream_k1_decode` takes: k = 1 poly-symmetric,
    64 <= NS <= 256, n <= 8 (acs_soft_k1.cu's warp-per-channel
    instantiations)."""
    return (spec.k == 1 and spec.has_poly_symmetry
            and spec.num_states in (64, 128, 256) and spec.n <= 8)


def stream_kernel_supports(spec: CodeSpec, traceback_len: int = 0) -> bool:
    """Whether `stream_k1_decode` decodes this spec and window: k = 1
    poly-symmetric, 64 <= NS <= 256, n <= 8, with 2 <= W <= 64.  The block
    kernels take more codes (`kernels.acs.kernel_supports`); this kernel
    does not yet (ROADMAP.md queue 2: K5 at NS >= 512)."""
    W = traceback_len or spec.traceback_len
    return _stream_code(spec) and 2 <= W <= 64


def stream_state_init(spec: CodeSpec, batch: int,
                      device=None) -> StreamState:
    """Fresh carried state: the known-start metrics (0 at state 0,
    `init_metric_value(spec)` elsewhere) and zeroed registers, on `device`
    (default the CUDA card)."""
    device = torch.device("cuda" if device is None else device)
    metrics = _initial_metrics(spec, batch, None, device)
    registers = torch.zeros((batch, spec.num_states), dtype=torch.int64,
                            device=device)
    return StreamState(metrics, registers)


def _window(spec: CodeSpec, traceback_len: int) -> int:
    """W, checked: a register holds one bit per step, so k = 1 codes with
    2 <= W <= 64 only."""
    W = traceback_len or spec.traceback_len
    if spec.k != 1:
        raise ValueError(f"k = {spec.k}: the stream registers hold one bit "
                         "per step (k = 1 codes only)")
    if not 2 <= W <= 64:
        raise ValueError(f"traceback_len {W} outside [2, 64]")
    return W


def registers_to_symbols(registers: torch.Tensor, W: int) -> torch.Tensor:
    """int64 registers [B, NS] -> uint8 [B, NS, W] symbol registers, the
    newest in column 0 (the layout of `ops.streaming.DecoderState`)."""
    shifts = torch.arange(W, dtype=torch.int64, device=registers.device)
    return ((registers[..., None] >> shifts) & 1).to(torch.uint8)


def symbols_to_registers(symbols: torch.Tensor) -> torch.Tensor:
    """Inverse of `registers_to_symbols`."""
    W = symbols.shape[-1]
    shifts = torch.arange(W, dtype=torch.int64, device=symbols.device)
    return (symbols.to(torch.int64) << shifts).sum(dim=-1)


def _check_state(state: StreamState, B: int, NS: int, device) -> StreamState:
    m, r = state
    if (m.shape != (B, NS) or m.dtype != torch.int32 or m.device != device
            or r.shape != (B, NS) or r.dtype != torch.int64
            or r.device != device):
        raise ValueError("state must be int32 metrics and int64 registers "
                         "[B, NS] on the inputs' device")
    return StreamState(m.contiguous(), r.contiguous())


def _plain(spec: CodeSpec, step_metrics, T: int, state: StreamState,
           W: int):
    """The scan from the carried state; metrics renormalised at the end."""
    m, reg, symbols = stream_scan(spec, step_metrics, T, state.metrics,
                                  registers_to_symbols(state.registers, W))
    m = m - m.min(dim=1, keepdim=True).values
    return symbols, StreamState(m, symbols_to_registers(reg))


def stream_decode_batch_plain(spec: CodeSpec, segments: torch.Tensor,
                              state: StreamState, traceback_len: int = 0):
    """Plain version of `stream_decode_batch`: `ops.viterbi.stream_scan`
    over Hamming branch metrics."""
    W = _window(spec, traceback_len)
    table = hard_metric_table(spec, segments.device)
    seg = segments.long()
    return _plain(spec, lambda t: table[seg[:, t]], segments.shape[1], state,
                  W)


def stream_decode_batch_soft_plain(spec: CodeSpec, qllrs: torch.Tensor,
                                   state: StreamState,
                                   traceback_len: int = 0):
    """Plain version of `stream_decode_batch_soft`: `ops.viterbi.stream_scan`
    over soft branch metrics of the LLRs floored at -127."""
    W = _window(spec, traceback_len)
    q = condition_qllrs(qllrs, 127)
    return _plain(spec, lambda t: soft_step_metrics(spec, q[:, t]),
                  qllrs.shape[1], state, W)


def _launch(spec: CodeSpec, inputs: torch.Tensor, soft: bool,
            state: StreamState, W: int):
    B, T = inputs.shape[:2]
    NS = spec.num_states
    if not _stream_code(spec):
        raise NotImplementedError(
            f"no CUDA kernel stream-decodes {spec}: stream_k1_decode takes "
            "k = 1 poly-symmetric codes with 64 <= NS <= 256 and n <= 8 "
            "(ROADMAP.md queue 2: K5 at NS >= 512)")
    if T * spec.n * (127 if soft else 1) + STATE_METRIC_BOUND >= 2 ** 31:
        raise ValueError(f"T = {T} overflows int32 path metrics")
    inputs = inputs.contiguous()
    state = _check_state(state, B, NS, inputs.device)
    symbols = torch.empty((B, T), dtype=torch.uint8, device=inputs.device)
    out = StreamState(torch.empty_like(state.metrics),
                      torch.empty_like(state.registers))
    if B == 0:
        return symbols, out
    from . import _build
    lib = _build.library()
    cb = _butterfly_table(spec, inputs.device)
    code = lib.stream_k1_decode(
        inputs.data_ptr(), int(soft), cb.data_ptr(),
        state.metrics.data_ptr(), state.registers.data_ptr(),
        symbols.data_ptr(), out.metrics.data_ptr(), out.registers.data_ptr(),
        B, T, NS, spec.n, W,
        torch.cuda.current_stream(inputs.device).cuda_stream)
    LAUNCHES["stream_k1_decode"] += 1
    _build.check("stream_k1_decode", code)
    return symbols, out


def stream_decode_batch(spec: CodeSpec, segments: torch.Tensor,
                        state: StreamState, traceback_len: int = 0):
    """Streaming register-exchange decode of a chunk of hard segments.

    Args:
      segments: uint8 [B, T] hard segments, any T >= 0.
      state: the carried `StreamState` (from `stream_state_init`, a previous
        call or `stream_state_from_reference`) on the segments' device.
      traceback_len: W, 2 <= W <= 64 (default 5K): the decode delay.

    Returns (symbols uint8 [B, T], new state): symbols[:, t] is the
    sliding-window emit after chunk step t, the decoded symbol of global
    step count + t - (W - 1); only those with that index >= 0 are data
    (the caller counts steps).
    """
    if segments.dtype != torch.uint8 or segments.dim() != 2:
        raise ValueError("segments must be uint8 [B, T]")
    W = _window(spec, traceback_len)
    if not _check_device(segments):
        return stream_decode_batch_plain(spec, segments, state, W)
    return _launch(spec, segments, False, state, W)


def stream_decode_batch_soft(spec: CodeSpec, qllrs: torch.Tensor,
                             state: StreamState, traceback_len: int = 0):
    """Soft-decision `stream_decode_batch`.

    Args:
      qllrs: int8 [B, T, n] quantized LLRs, each used as max(q, -127) (the
        TPU kernel's `_as_int8_qllrs` floor; no clip).
    Returns (symbols uint8 [B, T], new state), as `stream_decode_batch`.
    """
    if (qllrs.dtype != torch.int8 or qllrs.dim() != 3
            or qllrs.shape[2] != spec.n):
        raise ValueError(f"qllrs must be int8 [B, T, n = {spec.n}]")
    W = _window(spec, traceback_len)
    if not _check_device(qllrs):
        return stream_decode_batch_soft_plain(spec, qllrs, state, W)
    return _launch(spec, qllrs, True, state, W)


def stream_state_from_reference(reference, traceback_len: int,
                                device=None) -> StreamState:
    """A `StreamState` from the JAX package's carried state, given as numpy
    arrays in either of its layouts:

      * the TPU kernel's int32 [3, NS, B]: metrics, then the register planes
        `lo` (bit j = symbol j steps old) and `hi` (bit j = symbol 32 + j
        steps old), as `stream_state_init` and `stream_decode_batch` of the
        JAX package give them;
      * the JAX `StreamingDecoderBatch`'s pair (metrics [B, NS], registers
        uint8 [B, NS, W], the newest symbol in column 0).

    The metrics are taken minus each channel's minimum (decisions depend on
    differences only) and the registers to their W bits.  `device` defaults
    to the CUDA card.
    """
    W = traceback_len
    if not 2 <= W <= 64:
        raise ValueError(f"traceback_len {W} outside [2, 64]")
    if isinstance(reference, (tuple, list)):
        metrics = np.asarray(reference[0], np.int64)
        symbols = np.asarray(reference[1])
        if symbols.shape != metrics.shape + (W,):
            raise ValueError(f"registers must be [B, NS, W = {W}]")
        words = (symbols.astype(np.uint64)
                 << np.arange(W, dtype=np.uint64)).sum(axis=-1,
                                                       dtype=np.uint64)
    else:
        planes = np.asarray(reference)
        if planes.ndim != 3 or planes.shape[0] != 3:
            raise ValueError("kernel state must be int32 [3, NS, B]")
        metrics = planes[0].T.astype(np.int64)
        lo = planes[1].T.astype(np.uint32).astype(np.uint64)
        hi = planes[2].T.astype(np.uint32).astype(np.uint64)
        words = lo | (hi << np.uint64(32)) if W > 32 else lo
    if W < 64:
        words = words & np.uint64((1 << W) - 1)
    if metrics.size:
        metrics = metrics - metrics.min(axis=1, keepdims=True)
        if metrics.max() >= STATE_METRIC_BOUND:
            raise ValueError("metric spread beyond STATE_METRIC_BOUND")
    return StreamState(
        as_tensor(metrics.astype(np.int32), torch.int32, device),
        as_tensor(np.ascontiguousarray(words).view(np.int64), torch.int64,
                  device))


def stream_state_to_reference(state: StreamState, traceback_len: int,
                              layout: str = "kernel"):
    """Inverse of `stream_state_from_reference`, to numpy: `layout="kernel"`
    gives int32 [3, NS, B] (the `hi` plane zero when W <= 32, as the TPU
    kernel writes it), `layout="class"` the pair (metrics int32 [B, NS],
    registers uint8 [B, NS, W])."""
    W = traceback_len
    metrics = state.metrics.cpu().numpy()
    if layout == "class":
        return metrics, registers_to_symbols(state.registers.cpu(), W).numpy()
    if layout != "kernel":
        raise ValueError(f"layout must be 'kernel' or 'class', got {layout!r}")
    words = state.registers.cpu().numpy().view(np.uint64)
    lo = (words & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
    hi = (words >> np.uint64(32)).astype(np.uint32).view(np.int32)
    if W <= 32:
        hi = np.zeros_like(hi)
    return np.stack([metrics.T, lo.T, hi.T]).astype(np.int32)
