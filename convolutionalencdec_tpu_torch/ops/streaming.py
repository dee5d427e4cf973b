"""Chunked streaming encode and decode with explicit carried state.

Port of `convolutionalencdec_tpu/ops/streaming.py`.  The reference C
codebase's codec is streaming-stateful: its encoder carries partial-byte
and shift-register state between calls, and its decoder carries metrics and
the traceback across `viterbiDecoderHard` calls until `last=true`
(viterbiDecoder.h:128-145).  Receivers use this seam to decode continuous
links chunk by chunk at a fixed decode delay instead of buffering whole
packets.

  * `DecoderState`, `decoder_init`, `decode_chunk(_soft)`, `decode_flush`:
    the sliding-window register-exchange decoder as plain tensor scans
    (`ops.viterbi.stream_scan`), batched over a leading B.
  * `StreamingEncoder`, `StreamingDecoder`: the stateful one-channel
    conveniences.
  * `StreamingDecoderBatch`: B channels at a fixed decode delay W, on the
    streaming kernel (`kernels.stream`, TPU kernel K5) where it applies.
  * `BlockStreamingDecoderBatch`: B channels at block-kernel speed, exact
    carried-metric continuation through the block forwards and the masked
    traceback (`kernels.acs`), emitting in 48-step units.

Every stateful class takes `device=None` (default the CUDA card; "cpu" for
the tests), keeps its carried state there and returns tensors there: a call
forces no host synchronisation.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from .._device import as_tensor
from ..kernels.acs import (acs_forward_batch, acs_forward_batch_soft,
                           condition_qllrs, traceback_batch,
                           traceback_batch_masked)
from ..kernels.decode import (soft_qclip, swar_layout_supported,
                              swar_supported)
from ..kernels.stream import (StreamState, registers_to_symbols,
                              stream_decode_batch, stream_decode_batch_soft,
                              stream_state_init)
from ..params import CodeSpec
from .bits import pack_bits
from .encode import encode_bits
from .metrics import DEFAULT_QMAX, soft_step_metrics
from .viterbi import (_initial_metrics, hard_metric_table, pad_and_pack,
                      stream_scan, symbols_to_bits)

#: Emission granularity of `BlockStreamingDecoderBatch`: it forwards and
#: emits whole chunks of this many steps (the JAX package's kernel chunk,
#: kept so that every call returns the JAX class's bits).
CHUNK_F = 48


class DecoderState(NamedTuple):
    """Carried decoder state between chunks (the reference's node metrics,
    traceback and iteration count as an explicit value)."""
    metrics: torch.Tensor    # int32 [B, NS]
    registers: torch.Tensor  # uint8 [B, NS, W] survivor symbols, newest first
    count: int               # trellis steps consumed so far


def decoder_init(spec: CodeSpec, traceback_len: int = 0, batch: int = 1,
                 device=None) -> DecoderState:
    """Fresh state of `batch` channels on `device` (default the CUDA
    card)."""
    W = traceback_len or spec.traceback_len
    device = torch.device("cuda" if device is None else device)
    return DecoderState(
        _initial_metrics(spec, batch, None, device),
        torch.zeros((batch, spec.num_states, W), dtype=torch.uint8,
                    device=device), 0)


def decode_chunk(spec: CodeSpec, state: DecoderState, segments,
                 traceback_len: int = 0):
    """Consume a chunk of hard segments [B, T'], emitting one symbol per
    step (the reference's streaming emit).

    Returns (new_state, symbols uint8 [B, T'], valid bool [T']): symbols[:,
    t] is the decoded k-bit symbol of global step count + t - (W - 1),
    valid where that index is >= 0.
    """
    segments = as_tensor(segments, torch.uint8, state.metrics.device)
    table = hard_metric_table(spec, segments.device)
    seg = segments.long()
    return _decode_chunk_from_bm(spec, state, lambda t: table[seg[:, t]],
                                 segments.shape[1], traceback_len)


def decode_chunk_soft(spec: CodeSpec, state: DecoderState, qllrs,
                      traceback_len: int = 0):
    """Soft-decision `decode_chunk`: quantized-LLR branch costs
    (`ops.metrics.soft_step_metrics`, the LLRs used as they are) with the
    same streaming emit.  `qllrs`: int [B, T', n]."""
    qllrs = as_tensor(qllrs, torch.int32, state.metrics.device)
    return _decode_chunk_from_bm(
        spec, state, lambda t: soft_step_metrics(spec, qllrs[:, t]),
        qllrs.shape[1], traceback_len)


def _decode_chunk_from_bm(spec: CodeSpec, state: DecoderState, step_metrics,
                          T: int, traceback_len: int):
    W = traceback_len or spec.traceback_len
    m, reg, symbols = stream_scan(spec, step_metrics, T, state.metrics,
                                  state.registers)
    idx = state.count + torch.arange(T, device=m.device)
    return DecoderState(m, reg, state.count + T), symbols, idx >= W - 1


def decode_flush(spec: CodeSpec, state: DecoderState,
                 traceback_len: int = 0) -> torch.Tensor:
    """Terminate the packet: the undecoded window from state 0's register,
    the S pad steps dropped.

    Returns uint8 [B, W - 1 - S] symbols, oldest first.  When fewer than
    W - 1 steps were ever consumed, the leading W - 1 - count entries are
    register-init filler, not data: the stateful classes trim them; raw
    callers must do the same.
    """
    W = traceback_len or spec.traceback_len
    return state.registers[:, 0, spec.S:W - 1].flip(1)


def _filler(W: int, count: int) -> int:
    """Leading flush entries that are register-init filler after `count`
    consumed steps."""
    return max(0, W - 1 - count)


@dataclasses.dataclass
class StreamingEncoder:
    """Stateful chunked encoder (the reference's convEnc seam)."""
    spec: CodeSpec
    device: torch.device | str | None = None

    def __post_init__(self):
        self.reset()

    def encode(self, bits, last: bool = False) -> torch.Tensor:
        """Encode a chunk of bits [..., L]; with `last`, terminate the
        packet and start the next one from state 0.  Returns uint8
        segments [..., T]."""
        bits = as_tensor(bits, torch.uint8, self.device)
        segs, st = encode_bits(self.spec, bits, terminate=last,
                               initial_state=self._state)
        if last:
            self.reset()
        else:
            self._state = st
        return segs

    def reset(self):
        self._state = self.spec.starting_state


@dataclasses.dataclass
class StreamingDecoder:
    """Stateful chunked sliding-window decoder of one channel (decode delay
    = traceback_len), resetting at `last` like the reference.

    Caller contract (enforced): one packet per `last=True` cycle, and the
    chunk passed with `last=True` ends exactly at the packet's final
    (termination) segment.  The flush drops the S termination symbols from
    the undecoded window, which is only right when they are the last steps
    consumed; so every `last=True` call must consume at least one segment.

    With `soft=True`, chunks are int32 quantized LLRs [T', n] of any size,
    used as they are.  A per-step scan on `device`: the module itself, not
    a kernel's plain version.
    """
    spec: CodeSpec
    traceback_len: int = 0
    soft: bool = False
    device: torch.device | str | None = None

    def __post_init__(self):
        self.traceback_len = self.traceback_len or self.spec.traceback_len
        self.device = torch.device("cuda" if self.device is None
                                   else self.device)
        self.reset()

    def decode(self, segments, last: bool = False) -> torch.Tensor:
        """Feed a chunk; returns the newly decoded message bits, uint8."""
        dtype = torch.int32 if self.soft else torch.uint8
        chunk = as_tensor(segments, dtype, self.device).to(self.device)[None]
        chunk_fn = decode_chunk_soft if self.soft else decode_chunk
        if last and chunk.shape[1] == 0:
            raise ValueError(
                "StreamingDecoder: the last=True chunk must contain the "
                "packet's final segments (see class docstring); got an "
                "empty chunk, so the termination steps were already "
                "streamed and the flush accounting would be wrong.")
        W = self.traceback_len
        start = _filler(W, self._state.count)
        self._state, symbols, _ = chunk_fn(self.spec, self._state, chunk, W)
        out = symbols[:, start:]
        if last:
            flush = decode_flush(self.spec, self._state, W)
            out = torch.cat(
                [out, flush[:, _filler(W, self._state.count):]], dim=1)
            self.reset()
        return symbols_to_bits(self.spec, out)[0]

    def decode_bytes(self, segments, last: bool = False) -> torch.Tensor:
        """Feed a chunk; returns the newly completed decoded bytes (MSb-first
        fill).  A partial byte carries across chunks; at `last` a trailing
        partial byte is flushed zero-padded."""
        bits = torch.cat([self._bit_carry, self.decode(segments, last)])
        if last:
            self._bit_carry = bits[:0]
            return pad_and_pack(bits[None])[0]
        n_full = bits.shape[0] // 8 * 8
        self._bit_carry = bits[n_full:]
        return pack_bits(bits[:n_full])

    def reset(self):
        self._state = decoder_init(self.spec, self.traceback_len, 1,
                                   self.device)
        self._bit_carry = torch.zeros((0,), dtype=torch.uint8,
                                      device=self.device)


class StreamingDecoderBatch:
    """B independent channels decoded with sliding-window emission (decode
    delay = traceback_len W), bit-exact to one `StreamingDecoder` per
    channel and to `ops.viterbi.viterbi_decode_stream`, whatever the
    chunking.

    The kernel route (`use_kernel`; default: k = 1 poly-symmetric codes
    with NS >= 64 and W <= 64, the JAX package's rule) runs every chunk,
    of any length, through `kernels.stream.stream_decode_batch(_soft)`: the
    CUDA kernel on the card, its plain version on the CPU.  On the card a
    code the kernel does not take raises NotImplementedError.
    `use_kernel=False` runs the per-step scan (`decode_chunk`) on the
    class's device, as asked.

    Same caller contract as `StreamingDecoder`: one packet per last=True
    cycle, whose final chunk ends at the packet's last segment.

    With `soft=True`, chunks are quantized LLRs [B, T', n], cast to int8
    and floored at -127 on every step (on both routes).
    """

    def __init__(self, spec: CodeSpec, batch: int, traceback_len: int = 0,
                 use_kernel: bool | None = None, soft: bool = False,
                 device=None):
        self.spec = spec
        self.batch = batch
        self.traceback_len = traceback_len or spec.traceback_len
        self.soft = soft
        self.device = torch.device("cuda" if device is None else device)
        if use_kernel is None:
            use_kernel = (spec.num_states >= 64 and spec.k == 1
                          and spec.has_poly_symmetry
                          and self.traceback_len <= 64)
        if use_kernel and self.traceback_len > 64:
            raise ValueError("kernel streaming supports traceback_len <= 64")
        self.use_kernel = use_kernel
        self.reset()

    def reset(self):
        if self.use_kernel:
            self._state = stream_state_init(self.spec, self.batch,
                                            self.device)
        else:
            self._state = decoder_init(self.spec, self.traceback_len,
                                       self.batch, self.device)
        self._count = 0
        self._bit_carry = torch.zeros((self.batch, 0), dtype=torch.uint8,
                                      device=self.device)

    def resume(self, state: StreamState, count: int) -> None:
        """Continue a stream from a carried `state` (for example
        `kernels.stream.stream_state_from_reference` of another decoder's),
        `count` steps of the packet already consumed.  The partial-byte
        carry of `decode_bytes` starts empty."""
        self.reset()
        m, r = (t.to(self.device) for t in state)
        if self.use_kernel:
            self._state = StreamState(m, r)
        else:
            self._state = DecoderState(
                m, registers_to_symbols(r, self.traceback_len), count)
        self._count = count

    def _input(self, segments) -> torch.Tensor:
        dtype = torch.int8 if self.soft else torch.uint8
        segments = as_tensor(segments, device=self.device).to(self.device,
                                                              dtype)
        if self.soft and (segments.dim() != 3
                          or segments.shape[-1] != self.spec.n):
            raise ValueError(
                f"soft chunks are [B, T', n={self.spec.n}] LLRs; got "
                f"{tuple(segments.shape)}")
        return segments

    def decode(self, segments, last: bool = False) -> torch.Tensor:
        """Feed a chunk of [B, T'] segments ([B, T', n] LLRs); returns the
        newly decoded message bits, uint8 [B, bits]."""
        segments = self._input(segments)
        B, T = segments.shape[:2]
        if B != self.batch:
            raise ValueError(f"batch {B} != {self.batch}")
        if last and T == 0:
            raise ValueError(
                "the last=True chunk must contain the packet's final "
                "segments (see StreamingDecoder docstring)")
        if T == 0:
            return self._bit_carry[:, :0]
        W = self.traceback_len
        if self.use_kernel:
            fn = stream_decode_batch_soft if self.soft else stream_decode_batch
            symbols, self._state = fn(self.spec, segments, self._state, W)
        elif self.soft:
            self._state, symbols, _ = decode_chunk_soft(
                self.spec, self._state, condition_qllrs(segments, 127), W)
        else:
            self._state, symbols, _ = decode_chunk(self.spec, self._state,
                                                   segments, W)
        out = symbols[:, _filler(W, self._count):]
        self._count += T
        if last:
            out = torch.cat([out, self._flush()], dim=1)
            self.reset()
        return symbols_to_bits(self.spec, out)

    def _flush(self) -> torch.Tensor:
        """State 0's undecoded window, oldest first, the S termination steps
        and any register-init filler dropped."""
        W, S = self.traceback_len, self.spec.S
        if self.use_kernel:
            shifts = torch.arange(W - 2, S - 1, -1, device=self.device)
            flush = ((self._state.registers[:, :1] >> shifts) & 1).to(
                torch.uint8)
        else:
            flush = decode_flush(self.spec, self._state, W)
        return flush[:, _filler(W, self._count):]

    def decode_bytes(self, segments, last: bool = False) -> torch.Tensor:
        """Byte-granular streaming decode with a partial-byte carry (see
        `StreamingDecoder.decode_bytes`).  Returns uint8 [B, bytes]."""
        bits = torch.cat([self._bit_carry, self.decode(segments, last)], 1)
        if last:
            self._bit_carry = bits[:, :0]
            return pad_and_pack(bits)
        n_full = bits.shape[1] // 8 * 8
        self._bit_carry = bits[:, n_full:]
        return pack_bits(bits[:, :n_full])


class BlockStreamingDecoderBatch:
    """Chunked decode at block-kernel speed: exact carried-metric forward
    continuity across calls.

    Feed [B, t] segment chunks ([B, t, n] int8 LLRs with `soft=True`) of any
    sizes.  Each call runs the block forward ACS (`kernels.acs`:
    `acs_forward_batch`, or `acs_forward_batch_soft` with the clip of
    `kernels.decode.soft_qclip(spec, qmax)`) over the newly completed
    CHUNK_F-step chunks, seeded with the previous call's final metrics
    (exact continuation), appends the decision words to a pending buffer,
    and emits every decoded bit older than the kept `lookahead` window by
    the masked traceback (`traceback_batch_masked`) from the lowest state of
    least metric.  The `last=True` call is the terminated traceback from
    state 0 (`traceback_batch`), so the concatenated emissions equal the
    one-shot block decode wherever survivor paths merge within the
    lookahead.

    Cadence (every call returns the JAX class's bits): interior emissions
    are whole 48-step chunks and lag by `lookahead`..`lookahead` + 47 steps
    plus any buffered remainder; ceil(lookahead / 48) chunks are kept and
    walked again by the next interior traceback.

    Hard decode takes the codes of the JAX package's hard SWAR kernels
    (`kernels.decode.swar_supported`), soft decode the codes of its SWAR
    layout (`swar_layout_supported`); other codes raise ValueError and use
    `StreamingDecoderBatch`.  The carried metrics are renormalised (each
    channel's minimum subtracted) after every call, which keeps a stream of
    any length inside int32 and changes no decision.
    """

    def __init__(self, spec: CodeSpec, batch: int,
                 lookahead: int | None = None, soft: bool = False,
                 qmax: int | None = None, device=None):
        if soft:
            qmax = DEFAULT_QMAX if qmax is None else int(qmax)
            if not swar_layout_supported(spec):
                raise ValueError(
                    "soft BlockStreamingDecoderBatch requires a SWAR-"
                    "layout code; use StreamingDecoderBatch instead")
            self._qclip = soft_qclip(spec, qmax)
        elif not swar_supported(spec):
            raise ValueError(
                "BlockStreamingDecoderBatch requires a SWAR-eligible "
                "code (k=1 poly-symmetric, NS >= 64, n <= 4); use "
                "StreamingDecoderBatch instead")
        self.spec = spec
        self.batch = batch
        self.soft = soft
        self.device = torch.device("cuda" if device is None else device)
        la = spec.traceback_len if lookahead is None else int(lookahead)
        if la <= spec.S:
            # With no kept lookahead the termination steps would stream out
            # as message bits and the final flush would have nothing left.
            raise ValueError(f"lookahead must exceed S={spec.S} "
                             f"(5K = {spec.traceback_len} is the "
                             f"standard choice); got {la}")
        self._keep = -(-la // CHUNK_F)    # kept lookahead, whole chunks
        self.reset()

    def reset(self):
        self._buf = None         # sub-chunk remainder of the input
        self._m = None           # carried metrics int32 [B, NS]
        self._pending = None     # decision words int32 [B, steps, NS/32]
        self._in_steps = 0       # segments consumed
        self._emitted = 0        # steps emitted

    def decode(self, segments, last: bool = False) -> torch.Tensor:
        """Consume a [B, t] chunk (hard) or [B, t, n] LLR chunk (soft),
        t >= 0; returns uint8 [B, e] decoded bits (e varies per call).
        `last=True` flushes: the emissions then cover all (total segments
        - S) message positions, and the decoder resets for the next
        stream."""
        dtype = torch.int8 if self.soft else torch.uint8
        segments = as_tensor(segments, device=self.device).to(self.device,
                                                              dtype)
        if segments.shape[0] != self.batch:
            raise ValueError(f"batch {segments.shape[0]} != {self.batch}")
        t = segments.shape[1]
        self._in_steps += t
        if self._buf is None and t % CHUNK_F == 0 and (t or last):
            proc = segments                      # no remainder to carry
        else:
            buf = (segments if self._buf is None
                   else torch.cat([self._buf, segments], dim=1))
            if last:
                proc, self._buf = buf, None
            else:
                k = buf.shape[1] // CHUNK_F * CHUNK_F
                proc = buf[:, :k]
                self._buf = buf[:, k:] if k < buf.shape[1] else None
        empty = segments.new_zeros((self.batch, 0), dtype=torch.uint8)
        if not last and proc.shape[1] == 0:
            return empty
        if last and proc.shape[1] == 0 and self._pending is None:
            self.reset()
            return empty
        if proc.shape[1]:
            self._forward(proc)
        if last:
            live_rel = self._in_steps - self._emitted
            n_final = max(live_rel - self.spec.S, 0)
            bits = (traceback_batch(self.spec, self._pending, live_rel,
                                    n_final, out="bits") if n_final else empty)
            self.reset()
            return bits
        T = self._pending.shape[1]
        emit = T - self._keep * CHUNK_F
        if emit <= 0:
            return empty
        start = torch.argmin(self._m, dim=1).to(torch.int32)
        bits = traceback_batch_masked(self.spec, self._pending, start, T,
                                      emit, out="bits")
        self._pending = self._pending[:, emit:]
        self._emitted += emit
        return bits

    def _forward(self, proc: torch.Tensor) -> None:
        """Forward ACS over `proc` from the carried metrics (the known start
        on the first call); append its decisions, renormalise the metrics."""
        if self.soft:
            words, m = acs_forward_batch_soft(self.spec, proc, self._qclip,
                                              self._m)
        else:
            words, m = acs_forward_batch(self.spec, proc, self._m)
        self._m = m - m.min(dim=1, keepdim=True).values
        self._pending = (words if self._pending is None
                         else torch.cat([self._pending, words], dim=1))
