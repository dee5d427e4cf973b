"""Plain reference Viterbi decoders, batched over a leading B dimension.

Port of `convolutionalencdec_tpu/ops/viterbi.py` (block, ragged and
streaming decoders).  These are the port's ground truth and the plain
versions of the kernels in `kernels/acs.py` and `kernels/stream.py`: a
Python loop over time steps, tensor ops over the batch and the states.
A tensor input keeps its device; any other input goes to `device`
(default: the CUDA card), after the JAX function's own parameters.

Metric conventions match the JAX package exactly: initial metrics are 0 for
state 0 and `init_metric_value(spec)` for the rest, ties keep the lowest
decision index (the butterfly decides 1 only when strictly a0 > a1), and
int32 metrics are never renormalized (exact for any T below 2^31 / n).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .._device import as_tensor
from ..params import CodeSpec
from .bits import pack_bits
from .trellis import butterfly_coded_bits, edge_coded_bits, prev_state_table


def one_packet(rank: int):
    """Decorator of a batched function `fn(spec, x, ...)` whose input x has
    `rank` dimensions (a leading batch axis B): given one packet, x of
    rank - 1 dimensions as the JAX package's function takes it, it adds a
    batch axis of 1 and drops it from every tensor the function returns.
    Batched inputs pass through unchanged."""
    def wrap(fn):
        @functools.wraps(fn)
        def entry(spec, x, *args, **kwargs):
            is_tensor = isinstance(x, torch.Tensor)
            if (x.dim() if is_tensor else np.ndim(x)) != rank - 1:
                return fn(spec, x, *args, **kwargs)
            out = fn(spec, x[None] if is_tensor else np.asarray(x)[None],
                     *args, **kwargs)
            return tuple(o[0] for o in out) if isinstance(out, tuple) \
                else out[0]
        return entry
    return wrap


def init_metric_value(spec: CodeSpec) -> int:
    """Initial path metric for states other than starting_state.  The same
    value as the JAX package's, so that early decisions agree."""
    return min(spec.num_states + 1, max(64, spec.n * spec.S + 2))


def _initial_metrics(spec: CodeSpec, B: int, initial_metrics, device):
    """int32 [B, NS] starting metrics: the known-start default, or the
    caller's [NS] or [B, NS] metrics."""
    NS = spec.num_states
    if initial_metrics is None:
        init = torch.full((B, NS), init_metric_value(spec), dtype=torch.int32,
                          device=device)
        init[:, spec.starting_state] = 0
        return init
    init = torch.as_tensor(initial_metrics, dtype=torch.int32, device=device)
    return init.expand(B, NS).clone()


def _hamming_table(spec: CodeSpec, coded: np.ndarray) -> np.ndarray:
    """int32 [2^n, *coded.shape]: Hamming distance between every possible
    received segment and each coded segment."""
    c = np.arange(1 << spec.n, dtype=np.uint8).reshape((-1,) + (1,) * coded.ndim)
    x = np.bitwise_xor(c, coded[None])
    table = np.zeros(x.shape, dtype=np.int32)
    for j in range(spec.n):
        table += (x >> j) & 1
    return table


def hard_metric_table(spec: CodeSpec, device) -> torch.Tensor:
    """int32 [2^n, 2^k, NS]: entry [c, u, s] is the Hamming distance between
    received segment c and the coded bits of edge (src=s, input=u)."""
    return torch.as_tensor(_hamming_table(spec, edge_coded_bits(spec)),
                           device=device)


def hard_step_metrics(spec: CodeSpec, segments, device=None) -> torch.Tensor:
    """Branch metrics of hard n-bit segments [..., T]: int32
    [..., T, 2^k, NS], entry [t, u, s] the Hamming distance between segment t
    and the coded bits of edge (src=s, input=u)."""
    segments = as_tensor(segments, device=device)
    return hard_metric_table(spec, segments.device)[segments.long()]


@one_packet(4)
def viterbi_forward(spec: CodeSpec, step_metrics,
                    collect_metrics: bool = False, initial_metrics=None,
                    device=None):
    """Generic any-k ACS recurrence over branch metrics.

    Args:
      step_metrics: int32 [B, T, 2^k, NS]; entry [b, t, u, s] is the cost of
        leaving state s on the input-u edge at step t.
      collect_metrics: also return the path-metric history.
      initial_metrics: optional int32 [NS] or [B, NS] starting metrics
        (default 0 at state 0 and `init_metric_value(spec)` elsewhere; all
        zeros give the uniform start of the tail-biting decoders).

    Returns:
      (decisions uint8 [B, T, NS], final_metrics int32 [B, NS]), and with
      `collect_metrics` a third item, the metrics after every step, int32
      [B, T, NS].  decisions[b, t, d] is the chosen decision index e (the k
      shifted-out bits of the chosen source); the lowest e wins ties.
    """
    step_metrics = as_tensor(step_metrics, torch.int32, device)
    B, T = step_metrics.shape[:2]
    NS, E = spec.num_states, spec.num_edges_per_state
    dev = step_metrics.device
    prev = torch.as_tensor(prev_state_table(spec), dtype=torch.long,
                           device=dev)                                # [E, NS]
    u_of_dst = torch.arange(NS, device=dev) & (E - 1)
    bm_idx = u_of_dst[None, :] * NS + prev                            # [E, NS]

    m = _initial_metrics(spec, B, initial_metrics, dev)
    decisions = torch.empty((B, T, NS), dtype=torch.uint8, device=dev)
    history = (torch.empty((B, T, NS), dtype=torch.int32, device=dev)
               if collect_metrics else None)
    for t in range(T):
        pm = m[:, prev] + step_metrics[:, t].reshape(B, E * NS)[:, bm_idx]
        best = pm[:, 0]
        dec = torch.zeros((B, NS), dtype=torch.uint8, device=dev)
        for e in range(1, E):
            better = pm[:, e] < best
            best = torch.where(better, pm[:, e], best)
            dec = torch.where(better, e, dec)
        decisions[:, t] = dec
        m = best
        if collect_metrics:
            history[:, t] = m
    if collect_metrics:
        return decisions, m, history
    return decisions, m


@one_packet(2)
def viterbi_forward_butterfly(spec: CodeSpec, segments, initial_metrics=None,
                              device=None):
    """k=1 butterfly ACS with the poly-symmetry single-edge-metric trick.

    Butterfly b has sources {b, b + NS/2} and destinations {2b, 2b+1}.  With
    every generator tapping both the newest and the oldest bit, the four
    edge metrics are one Hamming distance m and its complement n - m:

        dst 2b   (u=0):  src b costs m,      src b+NS/2 costs n-m
        dst 2b+1 (u=1):  src b costs n-m,    src b+NS/2 costs m

    Args:
      segments: uint8 [B, T] hard segments.
      initial_metrics: optional int32 [NS] or [B, NS] starting metrics.

    Returns (decisions uint8 [B, T, NS], final_metrics int32 [B, NS]),
    decisions bit-identical to `viterbi_forward`.
    """
    spec.validate_for_butterfly()
    segments = as_tensor(segments, torch.uint8, device)
    B, T = segments.shape
    NS, half = spec.num_states, spec.num_states // 2
    dev = segments.device
    em_table = torch.as_tensor(
        _hamming_table(spec, butterfly_coded_bits(spec)), device=dev)  # [2^n, half]
    seg = segments.long()

    m = _initial_metrics(spec, B, initial_metrics, dev)
    decisions = torch.empty((B, T, NS), dtype=torch.uint8, device=dev)
    for t in range(T):
        em = em_table[seg[:, t]]                                       # [B, half]
        emc = spec.n - em
        m_lo, m_hi = m[:, :half], m[:, half:]
        a0, a1 = m_lo + em, m_hi + emc
        b0, b1 = m_lo + emc, m_hi + em
        decisions[:, t] = torch.stack([a0 > a1, b0 > b1], dim=2).reshape(B, NS)
        m = torch.stack([torch.minimum(a0, a1), torch.minimum(b0, b1)],
                        dim=2).reshape(B, NS)
    return decisions, m


def symbols_to_bits(spec: CodeSpec, symbols: torch.Tensor) -> torch.Tensor:
    """k-bit symbols [B, T] -> uint8 bits [B, T * k], MSb of each symbol
    first."""
    bit_idx = torch.arange(spec.k - 1, -1, -1, device=symbols.device)
    bits = (symbols.long()[..., None] >> bit_idx) & 1
    return bits.to(torch.uint8).reshape(symbols.shape[0],
                                        symbols.shape[1] * spec.k)


def traceback_terminated(spec: CodeSpec, decisions, num_pad: int = -1,
                         start_states: torch.Tensor | None = None,
                         device=None) -> torch.Tensor:
    """Block traceback over terminated packets.

    Walks backward from the known terminal state 0 (or from `start_states`,
    int [B], at step T - 1), reconstructing sources via
    ``src = (dst >> k) | (decision << (S-1)*k)`` and emitting the k input
    bits ``dst & (2^k - 1)`` per step; the last `num_pad` steps (default S,
    the termination padding) emit nothing.

    Args:
      decisions: uint8 [B, T, NS] decision indices.

    Returns uint8 [B, (T - num_pad) * k] decoded bits, MSb of each k-bit
    symbol first.
    """
    if num_pad < 0:
        num_pad = spec.S
    decisions = as_tensor(decisions, torch.uint8, device)
    B, T, _ = decisions.shape
    E = spec.num_edges_per_state
    shift = (spec.S - 1) * spec.k
    dev = decisions.device
    rows = torch.arange(B, device=dev)
    cur = (torch.zeros(B, dtype=torch.long, device=dev) if start_states is None
           else start_states.to(device=dev, dtype=torch.long))
    us = torch.empty((B, T), dtype=torch.long, device=dev)
    for t in range(T - 1, -1, -1):
        e = decisions[rows, t, cur].long()
        us[:, t] = cur & (E - 1)
        cur = (cur >> spec.k) | (e << shift)
    return symbols_to_bits(spec, us[:, : T - num_pad])


@one_packet(2)
def viterbi_decode(spec: CodeSpec, segments, use_butterfly: bool | None = None,
                   device=None) -> torch.Tensor:
    """Hard-decision block decode of terminated packets.

    Args:
      segments: uint8 [B, T] hard n-bit segments (T = L/k + S).
      use_butterfly: the butterfly formulation (bit-identical decisions) or
        the generic decoder; default the butterfly when k == 1 and the
        generators have poly symmetry.
    Returns uint8 [B, (T - S) * k] decoded bits.
    """
    segments = as_tensor(segments, torch.uint8, device)
    if use_butterfly is None:
        use_butterfly = spec.k == 1 and spec.has_poly_symmetry
    if use_butterfly:
        decisions, _ = viterbi_forward_butterfly(spec, segments)
    else:
        decisions, _ = viterbi_forward(spec, hard_step_metrics(spec, segments))
    return traceback_terminated(spec, decisions)


def pad_and_pack(bits: torch.Tensor) -> torch.Tensor:
    """uint8 bits [B, L] -> uint8 bytes [B, ceil(L/8)], MSb-first with a
    zero-padded trailing byte."""
    pad = (-bits.shape[-1]) % 8
    if pad:
        bits = torch.nn.functional.pad(bits, (0, pad))
    return pack_bits(bits)


@one_packet(2)
def viterbi_decode_bytes(spec: CodeSpec, segments,
                         message_bits: int | None = None,
                         device=None) -> torch.Tensor:
    """Hard-decision block decode to packed bytes: the first `message_bits`
    decoded bits (default all (T - S) * k) fill bytes MSb-first; a trailing
    partial byte is zero-padded.  Returns uint8 [B, ceil(L / 8)]."""
    bits = viterbi_decode(spec, segments, device=device)
    L = message_bits if message_bits is not None else bits.shape[-1]
    return pad_and_pack(bits[:, :L])


def viterbi_decode_ragged(spec: CodeSpec, segments, seg_lengths,
                          device=None) -> torch.Tensor:
    """Batched decode of terminated packets with per-channel lengths.

    Decisions at steps >= t_b are masked to decision 0; every trellis state
    is a shift register, so state 0 is a fixed point of decision 0, and the
    backward walk parked at state 0 over the masked tail arrives at step
    t_b - 1 still in the channel's true terminal state.

    Args:
      segments: uint8 [B, Tmax] hard segments; rows may hold anything past
        t_b.
      seg_lengths: int32 [B] valid segment counts, t_b = l_b / k + S for an
        l_b-bit message.
      device: where non-tensor inputs go (default the CUDA card); tensors
        keep their own device.
    Returns uint8 [B, (Tmax - S) * k] decoded bits; positions >= (t_b - S) *
    k of each row are zero.
    """
    segments = as_tensor(segments, torch.uint8, device)
    lens = as_tensor(seg_lengths, torch.int32, segments.device)
    if spec.k == 1 and spec.has_poly_symmetry:
        decisions, _ = viterbi_forward_butterfly(spec, segments)
    else:
        decisions, _ = viterbi_forward(spec, hard_step_metrics(spec, segments))
    return ragged_epilogue(spec, decisions, lens, segments.shape[1])


def ragged_epilogue(spec: CodeSpec, decisions: torch.Tensor,
                    lens: torch.Tensor, T: int) -> torch.Tensor:
    """Shared tail of the ragged decoders (hard here, soft in
    ops/metrics.py): zero the decisions past each row's length, run the
    terminated traceback from state 0 at step T - 1 with no padding
    dropped, then zero the termination symbols and everything beyond: only
    the first (t_b - S) * k positions are message bits."""
    dev = decisions.device
    lens = lens.to(device=dev, dtype=torch.int32)
    live = torch.arange(T, dtype=torch.int32, device=dev)[None, :] < lens[:, None]
    decisions = decisions * live[:, :, None].to(torch.uint8)
    bits = traceback_terminated(spec, decisions, num_pad=0)
    pos = torch.arange(T * spec.k, dtype=torch.int32, device=dev)
    msg_live = pos[None, :] < (lens[:, None] - spec.S) * spec.k
    bits = bits * msg_live.to(torch.uint8)
    return bits[:, : (T - spec.S) * spec.k]


def stream_scan(spec: CodeSpec, step_metrics, T: int, metrics: torch.Tensor,
                registers: torch.Tensor):
    """Sliding-window register-exchange recurrence from a carried state: the
    plain core of every streaming decoder of the port.

    Each state carries the last W decoded symbols of its survivor path.  At
    each step the ACS picks every destination's source (the lowest decision
    index wins ties), the destination's register becomes its source's
    register shifted by one symbol with the destination's input symbol
    (dst & (2^k - 1)) entering as the newest, and the step emits the oldest
    symbol (column W - 1) of the lowest-numbered state with the least new
    metric.  Metrics are int32 and not renormalised.

    Args:
      step_metrics: callable t -> int32 [B, 2^k, NS] branch costs of step t
        (entry [b, u, s]: leaving state s on input u).
      T: steps to run.
      metrics: int32 [B, NS] carried path metrics.
      registers: uint8 [B, NS, W] carried survivor symbols, the newest in
        column 0.

    Returns (metrics int32 [B, NS], registers uint8 [B, NS, W], symbols
    uint8 [B, T]).
    """
    B, NS, W = registers.shape
    E = spec.num_edges_per_state
    dev = metrics.device
    prev = torch.as_tensor(prev_state_table(spec), dtype=torch.long,
                           device=dev)                                # [E, NS]
    u_of_dst = torch.arange(NS, device=dev) & (E - 1)
    bm_idx = u_of_dst[None, :] * NS + prev                            # [E, NS]
    cols = torch.arange(NS, device=dev)
    rows = torch.arange(B, device=dev)
    newest = u_of_dst.to(torch.uint8)[None, :, None].expand(B, NS, 1)
    symbols = torch.empty((B, T), dtype=torch.uint8, device=dev)
    m, reg = metrics, registers
    for t in range(T):
        pm = m[:, prev] + step_metrics(t).reshape(B, E * NS)[:, bm_idx]
        best = pm[:, 0]
        dec = torch.zeros((B, NS), dtype=torch.long, device=dev)
        for e in range(1, E):
            better = pm[:, e] < best
            best = torch.where(better, pm[:, e], best)
            dec = torch.where(better, e, dec)
        src = prev[dec, cols]                                         # [B, NS]
        kept = torch.gather(reg[:, :, :W - 1], 1,
                            src[:, :, None].expand(B, NS, W - 1))
        reg = torch.cat([newest, kept], dim=2)
        m = best
        symbols[:, t] = reg[rows, torch.argmin(m, dim=1), W - 1]
    return m, reg, symbols


def _decode_stream(spec: CodeSpec, step_metrics, B: int, T: int,
                   traceback_len: int, device) -> torch.Tensor:
    """Shared streaming decode of whole packets: the register-exchange scan
    from the known start, the streamed symbols of steps 0 .. T - W, then
    the flush of state 0's register minus the S termination steps."""
    W = traceback_len or spec.traceback_len
    if T < W:
        raise ValueError(f"packet of {T} segments shorter than traceback {W}")
    if W <= spec.S:
        raise ValueError(f"traceback_len {W} must exceed S = {spec.S} "
                         "(the flush drops the S termination steps from "
                         "the register window)")
    m = _initial_metrics(spec, B, None, device)
    reg = torch.zeros((B, spec.num_states, W), dtype=torch.uint8,
                      device=device)
    _, reg, emitted = stream_scan(spec, step_metrics, T, m, reg)
    flush = reg[:, 0, spec.S:W - 1].flip(1)
    return symbols_to_bits(spec, torch.cat([emitted[:, W - 1:], flush], 1))


@one_packet(2)
def viterbi_decode_stream(spec: CodeSpec, segments, traceback_len: int = 0,
                          device=None) -> torch.Tensor:
    """Streaming sliding-window decode (decode delay = traceback_len W,
    default 5K) of terminated packets.

    Register-exchange formulation: once warmed up, each step emits the
    oldest symbol of the current best state's register; at packet end the
    rest is flushed from state 0's register, minus the S termination steps.

    Args:
      segments: uint8 [B, T] hard segments, T >= W.
      device: where a non-tensor `segments` goes (default the CUDA card).
    Returns uint8 [B, (T - S) * k] decoded bits.
    """
    segments = as_tensor(segments, torch.uint8, device)
    B, T = segments.shape
    table = hard_metric_table(spec, segments.device)
    seg = segments.long()
    return _decode_stream(spec, lambda t: table[seg[:, t]], B, T,
                          traceback_len, segments.device)


@one_packet(3)
def viterbi_decode_stream_soft(spec: CodeSpec, qllrs, traceback_len: int = 0,
                               device=None) -> torch.Tensor:
    """Soft-decision `viterbi_decode_stream`: quantized-LLR branch costs
    (`ops.metrics.soft_step_metrics`, the LLRs used as they are) with the
    same per-step emit and state-0 flush.

    Args:
      qllrs: int [B, T, n] quantized LLRs.
    Returns uint8 [B, (T - S) * k] decoded bits.
    """
    from .metrics import soft_step_metrics
    qllrs = as_tensor(qllrs, torch.int32, device)
    B, T, _ = qllrs.shape
    return _decode_stream(spec, lambda t: soft_step_metrics(spec, qllrs[:, t]),
                          B, T, traceback_len, qllrs.device)
