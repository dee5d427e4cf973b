"""Forward ACS and traceback of the k=1 butterfly block decodes.

Six wrappers, each with its plain PyTorch version beside it, each launching
the kernel of its code's size (TPU kernels named by their function in
convolutionalencdec_tpu/kernels/acs_swar.py and acs_pallas.py):

  * `acs_forward_batch` (hard decisions) launches `acs_k1_forward` of
    `csrc/acs_soft_k1.cu` at NS = 64..256 (replaces
    `acs_forward_batch_swar`), `acs_small_forward`
    of `csrc/acs_small.cu` at NS = 2..32 (replaces acs_pallas's
    `acs_forward_batch`, K12) and `acs_wide_forward` of `csrc/acs_wide.cu`
    at NS = 512..16384 (replaces `acs_forward_batch_fused`, K11, and the
    SWAR kernel there);
  * `acs_forward_batch_soft` (int8 quantized LLRs) launches
    `csrc/acs_soft_k1.cu` at NS = 64..256 (replaces both
    `acs_forward_batch_swar_soft8` and `acs_forward_batch_swar_soft`),
    `acs_soft_small_forward` at NS = 2..32 (acs_pallas's
    `acs_forward_batch_soft`, K12) and `acs_soft_wide_forward` at
    NS = 512..16384 and for any n > 8 (`acs_forward_batch_fused_soft`,
    K11);
  * `traceback_batch` launches `traceback_k1` in `csrc/traceback_k1.cu`
    (replaces `traceback_batch_swar`, and at NS <= 32 acs_pallas's
    `traceback_batch`, K12);
  * `traceback_batch_ragged` launches `traceback_k1_ragged`, same file
    (per-channel lengths; replaces `traceback_batch_swar_ragged`);
  * `traceback_batch_masked` launches `traceback_k1_masked`, same file
    (per-channel start states, a live prefix; replaces
    `traceback_batch_swar_masked`);
  * `traceback_batch_multi` launches `traceback_k1_multi`, same file
    (NW walks per channel, a window of steps out; replaces
    `traceback_batch_swar_masked_multi`).

At NS >= 512 the four tracebacks launch the wide walks of
`csrc/traceback_wide.cu`, `traceback_wide`, `_ragged`, `_masked` and
`_multi`: one segment walk, a segment a lane and one to eight warps a
walk (8 up to 256 walks a launch, 4 up to 512, 2 up to 1024, 1 from 1025;
the masked one also replaces `traceback_batch_fused_masked`, K11).
`kernels/fused.py` gives the JAX package's K11 names on these wrappers.
`kernels/stream.py` holds the streaming kernel's wrappers; their launches
are counted here too.

A wrapper takes its plain version only for a tensor on the CPU.  For a CUDA
tensor it launches its kernel or raises: nothing falls back.  `LAUNCHES`
counts the launches of each kernel.

Decision words: int32 [B, T, W] with W = ceil(NS/32).  The decision of
state s = 2b + p (butterfly b, parity p) is bit i % 32 of word i / 32, with
i = p * NS/2 + b: the even states' decisions fill the first NS/2 bits, the
odd states' the next NS/2, each in butterfly order; below 32 states the one
word's bits NS..31 are zero.  Both the kernels and the plain versions
produce the same words.
"""

from __future__ import annotations

import functools

import torch

from ..ops.metrics import viterbi_forward_butterfly_soft
from ..ops.trellis import butterfly_coded_bits
from ..ops.viterbi import (init_metric_value, pad_and_pack, ragged_epilogue,
                           traceback_terminated, viterbi_forward_butterfly)
from ..params import CodeSpec

#: Launches of each kernel since the count was last set to 0.
LAUNCHES = {"acs_k1_forward": 0, "traceback_k1": 0, "acs_soft_k1_forward": 0,
            "traceback_k1_ragged": 0, "stream_k1_decode": 0,
            "traceback_k1_masked": 0, "traceback_k1_multi": 0,
            "acs_small_forward": 0, "acs_soft_small_forward": 0,
            "acs_wide_forward": 0, "acs_soft_wide_forward": 0,
            "traceback_wide": 0, "traceback_wide_ragged": 0,
            "traceback_wide_masked": 0, "traceback_wide_multi": 0}

#: The most states the kernels take: the wide forward keeps a channel's
#: metrics twice in one block's shared memory (2 x 4 x NS bytes of 227 KB).
MAX_STATES = 16384
#: From this many states on, the wide forward and the wide walks run.
WIDE_STATES = 512
#: The largest n of a hard segment (one byte), and of the soft kernels'
#: compile-time instantiations; the wide soft forward takes any n.
MAX_HARD_N = 8


def kernel_supports(spec: CodeSpec, mode: str = "hard") -> bool:
    """Whether the kernels decode this spec: k = 1 with poly symmetry and
    2 <= NS <= MAX_STATES; hard decodes need n <= 8 (a segment is one
    byte), soft ones (`mode="soft"`) take any n."""
    return (spec.k == 1 and spec.has_poly_symmetry
            and 2 <= spec.num_states <= MAX_STATES
            and (mode == "soft" or spec.n <= MAX_HARD_N))


def decision_words(spec: CodeSpec) -> int:
    """W, the int32 decision words per step: ceil(NS / 32)."""
    return -(-spec.num_states // 32)


def pack_decisions(spec: CodeSpec, decisions: torch.Tensor) -> torch.Tensor:
    """uint8 [B, T, NS] decisions in state order -> int32 [B, T, W]
    decision words (the layout in the module docstring)."""
    B, T, NS = decisions.shape
    W = decision_words(spec)
    by_index = torch.cat([decisions[..., 0::2], decisions[..., 1::2]], dim=-1)
    if W * 32 != NS:
        by_index = torch.nn.functional.pad(by_index, (0, W * 32 - NS))
    return bits_to_words(by_index.reshape(B, T, W, 32))


def bits_to_words(bits: torch.Tensor) -> torch.Tensor:
    """0/1 integers [..., 32] -> int32 words [...], bit j of a word from
    bits[..., j], one bit position at a time so that no int32 copy of all
    the bits is made."""
    # Bit 31 weighs -2^31 in int32: the word's two's complement value.
    words = bits[..., 31].to(torch.int32) * -(1 << 31)
    for j in range(31):
        words |= bits[..., j].to(torch.int32) << j
    return words


def unpack_decisions(spec: CodeSpec, words: torch.Tensor) -> torch.Tensor:
    """int32 [B, T, W] decision words -> uint8 [B, T, NS] decisions in
    state order."""
    B, T, W = words.shape
    NS = spec.num_states
    by_index = torch.empty((B, T, W, 32), dtype=torch.uint8,
                           device=words.device)
    for j in range(32):
        by_index[..., j] = (words >> j) & 1
    by_index = by_index.reshape(B, T, W * 32)[..., :NS]
    half = NS // 2
    return torch.stack([by_index[..., :half], by_index[..., half:]],
                       dim=-1).reshape(B, T, NS)


def _check_kernel_spec(spec: CodeSpec, mode: str = "hard") -> None:
    if kernel_supports(spec, mode):
        return
    if not (spec.k == 1 and spec.has_poly_symmetry):
        reason = ("the k=1 butterfly kernels take poly-symmetric codes; the "
                  "rest decode through kernels/generic.py")
    elif spec.num_states > MAX_STATES:
        reason = (f"NS = {spec.num_states} > {MAX_STATES}: the wide forward "
                  "keeps 2 x 4 x NS bytes of metrics in one block's shared "
                  "memory (227 KB); more states are later work, ROADMAP.md "
                  "queue 2")
    else:
        reason = (f"a hard segment holds n <= {MAX_HARD_N} coded bits; "
                  f"n = {spec.n} decodes soft")
    raise NotImplementedError(f"no CUDA kernel decodes {spec}: {reason}")


def _forward_kernel(spec: CodeSpec, soft: bool) -> str:
    """The forward kernel of `spec`'s size: the wide one at NS >= 512 (and
    for soft n > 8), the small one at NS <= 32, else acs_k1."""
    NS = spec.num_states
    prefix = "acs_soft_" if soft else "acs_"
    if NS >= WIDE_STATES or spec.n > MAX_HARD_N:
        return prefix + "wide_forward"
    if NS < 64:
        return prefix + "small_forward"
    return prefix + "k1_forward"


def _walk_kernel(spec: CodeSpec, mode: str = "") -> str:
    """The traceback kernel of `spec`'s size and walk mode ("", "_ragged",
    "_masked" or "_multi"): the wide walk at NS >= 512."""
    family = ("traceback_wide" if spec.num_states >= WIDE_STATES
              else "traceback_k1")
    return family + mode


def _launch(name: str, *args) -> None:
    """Launch kernel `name` with `args` (the stream last), count it, and
    raise if it reported an error."""
    from . import _build
    code = getattr(_build.library(), name)(*args)
    LAUNCHES[name] += 1
    _build.check(name, code)


def _check_device(t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; raise otherwise."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"tensors on {t.device} are not supported")


def _checked_initial_metrics(initial_metrics, B: int, NS: int, device):
    """None, or contiguous int32 [B, NS] metrics on `device`; raise
    otherwise."""
    if initial_metrics is None:
        return None
    if (initial_metrics.shape != (B, NS)
            or initial_metrics.dtype != torch.int32
            or initial_metrics.device != device):
        raise ValueError("initial_metrics must be int32 [B, NS] on the "
                         "inputs' device")
    return initial_metrics.contiguous()


@functools.lru_cache(maxsize=None)
def _butterfly_table(spec: CodeSpec, device: torch.device) -> torch.Tensor:
    """int32 [NS/2] butterfly coded segments, resident on `device`."""
    return torch.as_tensor(butterfly_coded_bits(spec), dtype=torch.int32,
                           device=device)


def _check_words(spec: CodeSpec, decisions: torch.Tensor, out: str):
    """Validate a traceback's decision words and output format; returns
    (B, T)."""
    if out not in ("bytes", "bits"):
        raise ValueError(f"out must be 'bytes' or 'bits', got {out!r}")
    if decisions.dtype != torch.int32 or decisions.dim() != 3:
        raise ValueError("decisions must be int32 [B, T, W]")
    B, T, W = decisions.shape
    if W != decision_words(spec):
        raise ValueError(f"{W} decision words per step do not match "
                         f"NS = {spec.num_states}")
    return B, T


def acs_forward_batch_plain(spec: CodeSpec, segments: torch.Tensor,
                            initial_metrics: torch.Tensor | None = None):
    """Plain version of `acs_forward_batch`: the reference butterfly scan,
    its decisions packed into words."""
    decisions, final_metrics = viterbi_forward_butterfly(
        spec, segments, initial_metrics)
    return pack_decisions(spec, decisions), final_metrics


def acs_forward_batch(spec: CodeSpec, segments: torch.Tensor,
                      initial_metrics: torch.Tensor | None = None):
    """Forward butterfly ACS of a batch of hard-decision packets.

    Replaces the TPU kernels `acs_forward_batch_swar`
    (convolutionalencdec_tpu/kernels/acs_swar.py:815, pallas_call :847),
    acs_pallas's `acs_forward_batch` (:246, pallas_call :271; NS < 64) and
    `acs_forward_batch_fused` (:976, pallas_call :1004) at NS >= 512.

    Args:
      segments: uint8 [B, T] hard n-bit segments, contiguous.
      initial_metrics: optional int32 [B, NS] starting metrics (default 0 at
        state 0 and `init_metric_value(spec)` elsewhere).

    Returns:
      (decisions int32 [B, T, W] words, final_metrics int32 [B, NS] in
      natural state order).
    """
    if segments.dtype != torch.uint8 or segments.dim() != 2:
        raise ValueError("segments must be uint8 [B, T]")
    _check_kernel_spec(spec)
    if not _check_device(segments):
        return acs_forward_batch_plain(spec, segments, initial_metrics)
    B, T = segments.shape
    NS = spec.num_states
    if T * spec.n >= 2 ** 31:
        raise ValueError(f"T = {T} overflows int32 path metrics")
    segments = segments.contiguous()
    initial_metrics = _checked_initial_metrics(initial_metrics, B, NS,
                                               segments.device)
    decisions = torch.empty((B, T, decision_words(spec)), dtype=torch.int32,
                            device=segments.device)
    final_metrics = torch.empty((B, NS), dtype=torch.int32,
                                device=segments.device)
    if B == 0:
        return decisions, final_metrics
    cb = _butterfly_table(spec, segments.device)
    _launch(_forward_kernel(spec, False),
            segments.data_ptr(), cb.data_ptr(),
            None if initial_metrics is None else initial_metrics.data_ptr(),
            decisions.data_ptr(), final_metrics.data_ptr(),
            B, T, NS, spec.n, init_metric_value(spec),
            torch.cuda.current_stream(segments.device).cuda_stream)
    return decisions, final_metrics


def traceback_batch_plain(spec: CodeSpec, decisions: torch.Tensor,
                          t_actual: int, message_bits: int,
                          out: str = "bytes") -> torch.Tensor:
    """Plain version of `traceback_batch`: unpack the words and run the
    reference traceback."""
    dec = unpack_decisions(spec, decisions[:, :t_actual])
    bits = traceback_terminated(spec, dec)[:, :message_bits]
    return pad_and_pack(bits) if out == "bytes" else bits


def traceback_batch(spec: CodeSpec, decisions: torch.Tensor, t_actual: int,
                    message_bits: int, out: str = "bytes") -> torch.Tensor:
    """Traceback from terminal state 0 over decision words.

    Replaces the TPU kernel `traceback_batch_swar`
    (convolutionalencdec_tpu/kernels/acs_swar.py:863, pallas_call :877;
    `msb_first=True` for bytes) and, at NS < 64, acs_pallas's
    `traceback_batch` (:289, pallas_call :308).

    Args:
      decisions: int32 [B, T, W] words from `acs_forward_batch`.
      t_actual: steps of the packet (<= T); the walk starts at t_actual - 1.
      message_bits: decoded bits to keep, at most t_actual - S.
      out: "bytes" for uint8 [B, ceil(message_bits/8)] (MSb-first, trailing
        byte zero-padded) or "bits" for uint8 [B, message_bits].
    """
    B, T = _check_words(spec, decisions, out)
    if not 0 <= t_actual <= T:
        raise ValueError(f"t_actual = {t_actual} outside [0, {T}]")
    if not 0 <= message_bits <= t_actual - spec.S:
        raise ValueError(f"message_bits = {message_bits} outside "
                         f"[0, t_actual - S = {t_actual - spec.S}]")
    _check_kernel_spec(spec, "soft")  # any n: the walk reads decisions
    if not _check_device(decisions):
        return traceback_batch_plain(spec, decisions, t_actual, message_bits,
                                     out)
    decisions = decisions.contiguous()
    width = (message_bits + 7) // 8 if out == "bytes" else message_bits
    result = torch.empty((B, width), dtype=torch.uint8,
                         device=decisions.device)
    if B == 0:
        return result
    _launch(_walk_kernel(spec),
            decisions.data_ptr(), result.data_ptr(), B, T, t_actual,
            spec.num_states, spec.S, message_bits, int(out == "bytes"),
            torch.cuda.current_stream(decisions.device).cuda_stream)
    return result


def condition_qllrs(qllrs: torch.Tensor, qclip: int,
                    floor: bool = True) -> torch.Tensor:
    """int8 quantized LLRs -> int32 clamp(q, -qclip, qclip): the clip is
    the route's (see `kernels.decode.soft_qclip`) and, as qclip <= 127,
    floors -128 at -127.  `floor=False` (only with qclip = 127) leaves -128
    as it is, as the JAX package's tail-biting 16-bit route does."""
    return torch.clamp(qllrs.to(torch.int32), _qlo(qclip, floor), qclip)


def _qlo(qclip: int, floor: bool) -> int:
    """The lower clip of `condition_qllrs`."""
    if not floor and qclip != 127:
        raise ValueError("floor=False takes the LLRs as they are: only with "
                         f"qclip = 127, got {qclip}")
    return -qclip if floor else -128


def acs_forward_batch_soft_plain(spec: CodeSpec, qllrs: torch.Tensor,
                                 qclip: int,
                                 initial_metrics: torch.Tensor | None = None,
                                 floor: bool = True):
    """Plain version of `acs_forward_batch_soft`: the reference soft
    butterfly scan on the conditioned LLRs, its decisions packed into
    words."""
    decisions, final_metrics = viterbi_forward_butterfly_soft(
        spec, condition_qllrs(qllrs, qclip, floor), initial_metrics)
    return pack_decisions(spec, decisions), final_metrics


def acs_forward_batch_soft(spec: CodeSpec, qllrs: torch.Tensor, qclip: int,
                           initial_metrics: torch.Tensor | None = None,
                           floor: bool = True):
    """Forward butterfly ACS of a batch of soft-decision packets.

    Replaces the TPU kernels `acs_forward_batch_swar_soft8`
    (convolutionalencdec_tpu/kernels/acs_swar.py:1352, pallas_call :1381)
    and `acs_forward_batch_swar_soft` (:1231, pallas_call :1262): int32
    metrics make both of their field widths unnecessary; and acs_pallas's
    `acs_forward_batch_soft` (:465, pallas_call :489) at NS < 64 and
    `acs_forward_batch_fused_soft` (:1109, pallas_call :1134) at
    NS >= 512 or n > 8.

    Args:
      qllrs: int8 [B, T, n] quantized LLRs, contiguous, any n.  Each is
        used as clamp(q, -qclip, qclip), which floors -128 at -127.
      qclip: the clip, 1..127 (qmax on the route of the 8-bit TPU kernel,
        127 elsewhere).
      initial_metrics: optional int32 [B, NS] starting metrics (default 0 at
        state 0 and `init_metric_value(spec)` elsewhere; all zeros give the
        uniform start of tail-biting and interior time blocks).
      floor: False keeps -128 (only with qclip = 127): the tail-biting
        decodes on the JAX package's 16-bit route.

    Returns:
      (decisions int32 [B, T, W] words, the layout of
      `acs_forward_batch`; final_metrics int32 [B, NS], never renormalised).
    """
    if qllrs.dtype != torch.int8 or qllrs.dim() != 3 or qllrs.shape[2] != spec.n:
        raise ValueError(f"qllrs must be int8 [B, T, n = {spec.n}]")
    if not 1 <= qclip <= 127:
        raise ValueError(f"qclip = {qclip} outside [1, 127]")
    qlo = _qlo(qclip, floor)
    _check_kernel_spec(spec, "soft")
    B, T, n = qllrs.shape
    if T * n * 128 + init_metric_value(spec) >= 2 ** 31:
        raise ValueError(f"T = {T} overflows int32 path metrics")
    if not _check_device(qllrs):
        return acs_forward_batch_soft_plain(spec, qllrs, qclip,
                                            initial_metrics, floor)
    NS = spec.num_states
    qllrs = qllrs.contiguous()
    initial_metrics = _checked_initial_metrics(initial_metrics, B, NS,
                                               qllrs.device)
    decisions = torch.empty((B, T, decision_words(spec)), dtype=torch.int32,
                            device=qllrs.device)
    final_metrics = torch.empty((B, NS), dtype=torch.int32,
                                device=qllrs.device)
    if B == 0:
        return decisions, final_metrics
    cb = _butterfly_table(spec, qllrs.device)
    _launch(_forward_kernel(spec, True),
            qllrs.data_ptr(), cb.data_ptr(),
            None if initial_metrics is None else initial_metrics.data_ptr(),
            decisions.data_ptr(), final_metrics.data_ptr(),
            B, T, NS, n, qlo, qclip, init_metric_value(spec),
            torch.cuda.current_stream(qllrs.device).cuda_stream)
    return decisions, final_metrics


def traceback_batch_ragged_plain(spec: CodeSpec, decisions: torch.Tensor,
                                 lengths: torch.Tensor, message_bits_max: int,
                                 out: str = "bytes") -> torch.Tensor:
    """Plain version of `traceback_batch_ragged`: unpack the words and run
    the reference ragged epilogue."""
    T = decisions.shape[1]
    bits = ragged_epilogue(spec, unpack_decisions(spec, decisions), lengths,
                           T)[:, :message_bits_max]
    return pad_and_pack(bits) if out == "bytes" else bits


def traceback_batch_ragged(spec: CodeSpec, decisions: torch.Tensor,
                           lengths: torch.Tensor, message_bits_max: int,
                           out: str = "bytes") -> torch.Tensor:
    """Traceback of a batch of packets with per-channel lengths.

    Replaces the TPU kernel `traceback_batch_swar_ragged`
    (convolutionalencdec_tpu/kernels/acs_swar.py:954, pallas_call :975)
    and the per-channel byte mask of its epilogue (`_bytes_epilogue_ragged`,
    :1113).  Channel b (length t_b clamped to [0, T]) walks from state 0 at
    step t_b - 1: decision 0 keeps state 0 in place, so this is the walk
    the TPU kernel makes over the masked tail from step T - 1.

    Args:
      decisions: int32 [B, T, W] words.
      lengths: int32 [B] valid steps t_b of each channel.
      message_bits_max: row width L in bits, at most T - S; channel b keeps
        its first min(max(t_b - S, 0), L) bits and the rest of its row is 0.
      out: "bytes" for uint8 [B, ceil(L/8)] (MSb-first) or "bits" for uint8
        [B, L].
    """
    B, T = _check_words(spec, decisions, out)
    if (lengths.dtype != torch.int32 or lengths.shape != (B,)
            or lengths.device != decisions.device):
        raise ValueError("lengths must be int32 [B] on the decisions' device")
    if not 0 <= message_bits_max <= T - spec.S:
        raise ValueError(f"message_bits_max = {message_bits_max} outside "
                         f"[0, T - S = {T - spec.S}]")
    _check_kernel_spec(spec, "soft")  # any n: the walk reads decisions
    if not _check_device(decisions):
        return traceback_batch_ragged_plain(spec, decisions, lengths,
                                            message_bits_max, out)
    decisions = decisions.contiguous()
    lengths = lengths.contiguous()
    width = (message_bits_max + 7) // 8 if out == "bytes" else message_bits_max
    result = torch.empty((B, width), dtype=torch.uint8,
                         device=decisions.device)
    if B == 0:
        return result
    _launch(_walk_kernel(spec, "_ragged"),
            decisions.data_ptr(), lengths.data_ptr(), result.data_ptr(), B, T,
            spec.num_states, spec.S, message_bits_max, int(out == "bytes"),
            torch.cuda.current_stream(decisions.device).cuda_stream)
    return result


def traceback_batch_masked_plain(spec: CodeSpec, decisions: torch.Tensor,
                                 start_states: torch.Tensor, live_steps: int,
                                 out_steps: int,
                                 out: str = "bits") -> torch.Tensor:
    """Plain version of `traceback_batch_masked`: unpack the words, zero the
    decisions from `live_steps` on, and run the reference traceback from
    the start states with no padding dropped."""
    dec = unpack_decisions(spec, decisions)
    dec[:, live_steps:] = 0
    bits = traceback_terminated(spec, dec, num_pad=0,
                                start_states=start_states)[:, :out_steps]
    return pad_and_pack(bits) if out == "bytes" else bits


def traceback_batch_masked(spec: CodeSpec, decisions: torch.Tensor,
                           start_states: torch.Tensor, live_steps: int,
                           out_steps: int, out: str = "bits") -> torch.Tensor:
    """Traceback from given start states over a live prefix of the steps.

    Replaces the TPU kernel `traceback_batch_swar_masked`
    (convolutionalencdec_tpu/kernels/acs_swar.py:897, pallas_call :920;
    body `_tb_kernel_swar` with `with_hinit`).  That kernel takes a one-hot
    start and a byte mask per 8-step group; every caller builds the mask as
    a prefix of live groups, so one `live_steps` gives the same function.
    Channel b walks from `start_states[b]` at step T - 1; a step at or
    beyond `live_steps` counts as decision 0.  Used by the block-speed
    stream (`ops.streaming.BlockStreamingDecoderBatch`), and the traceback
    of the tail-biting and time-block decodes in the JAX package.

    Args:
      decisions: int32 [B, T, W] words.
      start_states: int32 [B] states in [0, NS), on the decisions' device.
      live_steps: steps [0, live_steps) read their decisions; 0..T.
      out_steps: the bits of steps [0, out_steps) are returned; 0..T.  No
        termination steps are dropped: the caller chooses.
      out: "bits" for uint8 [B, out_steps] (one bit per step, the step's
        input bit) or "bytes" for uint8 [B, ceil(out_steps/8)] (MSb-first).
    """
    B, T = _check_words(spec, decisions, out)
    if (start_states.dtype != torch.int32 or start_states.shape != (B,)
            or start_states.device != decisions.device):
        raise ValueError("start_states must be int32 [B] on the decisions' "
                         "device")
    if not 0 <= live_steps <= T:
        raise ValueError(f"live_steps = {live_steps} outside [0, {T}]")
    if not 0 <= out_steps <= T:
        raise ValueError(f"out_steps = {out_steps} outside [0, {T}]")
    _check_kernel_spec(spec, "soft")  # any n: the walk reads decisions
    if not _check_device(decisions):
        return traceback_batch_masked_plain(spec, decisions, start_states,
                                            live_steps, out_steps, out)
    decisions = decisions.contiguous()
    start_states = start_states.contiguous()
    width = (out_steps + 7) // 8 if out == "bytes" else out_steps
    result = torch.empty((B, width), dtype=torch.uint8,
                         device=decisions.device)
    if B == 0:
        return result
    _launch(_walk_kernel(spec, "_masked"),
            decisions.data_ptr(), start_states.data_ptr(), result.data_ptr(),
            B, T, spec.num_states, spec.S, live_steps, out_steps,
            int(out == "bytes"),
            torch.cuda.current_stream(decisions.device).cuda_stream)
    return result


def traceback_batch_multi_plain(spec: CodeSpec, decisions: torch.Tensor,
                                start_states: torch.Tensor, live_steps: int,
                                out_start: int, out_steps: int,
                                out: str = "bits") -> torch.Tensor:
    """Plain version of `traceback_batch_multi`: unpack the words, zero the
    decisions from `live_steps` on, and walk every (channel, walk) pair at
    once from step T - 1 down to `out_start`."""
    dec = unpack_decisions(spec, decisions)
    dec[:, live_steps:] = 0
    B, T, _ = dec.shape
    cur = start_states.to(torch.long)                        # [B, NW]
    bits = torch.zeros(cur.shape + (out_steps,), dtype=torch.uint8,
                       device=dec.device)
    for t in range(T - 1, out_start - 1, -1):
        if t < out_start + out_steps:
            bits[:, :, t - out_start] = cur & 1
        d = torch.gather(dec[:, t], 1, cur).to(torch.long)
        cur = (cur >> 1) | (d << (spec.S - 1))
    return pad_and_pack(bits) if out == "bytes" else bits


def traceback_batch_multi(spec: CodeSpec, decisions: torch.Tensor,
                          start_states: torch.Tensor, live_steps: int,
                          out_start: int, out_steps: int,
                          out: str = "bits") -> torch.Tensor:
    """NW tracebacks per channel over one decision matrix, in one launch.

    Replaces the TPU kernel `traceback_batch_swar_masked_multi`
    (convolutionalencdec_tpu/kernels/acs_swar.py:631, pallas_call :655,
    body `_tb_kernel_swar_multi`), the tail-biting list decode's candidate
    walks: walk w of channel b starts in state `start_states[b, w]` at step
    T - 1; a step at or beyond `live_steps` counts as decision 0 (the TPU
    kernel's group masks are such a prefix at every call site).  Only the
    window of steps [out_start, out_start + out_steps) is returned: the
    message, not the warm-up.

    Args:
      decisions: int32 [B, T, W] words.
      start_states: int32 [B, NW] states in [0, NS), 1 <= NW <= NS, on the
        decisions' device.
      live_steps: steps [0, live_steps) read their decisions; 0..T.
      out_start, out_steps: the window, within [0, T].
      out: "bits" for uint8 [B, NW, out_steps] or "bytes" for uint8
        [B, NW, ceil(out_steps/8)] (MSb-first).
    """
    B, T = _check_words(spec, decisions, out)
    if (start_states.dtype != torch.int32 or start_states.dim() != 2
            or start_states.shape[0] != B
            or start_states.device != decisions.device):
        raise ValueError("start_states must be int32 [B, NW] on the "
                         "decisions' device")
    NW = start_states.shape[1]
    if not 1 <= NW <= spec.num_states:
        raise ValueError(f"NW = {NW} walks outside [1, NS = "
                         f"{spec.num_states}]")
    if not 0 <= live_steps <= T:
        raise ValueError(f"live_steps = {live_steps} outside [0, {T}]")
    if not (0 <= out_start and 0 <= out_steps
            and out_start + out_steps <= T):
        raise ValueError(f"window [{out_start}, {out_start + out_steps}) "
                         f"outside [0, {T}]")
    _check_kernel_spec(spec, "soft")  # any n: the walk reads decisions
    if not _check_device(decisions):
        return traceback_batch_multi_plain(spec, decisions, start_states,
                                           live_steps, out_start, out_steps,
                                           out)
    decisions = decisions.contiguous()
    start_states = start_states.contiguous()
    width = (out_steps + 7) // 8 if out == "bytes" else out_steps
    result = torch.empty((B, NW, width), dtype=torch.uint8,
                         device=decisions.device)
    if B == 0:
        return result
    _launch(_walk_kernel(spec, "_multi"),
            decisions.data_ptr(), start_states.data_ptr(), result.data_ptr(),
            B, T, spec.num_states, spec.S, NW, live_steps, out_start,
            out_steps, int(out == "bytes"),
            torch.cuda.current_stream(decisions.device).cuda_stream)
    return result
