"""Single-pass block decode: forward ACS and traceback in one launch.

Port of the JAX package's single-pass path (convolutionalencdec_tpu/
kernels/acs_pallas.py:2082-2204): `_block_decode_1p` runs the forward and
the walk in one call with the decisions kept on chip, and `_use_single_pass`
is the rule by which `viterbi_decode_batch` and `viterbi_decode_batch_soft`
take it.  Here the kernel is `csrc/block_1p.cu`, its decisions in shared
memory; `kernels.decode.select_kernel` names its route SINGLE_PASS.

`block_decode_1p` launches it on a CUDA tensor and counts the launch in
`LAUNCHES`; on a CPU tensor it takes its plain version, the two-pass plain
forward and traceback (`kernels.acs`) on the same inputs.  Nothing falls
back: on the card it launches or raises.
"""

from __future__ import annotations

import torch

from ..ops.bits import pack_bits
from ..ops.viterbi import init_metric_value
from ..params import CodeSpec
from .acs import (_butterfly_table, _check_device, acs_forward_batch_plain,
                  acs_forward_batch_soft_plain, kernel_supports,
                  traceback_batch_plain)

#: Launches of the kernel since the count was last set to 0.
LAUNCHES = {"block_decode_1p": 0}

#: The JAX rule's constants (acs_pallas.py): its forward chunk, which T is
#: rounded up to; steps per packed row; its channel tile; its cap on the
#: VMEM decision scratch (T_pad / 8) x NS x B_TILE, 32 KiB per channel.
CHUNK_F = 48
PACK = 8
B_TILE = 256
SINGLE_PASS_DEC_LIMIT = 8 * 1024 * 1024

#: The state counts the kernel takes: the JAX rule's range (NS // 8 >= 8,
#: and NS <= 4096 at its shortest T_pad of 48 steps).
MIN_STATES, MAX_STATES = 64, 4096
#: Shared memory a block may use (227 KB): a channel's T * NS/8 bytes of
#: decisions, 64 words of the walk's scratch and ceil(T / 32) words of
#: decoded bits, beside 2 x 4 x NS bytes of metrics and 1 KB of staged
#: inputs from NS = 512 on.
SMEM_BYTES = 232448
WIDE_STATES = 512


def use_single_pass(spec: CodeSpec, T: int) -> bool:
    """The JAX package's `_use_single_pass` (acs_pallas.py:2201-2204) at T
    steps rounded up to CHUNK_F: NS // 8 >= 8 and the decisions of a
    B_TILE of channels fit SINGLE_PASS_DEC_LIMIT."""
    T_pad = -(-T // CHUNK_F) * CHUNK_F
    return (spec.num_states // 8 >= 8
            and (T_pad // PACK) * spec.num_states * B_TILE
            <= SINGLE_PASS_DEC_LIMIT)


def smem_bytes(spec: CodeSpec, T: int) -> int:
    """Shared memory of one block of the kernel at T steps (one channel)."""
    NS = spec.num_states
    extra = 1024 + 8 * NS if NS >= WIDE_STATES else 0
    return T * NS // 8 + 4 * -(-T // 32) + 256 + extra


def _check(spec: CodeSpec, x: torch.Tensor, t_actual: int, soft: bool,
           out: str, message_bits: int | None) -> int:
    """Validate a call; returns the message bit count."""
    if out not in ("bits", "bytes"):
        raise ValueError(f"out must be 'bits' or 'bytes', got {out!r}")
    if soft:
        if x.dtype != torch.int8 or x.dim() != 3 or x.shape[2] != spec.n:
            raise ValueError(f"qllrs must be int8 [B, T, n = {spec.n}]")
    elif x.dtype != torch.uint8 or x.dim() != 2:
        raise ValueError("segments must be uint8 [B, T]")
    if not kernel_supports(spec, "soft" if soft else "hard"):
        raise ValueError(f"{spec} is not a k = 1 poly-symmetric code the "
                         "butterfly decodes take")
    NS = spec.num_states
    if not MIN_STATES <= NS <= MAX_STATES:
        raise ValueError(f"NS = {NS} outside the single-pass range "
                         f"[{MIN_STATES}, {MAX_STATES}]")
    if not 0 <= t_actual <= x.shape[1]:
        raise ValueError(f"t_actual = {t_actual} outside [0, {x.shape[1]}]")
    if smem_bytes(spec, t_actual) > SMEM_BYTES:
        raise ValueError(f"T = {t_actual} steps of NS = {NS} decisions do not "
                         f"fit one block's {SMEM_BYTES} bytes of shared "
                         "memory")
    if t_actual * spec.n * 128 + init_metric_value(spec) >= 2 ** 31:
        raise ValueError(f"T = {t_actual} overflows int32 path metrics")
    full = max(t_actual - spec.S, 0)
    L = full if message_bits is None else message_bits
    if not 0 <= L <= full:
        raise ValueError(f"message_bits = {L} outside [0, max(t_actual - S, "
                         f"0) = {full}]")
    return L


def block_decode_1p_plain(spec: CodeSpec, x: torch.Tensor, t_actual: int,
                          soft: bool, out: str = "bits",
                          message_bits: int | None = None) -> torch.Tensor:
    """Plain version of `block_decode_1p`: the plain two-pass forward and
    terminated traceback on the first t_actual steps."""
    L = _check(spec, x, t_actual, soft, out, message_bits)
    B = x.shape[0]
    if L == 0:
        return torch.zeros((B, 0), dtype=torch.uint8, device=x.device)
    x = x[:, :t_actual]
    if soft:
        words, _ = acs_forward_batch_soft_plain(spec, x, 127)
    else:
        words, _ = acs_forward_batch_plain(spec, x)
    return traceback_batch_plain(spec, words, t_actual, L, out)


def block_decode_1p(spec: CodeSpec, x: torch.Tensor, t_actual: int,
                    soft: bool, out: str = "bits",
                    message_bits: int | None = None) -> torch.Tensor:
    """Terminated block decode of a batch in one launch of
    `csrc/block_1p.cu`, the decisions never leaving shared memory.

    Replaces the TPU kernel `_block_decode_1p`
    (convolutionalencdec_tpu/kernels/acs_pallas.py:2150, pallas_call :2174,
    body `_block_kernel_fused_1p` :2092).

    Args:
      x: hard uint8 segments [B, T] (n <= 8), or soft int8 LLRs [B, T, n]
        (any n; each used as max(q, -127), unclipped: the JAX package's
        clip off its 8-bit route); steps past t_actual are ignored.
      t_actual: the packet's steps; the walk starts in state 0 at step
        t_actual - 1.  NS 64 ... 4096, and the T * NS/8 bytes of decisions
        must fit one block's shared memory (`smem_bytes`).
      soft: which of the two x is.
      out: "bits" for uint8 [B, L] or "bytes" for uint8 [B, ceil(L / 8)]
        (MSb-first, the trailing byte zero-padded).
      message_bits: L, default and at most max(t_actual - S, 0).
    Returns the decoded bits, bit-identical to `ops.viterbi.viterbi_decode`
    (hard) and `ops.metrics.viterbi_decode_soft` on the floored LLRs.
    """
    L = _check(spec, x, t_actual, soft, out, message_bits)
    if not _check_device(x):
        return block_decode_1p_plain(spec, x, t_actual, soft, out, L)
    B = x.shape[0]
    x = x[:, :t_actual].contiguous()
    width = (L + 7) // 8 if out == "bytes" else L
    result = torch.empty((B, width), dtype=torch.uint8, device=x.device)
    if B == 0:
        return result
    from . import _build
    cb = _butterfly_table(spec, x.device)
    code = _build.library().block_decode_1p(
        x.data_ptr(), int(soft), cb.data_ptr(), result.data_ptr(), B,
        t_actual, spec.num_states, spec.n, spec.S, L, int(out == "bytes"),
        init_metric_value(spec),
        torch.cuda.current_stream(x.device).cuda_stream)
    LAUNCHES["block_decode_1p"] += 1
    _build.check("block_decode_1p", code)
    return result


def _block_decode_1p(spec: CodeSpec, segments_padded: torch.Tensor,
                     t_actual: int, soft: bool) -> torch.Tensor:
    """The JAX package's name and layout (acs_pallas.py:2150): segments
    padded to T_pad steps (a multiple of 8; hard [B, T_pad], soft
    [B, T_pad, n]) -> uint8 packed rows [T_pad / 8, B], bit j of row g the
    decoded bit of step 8 g + j: the message bits, then zeros (the S
    termination steps decode to 0 and the padded steps are masked)."""
    B, T_pad = segments_padded.shape[:2]
    if T_pad % PACK:
        raise ValueError(f"T_pad = {T_pad} is not a multiple of {PACK}")
    bits = block_decode_1p(spec, segments_padded, t_actual, soft)
    bits = torch.nn.functional.pad(bits, (0, T_pad - bits.shape[1]))
    return pack_bits(bits, "little").T.contiguous()
