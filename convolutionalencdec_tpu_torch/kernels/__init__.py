"""Hand-written CUDA kernels for Hopper and their batched entry points.

Importing this package builds nothing and needs no CUDA toolkit: the
kernels are compiled by `nvcc` at their first launch (see `_build`).
"""

from .acs import (LAUNCHES, acs_forward_batch, acs_forward_batch_plain,
                  acs_forward_batch_soft, acs_forward_batch_soft_plain,
                  condition_qllrs, kernel_supports, pack_decisions,
                  traceback_batch, traceback_batch_masked,
                  traceback_batch_masked_plain, traceback_batch_plain,
                  traceback_batch_ragged, traceback_batch_ragged_plain,
                  unpack_decisions)
from .decode import (BUTTERFLY, GENERIC, SOFT, SOFT8, select_kernel,
                     soft_qclip, swar8_soft_supported, swar_layout_supported,
                     swar_supported,
                     viterbi_decode_batch, viterbi_decode_batch_bytes,
                     viterbi_decode_batch_bytes_ragged,
                     viterbi_decode_batch_punctured,
                     viterbi_decode_batch_punctured_soft,
                     viterbi_decode_batch_ragged, viterbi_decode_batch_soft,
                     viterbi_decode_batch_soft_bytes,
                     viterbi_decode_batch_soft_bytes_ragged)
from .stream import (StreamState, stream_decode_batch,
                     stream_decode_batch_plain, stream_decode_batch_soft,
                     stream_decode_batch_soft_plain, stream_kernel_supports,
                     stream_state_from_reference, stream_state_init,
                     stream_state_to_reference)

__all__ = [
    "LAUNCHES", "acs_forward_batch", "acs_forward_batch_plain",
    "acs_forward_batch_soft", "acs_forward_batch_soft_plain",
    "condition_qllrs", "kernel_supports", "pack_decisions", "traceback_batch",
    "traceback_batch_masked", "traceback_batch_masked_plain",
    "traceback_batch_plain", "traceback_batch_ragged",
    "traceback_batch_ragged_plain", "unpack_decisions", "BUTTERFLY",
    "GENERIC", "SOFT", "SOFT8", "select_kernel", "soft_qclip",
    "swar8_soft_supported", "swar_layout_supported", "swar_supported",
    "viterbi_decode_batch",
    "viterbi_decode_batch_bytes", "viterbi_decode_batch_bytes_ragged",
    "viterbi_decode_batch_punctured", "viterbi_decode_batch_punctured_soft",
    "viterbi_decode_batch_ragged", "viterbi_decode_batch_soft",
    "viterbi_decode_batch_soft_bytes",
    "viterbi_decode_batch_soft_bytes_ragged", "StreamState",
    "stream_decode_batch", "stream_decode_batch_plain",
    "stream_decode_batch_soft", "stream_decode_batch_soft_plain",
    "stream_kernel_supports", "stream_state_from_reference",
    "stream_state_init", "stream_state_to_reference",
]
