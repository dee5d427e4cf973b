"""Plain tensor operations: bits, encoder, channel, trellis, reference
decoders."""

from .bits import pack_bits, unpack_bits
from .channel import bsc_segments
from .encode import encode_bits, encode_bytes
from .trellis import (butterfly_coded_bits, edge_coded_bits,
                      next_state_table, prev_state_table)
from .viterbi import (hard_step_metrics, init_metric_value, traceback_terminated,
                      viterbi_decode, viterbi_decode_bytes, viterbi_forward,
                      viterbi_forward_butterfly)

__all__ = [
    "pack_bits", "unpack_bits", "bsc_segments", "encode_bits", "encode_bytes",
    "butterfly_coded_bits", "edge_coded_bits", "next_state_table",
    "prev_state_table", "hard_step_metrics", "init_metric_value",
    "traceback_terminated", "viterbi_decode", "viterbi_decode_bytes",
    "viterbi_forward", "viterbi_forward_butterfly",
]
