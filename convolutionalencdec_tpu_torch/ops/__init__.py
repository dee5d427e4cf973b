"""Plain tensor operations: bits, encoder, channel, trellis, soft metrics,
puncturing, reference decoders.

`ops.streaming` (the streaming classes) runs on the kernels' wrappers, so
the package imports it after `kernels`, not here."""

from .bits import pack_bits, unpack_bits
from .channel import (awgn, bits_to_segments, bpsk_llr, bpsk_modulate, bsc,
                      bsc_segments, hard_decision, segments_to_bits,
                      uncoded_ber_bpsk)
from .encode import encode_bits, encode_bytes
from .metrics import (DEFAULT_QMAX, hard_bits_to_qllrs, quantize_llrs,
                      soft_step_metrics, viterbi_decode_ragged_soft,
                      viterbi_decode_soft, viterbi_forward_butterfly_soft)
from .puncture import (PUNCTURE_2_3, PUNCTURE_3_4, PUNCTURE_5_6,
                       check_pattern_rows, depuncture_llrs, puncture_bits,
                       puncture_mask, punctured_rate)
from .trellis import (butterfly_coded_bits, edge_coded_bits,
                      next_state_table, prev_state_table)
from .viterbi import (hard_step_metrics, init_metric_value, ragged_epilogue,
                      stream_scan, traceback_terminated, viterbi_decode,
                      viterbi_decode_bytes, viterbi_decode_ragged,
                      viterbi_decode_stream, viterbi_decode_stream_soft,
                      viterbi_forward, viterbi_forward_butterfly)

__all__ = [
    "pack_bits", "unpack_bits", "awgn", "bits_to_segments", "bpsk_llr",
    "bpsk_modulate", "bsc", "bsc_segments", "hard_decision",
    "segments_to_bits", "uncoded_ber_bpsk", "encode_bits", "encode_bytes",
    "DEFAULT_QMAX", "hard_bits_to_qllrs", "quantize_llrs",
    "soft_step_metrics", "viterbi_decode_ragged_soft", "viterbi_decode_soft",
    "viterbi_forward_butterfly_soft", "PUNCTURE_2_3", "PUNCTURE_3_4",
    "PUNCTURE_5_6", "check_pattern_rows", "depuncture_llrs", "puncture_bits",
    "puncture_mask", "punctured_rate", "butterfly_coded_bits",
    "edge_coded_bits", "next_state_table", "prev_state_table",
    "hard_step_metrics", "init_metric_value", "ragged_epilogue",
    "stream_scan", "traceback_terminated", "viterbi_decode",
    "viterbi_decode_bytes", "viterbi_decode_ragged", "viterbi_decode_stream",
    "viterbi_decode_stream_soft", "viterbi_forward",
    "viterbi_forward_butterfly",
]
