"""Plain tensor operations: bits, encoder, channel, trellis, soft metrics,
puncturing, CRC, rate matching, reference decoders (block, streaming,
tail-biting and max-log-MAP), and the turbo code with its LTE chain.

`ops.streaming` (the streaming classes) runs on the kernels' wrappers, so
the package imports it after `kernels`, not here."""

from .bits import (int_to_bits, pack_bits, pack_bits_np, parity32,
                   parity32_np, popcount32, unpack_bits, unpack_bits_np)
from .crc import (CRC6_NR, CRC8_LTE, CRC11_NR, CRC16_CCITT, CRC24A, CRC24B,
                  CrcSpec, crc_append, crc_bits, crc_check, crc_remainder_np)
from .channel import (awgn, bits_to_segments, bpsk_llr, bpsk_modulate, bsc,
                      bsc_segments, hard_decision, segments_to_bits,
                      uncoded_ber_bpsk)
from .encode import encode_bits, encode_bits_np, encode_bytes, encode_one_input
from .lte import (LTE_BLOCK_SIZES, Z_MAX, derate_match_turbo,
                  desegment_tb, dlsch_block_sizes, dlsch_rate_match_sizes,
                  lte_dlsch_decode, lte_dlsch_encode, lte_qpp,
                  lte_turbo_decode, lte_turbo_decode_early, lte_turbo_encode,
                  lte_turbo_encode_batch, rate_match_turbo, segment_sizes,
                  segment_tb, turbo_demux_tails, turbo_mux_streams,
                  turbo_ratematch_indices)
from .maxlogmap import maxlogmap_decode, maxlogmap_llrs, maxlogmap_llrs_batch
from .metrics import (DEFAULT_QMAX, hard_bits_to_qllrs, quantize_llrs,
                      soft_step_metrics, viterbi_decode_ragged_soft,
                      viterbi_decode_soft, viterbi_forward_butterfly_soft)
from .puncture import (PUNCTURE_2_3, PUNCTURE_3_4, PUNCTURE_5_6,
                       check_pattern_rows, depuncture_llrs, puncture_bits,
                       puncture_mask, punctured_rate)
from .ratematch import (circular_buffer_map, derate_match, rate_match,
                        rate_match_segments, ratematch_indices,
                        subblock_interleave_map)
from .tailbiting import (circular_extend, default_wrap, encode_tailbiting,
                         tail_state, viterbi_decode_tailbiting,
                         viterbi_decode_tailbiting_exact,
                         viterbi_decode_tailbiting_list,
                         viterbi_decode_tailbiting_list_soft,
                         viterbi_decode_tailbiting_soft)
from .turbo import (LA_CLAMP, QPP_TABLE, RscSpec, qpp_interleaver,
                    rsc_encode_batch, rsc_encode_batch_np, rsc_encode_np,
                    rsc_maxlogmap, rsc_tables, turbo_decode,
                    turbo_decode_batch, turbo_encode_batch,
                    turbo_encode_batch_np, turbo_encode_np)
from .trellis import (butterfly_coded_bits, edge_coded_bits,
                      next_state_table, prev_state_table)
from .viterbi import (hard_step_metrics, init_metric_value, ragged_epilogue,
                      stream_scan, traceback_terminated, viterbi_decode,
                      viterbi_decode_bytes, viterbi_decode_ragged,
                      viterbi_decode_stream, viterbi_decode_stream_soft,
                      viterbi_forward, viterbi_forward_butterfly)

__all__ = [
    "pack_bits", "unpack_bits", "pack_bits_np", "unpack_bits_np",
    "int_to_bits", "parity32", "popcount32", "encode_one_input",
    "encode_bits_np", "awgn", "bits_to_segments", "bpsk_llr",
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
    "viterbi_forward_butterfly", "CRC6_NR", "CRC8_LTE", "CRC11_NR",
    "CRC16_CCITT", "CRC24A", "CRC24B", "CrcSpec", "crc_append", "crc_bits",
    "crc_check", "crc_remainder_np", "circular_buffer_map", "derate_match",
    "rate_match", "rate_match_segments", "ratematch_indices",
    "subblock_interleave_map", "circular_extend", "default_wrap",
    "encode_tailbiting", "tail_state", "viterbi_decode_tailbiting",
    "viterbi_decode_tailbiting_exact", "viterbi_decode_tailbiting_list",
    "viterbi_decode_tailbiting_list_soft", "viterbi_decode_tailbiting_soft",
    "parity32_np", "LTE_BLOCK_SIZES", "Z_MAX", "derate_match_turbo",
    "desegment_tb", "dlsch_block_sizes", "dlsch_rate_match_sizes",
    "lte_dlsch_decode", "lte_dlsch_encode", "lte_qpp", "lte_turbo_decode",
    "lte_turbo_decode_early", "lte_turbo_encode", "lte_turbo_encode_batch",
    "rate_match_turbo", "segment_sizes", "segment_tb", "turbo_demux_tails",
    "turbo_mux_streams", "turbo_ratematch_indices", "maxlogmap_decode",
    "maxlogmap_llrs", "maxlogmap_llrs_batch", "LA_CLAMP", "QPP_TABLE",
    "RscSpec", "qpp_interleaver", "rsc_encode_batch", "rsc_encode_batch_np",
    "rsc_encode_np", "rsc_maxlogmap", "rsc_tables", "turbo_decode",
    "turbo_decode_batch", "turbo_encode_batch", "turbo_encode_batch_np",
    "turbo_encode_np",
]
