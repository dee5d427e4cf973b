"""convolutionalencdec_tpu_torch: the PyTorch + CUDA port.

Batched convolutional encoding and hard- and soft-decision Viterbi block
decoding (punctured and ragged too, and hard decoding of any rate-k/n
code), streaming decoding and the tail-biting receive chain (wrap and
list decodes, CRC, LTE rate matching), max-log-MAP soft output and the
LTE turbo receive chain on an NVIDIA Hopper GPU, with the forward ACS
(butterfly and generic 2^k-way), the tracebacks (one walk or a list of
walks per channel), the single-pass decode (forward and walk in one
launch), the register-exchange stream decode, the max-log-MAP and the
turbo constituent MAP as CUDA C++ kernels written for `sm_90a`
(`csrc/`); the BER, curve and speed harnesses (`harness`).  The JAX
package `convolutionalencdec_tpu` is its reference; this package imports
torch and numpy, never jax.

    import convolutionalencdec_tpu_torch as fec
    segs, _ = fec.encode_bits(fec.NASA_K7, bits)          # uint8 [B, T]
    out = fec.viterbi_decode_batch_bytes(fec.NASA_K7, segs)
    k2 = fec.CodeSpec(K=4, k=2, g=(0o133, 0o171, 0o266))  # rate 2/3
    out = fec.viterbi_decode_batch(k2, fec.encode_bits(k2, bits)[0])
    q = fec.quantize_llrs(fec.bpsk_llr(received, ebn0_db, rate))
    out = fec.viterbi_decode_batch_soft_bytes(fec.NASA_K7, q.reshape(B, T, 2))
    dec = fec.StreamingDecoderBatch(fec.NASA_K7, B)       # decode delay 5K
    bits = dec.decode(segs[:, :256])                      # ... last=True
    blocks = fec.crc_append(fec.CRC16_CCITT, payload)     # [B, 40 + 16]
    tx = fec.rate_match(fec.segments_to_bits(
        fec.encode_tailbiting(fec.LTE_TBCC_K7, blocks), 3), fec.LTE_TBCC_K7,
        56, 288)                                          # 288 channel bits
    bits, ok, chosen = fec.viterbi_decode_batch_tailbiting_ratematched_crc(
        fec.LTE_TBCC_K7, fec.CRC16_CCITT, q_rx, 56)       # q_rx [B, 288]
    llrs = fec.maxlogmap_llrs_batch_kernel(fec.NASA_K7, q8)  # int32 [B, T]
    tx = fec.lte_turbo_encode_batch(fec.crc_append(fec.CRC24B, payload),
                                    2056)                 # [B, 2056] bits
    bits, lapp, ok, iters = fec.lte_turbo_decode_early(q, 1024)
    fec.harness.run_reference_ber_test(fec.NASA_K7, n_packets=30000)

A tensor input keeps its own device; any other input goes to the card
unless the call passes `device="cpu"`.
"""

from . import harness, kernels, ops
from .ops import (channel, crc, lte, maxlogmap, metrics, puncture, ratematch,
                  tailbiting, turbo)
from .ops import (CRC6_NR, CRC8_LTE, CRC11_NR, CRC16_CCITT, CRC24A, CRC24B,
                  DEFAULT_QMAX, LA_CLAMP, LTE_BLOCK_SIZES, PUNCTURE_2_3,
                  PUNCTURE_3_4, PUNCTURE_5_6, CrcSpec, RscSpec, awgn,
                  bits_to_segments, bpsk_llr, bpsk_modulate,
                  bsc, bsc_segments, check_pattern_rows, crc_append,
                  crc_bits, crc_check, depuncture_llrs, derate_match,
                  desegment_tb,
                  encode_bits, encode_bytes, encode_tailbiting,
                  hard_bits_to_qllrs, hard_decision, lte_dlsch_decode,
                  lte_dlsch_encode, lte_qpp, lte_turbo_decode,
                  lte_turbo_decode_early, lte_turbo_encode,
                  lte_turbo_encode_batch, maxlogmap_decode, maxlogmap_llrs,
                  maxlogmap_llrs_batch, pack_bits, qpp_interleaver,
                  puncture_bits, puncture_mask, punctured_rate,
                  quantize_llrs, rate_match, rate_match_segments,
                  rsc_encode_batch, segment_tb, segments_to_bits,
                  soft_step_metrics, tail_state, turbo_decode,
                  turbo_decode_batch, turbo_encode_batch, turbo_encode_np,
                  traceback_terminated, uncoded_ber_bpsk, unpack_bits,
                  viterbi_decode, viterbi_decode_bytes,
                  viterbi_decode_ragged, viterbi_decode_ragged_soft,
                  viterbi_decode_soft, viterbi_decode_stream,
                  viterbi_decode_stream_soft, viterbi_decode_tailbiting,
                  viterbi_decode_tailbiting_exact,
                  viterbi_decode_tailbiting_list,
                  viterbi_decode_tailbiting_list_soft,
                  viterbi_decode_tailbiting_soft, viterbi_forward,
                  viterbi_forward_butterfly, viterbi_forward_butterfly_soft)
from .kernels import (maxlogmap_llrs_batch_kernel, rsc_maxlogmap_batch_kernel,
                      select_kernel, turbo_decode_batch_kernel,
                      turbo_decode_batch_kernel_early,
                      viterbi_decode_batch,
                      viterbi_decode_batch_bytes,
                      viterbi_decode_batch_bytes_ragged,
                      viterbi_decode_batch_generic, viterbi_decode_batch_k2,
                      viterbi_decode_batch_punctured,
                      viterbi_decode_batch_punctured_soft,
                      viterbi_decode_batch_ragged, viterbi_decode_batch_soft,
                      viterbi_decode_batch_soft_bytes,
                      viterbi_decode_batch_soft_bytes_ragged,
                      viterbi_decode_batch_tailbiting,
                      viterbi_decode_batch_tailbiting_bytes,
                      viterbi_decode_batch_tailbiting_crc,
                      viterbi_decode_batch_tailbiting_crc_soft,
                      viterbi_decode_batch_tailbiting_list,
                      viterbi_decode_batch_tailbiting_list_soft,
                      viterbi_decode_batch_tailbiting_punctured_crc,
                      viterbi_decode_batch_tailbiting_ratematched_crc,
                      viterbi_decode_batch_tailbiting_soft,
                      viterbi_decode_batch_tailbiting_soft_bytes)
from .ops import streaming
from .ops.streaming import (BlockStreamingDecoderBatch, StreamingDecoder,
                            StreamingDecoderBatch, StreamingEncoder)
from .params import (K5_23_35, K9_561_753, LTE_TBCC_K7, NASA_K7, NASA_K7_R13,
                     PRESETS, REF_K7, TOY_K3, CodeSpec, from_reference)

__all__ = [
    "harness", "kernels", "ops", "CRC6_NR", "CRC8_LTE", "CRC11_NR",
    "CRC16_CCITT", "CRC24A", "CRC24B", "CrcSpec", "crc_append", "crc_bits", "crc_check",
    "derate_match", "encode_tailbiting", "rate_match", "rate_match_segments",
    "tail_state", "viterbi_decode_tailbiting",
    "viterbi_decode_tailbiting_exact", "viterbi_decode_tailbiting_list",
    "viterbi_decode_tailbiting_list_soft", "viterbi_decode_tailbiting_soft",
    "viterbi_decode_batch_tailbiting",
    "viterbi_decode_batch_tailbiting_bytes",
    "viterbi_decode_batch_tailbiting_crc",
    "viterbi_decode_batch_tailbiting_crc_soft",
    "viterbi_decode_batch_tailbiting_list",
    "viterbi_decode_batch_tailbiting_list_soft",
    "viterbi_decode_batch_tailbiting_punctured_crc",
    "viterbi_decode_batch_tailbiting_ratematched_crc",
    "viterbi_decode_batch_tailbiting_soft",
    "viterbi_decode_batch_tailbiting_soft_bytes", "DEFAULT_QMAX", "PUNCTURE_2_3", "PUNCTURE_3_4",
    "PUNCTURE_5_6", "awgn", "bits_to_segments", "bpsk_llr", "bpsk_modulate",
    "bsc", "bsc_segments", "check_pattern_rows", "depuncture_llrs",
    "encode_bits", "encode_bytes", "hard_bits_to_qllrs", "hard_decision",
    "pack_bits", "puncture_bits", "puncture_mask", "punctured_rate",
    "quantize_llrs", "segments_to_bits", "soft_step_metrics",
    "traceback_terminated", "uncoded_ber_bpsk", "unpack_bits",
    "viterbi_decode", "viterbi_decode_bytes", "viterbi_decode_ragged",
    "viterbi_decode_ragged_soft", "viterbi_decode_soft",
    "viterbi_decode_stream", "viterbi_decode_stream_soft", "viterbi_forward",
    "viterbi_forward_butterfly", "viterbi_forward_butterfly_soft",
    "select_kernel", "viterbi_decode_batch", "viterbi_decode_batch_bytes",
    "viterbi_decode_batch_bytes_ragged", "viterbi_decode_batch_punctured",
    "viterbi_decode_batch_punctured_soft", "viterbi_decode_batch_ragged",
    "viterbi_decode_batch_soft", "viterbi_decode_batch_soft_bytes",
    "viterbi_decode_batch_soft_bytes_ragged", "streaming",
    "BlockStreamingDecoderBatch", "StreamingDecoder", "StreamingDecoderBatch",
    "StreamingEncoder", "K5_23_35", "K9_561_753", "LTE_TBCC_K7", "NASA_K7",
    "NASA_K7_R13", "PRESETS", "REF_K7", "TOY_K3", "CodeSpec", "from_reference",
    "LA_CLAMP", "LTE_BLOCK_SIZES", "RscSpec", "lte_dlsch_decode",
    "lte_dlsch_encode", "lte_qpp", "lte_turbo_decode",
    "lte_turbo_decode_early", "lte_turbo_encode", "lte_turbo_encode_batch",
    "maxlogmap_decode", "maxlogmap_llrs", "maxlogmap_llrs_batch",
    "qpp_interleaver", "turbo_decode", "turbo_decode_batch",
    "turbo_encode_batch", "maxlogmap_llrs_batch_kernel",
    "rsc_maxlogmap_batch_kernel", "turbo_decode_batch_kernel",
    "turbo_decode_batch_kernel_early", "viterbi_decode_batch_generic",
    "viterbi_decode_batch_k2", "channel", "crc", "lte", "maxlogmap",
    "metrics", "puncture", "ratematch", "tailbiting", "turbo", "segment_tb",
    "desegment_tb", "turbo_encode_np", "rsc_encode_batch",
]
