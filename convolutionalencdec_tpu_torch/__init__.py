"""convolutionalencdec_tpu_torch: the PyTorch + CUDA port.

Batched convolutional encoding and hard- and soft-decision Viterbi block
decoding (punctured and ragged too) and streaming decoding on an NVIDIA
Hopper GPU, with the forward ACS, the tracebacks and the register-exchange
stream decode as CUDA C++ kernels written for `sm_90a` (`csrc/`).  The JAX
package `convolutionalencdec_tpu` is its reference; this package imports
torch and numpy, never jax.

    import convolutionalencdec_tpu_torch as fec
    segs, _ = fec.encode_bits(fec.NASA_K7, bits)          # uint8 [B, T]
    out = fec.viterbi_decode_batch_bytes(fec.NASA_K7, segs)
    q = fec.quantize_llrs(fec.bpsk_llr(received, ebn0_db, rate))
    out = fec.viterbi_decode_batch_soft_bytes(fec.NASA_K7, q.reshape(B, T, 2))
    dec = fec.StreamingDecoderBatch(fec.NASA_K7, B)       # decode delay 5K
    bits = dec.decode(segs[:, :256])                      # ... last=True

A tensor input keeps its own device; any other input goes to the card
unless the call passes `device="cpu"`.
"""

from . import kernels, ops
from .ops import (DEFAULT_QMAX, PUNCTURE_2_3, PUNCTURE_3_4, PUNCTURE_5_6,
                  awgn, bits_to_segments, bpsk_llr, bpsk_modulate, bsc,
                  bsc_segments, check_pattern_rows, depuncture_llrs,
                  encode_bits, encode_bytes, hard_bits_to_qllrs,
                  hard_decision, pack_bits, puncture_bits, puncture_mask,
                  punctured_rate, quantize_llrs, segments_to_bits,
                  soft_step_metrics, traceback_terminated, uncoded_ber_bpsk,
                  unpack_bits, viterbi_decode, viterbi_decode_bytes,
                  viterbi_decode_ragged, viterbi_decode_ragged_soft,
                  viterbi_decode_soft, viterbi_decode_stream,
                  viterbi_decode_stream_soft, viterbi_forward,
                  viterbi_forward_butterfly, viterbi_forward_butterfly_soft)
from .kernels import (select_kernel, viterbi_decode_batch,
                      viterbi_decode_batch_bytes,
                      viterbi_decode_batch_bytes_ragged,
                      viterbi_decode_batch_punctured,
                      viterbi_decode_batch_punctured_soft,
                      viterbi_decode_batch_ragged, viterbi_decode_batch_soft,
                      viterbi_decode_batch_soft_bytes,
                      viterbi_decode_batch_soft_bytes_ragged)
from .ops import streaming
from .ops.streaming import (BlockStreamingDecoderBatch, StreamingDecoder,
                            StreamingDecoderBatch, StreamingEncoder)
from .params import (K5_23_35, K9_561_753, LTE_TBCC_K7, NASA_K7, NASA_K7_R13,
                     PRESETS, REF_K7, TOY_K3, CodeSpec, from_reference)

__all__ = [
    "kernels", "ops", "DEFAULT_QMAX", "PUNCTURE_2_3", "PUNCTURE_3_4",
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
]
