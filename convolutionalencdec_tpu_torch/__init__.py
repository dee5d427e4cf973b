"""convolutionalencdec_tpu_torch: the PyTorch + CUDA port.

Batched convolutional encoding and hard-decision Viterbi block decoding on
an NVIDIA Hopper GPU, with the forward ACS and the traceback as CUDA C++
kernels written for `sm_90a` (`csrc/`).  The JAX package
`convolutionalencdec_tpu` is its reference; this package imports torch and
numpy, never jax.

    import convolutionalencdec_tpu_torch as fec
    segs, _ = fec.encode_bits(fec.NASA_K7, bits)          # uint8 [B, T]
    out = fec.kernels.viterbi_decode_batch_bytes(fec.NASA_K7, segs)
"""

from . import kernels, ops
from .ops import (bsc_segments, encode_bits, encode_bytes, pack_bits,
                  traceback_terminated, unpack_bits, viterbi_decode,
                  viterbi_decode_bytes, viterbi_forward,
                  viterbi_forward_butterfly)
from .kernels import (select_kernel, viterbi_decode_batch,
                      viterbi_decode_batch_bytes)
from .params import (K5_23_35, K9_561_753, LTE_TBCC_K7, NASA_K7, NASA_K7_R13,
                     PRESETS, REF_K7, TOY_K3, CodeSpec, from_reference)

__all__ = [
    "kernels", "ops", "bsc_segments", "encode_bits", "encode_bytes",
    "pack_bits", "traceback_terminated", "unpack_bits", "viterbi_decode",
    "viterbi_decode_bytes", "viterbi_forward", "viterbi_forward_butterfly",
    "select_kernel", "viterbi_decode_batch", "viterbi_decode_batch_bytes",
    "K5_23_35", "K9_561_753", "LTE_TBCC_K7", "NASA_K7", "NASA_K7_R13",
    "PRESETS", "REF_K7", "TOY_K3", "CodeSpec", "from_reference",
]
