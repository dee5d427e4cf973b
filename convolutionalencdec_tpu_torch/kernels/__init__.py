"""Hand-written CUDA kernels for Hopper and their batched entry points.

Importing this package builds nothing and needs no CUDA toolkit: the
kernels are compiled by `nvcc` at their first launch (see `_build`).
"""

from .acs import (LAUNCHES, acs_forward_batch, acs_forward_batch_plain,
                  kernel_supports, pack_decisions, traceback_batch,
                  traceback_batch_plain, unpack_decisions)
from .decode import (BUTTERFLY, GENERIC, select_kernel, viterbi_decode_batch,
                     viterbi_decode_batch_bytes)

__all__ = [
    "LAUNCHES", "acs_forward_batch", "acs_forward_batch_plain",
    "kernel_supports", "pack_decisions", "traceback_batch",
    "traceback_batch_plain", "unpack_decisions", "BUTTERFLY", "GENERIC",
    "select_kernel", "viterbi_decode_batch", "viterbi_decode_batch_bytes",
]
