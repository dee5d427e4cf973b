"""Runtime code parameters for convolutional codes (numpy only).

The port's copy of `convolutionalencdec_tpu/params.py`: the same frozen,
hashable `CodeSpec` with the same fields, validation, derived properties
and presets, so that the port never has to import the JAX package (whose
`__init__` imports jax).  `tests/test_torch_params.py` holds the two
definitions equal.

Conventions (identical to the reference C codebase):
  * Generators are given in Proakis big-endian order: the MSB of each k*K-bit
    generator corresponds to the *most recent* input bit.  Internally they
    are bit-reversed so the LSb corresponds to the current input.
  * The encoder shift register shifts new bits into the LSb:
    ``delay' = (delay << 1) | bit``.  The state index is the low k*S bits of
    the delay, so bit ``i`` of a state is the input bit from ``i`` shifts ago.
  * Bytes are consumed/emitted MSb-first.
  * Packets are terminated by S all-zero input steps, which force the encoder
    back to state 0.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np


def bit_reverse(value: int, width: int) -> int:
    """Reverse the low `width` bits of `value`."""
    out = 0
    for _ in range(width):
        out = (out << 1) | (value & 1)
        value >>= 1
    return out


@dataclass(frozen=True)
class CodeSpec:
    """A rate-k/n convolutional code definition.

    Attributes:
      K: constraint length (number of k-bit stages influencing the output,
         including the current input).
      g: generator polynomials, one per output bit, in Proakis big-endian
         bit order over k*K bits (MSB = newest input).  len(g) == n.
      k: input bits shifted in per trellis step.
      starting_state: the state the shift register starts in (and the state
         the terminated packet ends in).  Only 0 is supported.
      traceback_len: survivor-path truncation depth for streaming decoders;
         0 selects the default 5*K.
    """

    K: int
    g: Tuple[int, ...]
    k: int = 1
    starting_state: int = 0
    traceback_len: int = 0  # 0 -> default 5*K, resolved in __post_init__

    def __post_init__(self):
        if self.K < 2:
            raise ValueError(f"K must be >= 2, got {self.K}")
        if self.k < 1:
            raise ValueError(f"k must be >= 1, got {self.k}")
        if not self.g:
            raise ValueError("need at least one generator polynomial")
        if self.k * self.K > 32:
            raise ValueError(f"k*K = {self.k * self.K} > 32 not supported")
        width = self.k * self.K
        for i, gi in enumerate(self.g):
            if gi <= 0 or gi >= (1 << width):
                raise ValueError(
                    f"g[{i}] = {gi:#o} does not fit in k*K = {width} bits"
                )
        if self.starting_state != 0:
            raise ValueError("only starting_state == 0 is supported")
        if self.traceback_len == 0:
            object.__setattr__(self, "traceback_len", 5 * self.K)
        object.__setattr__(self, "g", tuple(int(gi) for gi in self.g))

    @property
    def n(self) -> int:
        """Coded bits emitted per trellis step."""
        return len(self.g)

    @property
    def S(self) -> int:
        """State stages: S = K - 1."""
        return self.K - 1

    @property
    def rate(self) -> float:
        """Code rate Rc = k / n."""
        return self.k / self.n

    @property
    def num_states(self) -> int:
        """NUM_STATES = 2^(k*S)."""
        return 1 << (self.k * self.S)

    @property
    def num_edges_per_state(self) -> int:
        return 1 << self.k

    @property
    def delay_width(self) -> int:
        """Width of the tapped delay register in bits."""
        return self.k * self.K

    @property
    def g_reversed(self) -> Tuple[int, ...]:
        """Generators bit-reversed over k*K bits so the LSb taps the newest
        input bit."""
        return tuple(bit_reverse(gi, self.delay_width) for gi in self.g)

    @property
    def has_poly_symmetry(self) -> bool:
        """True iff k == 1 and every generator taps both the newest and the
        oldest bit: the condition for the butterfly decoder's
        single-edge-metric complement trick."""
        if self.k != 1:
            return False
        return all(
            ((gi >> (self.K - 1)) & 1) and (gi & 1) for gi in self.g
        )

    @property
    def metric_dtype(self):
        """Path-metric dtype of the unrenormalized decoders."""
        return np.int32

    def validate_for_butterfly(self) -> None:
        """Raise if this spec cannot use the poly-symmetry butterfly
        decoder."""
        if self.k != 1:
            raise ValueError("butterfly decoder requires k == 1")
        if not self.has_poly_symmetry:
            raise ValueError(
                "generators must tap both the newest and oldest bit for the "
                "poly-symmetry butterfly decoder"
            )

    def coded_segments_for(self, message_bits: int, terminate: bool = True) -> int:
        """Number of n-bit coded segments produced for a message: one per k
        message bits, plus S termination segments."""
        if message_bits % self.k != 0:
            raise ValueError(
                f"message length {message_bits} not a multiple of k={self.k}"
            )
        return message_bits // self.k + (self.S if terminate else 0)


def from_reference(spec_like) -> CodeSpec:
    """The port's `CodeSpec` for any object with the fields
    `K, g, k, starting_state, traceback_len` (for example the JAX
    package's `CodeSpec`).  The code and its trellis are this system's
    only parameters, so this carries a configuration across."""
    return CodeSpec(K=int(spec_like.K), g=tuple(int(x) for x in spec_like.g),
                    k=int(spec_like.k),
                    starting_state=int(spec_like.starting_state),
                    traceback_len=int(spec_like.traceback_len))


# ---- presets (the JAX package's, value for value) ----

#: The NASA-standard K=7 (133,171) code.
NASA_K7 = CodeSpec(K=7, g=(0o133, 0o171))

#: The code the reference C binary ships with: g[0] = 0113, not 0133.
REF_K7 = CodeSpec(K=7, g=(0o113, 0o171))

#: The K=3 toy code of the reference's hand-traced unit test.
TOY_K3 = CodeSpec(K=3, g=(0b111, 0b110))

#: K=5 (23, 35): a common small standard code.
K5_23_35 = CodeSpec(K=5, g=(0o23, 0o35))

#: K=9 (561, 753): the CDMA / IS-95 forward-link code, 256 states.
K9_561_753 = CodeSpec(K=9, g=(0o561, 0o753))

#: Rate-1/3 K=7 (133, 145, 175): exercises n=3.
NASA_K7_R13 = CodeSpec(K=7, g=(0o133, 0o145, 0o175))

#: The LTE tail-biting convolutional code (36.212 §5.1.3.1): K=7 rate-1/3
#: (133, 171, 165).
LTE_TBCC_K7 = CodeSpec(K=7, g=(0o133, 0o171, 0o165))

PRESETS = {
    "NASA_K7": NASA_K7, "REF_K7": REF_K7, "TOY_K3": TOY_K3,
    "K5_23_35": K5_23_35, "K9_561_753": K9_561_753,
    "NASA_K7_R13": NASA_K7_R13, "LTE_TBCC_K7": LTE_TBCC_K7,
}

