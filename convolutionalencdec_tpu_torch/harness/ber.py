"""BER validation harness: the berTestK7 equivalent.

Port of `convolutionalencdec_tpu/harness/ber.py`.  The reference codebase's
acceptance test pushes tens of megabits through encode -> IID bit-flip
channel -> decode at three SNR operating points and requires the measured
coded BER to sit within 10% relative error of the MATLAB vitdec
expectations (berTestK7.c:15, 95-100, 167-172).

Packets are batched as channels and decoded by the batched entry
(`kernels.viterbi_decode_batch`): on the card its CUDA kernels, whichever
route the code takes; on a CPU (`device="cpu"`) their plain versions.  The
messages and the channel draw from one `torch.Generator` per operating
point, seeded with `seed`; its numbers are not `jax.random`'s, so the
results agree with the JAX package's statistically, not bit for bit.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Sequence

import torch

from .._device import resolve
from ..kernels.decode import viterbi_decode_batch
from ..ops.channel import bsc_segments, uncoded_ber_bpsk
from ..ops.encode import encode_bits
from ..params import NASA_K7, CodeSpec

#: The reference's three operating points (berTestK7.c:95-103): BPSK at
#: SNR in {-5, -4, -3} dB with 4x oversampling, i.e. uncoded BERs p, and the
#: expected coded BERs from MATLAB vitdec full-traceback simulation
#: (viterbiBEREstimate.m:99), for the (133, 171) code those scripts
#: simulate (viterbiBEREstimate.m:11).
BER_EXPECTED_K7 = (
    # (snr_db, uncoded_ber, expected_coded_ber)
    (-5.0, 5.5856e-2, 4.765898e-3),
    (-4.0, 3.7162e-2, 5.184082e-4),
    (-3.0, 2.2622e-2, 3.499023e-5),
)

#: Pass threshold: 10% relative error (berTestK7.c:15).
ALLOWED_RELATIVE_ERROR = 0.10


@dataclasses.dataclass
class BerPointResult:
    snr_db: float
    uncoded_ber: float
    expected_coded_ber: float | None
    measured_coded_ber: float
    measured_uncoded_ber: float
    bits_tested: int
    errors: int

    @property
    def relative_error(self) -> float | None:
        if self.expected_coded_ber is None:
            return None
        return abs(self.measured_coded_ber - self.expected_coded_ber) / \
            self.expected_coded_ber

    @property
    def passed(self) -> bool | None:
        rel = self.relative_error
        return None if rel is None else rel <= ALLOWED_RELATIVE_ERROR


def random_bits(generator: torch.Generator, shape,
                device: torch.device) -> torch.Tensor:
    """uint8 0/1 bits of `shape`, fair coins from `generator`."""
    return torch.randint(0, 2, shape, generator=generator, device=device,
                         dtype=torch.uint8)


def _gen_and_corrupt(spec: CodeSpec, generator: torch.Generator,
                     n_packets: int, packet_bits: int, p: float,
                     device: torch.device):
    msgs = random_bits(generator, (n_packets, packet_bits), device)
    coded, _ = encode_bits(spec, msgs)
    noisy = bsc_segments(coded, spec.n, p, generator=generator)
    return msgs, coded, noisy


def ber_point(spec: CodeSpec, uncoded_ber: float, *, n_packets: int = 10000,
              packet_bits: int = 2048, seed: int = 9865,
              batch: int = 1024, decoder: Callable | None = None,
              snr_db: float = float("nan"),
              expected: float | None = None, device=None) -> BerPointResult:
    """Measure coded BER at one operating point.

    One iteration of berTestK7's configuration loop (berTestK7.c:109-174):
    random packets, encode, IID coded-bit flips at `uncoded_ber`, decode,
    count errors, `batch` packets at a time on `device` (default the CUDA
    card).  `decoder` maps uint8 segments [b, T] to bits [b, packet_bits]
    (default `viterbi_decode_batch` of `spec`).
    """
    device = resolve(device)
    decoder = decoder or functools.partial(viterbi_decode_batch, spec)
    gen = torch.Generator(device=device).manual_seed(seed)
    err = torch.zeros((), dtype=torch.int64, device=device)
    chan_err = torch.zeros((), dtype=torch.int64, device=device)
    total_bits = total_coded_bits = done = 0
    while done < n_packets:
        nb = min(batch, n_packets - done)
        msgs, coded, noisy = _gen_and_corrupt(spec, gen, nb, packet_bits,
                                              uncoded_ber, device)
        err += (decoder(noisy) != msgs).sum()
        # Channel sanity accounting (berTestK7.c:151-152).
        x = coded ^ noisy
        for j in range(spec.n):
            chan_err += ((x >> j) & 1).sum()
        total_bits += msgs.numel()
        total_coded_bits += x.numel() * spec.n
        done += nb
    errors = int(err)
    return BerPointResult(
        snr_db=snr_db,
        uncoded_ber=uncoded_ber,
        expected_coded_ber=expected,
        measured_coded_ber=errors / total_bits,
        measured_uncoded_ber=int(chan_err) / total_coded_bits,
        bits_tested=total_bits,
        errors=errors,
    )


def run_reference_ber_test(spec: CodeSpec = NASA_K7, *,
                           n_packets: int = 10000, packet_bits: int = 2048,
                           seed: int = 9865, decoder: Callable | None = None,
                           verbose: bool = True, batch: int = 1024,
                           device=None) -> list[BerPointResult]:
    """The full berTestK7 acceptance run: 3 SNR points x n_packets packets.

    Returns the per-point results; every point must satisfy
    `result.passed` (<= 10% relative error against the MATLAB
    expectation).  The -3 dB point needs >= 30k packets for converged
    statistics (RESULTS.md:12-21).
    """
    results = []
    for snr_db, p, expected in BER_EXPECTED_K7:
        r = ber_point(spec, p, n_packets=n_packets, packet_bits=packet_bits,
                      seed=seed, batch=batch, decoder=decoder, snr_db=snr_db,
                      expected=expected, device=device)
        if verbose:
            print(f"SNR {snr_db:+.0f} dB: coded BER {r.measured_coded_ber:.6e}"
                  f" vs expected {expected:.6e}"
                  f" ({100 * r.relative_error:.2f}% err)"
                  f" [{'PASS' if r.passed else 'FAIL'}]")
        results.append(r)
    return results


def ber_sweep(spec: CodeSpec, snrs_db: Sequence[float], *,
              oversample: int = 4, n_packets: int = 1000,
              packet_bits: int = 2048, seed: int = 0,
              decoder: Callable | None = None,
              device=None) -> list[BerPointResult]:
    """BER curve over arbitrary SNR points, with the BPSK-matched uncoded
    BER mapping the reference uses (berTestK7.c:103)."""
    return [
        ber_point(spec, uncoded_ber_bpsk(s, oversample), n_packets=n_packets,
                  packet_bits=packet_bits, seed=seed, decoder=decoder,
                  snr_db=s, device=device)
        for s in snrs_db
    ]
