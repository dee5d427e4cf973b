"""Throughput harnesses: the speedEncode / speedDecode equivalents.

Port of `convolutionalencdec_tpu/harness/speed.py`.  The reference benches
(speedEncode.c:37-103, speedDecode.c:41-116) pre-generate a warm working
set, run the operation in a steady-state loop and report Mbit/s of
uncoded-side bits.  Here the working set is a batch of channels resident
on the card, NBUF row rotations of it, so that consecutive calls read
distinct inputs, and the time is the card's: CUDA events around each
window of calls.  No tag echo or dedup guard: the card runs every call it
is given.

The benches measure the card and nothing else: on a device that is not
CUDA they raise.

    python -m convolutionalencdec_tpu_torch.harness.speed [encode|decode|ragged]
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from .._device import resolve
from ..kernels.decode import (viterbi_decode_batch,
                              viterbi_decode_batch_bytes_ragged)
from ..ops.encode import encode_bits
from ..params import NASA_K7, CodeSpec
from ..utils.telemetry import describe

#: Distinct row rotations of a working set (the reference round-robins 16
#: packets, speedDecode.c:55-60).
NBUF = 8


def _card(device) -> torch.device:
    device = resolve(device)
    if device.type != "cuda":
        raise RuntimeError(f"the speed benches time the CUDA card, not "
                           f"{device}")
    return device


def _steady_loop(call, inputs, bits_per_call: int, seconds: float,
                 verbose: bool, label: str) -> float:
    """Device-timed steady state: windows of len(inputs) calls, one per
    input, a CUDA event before and after each window, until `seconds` of
    host time have passed (at least one window).  Returns decoded Mbit/s
    of device time."""
    call(inputs[0])                         # build and warm up
    torch.cuda.synchronize()
    bits = 0
    ms = 0.0
    deadline = time.perf_counter() + seconds
    while True:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for x in inputs:
            call(x)
        end.record()
        end.synchronize()
        window_ms = start.elapsed_time(end)
        bits += bits_per_call * len(inputs)
        ms += window_ms
        if verbose:
            print(f"{label}: {bits_per_call * len(inputs) / (window_ms * 1e3):.2f}"
                  " Mbit/s", flush=True)
        if time.perf_counter() >= deadline:
            return bits / (ms * 1e3)


def _ring(x: torch.Tensor) -> list[torch.Tensor]:
    """NBUF row rotations of a working set on the card."""
    return [torch.roll(x, r, dims=0) for r in range(NBUF)]


def _noisy_segments(spec: CodeSpec, rng, msgs: np.ndarray, flip_p: float,
                    device) -> torch.Tensor:
    """Encode on the card, then hit each segment with probability flip_p by
    a nonzero XOR mask (numpy draws)."""
    coded = encode_bits(spec, torch.from_numpy(msgs).to(device))[0]
    coded = coded.cpu().numpy()
    flip = rng.random(coded.shape) < flip_p
    coded ^= (flip * rng.integers(1, 1 << spec.n, coded.shape)).astype(
        np.uint8)
    return torch.from_numpy(coded).to(device)


def bench_encode(spec: CodeSpec = NASA_K7, *, batch: int = 1024,
                 packet_bits: int = 8192, seconds: float = 3.0,
                 verbose: bool = False, device=None) -> float:
    """Steady-state encoder throughput in Mbit/s of device time (uncoded
    bits consumed, the reference's metric, speedEncode.c:91-92)."""
    device = _card(device)
    rng = np.random.default_rng(16)   # 16 packets round-robin in the ref
    bits = torch.from_numpy(
        rng.integers(0, 2, (batch, packet_bits), dtype=np.uint8)).to(device)
    return _steady_loop(lambda b: encode_bits(spec, b)[0], _ring(bits),
                        batch * packet_bits, seconds, verbose, "encode")


def bench_decode(spec: CodeSpec = NASA_K7, *, batch: int = 1024,
                 packet_bits: int = 2048, seconds: float = 5.0,
                 flip_p: float = 0.03, verbose: bool = False,
                 device=None) -> float:
    """Steady-state decoder throughput in Mbit/s of device time (decoded
    bits, speedDecode.c:103-104), through `viterbi_decode_batch` on the
    route of `spec`."""
    device = _card(device)
    rng = np.random.default_rng(16)
    msgs = rng.integers(0, 2, (batch, packet_bits), dtype=np.uint8)
    coded = _noisy_segments(spec, rng, msgs, flip_p, device)
    return _steady_loop(lambda c: viterbi_decode_batch(spec, c), _ring(coded),
                        batch * packet_bits, seconds, verbose, "decode")


def bench_decode_ragged(spec: CodeSpec = NASA_K7, *, batch: int = 1024,
                        lengths=(2048,), seconds: float = 5.0,
                        flip_p: float = 0.03, verbose: bool = False,
                        device=None) -> float:
    """Steady-state ragged-batch decode throughput in Mbit/s of device time
    (the sum of the channels' message lengths per call), through
    `viterbi_decode_batch_bytes_ragged`.

    Channel b gets message length `lengths[b % len(lengths)]`.  One entry
    isolates the ragged machinery's cost against `bench_decode`; mixed
    lengths measure a mixed-traffic service rate, where the shorter
    channels' padding to Tmax is the cost.  The rotations keep each
    channel's segments and length together.
    """
    device = _card(device)
    rng = np.random.default_rng(16)
    lens = np.asarray([lengths[i % len(lengths)] for i in range(batch)])
    T = lens + spec.S
    segs = rng.integers(0, 1 << spec.n, (batch, int(T.max())), dtype=np.uint8)
    for L in sorted(set(int(x) for x in lens)):
        idx = np.nonzero(lens == L)[0]
        msgs = rng.integers(0, 2, (len(idx), L), dtype=np.uint8)
        segs[idx, :L + spec.S] = _noisy_segments(
            spec, rng, msgs, flip_p, device).cpu().numpy()
    segs = torch.from_numpy(segs).to(device)
    t_lens = torch.from_numpy(T.astype(np.int32)).to(device)
    pairs = list(zip(_ring(segs), _ring(t_lens)))
    return _steady_loop(
        lambda p: viterbi_decode_batch_bytes_ragged(spec, p[0], p[1]), pairs,
        int(lens.sum()), seconds, verbose, "ragged decode")


def main(argv):
    which = argv[1] if len(argv) > 1 else "decode"
    print(describe(NASA_K7))
    if which == "encode":
        print(f"encoder: {bench_encode(verbose=True):.2f} Mbit/s avg")
    elif which == "ragged":
        print(f"ragged (uniform 2048): "
              f"{bench_decode_ragged(verbose=True):.2f} Mbit/s avg")
        print(f"ragged (mixed 2048/1024/512/1536): "
              f"{bench_decode_ragged(lengths=(2048, 1024, 512, 1536), verbose=True):.2f}"
              f" Mbit/s avg")
    else:
        print(f"decoder: {bench_decode(verbose=True):.2f} Mbit/s avg")


if __name__ == "__main__":
    main(sys.argv)
