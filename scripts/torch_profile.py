#!/usr/bin/env python3
"""Where the time goes in the port's block and tail-biting decodes on one GPU.

    python3 scripts/torch_profile.py [--calls 20]

At bench.py's size (NASA_K7, B = 2048 x L = 2048, numpy seed 9865; hard:
a BSC flipping 1.5% of the coded bits; soft: BPSK over AWGN at Eb/N0 =
3 dB, 3-bit LLRs), for each of `viterbi_decode_batch_bytes`,
`viterbi_decode_batch_soft_bytes` and the tail-biting hard byte decode
`viterbi_decode_batch_tailbiting_bytes` (the same messages tail-biting
encoded), for the CRC-aided list chain
`viterbi_decode_batch_tailbiting_crc_soft` on DCI-sized blocks (LTE_TBCC_K7,
40-bit payload + CRC16, B = 16384, list 8, AWGN at Eb/N0 = 2 dB), for the
max-log-MAP LLRs `maxlogmap_llrs_batch_kernel` of the soft input, and for
the turbo serving call (`lte_turbo_decode_early` + `pack_bits` on 2048 LTE
code blocks of 1000 bits + CRC24B, E = 2056, AWGN at 2.0 dB, qmax 31), it
prints:
  - the device time per call from CUDA events, and the host time per call
    of the same back-to-back run (host clock, one synchronise at the end);
  - under torch.profiler, each CUDA kernel's summed device time per call
    and the device's busy share of the window (first kernel start to last
    kernel end);
  - the peak device memory of one call above its inputs;
  - for the turbo call, its device time split into the MAP kernels, the
    CRC's matrix product, the rest of the exchange glue, and the idle
    share of the window (the host refilling the queue after each
    iteration's `ok.all()` synchronisation), per iteration;
and once, the time of `encode_bits` (input set-up, not in the decode).
Needs a CUDA device; uses torch and numpy only.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
B, L, SEED, EBN0_DB = 2048, 2048, 9865, 3.0
DCI_B, DCI_PAYLOAD, DCI_LIST, DCI_EBN0 = 16384, 40, 8, 2.0
TURBO_B, TURBO_L, TURBO_EBN0, TURBO_QMAX = 2048, 1024, 2.0, 31


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def event_and_host_ms(fn, inputs):
    """(device ms per call from CUDA events, host ms per call) of calls
    enqueued back to back."""
    import torch
    for x in inputs[:3]:
        fn(x)
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    start.record()
    for x in inputs:
        fn(x)
    end.record()
    torch.cuda.synchronize()
    host = (time.perf_counter() - t0) * 1e3 / len(inputs)
    return start.elapsed_time(end) / len(inputs), host


def profile(fn, inputs):
    """(per-kernel device ms per call, busy share of the window, window ms
    per call) under torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    fn(inputs[0])
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        for x in inputs:
            fn(x)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("the profiler recorded no device time")
    by_name: dict[str, float] = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start) / 1e3
    first = min(e.time_range.start for e in kernels)
    last = max(e.time_range.end for e in kernels)
    window = (last - first) / 1e3
    busy = sum(by_name.values())
    n = len(inputs)
    return ({k: v / n for k, v in by_name.items()}, busy / window,
            window / n)


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_profile: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import convolutionalencdec_tpu_torch as fec
    parser = argparse.ArgumentParser()
    parser.add_argument("--calls", type=int, default=20)
    calls = parser.parse_args().calls
    dev = torch.device("cuda", 0)
    spec = fec.NASA_K7
    name = card()
    print(f"[card] {name}; torch {torch.__version__}")

    rng = np.random.default_rng(SEED)
    msgs = torch.from_numpy(
        rng.integers(0, 2, (B, L), dtype=np.uint8)).to(dev)
    encode_ms, encode_host = event_and_host_ms(
        lambda m: fec.encode_bits(spec, m), [msgs] * calls)
    seg, _ = fec.encode_bits(spec, msgs)
    hard = fec.bsc_segments(seg, spec.n, 0.03 / spec.n,
                            torch.Generator(device=dev).manual_seed(SEED))
    y = fec.awgn(fec.bpsk_modulate(fec.segments_to_bits(seg, spec.n)),
                 EBN0_DB, spec.rate,
                 generator=torch.Generator(device=dev).manual_seed(SEED))
    q = fec.quantize_llrs(fec.bpsk_llr(y, EBN0_DB, spec.rate)).reshape(
        B, -1, spec.n).to(torch.int8)
    tb_hard = fec.bsc_segments(fec.encode_tailbiting(spec, msgs), spec.n,
                               0.03 / spec.n,
                               torch.Generator(device=dev).manual_seed(SEED))
    lte, crc = fec.LTE_TBCC_K7, fec.CRC16_CCITT
    blocks = fec.crc_append(crc, torch.from_numpy(rng.integers(
        0, 2, (DCI_B, DCI_PAYLOAD), dtype=np.uint8)).to(dev))
    y = fec.awgn(fec.bpsk_modulate(fec.segments_to_bits(
        fec.encode_tailbiting(lte, blocks), lte.n)), DCI_EBN0, lte.rate,
        generator=torch.Generator(device=dev).manual_seed(SEED))
    q_dci = fec.quantize_llrs(fec.bpsk_llr(y, DCI_EBN0, lte.rate)).reshape(
        DCI_B, -1, lte.n).to(torch.int8)
    payload = torch.from_numpy(rng.integers(
        0, 2, (TURBO_B, TURBO_L - 24), dtype=np.uint8)).to(dev)
    E = 2 * (TURBO_L + 4)
    y = fec.awgn(fec.bpsk_modulate(fec.lte_turbo_encode_batch(
        fec.crc_append(fec.CRC24B, payload), E)), TURBO_EBN0, TURBO_L / E,
        generator=torch.Generator(device=dev).manual_seed(SEED))
    q_turbo = fec.quantize_llrs(fec.bpsk_llr(y, TURBO_EBN0, TURBO_L / E),
                                qmax=TURBO_QMAX)

    def serve(x):
        bits, _, ok, iters = fec.lte_turbo_decode_early(x, TURBO_L)
        return fec.pack_bits(bits), ok, iters

    fec.viterbi_decode_batch_bytes(spec, hard)  # build and load the kernels
    torch.cuda.synchronize()

    lines = [f"card: {name}", f"encode_bits: {encode_ms:.4f} ms per call "
             f"(CUDA events), host {encode_host:.4f} ms"]
    paths = {
        "hard viterbi_decode_batch_bytes": (
            lambda s: fec.viterbi_decode_batch_bytes(spec, s), hard),
        "soft viterbi_decode_batch_soft_bytes": (
            lambda x: fec.viterbi_decode_batch_soft_bytes(spec, x), q),
        "tail-biting hard viterbi_decode_batch_tailbiting_bytes": (
            lambda s: fec.viterbi_decode_batch_tailbiting_bytes(spec, s),
            tb_hard),
        "DCI viterbi_decode_batch_tailbiting_crc_soft": (
            lambda x: fec.viterbi_decode_batch_tailbiting_crc_soft(
                lte, crc, x, DCI_LIST), q_dci),
        "max-log-MAP maxlogmap_llrs_batch_kernel": (
            lambda x: fec.maxlogmap_llrs_batch_kernel(spec, x), q),
        "turbo lte_turbo_decode_early + pack_bits": (serve, q_turbo),
    }
    for label, (fn, x) in paths.items():
        inputs = [torch.roll(x, r + 1, dims=0) for r in range(calls)]
        dev_ms, host_ms = event_and_host_ms(fn, inputs)
        per_kernel, busy, window = profile(fn, inputs)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        fn(x)
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated(dev) - base) / 1e6
        lines.append(f"{label}: {dev_ms:.4f} ms per call (CUDA events, "
                     f"{calls} calls), host {host_ms:.4f} ms per call; "
                     f"profiled window {window:.4f} ms per call, device busy "
                     f"{100 * busy:.1f}%; peak memory {peak:.1f} MB above "
                     "the inputs")
        for k, ms in sorted(per_kernel.items(), key=lambda kv: -kv[1]):
            lines.append(f"    {ms:.4f} ms  {k[:100]}")
        if label.startswith("turbo"):
            iters = serve(x)[2]
            maps = sum(v for k, v in per_kernel.items() if "turbo_rsc" in k)
            crc_ms = sum(v for k, v in per_kernel.items() if "gemm" in k)
            glue = sum(per_kernel.values()) - maps - crc_ms
            idle = window * (1 - busy)
            lines.append(
                f"    {iters} iterations; per iteration: MAP kernels "
                f"{maps / iters:.4f} ms, CRC product {crc_ms / iters:.4f} "
                f"ms, other glue kernels {glue / iters:.4f} ms, idle "
                f"{idle / iters:.4f} ms of the profiled window")
    for line in lines:
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
