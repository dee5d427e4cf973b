#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port once on one NVIDIA GPU, and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. environment: the card (nvidia-smi), torch's CUDA, nvcc;
  2. build: compile csrc/*.cu for sm_90a (one nvcc per source, in parallel)
     and print the build time and the compiler's register/spill report;
  3. kernel against plain version on the card, every kernel-route preset
     and a K=8 code at B = 37, L = 203, plus the smallest shapes:
     - hard: light (3%) and heavy (25%) segment corruption; decision words,
       final metrics, bytes and bits;
     - soft: LLRs drawn from +-7, full int8 with -128, +-1, and +-7 with 20%
       zeros, each at qclip 7 and 127; decision words, final metrics, also
       from carried and from all-zero initial metrics, and the soft entry
       points' bits and bytes;
     - ragged: lengths 0, 1, S, S+1, T and random ones, bytes and bits;
  4. hard main path at full size: bench.py's working set (NASA_K7,
     B = 2048 channels x L = 2048 bits, numpy seed 9865, 3% segment
     corruption), encoded on the card and decoded with
     `viterbi_decode_batch_bytes`; BER < 2e-3, bytes equal to the plain
     decode on the card, both kernels' launch counters > 0;
  5. soft main path at full size: the same messages, BPSK over AWGN at
     Eb/N0 = 3 dB (a seeded generator on the card), `bpsk_llr`,
     `quantize_llrs(qmax=7)`, `viterbi_decode_batch_soft_bytes`; bytes equal
     to the plain soft decode on the card, soft BER in [3e-4, 1.3e-3], the
     hard decode of the same received values at least 10x the soft BER,
     launches of the soft forward and the traceback > 0;
  6. ragged and punctured at full size: lengths uniform in [S+1, T]
     through `viterbi_decode_batch_soft_bytes_ragged` and
     `viterbi_decode_batch_bytes_ragged`, and PUNCTURE_3_4 through
     `viterbi_decode_batch_punctured_soft`; each equal to its plain route
     on the card, launches > 0, BER printed;
  7. times: median and minimum of 20 calls on distinct inputs, CUDA events,
     for each kernel and the whole hard and soft byte decodes, beside the
     plain version's time and the kernel's bound.

The line before the last is one JSON object {"kernels": [...]}; the one
before it is the card's name and power limit; the last is {"ok": true,
"device": {"platform": "gpu", "kind": ..., "count": ...}}.  Uses torch and
numpy only.
"""

from __future__ import annotations

import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

KERNEL_PRESETS = ["NASA_K7", "REF_K7", "NASA_K7_R13", "LTE_TBCC_K7",
                  "K9_561_753"]
NOISE = [0.03, 0.25]
SMALL_B, SMALL_L = 37, 203
MAIN_B, MAIN_L, MAIN_SEED, MAIN_NOISE = 2048, 2048, 9865, 0.03
BER_LIMIT = 2e-3
EBN0_DB, QMAX = 3.0, 7
# RESULTS.md:84 measured 6.28e-4 for the 3-bit soft path and 3.10e-2 for
# the hard path at Eb/N0 = 3 dB: properties of the algorithm, not of a
# device.
SOFT_BER_WINDOW = (3e-4, 1.3e-3)
HARD_OVER_SOFT = 10.0
TIMED_CALLS = 20
KERNELS = ("acs_k1_forward", "traceback_k1", "acs_soft_k1_forward",
           "traceback_k1_ragged")
SOURCES = {
    "acs_k1_forward": ("convolutionalencdec_tpu_torch/csrc/acs_k1.cu",
                       "convolutionalencdec_tpu/kernels/acs_swar.py:847"),
    "traceback_k1": ("convolutionalencdec_tpu_torch/csrc/traceback_k1.cu",
                     "convolutionalencdec_tpu/kernels/acs_swar.py:877"),
    "acs_soft_k1_forward": (
        "convolutionalencdec_tpu_torch/csrc/acs_soft_k1.cu",
        "convolutionalencdec_tpu/kernels/acs_swar.py:1262 and :1381"),
    "traceback_k1_ragged": (
        "convolutionalencdec_tpu_torch/csrc/traceback_k1.cu",
        "convolutionalencdec_tpu/kernels/acs_swar.py:975"),
}
# The card's peaks for the bound (H100 SXM; NVIDIA's data sheet and Hopper
# white paper): 3.35 TB/s of HBM, and int32 at 132 SMs x 64 INT32 lanes x
# 1.98 GHz boost = 16.7 T operations/s.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
ACS_OPS = 6        # per butterfly and step: 4 adds, 2 compare-selects
TRACEBACK_OPS = 4  # per step: bit select, shift, or, emit


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def corrupt(rng, coded, p, n):
    """bench.py's channel: each segment is hit with probability p by a
    nonzero XOR mask."""
    flip = rng.random(coded.shape) < p
    mask = flip * rng.integers(1, 1 << n, coded.shape)
    return coded ^ mask.astype(coded.dtype)


def encode_reference_np(spec, msgs):
    """Independent encoder for the check: walk the trellis tables."""
    import numpy as np
    from convolutionalencdec_tpu_torch.ops.trellis import (edge_coded_bits,
                                                           next_state_table)
    ec, ns = edge_coded_bits(spec), next_state_table(spec)
    bits = np.concatenate(
        [msgs, np.zeros((msgs.shape[0], spec.S), np.uint8)], axis=1)
    state = np.zeros(msgs.shape[0], np.int64)
    out = np.empty(bits.shape, np.uint8)
    for t in range(bits.shape[1]):
        out[:, t] = ec[bits[:, t], state]
        state = ns[bits[:, t], state]
    return out


def max_abs_diff(a, b) -> int:
    import torch
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def device_times(fn, inputs) -> list[float]:
    """Per-call device milliseconds: calls enqueued back to back with an
    event between each, one synchronise at the end."""
    import torch
    for x in inputs[:3]:
        fn(x)
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(len(inputs) + 1)]
    events[0].record()
    for i, x in enumerate(inputs):
        fn(x)
        events[i + 1].record()
    torch.cuda.synchronize()
    return [events[i].elapsed_time(events[i + 1]) for i in range(len(inputs))]


def time_once(fn):
    """(result, device milliseconds) of one call."""
    import torch
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    result = fn()
    end.record()
    torch.cuda.synchronize()
    return result, start.elapsed_time(end)


def drive(acs, fn):
    """Run `fn` with every launch count set to 0 just before and read just
    after: (result, launches of that run)."""
    import torch
    torch.cuda.synchronize()
    for key in acs.LAUNCHES:
        acs.LAUNCHES[key] = 0
    result = fn()
    torch.cuda.synchronize()
    return result, dict(acs.LAUNCHES)


def ber_of_bytes(out, msgs, lengths=None) -> float:
    """Bit error rate of decoded bytes against the sent message bits; with
    lengths, only the live bits (t < t_b - S) of each row count."""
    import numpy as np
    got = np.unpackbits(out.cpu().numpy(), axis=1)[:, :msgs.shape[1]]
    if lengths is None:
        return float((got != msgs).mean())
    live = np.arange(msgs.shape[1])[None, :] < lengths[:, None]
    return float(((got != msgs) & live).sum() / live.sum())


def soft_channel(fec, spec, msgs_dev, generator, rate):
    """Encode on the card, BPSK over AWGN at EBN0_DB, channel LLRs: returns
    (segments [B, T], float32 LLRs [B, T * n]) on the card."""
    seg, _ = fec.encode_bits(spec, msgs_dev)
    symbols = fec.bpsk_modulate(fec.segments_to_bits(seg, spec.n))
    rx = fec.awgn(symbols, EBN0_DB, rate, generator=generator)
    return seg, fec.bpsk_llr(rx, EBN0_DB, rate)


def phase_environment(build):
    import torch
    card = nvidia_smi("name,power.limit")
    print(f"[env] nvidia-smi: {card}")
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"torch.version.cuda {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}")
    nvcc = build.find_nvcc()
    nvcc_version = subprocess.run([nvcc, "--version"], capture_output=True,
                                  text=True, check=True).stdout.strip()
    print(f"[env] nvcc {nvcc}: {nvcc_version.splitlines()[-1]}")
    print(f"[env] triton installed: "
          f"{importlib.util.find_spec('triton') is not None}; "
          f"jax installed: {importlib.util.find_spec('jax') is not None}")
    return card


def phase_build(build):
    t0 = time.perf_counter()
    seconds = build.build()
    build.library()
    print(f"[build] nvcc {seconds:.2f} s (0 when an up-to-date library was "
          f"reused), build+load "
          f"{time.perf_counter() - t0:.2f} s -> {build.LIBRARY}")
    for line in build.BUILD_LOG.read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"[build] {line.strip()}")


def compare_one(fec, acs, spec, seg, err, lengths):
    """Kernel against plain version on one batch of segments on the card:
    decision words, final metrics (also from carried initial metrics),
    and the traceback's bytes and bits for each message length."""
    import torch
    T = seg.shape[1]
    words, fm = acs.acs_forward_batch(spec, seg)
    words_p, fm_p = acs.acs_forward_batch_plain(spec, seg)
    require(torch.equal(words, words_p), f"{spec} decision words")
    require(torch.equal(fm, fm_p), f"{spec} final metrics")
    words2, fm2 = acs.acs_forward_batch(spec, seg, initial_metrics=fm)
    words2_p, fm2_p = acs.acs_forward_batch_plain(spec, seg, fm_p)
    require(torch.equal(words2, words2_p) and torch.equal(fm2, fm2_p),
            f"{spec} carried initial metrics")
    err["acs_k1_forward"] = max(
        err["acs_k1_forward"], max_abs_diff(words, words_p),
        max_abs_diff(fm, fm_p), max_abs_diff(words2, words2_p),
        max_abs_diff(fm2, fm2_p))
    for L in lengths:
        for out in ("bytes", "bits"):
            got = acs.traceback_batch(spec, words, T, L, out)
            want = acs.traceback_batch_plain(spec, words_p, T, L, out)
            require(torch.equal(got, want), f"{spec} L={L} decoded {out}")
            err["traceback_k1"] = max(err["traceback_k1"],
                                      max_abs_diff(got, want))
    bits = fec.viterbi_decode_batch(spec, seg)
    require(torch.equal(bits, fec.viterbi_decode(spec, seg)),
            f"{spec} viterbi_decode_batch")
    return words


def compare_ragged(acs, spec, words, err, rng):
    """`traceback_batch_ragged` against its plain version on one batch of
    decision words: lengths 0, 1, S, S+1, T and random ones (some past T,
    some negative: clamped), bytes and bits, full and cut row widths."""
    import numpy as np
    import torch
    B, T, _ = words.shape
    edge = [0, 1, spec.S, spec.S + 1, T]
    lens = np.concatenate([edge, rng.integers(-3, T + 4, max(B - 5, 0))])[:B]
    lens = torch.from_numpy(lens.astype(np.int32)).to(words.device)
    for width in sorted({T - spec.S, max(T - spec.S - 13, 0)}):
        for out in ("bytes", "bits"):
            got = acs.traceback_batch_ragged(spec, words, lens, width, out)
            want = acs.traceback_batch_ragged_plain(
                spec, words, lens.clamp(0, T), width, out)
            require(torch.equal(got, want),
                    f"{spec} ragged {out} width {width}")
            err["traceback_k1_ragged"] = max(err["traceback_k1_ragged"],
                                             max_abs_diff(got, want))


def soft_draws(rng, shape):
    """The LLR distributions the soft kernel is held to."""
    import numpy as np
    pm7 = rng.integers(-7, 8, shape)
    return {
        "+-7": pm7,
        "int8": rng.integers(-128, 128, shape),
        "+-1": rng.choice(np.array([-1, 1]), shape),
        "+-7, 20% zeros": np.where(rng.random(shape) < 0.2, 0, pm7),
    }


def compare_soft(fec, acs, spec, q, qclip, err):
    """Soft kernel against plain version on one batch of int8 LLRs: words,
    final metrics, carried and all-zero initial metrics."""
    import torch
    words, fm = acs.acs_forward_batch_soft(spec, q, qclip)
    words_p, fm_p = acs.acs_forward_batch_soft_plain(spec, q, qclip)
    require(torch.equal(words, words_p) and torch.equal(fm, fm_p),
            f"{spec} soft words and final metrics, qclip {qclip}")
    zero = torch.zeros_like(fm)
    diffs = [max_abs_diff(words, words_p), max_abs_diff(fm, fm_p)]
    for init, init_p in ((fm, fm_p), (zero, zero)):
        w2, m2 = acs.acs_forward_batch_soft(spec, q, qclip, init)
        w2_p, m2_p = acs.acs_forward_batch_soft_plain(spec, q, qclip, init_p)
        require(torch.equal(w2, w2_p) and torch.equal(m2, m2_p),
                f"{spec} soft initial metrics, qclip {qclip}")
        diffs += [max_abs_diff(w2, w2_p), max_abs_diff(m2, m2_p)]
    err["acs_soft_k1_forward"] = max(err["acs_soft_k1_forward"], *diffs)
    return words


def phase_compare(fec, acs, dev, err):
    """Kernels against plain versions on the card: every kernel-route
    preset with B and L off every power of two, a K=8 code (the NS = 128
    instantiation), and the smallest shapes."""
    import numpy as np
    import torch
    rng = np.random.default_rng(2026)

    def noisy(spec, B, L, p):
        msgs = rng.integers(0, 2, (B, L), dtype=np.uint8)
        seg, _ = fec.encode_bits(spec, torch.from_numpy(msgs).to(dev))
        return torch.from_numpy(
            corrupt(rng, seg.cpu().numpy(), p, spec.n)).to(dev)

    cases = [(name, fec.PRESETS[name]) for name in KERNEL_PRESETS]
    cases.append(("K8_247_371", fec.CodeSpec(K=8, g=(0o247, 0o371))))
    for name, spec in cases:
        require(fec.select_kernel(spec) == fec.kernels.BUTTERFLY,
                f"{name} on the kernel route")
        for p in NOISE:
            seg = noisy(spec, SMALL_B, SMALL_L, p)
            words = compare_one(fec, acs, spec, seg, err,
                                (SMALL_L, SMALL_L - 13))
            compare_ragged(acs, spec, words, err, rng)
            print(f"[compare] {name:12s} p={p:.2f} B={SMALL_B} "
                  f"T={seg.shape[1]}: words, final metrics, bytes, bits and "
                  "ragged bytes and bits equal to the plain versions")
        T = SMALL_L + spec.S
        for label, draw in soft_draws(rng, (SMALL_B, T, spec.n)).items():
            q = torch.from_numpy(draw.astype(np.int8)).to(dev)
            for qclip in (QMAX, 127):
                words = compare_soft(fec, acs, spec, q, qclip, err)
            compare_ragged(acs, spec, words, err, rng)
            qmax = QMAX if label != "int8" else 127
            qc = fec.kernels.soft_qclip(spec, qmax)
            want = fec.viterbi_decode_soft(spec, acs.condition_qllrs(q, qc))
            got = fec.viterbi_decode_batch_soft(spec, q, qmax=qmax)
            require(torch.equal(got, want), f"{name} soft bits {label}")
            got = fec.viterbi_decode_batch_soft_bytes(spec, q, SMALL_L - 13,
                                                      qmax=qmax)
            want = fec.ops.viterbi.pad_and_pack(want[:, :SMALL_L - 13])
            require(torch.equal(got, want), f"{name} soft bytes {label}")
            print(f"[compare] {name:12s} soft {label:15s} B={SMALL_B} T={T}: "
                  f"qclip {QMAX} and 127, words, final metrics (default, "
                  f"carried, zero start), route {fec.select_kernel(spec, 'soft', qmax)}"
                  " bits and bytes, ragged equal")
    for B, L in ((1, 5), (3, 0), (33, 40)):
        seg = noisy(fec.NASA_K7, B, L, 0.25)
        words = compare_one(fec, acs, fec.NASA_K7, seg, err, (L,))
        compare_ragged(acs, fec.NASA_K7, words, err, rng)
        q = torch.from_numpy(
            rng.integers(-128, 128, (B, L + 6, 2)).astype(np.int8)).to(dev)
        words = compare_soft(fec, acs, fec.NASA_K7, q, QMAX, err)
        compare_ragged(acs, fec.NASA_K7, words, err, rng)
        print(f"[compare] NASA_K7      edge B={B} L={L}: hard, soft and "
              "ragged equal")


def phase_main(fec, acs, dev, err):
    """bench.py's working set through the port's hard entry point.  Returns
    (messages, segments on the card, launches of the run, plain ms)."""
    import numpy as np
    import torch
    from convolutionalencdec_tpu_torch.ops.viterbi import viterbi_decode_bytes
    spec = fec.NASA_K7
    rng = np.random.default_rng(MAIN_SEED)
    msgs = rng.integers(0, 2, (MAIN_B, MAIN_L), dtype=np.uint8)
    seg, _ = fec.encode_bits(spec, torch.from_numpy(msgs).to(dev))
    require(np.array_equal(seg.cpu().numpy(), encode_reference_np(spec, msgs)),
            "encode on the card equals the trellis-walk encoder")
    seg = torch.from_numpy(
        corrupt(rng, seg.cpu().numpy(), MAIN_NOISE, spec.n)).to(dev)
    T = seg.shape[1]

    out, launches = drive(acs, lambda: fec.viterbi_decode_batch_bytes(spec,
                                                                      seg))
    require(launches["acs_k1_forward"] > 0 and launches["traceback_k1"] > 0,
            f"both kernels launched on the main path: {launches}")
    require(tuple(out.shape) == (MAIN_B, MAIN_L // 8)
            and out.dtype == torch.uint8, f"output shape {tuple(out.shape)}")
    ber = ber_of_bytes(out, msgs)
    require(ber < BER_LIMIT, f"BER {ber} < {BER_LIMIT}")

    plain_ms = {}
    plain_out, plain_ms["decode"] = time_once(
        lambda: viterbi_decode_bytes(spec, seg))
    require(torch.equal(out, plain_out),
            "main-path bytes equal to the plain decode on the card")
    words, fm = acs.acs_forward_batch(spec, seg)
    (words_p, fm_p), plain_ms["acs_k1_forward"] = time_once(
        lambda: acs.acs_forward_batch_plain(spec, seg))
    require(torch.equal(words, words_p) and torch.equal(fm, fm_p),
            "main-path decision words and final metrics")
    tb_p, plain_ms["traceback_k1"] = time_once(
        lambda: acs.traceback_batch_plain(spec, words_p, T, MAIN_L, "bytes"))
    require(torch.equal(tb_p, out), "main-path plain traceback bytes")
    err["acs_k1_forward"] = max(err["acs_k1_forward"],
                                max_abs_diff(words, words_p),
                                max_abs_diff(fm, fm_p))
    err["traceback_k1"] = max(err["traceback_k1"], max_abs_diff(out, tb_p))
    print(f"[main] NASA_K7 B={MAIN_B} L={MAIN_L} T={T} p={MAIN_NOISE}: "
          f"BER {ber:.4e} (< {BER_LIMIT}), bytes equal to the plain decode "
          f"on the card, launches {launches}")
    return msgs, seg, launches, plain_ms


def phase_soft(fec, acs, dev, err, msgs):
    """The soft main path at full size.  Returns (int8 LLRs [B, T, n] on
    the card, launches of the run, plain ms)."""
    import torch
    spec = fec.NASA_K7
    gen = torch.Generator(device=dev).manual_seed(MAIN_SEED)
    msgs_dev = torch.from_numpy(msgs).to(dev)
    seg, llr = soft_channel(fec, spec, msgs_dev, gen, spec.rate)
    B, T = seg.shape
    q = fec.quantize_llrs(llr, qmax=QMAX).reshape(B, T, spec.n).to(
        torch.int8)
    require(fec.select_kernel(spec, "soft", QMAX) == fec.kernels.SOFT8,
            "NASA_K7 at qmax 7 on the 8-bit soft route")

    out, launches = drive(acs, lambda: fec.viterbi_decode_batch_soft_bytes(
        spec, q, qmax=QMAX))
    require(launches["acs_soft_k1_forward"] > 0
            and launches["traceback_k1"] > 0,
            f"soft forward and traceback launched on the soft path: "
            f"{launches}")
    require(tuple(out.shape) == (MAIN_B, MAIN_L // 8), "soft output shape")
    plain_ms = {}
    qc = acs.condition_qllrs(q, QMAX)
    plain_bits, plain_ms["soft_decode"] = time_once(
        lambda: fec.viterbi_decode_soft(spec, qc))
    require(torch.equal(out, fec.ops.viterbi.pad_and_pack(plain_bits)),
            "soft bytes equal to the plain soft decode on the card")
    words, fm = acs.acs_forward_batch_soft(spec, q, QMAX)
    (words_p, fm_p), plain_ms["acs_soft_k1_forward"] = time_once(
        lambda: acs.acs_forward_batch_soft_plain(spec, q, QMAX))
    require(torch.equal(words, words_p) and torch.equal(fm, fm_p),
            "soft main-path decision words and final metrics")
    err["acs_soft_k1_forward"] = max(err["acs_soft_k1_forward"],
                                     max_abs_diff(words, words_p),
                                     max_abs_diff(fm, fm_p))
    soft_ber = ber_of_bytes(out, msgs)
    hard_seg = fec.bits_to_segments(fec.hard_decision(llr), spec.n)
    hard_ber = ber_of_bytes(fec.viterbi_decode_batch_bytes(spec, hard_seg),
                            msgs)
    lo, hi = SOFT_BER_WINDOW
    require(lo <= soft_ber <= hi, f"soft BER {soft_ber} in [{lo}, {hi}]")
    require(hard_ber >= HARD_OVER_SOFT * soft_ber,
            f"hard BER {hard_ber} >= {HARD_OVER_SOFT} x soft BER {soft_ber}")
    print(f"[soft] NASA_K7 B={MAIN_B} L={MAIN_L} T={T} AWGN Eb/N0 "
          f"{EBN0_DB} dB, qmax {QMAX}: soft BER {soft_ber:.4e} (in "
          f"[{lo}, {hi}]), hard BER of the same received values "
          f"{hard_ber:.4e} (x{hard_ber / soft_ber:.1f}), bytes equal to the "
          f"plain soft decode on the card, launches {launches}")
    return q, launches, plain_ms


def phase_ragged_punctured(fec, acs, dev, err):
    """Ragged and punctured decodes at full size.  Returns (int8 LLRs,
    lengths on the card, launches of the runs, plain ms)."""
    import numpy as np
    import torch
    spec = fec.NASA_K7
    T = MAIN_L + spec.S
    rng = np.random.default_rng(MAIN_SEED)
    msgs = rng.integers(0, 2, (MAIN_B, MAIN_L), dtype=np.uint8)
    lens_np = rng.integers(spec.S + 1, T + 1, MAIN_B).astype(np.int32)
    # Zero each message past t_b - S: the first t_b segments of the full
    # encoding are then that channel's terminated packet.
    live = np.arange(MAIN_L)[None, :] < (lens_np - spec.S)[:, None]
    msgs = msgs * live.astype(np.uint8)
    lens = torch.from_numpy(lens_np).to(dev)
    gen = torch.Generator(device=dev).manual_seed(MAIN_SEED + 1)
    seg, llr = soft_channel(fec, spec, torch.from_numpy(msgs).to(dev), gen,
                            spec.rate)
    q = fec.quantize_llrs(llr, qmax=QMAX).reshape(MAIN_B, T, spec.n).to(
        torch.int8)
    hard_seg = fec.bits_to_segments(fec.hard_decision(llr), spec.n)
    launches = {}
    plain_ms = {}

    out, launches["soft ragged"] = drive(
        acs, lambda: fec.viterbi_decode_batch_soft_bytes_ragged(spec, q, lens))
    want = fec.ops.viterbi.pad_and_pack(fec.viterbi_decode_ragged_soft(
        spec, acs.condition_qllrs(q, QMAX), lens))
    require(torch.equal(out, want), "soft ragged bytes equal to the plain "
            "route on the card")
    soft_ber = ber_of_bytes(out, msgs, lens_np - spec.S)
    words, _ = acs.acs_forward_batch_soft(spec, q, QMAX)
    got = acs.traceback_batch_ragged(spec, words, lens, MAIN_L, "bytes")
    want_tb, plain_ms["traceback_k1_ragged"] = time_once(
        lambda: acs.traceback_batch_ragged_plain(spec, words, lens, MAIN_L,
                                                 "bytes"))
    require(torch.equal(got, want_tb) and torch.equal(got, out),
            "ragged traceback equal to its plain version at full size")
    err["traceback_k1_ragged"] = max(err["traceback_k1_ragged"],
                                     max_abs_diff(got, want_tb))

    out, launches["hard ragged"] = drive(
        acs, lambda: fec.viterbi_decode_batch_bytes_ragged(spec, hard_seg,
                                                           lens))
    want = fec.ops.viterbi.pad_and_pack(fec.viterbi_decode_ragged(
        spec, hard_seg, lens))
    require(torch.equal(out, want), "hard ragged bytes equal to the plain "
            "route on the card")
    hard_ber = ber_of_bytes(out, msgs, lens_np - spec.S)

    pattern = fec.PUNCTURE_3_4
    rate = fec.punctured_rate(spec, pattern)
    gen = torch.Generator(device=dev).manual_seed(MAIN_SEED + 2)
    msgs_p = np.random.default_rng(MAIN_SEED + 2).integers(
        0, 2, (MAIN_B, MAIN_L), dtype=np.uint8)
    seg_p, _ = fec.encode_bits(spec, torch.from_numpy(msgs_p).to(dev))
    sent = fec.puncture_bits(fec.segments_to_bits(seg_p, spec.n), pattern, T)
    rx = fec.awgn(fec.bpsk_modulate(sent), EBN0_DB, rate, generator=gen)
    qp = fec.quantize_llrs(fec.bpsk_llr(rx, EBN0_DB, rate), qmax=QMAX)
    out, launches["punctured soft"] = drive(
        acs, lambda: fec.viterbi_decode_batch_punctured_soft(spec, qp,
                                                             pattern, T))
    full = fec.depuncture_llrs(qp.to(torch.int8), pattern, T)
    want = fec.viterbi_decode_soft(spec, acs.condition_qllrs(
        full.reshape(MAIN_B, T, spec.n), QMAX))
    require(torch.equal(out, want), "punctured soft bits equal to the plain "
            "route on the card")
    punct_ber = float((out.cpu().numpy() != msgs_p).mean())

    for path, counts in launches.items():
        used = ("acs_soft_k1_forward" if "soft" in path else "acs_k1_forward",
                "traceback_k1" if "punctured" in path else "traceback_k1_ragged")
        require(all(counts[k] > 0 for k in used),
                f"{path}: kernels {used} launched: {counts}")
    print(f"[ragged] NASA_K7 B={MAIN_B} Tmax={T} lengths uniform in "
          f"[{spec.S + 1}, {T}] (mean {lens_np.mean():.1f}), AWGN Eb/N0 "
          f"{EBN0_DB} dB: soft ragged BER {soft_ber:.4e}, hard ragged BER "
          f"{hard_ber:.4e}; both equal to their plain routes on the card")
    print(f"[punctured] NASA_K7 PUNCTURE_3_4 (rate {rate:.4f}) B={MAIN_B} "
          f"L={MAIN_L}, AWGN Eb/N0 {EBN0_DB} dB: BER {punct_ber:.4e}, equal "
          "to the plain route on the card")
    print(f"[ragged/punctured] launches {launches}")
    return q, lens, launches, plain_ms


def phase_times(fec, acs, seg, q, q_ragged, lens):
    """Device ms of TIMED_CALLS calls on distinct inputs (row rotations of
    the main-path inputs)."""
    import torch
    spec = fec.NASA_K7
    T = seg.shape[1]
    bufs = [torch.roll(seg, r + 1, dims=0) for r in range(TIMED_CALLS)]
    runs = {"acs_k1_forward": device_times(
        lambda s: acs.acs_forward_batch(spec, s), bufs)}
    decs = [acs.acs_forward_batch(spec, s)[0] for s in bufs]
    runs["traceback_k1"] = device_times(
        lambda d: acs.traceback_batch(spec, d, T, MAIN_L, "bytes"), decs)
    del decs
    runs["decode"] = device_times(
        lambda s: fec.viterbi_decode_batch_bytes(spec, s), bufs)
    del bufs
    qbufs = [torch.roll(q, r + 1, dims=0) for r in range(TIMED_CALLS)]
    runs["acs_soft_k1_forward"] = device_times(
        lambda x: acs.acs_forward_batch_soft(spec, x, QMAX), qbufs)
    runs["soft_decode"] = device_times(
        lambda x: fec.viterbi_decode_batch_soft_bytes(spec, x, qmax=QMAX),
        qbufs)
    del qbufs
    decs = [acs.acs_forward_batch_soft(spec, torch.roll(q_ragged, r + 1,
                                                        dims=0), QMAX)[0]
            for r in range(TIMED_CALLS)]
    lens_r = [torch.roll(lens, r + 1) for r in range(TIMED_CALLS)]
    pairs = list(zip(decs, lens_r))
    runs["traceback_k1_ragged"] = device_times(
        lambda p: acs.traceback_batch_ragged(spec, p[0], p[1], MAIN_L,
                                             "bytes"), pairs)
    del decs, pairs
    print(f"[time] after timing: clocks.sm, power.draw, power.limit, "
          f"temperature: {nvidia_smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")
    return runs


def bounds(lens_sum: int):
    """(bound ms, what bounds it) of each kernel on this run's main-path
    inputs: the larger of the bytes it must move (each input read once,
    each output written once) over HBM_BYTES_PER_S and its int32 operations
    over INT32_OPS_PER_S."""
    B, L, NS, n = MAIN_B, MAIN_L, 64, 2
    T = L + 6
    dec_bytes = B * T * NS // 8
    fm_bytes = B * NS * 4
    acs_ops = B * T * NS // 2 * ACS_OPS
    work = {
        "acs_k1_forward": (B * T + dec_bytes + fm_bytes, acs_ops),
        "acs_soft_k1_forward": (B * T * n + dec_bytes + fm_bytes, acs_ops),
        "traceback_k1": (dec_bytes + B * L // 8, B * T * TRACEBACK_OPS),
        # Only the steps below each channel's length are needed.
        "traceback_k1_ragged": (lens_sum * NS // 8 + 4 * B + B * L // 8,
                                lens_sum * TRACEBACK_OPS),
    }
    out = {}
    for name, (nbytes, ops) in work.items():
        by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        by_ops = ops / INT32_OPS_PER_S * 1e3
        out[name] = ((by_bytes, "bytes") if by_bytes >= by_ops
                     else (by_ops, "operations"))
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    try:
        import convolutionalencdec_tpu_torch as fec
    except ImportError as exc:
        print(f"chip_smoke: the port package is missing: {exc}",
              file=sys.stderr)
        return 1
    from convolutionalencdec_tpu_torch.kernels import _build, acs
    dev = torch.device("cuda", 0)

    card = phase_environment(_build)
    phase_build(_build)
    err = dict.fromkeys(KERNELS, 0)
    t0 = time.perf_counter()
    phase_compare(fec, acs, dev, err)
    print(f"[compare] {time.perf_counter() - t0:.1f} s")
    msgs, seg, hard_launches, plain_ms = phase_main(fec, acs, dev, err)
    q, soft_launches, soft_plain = phase_soft(fec, acs, dev, err, msgs)
    q_ragged, lens, rp_launches, rp_plain = phase_ragged_punctured(
        fec, acs, dev, err)
    plain_ms.update(soft_plain, **rp_plain)
    runs = phase_times(fec, acs, seg, q, q_ragged, lens)

    # Launch counts: the sum over the main-path runs, each read just after.
    by_path = {"hard": hard_launches, "soft": soft_launches, **rp_launches}
    launches = {k: sum(c[k] for c in by_path.values()) for k in KERNELS}
    bits_per_call = MAIN_B * MAIN_L
    med = {key: statistics.median(ms) for key, ms in runs.items()}
    for key, ms in med.items():
        print(f"[time] {key:20s} median {ms:.4f} ms, min {min(runs[key]):.4f}"
              f" ms of {TIMED_CALLS} = {bits_per_call / (ms * 1e3):.1f} "
              f"decoded Mbit/s; plain {plain_ms[key]:.1f} ms [{card}]")
    bound = bounds(int(lens.clamp(0, seg.shape[1]).sum()))
    kernels = []
    for name in KERNELS:
        source, replaces = SOURCES[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "launches_by_path": {p: c[name] for p, c in by_path.items()},
            "max_abs_err": err[name], "ms": med[name],
            "min_ms": min(runs[name]), "plain_ms": plain_ms[name],
            "bound_ms": bound[name][0], "bound_by": bound[name][1],
            "library_ms": None})
        require(launches[name] > 0, f"{name} launched on the main paths")
        require(err[name] == 0, f"{name} equal to its plain version")
    print(json.dumps({
        "kernels": kernels, "decode_ms": med["decode"],
        "decode_min_ms": min(runs["decode"]),
        "decode_plain_ms": plain_ms["decode"],
        "decode_mbps": bits_per_call / (med["decode"] * 1e3),
        "soft_decode_ms": med["soft_decode"],
        "soft_decode_min_ms": min(runs["soft_decode"]),
        "soft_decode_plain_ms": plain_ms["soft_decode"],
        "soft_decode_mbps": bits_per_call / (med["soft_decode"] * 1e3)}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
