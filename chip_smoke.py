#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port once on one NVIDIA GPU, and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. environment: the card (nvidia-smi), torch's CUDA, nvcc;
  2. build: compile csrc/*.cu for sm_90a and print the build time and the
     compiler's register/spill report;
  3. kernel against plain version on the card: every kernel-route preset
     and a K=8 code, B = 37, L = 203, light (3%) and heavy (25%) segment
     corruption, plus the smallest shapes; decision words, final metrics,
     bytes and bits must be equal;
  4. main path at full size: bench.py's working set (NASA_K7, B = 2048
     channels x L = 2048 bits, numpy seed 9865, 3% segment corruption),
     encoded on the card and decoded with `viterbi_decode_batch_bytes`;
     BER < 2e-3, bytes equal to the plain decode on the card, and both
     kernels' launch counters > 0;
  5. times: median of 20 calls on distinct inputs, CUDA events, for each
     kernel and the whole byte decode, beside the plain version's time.

The line before the last is one JSON object {"kernels": [...]}; the last is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Uses torch and numpy only.
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
TIMED_CALLS = 20
KERNELS = ("acs_k1_forward", "traceback_k1")


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


def phase_compare(fec, acs, dev, err):
    """Kernel against plain version on the card: every kernel-route preset
    at light and heavy noise with B and L off every power of two, a K=8
    code (the NS = 128 instantiation), and the smallest shapes."""
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
            compare_one(fec, acs, spec, seg, err, (SMALL_L, SMALL_L - 13))
            print(f"[compare] {name:12s} p={p:.2f} B={SMALL_B} "
                  f"T={seg.shape[1]}: words, final metrics, bytes and bits "
                  "equal to the plain version")
    for B, L in ((1, 5), (3, 0), (33, 40)):
        seg = noisy(fec.NASA_K7, B, L, 0.25)
        compare_one(fec, acs, fec.NASA_K7, seg, err, (L,))
        print(f"[compare] NASA_K7      edge B={B} L={L}: equal")


def phase_main(fec, acs, dev, err):
    """bench.py's working set through the port's entry point.  Returns
    (segments on the card, launches of the main-path run, plain ms)."""
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

    torch.cuda.synchronize()
    for key in acs.LAUNCHES:
        acs.LAUNCHES[key] = 0
    out = fec.viterbi_decode_batch_bytes(spec, seg)
    torch.cuda.synchronize()
    launches = dict(acs.LAUNCHES)
    require(all(launches[k] > 0 for k in KERNELS),
            f"both kernels launched on the main path: {launches}")
    require(tuple(out.shape) == (MAIN_B, MAIN_L // 8)
            and out.dtype == torch.uint8, f"output shape {tuple(out.shape)}")
    got_bits = np.unpackbits(out.cpu().numpy(), axis=1)[:, :MAIN_L]
    ber = float((got_bits != msgs).mean())
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
    return seg, launches, plain_ms


def phase_times(fec, acs, seg):
    """Median device ms of TIMED_CALLS calls on distinct inputs (row
    rotations of the main-path segments)."""
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
    print(f"[time] after timing: clocks.sm, power.draw, power.limit, "
          f"temperature: {nvidia_smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")
    return runs


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
    phase_compare(fec, acs, dev, err)
    seg, launches, plain_ms = phase_main(fec, acs, dev, err)
    runs = phase_times(fec, acs, seg)

    bits_per_call = MAIN_B * MAIN_L
    med = {key: statistics.median(ms) for key, ms in runs.items()}
    for key, ms in med.items():
        print(f"[time] {key:15s} median {ms:.4f} ms, min {min(runs[key]):.4f}"
              f" ms of {TIMED_CALLS} = {bits_per_call / (ms * 1e3):.1f} "
              f"decoded Mbit/s; plain {plain_ms[key]:.1f} ms = "
              f"{bits_per_call / (plain_ms[key] * 1e3):.2f} Mbit/s [{card}]")
    kernels = [
        {"name": "acs_k1_forward", "route": "cuda",
         "source": "convolutionalencdec_tpu_torch/csrc/acs_k1.cu",
         "replaces": "convolutionalencdec_tpu/kernels/acs_swar.py:847"},
        {"name": "traceback_k1", "route": "cuda",
         "source": "convolutionalencdec_tpu_torch/csrc/traceback_k1.cu",
         "replaces": "convolutionalencdec_tpu/kernels/acs_swar.py:877"},
    ]
    for k in kernels:
        k.update(launches=launches[k["name"]], max_abs_err=err[k["name"]],
                 ms=med[k["name"]], plain_ms=plain_ms[k["name"]])
    print(json.dumps({"kernels": kernels, "decode_ms": med["decode"],
                      "decode_plain_ms": plain_ms["decode"],
                      "decode_mbps": bits_per_call / (med["decode"] * 1e3)}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
