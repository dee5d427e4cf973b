#!/usr/bin/env python3
"""The single-pass phases of chip_smoke.py alone, or build-time variants of
the single-pass block decode (`block_decode_1p`, csrc/block_1p.cu) against
a reference build of the same C entry, on one GPU.

    python3 scripts/torch_single_pass.py
    python3 scripts/torch_single_pass.py --ref PARENT.cu \\
        [--variant NAME=SOURCE.cu ...] [--lines NAME=NS:R,... ...] \\
        [--calls 9] [--no-time] [--out DIR]

With no `--ref`: builds the kernels, then runs chip_smoke.py's phases
19-21 and 27: the single-pass block decode against its plain version, the
main path (m) (the rate-1/6 K = 7 code at bench.py's working set), its
times and K13's beside the two-pass decode at (a)'s input (NASA_K7,
B = 2048 x L = 2048), the harness path (n) (`run_curve`, berTestK7's
acceptance run, a `bench_decode` tick, the traffic model) and the wide
main path (o) (the rate-1/5 K = 10 code, NS = 512, B = 2048, T = 480)
with its times beside the two-pass wide kernels; then the batch sweep of
K13, K1 and K2; prints each time's median beside its plain version's and
its bound, and the card's name and power limit.  Exits non-zero if a
check fails or there is no CUDA device.

With `--ref`: builds csrc/block_1p.cu (as "change"), each variant (a
hand-edited copy of it, `NAME=SOURCE.cu`), each `--lines` copy
(csrc/block_1p.cu with the wide template's dispatch lines rewritten: R
steps a round at NS, e.g. `--lines r3=512:3,4096:3`) and the reference (an
earlier tree's block_1p.cu: get it with `git show
HEAD:convolutionalencdec_tpu_torch/csrc/block_1p.cu >
_checkout/parent_block_1p.cu`); one nvcc each, all at once, with
`-Xptxas -v` (the logs and each build's SASS in `--out`; relative paths
are read from the caller's directory), printing the registers of the
warp kernels at NS = 64 and of the wide template's kernels at NS = 512
and 4096.  Each build then runs in its own process (a kernel fault
poisons the CUDA context): it is held bit for bit against the reference
build at NS = 64, 128, 256 (hard n = 2, 6, 8; soft n = 1, 4, 6, 8, 9, 11,
LLRs over the whole int8 range) at T = 1, S, S + 1, 31, 32, 33, 63, 64,
65, 203 + S and the longest single-pass T (4080, 2016, 1008), B = 1 and
37, noisy and garbage segments and a catastrophic code (its survivors
never merge, so the walk's guesses are wrong), bits and bytes, whole and
cut messages; at NS = 512, 1024, 2048, 4096 (the wide template, hard
n = 1 ... 8, soft n = 1 ... 9: n = 9 on the barrier-a-step template) at
T = 1 ... 8 (every T mod R for R <= 4), S, S + 1 and the longest
single-pass T (480, 240, 96, 48), B = 1 and 37, the same inputs; against
the plain version on 2 rows.  Then (unless `--no-time`) it is timed in
turns with the reference (CUDA events after a 0.1 s sleep, median of
`--calls`; each call on another row rotation of the input, 128 MB of
them, so that it reads its input from device memory as chip_smoke.py's
calls do):
  (m) hard, (m) soft   the rate-1/6 K = 7 code at bench.py's working set;
  (a) hard             NASA_K7 at (a)'s input;
  sweep B=...          (m) hard's first rows at each B of `SWEEP_B`;
  (o) hard, (o) soft   the rate-1/5 K = 10 code (NS = 512, chip_smoke.py's
                       (o)): B = 2048, T = 480, 3% segment corruption and
                       AWGN at 3 dB quantized to 7; beside them the
                       two-pass wide kernels (the package's
                       `acs_wide_forward` or `acs_soft_wide_forward`, then
                       `traceback_wide`) on the same input;
  NS=1024 T=240, NS=2048 T=96, NS=4096 T=48 (hard and soft)
                       random rate-1/5 codes at B = 2048 and their longest
                       single-pass T.
Prints one JSON line per build and the card's name and power limit.
Exits non-zero if a build fails or differs.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "scripts"))
import _torch_variants  # noqa: E402
from _torch_variants import load, variants_main  # noqa: E402

SOURCE = ROOT / "convolutionalencdec_tpu_torch" / "csrc" / "block_1p.cu"
LIBS = ROOT / "convolutionalencdec_tpu_torch" / "build" / "single_pass_variants"
#: The checks' codes: (NS, soft, n); their lengths besides the longest
#: single-pass T; their batches.
CHECK_CODES = [(NS, False, n) for NS in (64, 128, 256) for n in (2, 6, 8)] + [
    (NS, True, n) for NS in (64, 128, 256) for n in (1, 4, 6, 8, 9, 11)]
CHECK_T = (31, 32, 33, 63, 64, 65)
CHECK_B = (1, 37)
#: The wide template's checks: (NS, soft, n), every n at each wide NS.
WIDE_CODES = [(NS, soft, n) for NS in (512, 1024, 2048, 4096)
              for soft in (False, True) for n in range(1, 9 + soft)]
WIDE_T = tuple(range(1, 9))
#: Bytes of input copies a timed key rotates over: more than the card's
#: 50 MB L2.
COLD_BYTES = 128 << 20


#: Batch sizes of the sweep: one channel per SM; 13 per SM (the blocks of
#: 16.4 KB of decisions one SM's 227 KB holds, one wave); one more; (m)'s.
SWEEP_B = (132, 1716, 1717, 2048)


def batch_sweep(cs, acs, sp_in):
    """Device ms of K13 and of the two-pass kernels (K1, then K2) on the
    first B rows of (m)'s hard input, for each B of SWEEP_B: where K13's
    time goes as its blocks fill the SMs and spill into a second wave."""
    import torch
    from convolutionalencdec_tpu_torch.kernels import single_pass as sp
    spec, seg, _ = sp_in
    T = seg.shape[1]
    runs = {}
    for B in SWEEP_B:
        bufs = [torch.roll(seg, r + 1, dims=0)[:B].contiguous()
                for r in range(cs.TIMED_CALLS)]
        runs[f"sweep K13 B={B}"] = cs.device_times(
            lambda s: sp.block_decode_1p(spec, s, T, False, "bytes",
                                         cs.MAIN_L), bufs)
        runs[f"sweep K1 B={B}"] = cs.device_times(
            lambda s: acs.acs_forward_batch(spec, s), bufs)
        decs = [acs.acs_forward_batch(spec, s)[0] for s in bufs]
        runs[f"sweep K2 B={B}"] = cs.device_times(
            lambda d: acs.traceback_batch(spec, d, T, cs.MAIN_L, "bytes"),
            decs)
    return runs


def with_lines(name: str, spec: str, out: Path) -> Path:
    """A copy of csrc/block_1p.cu whose wide dispatch lines `spec` (NS:R,
    comma separated) rewrites, written to out/NAME.cu."""
    src = SOURCE.read_text()
    for item in spec.split(","):
        try:
            ns, r = (int(x) for x in item.split(":"))
        except ValueError:
            raise SystemExit(f"--lines {name}: items are NS:R")
        src, count = re.subn(
            rf"case {ns}: return launch_round<(\d+), \d+>",
            rf"case {ns}: return launch_round<\g<1>, {r}>", src)
        if count != 1:
            raise SystemExit(f"--lines {name}: no line for NS = {ns}")
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"{name}.cu"
    path.write_text(src)
    return path


def run(lib_path: str, ref_path: str, calls: int, timed: bool) -> int:
    """One build against the reference build: the checks, then the times
    in turns; prints its JSON line."""
    import numpy as np
    import torch
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import convolutionalencdec_tpu_torch as fec
    from convolutionalencdec_tpu_torch.kernels import acs
    from convolutionalencdec_tpu_torch.kernels import single_pass as sp
    from convolutionalencdec_tpu_torch.ops.trellis import butterfly_coded_bits
    from convolutionalencdec_tpu_torch.ops.viterbi import init_metric_value
    dev = torch.device("cuda", 0)
    fns = {"var": load(Path(lib_path), "block_decode_1p"),
           "ref": load(Path(ref_path), "block_decode_1p")}
    stream = torch.cuda.current_stream(dev).cuda_stream
    rng = np.random.default_rng(2043)

    def launcher(spec, x, soft, L, emit_bytes):
        """fn -> its output row for x: the table and the output allocated
        here, so that a timed call is the launch alone."""
        B, T = x.shape[:2]
        cb = torch.as_tensor(butterfly_coded_bits(spec), dtype=torch.int32,
                             device=dev)
        out = torch.full((B, (L + 7) // 8 if emit_bytes else L), 0xEE,
                         dtype=torch.uint8, device=dev)

        def launch(fn):
            code = fn(x.data_ptr(), int(soft), cb.data_ptr(), out.data_ptr(),
                      B, T, spec.num_states, spec.n, spec.S, L,
                      int(emit_bytes), init_metric_value(spec), stream)
            if code:
                raise RuntimeError(f"launch failed: CUDA error {code}")
            return out
        return launch

    def decode(fn, spec, x, soft, L, emit_bytes):
        return launcher(spec, x, soft, L, emit_bytes)(fn).clone()

    def inputs(spec, B, T, soft, kind):
        if soft:
            return torch.from_numpy(rng.integers(
                -128, 128, (B, T, spec.n)).astype(np.int8)).to(dev)
        msgs = rng.integers(0, 2, (B, max(T - spec.S, 0)), dtype=np.uint8)
        coded = cs.encode_reference_np(spec, msgs)[:, :T]
        if kind == "garbage":
            coded = rng.integers(0, 1 << spec.n, coded.shape)
        else:
            coded = cs.corrupt(rng, coded, cs.NOISE[0], spec.n)
        return torch.from_numpy(np.ascontiguousarray(
            coded.astype(np.uint8))).to(dev)

    bad, cases = [], 0

    def check(spec, T, soft, n, plain_at):
        """Both builds on B = 1 and 37 rows at T, noisy and garbage
        segments (soft: one draw over the whole int8 range), whole and cut
        messages, bits and bytes; at T = plain_at against the plain version
        on 2 rows."""
        nonlocal cases
        for B in CHECK_B:
            for kind in ("noisy", "garbage"):
                x = inputs(spec, B, T, soft, kind)
                full = max(T - spec.S, 0)
                for L, eb in ((full, 0), (full, 1), (cs.cut_bits(full), 0),
                              (cs.cut_bits(full), 1)):
                    got = decode(fns["var"], spec, x, soft, L, eb)
                    want = decode(fns["ref"], spec, x, soft, L, eb)
                    cases += 1
                    if not torch.equal(got, want):
                        bad.append(f"NS={spec.num_states} soft={soft} n={n} "
                                   f"g={spec.g} T={T} B={B} {kind} L={L} "
                                   f"bytes={eb}")
                        print(f"[sp-variants] differs: {bad[-1]}", flush=True)
                if T == plain_at and B > 1:
                    want = sp.block_decode_1p_plain(spec, x[:2], T, soft)
                    got = decode(fns["var"], spec, x[:2].contiguous(), soft,
                                 full, 0)
                    if not torch.equal(got, want):
                        bad.append(f"NS={spec.num_states} soft={soft} n={n} "
                                   f"g={spec.g} {kind} plain")
                if soft:
                    break  # one LLR draw, over the whole int8 range

    for NS, soft, n in CHECK_CODES:
        specs = [cs.bfly_spec(fec, rng, NS, n)]
        if n == 6:
            g = cs.SP_CATASTROPHIC[NS]
            specs.append(fec.CodeSpec(K=NS.bit_length(), g=g + g[:n - 3]))
        for spec in specs:
            top = 32768 * 8 // NS // 48 * 48
            for T in (1, spec.S, spec.S + 1, *CHECK_T, cs.SMALL_L + spec.S,
                      top):
                check(spec, T, soft, n, cs.SMALL_L + spec.S)
        torch.cuda.synchronize()
    for NS, soft, n in WIDE_CODES:
        spec = cs.bfly_spec(fec, rng, NS, n)
        top = 32768 * 8 // NS // 48 * 48
        for T in sorted({*WIDE_T, spec.S, spec.S + 1, top}):
            check(spec, T, soft, n, top)
        torch.cuda.synchronize()
    print(f"[sp-variants] {Path(lib_path).stem}: {cases} cases against the "
          f"reference, {len(bad)} differ", flush=True)
    result = {"lib": Path(lib_path).stem, "cases": cases, "ms": {},
              "ref_ms": {}, "two_pass_ms": {}}
    if not timed or bad:
        result["differs"] = bad
        print(json.dumps(result))
        return 1 if bad else 0

    # The timed inputs: (m) hard and soft, (a)'s hard, the sweep, (o) hard
    # and soft, and the wide template at NS = 1024, 2048 and 4096.
    spec = fec.CodeSpec(**cs.SP_MAIN)
    rng_m = np.random.default_rng(cs.MAIN_SEED)
    msgs = rng_m.integers(0, 2, (cs.MAIN_B, cs.MAIN_L), dtype=np.uint8)
    seg = torch.from_numpy(cs.corrupt(
        rng_m, cs.encode_reference_np(spec, msgs), cs.MAIN_NOISE,
        spec.n)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(cs.MAIN_SEED)

    def awgn(code, m):
        _, llr = cs.soft_channel(fec, code, torch.from_numpy(m).to(dev), gen,
                                 code.rate)
        return fec.quantize_llrs(llr, qmax=cs.QMAX).reshape(
            m.shape[0], -1, code.n).to(torch.int8)

    q = awgn(spec, msgs)
    nasa = fec.NASA_K7
    seg_a = torch.from_numpy(cs.corrupt(
        rng_m, cs.encode_reference_np(nasa, msgs), cs.MAIN_NOISE,
        nasa.n)).to(dev)
    timed_in = {"(m) hard": (spec, seg, False), "(m) soft": (spec, q, True),
                "(a) hard": (nasa, seg_a, False)}
    for B in SWEEP_B:
        timed_in[f"sweep B={B}"] = (spec, seg[:B].contiguous(), False)
    wide = [("(o)", fec.CodeSpec(**cs.SP_WIDE_MAIN))]
    wide += [(f"NS={NS} T={32768 * 8 // NS // 48 * 48}",
              cs.bfly_spec(fec, rng, NS, 5)) for NS in (1024, 2048, 4096)]
    for name, code in wide:
        T = 32768 * 8 // code.num_states // 48 * 48
        m = rng_m.integers(0, 2, (cs.MAIN_B, T - code.S), dtype=np.uint8)
        x = torch.from_numpy(cs.corrupt(
            rng_m, cs.encode_reference_np(code, m), cs.MAIN_NOISE,
            code.n)).to(dev)
        timed_in[f"{name} hard"] = (code, x, False)
        timed_in[f"{name} soft"] = (code, awgn(code, m), True)
    for key, (sp_spec, x, soft) in timed_in.items():
        T = x.shape[1]
        L = T - sp_spec.S
        same = torch.equal(decode(fns["var"], sp_spec, x, soft, L, 1),
                           decode(fns["ref"], sp_spec, x, soft, L, 1))
        if not same:
            bad.append(f"timed input {key}")
        # Row rotations of the input, at least COLD_BYTES of them, so that
        # every call reads its input from device memory, as in chip_smoke.
        copies = -(-COLD_BYTES // (x.numel() * x.element_size()))
        rolled = [torch.roll(x, r + 1, dims=0) for r in range(copies)]
        launches = [launcher(sp_spec, r, soft, L, 1) for r in rolled]
        launch = {name: (lambda k, name=name: launches[k % copies](fns[name]))
                  for name in ("var", "ref")}
        names = ("var", "ref")
        if key.startswith("(o)"):
            # The two-pass wide kernels of the package on the same input.
            def two_pass(k, sp_spec=sp_spec, soft=soft, T=T, L=L):
                xk = rolled[k % copies]
                words = (acs.acs_forward_batch_soft(sp_spec, xk, 127) if soft
                         else acs.acs_forward_batch(sp_spec, xk))[0]
                return acs.traceback_batch(sp_spec, words, T, L, "bytes")
            if not torch.equal(two_pass(0), launch["var"](0)):
                bad.append(f"two-pass bytes at {key}")
            launch["two-pass"] = two_pass
            names += ("two-pass",)
        ms = _torch_variants.in_turns(lambda name, k: launch[name](k), calls,
                                      cs.QUEUE_SLEEP_CYCLES, names)
        del launches, rolled
        result["ms"][key], result["ref_ms"][key] = ms["var"], ms["ref"]
        line = (f"[sp-variants] {result['lib']} {key:16s} B={x.shape[0]} "
                f"T={T}: {ms['var']:.4f} ms, reference {ms['ref']:.4f} ms")
        if "two-pass" in ms:
            result["two_pass_ms"][key] = ms["two-pass"]
            line += f", two-pass kernels {ms['two-pass']:.4f} ms"
        print(line, flush=True)
    result["differs"] = bad
    print(json.dumps(result))
    return 1 if bad else 0


def phases() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_single_pass: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import convolutionalencdec_tpu_torch as fec
    from convolutionalencdec_tpu_torch.kernels import _build, acs
    dev = torch.device("cuda", 0)
    t_all = time.perf_counter()
    card = cs.phase_environment(_build)
    cs.phase_build(_build)
    err = dict.fromkeys(cs.KERNELS, 0)
    t0 = time.perf_counter()
    cs.phase_compare_single_pass(fec, dev, err)
    print(f"[single pass] compare {time.perf_counter() - t0:.1f} s")
    sp_in, _, plain, summary = cs.phase_single_pass(fec, acs, dev, err)
    rng = np.random.default_rng(cs.MAIN_SEED)
    msgs = rng.integers(0, 2, (cs.MAIN_B, cs.MAIN_L), dtype=np.uint8)
    seg_a, _ = fec.encode_bits(fec.NASA_K7, torch.from_numpy(msgs).to(dev))
    seg_a = torch.from_numpy(cs.corrupt(rng, seg_a.cpu().numpy(),
                                        cs.MAIN_NOISE, 2)).to(dev)
    runs = cs.single_pass_times(fec, sp_in, seg_a)
    spw_in, _, plain_o, summary_o = cs.phase_single_pass_wide(fec, acs, dev,
                                                              err)
    plain.update(plain_o)
    runs.update(cs.single_pass_wide_times(fec, acs, spw_in))
    _, harness = cs.phase_harness(fec, acs, dev, seg_a)
    runs.update(batch_sweep(cs, acs, sp_in))
    bound = cs.bounds(0, [], (
        (fec.K5_23_35, cs.MAIN_L + 4, 0), (fec.K5_23_35, cs.MAIN_L + 4, 0),
        (1, 1, 1)))
    for key in sorted(runs):
        b = bound.get(key)
        print(f"[single pass] {key:24s} median "
              f"{statistics.median(runs[key]):.4f} ms, min "
              f"{min(runs[key]):.4f} ms; plain "
              f"{plain.get(key, float('nan')):.1f} ms; bound "
              f"{'-' if b is None else f'{b[0]:.4f} ms ({b[1]})'}")
    wrong = max(err["block_decode_1p"], err["block_decode_1p wide"])
    print(json.dumps({"max_abs_err": wrong, "m": summary, "n": harness,
                      "o": summary_o}))
    if wrong:
        print("torch_single_pass: K13 differs from its plain version",
              file=sys.stderr)
        return 1
    print(f"[single pass] {time.perf_counter() - t_all:.1f} s")
    print(card)
    return 0


def main() -> int:
    if "--run" in sys.argv:
        ap = argparse.ArgumentParser()
        ap.add_argument("--run")
        ap.add_argument("--ref-lib")
        ap.add_argument("--calls", type=int, default=9)
        ap.add_argument("--untimed", action="store_true")
        a = ap.parse_args()
        return run(a.run, a.ref_lib, a.calls, not a.untimed)
    if "--ref" not in sys.argv:
        os.chdir(ROOT)
        return phases()
    # `--lines NAME=SPEC`: a rewritten copy, built as a variant.
    argv, out, i = [sys.argv[0]], LIBS, 1
    if "--out" in sys.argv:
        out = Path(sys.argv[sys.argv.index("--out") + 1]).resolve()
    while i < len(sys.argv):
        if sys.argv[i] == "--lines":
            name, _, spec = sys.argv[i + 1].partition("=")
            argv += ["--variant", f"{name}={with_lines(name, spec, out)}"]
            i += 2
        else:
            argv.append(sys.argv[i])
            i += 1
    sys.argv = argv
    return variants_main(__doc__, SOURCE, LIBS, "sp-variants",
                         r"block_1p_warpILi1ELi(1ELb0|6ELb1)E|"
                         r"block_1p_wideILi(9|12)E",
                         lambda fn: (0, None), Path(__file__).resolve())


if __name__ == "__main__":
    sys.exit(main())
