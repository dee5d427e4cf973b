#!/usr/bin/env python3
"""The single-pass phases of chip_smoke.py alone, or build-time variants of
the single-pass block decode (`block_decode_1p`, csrc/block_1p.cu) against
a reference build of the same C entry, on one GPU.

    python3 scripts/torch_single_pass.py
    python3 scripts/torch_single_pass.py --ref PATH.cu \\
        [--variant NAME[=SOURCE.cu] ...] [--sass] [--out DIR]

With no `--ref`: builds the kernels, then runs chip_smoke.py's phases
19-21: the single-pass block decode against its plain version, the main
path (m) (the rate-1/6 K = 7 code at bench.py's working set), its times
and K13's beside the two-pass decode at (a)'s input (NASA_K7, B = 2048 x
L = 2048), and the harness path (n) (`run_curve`, berTestK7's acceptance
run, a `bench_decode` tick, the traffic model); then the batch sweep of
K13, K1 and K2; prints each time's median beside its plain version's and
its bound, and the card's name and power limit.  Exits non-zero if a
check fails or there is no CUDA device.

With `--ref`: builds each variant, csrc/block_1p.cu (the default, named
"shipped") or a modified copy of it (`--variant NAME=SOURCE.cu`), and
the reference, another source of the same C entry (an earlier tree's
block_1p.cu, from `git show REV:PATH`); one nvcc each, all at once, with
`-Xptxas -v`, into the package's build directory (the logs there too, or
in `--out`; with `--sass` the NS = 64 hard and n = 6 soft kernels' SASS
beside them).  Relative paths are read from the caller's directory.  Each variant then runs in its own process (a kernel fault
poisons the CUDA context): it is held bit for bit against the reference
build at NS = 64, 128, 256 (hard n = 2, 6, 8; soft n = 1, 4, 6, 8, 9, 11,
LLRs over the whole int8 range) at T = 1, S, S + 1, 31, 32, 33, 63, 64,
65, 203 + S and the longest single-pass T (4080, 2016, 1008), B = 1 and
37, noisy and garbage segments and a catastrophic code (its survivors
never merge, so the walk's guesses are wrong), bits and bytes, whole and
cut messages; against the plain version on 2 rows; then timed in turns
with the reference (CUDA events after a 0.1 s sleep, median of CALLS;
each call on another row rotation of the input, 128 MB of them, so that
it reads its input from device memory as chip_smoke.py's calls do) at
(m) hard and soft, at (a)'s input, and at each B of the batch sweep
(`SWEEP_B`, (m)'s hard input).  Prints one JSON line per variant and the
card's name and power limit.  Exits non-zero if a build fails or a
variant differs.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import _torch_variants

ROOT = Path(__file__).resolve().parent.parent
SOURCE = ROOT / "convolutionalencdec_tpu_torch" / "csrc" / "block_1p.cu"
LIBS = ROOT / "convolutionalencdec_tpu_torch" / "build" / "single_pass_variants"
#: The checks' codes: (NS, soft, n); their lengths besides the longest
#: single-pass T; their batches.
CHECK_CODES = [(NS, False, n) for NS in (64, 128, 256) for n in (2, 6, 8)] + [
    (NS, True, n) for NS in (64, 128, 256) for n in (1, 4, 6, 8, 9, 11)]
CHECK_T = (31, 32, 33, 63, 64, 65)
CHECK_B = (1, 37)
#: Bytes of input copies a timed key rotates over: more than the card's
#: 50 MB L2.
COLD_BYTES = 128 << 20
#: Timed calls of each build, in turns; a time is their median.
CALLS = 9


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


def report(sass: bool, out: Path):
    """A build's report for _torch_variants.build_all: the registers of the
    hard NS = 64 kernel and the soft n = 6 one at each NS; with `sass`, the
    SASS of the NS = 64 ones in `out`."""
    def each(name: str, lib: Path, output: str) -> None:
        lines = output.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry function" in line and (
                    "block_1p_warpILi1ELi1ELb0E" in line or
                    "block_1p_warp" in line and "ELi6ELb1E" in line):
                regs = next((x for x in lines[i + 1:i + 4]
                             if "registers" in x), "").strip()
                fn = line.split("'")[1] if "'" in line else line
                print(f"[sp-variants] {name} {fn}: {regs}")
        if sass:
            from convolutionalencdec_tpu_torch.kernels import _build
            cuobjdump = Path(_build.find_nvcc()).parent / "cuobjdump"
            proc = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                                  capture_output=True, text=True)
            parts = proc.stdout.split("Function : ")
            keep = [x for x in parts[1:] if "block_1p_warp" in x[:120]
                    and ("ILi1ELi1ELb0E" in x[:120] or "ILi1ELi6ELb1E" in
                         x[:120])]
            (out / f"{name}.sass").write_text(
                "".join("Function : " + x for x in keep))
    return each


def load(path: Path):
    lib = ctypes.CDLL(str(path))
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = lib.block_decode_1p
    fn.argtypes = [P, I, P, P, I, I, I, I, I, I, I, I, P]
    fn.restype = I
    return fn


def run_variant(lib_path: str, ref_path: str) -> int:
    """One variant against the reference build: the checks, then the
    times in turns; prints its JSON line."""
    import numpy as np
    import torch
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import convolutionalencdec_tpu_torch as fec
    from convolutionalencdec_tpu_torch.kernels import single_pass as sp
    from convolutionalencdec_tpu_torch.ops.trellis import butterfly_coded_bits
    from convolutionalencdec_tpu_torch.ops.viterbi import init_metric_value
    dev = torch.device("cuda", 0)
    fns = {"var": load(Path(lib_path)), "ref": load(Path(ref_path))}
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
    for NS, soft, n in CHECK_CODES:
        specs = [cs.bfly_spec(fec, rng, NS, n)]
        if n == 6:
            g = cs.SP_CATASTROPHIC[NS]
            specs.append(fec.CodeSpec(K=NS.bit_length(), g=g + g[:n - 3]))
        for spec in specs:
            top = 32768 * 8 // NS // 48 * 48
            for T in (1, spec.S, spec.S + 1, *CHECK_T, cs.SMALL_L + spec.S,
                      top):
                for B in CHECK_B:
                    for kind in ("noisy", "garbage"):
                        x = inputs(spec, B, T, soft, kind)
                        full = max(T - spec.S, 0)
                        for L, eb in ((full, 0), (full, 1),
                                      (cs.cut_bits(full), 0),
                                      (cs.cut_bits(full), 1)):
                            got = decode(fns["var"], spec, x, soft, L, eb)
                            want = decode(fns["ref"], spec, x, soft, L, eb)
                            cases += 1
                            if not torch.equal(got, want):
                                bad.append(f"NS={NS} soft={soft} n={n} "
                                           f"g={spec.g} T={T} B={B} {kind} "
                                           f"L={L} bytes={eb}")
                                print(f"[sp-variants] differs: {bad[-1]}",
                                      flush=True)
                        if T == cs.SMALL_L + spec.S and B > 1:
                            want = sp.block_decode_1p_plain(spec, x[:2], T,
                                                            soft)
                            got = decode(fns["var"], spec,
                                         x[:2].contiguous(), soft, full, 0)
                            if not torch.equal(got, want):
                                bad.append(f"NS={NS} soft={soft} n={n} "
                                           f"g={spec.g} {kind} plain")
                        if soft:
                            break  # one LLR draw, over the whole int8 range
        torch.cuda.synchronize()
    print(f"[sp-variants] {Path(lib_path).stem}: {cases} cases against the "
          f"reference, {len(bad)} differ", flush=True)

    # The timed inputs: (m) hard and soft, (a)'s hard.
    spec = fec.CodeSpec(**cs.SP_MAIN)
    rng_m = np.random.default_rng(cs.MAIN_SEED)
    msgs = rng_m.integers(0, 2, (cs.MAIN_B, cs.MAIN_L), dtype=np.uint8)
    seg = torch.from_numpy(cs.corrupt(
        rng_m, cs.encode_reference_np(spec, msgs), cs.MAIN_NOISE,
        spec.n)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(cs.MAIN_SEED)
    _, llr = cs.soft_channel(fec, spec, torch.from_numpy(msgs).to(dev), gen,
                             spec.rate)
    q = fec.quantize_llrs(llr, qmax=cs.QMAX).reshape(
        cs.MAIN_B, seg.shape[1], spec.n).to(torch.int8)
    del llr
    nasa = fec.NASA_K7
    seg_a = torch.from_numpy(cs.corrupt(
        rng_m, cs.encode_reference_np(nasa, msgs), cs.MAIN_NOISE,
        nasa.n)).to(dev)
    timed = {"(m) hard": (spec, seg, False), "(m) soft": (spec, q, True),
             "(a) hard": (nasa, seg_a, False)}
    for B in SWEEP_B:
        timed[f"sweep B={B}"] = (spec, seg[:B].contiguous(), False)
    result = {"lib": Path(lib_path).stem, "cases": cases, "ms": {},
              "ref_ms": {}}
    for key, (sp_spec, x, soft) in timed.items():
        L = x.shape[1] - sp_spec.S
        same = torch.equal(decode(fns["var"], sp_spec, x, soft, L, 1),
                           decode(fns["ref"], sp_spec, x, soft, L, 1))
        if not same:
            bad.append(f"timed input {key}")
        # Row rotations of the input, at least COLD_BYTES of them, so that
        # every call reads its input from device memory, as in chip_smoke.
        copies = -(-COLD_BYTES // (x.numel() * x.element_size()))
        launches = [launcher(sp_spec, torch.roll(x, r + 1, dims=0), soft, L,
                             1) for r in range(copies)]
        ms = _torch_variants.in_turns(
            lambda name, k: launches[k % copies](fns[name]), CALLS,
            cs.QUEUE_SLEEP_CYCLES)
        del launches
        result["ms"][key], result["ref_ms"][key] = ms["var"], ms["ref"]
        print(f"[sp-variants] {result['lib']} {key:14s} B={x.shape[0]} "
              f"T={x.shape[1]}: {result['ms'][key]:.4f} ms, reference "
              f"{result['ref_ms'][key]:.4f} ms", flush=True)
    result["differs"] = bad
    print(json.dumps(result))
    return 1 if bad else 0


def variants(args) -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_single_pass: no CUDA device", file=sys.stderr)
        return 1
    builds = {}
    for item in args.variant or ["shipped"]:
        name, _, src = item.partition("=")
        builds[name] = Path(src).resolve() if src else SOURCE
    builds["reference"] = args.ref.resolve()
    out = args.out.resolve()
    libs, failed = _torch_variants.build_all(builds, LIBS, out, "sp-variants",
                                             report(args.sass, out))
    if "reference" in failed:
        return 1
    ref_lib = libs.pop("reference")
    status = 1 if failed else 0
    for name, lib in libs.items():
        code = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--run", str(lib),
             "--ref-lib", str(ref_lib)], cwd=ROOT).returncode
        if code:
            print(f"[sp-variants] {name}: exit {code}", file=sys.stderr)
            status = 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip())
    return status


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
    print(json.dumps({"max_abs_err": err["block_decode_1p"], "m": summary,
                      "n": harness}))
    if err["block_decode_1p"]:
        print("torch_single_pass: K13 differs from its plain version",
              file=sys.stderr)
        return 1
    print(f"[single pass] {time.perf_counter() - t_all:.1f} s")
    print(card)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ref", type=Path,
                    help="the reference's source: an earlier block_1p.cu")
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME[=SOURCE.cu] (repeatable)")
    ap.add_argument("--sass", action="store_true",
                    help="keep the SASS of two kernels beside the logs")
    ap.add_argument("--out", type=Path, default=LIBS,
                    help="directory of the build logs and SASS")
    ap.add_argument("--run", help=argparse.SUPPRESS)
    ap.add_argument("--ref-lib", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.run:
        return run_variant(args.run, args.ref_lib)
    if args.ref:
        return variants(args)
    os.chdir(ROOT)
    return phases()


if __name__ == "__main__":
    sys.exit(main())
