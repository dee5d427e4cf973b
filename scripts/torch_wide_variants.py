#!/usr/bin/env python3
"""Build-time variants of the wide forwards (`acs_wide_forward`, with
`--soft` `acs_soft_wide_forward`, csrc/acs_wide.cu) against a reference
build of the same C entry, on one GPU.

    python3 scripts/torch_wide_variants.py [--soft [--n 4 6]] \\
        [--ref PATH.cu] [--variant NAME[=SOURCE.cu] ...] [--ns 512 16384] \\
        [--calls 5] [--sass] [--out DIR]

Builds each variant, csrc/acs_wide.cu or a modified copy of it
(`=SOURCE.cu`: other steps a round in its dispatch switch, another
round), and, with `--ref`, another source of the same C entry (an earlier
tree's acs_wide.cu) as the reference; one nvcc each, all at once, with
`-Xptxas -v`, into the package's build directory (the logs and, with
`--sass`, the NS = 16384 kernels' SASS there too, or in `--out`).  Each
variant then runs in its own process (a kernel fault poisons the CUDA
context): at each NS it is held bit for bit against the reference build
(or, with no `--ref`, the package's build) on a random poly-symmetric
rate-1/4 code (soft: rate 1/n for each `--n`) at B = 64 and T over every
residue mod 5, 4, 3 and 2 (fresh and carried start metrics; soft: LLRs over
the whole int8 range under the three conditionings, clamp to [-7, 7],
[-127, 127] and [-128, 127]; the first difference is located by step and
word), against the plain forward on 2 rows, and timed at B = 2048,
T = 2062 (`chip_smoke.py`'s (l) size; at NS = 16384 (l)'s own code; hard:
noisy segments, soft: its AWGN LLRs at 3 dB quantized to 7, used as
[-127, 127]) in turns with the reference, CUDA events, median of
`--calls`.  Prints one JSON line per variant and the card's name and power
limit.  Exits non-zero if a build fails or a variant differs.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SOURCE = ROOT / "convolutionalencdec_tpu_torch" / "csrc" / "acs_wide.cu"
LIBS = ROOT / "convolutionalencdec_tpu_torch" / "build" / "wide_variants"
TIMED_B, TIMED_T = 2048, 2062
CHECK_B, CHECK_T = 64, (1, 2, 3, 4, 5, 6, 7, 8, 9, 61, 62, 63, 64, 65)


def build_all(builds: dict[str, Path], out: Path):
    """name -> source: one nvcc each, in parallel; returns (name ->
    library, names that failed).  Prints each build's register report."""
    sys.path.insert(0, str(ROOT))
    from convolutionalencdec_tpu_torch.kernels import _build
    nvcc = _build.find_nvcc()
    out.mkdir(parents=True, exist_ok=True)
    LIBS.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, src in builds.items():
        lib = LIBS / f"{name}.so"
        cmd = [nvcc, *_build.NVCC_FLAGS, "-shared", "-o", str(lib), str(src)]
        jobs[name] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, failed = {}, []
    for name, (lib, proc) in jobs.items():
        output = proc.communicate()[0]
        (out / f"{name}.log").write_text(output)
        if proc.returncode:
            failed.append(name)
            print(f"[variants] {name}: nvcc failed\n{output}", file=sys.stderr)
            continue
        libs[name] = lib
        lines = output.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry function" in line and (
                    "acs_round_kernel" in line
                    or "acs_soft_round_kernel" in line):
                regs = next((x for x in lines[i + 1:i + 4]
                             if "registers" in x), "").strip()
                spill = next((x for x in lines[i + 1:i + 4]
                              if "spill" in x), "").strip()
                fn = line.split("'")[1] if "'" in line else line
                print(f"[variants] {name} {fn}: {regs}; {spill}")
    return libs, failed


def dump_sass(libs: dict[str, Path], out: Path) -> None:
    """The SASS (cuobjdump -sass) of each library's round kernels at
    NS = 16384 into out/NAME.sass."""
    sys.path.insert(0, str(ROOT))
    from convolutionalencdec_tpu_torch.kernels import _build
    cuobjdump = Path(_build.find_nvcc()).parent / "cuobjdump"
    for name, lib in libs.items():
        proc = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                              capture_output=True, text=True)
        parts = proc.stdout.split("Function : ")
        keep = [p for p in parts[1:] if "acs_round_kernelILi14" in p[:200]
                or "acs_soft_round_kernelILi14" in p[:200]]
        (out / f"{name}.sass").write_text(
            "".join("Function : " + p for p in keep) + proc.stderr)


def load(path: Path, soft: bool):
    lib = ctypes.CDLL(str(path))
    P, I = ctypes.c_void_p, ctypes.c_int
    if soft:
        fn = lib.acs_soft_wide_forward
        fn.argtypes = [P, P, P, P, P, I, I, I, I, I, I, I, P]
    else:
        fn = lib.acs_wide_forward
        fn.argtypes = [P, P, P, P, P, I, I, I, I, I, P]
    fn.restype = I
    return fn


# Soft conditionings (qclip, floor): the LLRs used as clamp(q, -7, 7),
# clamp(q, -127, 127) and clamp(q, -128, 127).
SOFT_MODES = ((7, True), (127, True), (127, False))


def run(lib_path: str, source: str, ref_path: str | None, ns_list,
        calls: int, soft: bool, n_list) -> int:
    """One variant (built from `source`) against the reference build;
    prints its JSON line."""
    import numpy as np
    import torch
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import convolutionalencdec_tpu_torch as fec
    from convolutionalencdec_tpu_torch.kernels import _build, acs
    from convolutionalencdec_tpu_torch.ops.trellis import butterfly_coded_bits
    from convolutionalencdec_tpu_torch.ops.viterbi import init_metric_value
    dev = torch.device("cuda", 0)
    fn = load(Path(lib_path), soft)
    steps = cs.wide_round_steps(source, soft)
    if ref_path is None:
        ref = getattr(_build.library(), "acs_soft_wide_forward" if soft
                      else "acs_wide_forward")
    else:
        ref = load(Path(ref_path), soft)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rng = np.random.default_rng(2040)

    def forward(f, spec, x, init=None, mode=(127, True)):
        """x: segments [B, T] (hard) or int8 LLRs [B, T, n] (soft, used
        as the conditioning `mode` says)."""
        B, T = x.shape[:2]
        NS = spec.num_states
        cb = torch.as_tensor(butterfly_coded_bits(spec), dtype=torch.int32,
                             device=dev)
        words = torch.empty((B, T, NS // 32), dtype=torch.int32, device=dev)
        fm = torch.empty((B, NS), dtype=torch.int32, device=dev)
        args = [x.data_ptr(), cb.data_ptr(),
                None if init is None else init.data_ptr(), words.data_ptr(),
                fm.data_ptr(), B, T, NS, spec.n]
        if soft:
            qclip, floor = mode
            args += [-qclip if floor else -128, qclip]
        code = f(*args, init_metric_value(spec), stream)
        if code:
            raise RuntimeError(f"launch failed: CUDA error {code}")
        return words, fm

    def plain(spec, x, mode):
        if soft:
            return acs.acs_forward_batch_soft_plain(spec, x, mode[0],
                                                    floor=mode[1])
        return acs.acs_forward_batch_plain(spec, x)

    result = {"lib": Path(lib_path).stem, "by_ns": {}}
    bad = []
    for NS in ns_list:
        for n in (n_list if soft else [4]):
            spec = (fec.CodeSpec(**cs.WIDE_MAIN)
                    if NS == 16384 and n == 4
                    else cs.bfly_spec(fec, rng, NS, n))
            for T in CHECK_T:
                for mode in (SOFT_MODES if soft else [None]):
                    if soft:
                        x = torch.from_numpy(rng.integers(
                            -128, 128, (CHECK_B, T, n)).astype(
                                np.int8)).to(dev)
                    else:
                        x = torch.from_numpy(rng.integers(
                            0, 1 << n, (CHECK_B, T)).astype(np.uint8)).to(dev)
                    w, f = forward(fn, spec, x, None, mode)
                    w_r, f_r = forward(ref, spec, x, None, mode)
                    x2 = x.flip(0).contiguous()
                    w2, f2 = forward(fn, spec, x2, f, mode)
                    w2_r, f2_r = forward(ref, spec, x2, f_r, mode)
                    torch.cuda.synchronize()
                    if not (torch.equal(w, w_r) and torch.equal(f, f_r)
                            and torch.equal(w2, w2_r)
                            and torch.equal(f2, f2_r)):
                        bad.append(f"NS={NS} n={n} T={T} mode={mode}")
                        if len(bad) == 1:  # where the first difference lies
                            diff = (w != w_r).sum(dim=(0, 2)).tolist()
                            col = (w != w_r).sum(dim=(0, 1)).nonzero().flatten()
                            print(f"[variants] NS={NS} n={n} T={T} "
                                  f"mode={mode}: differing words by step "
                                  f"{diff}, word indices {col[:16].tolist()}; "
                                  f"final metrics differ: "
                                  f"{int((f != f_r).sum())}, carried: "
                                  f"{int((w2 != w2_r).sum())} words, "
                                  f"{int((f2 != f2_r).sum())} metrics",
                                  flush=True)
            wp, fp = plain(spec, x[:2], mode)
            if not (torch.equal(w[:2], wp) and torch.equal(f[:2], fp)):
                bad.append(f"NS={NS} n={n} plain")
            del w, f, w_r, f_r, w2, f2, w2_r, f2_r
        spec = (fec.CodeSpec(**cs.WIDE_MAIN) if NS == 16384
                else cs.bfly_spec(fec, rng, NS, 4))
        R = steps.get(NS)
        msgs = torch.from_numpy(rng.integers(
            0, 2, (TIMED_B, TIMED_T - spec.S), dtype=np.uint8)).to(dev)
        if soft:
            gen = torch.Generator(device=dev).manual_seed(cs.MAIN_SEED)
            _, llr = cs.soft_channel(fec, spec, msgs, gen, spec.rate)
            seg = fec.quantize_llrs(llr, qmax=cs.QMAX).reshape(
                TIMED_B, TIMED_T, spec.n).to(torch.int8)
            del llr
        else:
            seg = fec.encode_bits(spec, msgs)[0]
            seg = torch.from_numpy(cs.corrupt(rng, seg.cpu().numpy(),
                                              cs.MAIN_NOISE, spec.n)).to(dev)
        times = {"var": [], "ref": []}
        out = {}
        for i in range(calls):
            for key, f in (("ref", ref), ("var", fn)) if i % 2 else \
                    (("var", fn), ("ref", ref)):
                out.pop(key, None)
                torch.cuda.synchronize()
                torch.cuda._sleep(10_000_000)
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                out[key] = forward(f, spec, seg)
                e1.record()
                torch.cuda.synchronize()
                times[key].append(e0.elapsed_time(e1))
            if i == 0 and not (torch.equal(out["var"][0], out["ref"][0])
                               and torch.equal(out["var"][1], out["ref"][1])):
                bad.append(f"NS={NS} timed input")
        out.clear()
        result["by_ns"][NS] = {
            "R": R, "threads": None if R is None else NS >> R,
            "ms": statistics.median(times["var"]),
            "ref_ms": statistics.median(times["ref"]),
            "ms_all": times["var"], "ref_ms_all": times["ref"]}
        print(f"[variants] {result['lib']} NS={NS} R={R}: "
              f"{statistics.median(times['var']):.4f} ms, reference "
              f"{statistics.median(times['ref']):.4f} ms", flush=True)
    result["differs"] = bad
    print(json.dumps(result))
    return 1 if bad else 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--soft", action="store_true",
                    help="the soft C entry, acs_soft_wide_forward")
    ap.add_argument("--n", type=int, nargs="+", default=[4],
                    help="soft: the codes' n in the bit-for-bit checks")
    ap.add_argument("--ref", help="a reference acs_wide.cu")
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME[=SOURCE.cu], e.g. r4=/tmp/r4.cu (repeatable)")
    ap.add_argument("--ns", type=int, nargs="+", default=[16384])
    ap.add_argument("--calls", type=int, default=5)
    ap.add_argument("--sass", action="store_true",
                    help="keep each build's SASS beside its log")
    ap.add_argument("--out", type=Path, default=LIBS,
                    help="directory of the build logs and SASS")
    ap.add_argument("--run", help=argparse.SUPPRESS)
    ap.add_argument("--source", help=argparse.SUPPRESS)
    ap.add_argument("--ref-lib", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.run:
        return run(args.run, args.source, args.ref_lib, args.ns, args.calls,
                   args.soft, args.n)
    import torch
    if not torch.cuda.is_available():
        print("torch_wide_variants: no CUDA device", file=sys.stderr)
        return 1
    builds = {}
    for item in args.variant or ["default"]:
        name, _, src = item.partition("=")
        builds[name] = Path(src) if src else SOURCE
    if args.ref:
        builds["reference"] = Path(args.ref)
    libs, failed = build_all(builds, args.out)
    if args.sass:
        dump_sass(libs, args.out)
    if "reference" in failed:
        return 1
    ref_lib = libs.pop("reference", None)
    status = 1 if failed else 0
    for name, lib in libs.items():
        cmd = [sys.executable, str(Path(__file__).resolve()), "--run",
               str(lib), "--source", str(builds[name]), "--calls",
               str(args.calls), "--ns", *map(str, args.ns),
               "--n", *map(str, args.n)] + (["--soft"] if args.soft else [])
        if ref_lib is not None:
            cmd += ["--ref-lib", str(ref_lib)]
        code = subprocess.run(cmd).returncode
        if code:
            print(f"[variants] {name}: exit {code}", file=sys.stderr)
            status = 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip())
    return status


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
