#!/usr/bin/env python3
"""Build-time variants of the hard wide forward (`acs_wide_forward`,
csrc/acs_wide.cu) against a reference build of it, on one GPU.

    python3 scripts/torch_wide_variants.py [--ref PATH.cu] \\
        [--variant NAME[=SOURCE.cu] ...] [--ns 512 16384] \\
        [--calls 5] [--sass] [--out DIR]

Builds each variant, csrc/acs_wide.cu or a modified copy of it
(`=SOURCE.cu`: other steps a round in its dispatch switch, another
round), and, with `--ref`, another source of the same C entry (an earlier
tree's acs_wide.cu) as the reference; one nvcc each, all at once, with
`-Xptxas -v`, into the package's build directory (the logs and, with
`--sass`, the NS = 16384 kernel's SASS there too, or in `--out`).  Each
variant then runs in its own process (a kernel fault poisons the CUDA
context): at each NS it is held bit for bit against the reference build
(or, with no `--ref`, the package's build) on a random poly-symmetric
rate-1/4 code at B = 64 and T over every residue mod 5, 4, 3 and 2 (fresh
and carried start metrics; the first difference is located by step and
word), against the plain forward on 2 rows, and timed at B = 2048,
T = 2062 (`chip_smoke.py`'s (l) size; at NS = 16384 (l)'s own code and
noisy input) in turns with the reference, CUDA events, median of
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
            if "Compiling entry function" in line and "acs_round_kernel" in line:
                regs = next((x for x in lines[i + 1:i + 4]
                             if "registers" in x), "").strip()
                spill = next((x for x in lines[i + 1:i + 4]
                              if "spill" in x), "").strip()
                fn = line.split("'")[1] if "'" in line else line
                print(f"[variants] {name} {fn}: {regs}; {spill}")
    return libs, failed


def dump_sass(libs: dict[str, Path], out: Path) -> None:
    """The SASS (cuobjdump -sass) of each library's hard forward at
    NS = 16384 into out/NAME.sass."""
    sys.path.insert(0, str(ROOT))
    from convolutionalencdec_tpu_torch.kernels import _build
    cuobjdump = Path(_build.find_nvcc()).parent / "cuobjdump"
    for name, lib in libs.items():
        proc = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                              capture_output=True, text=True)
        parts = proc.stdout.split("Function : ")
        keep = [p for p in parts[1:] if "acs_round_kernelILi14" in p[:200]]
        (out / f"{name}.sass").write_text(
            "".join("Function : " + p for p in keep) + proc.stderr)


def load(path: Path):
    lib = ctypes.CDLL(str(path))
    fn = lib.acs_wide_forward
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, P, P, P, P, I, I, I, I, I, P]
    fn.restype = I
    return fn


def run(lib_path: str, source: str, ref_path: str | None, ns_list,
        calls: int) -> int:
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
    fn = load(Path(lib_path))
    steps = cs.wide_round_steps(source)
    if ref_path is None:
        ref = _build.library().acs_wide_forward
    else:
        ref = load(Path(ref_path))
    stream = torch.cuda.current_stream(dev).cuda_stream
    rng = np.random.default_rng(2040)

    def forward(f, spec, seg, init=None):
        B, T = seg.shape
        NS = spec.num_states
        cb = torch.as_tensor(butterfly_coded_bits(spec), dtype=torch.int32,
                             device=dev)
        words = torch.empty((B, T, NS // 32), dtype=torch.int32, device=dev)
        fm = torch.empty((B, NS), dtype=torch.int32, device=dev)
        code = f(seg.data_ptr(), cb.data_ptr(),
                 None if init is None else init.data_ptr(), words.data_ptr(),
                 fm.data_ptr(), B, T, NS, spec.n, init_metric_value(spec),
                 stream)
        if code:
            raise RuntimeError(f"launch failed: CUDA error {code}")
        return words, fm

    result = {"lib": Path(lib_path).stem, "by_ns": {}}
    bad = []
    for NS in ns_list:
        spec = (fec.CodeSpec(**cs.WIDE_MAIN) if NS == 16384
                else cs.bfly_spec(fec, rng, NS, 4))
        R = steps.get(NS)
        for T in CHECK_T:
            seg = torch.from_numpy(rng.integers(
                0, 1 << spec.n, (CHECK_B, T)).astype(np.uint8)).to(dev)
            w, f = forward(fn, spec, seg)
            w_r, f_r = forward(ref, spec, seg)
            w2, f2 = forward(fn, spec, seg.flip(0).contiguous(), f)
            w2_r, f2_r = forward(ref, spec, seg.flip(0).contiguous(), f_r)
            torch.cuda.synchronize()
            if not (torch.equal(w, w_r) and torch.equal(f, f_r)
                    and torch.equal(w2, w2_r) and torch.equal(f2, f2_r)):
                bad.append(f"NS={NS} T={T}")
                if len(bad) == 1:  # where the first difference lies
                    diff = (w != w_r).sum(dim=(0, 2)).tolist()
                    col = (w != w_r).sum(dim=(0, 1)).nonzero().flatten()
                    print(f"[variants] NS={NS} T={T}: differing words by "
                          f"step {diff}, word indices {col[:16].tolist()}; "
                          f"final metrics differ: "
                          f"{int((f != f_r).sum())}", flush=True)
        wp, fp = acs.acs_forward_batch_plain(spec, seg[:2])
        if not (torch.equal(w[:2], wp) and torch.equal(f[:2], fp)):
            bad.append(f"NS={NS} plain")
        msgs = rng.integers(0, 2, (TIMED_B, TIMED_T - spec.S), dtype=np.uint8)
        seg = fec.encode_bits(spec, torch.from_numpy(msgs).to(dev))[0]
        seg = torch.from_numpy(cs.corrupt(rng, seg.cpu().numpy(),
                                          cs.MAIN_NOISE, spec.n)).to(dev)
        del w, f, w_r, f_r, w2, f2, w2_r, f2_r
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
        return run(args.run, args.source, args.ref_lib, args.ns, args.calls)
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
               str(args.calls), "--ns", *map(str, args.ns)]
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
