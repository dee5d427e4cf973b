#!/usr/bin/env python3
"""Build-time variants of the generic-k forward (`acs_generic_forward` and
`acs_generic_k2_forward`, csrc/acs_generic.cu) against a reference build of
the same C entries, on one GPU.

    python3 scripts/torch_generic_variants.py [--ref PATH.cu] \\
        [--variant NAME[=SOURCE.cu] ...] [--shapes main|all] [--calls 5] \\
        [--sass] [--out DIR]

Builds each variant, csrc/acs_generic.cu or a modified copy of it
(`=SOURCE.cu`: other lanes a channel in its dispatch switch, another
branch metric), and, with `--ref`, another source of the same C entries
(an earlier tree's acs_generic.cu) as the reference; one nvcc each, all at
once, with `-Xptxas -v`, into the package's build directory (the logs
there too, or in `--out`, and with `--sass` the main-path forward
kernels' SASS).  Each variant then runs in its own process (a
kernel fault poisons the CUDA context): at each of the 25 (k, NS) shapes
of the variant's dispatch switch it is held bit for bit (planes and final
metrics) against the reference build (or, with no `--ref`, the package's
build) on a random code for n = 1 ... 8 in turn, at B = 1 and B = 2 CPW +
3 (CPW: the shape's channels a warp), T = 1, S + 1, 31, 32, 33 and 100,
and, at n = 1, against the plain forward on 2 rows; then timed in turns with the
reference (CUDA events, median of `--calls`): `--shapes main` at the four
generic main-path codes of chip_smoke.py (B = 2048, their T; k2_NS64
through the k2 entry), `--shapes all` also at every shape on a random
rate-k/min(k + 2, 8) code at B = 2048, T = 512.  Prints one JSON line per variant
and the card's name and power limit.  Exits non-zero if a build fails or
a variant differs.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SOURCE = ROOT / "convolutionalencdec_tpu_torch" / "csrc" / "acs_generic.cu"
LIBS = ROOT / "convolutionalencdec_tpu_torch" / "build" / "generic_variants"
CHECK_T = (1, 31, 32, 33, 100)  # and S + 1
ALL_B, ALL_T = 2048, 512


def shapes_of(source: str) -> list[tuple[int, int, int]]:
    """(k, log2 NS, log2 lanes a channel) of each case of the dispatch
    switch of an acs_generic.cu."""
    return [tuple(map(int, m)) for m in re.findall(
        r"launch_forward<(\d+), (\d+), (\d+)(?:, \d+)*>\(GENERIC_ARGS\)",
        Path(source).read_text())]


def build_all(builds: dict[str, Path], out: Path):
    """name -> source: one nvcc each, in parallel; returns (name ->
    library, names that failed).  Prints each forward kernel's registers."""
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
            print(f"[generic-variants] {name}: nvcc failed\n{output}",
                  file=sys.stderr)
            continue
        libs[name] = lib
        lines = output.splitlines()
        regs = [x.split("Used")[1].split(",")[0].strip()
                for i, x in enumerate(lines) if "Used" in x and any(
                    "generic_forward_kernel" in y for y in lines[i - 3:i])]
        print(f"[generic-variants] {name}: {len(regs)} forward kernels, "
              f"registers {sorted(set(regs))}", flush=True)
    return libs, failed


# The main-path codes' instantiations, as their mangled template arguments
# (k, log2 NS, log2 lanes a channel, DEFER, UNROLL, HAM): TOY_K3, k2_NS64,
# k3_NS64 (n = 4: popc) and k2_NS256.
SASS_KERNELS = ("ILi1ELi2ELi2ELi0ELi2ELi1E", "ILi2ELi6ELi4ELi0ELi1ELi1E",
                "ILi3ELi6ELi4ELi1ELi4ELi0E", "ILi2ELi8ELi5ELi0ELi4ELi1E")


def dump_sass(libs: dict[str, Path], out: Path) -> None:
    """The SASS (cuobjdump -sass) of each library's forward kernels at the
    main-path shapes into out/NAME.sass, with a count of instructions of
    each."""
    sys.path.insert(0, str(ROOT))
    from convolutionalencdec_tpu_torch.kernels import _build
    cuobjdump = Path(_build.find_nvcc()).parent / "cuobjdump"
    for name, lib in libs.items():
        proc = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                              capture_output=True, text=True)
        parts = proc.stdout.split("Function : ")
        keep = [p for p in parts[1:] if "generic_forward_kernel" in p[:200]
                and any(t in p[:200] for t in SASS_KERNELS)]
        (out / f"{name}.sass").write_text(
            "".join("Function : " + p for p in keep) + proc.stderr)
        for p in keep:
            count = sum(1 for x in p.splitlines() if x.strip().startswith("/*")
                        and "*/" in x and ";" in x)
            tag = next(t for t in SASS_KERNELS if t in p[:200])
            print(f"[generic-variants] {name} {tag}: {count} SASS "
                  "instructions", flush=True)


def load(path: Path):
    lib = ctypes.CDLL(str(path))
    P, I = ctypes.c_void_p, ctypes.c_int
    fns = {}
    for name in ("acs_generic_forward", "acs_generic_k2_forward"):
        fn = getattr(lib, name)
        fn.argtypes = [P, P, P, P, I, I, I, I, I, I, I, P]
        fn.restype = I
        fns[name] = fn
    return fns


def random_spec(fec, rng, k, logns, n):
    """A rate-k/n code of NS = 2^logns states with random generators."""
    K = logns // k + 1
    return fec.CodeSpec(K=K, k=k, g=tuple(
        int(x) for x in rng.integers(1, 1 << (k * K), n)))


def run(lib_path: str, source: str, ref_path: str | None, calls: int,
        which: str) -> int:
    """One variant (built from `source`) against the reference build;
    prints its JSON line."""
    import numpy as np
    import torch
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import convolutionalencdec_tpu_torch as fec
    from convolutionalencdec_tpu_torch.kernels import _build, generic
    from convolutionalencdec_tpu_torch.ops.viterbi import init_metric_value
    dev = torch.device("cuda", 0)
    fns = load(Path(lib_path))
    refs = load(Path(ref_path)) if ref_path else {
        name: getattr(_build.library(), name)
        for name in ("acs_generic_forward", "acs_generic_k2_forward")}
    stream = torch.cuda.current_stream(dev).cuda_stream
    rng = np.random.default_rng(2050)

    def buffers(spec, seg):
        """The edge table and the outputs of one call."""
        B, T = seg.shape
        NS, k = spec.num_states, spec.k
        table = torch.as_tensor(np.concatenate(generic.edge_tables(spec)),
                                dtype=torch.uint8, device=dev)
        planes = torch.empty((B, T, k, (NS + 31) // 32), dtype=torch.int32,
                             device=dev)
        fm = torch.empty((B, NS), dtype=torch.int32, device=dev)
        return table, planes, fm

    def launch(f, spec, seg, table, planes, fm):
        B, T = seg.shape
        code = f(seg.data_ptr(), table.data_ptr(), planes.data_ptr(),
                 fm.data_ptr(), B, T, spec.k, spec.num_states, spec.n,
                 (spec.S - 1) * spec.k, init_metric_value(spec), stream)
        if code:
            raise RuntimeError(f"{spec}: launch failed, CUDA error {code}")

    def forward(f, spec, seg):
        table, planes, fm = buffers(spec, seg)
        launch(f, spec, seg, table, planes, fm)
        return planes, fm

    result = {"lib": Path(lib_path).stem, "checked": {}, "ms": {},
              "ref_ms": {}, "cpw": {}}
    bad = []
    for i, (k, logns, logc) in enumerate(shapes_of(source)):
        cpw = 32 >> logc
        key = f"k{k}_NS{1 << logns}"
        result["cpw"][key] = cpw
        cases = 0
        for j, n in enumerate(range(1, 9)):
            spec = random_spec(fec, rng, k, logns, n)
            entry = ("acs_generic_k2_forward"
                     if (k, logns) == (2, 6) and j % 2 else
                     "acs_generic_forward")
            for B in (1, 2 * cpw + 3):
                for T in (spec.S + 1,) + CHECK_T:
                    x = rng.integers(0, 1 << n, (B, T)).astype(np.uint8)
                    if T == 100:  # a clean stretch: long runs of ties
                        x[:, 40:80] = 0
                    seg = torch.from_numpy(x).to(dev)
                    p, f = forward(fns[entry], spec, seg)
                    pr, fr = forward(refs[entry], spec, seg)
                    cases += 1
                    if not (torch.equal(p, pr) and torch.equal(f, fr)):
                        bad.append(f"{key} n={n} B={B} T={T} {entry}")
                        if len(bad) == 1:
                            diff = (p != pr).sum(dim=(0, 2, 3)).tolist()
                            print(f"[generic-variants] {bad[0]}: differing "
                                  f"words by step {diff[:40]}, final "
                                  f"metrics {int((f != fr).sum())}",
                                  flush=True)
            if j == 0:
                pp, fp = generic.acs_forward_batch_generic_plain(spec,
                                                                 seg[:2])
                if not (torch.equal(p[:2], pp) and torch.equal(f[:2], fp)):
                    bad.append(f"{key} n={n} plain")
        result["checked"][key] = cases
        print(f"[generic-variants] {result['lib']} {key}: {cases} cases, "
              f"{cpw} channels a warp", flush=True)

    timed = []
    for name, code, L in cs.GENERIC_MAIN:
        spec = cs.generic_spec(fec, code)
        msgs = rng.integers(0, 2, (cs.MAIN_B, L), dtype=np.uint8)
        seg, _ = fec.encode_bits(spec, torch.from_numpy(msgs).to(dev))
        seg = torch.from_numpy(cs.corrupt(rng, seg.cpu().numpy(),
                                          cs.MAIN_NOISE, spec.n)).to(dev)
        entry = ("acs_generic_k2_forward" if generic.k2_supported(spec)
                 else "acs_generic_forward")
        timed.append((name, spec, seg, entry))
    if which == "all":
        for k, logns, _ in shapes_of(source):
            spec = random_spec(fec, rng, k, logns, min(k + 2, 8))
            seg = torch.from_numpy(rng.integers(
                0, 1 << spec.n, (ALL_B, ALL_T)).astype(np.uint8)).to(dev)
            timed.append((f"shape k{k}_NS{1 << logns}", spec, seg,
                          "acs_generic_forward"))
    for name, spec, seg, entry in timed:
        times = {"var": [], "ref": []}
        out = {}
        for i in range(calls):
            order = (("ref", refs), ("var", fns)) if i % 2 else \
                (("var", fns), ("ref", refs))
            for key, lib in order:
                out.pop(key, None)
                bufs = buffers(spec, seg)
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                torch.cuda._sleep(10_000_000)
                e0.record()
                launch(lib[entry], spec, seg, *bufs)
                e1.record()
                torch.cuda.synchronize()
                times[key].append(e0.elapsed_time(e1))
                out[key] = bufs[1:]
            if i == 0 and not (torch.equal(out["var"][0], out["ref"][0])
                               and torch.equal(out["var"][1],
                                               out["ref"][1])):
                bad.append(f"{name} timed input")
        out.clear()
        result["ms"][name] = statistics.median(times["var"])
        result["ref_ms"][name] = statistics.median(times["ref"])
        print(f"[generic-variants] {result['lib']} {name} ({entry}, "
              f"B={seg.shape[0]} T={seg.shape[1]}): "
              f"{result['ms'][name]:.4f} ms, reference "
              f"{result['ref_ms'][name]:.4f} ms", flush=True)
    result["differs"] = bad
    print(json.dumps(result))
    return 1 if bad else 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ref", help="a reference acs_generic.cu")
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME[=SOURCE.cu], e.g. c1=/tmp/c1.cu (repeatable)")
    ap.add_argument("--shapes", choices=("main", "all"), default="main")
    ap.add_argument("--calls", type=int, default=5)
    ap.add_argument("--sass", action="store_true",
                    help="keep the main-path forward kernels' SASS beside "
                    "the build logs")
    ap.add_argument("--out", type=Path, default=LIBS,
                    help="directory of the build logs and SASS")
    ap.add_argument("--run", help=argparse.SUPPRESS)
    ap.add_argument("--source", help=argparse.SUPPRESS)
    ap.add_argument("--ref-lib", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.run:
        return run(args.run, args.source, args.ref_lib, args.calls,
                   args.shapes)
    import torch
    if not torch.cuda.is_available():
        print("torch_generic_variants: no CUDA device", file=sys.stderr)
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
               str(args.calls), "--shapes", args.shapes]
        if ref_lib is not None:
            cmd += ["--ref-lib", str(ref_lib)]
        code = subprocess.run(cmd).returncode
        if code:
            print(f"[generic-variants] {name}: exit {code}", file=sys.stderr)
            status = 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip())
    return status


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
