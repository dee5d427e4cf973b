#!/usr/bin/env python3
"""Build-time variants of the generic-k forward (`acs_generic_forward` and
`acs_generic_k2_forward`, csrc/acs_generic.cu) or, with `--walk`, of its
walk (`traceback_generic` and `traceback_generic_k2`) against a reference
build of the same C entries, on one GPU.

    python3 scripts/torch_generic_variants.py [--walk] [--ref PATH.cu] \\
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

`--walk --trace`: each variant built with the walk's clock64 stamps
(TRACE_EDITS), whose cycles a warp by part each main-path code prints.

`--walk`: the shapes are the cases of the variant's walk switch
(`launch_walk`).  At each, random decision planes (which send most guesses
wrong, so that segments are walked again) and the planes of the package's
forward on random segments of a random code, at B = 1, 3 and 2 CPW + 3,
T = 1, S + 1, 31, 32, 33, 100, a segment's steps - 1 and + 1 and a
window's + 1, and one T of 5,000 steps at B = 3; t_actual = T and T - 2;
the whole message and a cut one (not a multiple of 8), in bits and bytes:
the variant's output against the reference build's, and against the plain
version on the first rows.  Then timed in turns on the planes of the
forward at the four main-path codes (`--shapes all`: also at every shape
on a random code's garbage at B = 2048, T = 512).
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
import time
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


# `--trace`: the walk's window loop stamped with clock64: each warp's
# cycles waiting for its window, warming up, walking its segment, checking
# and walking again, and writing out, the check's rounds and re-walked
# lanes, and its whole run, summed over warps into `g_walk_trace`, read by
# the C entry `generic_walk_trace`.
TRACE_EDITS = (
    ("// The walk: each channel from state 0",
     "__device__ unsigned long long g_walk_trace[9];\n\n"
     "// The walk: each channel from state 0"),
    ("  for (int i = 0; i < n_win; ++i) {\n",
     "  unsigned long long tr[7] = {};\n  const long long tr0 = clock64();\n"
     "  for (int i = 0; i < n_win; ++i) {\n    const long long tA = clock64();\n"),
    ("    __syncwarp();\n    const int lo = j * WS;",
     "    __syncwarp();\n    const long long tB = clock64();\n"
     "    tr[0] += tB - tA;\n    const int lo = j * WS;"),
    ("    unsigned end = mine ?",
     "    const long long tC = clock64();\n    tr[1] += tC - tB;\n"
     "    unsigned end = mine ?"),
    ("    // Top down: a segment whose start",
     "    const long long tD = clock64();\n    tr[2] += tD - tC;\n"
     "    // Top down: a segment whose start"),
    ("      if (!__any_sync(kFullMask, redo)) break;\n",
     "      if (!__any_sync(kFullMask, redo)) break;\n      tr[5] += 1;\n"
     "      tr[6] += __popc(__ballot_sync(kFullMask, redo));\n"),
    ("    top = __shfl_sync(kFullMask, end, cs << LOGC);",
     "    const long long tE = clock64();\n    tr[3] += tE - tD;\n"
     "    top = __shfl_sync(kFullMask, end, cs << LOGC);"),
    ("    __syncwarp();  // the buffer and the bytes are free for window j - 2\n"
     "  }\n}\n",
     "    __syncwarp();  // the buffer and the bytes are free for window j - 2\n"
     "    tr[4] += clock64() - tE;\n  }\n  if (lane == 0) {\n"
     "    for (int q = 0; q < 7; ++q) atomicAdd(&g_walk_trace[q], tr[q]);\n"
     "    atomicAdd(&g_walk_trace[7], (unsigned long long)(clock64() - tr0));\n"
     "    atomicAdd(&g_walk_trace[8], 1ull);\n  }\n}\n"),
)
TRACE_ENTRY = """
extern "C" int generic_walk_trace(unsigned long long* host, int reset) {
  if (reset) {
    const unsigned long long zero[9] = {};
    return static_cast<int>(
        cudaMemcpyToSymbol(g_walk_trace, zero, sizeof zero));
  }
  return static_cast<int>(
      cudaMemcpyFromSymbol(host, g_walk_trace, 9 * sizeof(*host)));
}
"""
TRACE_PARTS = ("wait", "warm-up", "segment", "check", "write-out")


def traced(source: Path, out: Path) -> Path:
    """A copy of `source` with the walk's trace stamps (TRACE_EDITS)."""
    text = source.read_text()
    for old, new in TRACE_EDITS:
        if text.count(old) != 1:
            raise SystemExit(f"--trace: no unique {old!r} in {source}")
        text = text.replace(old, new)
    path = out / f"{source.stem}.trace.cu"
    path.write_text(text + TRACE_ENTRY)
    return path


def build_all(builds: dict[str, Path], out: Path):
    """name -> source: one nvcc each, in parallel; returns (name ->
    library, names that failed).  Prints each build's seconds (from the
    start of all to its nvcc's exit) and each kernel's registers."""
    sys.path.insert(0, str(ROOT))
    from convolutionalencdec_tpu_torch.kernels import _build
    nvcc = _build.find_nvcc()
    out.mkdir(parents=True, exist_ok=True)
    LIBS.mkdir(parents=True, exist_ok=True)
    jobs = {}
    start = time.monotonic()
    for name, src in builds.items():
        lib = LIBS / f"{name}.so"
        cmd = [nvcc, *_build.NVCC_FLAGS, "-shared", "-o", str(lib), str(src)]
        with open(out / f"{name}.log", "w") as log:
            jobs[name] = (lib, subprocess.Popen(
                cmd, stdout=log, stderr=subprocess.STDOUT))
    seconds = {}
    while len(seconds) < len(jobs):
        for name, (_, proc) in jobs.items():
            if name not in seconds and proc.poll() is not None:
                seconds[name] = time.monotonic() - start
        time.sleep(0.05)
    libs, failed = {}, []
    for name, (lib, proc) in jobs.items():
        output = (out / f"{name}.log").read_text()
        print(f"[generic-variants] {name}: nvcc {seconds[name]:.1f} s",
              flush=True)
        if proc.returncode:
            failed.append(name)
            print(f"[generic-variants] {name}: nvcc failed\n{output}",
                  file=sys.stderr)
            continue
        libs[name] = lib
        lines = output.splitlines()
        for kernel in ("generic_forward_kernel", "generic_walk_kernel"):
            regs = [x.split("Used")[1].split(",")[0].strip()
                    for i, x in enumerate(lines) if "Used" in x and any(
                        kernel in y for y in lines[i - 3:i])]
            print(f"[generic-variants] {name}: {len(regs)} {kernel}s, "
                  f"registers {sorted(set(regs))}", flush=True)
    return libs, failed


# The main-path codes' instantiations, as their mangled template arguments
# (k, log2 NS, log2 lanes a channel, DEFER, UNROLL, HAM): TOY_K3, k2_NS64,
# k3_NS64 (n = 4: popc) and k2_NS256.
SASS_KERNELS = ("ILi1ELi2ELi2ELi0ELi2ELi1E", "ILi2ELi6ELi4ELi0ELi1ELi1E",
                "ILi3ELi6ELi4ELi1ELi4ELi0E", "ILi2ELi8ELi5ELi0ELi4ELi1E")


def dump_sass(libs: dict[str, Path], out: Path, walk: bool = False) -> None:
    """The SASS (cuobjdump -sass) of each library's forward kernels at the
    main-path shapes (`walk`: every walk kernel) into out/NAME.sass, with a
    count of instructions of each."""
    sys.path.insert(0, str(ROOT))
    from convolutionalencdec_tpu_torch.kernels import _build
    cuobjdump = Path(_build.find_nvcc()).parent / "cuobjdump"
    kernel = "generic_walk_kernel" if walk else "generic_forward_kernel"
    for name, lib in libs.items():
        proc = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                              capture_output=True, text=True)
        parts = proc.stdout.split("Function : ")
        keep = [p for p in parts[1:] if kernel in p[:200]
                and (walk or any(t in p[:200] for t in SASS_KERNELS))]
        (out / f"{name}.sass").write_text(
            "".join("Function : " + p for p in keep) + proc.stderr)
        for p in keep:
            count = sum(1 for x in p.splitlines() if x.strip().startswith("/*")
                        and "*/" in x and ";" in x)
            tag = re.search(r"I(Li\d+E)+", p[:200])
            print(f"[generic-variants] {name} {tag.group(0) if tag else ''}: "
                  f"{count} SASS instructions", flush=True)


WALKS = ("traceback_generic", "traceback_generic_k2")


def load(path: Path):
    lib = ctypes.CDLL(str(path))
    P, I = ctypes.c_void_p, ctypes.c_int
    fns = {}
    for name in ("acs_generic_forward", "acs_generic_k2_forward"):
        fn = getattr(lib, name)
        fn.argtypes = [P, P, P, P, I, I, I, I, I, I, I, P]
        fn.restype = I
        fns[name] = fn
    for name in WALKS:
        fn = getattr(lib, name)
        fn.argtypes = [P, P, I, I, I, I, I, I, I, I, P]
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


def run_walk(lib_path: str, source: str, ref_path: str | None, calls: int,
             which: str) -> int:
    """`--walk`: one variant's walk (built from `source`) against the
    reference build; prints its JSON line."""
    import numpy as np
    import torch
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import convolutionalencdec_tpu_torch as fec
    from convolutionalencdec_tpu_torch.kernels import _build, generic
    from convolutionalencdec_tpu_torch.ops.viterbi import (init_metric_value,
                                                           pad_and_pack)
    dev = torch.device("cuda", 0)
    fns = load(Path(lib_path))
    refs = load(Path(ref_path)) if ref_path else {
        name: getattr(_build.library(), name)
        for name in ("acs_generic_forward", *WALKS)}
    stream = torch.cuda.current_stream(dev).cuda_stream
    rng = np.random.default_rng(2051)

    def forward(spec, seg):
        """The reference build's forward: decision planes of `seg`."""
        B, T = seg.shape
        table = torch.as_tensor(np.concatenate(generic.edge_tables(spec)),
                                dtype=torch.uint8, device=dev)
        planes = torch.empty((B, T, spec.k, (spec.num_states + 31) // 32),
                             dtype=torch.int32, device=dev)
        fm = torch.empty((B, spec.num_states), dtype=torch.int32, device=dev)
        code = refs["acs_generic_forward"](
            seg.data_ptr(), table.data_ptr(), planes.data_ptr(),
            fm.data_ptr(), B, T, spec.k, spec.num_states, spec.n,
            (spec.S - 1) * spec.k, init_metric_value(spec), stream)
        if code:
            raise RuntimeError(f"{spec}: forward failed, CUDA error {code}")
        return planes

    def random_planes(spec, B, T):
        """Uniform decision words, the bits past NS zero."""
        NS = spec.num_states
        words = rng.integers(-2 ** 31, 2 ** 31, (B, T, spec.k,
                                                 (NS + 31) // 32))
        if NS < 32:
            words &= (1 << NS) - 1
        return torch.from_numpy(words.astype(np.int32)).to(dev)

    def walk(f, spec, planes, t_actual, L, out, res=None):
        B, T = planes.shape[:2]
        width = (L + 7) // 8 if out == "bytes" else L
        if res is None:
            res = torch.full((B, width), 0xA5, dtype=torch.uint8, device=dev)
        code = f(planes.data_ptr(), res.data_ptr(), B, T, t_actual, spec.k,
                 spec.num_states, spec.S, L, int(out == "bytes"), stream)
        if code:
            raise RuntimeError(f"{spec}: walk failed, CUDA error {code}")
        return res

    def spec_of(k, logns, n):
        spec = None
        while spec is None or not generic.generic_kernel_supports(spec):
            spec = random_spec(fec, rng, k, logns, n)
        return spec

    result = {"lib": Path(lib_path).stem, "walk": True, "checked": {},
              "ms": {}, "ref_ms": {}, "shape": {}}
    bad = []
    for i, (k, logns, logc, logcpw, logg, wu) in enumerate(
            cs.generic_walk_shapes(source)):
        n = 1 + i % 8
        spec = spec_of(k, logns, n)
        S, G, cpw = spec.S, 1 << logg, 1 << logcpw
        WS = (1 << logc) * G
        key = f"k{k}_NS{1 << logns}"
        result["shape"][key] = [1 << logc, cpw, G, wu]
        entries = WALKS if (k, logns) == (2, 6) else WALKS[:1]
        cases = 0
        Ts = sorted({1, S + 1, 31, 32, 33, 100, G - 1, G + 1, WS + 1} - {0})
        runs = [(B, T) for B in (1, 3, 2 * cpw + 3) for T in Ts]
        runs.append((3, 5000))
        for kind in ("random", "forward"):
            for B, T in runs:
                if kind == "random":
                    planes = random_planes(spec, B, T)
                else:
                    planes = forward(spec, torch.from_numpy(rng.integers(
                        0, 1 << n, (B, T)).astype(np.uint8)).to(dev))
                for ta in sorted({T, T - 2} & set(range(S, T + 1))):
                    full = (ta - S) * k
                    for L in sorted({full, cs.cut_bits(full)}):
                        for out in ("bytes", "bits"):
                            for entry in entries:
                                got = walk(fns[entry], spec, planes, ta, L,
                                           out)
                                want = walk(refs[entry], spec, planes, ta,
                                            L, out)
                                cases += 1
                                if not torch.equal(got, want):
                                    bad.append(f"{key} {kind} B={B} T={T} "
                                               f"t_actual={ta} L={L} {out} "
                                               f"{entry}")
                                    if len(bad) == 1:
                                        d = (got != want).nonzero()[:8]
                                        print(f"[generic-variants] {bad[0]}"
                                              f": differs at {d.tolist()}",
                                              flush=True)
                if B == 3 and T in (100, 5000):
                    bits = generic.traceback_batch_generic_plain(
                        spec, planes[:2], T, (T - S) * k, "bits")
                    got = walk(fns[entries[0]], spec, planes[:2], T,
                               (T - S) * k, "bits")
                    got_b = walk(fns[entries[0]], spec, planes[:2], T,
                                 (T - S) * k, "bytes")
                    if not (torch.equal(got, bits)
                            and torch.equal(got_b, pad_and_pack(bits))):
                        bad.append(f"{key} {kind} T={T} plain")
        result["checked"][key] = cases
        print(f"[generic-variants] {result['lib']} walk {key}: {cases} "
              f"cases, {1 << logc} lanes a channel, {cpw} channels a warp, "
              f"{G} steps a segment, warm-up {wu}",
              flush=True)

    rng = np.random.default_rng(2052)  # the same inputs in every variant
    timed = []
    for name, code, L in cs.GENERIC_MAIN:
        spec = cs.generic_spec(fec, code)
        msgs = rng.integers(0, 2, (cs.MAIN_B, L), dtype=np.uint8)
        seg, _ = fec.encode_bits(spec, torch.from_numpy(msgs).to(dev))
        seg = torch.from_numpy(cs.corrupt(rng, seg.cpu().numpy(),
                                          cs.MAIN_NOISE, spec.n)).to(dev)
        entry = WALKS[1] if generic.k2_supported(spec) else WALKS[0]
        timed.append((name, spec, forward(spec, seg), L, entry))
    if which == "all":
        for k, logns, *_ in cs.generic_walk_shapes(source):
            spec = spec_of(k, logns, min(k + 2, 8))
            seg = torch.from_numpy(rng.integers(
                0, 1 << spec.n, (ALL_B, ALL_T)).astype(np.uint8)).to(dev)
            timed.append((f"shape k{k}_NS{1 << logns}", spec,
                          forward(spec, seg), (ALL_T - spec.S) * k, WALKS[0]))
    for name, spec, planes, L, entry in timed:
        T = planes.shape[1]
        times = {"var": [], "ref": []}
        out = {}
        for i in range(calls):
            order = (("ref", refs), ("var", fns)) if i % 2 else \
                (("var", fns), ("ref", refs))
            for key, lib in order:
                res = torch.empty((planes.shape[0], (L + 7) // 8),
                                  dtype=torch.uint8, device=dev)
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                torch.cuda._sleep(10_000_000)
                e0.record()
                walk(lib[entry], spec, planes, T, L, "bytes", res)
                e1.record()
                torch.cuda.synchronize()
                times[key].append(e0.elapsed_time(e1))
                out[key] = res
            if i == 0 and not torch.equal(out["var"], out["ref"]):
                bad.append(f"{name} timed input")
        lib = ctypes.CDLL(lib_path)
        if hasattr(lib, "generic_walk_trace"):
            buf = (ctypes.c_ulonglong * 9)()
            lib.generic_walk_trace(buf, 1)
            walk(fns[entry], spec, planes, T, L, "bytes")
            torch.cuda.synchronize()
            lib.generic_walk_trace(buf, 0)
            warps = max(buf[8], 1)
            parts = {p: buf[i] / warps for i, p in enumerate(TRACE_PARTS)}
            parts.update(rounds=buf[5] / warps, rewalked=buf[6] / warps,
                         total=buf[7] / warps, warps=buf[8])
            result.setdefault("trace", {})[name] = parts
            print(f"[generic-variants] {result['lib']} walk trace {name}: "
                  "cycles a warp " + ", ".join(
                      f"{p} {v:.0f}" for p, v in parts.items()), flush=True)
        del planes
        result["ms"][name] = statistics.median(times["var"])
        result["ref_ms"][name] = statistics.median(times["ref"])
        print(f"[generic-variants] {result['lib']} walk {name} ({entry}, "
              f"B={cs.MAIN_B if not name.startswith('shape') else ALL_B} "
              f"T={T} L={L}): {result['ms'][name]:.4f} ms, reference "
              f"{result['ref_ms'][name]:.4f} ms", flush=True)
    result["differs"] = bad
    print(json.dumps(result))
    return 1 if bad else 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ref", help="a reference acs_generic.cu")
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME[=SOURCE.cu], e.g. c1=/tmp/c1.cu (repeatable)")
    ap.add_argument("--walk", action="store_true",
                    help="the walk (traceback_generic, _k2), not the forward")
    ap.add_argument("--trace", action="store_true",
                    help="with --walk: build each source with the walk's "
                    "clock64 stamps and print each main-path code's cycles "
                    "a warp by part")
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
        return (run_walk if args.walk else run)(
            args.run, args.source, args.ref_lib, args.calls, args.shapes)
    import torch
    if not torch.cuda.is_available():
        print("torch_generic_variants: no CUDA device", file=sys.stderr)
        return 1
    builds = {}
    for item in args.variant or ["default"]:
        name, _, src = item.partition("=")
        builds[name] = Path(src) if src else SOURCE
    if args.trace:
        args.out.mkdir(parents=True, exist_ok=True)
        builds = {name: traced(src, args.out) for name, src in builds.items()}
    if args.ref:
        builds["reference"] = Path(args.ref)
    libs, failed = build_all(builds, args.out)
    if args.sass:
        dump_sass(libs, args.out, args.walk)
    if "reference" in failed:
        return 1
    ref_lib = libs.pop("reference", None)
    status = 1 if failed else 0
    for name, lib in libs.items():
        cmd = [sys.executable, str(Path(__file__).resolve()), "--run",
               str(lib), "--source", str(builds[name]), "--calls",
               str(args.calls), "--shapes", args.shapes]
        if args.walk:
            cmd.append("--walk")
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
