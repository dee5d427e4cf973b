#!/usr/bin/env python3
"""Build-time variants of the turbo constituent MAP (`turbo_rsc_map`,
csrc/turbo_rsc.cu) against a reference build of the same C entry, on one
GPU.

    python3 scripts/torch_turbo_variants.py [--ref PATH.cu] \\
        [--variant NAME[=SOURCE.cu] ...] [--define NAME:CONST=VALUE,...] \\
        [--calls 7] [--sass] [--batches B,...] [--out DIR]
    python3 scripts/torch_turbo_variants.py --chain
    python3 scripts/torch_turbo_variants.py --trace [--batches B,...]

Builds each variant, csrc/turbo_rsc.cu or a modified copy of it
(`--variant NAME=SOURCE.cu`, or `--define NAME:CONST=VALUE[,...]`, a
copy of csrc/turbo_rsc.cu with `constexpr ... CONST = VALUE;`, e.g.
`--define r8:kRenorm=8`), and, with `--ref`, another source of the same C entry (an
earlier tree's turbo_rsc.cu, e.g. from `git show REV:PATH`) as the
reference; one nvcc each, all at once, with `-Xptxas -v`, into the
package's build directory (the logs there too, or in `--out`).  Each
variant then runs in its own process (a kernel fault poisons the CUDA
context): it is held bit for bit against the reference build (or, with no
`--ref`, the package's build) and against the plain scan at NS = 8, 4, 2
and an 8-state code whose edges into a state carry one input, at
L = 1, 2, 7, 8, 9, 40, 47, 61, 63, 64, 65, 104, 1024, 2047 and 6144, B = 3
and B = 2 (32 / NS) + 3, a-priori to +-31 and +-4000, and the LA_CLAMP
contract case; then timed in turns with the reference (CUDA events after
a 0.1 s sleep, median of `--calls`, inputs rotated over four draws) at
the turbo serving shape B = 2048, L = 1024, NS = 8 and at B = 2048,
L = 6144, and with `--batches` at B = each of them, L = 1024.  With
`--sass`, keeps the SASS of each build's NS = 8 kernel
(16-byte copies) beside the build logs, with its instruction count.
Prints one JSON line per variant and the card's name and power limit.
Exits non-zero if a build fails or a variant differs.

`--chain` times the recursion's step alone: a micro-kernel in which each
warp runs 4096 dependent steps of K8's forward step (two __shfl_sync from
the lanes of a state's predecessors, an add each, a min) or the same step
with the shuffles replaced by register moves, at 1, 2, 4, 8 and 16 warps
an SM, and prints the cycles a step (clock64) of each.

`--trace` builds a copy of csrc/turbo_rsc.cu whose walks stamp clock64 at
each round's start, after its copies landed (and, in phase 2, its helper
met it), before phase 2's reduction and at its end, into words past the
scratch, and prints, at L = 1024 and B = 2048 (and each of `--batches`),
for the first, middle and last block of warps, each walk's cycles a round
(waiting, steps, reduction) as medians over phase 1 and phase 2 and the
cycles to its end.
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
SOURCE = ROOT / "convolutionalencdec_tpu_torch" / "csrc" / "turbo_rsc.cu"
LIBS = ROOT / "convolutionalencdec_tpu_torch" / "build" / "turbo_variants"
CHECK_L = (1, 2, 7, 8, 9, 40, 47, 61, 63, 64, 65, 104, 1024, 2047, 6144)
CODES = {"NS8": dict(), "NS4": dict(K=3, g_fb=0o7, g_fw=0o5),
         "NS2": dict(K=2, g_fb=0o3, g_fw=0o2),
         "NS8_same_u": dict(K=4, g_fb=0o12, g_fw=0o15)}
TIMED = ((2048, 1024), (2048, 6144))  # (B, L) at NS = 8
ROTATIONS = 4


def define_copy(name: str, assigns: str, out: Path) -> Path:
    """A copy of csrc/turbo_rsc.cu with `constexpr TYPE CONST = VALUE;` for
    each CONST=VALUE of the comma-separated `assigns`."""
    text = SOURCE.read_text()
    for assign in assigns.split(","):
        const, _, value = assign.partition("=")
        text, n = re.subn(rf"(constexpr \w+ {re.escape(const)} = )[^;]+;",
                          rf"\g<1>{value};", text)
        if n != 1:
            raise SystemExit(f"{const}: {n} definitions in {SOURCE}")
    path = out / f"{name}.cu"
    path.write_text(text)
    return path


def build_all(builds: dict[str, Path], out: Path):
    """name -> source: one nvcc each, in parallel; returns (name ->
    library, names that failed).  Prints each kernel's registers."""
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
            print(f"[turbo-variants] {name}: nvcc failed\n{output}",
                  file=sys.stderr)
            continue
        libs[name] = lib
        lines = output.splitlines()
        regs = [x.strip() for i, x in enumerate(lines) if "Used" in x
                and any("turbo_rsc_map_kernel" in y for y in lines[i - 3:i])]
        print(f"[turbo-variants] {name}: {len(regs)} kernels: "
              f"{sorted(set(regs))}", flush=True)
    return libs, failed


CHAIN_SOURCE = r"""
#include <cuda_runtime.h>
template <bool SHFL>
__global__ void chain(int* out, long long* cycles, int steps) {
  const int lane = threadIdx.x & 31, s = lane & 7, gb = lane - s;
  const int q0 = gb + 2 * (s & 3), q1 = q0 + 1;  // an 8-state trellis
  const int a = lane * 3 - 40, b = 17 - lane;
  int x = lane;
  const long long t0 = clock64();
  for (int i = 0; i < steps; i += 8) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int x0 = SHFL ? __shfl_sync(0xffffffffu, x, q0) : x;
      const int x1 = SHFL ? __shfl_sync(0xffffffffu, x, q1) : (x ^ k);
      x = min(x0 + a, x1 + b);
    }
  }
  const long long t1 = clock64();
  out[blockIdx.x * 32 + lane] = x;
  if (lane == 0) cycles[blockIdx.x] = t1 - t0;
}
extern "C" int run_chain(int shfl, int blocks, int steps, double* per_step) {
  int* out; long long* cyc;
  cudaMalloc(&out, blocks * 32 * sizeof(int));
  cudaMalloc(&cyc, blocks * sizeof(long long));
  if (shfl) chain<true><<<blocks, 32>>>(out, cyc, steps);
  else chain<false><<<blocks, 32>>>(out, cyc, steps);
  long long* host = new long long[blocks];
  const int err = cudaMemcpy(host, cyc, blocks * sizeof(long long),
                             cudaMemcpyDeviceToHost);
  double sum = 0;
  for (int i = 0; i < blocks; ++i) sum += host[i];
  *per_step = sum / blocks / steps;
  delete[] host;
  cudaFree(out);
  cudaFree(cyc);
  return err ? err : static_cast<int>(cudaGetLastError());
}
"""


def chain_probe(out: Path) -> int:
    """Cycles a step of the shuffle chain by warps an SM (`--chain`)."""
    import torch
    sys.path.insert(0, str(ROOT))
    from convolutionalencdec_tpu_torch.kernels import _build
    out.mkdir(parents=True, exist_ok=True)
    LIBS.mkdir(parents=True, exist_ok=True)
    src, lib = out / "chain.cu", LIBS / "chain.so"
    src.write_text(CHAIN_SOURCE)
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared",
                           "-o", str(lib), str(src)], capture_output=True,
                          text=True)
    if proc.returncode:
        print(proc.stdout + proc.stderr, file=sys.stderr)
        return 1
    fn = ctypes.CDLL(str(lib)).run_chain
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_double)]
    fn.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for shfl in (1, 0):
        for warps in (1, 2, 4, 8, 16):
            v = ctypes.c_double()
            fn(shfl, sms, 64, ctypes.byref(v))  # warm up
            code = fn(shfl, sms * warps, 4096, ctypes.byref(v))
            if code:
                print(f"run_chain failed: CUDA error {code}", file=sys.stderr)
                return 1
            print(f"[turbo-variants] chain {'shuffle' if shfl else 'register'}"
                  f" step, {warps} warps an SM: {v.value:.1f} cycles a step",
                  flush=True)
    return 0


# The trace's stamps, inserted at these places of `walk` (each must occur
# once in csrc/turbo_rsc.cu).
TRACE_PATCH = (
    ("  stage(0);\n  stage(1);\n  for (int k = 0; k < 2 * m; ++k) {\n",
     "  stage(0);\n  stage(1);\n"
     "  const long long tbase = clock64();\n"
     "  const int tcta = blockIdx.x == 0 ? 0 : blockIdx.x == gridDim.x / 2 ? 1"
     " : blockIdx.x == gridDim.x - 1 ? 2 : -1;\n"
     "  int* trace = tcta < 0 || lane ? nullptr : a.scratch + (size_t)"
     "((a.B + G - 1) / G) * G * nC * NS + (tcta * 2 + (DIR < 0)) * 256;\n"
     "  auto stamp = [&](int k, int i) { if (trace && k < 64) "
     "trace[4 * k + i] = (int)(clock64() - tbase); };\n"
     "  for (int k = 0; k < 2 * m; ++k) {\n    stamp(k, 0);\n"),
    ("    if (k >= m) round_barrier<DIR>();\n",
     "    if (k >= m) round_barrier<DIR>();\n    stamp(k, 1);\n"),
    ("      __syncwarp();\n      reduce_emit<",
     "      stamp(k, 2);\n      __syncwarp();\n      reduce_emit<"),
    ("    __syncwarp();  // the buffers of round k are rewritten later\n",
     "    __syncwarp();  // the buffers of round k are rewritten later\n"
     "    stamp(k, 3);\n"),
)


def trace(out: Path, batches: tuple[int, ...]) -> int:
    """Per-round cycles of the walks (`--trace`)."""
    import numpy as np
    import torch
    sys.path.insert(0, str(ROOT))
    from convolutionalencdec_tpu_torch.kernels import _build
    from convolutionalencdec_tpu_torch.kernels import turbo as kt
    from convolutionalencdec_tpu_torch.ops import turbo as ot
    text = SOURCE.read_text()
    for old, new in TRACE_PATCH:
        if text.count(old) != 1:
            print(f"--trace: {old!r} is not in {SOURCE} once",
                  file=sys.stderr)
            return 1
        text = text.replace(old, new)
    out.mkdir(parents=True, exist_ok=True)
    LIBS.mkdir(parents=True, exist_ok=True)
    src, lib = out / "trace.cu", LIBS / "trace.so"
    src.write_text(text)
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared",
                           "-o", str(lib), str(src)], capture_output=True,
                          text=True)
    if proc.returncode:
        print(proc.stdout + proc.stderr, file=sys.stderr)
        return 1
    entry, dev = Entry(lib), torch.device("cuda", 0)
    rsc = ot.RscSpec()
    table = kt._edge_table(rsc, dev)
    for B in (2048,) + batches:
        L = 1024
        fields = draw_fields(np.random.default_rng(B), dev, B, L, rsc.S, 4000)
        words = entry.scratch_words(B, L, 8)
        scratch = torch.zeros(words + 6 * 256, dtype=torch.int32, device=dev)
        for _ in range(3):
            torch.cuda._sleep(50_000_000)
            entry(rsc, table, fields, scratch)
        torch.cuda.synchronize()
        stamps = scratch[words:].view(3, 2, 64, 4).cpu().numpy().astype(
            np.int64)
        m = (-(-L // 32) + 1) // 2
        print(f"[turbo-variants] trace B={B} L={L}: cycles a round as "
              "(waiting, steps, reduction), median of phase 1 | phase 2",
              flush=True)
        for cta, where in enumerate(("first", "middle", "last")):
            for w, name in enumerate(("alpha", "beta")):
                t = stamps[cta, w, :2 * m]
                wait = t[:, 1] - t[:, 0]
                steps = np.where(t[:, 2] > 0, t[:, 2], t[:, 3]) - t[:, 1]
                red = np.where(t[:, 2] > 0, t[:, 3] - t[:, 2], 0)

                def med(x, lo, hi):
                    return int(np.median(x[lo:hi]))
                print(f"[turbo-variants]   {where} block, {name}: "
                      f"({med(wait, 1, m)}, {med(steps, 1, m)}, 0) | "
                      f"({med(wait, m + 1, 2 * m)}, "
                      f"{med(steps, m + 1, 2 * m)}, "
                      f"{med(red, m + 1, 2 * m)}); end {int(t[-1, 3])}; "
                      f"round m waits {int(wait[m])}", flush=True)
    return 0


def dump_sass(libs: dict[str, Path], out: Path) -> None:
    """The SASS (cuobjdump -sass) of each library's NS = 8, 16-byte-copy
    kernel into out/NAME.sass, with its count of instructions."""
    sys.path.insert(0, str(ROOT))
    from convolutionalencdec_tpu_torch.kernels import _build
    cuobjdump = Path(_build.find_nvcc()).parent / "cuobjdump"
    for name, lib in libs.items():
        proc = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                              capture_output=True, text=True)
        keep = [p for p in proc.stdout.split("Function : ")[1:]
                if "turbo_rsc_map_kernelILi8ELb1E" in p[:200]]
        (out / f"{name}.sass").write_text(
            "".join("Function : " + p for p in keep) + proc.stderr)
        count = sum(1 for p in keep for x in p.splitlines()
                    if x.strip().startswith("/*") and "*/" in x and ";" in x)
        text = "".join(keep)
        print(f"[turbo-variants] {name}: {count} SASS instructions in the "
              f"NS = 8 kernel, {text.count('SHFL')} shuffles, "
              f"{text.count('WARPSYNC.COLLECTIVE')} of them in a "
              "collective (not known converged)", flush=True)


class Entry:
    """The C entry of one library, with the scratch it needs."""

    def __init__(self, path: Path):
        lib = ctypes.CDLL(str(path))
        P, I = ctypes.c_void_p, ctypes.c_int
        self.fn = lib.turbo_rsc_map
        self.fn.argtypes = [P, P, P, P, P, P, P, P, I, I, I, I, P]
        self.fn.restype = I
        self.words = None
        if hasattr(lib, "turbo_rsc_map_scratch_words"):
            self.words = lib.turbo_rsc_map_scratch_words
            self.words.argtypes = [I, I, I]
            self.words.restype = ctypes.c_longlong

    def scratch_words(self, B, L, NS) -> int:
        # The parent's kernel kept [B, ceil(L / 32), NS] checkpoints.
        if self.words is None:
            return B * -(-L // 32) * NS
        return int(self.words(B, L, NS))

    def __call__(self, rsc, table, fields, scratch=None):
        import torch
        B, L = fields[0].shape
        NS = rsc.num_states
        if scratch is None:
            scratch = torch.empty(self.scratch_words(B, L, NS),
                                  dtype=torch.int32, device=table.device)
        out = torch.empty((B, L), dtype=torch.int32, device=table.device)
        code = self.fn(*(x.data_ptr() for x in fields), table.data_ptr(),
                       scratch.data_ptr(), out.data_ptr(), B, L, NS, rsc.S,
                       torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"turbo_rsc_map failed: CUDA error {code}")
        return out


def draw_fields(rng, dev, B, L, S, apriori, clamp=False):
    """l_sys, l_par, l_apriori [B, L], l_sys_tail, l_par_tail [B, S]
    (chip_smoke.turbo_fields' draw; `clamp`: the LA_CLAMP contract case)."""
    import numpy as np
    import torch
    from convolutionalencdec_tpu_torch.ops import turbo as ot

    def draw(mag, shape):
        return rng.integers(-mag, mag + 1, shape).astype(np.int32)
    f = [draw(31, (B, L)), draw(31, (B, L)), draw(apriori, (B, L)),
         draw(31, (B, S)), draw(31, (B, S))]
    if clamp:
        f = [x * 264 if i != 2 else x for i, x in enumerate(f)]
        f[2][:, ::7] = ot.LA_CLAMP
        f[2][:, 3::7] = -ot.LA_CLAMP
    return [torch.from_numpy(x).to(dev) for x in f]


def run(lib_path: str, ref_path: str | None, calls: int,
        batches: tuple[int, ...] = ()) -> int:
    """One variant against the reference build; prints its JSON line."""
    import numpy as np
    import torch
    sys.path.insert(0, str(ROOT))
    from convolutionalencdec_tpu_torch.kernels import _build
    from convolutionalencdec_tpu_torch.kernels import turbo as kt
    from convolutionalencdec_tpu_torch.ops import turbo as ot
    dev = torch.device("cuda", 0)
    var = Entry(Path(lib_path))
    if not ref_path:
        _build.build()
    ref = Entry(Path(ref_path) if ref_path else _build.LIBRARY)
    rng = np.random.default_rng(2051)
    result = {"lib": Path(lib_path).stem, "checked": 0, "ms": {},
              "ref_ms": {}}
    bad = []
    for code, kwargs in CODES.items():
        rsc = ot.RscSpec(**kwargs)
        table = kt._edge_table(rsc, dev)
        G = 32 // rsc.num_states
        for L in CHECK_L:
            for B, apriori, clamp in ((3, 31, False), (2 * G + 3, 4000, False),
                                      (3, ot.LA_CLAMP, True)):
                if clamp and L not in (104, 1024):
                    continue
                fields = draw_fields(rng, dev, B, L, rsc.S, apriori, clamp)
                got, want = var(rsc, table, fields), ref(rsc, table, fields)
                result["checked"] += 1
                if not torch.equal(got, want):
                    bad.append(f"{code} L={L} B={B} a-priori +-{apriori}")
                    if len(bad) == 1:
                        d = (got != want).nonzero()[:8].tolist()
                        print(f"[turbo-variants] {bad[0]}: differs at "
                              f"{d}", flush=True)
                if L in (47, 1024) and B == 3:
                    plain = kt.rsc_maxlogmap_batch_plain(rsc, *fields)
                    if not torch.equal(got, plain):
                        bad.append(f"{code} L={L} plain")
        print(f"[turbo-variants] {result['lib']} {code}: checked",
              flush=True)
    rsc = ot.RscSpec()
    table = kt._edge_table(rsc, dev)
    for B, L in TIMED + tuple((b, 1024) for b in batches):
        sets = [draw_fields(rng, dev, B, L, rsc.S, 4000)
                for _ in range(ROTATIONS)]
        scratch = {key: torch.empty(lib.scratch_words(B, L, 8),
                                    dtype=torch.int32, device=dev)
                   for key, lib in (("var", var), ("ref", ref))}
        times = {"var": [], "ref": []}
        out = {}
        for i in range(calls):
            order = (("ref", ref), ("var", var)) if i % 2 else \
                (("var", var), ("ref", ref))
            for key, lib in order:
                fields = sets[(i + (key == "ref")) % ROTATIONS]
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                torch.cuda._sleep(100_000_000)
                e0.record()
                got = lib(rsc, table, fields, scratch[key])
                e1.record()
                torch.cuda.synchronize()
                times[key].append(e0.elapsed_time(e1))
                out[key] = (got, fields)
            if i < 2:
                got, fields = out["var"]
                if not torch.equal(got, ref(rsc, table, fields)):
                    bad.append(f"timed input B={B} L={L}")
        name = f"B={B} L={L}"
        result["ms"][name] = statistics.median(times["var"])
        result["ref_ms"][name] = statistics.median(times["ref"])
        print(f"[turbo-variants] {result['lib']} {name}: "
              f"{result['ms'][name]:.4f} ms, reference "
              f"{result['ref_ms'][name]:.4f} ms", flush=True)
        del sets, scratch, out
    result["differs"] = bad
    print(json.dumps(result))
    return 1 if bad else 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ref", help="a reference turbo_rsc.cu")
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME[=SOURCE.cu] (repeatable)")
    ap.add_argument("--define", action="append", default=[],
                    help="NAME:CONST=VALUE[,CONST=VALUE...], a copy of "
                    "csrc/turbo_rsc.cu with those constexprs (repeatable)")
    ap.add_argument("--calls", type=int, default=7)
    ap.add_argument("--batches", default="",
                    help="comma-separated B, also timed at L = 1024")
    ap.add_argument("--chain", action="store_true",
                    help="time the shuffle chain alone and exit")
    ap.add_argument("--trace", action="store_true",
                    help="the walks' cycles a round, and exit")
    ap.add_argument("--sass", action="store_true",
                    help="keep the NS = 8 kernel's SASS beside the logs")
    ap.add_argument("--out", type=Path, default=LIBS,
                    help="directory of the build logs")
    ap.add_argument("--run", help=argparse.SUPPRESS)
    ap.add_argument("--ref-lib", help=argparse.SUPPRESS)
    args = ap.parse_args()
    batches = tuple(int(b) for b in args.batches.split(",") if b)
    if args.run:
        return run(args.run, args.ref_lib, args.calls, batches)
    import torch
    if not torch.cuda.is_available():
        print("torch_turbo_variants: no CUDA device", file=sys.stderr)
        return 1
    if args.chain:
        return chain_probe(args.out)
    if args.trace:
        return trace(args.out, batches)
    args.out.mkdir(parents=True, exist_ok=True)
    builds = {}
    for item in args.variant:
        name, _, src = item.partition("=")
        builds[name] = Path(src) if src else SOURCE
    for item in args.define:
        name, _, assigns = item.partition(":")
        builds[name] = define_copy(name, assigns, args.out)
    if not builds:
        builds["default"] = SOURCE
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
               str(lib), "--calls", str(args.calls), "--batches",
               args.batches]
        if ref_lib is not None:
            cmd += ["--ref-lib", str(ref_lib)]
        code = subprocess.run(cmd).returncode
        if code:
            print(f"[turbo-variants] {name}: exit {code}", file=sys.stderr)
            status = 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip())
    return status


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
