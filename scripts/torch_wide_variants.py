#!/usr/bin/env python3
"""Build-time variants of the wide forwards (`acs_wide_forward`, with
`--soft` `acs_soft_wide_forward`, csrc/acs_wide.cu) or, with `--walk`, of
the wide segment walks (`traceback_wide`, `_masked`, `_ragged`, `_multi`,
csrc/traceback_wide.cu) against a reference build of the same C entries, on
one GPU.

    python3 scripts/torch_wide_variants.py [--soft [--n 4 6]] \\
        [--ref PATH.cu] [--variant NAME[=SOURCE.cu] ...] [--ns 512 16384] \\
        [--calls 5] [--sass] [--out DIR]
    python3 scripts/torch_wide_variants.py --walk [--ref PATH.cu ...] \\
        [--variant NAME[=SOURCE.cu] ...] [--lines NAME=SPEC ...] \\
        [--ns 512 2048 16384] [--check-ns ...] [--modes ...] [--calls 7] \\
        [--out DIR]

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

`--walk`: the variants are csrc/traceback_wide.cu, copies of it
(`--variant NAME=SOURCE.cu`) and copies whose walk constants `--lines`
rewrites: SPEC is `field=value,...` with the fields g (G's cap, `kGCap`),
wu (warm-up steps, `kWarm`), spw (segments a warp, `kSegs`), warps (the
most warps a walk, `kWarps`) and fill (the warps a launch keeps within,
`kFill`), e.g. `--lines wu16=wu=16` or `--lines one_warp=fill=1`.  The
reference (`--ref`) is one or more sources that together define the four
C entries, built into one library, e.g. an older tree's
csrc/traceback_wide.cu and csrc/traceback_k1.cu.  Each variant is held
bit for bit against the reference at every NS of `--check-ns` (default
all six) on the forward's words of 3%-corrupted packets and on garbage
words, B = 3, at `chip_smoke.wide_walk_lengths` of its own constants and
the warps its launches take (one window), terminated (t_actual T and
T - 2, whole and cut messages) and masked (live 0, S, T - 1, T from random
starts, whole and cut rows), and on 8 rows ragged (lengths 0, 1, S, S + 1,
T - 1, T, past T, negative, whole and cut rows) and list (NW = 1, 4 and
8, live T and T - 9, out_start 0, 13 and T // 3, whole and cut windows),
bits and bytes, and against the plain walks on the first rows; then over
more than one window (`chip_smoke.wide_walk_windows`): the smallest batch
of one warp a walk over three windows and 8 rows over two, both kinds of
words, all four walks (the edge lengths, NW = 4 from step 13); then timed
at each `--ns`
in turns with the reference (WALK_CODES with 3% of the segments hit;
16384: (l)'s code, as `chip_smoke.py` times it), each mode of `--modes`
(default all four) on two forwards' words alternately: at B = 2048,
T = 2062 the terminated walk into bytes, the masked walk from state 0
into bits and the ragged walk into bytes at lengths uniform in
[S + 1, T] ((l)'s); and the list walk of (l)'s tail-biting list decode:
64 packets of 2048 bits, extended by `list_wrap`, NW = 4 walks from the
four best end states, the window [wl, Te) as bits.  At NS <= 1024 the
run also times, beside the terminated walk, the generic walk of
csrc/acs_generic.cu (`traceback_generic`, the package's build: the staged
windows over a k = 1 code's planes) on the generic forward's planes of a
code of the same K and input.
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
SOURCE = ROOT / "convolutionalencdec_tpu_torch" / "csrc" / "acs_wide.cu"
WALK_SOURCE = (ROOT / "convolutionalencdec_tpu_torch" / "csrc"
               / "traceback_wide.cu")
WALKS = ("traceback_wide", "traceback_wide_masked", "traceback_wide_ragged",
         "traceback_wide_multi")
WALK_MODES = ("terminated", "masked", "ragged", "multi")
# The walks' timed codes: rate-1/2 codes of K = 10 ... 14 with no common
# factor (none catastrophic: a catastrophic code's survivors never merge,
# so every warm-up guess is wrong), and (l)'s code at NS = 16384.
WALK_CODES = {512: (0o1167, 0o1545), 1024: (0o2365, 0o3173),
              2048: (0o4335, 0o5723), 4096: (0o10533, 0o17661),
              8192: (0o21675, 0o27123)}
# --lines fields and the constants of csrc/traceback_wide.cu they set.
WALK_FIELDS = {"g": "kGCap", "wu": "kWarm", "spw": "kSegs",
               "warps": "kWarps", "fill": "kFill"}
# The list walk's timed size: (l)'s tail-biting list decode.
LIST_B, LIST_L, LIST_NW = 64, 2048, 4
LIBS = ROOT / "convolutionalencdec_tpu_torch" / "build" / "wide_variants"
TIMED_B, TIMED_T = 2048, 2062
CHECK_B, CHECK_T = 64, (1, 2, 3, 4, 5, 6, 7, 8, 9, 61, 62, 63, 64, 65)


def build_all(builds: dict[str, Path | list[Path]], out: Path):
    """name -> source (or sources, one library): one nvcc each, in
    parallel; returns (name -> library, names that failed).  Prints each
    build's register report."""
    sys.path.insert(0, str(ROOT))
    from convolutionalencdec_tpu_torch.kernels import _build
    nvcc = _build.find_nvcc()
    out.mkdir(parents=True, exist_ok=True)
    LIBS.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, src in builds.items():
        lib = LIBS / f"{name}.so"
        srcs = src if isinstance(src, list) else [src]
        cmd = [nvcc, *_build.NVCC_FLAGS, "-shared", "-o", str(lib),
               *map(str, srcs)]
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
                    or "acs_soft_round_kernel" in line
                    or "wide_walk_kernel" in line):
                regs = next((x for x in lines[i + 1:i + 4]
                             if "registers" in x), "").strip()
                spill = next((x for x in lines[i + 1:i + 4]
                              if "spill" in x), "").strip()
                fn = line.split("'")[1] if "'" in line else line
                print(f"[variants] {name} {fn}: {regs}; {spill}")
    return libs, failed


def dump_sass(libs: dict[str, Path], out: Path) -> None:
    """The SASS (cuobjdump -sass) of each library's round kernels at
    NS = 16384 into out/NAME.sass; and whether each build's whole SASS is
    the reference's instruction for instruction (every function's
    instructions, addresses aside), printed."""
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "scripts"))
    from _torch_variants import sass_functions
    from convolutionalencdec_tpu_torch.kernels import _build
    cuobjdump = Path(_build.find_nvcc()).parent / "cuobjdump"
    funcs = {}
    for name, lib in libs.items():
        proc = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                              capture_output=True, text=True)
        parts = proc.stdout.split("Function : ")
        keep = [p for p in parts[1:] if "acs_round_kernelILi14" in p[:200]
                or "acs_soft_round_kernelILi14" in p[:200]]
        (out / f"{name}.sass").write_text(
            "".join("Function : " + p for p in keep) + proc.stderr)
        # A function's name without its anonymous namespace's tag, which
        # names the source file.
        funcs[name] = {re.sub(r"\d+_GLOBAL__N__\w+?_cu_[0-9a-f]{8}", "",
                              fn): [t for a, t in body if a != "label"]
                       for fn, body in sass_functions(proc.stdout).items()}
    ref = funcs.get("reference")
    for name, f in funcs.items():
        if ref is None or name == "reference":
            continue
        differ = sorted(fn for fn in set(f) | set(ref)
                        if f.get(fn) != ref.get(fn))
        print(f"[variants] {name}: SASS of {len(f)} functions, "
              f"{sum(map(len, f.values()))} instructions (reference "
              f"{len(ref)}, {sum(map(len, ref.values()))}); instruction for "
              f"instruction the reference's: {'yes' if not differ else 'no'}"
              + (f"; {len(differ)} differ, e.g. {differ[:4]}" if differ
                 else ""), flush=True)


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


def with_lines(name: str, spec: str, out: Path) -> Path:
    """A copy of csrc/traceback_wide.cu whose walk constants `spec` (see
    the module docstring) rewrites, written to out/NAME.cu."""
    src = WALK_SOURCE.read_text()
    for field in spec.split(","):
        key, _, value = field.partition("=")
        if key not in WALK_FIELDS or not value.isdigit():
            raise SystemExit(f"--lines {name}: fields are {set(WALK_FIELDS)}"
                             " with whole numbers")
        src, count = re.subn(rf"constexpr int {WALK_FIELDS[key]} = \d+;",
                             f"constexpr int {WALK_FIELDS[key]} = {value};",
                             src)
        if count != 1:
            raise SystemExit(f"--lines {name}: no {WALK_FIELDS[key]}")
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"{name}.cu"
    path.write_text(src)
    return path


def load_walks(path: Path) -> dict:
    """The four wide walks' C entries of a library, with the package's
    argument types."""
    from convolutionalencdec_tpu_torch.kernels import _build
    lib = ctypes.CDLL(str(path))
    fns = {name: getattr(lib, name) for name in WALKS}
    for name, fn in fns.items():
        fn.argtypes = _build.SIGNATURES[name]
        fn.restype = ctypes.c_int
    return fns


def run_walk(lib_path: str, source: str, ref_path: str | None, check_ns,
             timed_ns, calls: int, modes) -> int:
    """`--walk`: one variant's walks (built from `source`) against the
    reference build; prints its JSON line."""
    import numpy as np
    import torch
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import convolutionalencdec_tpu_torch as fec
    from convolutionalencdec_tpu_torch.kernels import _build, acs, generic
    from convolutionalencdec_tpu_torch.kernels import tailbiting as ktb
    dev = torch.device("cuda", 0)
    fns = load_walks(Path(lib_path))
    refs = load_walks(Path(ref_path)) if ref_path else {
        name: getattr(_build.library(), name) for name in WALKS}
    stream = torch.cuda.current_stream(dev).cuda_stream
    pad_and_pack = fec.ops.viterbi.pad_and_pack
    rng = np.random.default_rng(2060)
    lines = {ns: rest for ns, *rest in cs.wide_walk_lines(source)}

    def result_rows(shape, L, out, res):
        if res is None:
            res = torch.full((*shape, (L + 7) // 8 if out == "bytes" else L),
                             0xA5, dtype=torch.uint8, device=dev)
        return res

    def launched(name, spec, code, res):
        if code:
            raise RuntimeError(f"{spec}: {name}, CUDA error {code}")
        return res

    def terminated(lib, spec, words, t_actual, L, out, res=None):
        B, T = words.shape[:2]
        res = result_rows((B,), L, out, res)
        return launched(WALKS[0], spec, lib[WALKS[0]](
            words.data_ptr(), res.data_ptr(), B, T, t_actual,
            spec.num_states, spec.S, L, int(out == "bytes"), stream), res)

    def masked(lib, spec, words, starts, live, L, out, res=None):
        B, T = words.shape[:2]
        res = result_rows((B,), L, out, res)
        return launched(WALKS[1], spec, lib[WALKS[1]](
            words.data_ptr(), starts.data_ptr(), res.data_ptr(), B, T,
            spec.num_states, spec.S, live, L, int(out == "bytes"), stream),
            res)

    def ragged(lib, spec, words, lens, L, out, res=None):
        B, T = words.shape[:2]
        res = result_rows((B,), L, out, res)
        return launched(WALKS[2], spec, lib[WALKS[2]](
            words.data_ptr(), lens.data_ptr(), res.data_ptr(), B, T,
            spec.num_states, spec.S, L, int(out == "bytes"), stream), res)

    def multi(lib, spec, words, starts, live, start, steps, out, res=None):
        B, T = words.shape[:2]
        res = result_rows(tuple(starts.shape), steps, out, res)
        return launched(WALKS[3], spec, lib[WALKS[3]](
            words.data_ptr(), starts.data_ptr(), res.data_ptr(), B, T,
            spec.num_states, spec.S, starts.shape[1], live, start, steps,
            int(out == "bytes"), stream), res)

    def noisy_segments(spec, B, T):
        msgs = rng.integers(0, 2, (B, max(T - spec.S, 1)), dtype=np.uint8)
        seg = fec.encode_bits(spec, torch.from_numpy(msgs).to(dev))[0]
        return torch.from_numpy(cs.corrupt(
            rng, seg[:, :T].cpu().numpy(), cs.MAIN_NOISE, spec.n)).to(dev)

    result = {"lib": Path(lib_path).stem, "walk": True, "lines": lines,
              "checked": {}, "ms": {}, "ref_ms": {}, "staged_ms": {}}
    bad = []

    def same(got, want, what):
        if not torch.equal(got, want):
            bad.append(what)
            if len(bad) == 1:
                d = (got != want).nonzero()[:8]
                print(f"[wide-variants] {what}: differs at {d.tolist()}",
                      flush=True)

    def both(walk, *args, what):
        """The variant's rows against the reference's; returns them."""
        got = walk(fns, *args)
        same(got, walk(refs, *args), what)
        return got

    for NS in check_ns:
        gcap, wu, spw = lines[NS]
        spec = cs.bfly_spec(fec, rng, NS, 4)
        S, cases = spec.S, 0
        lengths = cs.wide_walk_lengths(S, spw, cs.wide_walk_warps(3, source))
        for T in lengths:
            for kind in ("noisy", "garbage"):
                if kind == "garbage":
                    rows = torch.from_numpy(rng.integers(
                        -2 ** 31, 2 ** 31, (8, T, NS // 32)).astype(
                            np.int32)).to(dev)
                else:
                    rows = acs.acs_forward_batch(
                        spec, noisy_segments(spec, 8, T))[0]
                words = rows[:3]
                for ta in sorted({T, T - 2} & set(range(S, T + 1))):
                    full = ta - S
                    for L in sorted({full, cs.cut_bits(full)}):
                        for out in ("bits", "bytes"):
                            both(terminated, spec, words, ta, L, out,
                                 what=f"NS={NS} {kind} T={T} t_actual={ta} "
                                 f"L={L} {out}")
                            cases += 1
                starts = torch.from_numpy(rng.integers(0, NS, 3).astype(
                    np.int32)).to(dev)
                for live in sorted({0, min(S, T), T - 1, T}):
                    for L in sorted({T, cs.cut_bits(T)}):
                        for out in ("bits", "bytes"):
                            both(masked, spec, words, starts, live, L, out,
                                 what=f"NS={NS} {kind} T={T} masked "
                                 f"live={live} L={L} {out}")
                            cases += 1
                if T >= S:
                    lens = torch.from_numpy(np.array(
                        [0, 1, S, S + 1, T - 1, T, T + 3, -2],
                        np.int32)).to(dev)
                    for L in sorted({T - S, cs.cut_bits(T - S)}):
                        for out in ("bits", "bytes"):
                            both(ragged, spec, rows, lens, L, out,
                                 what=f"NS={NS} {kind} T={T} ragged "
                                 f"L={L} {out}")
                            cases += 1
                    want = acs.traceback_batch_ragged_plain(
                        spec, rows, lens.clamp(0, T), T - S, "bytes")
                    same(ragged(fns, spec, rows, lens, T - S, "bytes"),
                         want, f"NS={NS} {kind} T={T} ragged plain")
                for nw, live, start in ((1, T, min(13, T)),
                                        (4, max(T - 9, 0), 0),
                                        (8, T, T // 3)):
                    starts = torch.from_numpy(rng.integers(
                        0, NS, (8, nw)).astype(np.int32)).to(dev)
                    for steps in sorted({T - start,
                                         max(T - start - 11, 0)}):
                        for out in ("bits", "bytes"):
                            both(multi, spec, rows, starts, live, start,
                                 steps, out, what=f"NS={NS} {kind} T={T} "
                                 f"multi NW={nw} live={live} "
                                 f"out_start={start} steps={steps} {out}")
                            cases += 1
                    want = acs.traceback_batch_multi_plain(
                        spec, rows[:2], starts[:2], live, start, T - start,
                        "bits")
                    same(multi(fns, spec, rows[:2], starts[:2], live, start,
                               T - start, "bits"), want,
                         f"NS={NS} {kind} T={T} multi NW={nw} plain")
                if T == lengths[-1]:
                    want = acs.traceback_batch_plain(spec, words[:2], T,
                                                     T - S, "bits")
                    same(terminated(fns, spec, words[:2], T, T - S, "bits"),
                         want, f"NS={NS} plain")
                    same(terminated(fns, spec, words[:2], T, T - S,
                                    "bytes"), pad_and_pack(want),
                         f"NS={NS} plain bytes")
                    starts = torch.from_numpy(rng.integers(0, NS, 3).astype(
                        np.int32)).to(dev)
                    want = acs.traceback_batch_masked_plain(
                        spec, words[:2], starts[:2], T - 7, T, "bits")
                    same(masked(fns, spec, words[:2], starts[:2], T - 7, T,
                                "bits"), want, f"NS={NS} masked plain")
                del words, rows
        # Over more than one window: the smallest batch of one warp a walk
        # over three, and 8 rows (the most warps) over two.
        one = cs.wide_walk_consts(source)["kFill"] // 2 + 1
        for B, windows in ((one, 3), (8, 2)):
            T = cs.wide_walk_windows(spw, gcap, cs.wide_walk_warps(B, source),
                                     windows)
            for kind in ("noisy", "garbage"):
                if kind == "garbage":
                    gen = torch.Generator(device=dev).manual_seed(
                        int(rng.integers(1 << 62)))
                    words = torch.randint(0, 256, (B, T, NS // 8),
                                          dtype=torch.uint8, device=dev,
                                          generator=gen).view(torch.int32)
                else:
                    words = acs.acs_forward_batch(
                        spec, noisy_segments(spec, B, T))[0]
                lens = torch.from_numpy(np.concatenate(
                    [[0, 1, S, S + 1, T - 1, T, T + 3, -2],
                     rng.integers(0, T + 1, B - 8)]).astype(np.int32)).to(dev)
                starts = torch.from_numpy(rng.integers(
                    0, NS, (B, 4)).astype(np.int32)).to(dev)
                what = f"NS={NS} {kind} B={B} T={T}"
                both(terminated, spec, words, T - 2, T - 2 - S, "bytes",
                     what=f"{what} terminated")
                both(masked, spec, words, starts[:, 0].contiguous(), T - 1, T,
                     "bits", what=f"{what} masked")
                both(ragged, spec, words, lens, T - S, "bytes",
                     what=f"{what} ragged")
                both(multi, spec, words, starts, T - 9, 13, T - 13, "bytes",
                     what=f"{what} multi")
                cases += 4
                del words
        torch.cuda.synchronize()
        result["checked"][NS] = cases
        print(f"[wide-variants] {result['lib']} NS={NS} (G cap {gcap}, "
              f"warm-up {wu}, {spw} segments a warp): "
              f"{cases} cases against the reference", flush=True)

    rng = np.random.default_rng(2061)  # the same inputs in every variant
    B, T = TIMED_B, TIMED_T
    for NS in timed_ns:
        spec = (fec.CodeSpec(**cs.WIDE_MAIN) if NS == 16384
                else fec.CodeSpec(K=NS.bit_length(), g=WALK_CODES[NS]))
        seg = noisy_segments(spec, B, T)
        decs = [acs.acs_forward_batch(spec, torch.roll(seg, r, dims=0))[0]
                for r in range(2)]
        zeros = torch.zeros(B, dtype=torch.int32, device=dev)
        lens = [torch.from_numpy(rng.integers(spec.S + 1, T + 1, B).astype(
            np.int32)).to(dev) for _ in range(2)]
        res = {"bytes": torch.empty((B, (T - spec.S + 7) // 8),
                                    dtype=torch.uint8, device=dev),
               "bits": torch.empty((B, T), dtype=torch.uint8, device=dev),
               "list": torch.empty((LIST_B, LIST_NW, LIST_L),
                                   dtype=torch.uint8, device=dev)}
        lists = None
        if "multi" in modes:
            # (l)'s list decode: the circularly extended packets' forward
            # from all-zero metrics, the four best end states.
            wl = ktb.list_wrap(spec, LIST_L)
            msgs = torch.from_numpy(rng.integers(
                0, 2, (LIST_B, LIST_L), dtype=np.uint8)).to(dev)
            seg_t = torch.from_numpy(cs.corrupt(
                rng, fec.encode_tailbiting(spec, msgs).cpu().numpy(),
                cs.MAIN_NOISE, spec.n)).to(dev)
            lists = []
            for r in range(2):
                ext = fec.tailbiting.circular_extend(
                    torch.roll(seg_t, r, dims=0), wl, 0, axis=1)
                words, fm = acs.acs_forward_batch(spec, ext, torch.zeros(
                    (LIST_B, spec.num_states), dtype=torch.int32,
                    device=dev))
                lists.append((words, torch.argsort(
                    fm, dim=1, stable=True)[:, :LIST_NW].to(torch.int32)))
            Te = lists[0][0].shape[1]
        runs = {
            "terminated": lambda lib, d: terminated(
                lib, spec, decs[d], T, T - spec.S, "bytes", res["bytes"]),
            "masked": lambda lib, d: masked(
                lib, spec, decs[d], zeros, T, T, "bits", res["bits"]),
            "ragged": lambda lib, d: ragged(
                lib, spec, decs[d], lens[d], T - spec.S, "bytes",
                res["bytes"]),
            "multi": lambda lib, d: multi(
                lib, spec, lists[d][0], lists[d][1], Te, wl, LIST_L, "bits",
                res["list"])}
        staged = None
        if NS <= 1024 and "terminated" in modes:
            # The generic kernels take the k = 1 codes that are not
            # butterflies: the timed code with its second generator's
            # oldest tap moved (still no common factor).
            gspec = fec.CodeSpec(K=spec.K, g=(spec.g[0], spec.g[1] ^ 1))
            gseg = noisy_segments(gspec, B, T)
            planes = [generic.acs_forward_batch_generic(
                gspec, torch.roll(gseg, r, dims=0))[0] for r in range(2)]
            del gseg
            staged = lambda _, d: generic.traceback_batch_generic(
                gspec, planes[d], T, T - gspec.S, "bytes")
        for mode in modes:
            fn = runs[mode]
            same(fn(fns, 0).clone(), fn(refs, 0),
                 f"NS={NS} timed input {mode}")
            times = {"var": [], "ref": [], "staged": []}
            launches = {"walk": 0, "staged": 0}
            for i in range(calls):
                order = [("var", fns), ("ref", refs)]
                if staged is not None and mode == "terminated":
                    order.append(("staged", None))
                if i % 2:
                    order.reverse()
                for key, lib in order:
                    # Each build reads the other forward's words than the
                    # launch before it: no sector comes from L2.
                    kind = "staged" if key == "staged" else "walk"
                    d = launches[kind] % 2
                    launches[kind] += 1
                    torch.cuda.synchronize()
                    torch.cuda._sleep(10_000_000)
                    e0 = torch.cuda.Event(enable_timing=True)
                    e1 = torch.cuda.Event(enable_timing=True)
                    e0.record()
                    if key == "staged":
                        staged(None, d)
                    else:
                        fn(lib, d)
                    e1.record()
                    torch.cuda.synchronize()
                    times[key].append(e0.elapsed_time(e1))
            key = f"{NS} {mode}"
            result["ms"][key] = statistics.median(times["var"])
            result["ref_ms"][key] = statistics.median(times["ref"])
            size = (f"B={LIST_B} NW={LIST_NW} Te={Te} out_start={wl}"
                    if mode == "multi" else f"B={B} T={T}")
            line = (f"[wide-variants] {result['lib']} NS={NS} {mode} "
                    f"({size}): {result['ms'][key]:.4f} ms, reference "
                    f"{result['ref_ms'][key]:.4f} ms")
            if times["staged"]:
                result["staged_ms"][key] = statistics.median(times["staged"])
                line += (f", staged generic walk "
                         f"{result['staged_ms'][key]:.4f} ms")
            print(line, flush=True)
        del decs, res, lists
        if staged is not None:
            del planes
        torch.cuda.empty_cache()
    result["differs"] = bad
    print(json.dumps(result))
    return 1 if bad else 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--soft", action="store_true",
                    help="the soft C entry, acs_soft_wide_forward")
    ap.add_argument("--n", type=int, nargs="+", default=[4],
                    help="soft: the codes' n in the bit-for-bit checks")
    ap.add_argument("--ref", type=Path, nargs="+",
                    help="the reference's source(s), one library: an "
                         "acs_wide.cu, or with --walk sources defining the "
                         "four walks")
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME[=SOURCE.cu], e.g. r4=/tmp/r4.cu (repeatable)")
    ap.add_argument("--ns", type=int, nargs="+", default=[16384])
    ap.add_argument("--calls", type=int, default=5)
    ap.add_argument("--sass", action="store_true",
                    help="keep each build's SASS beside its log")
    ap.add_argument("--out", type=Path, default=LIBS,
                    help="directory of the build logs and SASS")
    ap.add_argument("--walk", action="store_true",
                    help="the wide walks (traceback_wide, _masked, "
                         "_ragged, _multi)")
    ap.add_argument("--modes", nargs="+", choices=WALK_MODES,
                    default=list(WALK_MODES),
                    help="--walk: the walks timed")
    ap.add_argument("--lines", action="append", default=[],
                    help="--walk: NAME=SPEC, walk constants rewritten "
                         "(repeatable; see the module docstring)")
    ap.add_argument("--check-ns", type=int, nargs="+",
                    default=[512 << i for i in range(6)],
                    help="--walk: the NS of the bit-for-bit checks")
    ap.add_argument("--run", help=argparse.SUPPRESS)
    ap.add_argument("--source", help=argparse.SUPPRESS)
    ap.add_argument("--ref-lib", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.run:
        if args.walk:
            return run_walk(args.run, args.source, args.ref_lib,
                            args.check_ns, args.ns, args.calls, args.modes)
        return run(args.run, args.source, args.ref_lib, args.ns, args.calls,
                   args.soft, args.n)
    import torch
    if not torch.cuda.is_available():
        print("torch_wide_variants: no CUDA device", file=sys.stderr)
        return 1
    builds = {}
    for item in args.variant or ([] if args.lines else ["default"]):
        name, _, src = item.partition("=")
        builds[name] = Path(src) if src else (WALK_SOURCE if args.walk
                                              else SOURCE)
    for item in args.lines:
        name, _, spec = item.partition("=")
        builds[name] = with_lines(name, spec, args.out)
    if args.ref:
        builds["reference"] = args.ref
    package = None
    if args.walk:  # the package's kernels (the forwards, the generic walk)
        import threading
        sys.path.insert(0, str(ROOT))
        from convolutionalencdec_tpu_torch.kernels import _build
        package = threading.Thread(target=_build.build)
        package.start()
    libs, failed = build_all(builds, args.out)
    if package is not None:
        package.join()
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
        if args.walk:
            cmd += ["--walk", "--check-ns", *map(str, args.check_ns),
                    "--modes", *args.modes]
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
