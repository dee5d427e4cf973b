#!/usr/bin/env python3
"""Build-time variants of the narrow walk (`traceback_k1`,
`traceback_k1_masked`, `traceback_k1_ragged` and `traceback_k1_multi` at
NS = 2 ... 256: `narrow_walk_kernel` in csrc/traceback_k1.cu) against a
reference build of the same C entries, on one GPU.

    python3 scripts/torch_narrow_walk.py --ref PARENT.cu \\
        [--variant NAME=SOURCE.cu ...] [--lines NAME=NS:G:WU,... ...] \\
        [--ns NS ...] [--timed KEY ...] [--no-time] [--calls 15] [--trace] \\
        [--out DIR]

Builds csrc/traceback_k1.cu (as "change"), each variant (a hand-edited copy
of it, `NAME=SOURCE.cu`) and each `--lines` copy (csrc/traceback_k1.cu
with the dispatch lines of the given NS rewritten: G steps a segment, WU
warm-up steps, e.g. `--lines g32=64:32:32`; an item `mNS:G:WU` rewrites
the list walk's line, e.g. `--lines m8=m64:8:16`),
and the reference (`--ref`, e.g. the parent tree's traceback_k1.cu: get it
with `git show HEAD:convolutionalencdec_tpu_torch/csrc/traceback_k1.cu >
_checkout/parent_traceback_k1.cu`); one nvcc each, all at once, with
`-Xptxas -v` (the logs in `--out`).  Each build then runs in its own
process (a kernel fault poisons the CUDA context): at each NS of its
dispatch switch (or of `--ns`) it is held bit for bit against the
reference on chip_smoke.py's batches
and cases of the narrow walk (`narrow_walk_batches` at its own G:
noisy, garbage and catastrophic-code words over one to four windows,
B = 1, a slice of a batch and a base 4 bytes past a 16-byte line; each
at every `narrow_walk_cases`: terminated and masked, whole and cut rows,
bits and bytes; and, where T >= S, ragged at `narrow_ragged_lengths`,
rows of T - S bits and a cut one, bits and bytes) and on 2048 channels
at 2054 steps, every byte of the rows (both builds write into rows
filled with 0xA5); its wrong
first-pass guesses on the garbage and catastrophic words (below 64 states
`rotating_words`) are counted; and at each NS of the list walk's switch
(or of `--ns`) the list walk on chip_smoke.py's `multi_walk_batches` at
NW = 1, 2, 8 and NS, live 0, S, T - 1 and T, each of `multi_windows`,
bits and bytes.
Then each build is timed in turns with the reference (CUDA events after a sleep that queues the launch, median of
`--calls`, two inputs alternately; `--timed` keeps the named ones,
`--no-time` none):
  (a) hard    NASA_K7, B = 2048, T = 2054: the forward's words of bench.py's
              3%-corrupted segments, the terminated walk into bytes;
  (a) soft    the same messages over AWGN at 3 dB, quantized to 7: the soft
              forward's words, the same walk;
  (c)         the ragged walk over those words, lengths uniform in
              [S + 1, T] (the ragged decodes' lengths), bytes of L bits;
  288 steps   the block stream's interior pending buffer (48 kept + 240 new
              steps from the argmin state): the masked walk, 240 bits out;
  (f)         LTE_TBCC_K7, 16384 DCI blocks of 56 bits at 2 dB: the soft
              wrap decode's masked walk over 192 steps, 104 bits out;
  (f) list    the same blocks: the soft list decode's walk of its 8
              candidates over the last 56 of 144 steps (out_start 88),
              56 bits out each; `(f) list NS=128` and `NS=256` the same
              walk on the forward's words of noisy packets of those codes;
  NS=128      a K = 8 code, and NS=256 K9_561_753, at (a)'s size, hard;
  (k) hard    K5_23_35 (NS = 16, T = 2052) at (a)'s size: the forward's words
              of 3%-corrupted segments, the terminated walk into bytes (the
              one-word walk);
  (k) soft    the same messages over AWGN at 3 dB, quantized to 7: the soft
              forward's words, the same walk;
  (k) ragged  the ragged walk over (k) hard's words, lengths uniform in
              [S + 1, T], bytes of L bits (the one-word ragged walk);
  (k) masked  the masked walk over (k) hard's words from random starts,
              every step live, T bits out; `(k) masked live-9` with the
              last 9 steps masked;
  (k) NS=...  the terminated walk at (k)'s size at the other one-word NS
              (`ONE_WORD_CODES`), hard;
and beside (a) hard the generic walk of csrc/acs_generic.cu
(`traceback_generic`, the package's build, k = 1, NS = 64) on the generic
forward's planes of a code of the same K.  Prints one JSON line per build
and the card's name and power limit.  Exits non-zero if a build fails or
differs.  `--trace`: each build with clock64
stamps in its window loop (`TRACE_EDITS`): before each timed case, cycles
a warp waiting for its window, warming up, walking its segment, checking
and walking again, and writing out, the rounds and lanes walked again,
and the whole run.  A variant named `diag_*` is a diagnostic cut of the kernel (its
bits are not the walk's, e.g. a copy that walks nothing or copies
nothing): it is timed without the checks.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "scripts"))
import _torch_variants  # noqa: E402

SOURCE = ROOT / "convolutionalencdec_tpu_torch" / "csrc" / "traceback_k1.cu"
LIBS = ROOT / "convolutionalencdec_tpu_torch" / "build" / "narrow_walk"
WALKS = ("traceback_k1", "traceback_k1_masked", "traceback_k1_ragged",
         "traceback_k1_multi")
SLEEP_CYCLES = 10_000_000
# The timed code at NS = 128 (no common factor: a catastrophic code's
# survivors never merge, so every warm-up guess would be wrong); NS = 256
# times K9_561_753.
TIMED_K8 = (0o247, 0o371)
# The one-word walk's timed codes besides (k)'s (NS = 16): the standard
# K = 3, 4 and 6 codes; at NS = 2 the only symmetric rate-1/2 code.
ONE_WORD_CODES = {2: (0o3, 0o3), 4: (0o7, 0o5), 8: (0o17, 0o15),
                  32: (0o65, 0o57)}


def with_lines(name: str, spec: str, out: Path) -> Path:
    """A copy of csrc/traceback_k1.cu whose dispatch lines `spec`
    (NS:G:WU, comma separated; mNS:G:WU the list walk's) rewrites, written
    to out/NAME.cu."""
    src = SOURCE.read_text()
    for item in spec.split(","):
        fn = "launch_multi" if item.startswith("m") else "launch_narrow"
        try:
            ns, g, wu = (int(x) for x in item.removeprefix("m").split(":"))
        except ValueError:
            raise SystemExit(f"--lines {name}: items are [m]NS:G:WU")
        log_ns, log_g = ns.bit_length() - 1, g.bit_length() - 1
        if 1 << log_ns != ns or 1 << log_g != g:
            raise SystemExit(f"--lines {name}: NS and G are powers of two")
        src, count = re.subn(
            rf"case {ns}: return {fn}<\d+, \d+, \d+>",
            f"case {ns}: return {fn}<{log_ns}, {log_g}, {wu}>", src)
        if count != 1:
            raise SystemExit(f"--lines {name}: no line for NS = {ns}")
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"{name}.cu"
    path.write_text(src)
    return path


# `--trace`: the walk's window loop stamped with clock64: each warp's
# cycles waiting for its window, warming up, walking its segment, checking
# and walking again, and writing out, the check's rounds and walked-again
# lanes, and its whole run from the first fetch, summed over warps into
# `g_narrow_trace`, read by the C entry `narrow_walk_trace`.
TRACE_EDITS = (
    ("// The walk: channel b from state",
     "__device__ unsigned long long g_narrow_trace[9];\n\n"
     "// The walk: channel b from state"),
    ("  // Window n_win - 1 - i goes to buffer i % NB, NB - 1 windows ahead.\n",
     "  unsigned long long tr[7] = {};\n  const long long tr0 = clock64();\n"
     "  // Window n_win - 1 - i goes to buffer i % NB, NB - 1 windows ahead.\n"),
    ("    const int j = n_win - 1 - i;\n    const int buf = i % NB;\n",
     "    const long long tA = clock64();\n"
     "    const int j = n_win - 1 - i;\n    const int buf = i % NB;\n"),
    ("    __syncwarp();\n    const int lo = j * WS;",
     "    __syncwarp();\n    const long long tB = clock64();\n"
     "    tr[0] += tB - tA;\n    const int lo = j * WS;"),
    ("    unsigned end = mine ? wk.template walk<false>(",
     "    const long long tC = clock64();\n    tr[1] += tC - tB;\n"
     "    unsigned end = mine ? wk.template walk<false>("),
    ("    // Top down: a segment whose start",
     "    const long long tD = clock64();\n    tr[2] += tD - tC;\n"
     "    // Top down: a segment whose start"),
    ("      if (!__any_sync(kFullMask, redo)) break;\n",
     "      if (!__any_sync(kFullMask, redo)) break;\n      tr[5] += 1;\n"
     "      tr[6] += __popc(__ballot_sync(kFullMask, redo));\n"),
    ("    top = __shfl_sync(kFullMask, end, c << logc);",
     "    const long long tE = clock64();\n    tr[3] += tE - tD;\n"
     "    top = __shfl_sync(kFullMask, end, c << logc);"),
    ("    __syncwarp();  // the buffer and the bytes are free for window j - NB\n"
     "  }\n}\n",
     "    __syncwarp();  // the buffer and the bytes are free for window j - NB\n"
     "    tr[4] += clock64() - tE;\n  }\n  if (lane == 0) {\n"
     "    for (int q = 0; q < 7; ++q) atomicAdd(&g_narrow_trace[q], tr[q]);\n"
     "    atomicAdd(&g_narrow_trace[7], (unsigned long long)(clock64() - tr0));\n"
     "    atomicAdd(&g_narrow_trace[8], 1ull);\n  }\n}\n"),
)
TRACE_ENTRY = """
extern "C" int narrow_walk_trace(unsigned long long* host, int reset) {
  if (reset) {
    const unsigned long long zero[9] = {};
    return static_cast<int>(
        cudaMemcpyToSymbol(g_narrow_trace, zero, sizeof zero));
  }
  return static_cast<int>(
      cudaMemcpyFromSymbol(host, g_narrow_trace, 9 * sizeof(*host)));
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
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"{source.stem}.trace.cu"
    path.write_text(text + TRACE_ENTRY)
    return path


def load_walks(path: Path) -> dict:
    """The three C entries of a library, with the package's argument
    types."""
    from convolutionalencdec_tpu_torch.kernels import _build
    lib = ctypes.CDLL(str(path))
    fns = {name: getattr(lib, name) for name in WALKS}
    for name, fn in fns.items():
        fn.argtypes = _build.SIGNATURES[name]
        fn.restype = ctypes.c_int
    return fns


def run(lib_path: str, source: str, ref_path: str, calls: int,
        ns: list[int] | None = None, timed: list[str] | None = None) -> int:
    """One build against the reference; prints its JSON line."""
    import numpy as np
    import torch
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import convolutionalencdec_tpu_torch as fec
    from convolutionalencdec_tpu_torch.kernels import acs, generic
    from convolutionalencdec_tpu_torch.kernels import tailbiting as ktb
    dev = torch.device("cuda", 0)
    fns = load_walks(Path(lib_path))
    refs = load_walks(Path(ref_path))
    stream = torch.cuda.current_stream(dev).cuda_stream
    rng = np.random.default_rng(2063)
    lines = {ns: rest for ns, *rest in cs.narrow_walk_lines(source)}
    multi_lines = {ns: rest for ns, *rest in cs.narrow_multi_lines(source)}
    result = {"lib": Path(lib_path).stem, "lines": lines,
              "multi_lines": multi_lines, "checked": {}, "multi_checked": {},
              "wrong_guesses": {}, "ms": {}, "ref_ms": {}, "generic_ms": {}}
    bad = []

    def rows(B, L, out, res):
        if res is None:
            res = torch.full((B, (L + 7) // 8 if out == "bytes" else L), 0xA5,
                             dtype=torch.uint8, device=dev)
        return res

    def launched(name, code, res):
        if code:
            raise RuntimeError(f"{name}: CUDA error {code}")
        return res

    def terminated(lib, spec, words, t_actual, L, out, res=None):
        B, T = words.shape[:2]
        res = rows(B, L, out, res)
        return launched(WALKS[0], lib[WALKS[0]](
            words.data_ptr(), res.data_ptr(), B, T, t_actual,
            spec.num_states, spec.S, L, int(out == "bytes"), stream), res)

    def masked(lib, spec, words, starts, live, L, out, res=None):
        B, T = words.shape[:2]
        res = rows(B, L, out, res)
        return launched(WALKS[1], lib[WALKS[1]](
            words.data_ptr(), starts.data_ptr(), res.data_ptr(), B, T,
            spec.num_states, spec.S, live, L, int(out == "bytes"), stream),
            res)

    def ragged(lib, spec, words, lens, L, out, res=None):
        B, T = words.shape[:2]
        res = rows(B, L, out, res)
        return launched(WALKS[2], lib[WALKS[2]](
            words.data_ptr(), lens.data_ptr(), res.data_ptr(), B, T,
            spec.num_states, spec.S, L, int(out == "bytes"), stream), res)

    def multi(lib, spec, words, starts, live, start, steps, out, res=None):
        B, T = words.shape[:2]
        NW = starts.shape[1]
        if res is None:
            res = torch.full((B, NW, (steps + 7) // 8 if out == "bytes"
                              else steps), 0xA5, dtype=torch.uint8,
                             device=dev)
        return launched(WALKS[3], lib[WALKS[3]](
            words.data_ptr(), starts.data_ptr(), res.data_ptr(), B, T,
            spec.num_states, spec.S, NW, live, start, steps,
            int(out == "bytes"), stream), res)

    def same(walk, *args, what):
        got, want = walk(fns, *args), walk(refs, *args)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            bad.append(what)
            if len(bad) == 1:
                d = (got != want).nonzero()[:8]
                print(f"[narrow-walk] {what}: differs at {d.tolist()}",
                      flush=True)
        return 1

    def noisy_words(spec, B, T):
        return cs.narrow_walk_words(fec, acs, spec, rng, dev, "noisy", B, T)

    def check(spec, words, what):
        """Both builds at every `narrow_walk_cases` on one batch."""
        B, T = words.shape[:2]
        starts = torch.from_numpy(rng.integers(0, spec.num_states, B).astype(
            np.int32)).to(dev)
        n = 0
        for mode, t, L, out in cs.narrow_walk_cases(spec.S, T):
            if mode == "terminated":
                n += same(terminated, spec, words, t, L, out,
                          what=f"{what} terminated T={T} t_actual={t} "
                          f"L={L} {out}")
            else:
                n += same(masked, spec, words, starts, t, L, out,
                          what=f"{what} masked T={T} live={t} L={L} {out}")
        if T >= spec.S:
            lens = torch.from_numpy(cs.narrow_ragged_lengths(
                rng, B, T, spec.S)).to(dev)
            full = T - spec.S
            for L in sorted({full, cs.cut_bits(full)}):
                for out in ("bits", "bytes"):
                    n += same(ragged, spec, words, lens, L, out,
                              what=f"{what} ragged T={T} L={L} {out}")
        return n

    diagnostic = result["lib"].startswith("diag_")
    for NS in () if diagnostic else sorted(ns or lines):
        G, WU = lines[NS]
        spec = cs.bfly_spec(fec, rng, NS, 4)
        n, wrong = 0, []
        batches = list(cs.narrow_walk_batches(fec, acs, spec, rng, dev, G))
        batches.append(("B=2048", noisy_words(spec, cs.MAIN_B,
                                              cs.MAIN_L + spec.S), False))
        for what, words, guessed in batches:
            T = words.shape[1]
            n += check(spec, words, f"NS={NS} {what}")
            if guessed:
                wrong.append(cs.narrow_walk_guesses_wrong(words, T, T, None,
                                                          G, WU, NS))
        result["checked"][NS], result["wrong_guesses"][NS] = n, wrong
        print(f"[narrow-walk] {result['lib']} NS={NS} (G {G}, warm-up {WU}): "
              f"{n} cases against the reference, "
              f"{' / '.join(map(str, wrong))} wrong guesses on garbage / "
              "catastrophic words", flush=True)
    for NS in () if diagnostic else sorted(
            x for x in multi_lines if ns is None or x in ns):
        spec = cs.bfly_spec(fec, rng, NS, 4)
        n = 0
        for what, words in cs.multi_walk_batches(fec, acs, spec, rng, dev,
                                                 multi_lines[NS][0]):
            B, T = words.shape[:2]
            for nw in sorted({1, 2, 8, NS} & set(range(1, NS + 1))):
                starts = torch.from_numpy(rng.integers(
                    0, NS, (B, nw)).astype(np.int32)).to(dev)
                for live in sorted({0, min(spec.S, T), max(T - 1, 0), T}):
                    for start, steps in cs.multi_windows(T):
                        for out in ("bits", "bytes"):
                            n += same(multi, spec, words, starts, live, start,
                                      steps, out,
                                      what=f"NS={NS} {what} multi T={T} "
                                      f"NW={nw} live={live} window=({start}"
                                      f", {steps}) {out}")
        result["multi_checked"][NS] = n
        print(f"[narrow-walk] {result['lib']} list walk NS={NS} (G "
              f"{multi_lines[NS][0]}, warm-up {multi_lines[NS][1]}): {n} "
              "cases against the reference", flush=True)
    if bad:
        result["differs"] = bad
        print(json.dumps(result))
        return 1

    # The timed inputs, two of each.
    spec = fec.NASA_K7
    B, L = cs.MAIN_B, cs.MAIN_L
    T = L + spec.S
    msgs = [torch.from_numpy(rng.integers(0, 2, (B, L), dtype=np.uint8)).to(
        dev) for _ in range(2)]
    segs = []
    for m in msgs:
        seg = fec.encode_bits(spec, m)[0]
        segs.append(torch.from_numpy(cs.corrupt(
            rng, seg.cpu().numpy(), cs.MAIN_NOISE, spec.n)).to(dev))
    gen = torch.Generator(device=dev).manual_seed(cs.MAIN_SEED + 1)
    soft = []
    for m in msgs:
        _, llr = cs.soft_channel(fec, spec, m, gen, spec.rate)
        q = fec.quantize_llrs(llr, qmax=cs.QMAX).reshape(B, T, spec.n)
        soft.append(acs.acs_forward_batch_soft(spec, q.to(torch.int8),
                                               cs.QMAX)[0])
    hard = [acs.acs_forward_batch(spec, s)[0] for s in segs]
    lens = [torch.from_numpy(rng.integers(spec.S + 1, T + 1, B).astype(
        np.int32)).to(dev) for _ in range(2)]
    pend = [cs.interior_buffer(acs, spec, s) for s in segs]
    lte = fec.LTE_TBCC_K7
    D = cs.DCI_PAYLOAD + 16
    tb, tb_list = [], []
    for _ in range(2):
        blocks = torch.from_numpy(rng.integers(
            0, 2, (cs.DCI_B, D), dtype=np.uint8)).to(dev)
        q, _ = cs.dci_channel(fec, lte, blocks, dev)
        wrap_in, list_in = cs.tb_kernel_inputs(fec, ktb, acs, lte, q)
        tb.append(wrap_in)
        tb_list.append(list_in)
    wide = {}
    for NS, code in ((128, fec.CodeSpec(K=8, g=TIMED_K8)),
                     (256, fec.K9_561_753)):
        wide[NS] = (code, [noisy_words(code, B, code.S + L) for _ in
                           range(2)])
    # (f)'s list walk at NS = 128 and 256: the forward's words of noisy
    # packets of its 144 steps, 8 random starts a channel.
    Tl = tb_list[0][0].shape[1]
    lists = {NS: (code, [(noisy_words(code, cs.DCI_B, Tl), torch.from_numpy(
        rng.integers(0, NS, (cs.DCI_B, cs.DCI_LIST)).astype(np.int32)).to(
            dev), Tl, tb_list[0][3], tb_list[0][4]) for _ in range(2)])
        for NS, (code, _) in wide.items()}
    small = fec.PRESETS[cs.SMALL_MAIN]
    Tk = L + small.S
    k_hard, k_soft = [], []
    for m in msgs:
        seg = fec.encode_bits(small, m)[0]
        seg = torch.from_numpy(cs.corrupt(rng, seg.cpu().numpy(),
                                          cs.MAIN_NOISE, small.n)).to(dev)
        k_hard.append(acs.acs_forward_batch(small, seg)[0])
        _, llr = cs.soft_channel(fec, small, m, gen, small.rate)
        q = fec.quantize_llrs(llr, qmax=cs.QMAX).reshape(B, Tk, small.n)
        k_soft.append(acs.acs_forward_batch_soft(small, q.to(torch.int8),
                                                 127)[0])
    lens_k = [torch.from_numpy(rng.integers(small.S + 1, Tk + 1, B).astype(
        np.int32)).to(dev) for _ in range(2)]
    starts_k = [torch.from_numpy(rng.integers(0, small.num_states, B).astype(
        np.int32)).to(dev) for _ in range(2)]
    one_word = {}
    for NS, g in ONE_WORD_CODES.items():
        code = fec.CodeSpec(K=NS.bit_length(), g=g)
        one_word[NS] = (code, [noisy_words(code, B, code.S + L)
                               for _ in range(2)])
    gspec = fec.CodeSpec(K=spec.K, g=(spec.g[0], spec.g[1] ^ 1))
    planes = [generic.acs_forward_batch_generic(gspec, s)[0] for s in segs]
    res = {"bytes": torch.empty((B, L // 8), dtype=torch.uint8, device=dev),
           "bits240": torch.empty((B, 240), dtype=torch.uint8, device=dev),
           "f": torch.empty((cs.DCI_B, tb[0][3]), dtype=torch.uint8,
                            device=dev),
           "f list": torch.empty((cs.DCI_B, cs.DCI_LIST, tb_list[0][4]),
                                 dtype=torch.uint8, device=dev),
           "bits k": torch.empty((B, Tk), dtype=torch.uint8, device=dev)}
    cases = {
        "(a) hard": lambda lib, d: terminated(lib, spec, hard[d], T, L,
                                              "bytes", res["bytes"]),
        "(a) soft": lambda lib, d: terminated(lib, spec, soft[d], T, L,
                                              "bytes", res["bytes"]),
        "(c)": lambda lib, d: ragged(lib, spec, soft[d], lens[d], L, "bytes",
                                     res["bytes"]),
        "288 steps": lambda lib, d: masked(lib, spec, pend[d][0], pend[d][1],
                                           288, 240, "bits", res["bits240"]),
        "(f)": lambda lib, d: masked(lib, lte, tb[d][0], tb[d][1], tb[d][2],
                                     tb[d][3], "bits", res["f"]),
        "(f) list": lambda lib, d: multi(lib, lte, *tb_list[d], "bits",
                                         res["f list"]),
        "(f) list NS=128": lambda lib, d: multi(
            lib, lists[128][0], *lists[128][1][d], "bits", res["f list"]),
        "(f) list NS=256": lambda lib, d: multi(
            lib, lists[256][0], *lists[256][1][d], "bits", res["f list"]),
        "NS=128": lambda lib, d: terminated(lib, wide[128][0], wide[128][1][d],
                                            T + 1, L, "bytes", res["bytes"]),
        "NS=256": lambda lib, d: terminated(lib, wide[256][0], wide[256][1][d],
                                            T + 2, L, "bytes", res["bytes"]),
        "(k) hard": lambda lib, d: terminated(lib, small, k_hard[d], Tk, L,
                                              "bytes", res["bytes"]),
        "(k) soft": lambda lib, d: terminated(lib, small, k_soft[d], Tk, L,
                                              "bytes", res["bytes"]),
        "(k) ragged": lambda lib, d: ragged(lib, small, k_hard[d], lens_k[d],
                                           L, "bytes", res["bytes"]),
        "(k) masked": lambda lib, d: masked(lib, small, k_hard[d],
                                            starts_k[d], Tk, Tk, "bits",
                                            res["bits k"]),
        "(k) masked live-9": lambda lib, d: masked(
            lib, small, k_hard[d], starts_k[d], Tk - 9, Tk, "bits",
            res["bits k"])}
    for NS, (code, words) in one_word.items():
        cases[f"(k) NS={NS}"] = (
            lambda lib, d, code=code, words=words: terminated(
                lib, code, words[d], code.S + L, L, "bytes", res["bytes"]))
    if timed is not None:
        cases = {key: cases[key] for key in timed}
    for key, fn in cases.items():
        for d in range(0 if diagnostic else 2):
            same(lambda lib, *_: fn(lib, d).clone(), what=f"timed {key}")
        if bad:
            break
        launch = {"var": lambda k: fn(fns, k % 2),
                  "ref": lambda k: fn(refs, k % 2)}
        names = ("var", "ref")
        if key == "(a) hard":
            launch["generic"] = lambda k: generic.traceback_batch_generic(
                gspec, planes[k % 2], T, L, "bytes")
            names += ("generic",)
        lib = ctypes.CDLL(lib_path)
        if hasattr(lib, "narrow_walk_trace"):
            buf = (ctypes.c_ulonglong * 9)()
            lib.narrow_walk_trace(buf, 1)
            fn(fns, 0)
            torch.cuda.synchronize()
            lib.narrow_walk_trace(buf, 0)
            warps = max(buf[8], 1)
            parts = {p: buf[i] / warps for i, p in enumerate(TRACE_PARTS)}
            parts.update(rounds=buf[5] / warps, rewalked=buf[6] / warps,
                         total=buf[7] / warps, warps=buf[8])
            result.setdefault("trace", {})[key] = parts
            print(f"[narrow-walk] {result['lib']} trace {key}: cycles a warp "
                  + ", ".join(f"{p} {v:.0f}" for p, v in parts.items()),
                  flush=True)
        ms = _torch_variants.in_turns(lambda name, k: launch[name](k), calls,
                                      SLEEP_CYCLES, names)
        result["ms"][key], result["ref_ms"][key] = ms["var"], ms["ref"]
        line = (f"[narrow-walk] {result['lib']} {key}: {ms['var']:.4f} ms, "
                f"reference {ms['ref']:.4f} ms")
        if "generic" in ms:
            result["generic_ms"][key] = ms["generic"]
            line += f", generic walk {ms['generic']:.4f} ms"
        print(line, flush=True)
    result["differs"] = bad
    print(json.dumps(result))
    return 1 if bad else 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ref", type=Path,
                    help="the reference source of the four C entries")
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=SOURCE.cu, a copy of csrc/traceback_k1.cu")
    ap.add_argument("--lines", action="append", default=[],
                    help="NAME=[m]NS:G:WU,..., dispatch lines rewritten")
    ap.add_argument("--calls", type=int, default=15)
    ap.add_argument("--out", type=Path, default=LIBS)
    ap.add_argument("--trace", action="store_true",
                    help="each build with the walk's clock64 stamps")
    ap.add_argument("--ns", type=int, nargs="*",
                    help="the NS checked (default: every dispatch line)")
    ap.add_argument("--timed", nargs="*",
                    help="the timed cases kept, e.g. '(k) hard'")
    ap.add_argument("--no-time", action="store_true",
                    help="the builds and the checks only")
    ap.add_argument("--run", help=argparse.SUPPRESS)
    ap.add_argument("--source", help=argparse.SUPPRESS)
    ap.add_argument("--ref-lib", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.run:
        return run(args.run, args.source, args.ref_lib, args.calls, args.ns,
                   [] if args.no_time else args.timed)
    if args.ref is None:
        raise SystemExit("--ref PATH.cu is required")
    builds = {"change": SOURCE}
    for item in args.variant:
        name, _, src = item.partition("=")
        builds[name] = Path(src).resolve()
    for item in args.lines:
        name, _, spec = item.partition("=")
        builds[name] = with_lines(name, spec, args.out)
    if args.trace:
        builds = {name: traced(src, args.out) for name, src in builds.items()}
    builds["reference"] = args.ref.resolve()
    libs, failed = _torch_variants.build_all(builds, LIBS, args.out,
                                             "narrow-walk")
    for line in subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.splitlines():
        print(f"[narrow-walk] card: {line.strip()}")
    if "reference" not in libs:
        return 1
    status = 1 if failed else 0
    for name, lib in libs.items():
        if name == "reference":
            continue
        cmd = [sys.executable, __file__, "--run", str(lib), "--source",
               str(builds[name]), "--ref-lib", str(libs["reference"]),
               "--calls", str(args.calls)]
        if args.ns:
            cmd += ["--ns", *map(str, args.ns)]
        if args.timed:
            cmd += ["--timed", *args.timed]
        if args.no_time:
            cmd.append("--no-time")
        proc = subprocess.run(cmd)
        if proc.returncode:
            print(f"[narrow-walk] {name}: exit {proc.returncode}",
                  file=sys.stderr)
            status = 1
    return status


if __name__ == "__main__":
    sys.exit(main())
