#!/usr/bin/env python3
"""Build-time variants of the narrow forward (`acs_soft_k1_forward` and,
`--hard`, `acs_k1_forward` at NS = 64, 128 and 256: one template in
csrc/acs_soft_k1.cu) against a reference build of the same C entry, on one
GPU.

    python3 scripts/torch_soft_forward.py [--hard] --ref PARENT.cu \\
        [--variant NAME=SOURCE.cu ...] [--calls 15] [--out DIR]
    python3 scripts/torch_soft_forward.py --decodes TREE

Builds csrc/acs_soft_k1.cu (as "change"), each variant (a hand-edited copy
of it, `NAME=SOURCE.cu`) and the reference (`--ref`, e.g. the parent
tree's acs_soft_k1.cu: get it with `git show
HEAD:convolutionalencdec_tpu_torch/csrc/acs_soft_k1.cu >
_checkout/parent_acs_soft_k1.cu`); one nvcc each, all at once, with
`-Xptxas -v` (the logs and each build's SASS in `--out`; relative paths
are read from the caller's directory).  For each build it prints the
instructions a step takes in the SASS of the kernels of the main paths'
lines: in an unrolled block, the distance between the first ballot (VOTE)
of its first step and that of its last over the steps between; in a loop
of a few steps an iteration, the loop's length over its steps.  Each build then runs in its own process (a kernel fault
poisons the CUDA context): it is held bit for bit against the reference,
decision words and final metrics, at every line (NS = 64, 128, 256 and
n = 1 ... 8) on chip_smoke.py's cases of the narrow soft forward (B = 37
at `SOFT_FORWARD_T`, under every `SOFT_FORWARD_CONDITIONS`; B = 1) and
on the timed inputs, and timed in turns with the reference (CUDA events
after a sleep that queues the launch, median of `--calls`, two inputs
alternately; the launch alone, its outputs allocated beforehand):
  (a) soft    NASA_K7, B = 2048, T = 2054: bench.py's messages over AWGN at
              3 dB, quantized to 7 (the 8-bit route: qclip 7);
  (d)         NASA_K7 punctured to rate 3/4 (PUNCTURE_3_4), the same size:
              the depunctured LLRs, erasures at the punctured places;
  (f)         LTE_TBCC_K7, 16384 DCI blocks of 56 bits at 2 dB: the soft wrap
              decode's forward over 192 steps from the uniform start (the
              -128 route, qclip 127);
  (a) B=...   (a) soft's first rows, or two inputs' rows, at `SWEEP_B`.
Prints one JSON line per build and the card's name and power limit.  Exits
non-zero if a build fails or differs.

`--hard` does the same for the hard entry `acs_k1_forward` (the reference
e.g. the parent tree's csrc/acs_k1.cu: `git show
HEAD:convolutionalencdec_tpu_torch/csrc/acs_k1.cu >
_checkout/parent_acs_k1.cu`): the SASS a step of the hard kernels, then
each build bit for bit against the reference, words and final metrics, at
every line and n = 1 ... 8 on chip_smoke.py's cases of the hard forward
(B = 37 at `HARD_FORWARD_T`, every n at 2054 steps, B = 1; uniform
segments of n bits and of 8 bits, from the default start and from carried
metrics) and on the timed inputs, timed in turns with the reference:
  (a) hard    NASA_K7, B = 2048, T = 2054: bench.py's messages, 3% of the
              segments hit (the hard decode's and the hard ragged decode's
              forward);
  NS=128      a K = 8 code, and NS=256 K9_561_753, at (a)'s size;
  n=6         the rate-1/6 K = 7 code of main path (m) at (a)'s size (two
              packed registers a step);
  (a) B=...   (a) hard's first rows, or two inputs' rows, at `SWEEP_B`.

`--decodes TREE` times the decodes that run the kernel, with the package
of TREE (this tree, or e.g. the parent unpacked by `git archive HEAD | tar
-x -C _checkout/parent`) and this tree's chip_smoke.py: its phases 4-6
and 11 (each decode held to its plain route) and its timing phases 9 and
11 (median of 20 calls, CUDA events); prints the rows of (a)-(d) and (f)
and the kernels they run.  Run one process a tree in the order parent,
change, change, parent in one call.
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
from _torch_variants import BRANCH, sass_functions  # noqa: E402

SOURCE = ROOT / "convolutionalencdec_tpu_torch" / "csrc" / "acs_soft_k1.cu"
LIBS = ROOT / "convolutionalencdec_tpu_torch" / "build" / "soft_forward"
ENTRY = "acs_soft_k1_forward"
HARD_ENTRY = "acs_k1_forward"
# The kernels whose SASS is counted: the template's hard (Lb1E) or soft
# (Lb0E) instantiations, or a reference's kernel of one entry.
KERNEL = re.compile(r"acs_(soft_)?k1_forward_kernel")
# The hard timed code at NS = 128 (no common factor), as the narrow walk's.
TIMED_K8 = (0o247, 0o371)


def wanted(fn: str, hard: bool) -> bool:
    """Whether SASS function `fn` is a kernel of the hard (or soft) entry."""
    m = KERNEL.search(fn)
    if not m:
        return False
    if "ELb1E" in fn or "ELb0E" in fn:
        return ("ELb1E" in fn) == hard
    return (m.group(1) is None) == hard
SLEEP_CYCLES = 10_000_000
#: Batch sizes of (a) soft's sweep: one warp an SM, half of (a), twice (a).
SWEEP_B = (132, 1024, 4096)


def per_step(body: list, bpl: int) -> dict:
    """What a step of one kernel (NS = 64 bpl) takes in its SASS:
    instructions in all; `loop_step`, for each innermost loop (backward
    branch) that holds a step's ballots (VOTE, one a destination: 2 bpl a
    step), its length over the steps an iteration; and `block_step`, where
    32 steps' ballots lie outside those loops (an unrolled block), the
    distance from the first ballot of its first step to that of its last,
    over 31."""
    ins = [(a, t) for a, t in body if a != "label"]
    labels, pos = {}, 0
    for a, t in body:
        if a == "label":
            labels[t] = pos
        else:
            pos += 1
    index = {a: i for i, (a, _) in enumerate(ins)}
    votes = [i for i, (_, t) in enumerate(ins) if "VOTE" in t]
    per = 2 * bpl  # ballots a step
    loops = []
    for i, (_, t) in enumerate(ins):
        m = BRANCH.search(t)
        if not m:
            continue
        target = m.group(1)
        j = labels.get(target) if target.startswith(".L") else index.get(
            int(target, 16))
        if j is None or j > i:
            continue
        inside = sum(j <= k <= i for k in votes)
        if 0 < inside < 32 * per:
            loops.append((j, i, inside // per))  # a few steps an iteration
    inner = [(j, i, n) for j, i, n in loops
             if not any((j, i) != (a, b) and j <= a and b <= i
                        for a, b, _ in loops)]
    outside = [k for k in votes if not any(j <= k <= i for j, i, _ in inner)]
    out = {"instructions": len(ins), "ballots": len(votes),
           "loop_step": [round((i - j + 1) / max(n, 1), 1)
                         for j, i, n in inner]}
    if len(outside) >= 32 * per:
        out["block_step"] = round((outside[31 * per] - outside[0]) / 31, 1)
    return out


def report(out: Path, sass: dict, hard: bool = False):
    """A build's report for _torch_variants.build_all: the registers of
    each kernel of the entry, its SASS kept in `out`, and the instructions
    a step of each takes."""
    def each(name: str, lib: Path, output: str) -> None:
        lines = output.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry function" in line and wanted(line, hard):
                regs = next((x for x in lines[i + 1:i + 4]
                             if "registers" in x), "").strip()
                fn = line.split("'")[1] if "'" in line else line
                print(f"[soft-forward] {name} {fn}: {regs}")
        from convolutionalencdec_tpu_torch.kernels import _build
        cuobjdump = Path(_build.find_nvcc()).parent / "cuobjdump"
        text = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                              capture_output=True, text=True).stdout
        (out / f"{name}.sass").write_text(text)
        sass[name] = {}
        for fn, body in sass_functions(text).items():
            if not wanted(fn, hard):
                continue
            stats = per_step(body, int(re.search(r"kernelILi(\d+)E",
                                                 fn).group(1)))
            sass[name][fn] = stats
            print(f"[soft-forward] {name} {fn}: {stats}")
    return each


def load(path: Path, entry: str = ENTRY):
    from convolutionalencdec_tpu_torch.kernels import _build
    lib = ctypes.CDLL(str(path))
    fn = getattr(lib, entry)
    fn.argtypes = _build.SIGNATURES[entry]
    fn.restype = ctypes.c_int
    return fn


def run_hard(lib_path: str, ref_path: str, calls: int) -> int:
    """One build's hard entry against the reference: the checks, then the
    times in turns; prints its JSON line."""
    import numpy as np
    import torch
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import convolutionalencdec_tpu_torch as fec
    from convolutionalencdec_tpu_torch.kernels import acs
    from convolutionalencdec_tpu_torch.ops.viterbi import init_metric_value
    dev = torch.device("cuda", 0)
    fns = {"var": load(Path(lib_path), HARD_ENTRY),
           "ref": load(Path(ref_path), HARD_ENTRY)}
    stream = torch.cuda.current_stream(dev).cuda_stream
    rng = np.random.default_rng(2079)

    def launcher(spec, seg, init):
        """fn -> (words, final metrics) of seg: the table and the outputs
        allocated here, so that a timed call is the launch alone."""
        B, T = seg.shape
        NS = spec.num_states
        cb = acs._butterfly_table(spec, dev)
        words = torch.full((B, T, NS // 32), 0x5A5A5A5A, dtype=torch.int32,
                           device=dev)
        fm = torch.full((B, NS), -7, dtype=torch.int32, device=dev)

        def launch(fn):
            code = fn(seg.data_ptr(), cb.data_ptr(),
                      None if init is None else init.data_ptr(),
                      words.data_ptr(), fm.data_ptr(), B, T, NS, spec.n,
                      init_metric_value(spec), stream)
            if code:
                raise RuntimeError(f"launch failed: CUDA error {code}")
            return words, fm
        return launch

    def same(spec, seg, init):
        got = [x.clone() for x in launcher(spec, seg, init)(fns["var"])]
        want = launcher(spec, seg, init)(fns["ref"])
        torch.cuda.synchronize()
        return all(torch.equal(a, b) for a, b in zip(got, want))

    bad, cases = [], 0
    for NS, _ in cs.soft_forward_lines():
        for n in range(1, 9):
            spec = cs.bfly_spec(fec, rng, NS, n)
            for B, T in ([(cs.NARROW_B, T) for T in cs.HARD_FORWARD_T]
                         + [(1, 33)]):
                for top in (1 << n, 256):  # n bits, and bits above n set
                    seg = torch.from_numpy(rng.integers(
                        0, top, (B, T)).astype(np.uint8)).to(dev)
                    init = torch.from_numpy(rng.integers(
                        0, 6000, (B, NS)).astype(np.int32)).to(dev)
                    for given in (None, init):
                        cases += 1
                        if not same(spec, seg, given):
                            bad.append(f"NS={NS} n={n} B={B} T={T} top={top}"
                                       f" init={given is not None}")
                            print(f"[hard-forward] differs: {bad[-1]}",
                                  flush=True)
    print(f"[hard-forward] {Path(lib_path).stem}: {cases} cases against "
          f"the reference, {len(bad)} differ", flush=True)

    # The timed inputs, two of each.
    B, L = cs.MAIN_B, cs.MAIN_L
    codes = {"(a) hard": fec.NASA_K7,
             "NS=128": fec.CodeSpec(K=8, g=TIMED_K8),
             "NS=256": fec.K9_561_753, "n=6": fec.CodeSpec(**cs.SP_MAIN)}
    timed = {}
    for key, spec in codes.items():
        timed[key] = []
        for _ in range(2):
            msgs = rng.integers(0, 2, (B, L), dtype=np.uint8)
            seg = cs.corrupt(rng, cs.encode_reference_np(spec, msgs),
                             cs.MAIN_NOISE, spec.n)
            timed[key].append((spec, torch.from_numpy(seg).to(dev), None))
    a0, a1 = (x[1] for x in timed["(a) hard"])
    for B_sweep in SWEEP_B:
        pair = ((a0, a1) if B_sweep <= B else
                (torch.cat([a0, a1]), torch.cat([a1, a0])))
        timed[f"(a) B={B_sweep}"] = [
            (fec.NASA_K7, x[:B_sweep].contiguous(), None) for x in pair]
    result = {"lib": Path(lib_path).stem, "cases": cases, "ms": {},
              "ref_ms": {}}
    for key, inputs in timed.items():
        for args in inputs:
            if not same(*args):
                bad.append(f"timed input {key}")
        launches = [launcher(*args) for args in inputs]
        ms = _torch_variants.in_turns(
            lambda name, k: launches[k % 2](fns[name]), calls, SLEEP_CYCLES)
        result["ms"][key], result["ref_ms"][key] = ms["var"], ms["ref"]
        x = inputs[0][1]
        print(f"[hard-forward] {result['lib']} {key:9s} B={x.shape[0]} "
              f"T={x.shape[1]} n={inputs[0][0].n}: {ms['var']:.4f} ms, "
              f"reference {ms['ref']:.4f} ms", flush=True)
    result["differs"] = bad
    print(json.dumps(result))
    return 1 if bad else 0


def run(lib_path: str, ref_path: str, calls: int) -> int:
    """One build against the reference: the checks, then the times in
    turns; prints its JSON line."""
    import numpy as np
    import torch
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import convolutionalencdec_tpu_torch as fec
    from convolutionalencdec_tpu_torch.kernels import acs
    from convolutionalencdec_tpu_torch.kernels import tailbiting as ktb
    from convolutionalencdec_tpu_torch.ops.viterbi import init_metric_value
    dev = torch.device("cuda", 0)
    fns = {"var": load(Path(lib_path)), "ref": load(Path(ref_path))}
    stream = torch.cuda.current_stream(dev).cuda_stream
    rng = np.random.default_rng(2069)

    def launcher(spec, q, qclip, floor, init):
        """fn -> (words, final metrics) of q: the table and the outputs
        allocated here, so that a timed call is the launch alone."""
        B, T, n = q.shape
        NS = spec.num_states
        cb = acs._butterfly_table(spec, dev)
        words = torch.full((B, T, NS // 32), 0x5A5A5A5A, dtype=torch.int32,
                           device=dev)
        fm = torch.full((B, NS), -7, dtype=torch.int32, device=dev)

        def launch(fn):
            code = fn(q.data_ptr(), cb.data_ptr(),
                      None if init is None else init.data_ptr(),
                      words.data_ptr(), fm.data_ptr(), B, T, NS, n,
                      acs._qlo(qclip, floor), qclip, init_metric_value(spec),
                      stream)
            if code:
                raise RuntimeError(f"launch failed: CUDA error {code}")
            return words, fm
        return launch

    def same(spec, q, qclip, floor, init):
        got = [x.clone() for x in launcher(spec, q, qclip, floor, init)(
            fns["var"])]
        want = launcher(spec, q, qclip, floor, init)(fns["ref"])
        torch.cuda.synchronize()
        return all(torch.equal(a, b) for a, b in zip(got, want))

    bad, cases = [], 0
    for NS, _ in cs.soft_forward_lines():
        for n in range(1, 9):
            spec = cs.bfly_spec(fec, rng, NS, n)
            for B, T in ([(cs.NARROW_B, T) for T in cs.SOFT_FORWARD_T]
                         + [(1, 33)]):
                draw = rng.integers(-128, 128, (B, T, n))
                draw.reshape(-1)[::13] = -128
                q = torch.from_numpy(draw.astype(np.int8)).to(dev)
                for qclip, floor, given in cs.SOFT_FORWARD_CONDITIONS:
                    init = None
                    if given:
                        init = torch.from_numpy(rng.integers(
                            0, 6000, (B, NS)).astype(np.int32)).to(dev)
                    cases += 1
                    if not same(spec, q, qclip, floor, init):
                        bad.append(f"NS={NS} n={n} B={B} T={T} qclip={qclip}"
                                   f" floor={floor} init={given}")
                        print(f"[soft-forward] differs: {bad[-1]}",
                              flush=True)
    print(f"[soft-forward] {Path(lib_path).stem}: {cases} cases against "
          f"the reference, {len(bad)} differ", flush=True)

    # The timed inputs, two of each.
    spec = fec.NASA_K7
    B, L = cs.MAIN_B, cs.MAIN_L
    T = L + spec.S
    gen = torch.Generator(device=dev).manual_seed(cs.MAIN_SEED)
    timed = {"(a) soft": [], "(d)": [], "(f)": []}
    for _ in range(2):
        msgs = torch.from_numpy(rng.integers(0, 2, (B, L), dtype=np.uint8)).to(
            dev)
        _, llr = cs.soft_channel(fec, spec, msgs, gen, spec.rate)
        q = fec.quantize_llrs(llr, qmax=cs.QMAX).reshape(B, T, spec.n)
        timed["(a) soft"].append((spec, q.to(torch.int8), cs.QMAX, True,
                                  None))
        pattern = fec.PUNCTURE_3_4
        rate = fec.punctured_rate(spec, pattern)
        seg, _ = fec.encode_bits(spec, msgs)
        sent = fec.puncture_bits(fec.segments_to_bits(seg, spec.n), pattern,
                                 T)
        rx = fec.awgn(fec.bpsk_modulate(sent), cs.EBN0_DB, rate,
                      generator=gen)
        qp = fec.quantize_llrs(fec.bpsk_llr(rx, cs.EBN0_DB, rate),
                               qmax=cs.QMAX)
        full = fec.depuncture_llrs(qp.to(torch.int8), pattern, T)
        timed["(d)"].append((spec, full.reshape(B, T, spec.n).to(torch.int8)
                             .contiguous(), cs.QMAX, True, None))
        lte = fec.LTE_TBCC_K7
        blocks = torch.from_numpy(rng.integers(
            0, 2, (cs.DCI_B, cs.DCI_PAYLOAD + 16), dtype=np.uint8)).to(dev)
        qd, _ = cs.dci_channel(fec, lte, blocks, dev)
        ext, qclip, zeros, floor = cs.tb_forward_inputs(fec, ktb, lte, qd)
        timed["(f)"].append((lte, ext.contiguous(), qclip, floor, zeros))
    # (a) soft at other batch sizes: where the time goes as warps fill the
    # SMs (132 channels: one warp an SM).
    a0, a1 = (x[1] for x in timed["(a) soft"])
    for B_sweep in SWEEP_B:
        pair = ((a0, a1) if B_sweep <= B else
                (torch.cat([a0, a1]), torch.cat([a1, a0])))
        timed[f"(a) B={B_sweep}"] = [
            (spec, x[:B_sweep].contiguous(), cs.QMAX, True, None)
            for x in pair]
    result = {"lib": Path(lib_path).stem, "cases": cases, "ms": {},
              "ref_ms": {}}
    for key, inputs in timed.items():
        for args in inputs:
            if not same(*args):
                bad.append(f"timed input {key}")
        launches = [launcher(*args) for args in inputs]
        ms = _torch_variants.in_turns(
            lambda name, k: launches[k % 2](fns[name]), calls, SLEEP_CYCLES)
        result["ms"][key], result["ref_ms"][key] = ms["var"], ms["ref"]
        x = inputs[0][1]
        print(f"[soft-forward] {result['lib']} {key:9s} B={x.shape[0]} "
              f"T={x.shape[1]} n={x.shape[2]}: {ms['var']:.4f} ms, reference "
              f"{ms['ref']:.4f} ms", flush=True)
    result["differs"] = bad
    print(json.dumps(result))
    return 1 if bad else 0


#: The timed rows `--decodes` prints: chip_smoke.py's keys.
DECODE_ROWS = ("acs_soft_k1_forward", "acs_soft_k1_forward (f)",
               "traceback_k1_ragged", "traceback_k1_multi", "decode",
               "soft_decode", "soft ragged decode", "hard ragged decode",
               "punctured soft decode", "tailbiting crc soft",
               "tailbiting rate-matched", "tailbiting soft bytes",
               "block stream soft")


def decodes(root: Path) -> int:
    """chip_smoke.py's main paths (a)-(d) and (f) and their times on the
    package of `root`."""
    import statistics
    import torch
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    sys.path.insert(0, str(root.resolve()))
    import convolutionalencdec_tpu_torch as fec
    print(f"[soft-forward] package {Path(fec.__file__).parent}")
    from convolutionalencdec_tpu_torch.kernels import _build, acs
    dev = torch.device("cuda", 0)
    card = cs.phase_environment(_build)
    cs.phase_build(_build)
    err = dict.fromkeys(cs.KERNELS, 0)
    msgs, seg, _, _ = cs.phase_main(fec, acs, dev, err)
    q, _, _ = cs.phase_soft(fec, acs, dev, err, msgs)
    rp_in, _, _ = cs.phase_ragged_punctured(fec, acs, dev, err)
    tb_in, _, _, _ = cs.phase_tailbiting(fec, acs, dev, err)
    runs = cs.phase_times(fec, acs, seg, q, rp_in)
    runs.update(cs.tailbiting_times(fec, acs, tb_in))
    ms = {key: statistics.median(runs[key]) for key in DECODE_ROWS}
    for key, t in ms.items():
        print(f"[soft-forward] {key:24s} median {t:.4f} ms, min "
              f"{min(runs[key]):.4f} ms")
    print(json.dumps({"root": str(root), "ms": ms}))
    print(card)
    bad = [k for k, v in err.items() if v]
    if bad:
        print(f"torch_soft_forward: kernels differ from their plain "
              f"versions: {bad}", file=sys.stderr)
        return 1
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ref", type=Path,
                    help="the reference source of the C entry")
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=SOURCE.cu, a copy of csrc/acs_soft_k1.cu")
    ap.add_argument("--calls", type=int, default=15)
    ap.add_argument("--out", type=Path, default=LIBS)
    ap.add_argument("--decodes", type=Path,
                    help="time the decodes with the package of this tree")
    ap.add_argument("--hard", action="store_true",
                    help="the hard entry acs_k1_forward")
    ap.add_argument("--run", help=argparse.SUPPRESS)
    ap.add_argument("--ref-lib", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.run:
        return (run_hard if args.hard else run)(args.run, args.ref_lib,
                                                args.calls)
    import torch
    if not torch.cuda.is_available():
        print("torch_soft_forward: no CUDA device", file=sys.stderr)
        return 1
    if args.decodes:
        return decodes(args.decodes)
    if args.ref is None:
        raise SystemExit("--ref PATH.cu is required")
    builds = {"change": SOURCE}
    for item in args.variant:
        name, _, src = item.partition("=")
        builds[name] = Path(src).resolve()
    builds["reference"] = args.ref.resolve()
    out = args.out.resolve()
    sass = {}
    libs, failed = _torch_variants.build_all(builds, LIBS, out,
                                             "soft-forward",
                                             report(out, sass, args.hard))
    print(json.dumps({"sass": sass}))
    for line in subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.splitlines():
        print(f"[soft-forward] card: {line.strip()}")
    if "reference" not in libs:
        return 1
    ref_lib = libs.pop("reference")
    status = 1 if failed else 0
    for name, lib in libs.items():
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--run", str(lib),
             "--ref-lib", str(ref_lib), "--calls", str(args.calls)]
            + ["--hard"] * args.hard, cwd=ROOT)
        if proc.returncode:
            print(f"[soft-forward] {name}: exit {proc.returncode}",
                  file=sys.stderr)
            status = 1
    return status


if __name__ == "__main__":
    sys.exit(main())
