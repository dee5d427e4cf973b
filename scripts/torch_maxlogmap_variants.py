#!/usr/bin/env python3
"""Build-time variants of the max-log-MAP kernel (`maxlogmap_k1`,
csrc/maxlogmap_k1.cu) against a reference build of the same C entry, on
one GPU.

    python3 scripts/torch_maxlogmap_variants.py --ref PARENT.cu \\
        [--variant NAME=SOURCE.cu ...] [--calls 15] [--no-time] [--out DIR]

Builds csrc/maxlogmap_k1.cu (as "change"), each variant (a hand-edited
copy of it, `NAME=SOURCE.cu`) and the reference (`--ref`, e.g. the parent
tree's maxlogmap_k1.cu: get it with `git show
HEAD:convolutionalencdec_tpu_torch/csrc/maxlogmap_k1.cu >
_checkout/parent_maxlogmap_k1.cu`); one nvcc each, all at once, with
`-Xptxas -v` (the logs and each build's SASS in `--out`; relative paths
are read from the caller's directory).  For each build it prints, for the
kernels of NS = 64 (the template's second argument: n <= 4 or 5..8, or,
in the parent's, n = 1, 2, 3), the instructions a step takes in each pass
(forward, replay, beta with the emit) in the SASS (`passes`): each
innermost loop's instructions and shuffles (the parent's loops are a pass
each, a few steps an iteration), and each run of unrolled steps of K4's
exchange with its instructions a step.

Each build then runs in its own process (a kernel fault poisons the CUDA
context): it is held bit for bit against the reference (which equals the
plain version: chip_smoke.py holds it so) at NS = 64, 128 and 256, n = 1
... 8, on chip_smoke.py's cases of the max-log-MAP kernel
(`map_edge_cases`: T = 1, S + 1, 31, 32, 33, 63, 64, 65, 203, B = 1, 5
and 37, LLRs at +-7, over the whole int8 range with -128, and at +-127 and
-128 with 20% erasures, terminated and not) and on the timed inputs.  Then
(unless `--no-time`) it is timed in turns with the reference (CUDA events
after a sleep that queues the launch, median of `--calls`, two inputs
alternately; the launch alone, its scratch and output allocated
beforehand):
  (h)         NASA_K7, B = 2048, T = 2054: bench.py's messages over AWGN at
              3 dB, quantized to 7 (the soft main path's LLRs), terminated;
  (h) B=...   (h)'s first rows, or two inputs' rows, at `SWEEP_B`;
  NS=128      a K = 8 code, and NS=256 K9_561_753, at (h)'s size and
              channel;
  n=6         the rate-1/6 K = 7 code of the single-pass path (m) at (h)'s
              size: the n = 5-8 kernels.
Prints one JSON line per build and the card's name and power limit.  Exits
non-zero if a build fails or differs.
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

SOURCE = ROOT / "convolutionalencdec_tpu_torch" / "csrc" / "maxlogmap_k1.cu"
LIBS = ROOT / "convolutionalencdec_tpu_torch" / "build" / "maxlogmap"
ENTRY = "maxlogmap_k1"
KERNEL = "maxlogmap_k1_kernel"
SLEEP_CYCLES = 10_000_000
#: Batch sizes of (h)'s sweep: one warp an SM, half of (h), twice (h).
SWEEP_B = (132, 1024, 4096)
#: The timed code at NS = 128 (scripts/torch_narrow_walk.py's).
TIMED_K8 = (0o247, 0o371)


def passes(body: list, bpl: int) -> dict:
    """What a step of one kernel (NS = 64 bpl) takes in its SASS, in the
    order of the code: `loops`, each innermost loop (backward branch) that
    holds shuffles, with its instructions, shuffles, warp reductions
    (REDUX), shared stores and loads (the parent's are a pass each, a few
    steps an iteration, so per step is over its steps: its shuffles over
    4 bpl + 1); `runs`, each run of 8 to 32 consecutive steps of K4's
    exchange (2 bpl shuffles a step), a step counted as beta's where it
    holds warp reductions (the emit), else the forward's or the replay's,
    with the distance from the first shuffle of its first step to that of
    its last over the steps between, and its reductions, shared stores and
    loads a step."""
    ins = [t for a, t in body if a != "label"]
    labels, pos = {}, 0
    for a, t in body:
        if a == "label":
            labels[t] = pos
        else:
            pos += 1
    index = {a: i for i, (a, t) in enumerate(
        (a, t) for a, t in body if a != "label")}

    def op(t):
        words = t.split()
        return (words[1] if words[0].startswith("@") else words[0]) \
            if words else ""

    def count(lo, hi, name):
        return sum(name in op(t) for t in ins[lo:hi + 1])

    loops = []
    for i, t in enumerate(ins):
        m = BRANCH.search(t)
        if not m:
            continue
        target = m.group(1)
        j = labels.get(target) if target.startswith(".L") else index.get(
            int(target, 16))
        if j is not None and j <= i and count(j, i, "SHFL"):
            loops.append((j, i))
    inner = [(j, i) for j, i in loops
             if not any((j, i) != (a, b) and j <= a and b <= i
                        for a, b in loops)]
    out = {"loops": [{"at": j, "instructions": i - j + 1,
                      "shfl": count(j, i, "SHFL"),
                      "redux": count(j, i, "REDUX"),
                      "sts": count(j, i, "STS"), "lds": count(j, i, "LDS")}
                     for j, i in inner], "runs": []}
    per = 2 * bpl
    shfl = [k for k, t in enumerate(ins) if "SHFL" in op(t)]
    firsts = shfl[::per]
    kinds = [("beta" if count(a, b - 1, "REDUX") else "forward/replay")
             for a, b in zip(firsts, firsts[1:] + [len(ins)])]
    k = 0
    while k < len(firsts):
        e = k
        while e + 1 < len(firsts) and kinds[e + 1] == kinds[k] and \
                e + 1 - k < 32:
            e += 1
        if e - k + 1 >= 8:
            lo, hi = firsts[k], firsts[e]
            steps = e - k
            out["runs"].append({
                "at": lo, "kind": kinds[k], "steps": steps + 1,
                "per_step": round((hi - lo) / steps, 1),
                "redux": round(count(lo, hi - 1, "REDUX") / steps, 2),
                "sts": round(count(lo, hi - 1, "STS") / steps, 2),
                "lds": round(count(lo, hi - 1, "LDS") / steps, 2)})
        k = e + 1
    return out


def report(out: Path, sass: dict):
    """A build's report for _torch_variants.build_all: the registers of
    each kernel, its SASS kept in `out`, and each pass's instructions a
    step of the NS = 64 kernels."""
    def each(name: str, lib: Path, output: str) -> None:
        lines = output.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry function" in line and KERNEL in line:
                regs = next((x for x in lines[i + 1:i + 4]
                             if "registers" in x), "").strip()
                fn = line.split("'")[1] if "'" in line else line
                print(f"[maxlogmap] {name} {fn}: {regs}")
        from convolutionalencdec_tpu_torch.kernels import _build
        cuobjdump = Path(_build.find_nvcc()).parent / "cuobjdump"
        text = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                              capture_output=True, text=True).stdout
        (out / f"{name}.sass").write_text(text)
        sass[name] = {}
        for fn, body in sass_functions(text).items():
            m = re.search(r"kernelI((?:Li\d+E)+)E", fn)
            if KERNEL not in fn or m is None:
                continue
            # The parent's template is <BPL, n>, the change's <BPL, NP,
            # EMIT>: NS = 64, n = 1, 2, 3 or NP = 1, 2.
            targs = [int(x) for x in re.findall(r"Li(\d+)E", m.group(1))]
            if targs[0] != 1 or (len(targs) == 2 and targs[1] > 3):
                continue
            stats = passes(body, 1)
            sass[name][fn] = stats
            print(f"[maxlogmap] {name} {fn}:")
            for kind in ("loops", "runs"):
                for p in stats[kind]:
                    print(f"[maxlogmap]   {kind[:-1]} {p}")
    return each


def load(path: Path):
    from convolutionalencdec_tpu_torch.kernels import _build
    lib = ctypes.CDLL(str(path))
    fn = getattr(lib, ENTRY)
    fn.argtypes = _build.SIGNATURES[ENTRY]
    fn.restype = ctypes.c_int
    return fn


def run(lib_path: str, ref_path: str, calls: int, timed: bool) -> int:
    """One build against the reference: the checks, then the times in
    turns; prints its JSON line."""
    import numpy as np
    import torch
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import convolutionalencdec_tpu_torch as fec
    from convolutionalencdec_tpu_torch.kernels import acs
    from convolutionalencdec_tpu_torch.kernels import maxlogmap as km
    dev = torch.device("cuda", 0)
    fns = {"var": load(Path(lib_path)), "ref": load(Path(ref_path))}
    stream = torch.cuda.current_stream(dev).cuda_stream
    rng = np.random.default_rng(2081)

    def launcher(spec, q, terminated=True):
        """fn -> the LLRs of q: the table, scratch and output allocated
        here, so that a timed call is the launch alone."""
        B, T, n = q.shape
        NS = spec.num_states
        cb = acs._butterfly_table(spec, dev)
        ckpt = torch.empty((B, -(-T // km.CHUNK), NS), dtype=torch.int32,
                           device=dev)
        out = torch.full((B, T), 0x5A5A5A5A, dtype=torch.int32, device=dev)

        def launch(fn):
            code = fn(q.data_ptr(), cb.data_ptr(), ckpt.data_ptr(),
                      out.data_ptr(), B, T, NS, n, spec.starting_state,
                      int(terminated), stream)
            if code:
                raise RuntimeError(f"launch failed: CUDA error {code}")
            return out
        return launch

    def same(spec, q, terminated=True):
        got = launcher(spec, q, terminated)(fns["var"]).clone()
        want = launcher(spec, q, terminated)(fns["ref"])
        torch.cuda.synchronize()
        return torch.equal(got, want)

    bad, cases = [], 0
    for NS in (64, 128, 256):
        for n in range(1, 9):
            spec = cs.bfly_spec(fec, rng, NS, n)
            for B, T, label, draw in cs.map_edge_cases(rng, spec):
                q = torch.from_numpy(draw.astype(np.int8)).to(dev)
                for terminated in (True, False):
                    cases += 1
                    if not same(spec, q, terminated):
                        bad.append(f"NS={NS} n={n} B={B} T={T} {label} "
                                   f"terminated={terminated}")
                        print(f"[maxlogmap] differs: {bad[-1]}", flush=True)
    print(f"[maxlogmap] {Path(lib_path).stem}: {cases} cases against the "
          f"reference, {len(bad)} differ", flush=True)

    # The timed inputs, two of each.
    B, L = cs.MAIN_B, cs.MAIN_L
    gen = torch.Generator(device=dev).manual_seed(cs.MAIN_SEED)
    timed_in = {"(h)": [], "NS=128": [], "NS=256": [], "n=6": []}
    codes = {"(h)": fec.NASA_K7, "NS=128": fec.CodeSpec(K=8, g=TIMED_K8),
             "NS=256": fec.K9_561_753, "n=6": fec.CodeSpec(**cs.SP_MAIN)}
    for key, spec in codes.items():
        T = L + spec.S
        for _ in range(2):
            msgs = torch.from_numpy(rng.integers(0, 2, (B, L),
                                                 dtype=np.uint8)).to(dev)
            _, llr = cs.soft_channel(fec, spec, msgs, gen, spec.rate)
            q = fec.quantize_llrs(llr, qmax=cs.QMAX).reshape(B, T, spec.n)
            timed_in[key].append((spec, q.to(torch.int8).contiguous()))
    h0, h1 = (x[1] for x in timed_in["(h)"])
    for B_sweep in SWEEP_B:
        pair = ((h0, h1) if B_sweep <= B else
                (torch.cat([h0, h1]), torch.cat([h1, h0])))
        timed_in[f"(h) B={B_sweep}"] = [
            (fec.NASA_K7, x[:B_sweep].contiguous()) for x in pair]
    result = {"lib": Path(lib_path).stem, "cases": cases, "ms": {},
              "ref_ms": {}}
    for key, inputs in timed_in.items():
        for args in inputs:
            if not same(*args):
                bad.append(f"timed input {key}")
        if not timed:
            continue
        launches = [launcher(*args) for args in inputs]
        ms = _torch_variants.in_turns(
            lambda name, k: launches[k % 2](fns[name]), calls, SLEEP_CYCLES)
        result["ms"][key], result["ref_ms"][key] = ms["var"], ms["ref"]
        x = inputs[0][1]
        print(f"[maxlogmap] {result['lib']} {key:12s} B={x.shape[0]} "
              f"T={x.shape[1]} n={x.shape[2]}: {ms['var']:.4f} ms, "
              f"reference {ms['ref']:.4f} ms", flush=True)
    result["differs"] = bad
    print(json.dumps(result))
    return 1 if bad else 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ref", type=Path,
                    help="the reference source of the C entry")
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=SOURCE.cu, a copy of csrc/maxlogmap_k1.cu")
    ap.add_argument("--calls", type=int, default=15)
    ap.add_argument("--no-time", action="store_true",
                    help="the builds, their SASS and the checks only")
    ap.add_argument("--out", type=Path, default=LIBS)
    ap.add_argument("--run", help=argparse.SUPPRESS)
    ap.add_argument("--ref-lib", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.run:
        return run(args.run, args.ref_lib, args.calls, not args.no_time)
    import torch
    if not torch.cuda.is_available():
        print("torch_maxlogmap_variants: no CUDA device", file=sys.stderr)
        return 1
    if args.ref is None:
        raise SystemExit("--ref PATH.cu is required")
    builds = {"change": SOURCE}
    for item in args.variant:
        name, _, src = item.partition("=")
        builds[name] = Path(src).resolve()
    builds["reference"] = args.ref.resolve()
    out = args.out.resolve()
    sass = {}
    libs, failed = _torch_variants.build_all(builds, LIBS, out, "maxlogmap",
                                             report(out, sass))
    print(json.dumps({"sass": sass}))
    for line in subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.splitlines():
        print(f"[maxlogmap] card: {line.strip()}")
    if "reference" not in libs:
        return 1
    ref_lib = libs.pop("reference")
    status = 1 if failed else 0
    for name, lib in libs.items():
        cmd = [sys.executable, str(Path(__file__).resolve()), "--run",
               str(lib), "--ref-lib", str(ref_lib), "--calls",
               str(args.calls)]
        if args.no_time:
            cmd.append("--no-time")
        proc = subprocess.run(cmd, cwd=ROOT)
        if proc.returncode:
            print(f"[maxlogmap] {name}: exit {proc.returncode}",
                  file=sys.stderr)
            status = 1
    return status


if __name__ == "__main__":
    sys.exit(main())
