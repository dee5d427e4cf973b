"""What a script that measures build-time variants of a kernel shares:
building several sources of one C entry at once, reading what a step takes
in their SASS, timing two builds in turns on one GPU, and the main that
builds, reports and runs each build against a reference in its own process
(`variants_main`).  A variants script holds only its checks and timings
(its `run`) and the pattern of the kernels whose SASS it counts.  Used by
scripts/torch_single_pass.py, torch_soft_forward.py,
torch_maxlogmap_variants.py, torch_narrow_walk.py, torch_small_forward.py
and torch_stream_variants.py."""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable

ROOT = Path(__file__).resolve().parent.parent

INSTRUCTION = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
BRANCH = re.compile(r"\bBRA\b.*?(0x[0-9a-f]+|\.L_x_\d+)")
LABEL = re.compile(r"^\s*(\.L_x_\d+):")


def sass_functions(text: str) -> dict[str, list]:
    """cuobjdump -sass text -> {function name: [(address, instruction) or
    ("label", name)]}."""
    funcs, cur = {}, None
    for line in text.splitlines():
        if "Function : " in line:
            cur = funcs.setdefault(line.split("Function : ")[1].strip(), [])
            continue
        if cur is None:
            continue
        m = LABEL.match(line)
        if m:
            cur.append(("label", m.group(1)))
            continue
        m = INSTRUCTION.search(line)
        if m:
            cur.append((int(m.group(1), 16), m.group(2)))
    return funcs


#: What a step's SASS is counted by: opcode prefixes.
CLASSES = {"shfl": ("SHFL",), "vote": ("VOTE",), "redux": ("REDUX",),
           "lds": ("LDS",), "sts": ("STS",)}


def step_mix(body: list, per: int, steps_hint=None) -> dict:
    """What a step of one kernel takes in its SASS, `per` ballots (VOTE) a
    step: over a run of 32 unrolled steps (from the first ballot of its
    first step to that of its last, over 31) or, where there is none, over
    each innermost loop holding a ballot, shuffle or reduction (over the
    steps an iteration: its ballots over `per`, or `steps_hint(loop)`).
    Counts instructions in all and each of CLASSES."""
    ins = [(a, t) for a, t in body if a != "label"]
    labels, pos = {}, 0
    for a, t in body:
        if a == "label":
            labels[t] = pos
        else:
            pos += 1
    index = {a: i for i, (a, _) in enumerate(ins)}

    def mix(lo, hi, steps):
        out = {"instructions": round((hi - lo) / steps, 1)}
        for name, ops in CLASSES.items():
            out[name] = round(sum(any(ins[k][1].startswith(op) or
                                      f" {op}" in ins[k][1][:12]
                                      for op in ops)
                                  for k in range(lo, hi)) / steps, 2)
        return out

    votes = [i for i, (_, t) in enumerate(ins) if t.startswith("VOTE")]
    if per and len(votes) >= 32 * per:
        for k in range(len(votes) - 31 * per):
            lo, hi = votes[k], votes[k + 31 * per]
            run = [v for v in votes if lo <= v <= hi]
            if len(run) == 31 * per + 1:
                return {"block": mix(lo, hi, 31)}
    loops = []
    for i, (_, t) in enumerate(ins):
        m = BRANCH.search(t)
        if not m:
            continue
        target = m.group(1)
        j = labels.get(target) if target.startswith(".L") else index.get(
            int(target, 16))
        if j is not None and j <= i:
            loops.append((j, i + 1))
    inner = [(j, i) for j, i in loops
             if not any((j, i) != (a, b) and j <= a and b <= i
                        for a, b in loops)]
    out = []
    for j, i in inner:
        text = [ins[k][1] for k in range(j, i)]
        nv = sum(x.startswith("VOTE") for x in text)
        steps = nv // per if per and nv else (steps_hint(text) if steps_hint
                                              else 0)
        if steps:
            out.append(mix(j, i, steps))
    return {"loops": out}


def report(out: Path, sass: dict, pattern: str, per_of):
    """A build's report for `build_all`: the registers of
    each kernel matching `pattern`, its SASS kept in `out`, and what a step
    takes (`per_of(function name)`: the ballots a step)."""
    def each(name: str, lib: Path, output: str) -> None:
        lines = output.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry function" in line and re.search(pattern, line):
                regs = next((x for x in lines[i + 1:i + 4]
                             if "registers" in x), "").strip()
                print(f"[variants] {name} {line.split(chr(39))[1]}: {regs}")
        from convolutionalencdec_tpu_torch.kernels import _build
        cuobjdump = Path(_build.find_nvcc()).parent / "cuobjdump"
        text = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                              capture_output=True, text=True).stdout
        (out / f"{name}.sass").write_text(text)
        sass[name] = {}
        for fn, body in sass_functions(text).items():
            if re.search(pattern, fn):
                per, hint = per_of(fn)
                sass[name][fn] = step_mix(body, per, hint)
                print(f"[variants] {name} {fn}: {sass[name][fn]}")
    return each


def load(path: Path, entry: str):
    from convolutionalencdec_tpu_torch.kernels import _build
    fn = getattr(ctypes.CDLL(str(path)), entry)
    fn.argtypes = _build.SIGNATURES[entry]
    fn.restype = ctypes.c_int
    return fn


def build_all(builds: dict[str, Path], libs: Path, out: Path, tag: str,
              report: Callable[[str, Path, str], None] | None = None):
    """name -> source: one nvcc each, all started at once, into
    `libs`/NAME.so, nvcc's output (ptxas's registers among it) in
    `out`/NAME.log.  Calls `report(name, library, output)` for each build
    that succeeded; returns (name -> library, names that failed)."""
    sys.path.insert(0, str(ROOT))
    from convolutionalencdec_tpu_torch.kernels import _build
    nvcc = _build.find_nvcc()
    out.mkdir(parents=True, exist_ok=True)
    libs.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    jobs = {}
    for name, src in builds.items():
        lib = libs / f"{name}.so"
        cmd = [nvcc, *_build.NVCC_FLAGS, "-shared", "-o", str(lib), str(src)]
        jobs[name] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built, failed = {}, []
    for name, (lib, proc) in jobs.items():
        output = proc.communicate()[0]
        (out / f"{name}.log").write_text(output)
        if proc.returncode:
            failed.append(name)
            print(f"[{tag}] {name}: nvcc failed\n{output}", file=sys.stderr)
            continue
        built[name] = lib
        if report is not None:
            report(name, lib, output)
    print(f"[{tag}] nvcc {time.perf_counter() - t0:.1f} s", flush=True)
    return built, failed


def in_turns(launch: Callable[[str, int], object], calls: int,
             sleep_cycles: int, names=("var", "ref")) -> dict[str, float]:
    """name -> median device ms of `launch(name, k)` over `calls` turns.
    Turn i runs the names in order where i is even, reversed where it is
    odd; each launch alone on the stream, after a sleep of `sleep_cycles`
    that queues it, between two CUDA events.  k counts the launches, so
    that the caller can rotate its inputs."""
    import torch
    times = {name: [] for name in names}
    k = 0
    for i in range(calls):
        for name in names if i % 2 == 0 else names[::-1]:
            torch.cuda.synchronize()
            torch.cuda._sleep(sleep_cycles)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            launch(name, k)
            e1.record()
            torch.cuda.synchronize()
            times[name].append(e0.elapsed_time(e1))
            k += 1
    return {name: statistics.median(x) for name, x in times.items()}


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def variants_main(doc: str, source: Path, libs_dir: Path, tag: str,
                  pattern: str, per_of, script: Path) -> int:
    """The shared main of a variants script: parse, build, report the
    SASS, and run each build against the reference in its own process
    (`script --run LIB --ref-lib REF`)."""
    ap = argparse.ArgumentParser(description=doc.split("\n")[0])
    ap.add_argument("--ref", type=Path, required=True,
                    help="the reference source of the C entries")
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=SOURCE.cu, a copy of the kernel's source")
    ap.add_argument("--calls", type=int, default=15)
    ap.add_argument("--no-time", action="store_true",
                    help="the checks only")
    ap.add_argument("--no-change", action="store_true",
                    help="only the variants, not the tree's source (e.g. "
                         "the reference timed against a copy of itself)")
    ap.add_argument("--out", type=Path, default=libs_dir)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print(f"{script.stem}: no CUDA device", file=sys.stderr)
        return 1
    builds = {} if args.no_change else {"change": source}
    for item in args.variant:
        name, _, src = item.partition("=")
        builds[name] = Path(src).resolve()
    builds["reference"] = args.ref.resolve()
    out = args.out.resolve()
    sass = {}
    libs, failed = build_all(builds, libs_dir, out, tag,
                                             report(out, sass, pattern,
                                                    per_of))
    print(json.dumps({"sass": sass}))
    print(f"[{tag}] card: {card()}")
    if "reference" not in libs:
        return 1
    ref_lib = libs.pop("reference")
    status = 1 if failed else 0
    for name, lib in libs.items():
        cmd = [sys.executable, str(script), "--run", str(lib), "--ref-lib",
               str(ref_lib), "--calls", str(args.calls)]
        if args.no_time:
            cmd.append("--untimed")
        proc = subprocess.run(cmd, cwd=ROOT)
        if proc.returncode:
            print(f"[{tag}] {name}: exit {proc.returncode}", file=sys.stderr)
            status = 1
    return status
