"""What a script that measures build-time variants of a kernel shares:
building several sources of one C entry at once, and timing two builds in
turns on one GPU.  Used by scripts/torch_single_pass.py --ref."""

from __future__ import annotations

import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable

ROOT = Path(__file__).resolve().parent.parent


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
