"""Build and load the package's CUDA kernels.

At first use, each `csrc/*.cu` is compiled by its own `nvcc` for Hopper
(`sm_90a`), all of them at once, and the objects are linked into one
shared library with a plain C interface under
`convolutionalencdec_tpu_torch/build/` (git-ignored), loaded with
`ctypes`.  A library newer than every source and header (`csrc/*.cuh`)
is reused.  Importing this module builds and loads nothing, so the package
imports on a machine with no CUDA toolkit.

Every C entry point launches on the stream it is given and returns
`cudaGetLastError()`; `check` turns a non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"
LIBRARY = BUILD_DIR / "libconvenc_kernels.so"
BUILD_LOG = BUILD_DIR / "build.log"

# -I csrc: a copy of a source built elsewhere (a variants script's) finds
# the package's headers.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", str(CSRC_DIR)]

_P, _I = ctypes.c_void_p, ctypes.c_int
_HARD_FORWARD = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
_SOFT_FORWARD = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]
_MULTI = [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P]
# name -> argtypes, in the order of the C signatures in csrc/.
SIGNATURES = {
    # seg, cb, init, decs, final_metrics, B, T, NS, n, init_value, stream
    "acs_k1_forward": _HARD_FORWARD,
    "acs_small_forward": _HARD_FORWARD,
    "acs_wide_forward": _HARD_FORWARD,
    # decs, out, B, T_stride, t_actual, NS, S, message_bits, emit_bytes, stream
    "traceback_k1": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "traceback_wide": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # qllrs, cb, init, decs, final_metrics, B, T, NS, n, qlo, qclip,
    # init_value, stream
    "acs_soft_k1_forward": _SOFT_FORWARD,
    "acs_soft_small_forward": _SOFT_FORWARD,
    "acs_soft_wide_forward": _SOFT_FORWARD,
    # decs, lengths, out, B, T, NS, S, message_bits_max, emit_bytes, stream
    "traceback_k1_ragged": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "traceback_wide_ragged": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # decs, starts, out, B, T, NS, S, live, out_steps, emit_bytes, stream
    "traceback_k1_masked": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "traceback_wide_masked": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # decs, starts, out, B, T, NS, S, NW, live, out_start, out_steps,
    # emit_bytes, stream
    "traceback_k1_multi": _MULTI,
    "traceback_wide_multi": _MULTI,
    # input, soft, cb, m_in, r_in, sym, m_out, r_out, B, T, NS, n, W, stream
    "stream_k1_decode": [_P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                         _P],
    # qllrs, cb, ckpt, llrs, B, T, NS, n, start, terminated, stream
    "maxlogmap_k1": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # l_sys, l_par, l_apriori, l_sys_tail, l_par_tail, tab, scratch, lapp,
    # B, L, NS, S, stream
    "turbo_rsc_map": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # seg, table, planes, final_metrics, B, T, k, NS, n, shift, init_value,
    # stream
    "acs_generic_forward": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "acs_generic_k2_forward": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                               _P],
    # planes, out, B, T_stride, t_actual, k, NS, S, message_bits, emit_bytes,
    # stream
    "traceback_generic": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "traceback_generic_k2": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # in, soft, cb, out, B, T, NS, n, S, message_bits, emit_bytes,
    # init_value, stream
    "block_decode_1p": [_P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
}


def find_nvcc() -> str:
    """Path of nvcc: under torch's CUDA_HOME, else on PATH."""
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        candidate = Path(CUDA_HOME) / "bin" / "nvcc"
        if candidate.is_file():
            return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (neither under torch's CUDA_HOME nor on PATH): "
            "the CUDA kernels of convolutionalencdec_tpu_torch cannot be built")
    return found


def build() -> float:
    """Compile csrc/*.cu into LIBRARY unless it is newer than every source
    and header (csrc/*.cuh): one nvcc per source, all started together,
    then one link.  Returns the seconds spent (0.0 when the library was
    reused).  The compilers' output (with `-Xptxas -v` register and spill
    counts) is kept in BUILD_LOG."""
    sources = sorted(CSRC_DIR.glob("*.cu"))
    newest = max(p.stat().st_mtime
                 for p in [*sources, *CSRC_DIR.glob("*.cuh")])
    if LIBRARY.exists() and LIBRARY.stat().st_mtime >= newest:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    # Build under private names and rename, so that concurrent builders
    # never load a half-written library.
    tag = os.getpid()
    objects = [BUILD_DIR / f".{src.stem}.{tag}.o" for src in sources]
    t0 = time.perf_counter()
    jobs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                   stderr=subprocess.STDOUT, text=True))
            for cmd in ([nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
                        for src, obj in zip(sources, objects))]
    log, failed = [], []
    for cmd, proc in jobs:
        output = proc.communicate()[0]
        log.append(" ".join(cmd) + "\n" + output)
        if proc.returncode != 0:
            failed.append(f"{cmd[-3]} ({proc.returncode}):\n{output}")
    tmp = BUILD_DIR / f".{LIBRARY.name}.{tag}"
    if not failed:
        cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, objects)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(f"link ({proc.returncode}):\n"
                          f"{proc.stdout}{proc.stderr}")
    seconds = time.perf_counter() - t0
    for obj in objects:
        obj.unlink(missing_ok=True)
    BUILD_LOG.write_text("".join(log))
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    os.replace(tmp, LIBRARY)
    return seconds


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built kernel library, with argtypes and restype set."""
    build()
    lib = ctypes.CDLL(str(LIBRARY))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    # B, L, NS -> int32 words of turbo_rsc_map's scratch
    lib.turbo_rsc_map_scratch_words.argtypes = [_I, _I, _I]
    lib.turbo_rsc_map_scratch_words.restype = ctypes.c_longlong
    return lib


def check(name: str, code: int) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        text = library().cuda_error_string(code).decode()
        raise RuntimeError(f"{name} failed: CUDA error {code} ({text})")
