#!/usr/bin/env python3
"""Latency of the instructions on a butterfly forward's chain, on one GPU.

    python3 scripts/torch_chain_latency.py

Builds a one-warp CUDA probe (nvcc, sm_90a, into the package's build
directory) whose loops each run 4096 dependent instructions of one kind
between two clock64() reads, and prints the cycles per instruction: a
32-lane `__shfl_sync` (full width and width 8), `__dp4a`, a 32-bit
minimum, a shared-memory load, a shared-memory store and load across a
`__syncwarp`, and the step chains of csrc/acs_small.cu (`__dp4a`, minimum,
shuffle) and of an add-based step.  These are the floors under a step of a
forward whose channels do not fill the card; the card's name and power
limit are printed beside them.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "convolutionalencdec_tpu_torch" / "build" / "chain_latency"

SOURCE = r"""
#include <cstdio>
#include <cuda_runtime.h>
#define N 4096
__global__ void probe(int seed, int* out, long long* cyc) {
  __shared__ int sm[64];
  const int lane = threadIdx.x & 31;
  sm[lane] = lane;
  sm[lane + 32] = lane;
  __syncwarp();
  int a = seed + lane, b = seed * 3 + lane;
  long long t0, t1;
#define TIME(slot, body)                                 \
  t0 = clock64();                                        \
  _Pragma("unroll 16") for (int i = 0; i < N; ++i) body; \
  t1 = clock64();                                        \
  if (lane == 0) cyc[slot] = t1 - t0;
  TIME(0, a = __shfl_sync(0xffffffff, a, (lane + 1) & 31))
  TIME(1, a = __shfl_sync(0xffffffff, a, (lane + 1) & 7, 8))
  TIME(2, a = __dp4a(b, 0x01010101, a))
  TIME(3, a = min(a, b - i))
  TIME(4, a = sm[a & 31])
  TIME(5, { sm[(i & 1) * 32 + lane] = a + 1; __syncwarp();
            a = sm[(i & 1) * 32 + ((lane + 1) & 31)]; })
  TIME(6, { const int c = __dp4a(b, 0x01010101, a);
            const int d = __dp4a(b, 0x00010001, a);
            a = __shfl_sync(0xffffffff, min(c, d + i), (lane + 1) & 7, 8); })
  TIME(7, { const int c = a + b; const int d = a + i;
            a = __shfl_sync(0xffffffff, min(c, d), (lane + 1) & 7, 8); })
  out[threadIdx.x] = a;
}
int main() {
  int* out;
  long long* cyc;
  cudaMalloc(&out, 1024);
  cudaMallocManaged(&cyc, 8 * sizeof(long long));
  for (int rep = 0; rep < 2; ++rep) {  // the second run is reported
    probe<<<1, 32>>>(rep + 1, out, cyc);
    if (cudaDeviceSynchronize() != cudaSuccess) return 1;
  }
  const char* names[] = {"shfl", "shfl width 8", "dp4a", "min", "lds",
                         "sts + syncwarp + lds", "dp4a + min + shfl (w8)",
                         "add + min + shfl (w8)"};
  for (int i = 0; i < 8; ++i) printf("%-24s %.2f cycles\n", names[i], (double)cyc[i] / N);
  return 0;
}
"""


def main() -> int:
    sys.path.insert(0, str(ROOT))
    from convolutionalencdec_tpu_torch.kernels import _build
    OUT.mkdir(parents=True, exist_ok=True)
    src, exe = OUT / "chain_latency.cu", OUT / "chain_latency"
    src.write_text(SOURCE)
    subprocess.run([_build.find_nvcc(), "-gencode",
                    "arch=compute_90a,code=sm_90a", "-O3", "-o", str(exe),
                    str(src)], check=True)
    proc = subprocess.run([str(exe)], capture_output=True, text=True)
    print(proc.stdout, end="")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}")
    return proc.returncode


if __name__ == "__main__":
    sys.exit(main())
