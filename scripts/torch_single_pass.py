#!/usr/bin/env python3
"""The single-pass phases of chip_smoke.py alone, on one GPU.

    python3 scripts/torch_single_pass.py

Builds the kernels, then runs chip_smoke.py's phases 19-22: the single-pass
block decode (csrc/block_1p.cu) against its plain version, the main path
(m) (the rate-1/6 K = 7 code at bench.py's working set), its times and
K13's beside the two-pass decode at (a)'s input (NASA_K7, B = 2048 x
L = 2048), and the harness path (n) (`run_curve`, berTestK7's acceptance
run, a `bench_decode` tick, the traffic model); prints each time's median
beside its plain version's and its bound, and the card's name and power
limit.  Exits non-zero if a check fails or there is no CUDA device.
"""

from __future__ import annotations

import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


#: Batch sizes of the sweep: one channel per SM; 13 per SM (the blocks of
#: 16.4 KB of decisions one SM's 227 KB holds, one wave); one more; (m)'s.
SWEEP_B = (132, 1716, 1717, 2048)


def batch_sweep(cs, acs, sp_in):
    """Device ms of K13 and of the two-pass kernels (K1, then K2) on the
    first B rows of (m)'s hard input, for each B of SWEEP_B: where K13's
    time goes as its blocks fill the SMs and spill into a second wave."""
    import torch
    from convolutionalencdec_tpu_torch.kernels import single_pass as sp
    spec, seg, _ = sp_in
    T = seg.shape[1]
    runs = {}
    for B in SWEEP_B:
        bufs = [torch.roll(seg, r + 1, dims=0)[:B].contiguous()
                for r in range(cs.TIMED_CALLS)]
        runs[f"sweep K13 B={B}"] = cs.device_times(
            lambda s: sp.block_decode_1p(spec, s, T, False, "bytes",
                                         cs.MAIN_L), bufs)
        runs[f"sweep K1 B={B}"] = cs.device_times(
            lambda s: acs.acs_forward_batch(spec, s), bufs)
        decs = [acs.acs_forward_batch(spec, s)[0] for s in bufs]
        runs[f"sweep K2 B={B}"] = cs.device_times(
            lambda d: acs.traceback_batch(spec, d, T, cs.MAIN_L, "bytes"),
            decs)
    return runs


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_single_pass: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import convolutionalencdec_tpu_torch as fec
    from convolutionalencdec_tpu_torch.kernels import _build, acs
    dev = torch.device("cuda", 0)
    t_all = time.perf_counter()
    card = cs.phase_environment(_build)
    cs.phase_build(_build)
    err = dict.fromkeys(cs.KERNELS, 0)
    t0 = time.perf_counter()
    cs.phase_compare_single_pass(fec, dev, err)
    print(f"[single pass] compare {time.perf_counter() - t0:.1f} s")
    sp_in, _, plain, summary = cs.phase_single_pass(fec, acs, dev, err)
    rng = np.random.default_rng(cs.MAIN_SEED)
    msgs = rng.integers(0, 2, (cs.MAIN_B, cs.MAIN_L), dtype=np.uint8)
    seg_a, _ = fec.encode_bits(fec.NASA_K7, torch.from_numpy(msgs).to(dev))
    seg_a = torch.from_numpy(cs.corrupt(rng, seg_a.cpu().numpy(),
                                        cs.MAIN_NOISE, 2)).to(dev)
    runs = cs.single_pass_times(fec, sp_in, seg_a)
    _, harness = cs.phase_harness(fec, acs, dev, seg_a)
    runs.update(batch_sweep(cs, acs, sp_in))
    bound = cs.bounds(0, [], (
        (fec.K5_23_35, cs.MAIN_L + 4, 0), (fec.K5_23_35, cs.MAIN_L + 4, 0),
        (1, 1, 1)))
    for key in sorted(runs):
        b = bound.get(key)
        print(f"[single pass] {key:24s} median "
              f"{statistics.median(runs[key]):.4f} ms, min "
              f"{min(runs[key]):.4f} ms; plain "
              f"{plain.get(key, float('nan')):.1f} ms; bound "
              f"{'-' if b is None else f'{b[0]:.4f} ms ({b[1]})'}")
    print(json.dumps({"max_abs_err": err["block_decode_1p"], "m": summary,
                      "n": harness}))
    if err["block_decode_1p"]:
        print("torch_single_pass: K13 differs from its plain version",
              file=sys.stderr)
        return 1
    print(f"[single pass] {time.perf_counter() - t_all:.1f} s")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
