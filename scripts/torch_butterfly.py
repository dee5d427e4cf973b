#!/usr/bin/env python3
"""The small and wide butterfly phases of chip_smoke.py alone, on one GPU.

    python3 scripts/torch_butterfly.py [--root TREE] [--no-compare]

Builds the kernels, then runs chip_smoke.py's phases 16-18: the small
(NS 2-32) and wide (NS 512-16384) butterfly kernels against their plain
versions, the main paths (k) K5_23_35 and (l) the K=15 rate-1/4 code at
bench.py's working set, and their times; prints each kernel's and decode's
median ms beside its plain version's ms and its bound, and the card's name
and power limit.  About a minute of command where the whole chip_smoke.py
takes three: the quick measurement of these kernels after a change to
them.  Exits non-zero if a check fails or there is no CUDA device.

`--root TREE` runs the package of another tree (e.g. the parent, unpacked
by `git archive HEAD | tar -x -C _checkout/parent`) with this tree's
chip_smoke.py: its inputs, checks and timing code, so that two trees are
timed on the same inputs; run one process a tree in the order parent,
change, change, parent in one call.  `--no-compare` skips phase 16 (the
main paths are still held to their plain routes).
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", type=Path, default=ROOT,
                    help="the tree whose package runs")
    ap.add_argument("--no-compare", action="store_true",
                    help="skip phase 16's comparisons")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_butterfly: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    sys.path.insert(0, str(args.root.resolve()))
    import convolutionalencdec_tpu_torch as fec
    print(f"[butterfly] package {Path(fec.__file__).parent}")
    from convolutionalencdec_tpu_torch.kernels import _build, acs
    dev = torch.device("cuda", 0)
    t_all = time.perf_counter()
    card = cs.phase_environment(_build)
    cs.phase_build(_build)
    err = dict.fromkeys(cs.KERNELS, 0)
    if not args.no_compare:
        t0 = time.perf_counter()
        cs.phase_compare_butterfly(fec, acs, dev, err)
        print(f"[butterfly] compare {time.perf_counter() - t0:.1f} s")
    small_in, _, small_plain, small_summary = cs.phase_small(fec, acs, dev,
                                                             err)
    wide_in, _, wide_plain, wide_summary = cs.phase_wide(fec, acs, dev, err)
    runs = cs.butterfly_times(fec, acs, small_in, wide_in)
    small_spec, small_seg, _, _, small_lens = small_in
    wide_spec, wide_seg, _, wide_lens = wide_in[:4]
    bound = cs.bounds(0, [], (
        (small_spec, small_seg.shape[1],
         int(small_lens.clamp(0, small_seg.shape[1]).sum())),
        (wide_spec, wide_seg.shape[1],
         int(wide_lens.clamp(0, wide_seg.shape[1]).sum())),
        (cs.WIDE_LIST_B, cs.MAIN_L, cs.WIDE_LIST_SIZE)))
    plain = {**small_plain, **wide_plain}
    for key in sorted(runs):
        b = bound.get(key)
        print(f"[butterfly] {key:24s} median {statistics.median(runs[key]):.4f}"
              f" ms, min {min(runs[key]):.4f} ms; plain "
              f"{plain.get(key, float('nan')):.1f} ms; bound "
              f"{'-' if b is None else f'{b[0]:.4f} ms ({b[1]})'}")
    print(json.dumps({"max_abs_err": err, "small": small_summary,
                      "wide": wide_summary}))
    bad = [k for k, v in err.items() if v]
    if bad:
        print(f"torch_butterfly: kernels differ from their plain versions: "
              f"{bad}", file=sys.stderr)
        return 1
    print(f"[butterfly] {time.perf_counter() - t_all:.1f} s")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
