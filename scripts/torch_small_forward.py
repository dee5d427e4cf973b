#!/usr/bin/env python3
"""Build-time variants of the small-state forward (`acs_small_forward` and
`acs_soft_small_forward` at NS = 2 ... 32, csrc/acs_small.cu) against a
reference build of the same C entries, on one GPU.

    python3 scripts/torch_small_forward.py --ref PARENT.cu \\
        [--variant NAME=SOURCE.cu ...] [--calls 15] [--no-time] [--out DIR]

Builds csrc/acs_small.cu (as "change"), each variant (a hand-edited copy
of it, `NAME=SOURCE.cu`, e.g. scripts/variants/acs_small_radix4.cu: radix-4
steps at NS = 8, 16, 32) and the reference (`--ref`, e.g. the parent
tree's acs_small.cu: get it with `git show
HEAD:convolutionalencdec_tpu_torch/csrc/acs_small.cu >
_checkout/parent_acs_small.cu`); one nvcc each, all at once, with
`-Xptxas -v` (the logs and each build's SASS in `--out`; relative paths
are read from the caller's directory).  For each build it prints, for the
kernels of NS = 16 (each template: hard and soft, n <= 4 and 5..8; the
radix-4 kernel's at four ballots a step), what a step takes in the SASS
(`step_mix` of scripts/_torch_variants.py): instructions, shuffles,
ballots, shared loads and stores, over a run of 32 unrolled steps or over
the loop that holds a step.

Each build then runs in its own process (a kernel fault poisons the CUDA
context): it is held bit for bit against the reference (which equals the
plain version: chip_smoke.py holds it so), decision words and final
metrics, at NS = 2, 4, 8, 16, 32, n = 1 ... 8 hard and soft: B = 37 (no
multiple of the channels a warp) at T = 0, 1, 31, 32, 33, 70, B = 5 at
T = 2054, noisy and garbage segments, LLRs over the whole int8 range with
-128 at the clip 7 and 127 with the -127 floor and at the -128 route, from
the default start and from carried metrics; and on the timed inputs.  Then
(unless `--no-time`) it is timed in turns with the reference (CUDA events
after a sleep that queues the launch, median of `--calls`, two inputs
alternately; the launch alone, its outputs allocated beforehand):
  (k) hard     K5_23_35 (NS = 16, n = 2), B = 2048, T = 2054: bench.py's
               messages, 3% of the segments hit (chip_smoke.py's (k));
  (k) soft     the same messages over AWGN at 3 dB, quantized to 7 (the
               clip 127);
  (k) B=...    (k) hard's first rows, or two inputs' rows, at `SWEEP_B`;
  NS=...       (k) hard's size on a random code of NS = 2, 4, 8, 32 (n 2).
Prints one JSON line per build and the card's name and power limit.  Exits
non-zero if a build fails or differs.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "scripts"))
import _torch_variants  # noqa: E402
from _torch_variants import load, variants_main  # noqa: E402

SOURCE = ROOT / "convolutionalencdec_tpu_torch" / "csrc" / "acs_small.cu"
LIBS = ROOT / "convolutionalencdec_tpu_torch" / "build" / "small_forward"
ENTRIES = ("acs_small_forward", "acs_soft_small_forward")
SLEEP_CYCLES = 10_000_000
#: Batch sizes of (k) hard's sweep: one warp an SM at NS = 16 (4 channels
#: a warp), a quarter of (k), half of it, twice it.
SWEEP_B = (528, 512, 1024, 4096)
CHECK_T = (0, 1, 31, 32, 33, 70)


def run(lib_path: str, ref_path: str, calls: int, timed: bool) -> int:
    """One build against the reference: the checks, then the times in
    turns; prints its JSON line."""
    import numpy as np
    import torch
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import convolutionalencdec_tpu_torch as fec
    from convolutionalencdec_tpu_torch.kernels import acs
    from convolutionalencdec_tpu_torch.ops.viterbi import init_metric_value
    dev = torch.device("cuda", 0)
    fns = {key: {e: load(Path(p), e) for e in ENTRIES}
           for key, p in (("var", lib_path), ("ref", ref_path))}
    stream = torch.cuda.current_stream(dev).cuda_stream
    rng = np.random.default_rng(2071)

    def launcher(spec, x, soft, init, qlo=0, qclip=0):
        """key -> (words, final metrics) of x: the table and the outputs
        allocated here, so that a timed call is the launch alone."""
        B, T = x.shape[:2]
        NS = spec.num_states
        cb = acs._butterfly_table(spec, dev)
        words = torch.full((B, T, 1), 0x5A5A5A5A, dtype=torch.int32,
                           device=dev)
        fm = torch.full((B, NS), -7, dtype=torch.int32, device=dev)
        ip = None if init is None else init.data_ptr()

        def launch(key):
            if soft:
                code = fns[key][ENTRIES[1]](
                    x.data_ptr(), cb.data_ptr(), ip, words.data_ptr(),
                    fm.data_ptr(), B, T, NS, spec.n, qlo, qclip,
                    init_metric_value(spec), stream)
            else:
                code = fns[key][ENTRIES[0]](
                    x.data_ptr(), cb.data_ptr(), ip, words.data_ptr(),
                    fm.data_ptr(), B, T, NS, spec.n, init_metric_value(spec),
                    stream)
            if code:
                raise RuntimeError(f"launch failed: CUDA error {code}")
            return words, fm
        return launch

    def same(*args):
        got = [x.clone() for x in launcher(*args)("var")]
        want = launcher(*args)("ref")
        torch.cuda.synchronize()
        return all(torch.equal(a, b) for a, b in zip(got, want))

    bad, cases = [], 0
    for NS in cs.BFLY_SMALL_NS:
        for n in range(1, 9):
            spec = cs.bfly_spec(fec, rng, NS, n)
            for B, T in [(cs.NARROW_B, T) for T in CHECK_T] + [(5, 2054)]:
                msgs = rng.integers(0, 2, (B, max(T - spec.S, 0)),
                                    dtype=np.uint8)
                coded = cs.encode_reference_np(spec, msgs)[:, :T]
                coded = np.concatenate(
                    [coded, np.zeros((B, T - coded.shape[1]), np.uint8)], 1)
                noisy = cs.corrupt(rng, coded, cs.NOISE[0], n)
                garbage = rng.integers(0, 1 << n, (B, T)).astype(np.uint8)
                draw = rng.integers(-128, 128, (B, T, n))
                draw.reshape(-1)[::13] = -128
                q = torch.from_numpy(draw.astype(np.int8)).to(dev)
                init = torch.from_numpy(rng.integers(0, 6000, (B, NS)).astype(
                    np.int32)).to(dev)
                for given in (None, init):
                    for label, seg in (("noisy", noisy), ("garbage", garbage)):
                        cases += 1
                        if not same(spec, torch.from_numpy(seg).to(dev),
                                    False, given):
                            bad.append(f"hard NS={NS} n={n} B={B} T={T} "
                                       f"{label} init={given is not None}")
                    for qlo, qclip in ((-7, 7), (-127, 127), (-128, 127)):
                        cases += 1
                        if not same(spec, q, True, given, qlo, qclip):
                            bad.append(f"soft NS={NS} n={n} B={B} T={T} "
                                       f"clamp [{qlo}, {qclip}] "
                                       f"init={given is not None}")
    for line in bad:
        print(f"[small-forward] differs: {line}", flush=True)
    print(f"[small-forward] {Path(lib_path).stem}: {cases} cases against "
          f"the reference, {len(bad)} differ", flush=True)
    result = {"lib": Path(lib_path).stem, "cases": cases, "ms": {},
              "ref_ms": {}}
    if timed:
        spec = fec.PRESETS[cs.SMALL_MAIN]
        B, L = cs.MAIN_B, cs.MAIN_L
        gen = torch.Generator(device=dev).manual_seed(cs.MAIN_SEED)
        timed_in = {"(k) hard": [], "(k) soft": []}
        for _ in range(2):
            msgs = rng.integers(0, 2, (B, L), dtype=np.uint8)
            seg = cs.corrupt(rng, cs.encode_reference_np(spec, msgs),
                             cs.MAIN_NOISE, spec.n)
            timed_in["(k) hard"].append(
                (spec, torch.from_numpy(seg).to(dev), False, None))
            _, llr = cs.soft_channel(fec, spec, torch.from_numpy(msgs).to(
                dev), gen, spec.rate)
            q = fec.quantize_llrs(llr, qmax=cs.QMAX).reshape(
                B, L + spec.S, spec.n).to(torch.int8)
            timed_in["(k) soft"].append((spec, q, True, None, -127, 127))
        h0, h1 = (x[1] for x in timed_in["(k) hard"])
        for Bs in SWEEP_B:
            pair = ((h0, h1) if Bs <= B else
                    (torch.cat([h0, h1]), torch.cat([h1, h0])))
            timed_in[f"(k) B={Bs}"] = [(spec, x[:Bs].contiguous(), False,
                                        None) for x in pair]
        for NS in (2, 4, 8, 32):
            other = cs.bfly_spec(fec, rng, NS, 2)
            timed_in[f"NS={NS}"] = [(other, x, False, None) for x in (h0, h1)]
        for key, inputs in timed_in.items():
            for args in inputs:
                if not same(*args):
                    bad.append(f"timed input {key}")
            launches = [launcher(*args) for args in inputs]
            ms = _torch_variants.in_turns(
                lambda name, k: launches[k % 2](name), calls, SLEEP_CYCLES)
            result["ms"][key], result["ref_ms"][key] = ms["var"], ms["ref"]
            x = inputs[0][1]
            print(f"[small-forward] {result['lib']} {key:10s} B={x.shape[0]}"
                  f" T={x.shape[1]}: {ms['var']:.4f} ms, reference "
                  f"{ms['ref']:.4f} ms", flush=True)
    result["differs"] = bad
    print(json.dumps(result))
    return 1 if bad else 0


def main() -> int:
    if "--run" in sys.argv:
        ap = argparse.ArgumentParser()
        ap.add_argument("--run")
        ap.add_argument("--ref-lib")
        ap.add_argument("--calls", type=int, default=15)
        ap.add_argument("--untimed", action="store_true")
        a = ap.parse_args()
        return run(a.run, a.ref_lib, a.calls, not a.untimed)
    return variants_main(__doc__, SOURCE, LIBS, "small-forward",
                         r"acs_(small|radix4)_kernelILi16E"
                         r"(Li\d|Lb[01]ELi[12])E",
                         lambda fn: (4 if "radix4" in fn else 2, None),
                         Path(__file__).resolve())


if __name__ == "__main__":
    sys.exit(main())
