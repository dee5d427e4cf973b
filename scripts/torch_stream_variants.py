#!/usr/bin/env python3
"""Build-time variants of the register-exchange stream decode
(`stream_k1_decode` at NS = 64, 128 and 256, csrc/stream_k1.cu) against a
reference build of the same C entry, on one GPU.

    python3 scripts/torch_stream_variants.py --ref PARENT.cu \\
        [--variant NAME=SOURCE.cu ...] [--calls 15] [--no-time] [--out DIR]

Builds csrc/stream_k1.cu (as "change"), each variant (a hand-edited copy
of it, `NAME=SOURCE.cu`) and the reference (`--ref`, e.g. the parent
tree's stream_k1.cu: get it with `git show
HEAD:convolutionalencdec_tpu_torch/csrc/stream_k1.cu >
_checkout/parent_stream_k1.cu`); one nvcc each, all at once, with
`-Xptxas -v` (the logs and each build's SASS in `--out`).  For each build
it prints, for the kernels of NS = 64 (each template), what a step takes
in the SASS (`step_mix` of scripts/_torch_variants.py): instructions,
shuffles, ballots, reductions, shared loads and stores.

Each build then runs in its own process: it is held bit for bit against
the reference (which equals the plain version: chip_smoke.py holds it so),
symbols, metrics and registers out, on NASA_K7, a K = 8 code and
K9_561_753 and on random codes of NS = 64, 128, 256 with n = 1, 3, 5, 8,
hard (3% and 25% segment corruption) and soft (LLRs over the whole int8
range with -128, 20% erased), at W = 2, 7, 35, 63, 64: B = 37 over
T = 209 in one call and cut at 77 (the second call from the first one's
state, its first W - 1 emits reaching the carried registers); T = 0, 1,
13 from a carried state; B = 1.  Then (unless `--no-time`) it is timed in
turns with the reference (CUDA events after a sleep that queues the
launch, median of `--calls`, two inputs alternately, from the fresh
state; the launch alone, its outputs allocated beforehand):
  256 hard    NASA_K7, B = 2048, W = 35, 256 steps: a call of the
              streaming main path's feed (bench.py's messages, 3%);
  256 soft    the same messages over AWGN at 3 dB, quantized to 7;
  (a) hard    the whole 2054 steps in one call, and (a) soft;
  256 B=...   256 hard's first rows, or two inputs' rows, at `SWEEP_B`;
  NS=...      256 hard's size on K8 (NS = 128) and K9_561_753 (NS = 256).
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

SOURCE = ROOT / "convolutionalencdec_tpu_torch" / "csrc" / "stream_k1.cu"
LIBS = ROOT / "convolutionalencdec_tpu_torch" / "build" / "stream_variants"
ENTRY = "stream_k1_decode"
SLEEP_CYCLES = 10_000_000
SWEEP_B = (132, 528, 1024, 4096)
WINDOWS = (2, 7, 35, 63, 64)
K8 = dict(K=8, g=(0o247, 0o371))


def run(lib_path: str, ref_path: str, calls: int, timed: bool) -> int:
    import numpy as np
    import torch
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import convolutionalencdec_tpu_torch as fec
    from convolutionalencdec_tpu_torch.kernels import acs
    from convolutionalencdec_tpu_torch.kernels import stream as ks
    dev = torch.device("cuda", 0)
    fns = {"var": load(Path(lib_path), ENTRY), "ref": load(Path(ref_path),
                                                           ENTRY)}
    cuda_stream = torch.cuda.current_stream(dev).cuda_stream
    rng = np.random.default_rng(2073)

    def launcher(spec, x, soft, W, state):
        """key -> (symbols, metrics, registers) of x from `state`."""
        B, T = x.shape[:2]
        NS = spec.num_states
        cb = acs._butterfly_table(spec, dev)
        m_in, r_in = (t.contiguous() for t in state)
        sym = torch.full((B, T), 0xA5, dtype=torch.uint8, device=dev)
        m_out = torch.full((B, NS), -7, dtype=torch.int32, device=dev)
        r_out = torch.full((B, NS), -7, dtype=torch.int64, device=dev)

        def launch(key):
            code = fns[key](x.data_ptr(), int(soft), cb.data_ptr(),
                            m_in.data_ptr(), r_in.data_ptr(), sym.data_ptr(),
                            m_out.data_ptr(), r_out.data_ptr(), B, T, NS,
                            spec.n, W, cuda_stream)
            if code:
                raise RuntimeError(f"launch failed: CUDA error {code}")
            return sym, m_out, r_out
        return launch

    def same(*args):
        got = [x.clone() for x in launcher(*args)("var")]
        want = launcher(*args)("ref")
        torch.cuda.synchronize()
        return all(torch.equal(a, b) for a, b in zip(got, want)), want

    def carried(spec, B, W):
        NS = spec.num_states
        m = torch.from_numpy(rng.integers(0, 300, (B, NS)).astype(np.int32))
        r = rng.integers(0, 2 ** 63, (B, NS), dtype=np.uint64)
        r &= np.uint64((1 << W) - 1 if W < 64 else 2 ** 64 - 1)
        return ks.StreamState(m.to(dev), torch.from_numpy(
            r.view(np.int64)).to(dev))

    codes = [("NASA_K7", fec.NASA_K7), ("K8", fec.CodeSpec(**K8)),
             ("K9_561_753", fec.K9_561_753)]
    codes += [(f"NS{NS}_n{n}", cs.bfly_spec(fec, rng, NS, n))
              for NS in (64, 128, 256) for n in (1, 3, 5, 8)]
    bad, cases = [], 0
    for name, spec in codes:
        for i, (label, soft, x) in enumerate(cs.stream_draws(
                rng, spec, cs.SMALL_B, cs.SMALL_L + 6)):
            x = x.to(dev)
            W = WINDOWS[i % len(WINDOWS)] if name.startswith("NS") else None
            for W in (WINDOWS if W is None else (W,)):
                st = ks.stream_state_init(spec, x.shape[0], dev)
                for part in (x, x[:, :77].contiguous(),
                             x[:, 77:].contiguous()):
                    ok, out = same(spec, part, soft, W, st)
                    cases += 1
                    if not ok:
                        bad.append(f"{name} {label} W={W} T={part.shape[1]}")
                    if part.shape[1] == 77:
                        st = ks.StreamState(out[1].clone(), out[2].clone())
                for B, T in ((cs.SMALL_B, 0), (cs.SMALL_B, 1), (1, 13),
                             (cs.SMALL_B, 13)):
                    ok, _ = same(spec, x[:B, :T].contiguous(), soft, W,
                                 carried(spec, B, W))
                    cases += 1
                    if not ok:
                        bad.append(f"{name} {label} W={W} B={B} T={T} "
                                   "carried")
    for line in bad:
        print(f"[stream] differs: {line}", flush=True)
    print(f"[stream] {Path(lib_path).stem}: {cases} cases against the "
          f"reference, {len(bad)} differ", flush=True)
    result = {"lib": Path(lib_path).stem, "cases": cases, "ms": {},
              "ref_ms": {}}
    if timed:
        spec = fec.NASA_K7
        B, L = cs.MAIN_B, cs.MAIN_L
        gen = torch.Generator(device=dev).manual_seed(cs.MAIN_SEED)
        hard, soft = [], []
        for _ in range(2):
            msgs = rng.integers(0, 2, (B, L), dtype=np.uint8)
            seg = cs.corrupt(rng, cs.encode_reference_np(spec, msgs),
                             cs.MAIN_NOISE, spec.n)
            hard.append(torch.from_numpy(seg).to(dev))
            _, llr = cs.soft_channel(fec, spec, torch.from_numpy(msgs).to(
                dev), gen, spec.rate)
            soft.append(fec.quantize_llrs(llr, qmax=cs.QMAX).reshape(
                B, L + spec.S, spec.n).to(torch.int8))
        fresh = ks.stream_state_init(spec, B, dev)
        steps = cs.STREAM_FEED[0]
        timed_in = {
            "256 hard": [(spec, x[:, :steps].contiguous(), False, cs.MAIN_W,
                          fresh) for x in hard],
            "256 soft": [(spec, x[:, :steps].contiguous(), True, cs.MAIN_W,
                          fresh) for x in soft],
            "(a) hard": [(spec, x, False, cs.MAIN_W, fresh) for x in hard],
            "(a) soft": [(spec, x, True, cs.MAIN_W, fresh) for x in soft]}
        h0, h1 = (x[:, :steps] for x in hard)
        for Bs in SWEEP_B:
            pair = ((h0, h1) if Bs <= B else
                    (torch.cat([h0, h1]), torch.cat([h1, h0])))
            timed_in[f"256 B={Bs}"] = [
                (spec, x[:Bs].contiguous(), False, cs.MAIN_W,
                 ks.stream_state_init(spec, Bs, dev)) for x in pair]
        for other in (fec.CodeSpec(**K8), fec.K9_561_753):
            timed_in[f"NS={other.num_states}"] = [
                (other, x.contiguous(), False, cs.MAIN_W,
                 ks.stream_state_init(other, B, dev)) for x in (h0, h1)]
        for key, inputs in timed_in.items():
            for args in inputs:
                if not same(*args)[0]:
                    bad.append(f"timed input {key}")
            launches = [launcher(*args) for args in inputs]
            ms = _torch_variants.in_turns(
                lambda name, k: launches[k % 2](name), calls, SLEEP_CYCLES)
            result["ms"][key], result["ref_ms"][key] = ms["var"], ms["ref"]
            x = inputs[0][1]
            print(f"[stream] {result['lib']} {key:10s} B={x.shape[0]} "
                  f"T={x.shape[1]}: {ms['var']:.4f} ms, reference "
                  f"{ms['ref']:.4f} ms", flush=True)
    result["differs"] = bad
    print(json.dumps(result))
    return 1 if bad else 0


def per_of(fn: str):
    """(ballots a step, steps of a loop without ballots) of a kernel: the
    parent's has no ballots, 16 reductions a loop of 8 steps."""
    bpl = int(fn.split("stream_k1_kernelILi")[1].split("E")[0])
    return 2 * bpl, lambda text: sum(x.startswith("REDUX") for x in text) // 2


def main() -> int:
    if "--run" in sys.argv:
        ap = argparse.ArgumentParser()
        ap.add_argument("--run")
        ap.add_argument("--ref-lib")
        ap.add_argument("--calls", type=int, default=15)
        ap.add_argument("--untimed", action="store_true")
        a = ap.parse_args()
        return run(a.run, a.ref_lib, a.calls, not a.untimed)
    return variants_main(__doc__, SOURCE, LIBS, "stream",
                         r"stream_k1_kernelILi1E(Li\d|Lb[01]ELi[12])E", per_of,
                         Path(__file__).resolve())


if __name__ == "__main__":
    sys.exit(main())
