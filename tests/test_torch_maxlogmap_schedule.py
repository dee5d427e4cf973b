"""The max-log-MAP kernel's schedule (csrc/maxlogmap_k1.cu,
`maxlogmap_k1_kernel`, TPU kernel K7), modelled in numpy, against the
port's scan (ops/maxlogmap.maxlogmap_llrs) and the JAX package's scan, bit
for bit.

The kernel runs only on the card, where chip_smoke.py holds it to its plain
version; here a model done the way the kernel does it is held to both
scans: a warp's 32 lanes, lane l owning butterflies 32 j + l and states
32 m + l; edge metrics without the relu(-q) sums, each candidate the source
metric plus the LLRs over a 0/1 byte mask (for n > 4, f2 the step's LLR
sum less f1), the masks complemented on lanes 16-31; the forward's K4
exchange (two shuffles, parity selects); beta's gather of beta(2b),
beta(2b + 1) by two shuffles from lanes 2l, 2l + 1 or 2l - 31, 2l - 32,
even lanes sending slot 2j first; at NS = 64 odd lanes' two metrics
swapped in both recursions, their masks flipped to match, and no select;
the forward's checkpoints every 32 steps (the last chunk not stepped
through); each chunk replayed from its checkpoint (at NS = 64, n <= 4, into
registers, for all 32 steps: those past T from stale inputs), beta back
through its steps, the emit a min of
alpha' + beta' over each lane's states (all of its parity) and the minima
over the even and the odd lanes.  The kernel's constants are read from
its source.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import convolutionalencdec_tpu as ref
from convolutionalencdec_tpu.ops import maxlogmap as ref_map

import convolutionalencdec_tpu_torch as port
from convolutionalencdec_tpu_torch.kernels import maxlogmap as kmap
from convolutionalencdec_tpu_torch.ops import maxlogmap as port_map
from convolutionalencdec_tpu_torch.ops.trellis import butterfly_coded_bits

SOURCE = (Path(__file__).resolve().parent.parent / "convolutionalencdec_tpu_torch"
          / "csrc" / "maxlogmap_k1.cu").read_text()
CHUNK = int(re.search(r"constexpr int kChunk = (\d+);", SOURCE).group(1))
BIG = 1 << int(re.search(r"constexpr int kBig = 1 << (\d+);",
                         SOURCE).group(1))
INT_MAX = 2 ** 31 - 1


def _model(spec, q, terminated):
    """numpy model of `maxlogmap_k1_kernel`: int32 LLRs [B, T] of int LLRs
    q [B, T, n] (floored at -127 as the kernel's staging lane does)."""
    NS = spec.num_states
    BPL = NS // 64
    B, T, n = q.shape
    q = np.maximum(q.astype(np.int64), -127)
    lane = np.arange(32)
    upper, odd = lane >= 16, (lane & 1) == 1
    b = 32 * np.arange(BPL)[:, None] + lane                   # [BPL, 32]
    cb = butterfly_coded_bits(spec).astype(np.int64)[b]
    # Slot m of lane l holds state 32 m + l, at NS = 64 with odd lanes'
    # two slots swapped; the masks of butterfly 32 j + l for those sources
    # (f1 the edge's own metric on lanes 0-15, flipped on 16-31 and where
    # swapped).
    swap = BPL == 1
    regs = swap and n <= 4  # alpha' replayed into registers
    flip = upper != (odd & swap)
    m1 = (np.where(flip, ~cb, cb)[..., None] >> np.arange(n)) & 1
    m2 = 1 - m1
    nat = 32 * np.arange(2 * BPL)[:, None] + lane             # [2 BPL, 32]
    held = np.where(odd & swap, nat ^ 32, nat)                # the states
    assert np.all((held & 1) == (lane & 1))                   # lane parity
    src1 = np.where(odd, 16, 0) + (lane >> 1)
    src2 = src1 ^ 16
    e1 = np.where(lane < 16, 2 * lane, 2 * lane - 31)
    e2 = np.where(lane < 16, 2 * lane + 1, 2 * lane - 32)

    def butterfly(t, a, b_):
        """v1 = min(a + f1, b + f2), v2 = min(a + f2, b + f1) at step t
        [B, BPL, 32], the candidates without the relu sums (f2 the sum
        less f1 for n > 4)."""
        x = q[:, t, None, None, :]
        f1 = (x * m1).sum(-1)
        f2 = (x * m2).sum(-1) if n <= 4 else q[:, t].sum(-1)[:, None,
                                                             None] - f1
        return np.minimum(a + f1, b_ + f2), np.minimum(a + f2, b_ + f1)

    def fstep(t, R):
        """The forward: the butterflies, K4's two shuffles, the parity
        selects (none where swapped)."""
        v1, v2 = butterfly(t, R[:, :BPL], R[:, BPL:])
        out = np.empty_like(R)
        for i in range(BPL):
            x1, x2 = v1[:, i, src1], v2[:, i, src2]
            out[:, 2 * i] = x1 if swap else np.where(odd, x2, x1)
            out[:, 2 * i + 1] = x2 if swap else np.where(odd, x1, x2)
        return out

    def bstep(t, R):
        """Beta: the two shuffles that gather beta(2b), beta(2b + 1) (even
        lanes send slot 2j first, odd ones slot 2j + 1; as they are where
        swapped), then the butterflies in natural order."""
        x1 = np.empty((B, BPL, 32), np.int64)
        x2 = np.empty_like(x1)
        for j in range(BPL):
            p, r = R[:, 2 * j], R[:, 2 * j + 1]
            s1 = p if swap else np.where(odd, r, p)
            s2 = r if swap else np.where(odd, p, r)
            x1[:, j], x2[:, j] = s1[:, e1], s2[:, e2]
        v1, v2 = butterfly(t, x1, x2)
        return np.concatenate([v1, v2], axis=1)

    # Forward: checkpoints of alpha' at every chunk start.
    R = np.broadcast_to(np.where(held == spec.starting_state, 0, BIG),
                        (B, 2 * BPL, 32)).astype(np.int64)
    nC = -(-T // CHUNK)
    ckpt = []
    for c in range(nC):
        ckpt.append(R.copy())
        if c == nC - 1:
            break
        for s in range(CHUNK):
            R = fstep(c * CHUNK + s, R)

    # Backward: each chunk replayed from its checkpoint (into registers:
    # 32 steps, those past T from stale inputs), beta back through its
    # steps, the emit.
    beta = np.where((held != spec.starting_state) & terminated, BIG, 0)
    beta = np.broadcast_to(beta, (B, 2 * BPL, 32)).astype(np.int64)
    out = np.empty((B, T), np.int64)
    stale = np.random.default_rng(T).integers(-127, 128, (CHUNK, B, n))
    for c in reversed(range(nC)):
        t0 = c * CHUNK
        steps = min(CHUNK, T - t0)
        R = ckpt[c]
        alpha = []
        for s in range(CHUNK if regs else steps):
            if s < steps:
                R = fstep(t0 + s, R)
            else:  # a stale input: its alpha' is never read
                R = R + stale[s].sum(-1)[:, None, None]
            alpha.append(R)
        for s in reversed(range(steps)):
            v = (alpha[s] + beta).min(axis=1)                 # [B, 32]
            m0 = np.where(odd, INT_MAX, v).min(axis=1)
            m1_ = np.where(odd, v, INT_MAX).min(axis=1)
            out[:, t0 + s] = m1_ - m0
            beta = bstep(t0 + s, beta)
    assert np.abs(out).max(initial=0) < 2 ** 31
    return out.astype(np.int32)


_CODES = {64: (0o171, 0o133, 0o165, 0o117, 0o127),
          128: (0o247, 0o371, 0o331, 0o235, 0o313)}
_CASES = [(NS, n) for NS in (64, 128) for n in (1, 2, 5)]


@pytest.mark.parametrize("NS,n", _CASES, ids=[f"NS{ns}-n{n}"
                                              for ns, n in _CASES])
def test_maxlogmap_schedule_model_matches_the_scans(NS, n):
    """The kernel's schedule gives the port's scan and the JAX scan bit for
    bit at T = 31, 32, 33 and 65 (within a checkpoint, one, one and a
    step, two and a step), terminated and not, on LLRs over the whole
    int8 range (-128 floored), 20% of them erased."""
    K = NS.bit_length()
    g = _CODES[NS][:n]
    spec, rspec = port.CodeSpec(K=K, g=g), ref.CodeSpec(K=K, g=g)
    rng = np.random.default_rng(NS + n)
    for T in (31, 32, 33, 65):
        q = rng.integers(-128, 128, (2, T, n))
        q = np.where(rng.random(q.shape) < 0.2, 0, q).astype(np.int32)
        floored = np.maximum(q, -127)
        for terminated in (True, False):
            got = _model(spec, q, terminated)
            want = port_map.maxlogmap_llrs(spec, torch.from_numpy(floored),
                                           terminated).numpy()
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(
                got, kmap.maxlogmap_llrs_batch_kernel(
                    spec, torch.from_numpy(q.astype(np.int8)), terminated,
                    device="cpu").numpy())
            np.testing.assert_array_equal(got, np.asarray(
                ref_map.maxlogmap_llrs_batch(rspec, floored, terminated)))
