"""The narrow forward's schedule (csrc/acs_soft_k1.cu, one template for
`acs_soft_k1_forward` and `acs_k1_forward` at NS = 64, 128 and 256, n =
1..8: TPU kernels `acs_forward_batch_swar_soft` and `_soft8`, K4 and K3,
and `acs_forward_batch_swar`, K1), modelled in numpy as the kernel is
built, against the port's plain soft and hard forwards and the JAX
package's soft and hard butterfly scans.

The kernel runs only on the card, where chip_smoke.py holds it to the plain
version; here a model done the way the kernel does it is held bit for bit
to that plain version: lanes as a numpy axis, each block of 32 steps staged
by the lane of its step (clamped once, the n bytes packed, the step's LLR
sum beside them; the stale entries of the lanes past T filled at random),
for n <= 4 each candidate the source's metric plus the dot product of the
packed bytes with the lane's 0/1 byte masks of the edge's 1 or 0 bits
(`__dp4a` with the metric as accumulator), for n > 4 em as such a dot
product and emc the step's sum less em, with em and emc fixed per lane
(codes complemented on lanes 16-31), so every metric runs offset by the
step's sum(relu(-q)), which the staging lanes add up and the warp adds back
to the final metrics; two shuffles a butterfly; each destination's
decisions of a step one ballot, kept in the warp's row buffer and put into
the row layout by lane s after the block.  Hard: each staging lane's
segment byte (stale past T, at random) becomes the bytes of the LLRs
1 - 2 bit (0x01 or 0xFF) for its n bits, their sum n - 2 popcount, and
the popcount is the dropped sum; the step is the soft one.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import convolutionalencdec_tpu as ref
from convolutionalencdec_tpu.ops import metrics as ref_metrics
from convolutionalencdec_tpu.ops import viterbi as ref_viterbi

import convolutionalencdec_tpu_torch as port
from convolutionalencdec_tpu_torch.kernels import acs
from convolutionalencdec_tpu_torch.ops.trellis import butterfly_coded_bits
from convolutionalencdec_tpu_torch.ops.viterbi import init_metric_value

ROOT = Path(__file__).resolve().parent.parent
SOURCE = ROOT / "convolutionalencdec_tpu_torch" / "csrc" / "acs_soft_k1.cu"


def _smoke():
    """chip_smoke.py, whose reader of the kernel's NS switch the test
    shares."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


_SMOKE = _smoke()

LANE = np.arange(32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _spec(NS, n, rng):
    """A random poly-symmetric code with NS states and n generators."""
    K = NS.bit_length()
    return port.CodeSpec(K=K, g=tuple(
        (1 << (K - 1)) | 1 | (int(rng.integers(0, 1 << (K - 2))) << 1)
        for _ in range(n)))


def _ballot(pred):
    """[..., 32] bool -> [...] uint32 ballot words, bit l from lane l."""
    return (pred.astype(np.uint64) << LANE.astype(np.uint64)).sum(
        -1).astype(np.uint32)


def _rows(d1, d2):
    """The kernel's rows from a step's ballots [..., BPL] of the first and
    the second shuffle's destinations: word j the even destinations (d1's
    lanes 0-15, d2's lanes 16-31: `__byte_perm(d1, d2, 0x7610)`), word
    BPL + j the odd ones -> [..., W]."""
    lo16, hi16 = np.uint32(0xFFFF), np.uint32(0xFFFF0000)
    return np.concatenate([(d1 & lo16) | (d2 & hi16),
                           (d2 & lo16) | (d1 & hi16)], -1)


def _model_forward(spec, inp, qlo, qclip, init, rng, hard=False):
    """The kernel's schedule on every channel of int8 LLRs inp [B, T, n]
    or, `hard`, uint8 segments inp [B, T]: (decision words uint32
    [B, T, W], final metrics int64 [B, NS])."""
    NS, n = spec.num_states, spec.n
    BPL, W = NS // 64, NS // 32
    NP = 1 if n <= 4 else 2
    B, T = inp.shape[:2]
    upper = LANE >= 16
    odd = (LANE & 1).astype(bool)
    cb = butterfly_coded_bits(spec).astype(np.uint32)
    code = np.stack([np.where(upper, ~cb[32 * j + LANE], cb[32 * j + LANE])
                     for j in range(BPL)])                    # [BPL, 32]
    m1 = np.zeros((BPL, 32, 4 * NP), np.int64)  # f1's bits as 0/1 bytes
    for i in range(n):
        m1[..., i] = (code >> i) & 1
    m2 = np.where(np.arange(4 * NP) < n, 1 - m1, 0)  # f2's: the 0 bits
    if init is None:
        iv = init_metric_value(spec)
        lo = np.broadcast_to(np.stack([np.where(32 * j + LANE == 0, 0, iv)
                                       for j in range(BPL)]), (B, BPL, 32))
        hi = np.full((B, BPL, 32), iv, np.int64)
    else:
        m = init.astype(np.int64)
        lo, hi = m[:, :NS // 2].reshape(B, BPL, 32), m[:, NS // 2:].reshape(
            B, BPL, 32)
    src1 = np.where(odd, 16, 0) + (LANE >> 1)
    src2 = src1 ^ 16
    words = np.zeros((B, T, W), np.uint32)
    drop = np.zeros((B, 32), np.int64)
    # A lane past T keeps the raw inputs of an earlier block.
    used = np.arange(4 * NP) < n
    if hard:
        raw = rng.integers(0, 256, (B, 32))
    else:
        raw = rng.integers(-128, 128, (B, 32, 4 * NP))
    for t0 in range(0, T, 32):
        steps = min(32, T - t0)
        if hard:   # bit i of the segment as the LLR 1 - 2 bit
            raw[:, :steps] = inp[:, t0:t0 + steps]
            r = raw & ((1 << n) - 1)
            bits = (r[..., None] >> np.arange(4 * NP)) & 1
            qc = np.where(used, 1 - 2 * bits, 0)               # [B, 32, 4NP]
            neg = ((r[..., None] >> np.arange(8)) & 1).sum(-1)  # popcount
        else:
            raw[:, :steps, :n] = inp[:, t0:t0 + steps]
            qc = np.where(used, np.clip(raw, qlo, qclip), 0)   # [B, 32, 4NP]
            neg = np.maximum(-qc, 0).sum(-1)
        packed = qc.astype(np.int8)                            # the bytes
        total = qc.sum(-1)
        if hard:
            np.testing.assert_array_equal(total, n - 2 * neg)
        drop += np.where(LANE < steps, neg, 0)
        rowbuf = rng.integers(0, 2 ** 32, (B, 32, 2, BPL)).astype(np.uint32)
        for s in range(steps):
            x = packed[:, s].astype(np.int64)[:, None, None, :]
            if NP == 1:    # each candidate one __dp4a onto its metric
                u1, w1 = lo + (x * m1).sum(-1), hi + (x * m2).sum(-1)
                u2, w2 = lo + (x * m2).sum(-1), hi + (x * m1).sum(-1)
            else:          # em by __dp4a, emc = the step's sum - em
                f1 = (x * m1).sum(-1)
                f2 = total[:, s, None, None] - f1
                u1, w1, u2, w2 = lo + f1, hi + f2, lo + f2, hi + f1
            rowbuf[:, s, 0] = _ballot(u1 > w1)                 # by lane 0
            rowbuf[:, s, 1] = _ballot(u2 > w2)
            x1 = np.minimum(u1, w1)[..., src1]
            x2 = np.minimum(u2, w2)[..., src2]
            nxt = np.stack([np.where(odd, x2, x1), np.where(odd, x1, x2)],
                           2).reshape(B, 2 * BPL, 32)
            lo, hi = nxt[:, :BPL], nxt[:, BPL:]
            for m in (lo, hi):
                assert np.all((m >= -2 ** 31) & (m < 2 ** 31))
        # Lane s reads step s's ballots and stores its row.
        words[:, t0:t0 + steps] = _rows(rowbuf[:, :steps, 0],
                                        rowbuf[:, :steps, 1])
    dropped = drop.sum(1)[:, None]
    final = np.concatenate([lo.reshape(B, -1), hi.reshape(B, -1)], 1)
    return words, final + dropped


def _draw(rng, B, T, n):
    """int8 LLRs over the whole range, -128 and +-127 among them."""
    q = rng.integers(-128, 128, (B, T, n)).astype(np.int8)
    q.reshape(-1)[::13] = -128
    q.reshape(-1)[5::17] = 127
    return q


#: (qclip, floor, initial metrics given): the 8-bit route's clip to 7, the
#: block routes' -127 floor from carried metrics, the tail-biting route's
#: -128 from the uniform start and from carried metrics.
CONDITIONS = [(7, True, False), (127, True, True), (127, False, False),
              (127, False, True)]
MODEL_T = (0, 1, 31, 32, 33, 192, 288)
MODEL_CASES = [(NS, n) for NS in (64, 128, 256) for n in (1, 2, 3, 5, 8)]


@pytest.mark.parametrize("NS,n", MODEL_CASES,
                         ids=[f"NS{ns}-n{n}" for ns, n in MODEL_CASES])
def test_soft_forward_schedule_model_matches_plain_and_jax(NS, n):
    """The model of the kernel's schedule (staged packed bytes, the dp4a
    candidates (n <= 4) or em and emc = sum - em (n > 4), the per-step
    offset and its restoration in the final metrics, the fixed em/emc
    roles and the two-shuffle permutation, ballots into rows) gives the
    plain soft forward's words and final metrics at T = 0, 1, 31, 32, 33,
    192, 288 under the clip to 7, the -127 floor and the -128 route, from
    the default start and from carried metrics; and the JAX soft scan's on
    the conditioned LLRs (it takes no initial metrics)."""
    rng = np.random.default_rng(NS * 10 + n)
    spec = _spec(NS, n, rng)
    rspec = ref.CodeSpec(K=spec.K, g=spec.g)
    B = 3
    for T in MODEL_T:
        q = _draw(rng, B, T, n)
        for qclip, floor, given in CONDITIONS:
            qlo = acs._qlo(qclip, floor)
            init = None
            if given:
                init = rng.integers(0, 6000, (B, NS)).astype(np.int32)
            words, final = _model_forward(spec, q, qlo, qclip, init, rng)
            want_w, want_m = acs.acs_forward_batch_soft_plain(
                spec, _t(q), qclip, None if init is None else _t(init),
                floor)
            what = f"T={T} qclip={qclip} floor={floor} init={given}"
            np.testing.assert_array_equal(
                words, want_w.numpy().view(np.uint32), err_msg=what)
            np.testing.assert_array_equal(final, want_m.numpy(),
                                          err_msg=what)
            if given or T not in (1, 33):
                continue
            qc = np.clip(q.astype(np.int32), qlo, qclip)
            dec, fm = jax.vmap(lambda x: ref_metrics.viterbi_forward_butterfly_soft(
                rspec, x))(jnp.asarray(qc))
            np.testing.assert_array_equal(
                words, acs.pack_decisions(spec, _t(np.asarray(dec)))
                .numpy().view(np.uint32), err_msg=what + " JAX")
            np.testing.assert_array_equal(final, np.asarray(fm),
                                          err_msg=what + " JAX")


#: The hard template's cases: each NS, one and two packed registers.
HARD_CASES = [(64, 2), (64, 6), (128, 3), (256, 8)]
HARD_T = (0, 1, 31, 33, 70)


@pytest.mark.parametrize("NS,n", HARD_CASES,
                         ids=[f"NS{ns}-n{n}" for ns, n in HARD_CASES])
def test_hard_forward_schedule_model_matches_plain_and_jax(NS, n):
    """The model of the kernel's schedule on hard segments (each bit as the
    LLR 1 - 2 bit, the segment's popcount dropped a step and restored in
    the final metrics, the soft step) gives the plain hard forward's words
    and final metrics at T = 0, 1, 31, 33, 70 from the default start and
    from carried metrics, segments with bits above n set; and the JAX
    hard butterfly scan's at T = 33 from the default start (at NS = 128
    also from carried metrics)."""
    rng = np.random.default_rng(NS * 100 + n)
    spec = _spec(NS, n, rng)
    rspec = ref.CodeSpec(K=spec.K, g=spec.g)
    B = 3
    for T in HARD_T:
        seg = rng.integers(0, 256, (B, T)).astype(np.uint8)
        for given in (False, True):
            init = None
            if given:
                init = rng.integers(0, 6000, (B, NS)).astype(np.int32)
            words, final = _model_forward(spec, seg, 0, 0, init, rng,
                                          hard=True)
            # The plain forward and the JAX scan index their tables by
            # the segment: its n bits.
            clean = seg & ((1 << n) - 1)
            want_w, want_m = acs.acs_forward_batch_plain(
                spec, _t(clean), None if init is None else _t(init))
            what = f"T={T} init={given}"
            np.testing.assert_array_equal(
                words, want_w.numpy().view(np.uint32), err_msg=what)
            np.testing.assert_array_equal(final, want_m.numpy(),
                                          err_msg=what)
            if T != 33 or (given and NS != 128):
                continue
            if given:
                dec, fm = jax.vmap(
                    lambda x, m: ref_viterbi.viterbi_forward_butterfly(
                        rspec, x, m))(jnp.asarray(clean), jnp.asarray(init))
            else:
                dec, fm = jax.vmap(
                    lambda x: ref_viterbi.viterbi_forward_butterfly(
                        rspec, x))(jnp.asarray(clean))
            np.testing.assert_array_equal(
                words, acs.pack_decisions(spec, _t(np.asarray(dec)))
                .numpy().view(np.uint32), err_msg=what + " JAX")
            np.testing.assert_array_equal(final, np.asarray(fm),
                                          err_msg=what + " JAX")


def test_soft_forward_ballot_rows_are_the_word_layout():
    """A step's ballots put into rows as the kernel does (the first
    shuffle's destinations are the even states on lanes 0-15 and the odd
    ones on lanes 16-31) give `pack_decisions`' words: the decision of
    state 2b + p at bit i % 32 of word i / 32, i = p NS/2 + b."""
    rng = np.random.default_rng(5)
    for NS in (64, 128, 256):
        BPL = NS // 64
        spec = port.CodeSpec(K=NS.bit_length(), g=(
            (1 << NS.bit_length() - 1) | 1,) * 2)
        dec = rng.integers(0, 2, (3, 4, NS)).astype(np.uint8)  # [B, T, NS]
        b = 32 * np.arange(BPL)[:, None] + LANE                # [BPL, 32]
        p_first = (LANE >= 16).astype(int)     # the first shuffle's parity
        d1 = _ballot(dec[..., 2 * b + p_first].astype(bool))
        d2 = _ballot(dec[..., 2 * b + 1 - p_first].astype(bool))
        want = acs.pack_decisions(spec, _t(dec)).numpy().view(np.uint32)
        np.testing.assert_array_equal(_rows(d1, d2), want)


def test_soft_forward_source_matches_the_model():
    """The facts the model takes from csrc/acs_soft_k1.cu: the candidates
    as __dp4a onto the source metrics (n <= 4), the ballots kept by lane 0
    and put into rows by the byte permute, one template a packed-register
    count (n <= 4 and n = 5..8) at each of NS = 64, 128, 256 for each of
    the hard and soft entries, a hard segment's bits as the bytes of 1 - 2
    bit and its popcount dropped, and the final metrics stored with the
    dropped sums added back; the hard forward's old loop (csrc/acs_k1.cu)
    is gone."""
    src = SOURCE.read_text()
    for cand in ("u1 = __dp4a(in.x, (int)m1[j], lo[j])",
                 "w1 = __dp4a(in.x, (int)m2[j], hi[j])",
                 "u2 = __dp4a(in.x, (int)m2[j], lo[j])",
                 "w2 = __dp4a(in.x, (int)m1[j], hi[j])",
                 "const int f2 = in.z - f1;"):
        assert cand in src
    assert "wd[j] = __byte_perm(d1s[j], d2s[j], 0x7610)" in src
    assert "wd[BPL + j] = __byte_perm(d2s[j], d1s[j], 0x7610)" in src
    assert "if (lane == 0) {" in src and "d1s[j] = rowbuf[lane][j]" in src
    assert "launch<BPL, kHard, 1>(a, s)" in src
    assert "launch<BPL, kHard, 2>(a, s)" in src
    assert _SMOKE.soft_forward_lines() == [(64, 1), (128, 2), (256, 4)]
    assert "return launch_forward<true>(NS, a," in src
    assert "return launch_forward<false>(NS, a," in src
    assert "const unsigned q = 1u + 0xFEu * ((r >> i) & 1u);" in src
    assert "neg = __popc(r);" in src and "sum = n - 2 * neg;" in src
    assert not (SOURCE.parent / "acs_k1.cu").exists()
    assert _SMOKE.SOURCES["acs_k1_forward"][0].endswith("csrc/acs_soft_k1.cu")
    assert "lo[j] + dropped" in src and "hi[j] + dropped" in src
    assert acs._forward_kernel(port.NASA_K7, True) == "acs_soft_k1_forward"
    assert acs._forward_kernel(port.NASA_K7, False) == "acs_k1_forward"
