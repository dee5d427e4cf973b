"""The port's decodes of wide butterfly codes (NS = 512 ... 16384, K = 10
... 15) and the JAX names of the fused kernels (TPU kernel K11) on the CPU,
where each kernel wrapper takes its plain version (the CUDA kernels run
only on the card, where chip_smoke.py holds them to these plain versions).

Every entry the wide codes now reach on the card (block bits and bytes,
soft, punctured, ragged, and the tail-biting wrap and list decodes) is held
bit for bit against the JAX package's scans on noisy, garbage (tie-heavy)
and -128 inputs; the K11 names' layouts (`init_chunk` 0 / -1 / 1, the
`gmask` prefix rule) against the port's plain forward and traceback; and
one chain of the JAX package's fused kernels (forward, then traceback) in
interpret mode against the port's names; numpy models of the wide
forwards' round schedules (csrc/acs_wide.cu) against the port's plain
forwards; and a numpy model of the four wide walks (terminated, masked,
ragged and list; csrc/traceback_wide.cu) against the port's plain walks.
"""

import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

import convolutionalencdec_tpu as ref
from convolutionalencdec_tpu.kernels import acs_pallas as ref_acs
from convolutionalencdec_tpu.kernels import tailbiting as ref_ktb
from convolutionalencdec_tpu.ops import metrics as ref_metrics
from convolutionalencdec_tpu.ops import puncture as ref_puncture
from convolutionalencdec_tpu.ops import tailbiting as ref_tb
from convolutionalencdec_tpu.ops import viterbi as ref_viterbi

import convolutionalencdec_tpu_torch as port
from convolutionalencdec_tpu_torch import kernels
from convolutionalencdec_tpu_torch.kernels import acs, fused
from convolutionalencdec_tpu_torch.kernels import tailbiting as ktb
from convolutionalencdec_tpu_torch.ops.trellis import butterfly_coded_bits
from convolutionalencdec_tpu_torch.ops.viterbi import init_metric_value

# K = 10 (NS = 512, the first wide size), 11, and 15 (NS = 16384, the
# rate-1/4 code of the Galileo experiment, the widest the kernels take); a
# rate-1/5 K=10 code (n >= 5: the JAX package floors -128 on its routes);
# the n = 6, NS = 64 code of the interpreted fused-kernel chain.
CODES = {
    "K10": dict(K=10, g=(0o1167, 0o1545)),
    "K11": dict(K=11, g=(0o2365, 0o3173)),
    "K15": dict(K=15, g=(0o46321, 0o51271, 0o63667, 0o70535)),
    "K10_n5": dict(K=10, g=(0o1167, 0o1545, 0o1337, 0o1071, 0o1423)),
    "K7_n6": dict(K=7, g=(0o133, 0o171, 0o165, 0o117, 0o127, 0o155)),
}
B, L = 3, 50


def _specs(name):
    return ref.CodeSpec(**CODES[name]), port.CodeSpec(**CODES[name])


def _segments(spec, kind, seed, B=B, L=L):
    """uint8 segments [B, L + S]: encoded and hit at 8% by nonzero XOR
    masks, or uniform garbage (tie-heavy)."""
    rng = np.random.default_rng(seed)
    msgs = rng.integers(0, 2, (B, L), dtype=np.uint8)
    coded = port.encode_bits(spec, torch.from_numpy(msgs))[0].numpy().copy()
    if kind == "garbage":
        return rng.integers(0, 1 << spec.n, coded.shape).astype(np.uint8)
    hit = rng.random(coded.shape) < 0.08
    return coded ^ (hit * rng.integers(1, 1 << spec.n, coded.shape)).astype(
        np.uint8)


def _llrs(spec, coded, kind, seed):
    """int8 LLRs [B, T, n]: signs from the coded bits, magnitudes 1..7 with
    6% flips and 5% erasures; or full int8 with -128."""
    rng = np.random.default_rng(seed)
    shape = coded.shape + (spec.n,)
    if kind == "int8":
        return rng.integers(-128, 128, shape).astype(np.int8)
    planes = np.stack([(coded >> j) & 1 for j in range(spec.n)], -1)
    q = (1 - 2 * planes.astype(np.int32)) * rng.integers(1, 8, shape)
    q = np.where(rng.random(shape) < 0.06, -q, q)
    return np.where(rng.random(shape) < 0.05, 0, q).astype(np.int8)


def _floored(q):
    return np.maximum(q.astype(np.int32), -127)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("kind", ["noisy", "garbage"])
@pytest.mark.parametrize("name", ["K10", "K11", "K15"])
def test_hard_entries_match_vmapped_scan(name, kind):
    ref_spec, spec = _specs(name)
    assert kernels.select_kernel(spec) == kernels.BUTTERFLY
    coded = _segments(spec, kind, 3)
    want = np.asarray(jax.vmap(lambda c: ref.viterbi_decode(ref_spec, c))(
        coded))
    seg = _t(coded)
    np.testing.assert_array_equal(
        kernels.viterbi_decode_batch(spec, seg).numpy(), want)
    np.testing.assert_array_equal(
        kernels.viterbi_decode_batch_bytes(spec, seg, L - 3).numpy(),
        np.packbits(want[:, :L - 3], axis=1))


@pytest.mark.parametrize("kind", ["noisy", "int8"])
@pytest.mark.parametrize("name", ["K10", "K15", "K10_n5"])
def test_soft_entries_match_vmapped_scan(name, kind):
    """The block routes floor -128 at -127 and, the 8-bit rule failing,
    clip nothing else."""
    ref_spec, spec = _specs(name)
    assert kernels.select_kernel(spec, "soft") == kernels.SOFT
    q = _llrs(spec, _segments(spec, "noisy", 5), kind, 6)
    want = np.asarray(jax.vmap(
        lambda x: ref.viterbi_decode_soft(ref_spec, x))(_floored(q)))
    np.testing.assert_array_equal(
        kernels.viterbi_decode_batch_soft(spec, _t(q)).numpy(), want)
    np.testing.assert_array_equal(
        kernels.viterbi_decode_batch_soft_bytes(spec, _t(q)).numpy(),
        np.packbits(want, axis=1))


def test_punctured_and_ragged_entries_match_reference():
    ref_spec, spec = _specs("K11")
    coded = _segments(spec, "noisy", 7)
    T = coded.shape[1]
    pattern = port.ops.puncture.PUNCTURE_2_3
    q = _llrs(spec, coded, "int8", 8).reshape(B, T * spec.n)
    q_rx = np.array(ref_puncture.puncture_bits(q, pattern, T))
    full = np.asarray(ref_puncture.depuncture_llrs(q_rx, pattern, T))
    want = np.asarray(jax.vmap(lambda x: ref.viterbi_decode_soft(
        ref_spec, x))(_floored(full).reshape(B, T, spec.n)))
    got = kernels.viterbi_decode_batch_punctured_soft(spec, _t(q_rx),
                                                      pattern, T)
    np.testing.assert_array_equal(got.numpy(), want)
    lens = np.array([spec.S + 1, 17, T], np.int32)
    want = np.asarray(ref_viterbi.viterbi_decode_ragged(ref_spec, coded,
                                                        lens))
    np.testing.assert_array_equal(
        kernels.viterbi_decode_batch_bytes_ragged(spec, _t(coded),
                                                  _t(lens)).numpy(),
        np.packbits(want, axis=1))
    q = _llrs(spec, coded, "int8", 9)
    want = np.asarray(ref_metrics.viterbi_decode_ragged_soft(
        ref_spec, np.maximum(q, -127), lens))
    np.testing.assert_array_equal(
        kernels.viterbi_decode_batch_soft_bytes_ragged(spec, _t(q),
                                                       _t(lens)).numpy(),
        np.packbits(want, axis=1))


def _tailbiting(ref_spec, spec, seed, T=40):
    rng = np.random.default_rng(seed)
    msgs = rng.integers(0, 2, (B, T), dtype=np.uint8)
    coded = np.asarray(ref_tb.encode_tailbiting(ref_spec, msgs)).copy()
    hit = rng.random(coded.shape) < 0.05
    return coded ^ (hit * rng.integers(1, 1 << spec.n, coded.shape)).astype(
        np.uint8)


@pytest.mark.parametrize("name", ["K10", "K10_n5"])
def test_tailbiting_wrap_matches_reference_scans(name):
    """The wrap decode, hard and soft, at the kernel wraps.  -128 follows
    the JAX route: kept for n <= 4 (its 16-bit SWAR route), floored for
    n >= 5 (its fused int32 kernel)."""
    ref_spec, spec = _specs(name)
    coded = _tailbiting(ref_spec, spec, 11)
    wraps = ktb.kernel_wraps(spec, 40)
    assert wraps == ref_ktb.kernel_wraps(ref_spec, 40)
    want = np.asarray(jax.vmap(lambda c: ref_tb.viterbi_decode_tailbiting(
        ref_spec, c, wraps))(coded))
    np.testing.assert_array_equal(
        ktb.viterbi_decode_batch_tailbiting(spec, _t(coded)).numpy(), want)
    q = _llrs(spec, coded, "int8", 12)
    keeps = spec.n <= 4
    assert kernels.swar_layout_supported(spec) == keeps
    used = q.astype(np.int32) if keeps else _floored(q)
    want = np.asarray(jax.vmap(lambda x: ref_tb.viterbi_decode_tailbiting_soft(
        ref_spec, x, wraps))(used))
    got = ktb.viterbi_decode_batch_tailbiting_soft_bytes(spec, _t(q),
                                                         qmax=127)
    np.testing.assert_array_equal(got.numpy(), np.packbits(want, axis=1))


def test_tailbiting_list_matches_reference_scans():
    ref_spec, spec = _specs("K11")
    coded = _tailbiting(ref_spec, spec, 13, T=48)
    wl = ktb.list_wrap(spec, 48)
    got_b, got_m = ktb.viterbi_decode_batch_tailbiting_list(spec, _t(coded),
                                                            4)
    want_b, want_m = jax.vmap(lambda c: ref_tb.viterbi_decode_tailbiting_list(
        ref_spec, c, 4, wl))(coded)
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))
    want_m = np.asarray(want_m)
    np.testing.assert_array_equal(got_m.numpy(), want_m - want_m[:, :1])
    q = _llrs(spec, coded, "noisy", 14)
    got_b, _ = ktb.viterbi_decode_batch_tailbiting_list_soft(spec, _t(q), 3)
    want_b, _ = jax.vmap(lambda x: ref_tb.viterbi_decode_tailbiting_list_soft(
        ref_spec, x, 3, wl))(q.astype(np.int32))
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))


def test_wide_layout_round_trip():
    """W = NS/32 = 512 words per step at NS = 16384: bit p * NS/2 + b of
    the step's words for state 2b + p; unpack inverts pack."""
    _, spec = _specs("K15")
    NS = spec.num_states
    assert acs.decision_words(spec) == 512
    dec = torch.from_numpy(np.random.default_rng(15).integers(
        0, 2, (2, 3, NS), dtype=np.uint8))
    words = acs.pack_decisions(spec, dec)
    assert words.shape == (2, 3, 512) and words.dtype == torch.int32
    w = words.to(torch.int64) & 0xFFFFFFFF
    for s in (0, 1, 2, 3, 8191, 8192, NS - 2, NS - 1):
        i = (s >> 1) + (s & 1) * NS // 2
        assert torch.equal((w[..., i // 32] >> (i % 32)) & 1,
                           dec[..., s].to(torch.int64)), s
    assert torch.equal(acs.unpack_decisions(spec, words), dec)


def test_routes_of_wide_and_past_codes():
    for name in ("K10", "K11", "K15"):
        spec = _specs(name)[1]
        assert acs.kernel_supports(spec) and acs.kernel_supports(spec, "soft")
        assert acs._forward_kernel(spec, False) == "acs_wide_forward"
        assert acs._walk_kernel(spec, "_multi") == "traceback_wide_multi"
    # n = 9: soft on the wide forward's runtime-n instantiation at any NS;
    # no hard segment holds it.
    n9 = port.CodeSpec(K=7, g=(0o133, 0o171, 0o165, 0o117, 0o127, 0o155,
                               0o133, 0o171, 0o165))
    assert kernels.select_kernel(n9, "soft") == kernels.SOFT
    assert kernels.select_kernel(n9) == kernels.GENERIC
    # Given a length, codes the JAX package's SWAR kernels reject (n >= 5)
    # take the single pass while T_pad * NS/8 <= 32 KiB (K10_n5: T_pad
    # <= 480; n9 at NS = 64: T_pad <= 4080), the two-pass route past it;
    # n <= 4 codes never; a hard n9 decode has no segment to take.
    k10_n5 = _specs("K10_n5")[1]
    for spec, top in ((k10_n5, 480), (n9, 4080)):
        assert kernels.select_kernel(spec, "soft", T=top) == \
            kernels.SINGLE_PASS
        assert kernels.select_kernel(spec, "soft", T=top + 1) == kernels.SOFT
    assert kernels.select_kernel(k10_n5, T=480) == kernels.SINGLE_PASS
    assert kernels.select_kernel(k10_n5, T=481) == kernels.BUTTERFLY
    assert kernels.select_kernel(n9, T=100) == kernels.GENERIC
    for name in ("K10", "K11", "K15"):
        for mode in ("hard", "soft"):
            assert kernels.select_kernel(_specs(name)[1], mode, T=48) != \
                kernels.SINGLE_PASS
    assert acs._forward_kernel(n9, True) == "acs_soft_wide_forward"
    assert acs._forward_kernel(port.NASA_K7, True) == "acs_soft_k1_forward"
    assert acs._forward_kernel(port.K5_23_35, False) == "acs_small_forward"
    k16 = port.CodeSpec(K=16, g=(0o104723, 0o153545))
    assert not acs.kernel_supports(k16, "soft")
    with pytest.raises(NotImplementedError, match="16384"):
        acs.acs_forward_batch(k16, torch.zeros((1, 20), dtype=torch.uint8))


def test_fused_names_init_chunk():
    """0: the standard start; -1: uniform; 1: uniform, the standard metrics
    applied at step 48.  Final metrics less each channel's minimum."""
    _, spec = _specs("K10")
    seg = _t(_segments(spec, "noisy", 21, L=96 - spec.S))
    zero = torch.zeros((B, spec.num_states), dtype=torch.int32)

    def rel(m):
        return m - m.min(dim=1, keepdim=True).values

    words, fm = fused.acs_forward_batch_fused(spec, seg)
    want_w, want_m = acs.acs_forward_batch_plain(spec, seg)
    assert torch.equal(words, want_w) and torch.equal(fm, rel(want_m))
    assert int(fm.min(dim=1).values.abs().sum()) == 0
    words, fm = fused.acs_forward_batch_fused(spec, seg, -1)
    want_w, want_m = acs.acs_forward_batch_plain(spec, seg, zero)
    assert torch.equal(words, want_w) and torch.equal(fm, rel(want_m))
    words, fm = fused.acs_forward_batch_fused(spec, seg, 1)
    head, _ = acs.acs_forward_batch_plain(spec, seg[:, :48], zero)
    tail, tail_m = acs.acs_forward_batch_plain(spec, seg[:, 48:].contiguous())
    assert torch.equal(words, torch.cat([head, tail], dim=1))
    assert torch.equal(fm, rel(tail_m))
    q = _t(_llrs(spec, seg.numpy(), "int8", 22))
    words, fm = fused.acs_forward_batch_fused_soft(spec, q, 1)
    head, _ = acs.acs_forward_batch_soft_plain(spec, q[:, :48], 127, zero)
    tail, tail_m = acs.acs_forward_batch_soft_plain(
        spec, q[:, 48:].contiguous(), 127)
    assert torch.equal(words, torch.cat([head, tail], dim=1))
    assert torch.equal(fm, rel(tail_m))


def test_fused_tracebacks_and_gmask_rule():
    _, spec = _specs("K11")
    T = 64
    seg = _t(_segments(spec, "noisy", 31, L=T - 4 - spec.S))
    seg = torch.cat([seg, torch.zeros((B, 4), dtype=torch.uint8)], dim=1)
    t_actual = T - 4
    words, _ = fused.acs_forward_batch_fused(spec, seg)
    rows = fused.traceback_batch_fused(spec, words, t_actual)
    assert rows.shape == (T // 8, B) and rows.dtype == torch.uint8
    bits = np.zeros((B, T), np.uint8)
    bits[:, :t_actual - spec.S] = kernels.viterbi_decode_batch(
        spec, seg[:, :t_actual]).numpy()
    np.testing.assert_array_equal(
        rows.numpy(), np.packbits(bits, axis=1, bitorder="little").T)
    # The masked form: gmask a live prefix, a one-hot start per channel.
    gm = np.zeros((T // 8, 1), np.int32)
    gm[:5] = 0xFF
    gm[5] = 0b111
    assert fused.live_prefix(gm, T // 8) == 43
    assert fused.live_prefix(np.full((T // 8, 1), 0xFF), T // 8) == T
    starts = torch.tensor([0, 5, spec.num_states - 1], dtype=torch.int32)
    h = torch.zeros((spec.num_states, B), dtype=torch.uint8)
    h[starts.long(), torch.arange(B)] = 1
    rows = fused.traceback_batch_fused_masked(spec, words, gm, h)
    want = acs.traceback_batch_masked_plain(spec, words, starts, 43, T)
    np.testing.assert_array_equal(
        rows.numpy(), np.packbits(want.numpy(), axis=1, bitorder="little").T)
    for bad in ([0xFF, 0x0F, 0xFF], [0x7F, 0xFF], [0x05], [0xFF, 0x1FF],
                [0xFF, 0xFF, 0x80]):
        mask = np.zeros((T // 8, 1), np.int32)
        mask[:len(bad), 0] = bad
        with pytest.raises(ValueError, match="gmask"):
            fused.traceback_batch_fused_masked(spec, words, mask, h)
    with pytest.raises(ValueError, match="gmask"):
        fused.traceback_batch_fused_masked(spec, words, gm[:-1], h)
    with pytest.raises(ValueError, match="one-hot"):
        fused.traceback_batch_fused_masked(spec, words, gm, h * 2)
    with pytest.raises(ValueError, match="multiple of 8"):
        fused.traceback_batch_fused(spec, words[:, :60], 50)
    with pytest.raises(ValueError, match=">= 64 states"):
        fused.acs_forward_batch_fused(port.K5_23_35, seg)


def test_interpreted_fused_kernel_chain_matches():
    """One chain of the JAX package's fused kernels (K11) in interpret
    mode, on an n = 6, NS = 64 code (the JAX package sends n > 4 to them):
    `acs_forward_batch_fused` then `traceback_batch_fused`, against the
    port's names bit for bit (final metrics transposed)."""
    ref_spec, spec = _specs("K7_n6")
    Bp = ref_acs.B_TILE
    seg = _segments(spec, "noisy", 41, B=Bp, L=40)          # T = 46
    seg = np.concatenate([seg, np.zeros((Bp, 2), np.uint8)], axis=1)
    decs, fm = ref_acs.acs_forward_batch_fused(ref_spec, seg, True)
    rows = np.asarray(ref_acs.traceback_batch_fused(ref_spec, decs, 46, True))
    words, got_fm = fused.acs_forward_batch_fused(spec, _t(seg))
    np.testing.assert_array_equal(got_fm.numpy(), np.asarray(fm).T)
    np.testing.assert_array_equal(
        fused.traceback_batch_fused(spec, words, 46).numpy(), rows)


def _shfl_down(v, s):
    """__shfl_down_sync over warps of the last axis: lane l gets lane
    l + s's value, lanes past 31 keep their own."""
    w = v.reshape(v.shape[:-1] + (-1, 32))
    out = w.copy()
    out[..., :32 - s] = w[..., s:]
    return out.reshape(v.shape)


def _soft_tables(q, n, qlo, qclip):
    """The soft round kernel's per-step tables (`build_tables`) of int8
    LLRs q [B, T, n]: (lo [B, T, 16], hi [B, T, 16], Q [B, T]), lo[p] =
    base + the conditioned q_i of the set bits i < 4 of p, hi[p] = those of
    the set bits i - 4 of p, base = sum_i relu(-q_i), Q = sum_i |q_i|."""
    qc = np.clip(q.astype(np.int64), qlo, qclip)
    base = np.maximum(-qc, 0).sum(-1)
    s = np.arange(16)
    lo = np.broadcast_to(base[..., None], base.shape + (16,)).copy()
    hi = np.zeros_like(lo)
    for i in range(n):
        if i < 4:
            lo += ((s >> i) & 1) * qc[..., i:i + 1]
        else:
            hi += ((s >> (i - 4)) & 1) * qc[..., i:i + 1]
    return lo, hi, np.abs(qc).sum(-1)


def _round_model(NS, n, cb, seg, init, init_value, R, soft=None):
    """numpy model of csrc/acs_wide.cu's hard forward (`acs_round_kernel`),
    done the way the kernel does it: thread c owns closed group c, its 2^R
    metrics in registers idx = k*2^j + u; step j pairs registers i and
    i + 2^(R-1) (butterfly c*2^j + u + k*(NS >> (R - j))) and writes 2i,
    2i + 1; decisions as ballots (j = 0) or per-lane 2^j-bit nibbles joined
    by shfl_down into bytes and stored per lane; after R steps the
    destinations go to a swizzled shared buffer and come back as sources
    c + m*G; the last round runs T mod R steps.  With `soft` = (qlo, qclip)
    it models the soft one (`acs_soft_round_kernel`) on int8 LLRs seg
    [B, T, n]: the same rounds, each butterfly's edge metric read from its
    step's tables by its packed coded byte (n <= 4: the entry's byte
    offset; else lo[p & 15] + hi[p >> 4]), the complement Q - em.  Returns
    (decision words int32 [B, T, NS/32], final metrics int32 [B, NS])."""
    B, T = seg.shape[:2]
    H, G, M, HALF, W = NS // 2, NS >> R, 1 << R, 1 << (R - 1), NS // 32
    Q, SH = M // 4, 5 - R
    c = np.arange(G)
    lane, warp = c & 31, c >> 5
    nmask = (1 << n) - 1
    cbj = np.empty((R, G, HALF), np.int64)
    for j in range(R):
        for i in range(HALF):
            b = (c << j) + (i & ((1 << j) - 1)) + (i >> j) * (NS >> (R - j))
            cbj[j, :, i] = cb[b] & 0xFF
    start = c[:, None] + np.arange(M)[None, :] * G
    if init is None:
        m = np.broadcast_to(np.where(start == 0, 0, init_value),
                            (B, G, M)).astype(np.int64)
    else:
        m = init.astype(np.int64)[:, start]
    dec = np.zeros((B, T, 4 * W), np.uint8)
    rows = np.arange(B)[:, None]

    def phys(s):
        if Q == 1:
            return s
        o = s >> R
        return (o << R) | ((((s >> 2) & (Q - 1)) ^ ((o >> SH) & (Q - 1)))
                           << 2) | (s & 3)

    if soft is not None:
        lo_t, hi_t, q_t = _soft_tables(seg, n, *soft)
        # The packed byte of each pair: its entry's byte offset (n <= 4) or
        # its coded segment.
        cbo = cbj << 2 if n <= 4 else cbj

    def step(m, j, t):
        if soft is None:
            r = seg[:, t].astype(np.int64)[:, None, None]
            em = np.bitwise_count((r ^ cbj[j][None]) & nmask).astype(np.int64)
            emc = n - em
        else:
            rows3 = np.arange(B)[:, None, None]
            if n <= 4:
                em = lo_t[rows3, t, cbo[j][None] >> 2]
            else:
                em = (lo_t[rows3, t, cbo[j][None] & 15]
                      + hi_t[rows3, t, cbo[j][None] >> 4])
            emc = q_t[:, t, None, None] - em
        lo, hi = m[..., :HALF], m[..., HALF:]
        a0, a1, b0, b1 = lo + em, hi + emc, lo + emc, hi + em
        nm = np.empty_like(m)
        nm[..., 0::2] = np.minimum(a0, a1)
        nm[..., 1::2] = np.minimum(b0, b1)
        for p, d in ((0, a0 > a1), (1, b0 > b1)):
            for k in range(HALF >> j):
                word = p * (H // 32) + k * ((NS >> (R - j)) // 32) + (warp << j)
                d_k = d[..., k << j:(k + 1) << j].astype(np.int64)
                if j == 0:   # a ballot is the word; lane 0 stores it
                    ballot = (d_k[..., 0].reshape(B, -1, 32)
                              << np.arange(32)).sum(-1)
                    at = 4 * word[::32, None] + np.arange(4)
                    dec[rows[..., None], t, at[None]] = (
                        ballot[..., None] >> (8 * np.arange(4))) & 0xFF
                    continue
                v = (d_k << np.arange(1 << j)).sum(-1)
                s = 1
                while (s << j) < 8:
                    v = v | (_shfl_down(v, s) << (s << j))
                    s <<= 1
                byte = 4 * word + ((lane << j) >> 3)
                if j >= 4:   # a half word a lane
                    dec[rows, t, byte] = v & 0xFF
                    dec[rows, t, byte + 1] = (v >> 8) & 0xFF
                else:        # lanes owning a byte store it
                    own = (lane & ((8 >> j) - 1)) == 0
                    dec[rows, t, byte[own]] = v[:, own] & 0xFF
        return nm

    t = 0
    while t + R <= T:
        for j in range(R):
            m = step(m, j, t + j)
        smem = np.empty((B, NS), np.int64)
        for q in range(Q):
            qs = q ^ ((c >> SH) & (Q - 1))
            for w in range(4):
                smem[:, (c << R) + (qs << 2) + w] = m[..., 4 * q + w]
        m = smem[:, phys(start)]
        t += R
    J = T - t
    for j in range(J):
        m = step(m, j, t + j)
    i = np.arange(M)
    states = ((c[:, None] << J) + (i & ((1 << J) - 1))
              + (i >> J) * (NS >> (R - J)))
    final = np.empty((B, NS), np.int64)
    final[:, states] = m
    return dec.view("<i4"), final.astype(np.int32)


def _kernel_round_steps(soft=False):
    """NS -> the steps a round R at which csrc/acs_wide.cu's dispatch
    switch launches the hard wide forward (`soft`: the soft one, n <= 8)."""
    src = (Path(kernels.__file__).resolve().parent.parent / "csrc"
           / "acs_wide.cu").read_text()
    launch = "launch_soft_round" if soft else "launch_round"
    return {int(ns): int(r) for ns, _, r in re.findall(
        rf"case (\d+): return {launch}<(\d+), (\d+)>", src)}


# (NS, R, B, T) at the R the kernel launches at NS: T = 1 ... 2R at NS 512
# and 1024 (every residue mod R, T < R, whole rounds); one round and a step
# at NS 2048 ... 16384, and NS 16384 with T = 3, each with B = 1.
_STEPS = _kernel_round_steps()
_ROUND_CASES = (
    [(NS, _STEPS[NS], 2, T) for NS in (512, 1024)
     for T in range(1, 2 * _STEPS[NS] + 1)]
    + [(NS, _STEPS[NS], 1, _STEPS[NS] + 1)
       for NS in (2048, 4096, 8192, 16384)]
    + [(16384, _STEPS[16384], 1, 3)])


@pytest.mark.parametrize("NS,R,B,T", _ROUND_CASES)
def test_round_schedule_model_matches_plain_forward(NS, R, B, T):
    """The kernel's round schedule, modelled in numpy, gives the plain
    forward's words and final metrics bit for bit: fresh and carried start
    metrics, segments over all 2^n values (ties)."""
    assert NS >> R >= 32
    rng = np.random.default_rng(NS + 16 * R + T)
    # A poly-symmetric code: each generator taps the newest and the oldest
    # bit, the bits between at random; n = 2 ... 8 over the cases.
    K = NS.bit_length()
    spec = port.CodeSpec(K=K, g=tuple(
        (1 << (K - 1)) | 1 | (int(rng.integers(0, 1 << (K - 2))) << 1)
        for _ in range(2 + T % 7)))
    seg = rng.integers(0, 1 << spec.n, (B, T)).astype(np.uint8)
    cb = np.asarray(butterfly_coded_bits(spec), np.int64)
    init_value = init_metric_value(spec)
    words_p, fm_p = acs.acs_forward_batch_plain(spec, _t(seg))
    words, fm = _round_model(NS, spec.n, cb, seg, None, init_value, R)
    np.testing.assert_array_equal(words, words_p.numpy())
    np.testing.assert_array_equal(fm, fm_p.numpy())
    # Carried metrics: the plain forward's own, over a second draw.
    seg2 = rng.integers(0, 1 << spec.n, (B, T)).astype(np.uint8)
    words_p, fm2_p = acs.acs_forward_batch_plain(spec, _t(seg2), fm_p)
    words, fm2 = _round_model(NS, spec.n, cb, seg2, fm_p.numpy(), init_value,
                              R)
    np.testing.assert_array_equal(words, words_p.numpy())
    np.testing.assert_array_equal(fm2, fm2_p.numpy())


# (NS, R, B, T, n, qclip, floor) at the R the soft kernel launches at NS:
# T = 1 ... 2R at NS 512 and 1024, one round and a step at NS 2048 ...
# 16384 and NS 16384 at T = 3; n = 1, 4, 8 and the three conditionings
# (clamp to [-7, 7], [-127, 127], [-128, 127]) in turn.
_SOFT_STEPS = _kernel_round_steps(soft=True)
_SOFT_MODES = ((7, True), (127, True), (127, False))
_SOFT_ROUND_CASES = [
    case + ((1, 4, 8)[i % 3],) + _SOFT_MODES[(i // 3 + i) % 3]
    for i, case in enumerate(
        [(NS, _SOFT_STEPS[NS], 2, T) for NS in (512, 1024)
         for T in range(1, 2 * _SOFT_STEPS[NS] + 1)]
        + [(NS, _SOFT_STEPS[NS], 1, _SOFT_STEPS[NS] + 1)
           for NS in (2048, 4096, 8192, 16384)]
        + [(16384, _SOFT_STEPS[16384], 1, 3)])]


@pytest.mark.parametrize("NS,R,B,T,n,qclip,floor", _SOFT_ROUND_CASES)
def test_soft_round_schedule_model_matches_plain_forward(NS, R, B, T, n,
                                                         qclip, floor):
    """The soft kernel's rounds and table edge metrics, modelled in numpy,
    give the plain soft forward's words and final metrics bit for bit: LLRs
    over the whole int8 range, fresh and carried start metrics."""
    assert NS >> R >= 32
    rng = np.random.default_rng(NS + 16 * R + T + 1000 * n)
    K = NS.bit_length()
    spec = port.CodeSpec(K=K, g=tuple(
        (1 << (K - 1)) | 1 | (int(rng.integers(0, 1 << (K - 2))) << 1)
        for _ in range(n)))
    qlo = -qclip if floor else -128
    cb = np.asarray(butterfly_coded_bits(spec), np.int64)
    init_value = init_metric_value(spec)
    q = rng.integers(-128, 128, (B, T, n)).astype(np.int8)
    words_p, fm_p = acs.acs_forward_batch_soft_plain(spec, _t(q), qclip,
                                                     floor=floor)
    words, fm = _round_model(NS, n, cb, q, None, init_value, R,
                             (qlo, qclip))
    np.testing.assert_array_equal(words, words_p.numpy())
    np.testing.assert_array_equal(fm, fm_p.numpy())
    q2 = rng.integers(-128, 128, (B, T, n)).astype(np.int8)
    words_p, fm2_p = acs.acs_forward_batch_soft_plain(spec, _t(q2), qclip,
                                                      fm_p, floor)
    words, fm2 = _round_model(NS, n, cb, q2, fm_p.numpy(), init_value, R,
                              (qlo, qclip))
    np.testing.assert_array_equal(words, words_p.numpy())
    np.testing.assert_array_equal(fm2, fm2_p.numpy())


# --- The wide walk's schedule (csrc/traceback_wide.cu), modelled in numpy ----

def _smoke():
    """chip_smoke.py, whose readers of csrc/traceback_wide.cu the model
    shares."""
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


_SMOKE = _smoke()


def _wide_walk_lines():
    """[(NS, G's cap, warm-up steps, segments a window)] of each wide NS,
    as chip_smoke.py reads them from csrc/traceback_wide.cu."""
    return _SMOKE.wide_walk_lines()


_WIDE_WALK = {ns: rest for ns, *rest in _wide_walk_lines()}
#: walks -> P, the warps a walk takes in a launch of that many walks.
_WIDE_WARPS = _SMOKE.wide_walk_warps


def _segment_steps(t_top, spw, gcap):
    """G, the steps of a segment: a multiple of 8, spw segments a window,
    at most gcap (`launch_walk`)."""
    per_lane = -(-t_top // spw)
    return min(gcap, max(8, -(-per_lane // 8) * 8))


def _wide_walk_model(NS, gcap, wu, spw, words, tops, starts, live, widths,
                     rng, warps=1, base=0, chans=None, ragged=False):
    """numpy model of csrc/traceback_wide.cu's `wide_walk_kernel`, done the
    way the kernel does it.  A block of `warps` warps a walk: walk g reads
    channel chans[g] (g itself if None) from state starts[g] at step
    tops[g] - 1 down to step `base`.  Segments of G steps
    (`_segment_steps` of the launch's steps above base, the walks' top or
    for a `ragged` launch T, warps x spw segments a window), lane l of warp
    p owning segment p spw + l (lanes spw ... 31 none), so windows of
    warps spw G steps on the grid of their multiples above base, the top
    one first.  Each lane guesses the state at its
    segment's top by a warm-up of `wu` steps from state 0, or from the
    window's top state where the warm-up reaches the window's top, and
    walks on through its segment, all lanes in lock step, each step's word
    loaded for the state's bit index, decision 0 at steps >= live.  A
    segment's bits go MSb first into a byte stored at its lowest step (on
    the grid of 8 steps above base), the state there beside it.  Then, in
    rounds, every segment whose start differs from the end of the segment
    above walks again from that state, until none differs; a walk again
    stops where it meets its earlier walk's state at a byte's lowest step.
    For each row width L in `widths` a walk emits msg bits: L, or for a
    `ragged` walk min(max(tops[g] - S, 0), L); a walk whose msg is 0 at
    every width reads nothing.  The window's bytes (left as they were in
    the shared buffer where no lane stores) are written out as bits or as
    bytes with the bits past msg masked, and the row past msg is written
    0 (the rows start as 0xA5).  Asserts that each lane stores only bytes
    of its own segment.  Returns ({L: (bits uint8 [N, L], bytes uint8
    [N, ceil(L / 8)])}, segments walked again)."""
    _, T_stride, _ = words.shape
    S = NS.bit_length() - 1
    w64 = words.astype(np.int64) & 0xFFFFFFFF
    tops = np.asarray(tops, np.int64)
    N = tops.shape[0]
    chans = np.arange(N) if chans is None else np.asarray(chans)
    segs = warps * spw
    lane = np.arange(32 * warps) % 32
    seg = np.arange(32 * warps) // 32 * spw + lane
    valid = lane < spw
    col = {int(s): c for c, s in enumerate(seg) if valid[c]}
    above_col = np.array([col.get(int(s) + 1, c) for c, s in enumerate(seg)])

    def msg_of(L):
        return (np.minimum(np.maximum(tops - S, 0), L) if ragged
                else np.full(N, L))

    walks = np.max([msg_of(L) for L in widths], axis=0) > 0
    launch_top = T_stride if ragged else int(tops.max(initial=0))
    G = np.full(N, _segment_steps(max(launch_top - base, 1), segs, gcap))
    steps = np.where(walks, tops - base, 0)
    WS = segs * G
    n_win = -(-steps // WS)

    def index(s):
        return (s >> 1) | ((s & 1) << (S - 1))

    def load(t, i):
        return w64[chans[:, None], np.clip(t, 0, T_stride - 1), i >> 5]

    def walk(hi, lo, cur, on, emit_hi, got, wlo, again=None):
        """Lanes `on` from step hi - 1 down to lo, in lock step; returns
        (states at step lo - 1, states at step emit_hi - 1).  `again`: the
        ends of the lanes' earlier walks, where a walk stops on meeting its
        earlier walk's state at a byte's lowest step."""
        cur, got, on = cur.copy(), got.copy(), on.copy()
        acc = np.zeros_like(cur)
        for s in range(int(np.max(np.where(on, hi - lo, 0), initial=0))):
            t = hi - 1 - s
            act = on & (t >= lo)
            i = index(cur)
            d = np.where(t < live, (load(t, i) >> (i & 31)) & 1, 0)
            got = np.where(act & (t == emit_hi - 1), cur, got)
            em = act & (t < emit_hi)
            rel = t - wlo
            acc = np.where(em, acc | ((cur & 1) << (7 - (rel & 7))), acc)
            store = em & ((rel & 7) == 0)
            r, l = np.nonzero(store)
            at = rel[r, l] >> 3
            g8 = G[r] // 8
            assert np.all((seg[l] * g8 <= at) & (at < (seg[l] + 1) * g8))
            stage[r, at] = acc[r, l]
            acc = np.where(store, 0, acc)
            if again is not None:
                met = np.zeros_like(store)
                met[r, l] = ck[r, at] == cur[r, l]
                cur = np.where(met, again, cur)
                act &= ~met
                on &= ~met
                r, l = np.nonzero(store & ~met)
                at = rel[r, l] >> 3
            ck[r, at] = cur[r, l]
            cur = np.where(act, (cur >> 1) | (d << (S - 1)), cur)
        return cur, got

    outs = {L: (np.full((N, L), 0xA5, np.uint8),
                np.full((N, (L + 7) // 8), 0xA5, np.uint8)) for L in widths}
    for L, (bits, out_bytes) in outs.items():
        for g, m in enumerate(msg_of(L)):
            bits[g, m:] = 0
            out_bytes[g, -(-m // 8):] = 0
    stage = rng.integers(0, 256, (N, segs * gcap // 8)).astype(np.int64)
    ck = rng.integers(0, NS, (N, segs * gcap // 8)).astype(np.int64)
    top = np.asarray(starts, np.int64)
    rewalks = 0
    for j in reversed(range(int(n_win.max(initial=0)))):
        live_row = (j < n_win)[:, None]
        wlo = (base + j * WS)[:, None]
        whi = np.minimum(wlo + WS[:, None], tops[:, None])
        a = wlo + seg * G[:, None]
        b = np.minimum(a + G[:, None], whi)
        mine = live_row & valid & (a < whi)
        top_seg = b == whi
        t0 = np.minimum(b - 1 + wu, whi - 1)
        x = np.where(t0 == whi - 1, top[:, None], 0)
        start = np.broadcast_to(top[:, None], x.shape)
        end, start = walk(t0 + 1, a, x, mine, b, start, wlo)
        while True:
            above = np.where(mine & ~top_seg, end[:, above_col], start)
            redo = above != start
            if not redo.any():
                break
            rewalks += int(redo.sum())
            start = np.where(redo, above, start)
            again, _ = walk(b, a, start, redo, b, start, wlo, end)
            end = np.where(redo, again, end)
        top = np.where(live_row[:, 0], end[:, 0], top)
        staged = stage.astype(np.uint8)
        for L, (bits, out_bytes) in outs.items():
            for g, m in enumerate(msg_of(L)):
                r_lo, r_hi = int(wlo[g, 0]) - base, min(int(whi[g, 0]) - base,
                                                        int(m))
                if not live_row[g, 0] or r_hi <= r_lo:
                    continue
                bits[g, r_lo:r_hi] = np.unpackbits(staged[g])[:r_hi - r_lo]
                m_lo, m_hi = r_lo // 8, (r_hi + 7) // 8
                out_bytes[g, m_lo:m_hi] = staged[g, :m_hi - m_lo]
                if r_hi % 8:
                    out_bytes[g, m_hi - 1] &= 0xFF << (8 - r_hi % 8) & 0xFF
    return outs, rewalks


def _wide_spec(NS, rng, n=2):
    """A random poly-symmetric code with NS states and n generators."""
    K = NS.bit_length()
    return port.CodeSpec(K=K, g=tuple(
        (1 << (K - 1)) | 1 | (int(rng.integers(0, 1 << (K - 2))) << 1)
        for _ in range(n)))


def _garbage_words(rng, B, T, NS):
    """Uniform decision words: warm-up guesses go wrong."""
    return rng.integers(-2 ** 31, 2 ** 31, (B, T, NS // 32)).astype(np.int32)


def _sparse_words(rng, B, T, NS):
    """Decision words with a bit set one time in 8: survivors merge within
    a few steps, so most guesses are right and a few are walked again."""
    return (_garbage_words(rng, B, T, NS) & _garbage_words(rng, B, T, NS)
            & _garbage_words(rng, B, T, NS))


def _cut(L):
    """A row length below L and not a multiple of 8 (L itself if small)."""
    c = max(L - 13, 0)
    return c - 1 if c % 8 == 0 and c > 0 else c


def _assert_rows(outs, want):
    """Each width's model bits and bytes against the plain walk's bits
    `want` (uint8 [..., >= L])."""
    for L, (bits, out_bytes) in outs.items():
        w = want[..., :L].reshape(bits.shape[0], L)
        np.testing.assert_array_equal(bits, w.numpy())
        np.testing.assert_array_equal(
            out_bytes, port.ops.viterbi.pad_and_pack(w).numpy())


def _check_terminated(NS, words, t_actual, wu, rng):
    """The model's terminated walk (one warp a walk) against
    `traceback_batch_plain` at the whole message and a cut one, bits and
    bytes; returns re-walks."""
    gcap, _, spw = _WIDE_WALK[NS]
    spec = _wide_spec(NS, rng)
    B, T = words.shape[:2]
    full = max(t_actual - spec.S, 0)
    outs, rewalks = _wide_walk_model(
        NS, gcap, wu, spw, words, np.full(B, t_actual), np.zeros(B), T,
        sorted({full, _cut(full)}), rng)
    _assert_rows(outs, acs.traceback_batch_plain(spec, _t(words), t_actual,
                                                 full, "bits"))
    return rewalks


def _check_masked(NS, words, starts, live, wu, rng):
    """The model's masked walk (one warp a walk) against
    `traceback_batch_masked_plain` at out_steps T and a cut one, bits and
    bytes; returns re-walks."""
    gcap, _, spw = _WIDE_WALK[NS]
    spec = _wide_spec(NS, rng)
    B, T = words.shape[:2]
    outs, rewalks = _wide_walk_model(NS, gcap, wu, spw, words, np.full(B, T),
                                     starts, live, sorted({T, _cut(T)}), rng)
    _assert_rows(outs, acs.traceback_batch_masked_plain(
        spec, _t(words), _t(starts.astype(np.int32)), live, T, "bits"))
    return rewalks


def _check_ragged(NS, words, lengths, wu, rng, warps):
    """The model's ragged walk (each channel from state 0 at its own top,
    clamped to [0, T]) against `traceback_batch_ragged_plain` at the row
    widths T - S and a cut one, bits and bytes; returns re-walks."""
    gcap, _, spw = _WIDE_WALK[NS]
    spec = _wide_spec(NS, rng)
    B, T = words.shape[:2]
    lengths = np.asarray(lengths, np.int32)
    widths = sorted({T - spec.S, _cut(T - spec.S)})
    outs, rewalks = _wide_walk_model(
        NS, gcap, wu, spw, words, np.clip(lengths, 0, T), np.zeros(B), T,
        widths, rng, warps, ragged=True)
    _assert_rows(outs, acs.traceback_batch_ragged_plain(
        spec, _t(words), _t(lengths), T - spec.S, "bits"))
    return rewalks


def _check_multi(NS, words, starts, live, out_start, wu, rng):
    """The model's list walk (walk (b, w) from starts[b, w], a block of the
    kernel's warps for B NW walks each, the byte grid from out_start)
    against `traceback_batch_multi_plain` at the window [out_start, T) and
    a cut one, bits and bytes; returns re-walks."""
    gcap, _, spw = _WIDE_WALK[NS]
    spec = _wide_spec(NS, rng)
    B, T = words.shape[:2]
    NW = starts.shape[1]
    steps = T - out_start
    outs, rewalks = _wide_walk_model(
        NS, gcap, wu, spw, words, np.full(B * NW, T), starts.reshape(-1),
        live, sorted({steps, _cut(steps)}), rng, _WIDE_WARPS(B * NW),
        out_start, np.repeat(np.arange(B), NW))
    _assert_rows(outs, acs.traceback_batch_multi_plain(
        spec, _t(words), _t(starts.astype(np.int32)), live, out_start, steps,
        "bits"))
    return rewalks


# At each wide NS, at its dispatch line's G cap, warm-up and segments a
# window: "noisy" the forward's
# words of a noisy packet (t_actual two below T_stride), with the line's
# warm-up and with none (every guess from state 0, so segments are walked
# again, asserted); "edges" T = 1 and T < 8 (masked) and t_actual = S + 5
# (terminated); "garbage" uniform words at T not a multiple of G,
# terminated and masked at live 0, S, T - 1 and T from random starts;
# "windows" three windows of sparse words (a bit set one time in 8),
# terminated, and masked with no warm-up; "ragged" lengths 0, 1, S, S + 1,
# T - 1, T, past T, negative and random ones in one batch of garbage words
# (re-walks asserted) at one warp a walk (the main paths' B = 2048) and at
# the kernel's warps for the batch, and three windows of sparse words;
# "multi" NW = 1, 4 and 8 walks from random starts at the kernel's warps,
# out_start 0, 13 (not a multiple of 8) and a third of T, live T and below
# T, garbage words (re-walks asserted) and two windows of sparse words.
_WIDE_WALK_CASES = [(NS, which) for NS in sorted(_WIDE_WALK)
                    for which in ("noisy", "edges", "garbage", "windows",
                                  "ragged", "multi")]


@pytest.mark.parametrize("NS,which", _WIDE_WALK_CASES,
                         ids=[f"NS{ns}-{w}" for ns, w in _WIDE_WALK_CASES])
def test_wide_walk_schedule_model_matches_plain_walks(NS, which):
    """The wide walk's windows, segments a lane, warps a walk, warm-ups,
    guesses, top-down check and re-walks and each lane's whole output
    bytes, modelled in numpy, give the plain terminated, masked, ragged and
    list walks' bits and bytes bit for bit."""
    gcap, wu, spw = _WIDE_WALK[NS]
    rng = np.random.default_rng(NS + len(which))
    S = NS.bit_length() - 1
    if which == "noisy":
        spec = _wide_spec(NS, rng, 4)
        seg = _segments(spec, "noisy", NS, B=2, L=120)
        words = acs.acs_forward_batch_plain(spec, _t(seg))[0].numpy()
        T = words.shape[1]
        assert _check_terminated(NS, words, T - 2, wu, rng) >= 0
        assert _check_terminated(NS, words, T - 2, 0, rng) > 0
        _check_masked(NS, words, rng.integers(0, NS, 2), T, wu, rng)
    elif which == "edges":
        for T in (1, 5):
            words = _garbage_words(rng, 3, T, NS)
            _check_masked(NS, words, rng.integers(0, NS, 3), T, wu, rng)
        words = _garbage_words(rng, 3, S + 7, NS)
        _check_terminated(NS, words, S + 5, wu, rng)
    elif which == "garbage":
        T = spw * min(16, gcap) - 5        # spw segments, the top one short
        words = _garbage_words(rng, 2, T, NS)
        assert _check_terminated(NS, words, T, wu, rng) > 0
        for live in (0, S, T - 1, T):
            _check_masked(NS, words, rng.integers(0, NS, 2), live, wu, rng)
    elif which == "ragged":
        T = spw * min(16, gcap) - 5
        words = _garbage_words(rng, 12, T, NS)
        lengths = [0, 1, S, S + 1, T - 1, T, T + 4, -3,
                   *rng.integers(S + 1, T, 4)]
        for warps in sorted({1, _WIDE_WARPS(len(lengths))}):
            assert _check_ragged(NS, words, lengths, wu, rng, warps) > 0
        T = 2 * spw * gcap + 37
        words = _sparse_words(rng, 2, T, NS)
        _check_ragged(NS, words, [T - 1, spw * gcap + 3], wu, rng, 1)
    elif which == "multi":
        T = spw * min(16, gcap) + 17
        words = _garbage_words(rng, 2, T, NS)
        rewalks = 0
        for nw, live, out_start in ((1, T, 13), (4, T - 9, 0),
                                    (8, T, T // 3)):
            rewalks += _check_multi(NS, words, rng.integers(0, NS, (2, nw)),
                                    live, out_start, wu, rng)
        assert rewalks > 0
        T = _WIDE_WARPS(4) * spw * gcap + 42  # two windows above step 13
        words = _sparse_words(rng, 1, T, NS)
        _check_multi(NS, words, rng.integers(0, NS, (1, 4)), T - 40, 13, 0,
                     rng)
    else:
        T = 2 * spw * gcap + 37
        words = _sparse_words(rng, 1, T, NS)
        _check_terminated(NS, words, T - 3, wu, rng)
        _check_masked(NS, words, rng.integers(0, NS, 1), T - 50, 0, rng)


def test_wide_walk_dispatch_covers_every_wide_state_count():
    """The wide walk's dispatch switch has exactly one line for each wide
    NS, 512 ... 16384, each with segments of whole output bytes and at most
    a warp's lanes a window; a segment walk's window of output bytes and
    its ends fit a block's static shared memory (48 KB) at the most warps
    a walk, at (l)'s length a packet is one window, and the warps a walk
    fall from the most for a few walks to one for the main paths' 2048."""
    lines = _wide_walk_lines()
    assert [ns for ns, *_ in lines] == [512 << i for i in range(6)]
    most = _WIDE_WARPS(1)
    assert most in (1, 2, 4, 8, 16, 32) and _WIDE_WARPS(2048) == 1
    assert all(_WIDE_WARPS(n) >= _WIDE_WARPS(n + 1) for n in range(4096))
    for ns, gcap, wu, spw in lines:
        assert gcap % 8 == 0 and gcap >= 8 and wu >= 0 and 1 <= spw <= 32
        assert most * spw * (gcap // 8 * 3 + 4) <= 48 * 1024
        assert spw * _segment_steps(2062, spw, gcap) >= 2062
