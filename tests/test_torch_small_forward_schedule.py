"""The small-state forward's schedule (csrc/acs_small.cu, `acs_small_kernel`,
TPU kernel K12's forward, hard and soft), modelled in numpy, against the
port's plain forwards and the JAX package's butterfly scans, bit for bit.

The kernel runs only on the card, where chip_smoke.py holds it to its plain
version; here a model done the way the kernel does it is held to the scans:
G = 64/NS channels a warp, lane (c, b) = c NS/2 + b serving butterfly b of
channel c; odd lanes keeping their two sources swapped (the high one
first); each lane's code complemented where it is in the upper half of its
channel xor odd; a hard segment's bit i as the LLR 1 - 2 bit; edge
metrics without the relu(-q) sums (each candidate the source metric plus
the clamped LLRs over the code's bits or over the others; n = 5..8: the
step's sum less that), the dropped sums added back to the final metrics; the tie rule reversed on
odd lanes (c1 - c2 + 1 > 0, inverted); the two shuffles within a channel's
lanes; the two ballots of each step across the warp, put in place into
each channel's word by the lower-lane mask.  The source facts the model
takes are read from the kernel's source.
"""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import convolutionalencdec_tpu as ref
from convolutionalencdec_tpu.ops import metrics as ref_metrics
from convolutionalencdec_tpu.ops import viterbi as ref_viterbi

import convolutionalencdec_tpu_torch as port
from convolutionalencdec_tpu_torch.kernels import acs
from convolutionalencdec_tpu_torch.ops.trellis import butterfly_coded_bits
from convolutionalencdec_tpu_torch.ops.viterbi import init_metric_value

SOURCE = (Path(__file__).resolve().parent.parent / "convolutionalencdec_tpu_torch"
          / "csrc" / "acs_small.cu").read_text()
# The lines of the kernel the model follows.
FACTS = (
    "const int odd = (H > 1) ? (b & 1) : 0;",
    "const bool upper = (H > 1) && b >= H / 2;",
    "const unsigned code = (upper != (odd != 0)) ? ~(unsigned)cb[b]",
    "const int src1 = (odd ? H / 2 : 0) + (b >> 1);",
    "const int src2 = src1 ^ (H / 2);",
    "((c1 - c2 + odd) > 0) != (odd != 0)",
    "((c3 - c4 + odd) > 0) != (odd != 0)",
    "if (lane == s) kept = make_uint2(d1, d2);",
    "const unsigned e = (d.x & kLow) | (d.y & ~kLow);",
    "const unsigned o = (d.y & kLow) | (d.x & ~kLow);",
    "const int a_state = odd ? b + H : b;",
)


def _model(spec, x, soft, n, init=None, qlo=-127, qclip=127):
    """numpy model of `acs_small_kernel`: (words int32 [B, T], final
    metrics int32 [B, NS]) of segments x [B, T] (hard) or LLRs x [B, T, n]
    (soft, clamped to [qlo, qclip])."""
    NS = spec.num_states
    H = NS // 2
    G = 32 // H
    B, T = x.shape[:2]
    Bp = -(-B // G) * G                       # whole warps
    b = np.arange(H)
    odd = (b & 1) if H > 1 else np.zeros(H, np.int64)
    upper = (b >= H // 2) if H > 1 else np.zeros(H, bool)
    cb = butterfly_coded_bits(spec).astype(np.int64)
    code = np.where(upper != (odd != 0), ~cb, cb)              # [H]
    bits = (code[:, None] >> np.arange(n)) & 1                 # [H, n]
    src1 = np.where(odd == 1, H // 2, 0) + (b >> 1)
    src2 = src1 ^ (H // 2)
    a_state = np.where(odd == 1, b + H, b)
    b_state = a_state ^ H
    iv = init_metric_value(spec)
    if init is None:
        full = np.where(np.arange(NS) == 0, 0, iv)[None].repeat(Bp, 0)
    else:
        full = np.full((Bp, NS), iv, np.int64)
        full[:B] = init
    A = full[:, a_state].astype(np.int64)                      # [Bp, H]
    Bm = full[:, b_state].astype(np.int64)
    if soft:
        q = np.clip(x.astype(np.int64), qlo, qclip)
    else:  # a segment's bit i as the LLR 1 - 2 bit
        q = 1 - 2 * ((x[..., None].astype(np.int64) >> np.arange(n)) & 1)
    xp = np.zeros((Bp, T, n), np.int64)
    xp[:B] = q
    drop = np.maximum(-xp, 0).sum(axis=(1, 2))                 # [Bp]
    lanes = (np.arange(G)[:, None] * H + b).reshape(-1)        # c H + b
    k_low = sum(1 << int(l) for l in lanes if H == 1 or l % H < H // 2)
    half = (1 << H) - 1
    words = np.zeros((Bp, T), np.int64)
    for t in range(T):
        qt = xp[:, t]                                          # [Bp, n]
        g1 = qt @ bits.T                                       # [Bp, H]
        g2 = qt.sum(1)[:, None] - g1 if n > 4 else qt @ (1 - bits).T
        c1, c2, c3, c4 = A + g1, Bm + g2, A + g2, Bm + g1
        p1 = ((c1 - c2 + odd) > 0) != (odd != 0)
        p2 = ((c3 - c4 + odd) > 0) != (odd != 0)
        v1, v2 = np.minimum(c1, c2), np.minimum(c3, c4)
        if H == 1:
            A, Bm = v1, v2
        else:
            A, Bm = v1[:, src1], v2[:, src2]
        # The ballots of each warp, lane c H + b; each channel's word.
        d1 = (p1.reshape(-1, G * H).astype(np.int64) << lanes).sum(1)
        d2 = (p2.reshape(-1, G * H).astype(np.int64) << lanes).sum(1)
        e = (d1 & k_low) | (d2 & ~k_low & 0xFFFFFFFF)
        o = (d2 & k_low) | (d1 & ~k_low & 0xFFFFFFFF)
        for c in range(G):
            words[c::G, t] = (((e >> (c * H)) & half)
                              | (((o >> (c * H)) & half) << H))
    fm = np.empty((Bp, NS), np.int64)
    fm[:, a_state] = A
    fm[:, b_state] = Bm
    fm += drop[:, None]
    assert np.abs(fm).max(initial=0) < 2 ** 31
    return words[:B].astype(np.int32), fm[:B].astype(np.int32)


def _code(NS, n, rng):
    """A random poly-symmetric code of NS states and n generators."""
    K = NS.bit_length()
    inner = 1 << max(K - 2, 0)
    g = tuple((1 << (K - 1)) | 1 | ((int(rng.integers(0, inner)) << 1)
                                    if K > 2 else 0) for _ in range(n))
    return port.CodeSpec(K=K, g=g), ref.CodeSpec(K=K, g=g)


def _inputs(spec, rng, B, T, soft):
    """Hard: noisy segments of random messages and a few garbage rows;
    soft: LLRs over the whole int8 range, -128 among them, 20% erased."""
    n = spec.n
    if soft:
        q = rng.integers(-128, 128, (B, T, n))
        q[rng.random(q.shape) < 0.2] = 0
        q.reshape(-1)[::17] = -128
        return q
    msgs = rng.integers(0, 2, (B, max(T - spec.S, 0)), dtype=np.uint8)
    seg = port.encode_bits(spec, torch.from_numpy(msgs))[0].numpy()[:, :T]
    seg = np.concatenate([seg, np.zeros((B, T - seg.shape[1]), np.uint8)], 1)
    hit = rng.random(seg.shape) < 0.08
    seg = seg ^ (hit * rng.integers(1, 1 << n, seg.shape)).astype(np.uint8)
    seg[::5] = rng.integers(0, 1 << n, seg[::5].shape)
    return seg.astype(np.uint8)


def test_small_forward_source_facts():
    """The model's lines are the kernel's."""
    for fact in FACTS:
        assert fact in SOURCE, fact


@pytest.mark.parametrize("NS", (2, 4, 8, 16, 32))
def test_small_forward_model_matches_the_scans(NS):
    """At every n = 1..8, hard and soft (the clip 127 with the -127
    floor), B = 37 (no multiple of G) over a block and a tail (T = 40):
    the model's words and final metrics equal the port's plain forwards;
    at n = 2 and 7 also hard from carried metrics and soft at the clip 7.
    The JAX package's butterfly scans (vmapped, a compile each): hard from
    carried metrics at NS 2 and 16 (n 2), soft at NS 8 and 32 (n 7)."""
    rng = np.random.default_rng(NS)
    B, T = 37, 40
    for n in range(1, 9):
        spec, rspec = _code(NS, n, rng)
        seg = _inputs(spec, rng, B, T, False)
        got = _model(spec, seg, False, n)
        words, fm = acs.acs_forward_batch_plain(spec, torch.from_numpy(seg))
        np.testing.assert_array_equal(got[0], words[..., 0].numpy())
        np.testing.assert_array_equal(got[1], fm.numpy())
        q = _inputs(spec, rng, B, T, True)
        qt = torch.from_numpy(q.astype(np.int8))
        got_s = _model(spec, q, True, n)
        words, fm = acs.acs_forward_batch_soft_plain(spec, qt, 127)
        np.testing.assert_array_equal(got_s[0], words[..., 0].numpy())
        np.testing.assert_array_equal(got_s[1], fm.numpy())
        if n not in (2, 7):
            continue
        init = rng.integers(0, 6000, (B, NS)).astype(np.int32)
        got_i = _model(spec, seg, False, n, init)
        words, fm = acs.acs_forward_batch_plain(spec, torch.from_numpy(seg),
                                                torch.from_numpy(init))
        np.testing.assert_array_equal(got_i[0], words[..., 0].numpy())
        np.testing.assert_array_equal(got_i[1], fm.numpy())
        got_7 = _model(spec, q, True, n, qlo=-7, qclip=7)
        words, fm = acs.acs_forward_batch_soft_plain(spec, qt, 7)
        np.testing.assert_array_equal(got_7[0], words[..., 0].numpy())
        np.testing.assert_array_equal(got_7[1], fm.numpy())
        if n == 2 and NS in (2, 16):
            dec, fm = jax.vmap(lambda s, i: ref_viterbi.viterbi_forward_butterfly(
                rspec, s, i))(seg, init)
            dec = acs.pack_decisions(spec, torch.tensor(np.asarray(dec)))
            np.testing.assert_array_equal(got_i[0], dec[..., 0].numpy())
            np.testing.assert_array_equal(got_i[1], np.asarray(fm))
        if n == 7 and NS in (8, 32):
            dec, fm = jax.vmap(lambda x: ref_metrics.viterbi_forward_butterfly_soft(
                rspec, x))(np.clip(q, -127, 127).astype(np.int32))
            dec = acs.pack_decisions(spec, torch.tensor(np.asarray(dec)))
            np.testing.assert_array_equal(got_s[0], dec[..., 0].numpy())
            np.testing.assert_array_equal(got_s[1], np.asarray(fm))


@pytest.mark.parametrize("T", (0, 1, 31, 33))
def test_small_forward_model_edges(T):
    """T = 0, 1, 31, 33 (no step, one, a block less one, a block and one)
    at every NS, B = 1 and 5, the -128 route (qlo -128): the model equals
    the plain forwards."""
    rng = np.random.default_rng(100 + T)
    for NS in (2, 4, 8, 16, 32):
        for B in (1, 5):
            n = int(rng.integers(1, 9))
            spec, _ = _code(NS, n, rng)
            seg = _inputs(spec, rng, B, T, False)
            got = _model(spec, seg, False, n)
            words, fm = acs.acs_forward_batch_plain(spec,
                                                    torch.from_numpy(seg))
            np.testing.assert_array_equal(got[0], words[..., 0].numpy())
            np.testing.assert_array_equal(got[1], fm.numpy())
            q = _inputs(spec, rng, B, T, True)
            got_s = _model(spec, q, True, n, qlo=-128, qclip=127)
            words, fm = acs.acs_forward_batch_soft_plain(
                spec, torch.from_numpy(q.astype(np.int8)), 127, floor=False)
            np.testing.assert_array_equal(got_s[0], words[..., 0].numpy())
            np.testing.assert_array_equal(got_s[1], fm.numpy())
