"""The port's single-pass block decode (TPU kernel K13) and its route on the
CPU, where `block_decode_1p` takes its plain version (the CUDA kernel,
csrc/block_1p.cu, runs only on the card, where chip_smoke.py holds it to
that plain version).

The port's `_block_decode_1p` is held bit for bit against the JAX
package's kernel in interpret mode (two calls, hard and soft, on the
rate-1/6 K = 7 code); the decode entries that now route to it, against the
JAX scan decoders on that code and on an NS = 512, n = 5 code; and
`use_single_pass` / `select_kernel(..., T)` against the JAX package's rule
and branch choice on every preset, on test_torch_wide.py's codes and at the
32 KiB boundary.  A numpy model of the CUDA warp kernel's schedule (NS 64
... 256: lanes, shuffles, decision columns and rows, the shared-memory
layout the walk reads) is held against the plain forward's words and
`block_decode_1p_plain`; so is the wide template's (NS 512 ... 4096: the
wide forward's rounds, test_torch_wide.py's model, at the R its dispatch
switch launches, writing the region's rows), whose shared memory fits
wherever the wrapper admits a T.
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
from convolutionalencdec_tpu.kernels import acs_swar as ref_swar

import convolutionalencdec_tpu_torch as port
from convolutionalencdec_tpu_torch import kernels
from convolutionalencdec_tpu_torch.kernels import single_pass

# The rate-1/6 K = 7 code (NS = 64, n = 6: the JAX package sends its block
# decodes to K13), the NS = 512 rate-1/5 code of test_torch_wide.py, and
# test_torch_wide.py's other codes for the route rule.
K7_R16 = dict(K=7, g=(0o133, 0o171, 0o165, 0o117, 0o127, 0o155))
K10_N5 = dict(K=10, g=(0o1167, 0o1545, 0o1337, 0o1071, 0o1423))
ROUTE_CODES = {
    "K7_R16": K7_R16, "K10_n5": K10_N5,
    "K10": dict(K=10, g=(0o1167, 0o1545)),
    "K11": dict(K=11, g=(0o2365, 0o3173)),
    "K15": dict(K=15, g=(0o46321, 0o51271, 0o63667, 0o70535)),
    "K8_n5": dict(K=8, g=(0o247, 0o371, 0o275, 0o313, 0o357)),
    "K9_n8": dict(K=9, g=(0o561, 0o753, 0o711, 0o545, 0o633, 0o447, 0o655,
                          0o537)),
    "K13_n5": dict(K=13, g=(0o10533, 0o15671, 0o12345, 0o17233, 0o11111)),
    "K7_n9": dict(K=7, g=K7_R16["g"] + (0o133, 0o171, 0o165)),
}


def _specs(code):
    return ref.CodeSpec(**code), port.CodeSpec(**code)


def _segments(spec, B, L, seed, p=0.08):
    """uint8 segments [B, L + S], encoded and hit at rate p by nonzero XOR
    masks."""
    rng = np.random.default_rng(seed)
    msgs = rng.integers(0, 2, (B, L), dtype=np.uint8)
    coded = port.encode_bits(spec, torch.from_numpy(msgs))[0].numpy().copy()
    hit = rng.random(coded.shape) < p
    return coded ^ (hit * rng.integers(1, 1 << spec.n, coded.shape)).astype(
        np.uint8)


def _llrs(spec, coded, seed):
    """int8 LLRs [B, T, n]: signs from the coded bits, magnitudes 1..127
    with 8% flips, 6% erasures and 4% -128."""
    rng = np.random.default_rng(seed)
    shape = coded.shape + (spec.n,)
    planes = np.stack([(coded >> j) & 1 for j in range(spec.n)], -1)
    q = (1 - 2 * planes.astype(np.int32)) * rng.integers(1, 128, shape)
    q = np.where(rng.random(shape) < 0.08, -q, q)
    q = np.where(rng.random(shape) < 0.06, 0, q)
    return np.where(rng.random(shape) < 0.04, -128, q).astype(np.int8)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
def test_interpreted_single_pass_kernel_matches(soft):
    """One interpret-mode call of the JAX kernel K13 on one full chunk
    (B = B_TILE = 256, T = 46 padded to 48) against the port's JAX-named
    `_block_decode_1p`, packed rows bit for bit.  The JAX kernel takes the
    LLRs as its routes leave them (floored at -127, `_as_int8_qllrs`); the
    port's floors them itself."""
    ref_spec, spec = _specs(K7_R16)
    Bp = ref_acs.B_TILE
    T = 46
    seg = _segments(spec, Bp, T - spec.S, 41)
    x = _llrs(spec, seg, 42) if soft else seg
    pad = ((0, 0), (0, 48 - T)) + ((0, 0),) * (x.ndim - 2)
    x = np.pad(x, pad)
    x_ref = np.asarray(ref_acs._as_int8_qllrs(x)) if soft else x
    want = np.asarray(ref_acs._block_decode_1p(ref_spec, x_ref, T, soft,
                                               True))
    got = single_pass._block_decode_1p(spec, _t(x), T, soft)
    assert got.shape == (48 // 8, Bp) and got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind", ["noisy", "garbage"])
@pytest.mark.parametrize("name", ["K7_R16", "K10_n5"])
def test_routes_match_scan_decoders(name, kind):
    """The decode entries on the SINGLE_PASS route against
    `jax.vmap(viterbi_decode)` and `viterbi_decode_soft` on the floored
    LLRs; bits, bytes and a cut message."""
    ref_spec, spec = _specs(ROUTE_CODES[name])
    L = 61
    seg = _segments(spec, 3, L, 7, 0.5 if kind == "garbage" else 0.08)
    T = seg.shape[1]
    assert kernels.select_kernel(spec, T=T) == kernels.SINGLE_PASS
    assert kernels.select_kernel(spec, "soft", T=T) == kernels.SINGLE_PASS
    want = np.asarray(jax.vmap(lambda c: ref.viterbi_decode(ref_spec, c))(
        seg))
    np.testing.assert_array_equal(
        kernels.viterbi_decode_batch(spec, _t(seg)).numpy(), want)
    np.testing.assert_array_equal(
        kernels.viterbi_decode_batch_bytes(spec, _t(seg), L - 5).numpy(),
        np.packbits(want[:, :L - 5], axis=1))
    q = _llrs(spec, seg, 8)
    want = np.asarray(jax.vmap(lambda x: ref.viterbi_decode_soft(
        ref_spec, x))(np.maximum(q.astype(np.int32), -127)))
    np.testing.assert_array_equal(
        kernels.viterbi_decode_batch_soft(spec, _t(q)).numpy(), want)
    np.testing.assert_array_equal(
        kernels.viterbi_decode_batch_soft_bytes(spec, _t(q)).numpy(),
        np.packbits(want, axis=1))


def _jax_single_pass(ref_spec, T, mode):
    """The JAX package's branch choice (acs_pallas.py:366-376, :538-551):
    whether `viterbi_decode_batch` (hard) or `viterbi_decode_batch_soft`
    (soft, default qmax) of a T-step packet runs `_block_decode_1p`."""
    if not (ref_spec.k == 1 and ref_spec.has_poly_symmetry):
        return False
    if mode == "hard" and ref_spec.n > 8:
        return False  # no uint8 segment holds the step: no hard decode
    if mode == "hard":
        swar = ref_swar.swar_supported(ref_spec)
    else:
        swar = (ref_swar.swar8_soft_supported(ref_spec, 7)
                or ref_swar.swar_layout_supported(ref_spec))
    T_pad = -(-T // ref_acs.CHUNK_F) * ref_acs.CHUNK_F
    return (not swar and ref_spec.num_states >= 64
            and ref_acs._use_single_pass(ref_spec, T_pad))


def _boundary_steps(NS):
    """T around the largest multiple of 48 whose decisions fit 32 KiB per
    channel: one chunk below, one step either side, one chunk above."""
    top = 32768 * 8 // NS // 48 * 48
    return [1, 48, top - 48, top - 1, top, top + 1, top + 48]


CASES = ([(name, dict(K=s.K, g=s.g, k=s.k)) for name, s in
          port.PRESETS.items()] + list(ROUTE_CODES.items()))


@pytest.mark.parametrize("name,code", CASES, ids=[c[0] for c in CASES])
def test_route_rule_matches_reference(name, code):
    ref_spec, spec = _specs(code)
    NS = spec.num_states
    for T in _boundary_steps(max(NS, 64)) + [2054, 4080, 4081]:
        T_pad = -(-T // 48) * 48
        assert single_pass.use_single_pass(spec, T) == \
            ref_acs._use_single_pass(ref_spec, T_pad), (name, T)
        for mode in ("hard", "soft"):
            got = kernels.select_kernel(spec, mode, T=T)
            want = _jax_single_pass(ref_spec, T, mode)
            assert (got == kernels.SINGLE_PASS) == want, (name, mode, T, got)
            if not want:   # every other answer is the length-free one
                assert got == kernels.select_kernel(spec, mode), (name, mode)


def test_no_code_of_four_or_fewer_bits_takes_the_single_pass():
    for spec in port.PRESETS.values():
        if spec.n <= 4:
            for mode in ("hard", "soft"):
                assert kernels.select_kernel(spec, mode, T=100) != \
                    kernels.SINGLE_PASS


def test_plain_version_edges_and_errors():
    _, spec = _specs(K7_R16)
    seg = _t(_segments(spec, 4, 30, 11))
    T = seg.shape[1]
    want = port.viterbi_decode(spec, seg)
    padded = torch.cat([seg, torch.full((4, 9), 0x2A, dtype=torch.uint8)], 1)
    # Steps past t_actual are ignored; bits and MSb-first bytes; a cut L.
    assert torch.equal(single_pass.block_decode_1p(spec, padded, T, False),
                       want)
    assert torch.equal(
        single_pass.block_decode_1p(spec, padded, T, False, "bytes", 21),
        port.ops.viterbi.pad_and_pack(want[:, :21]))
    # Below and at S steps: no message bits.
    for t in (0, 1, spec.S):
        out = single_pass.block_decode_1p(spec, seg, t, False)
        assert out.shape == (4, 0)
    assert single_pass.block_decode_1p(spec, seg[:0], T, False).shape == (0, 30)
    # The JAX-named rows: the message bits, then zeros.
    rows = single_pass._block_decode_1p(spec, padded[:, :40], T, False)
    bits = np.unpackbits(rows.numpy().T, axis=1, bitorder="little")
    np.testing.assert_array_equal(bits[:, :30], want.numpy())
    assert not bits[:, 30:].any()
    with pytest.raises(ValueError, match="multiple of 8"):
        single_pass._block_decode_1p(spec, padded[:, :33], T, False)
    with pytest.raises(ValueError, match="message_bits"):
        single_pass.block_decode_1p(spec, seg, T, False, "bits", 31)
    with pytest.raises(ValueError, match="t_actual"):
        single_pass.block_decode_1p(spec, seg, T + 1, False)
    with pytest.raises(ValueError, match="out"):
        single_pass.block_decode_1p(spec, seg, T, False, "words")
    with pytest.raises(ValueError, match="int8"):
        single_pass.block_decode_1p(spec, seg, T, True)
    with pytest.raises(ValueError, match="single-pass range"):
        single_pass.block_decode_1p(port.K5_23_35, seg[:, :12], 12, False)
    with pytest.raises(ValueError, match="single-pass range"):
        single_pass.block_decode_1p(port.CodeSpec(K=14, g=(0o21675, 0o27123)),
                                    seg, T, False)
    # 28,578 steps of NS = 64 decisions and bits pass one block's shared
    # memory.
    assert single_pass.smem_bytes(spec, 28577) <= single_pass.SMEM_BYTES
    assert single_pass.smem_bytes(spec, 28578) > single_pass.SMEM_BYTES
    long = torch.zeros((1, 28578), dtype=torch.uint8)
    with pytest.raises(ValueError, match="shared"):
        single_pass.block_decode_1p(spec, long, 28578, False)
    meta = torch.empty((2, 40), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="not supported"):
        single_pass.block_decode_1p(spec, meta, 40, False)


def test_cpu_route_launches_nothing():
    _, spec = _specs(K7_R16)
    single_pass.LAUNCHES["block_decode_1p"] = 0
    seg = _t(_segments(spec, 2, 20, 12))
    kernels.viterbi_decode_batch_bytes(spec, seg)
    kernels.viterbi_decode_batch_soft(
        spec, torch.ones(seg.shape + (spec.n,), dtype=torch.int8))
    assert single_pass.LAUNCHES == {"block_decode_1p": 0}


# ---------------------------------------------------------------------------
# A numpy model of csrc/block_1p.cu's warp kernel (`block_1p_warp`, NS 64 ...
# 256), held against the plain forward's words and `block_decode_1p_plain`.

def _ballot(pred):
    """[B, 32] bool -> [B] uint32, bit l from lane l."""
    return (pred.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(
        axis=1).astype(np.uint32)


def _channel_region(T, NS):
    """(stride, walk scratch offset, hard stage offset) in bytes: the
    kernel's `channel_stride`, `xy` and `stage_hard`."""
    size = T * NS // 8 + 4 * -(-T // 32) + 4 * 64
    xy = T * NS // 8
    return -(-size // 16) * 16, xy, -(-xy // 16) * 16


def _model_block_1p(spec, x, T, soft):
    """The warp kernel's schedule on every channel of x, lanes as a numpy
    axis: returns each channel's shared-memory region as the walk reads it
    (uint32 [B, stride / 4]: whole blocks of 32 steps as columns, the last
    T % 32 steps as rows)."""
    NS, n = spec.num_states, spec.n
    BPL, W = NS // 64, NS // 32
    NQ = min(n, 8)
    B = x.shape[0]
    lane = np.arange(32)
    upper = lane >= 16
    odd = (lane & 1).astype(bool)
    iv = port.ops.viterbi.init_metric_value(spec)
    cb = port.ops.trellis.butterfly_coded_bits(spec).astype(np.uint32)
    code = np.stack([np.where(upper, ~cb[32 * j + lane], cb[32 * j + lane])
                     for j in range(BPL)])                    # [BPL, 32]
    bits = np.stack([(code >> i) & 1 for i in range(NQ)], -1).astype(
        np.int64)                                             # [BPL, 32, NQ]
    lo = np.broadcast_to(np.stack([np.where(32 * j + lane == 0, 0, iv)
                                   for j in range(BPL)]), (B, BPL, 32))
    hi = np.full((B, BPL, 32), iv)
    src1 = np.where(odd, 16, 0) + (lane >> 1)
    src2 = src1 ^ 16
    stride, xy, stage_hard = _channel_region(T, NS)
    assert stride % 16 == 0 and stage_hard + 32 <= xy + 256
    region = np.zeros((B, stride), np.uint8)
    words = region.view(np.uint32)
    for t0 in range(0, T, 32):
        steps = min(32, T - t0)
        # Step t0 + l's input, staged at lane l's place in the scratch.
        x_blk = np.zeros((B, 32) + x.shape[2:], x.dtype)
        x_blk[:, :steps] = x[:, t0:t0 + steps]
        if soft:
            q = np.maximum(x_blk.astype(np.int64), -127)
            packed = np.zeros((B, 32, 8), np.int64)
            packed[..., :NQ] = q[..., :NQ]
            region[:, xy:xy + 256] = packed.astype(np.int8).view(
                np.uint8).reshape(B, 256)
            rest = q[..., 8:].sum(-1)                         # [B, 32]
        else:
            region[:, stage_hard:stage_hard + 32] = x_blk
        col = np.zeros((B, 2, BPL, 32), np.uint32)
        buf = np.zeros((B, 32, 2, BPL), np.uint32)
        for s in range(steps):
            if soft:
                q8 = region[:, xy + 8 * s:xy + 8 * s + 8].view(np.int8)
                q8 = q8.astype(np.int64)[:, None, None, :NQ]   # [B, 1, 1, NQ]
                r = rest[:, s, None, None]
                f1 = (q8 * bits).sum(-1) + np.where(upper, r, 0)
                f2 = q8.sum(-1) + r - f1
            else:
                seg = region[:, stage_hard + s].astype(np.uint32)
                f1 = np.bitwise_count((seg[:, None, None] ^ code) & (
                    (1 << n) - 1)).astype(np.int64)
                f2 = n - f1
            u1, w1, u2, w2 = lo + f1, hi + f2, lo + f2, hi + f1
            g = np.stack([u1 > w1, u2 > w2], 1)              # [B, 2, BPL, 32]
            if steps == 32:
                col |= g.astype(np.uint32) << np.uint32(s)
            else:
                for h in range(2):
                    for j in range(BPL):
                        buf[:, s, h, j] = _ballot(g[:, h, j])
            x1 = np.minimum(u1, w1)[..., src1]
            x2 = np.minimum(u2, w2)[..., src2]
            nxt = np.stack([np.where(odd, x2, x1), np.where(odd, x1, x2)],
                           2).reshape(B, 2 * BPL, 32)
            lo, hi = nxt[:, :BPL], nxt[:, BPL:]
        if steps == 32:   # word 64 j + 32 h + lane of the block's NS
            words[:, t0 * W:(t0 + 32) * W] = col.transpose(0, 2, 1, 3).reshape(
                B, NS)
        else:             # rows: d1's low half and d2's high half, and back
            lo16, hi16 = np.uint32(0xFFFF), np.uint32(0xFFFF0000)
            d1, d2 = buf[:, :steps, 0], buf[:, :steps, 1]
            rows = np.concatenate([(d1 & lo16) | (d2 & hi16),
                                   (d2 & lo16) | (d1 & hi16)], -1)
            words[:, t0 * W:T * W] = rows.reshape(B, -1)
    return words


def _decision(spec, region, T, t, state, per_channel):
    """Decisions at step t as `walk_step` reads them (columns below
    T - T % 32, rows from there; T = 0: rows only): per_channel, of
    state[c] on channel c ([B]); else of each state on every channel
    ([B, len(state)])."""
    NS, W, top = spec.num_states, spec.num_states // 32, spec.S - 1
    b, p = state >> 1, state & 1
    if t < T & ~31:
        h = p ^ ((b >> 4) & 1)
        idx, shift = (t >> 5) * NS + (b >> 5) * 64 + h * 32 + (b & 31), t & 31
    else:
        i = b | (p << top)
        idx, shift = t * W + (i >> 5), i & 31
    shift = np.asarray(shift, np.uint32)
    if per_channel:
        return (region[np.arange(len(state)), idx] >> shift) & 1
    return (region[:, idx] >> shift) & 1


def _walk_region(spec, region, T, L, cols=True):
    """The terminated walk from state 0 at step T - 1 over the region:
    bits [B, L].  `cols`: the warp kernel's region (columns below
    T - T % 32); else every step a row (the wide template's)."""
    top = spec.S - 1
    cur = np.zeros(region.shape[0], np.int64)
    out = np.zeros((region.shape[0], L), np.uint8)
    for t in range(T - 1, -1, -1):
        if t < L:
            out[:, t] = cur & 1
        d = _decision(spec, region, T if cols else 0, t, cur, True)
        cur = (cur >> 1) | (d.astype(np.int64) << top)
    return out


def _region_rows(spec, region, T):
    """Every state's decision at every step, read as the walk reads them,
    packed as the plain forward's words: uint32 [B, T, W]."""
    NS, W, top = spec.num_states, spec.num_states // 32, spec.S - 1
    state = np.arange(NS)
    i = (state >> 1) | ((state & 1) << top)
    rows = np.zeros((region.shape[0], T, W), np.uint32)
    for t in range(T):
        d = _decision(spec, region, T, t, state, False).astype(np.uint32)
        for w in range(W):
            sel = (i >> 5) == w
            rows[:, t, w] = (d[:, sel] << (i[sel] & 31).astype(
                np.uint32)).sum(1, dtype=np.uint32)
    return rows


MODEL_CASES = [(NS, mode) for NS in (64, 128, 256)
               for mode in ("hard", "soft", "soft_n9")]


@pytest.mark.parametrize("NS,mode", MODEL_CASES,
                         ids=[f"NS{c[0]}_{c[1]}" for c in MODEL_CASES])
def test_block_1p_schedule_model(NS, mode):
    """The model of the warp kernel's schedule (lanes' butterflies, the
    first/second shuffle's destinations, em or emc by lane, a whole block's
    decisions as columns and the last block's as ballots in lane s put
    right by the byte permute, the region's layout, the staged inputs in
    the walk's scratch, soft metrics offset by sum(relu(-q)) a step) gives
    the plain forward's decisions, read as the walk reads them, at T < 32,
    at multiples of 32 and between; the walk over the region gives
    `block_decode_1p_plain`'s bits, whole and cut."""
    rng = np.random.default_rng(NS + len(mode))
    n = {"hard": 6, "soft": 6, "soft_n9": 9}[mode]
    K = NS.bit_length()
    spec = port.CodeSpec(**ROUTE_CODES["K7_R16"]) if (NS, n) == (64, 6) \
        else _bfly_code(rng, K, n)
    soft = mode != "hard"
    for T in (1, 5, 31, 32, 33, 64, 97):
        B = 3
        if soft:
            x = rng.integers(-128, 128, (B, T, n)).astype(np.int8)
            words, _ = kernels.acs.acs_forward_batch_soft_plain(spec, _t(x),
                                                                127)
        else:
            x = rng.integers(0, 1 << n, (B, T)).astype(np.uint8)
            words, _ = kernels.acs.acs_forward_batch_plain(spec, _t(x))
        region = _model_block_1p(spec, x, T, soft)
        np.testing.assert_array_equal(_region_rows(spec, region, T),
                                      words.numpy().view(np.uint32),
                                      err_msg=f"T={T}")
        for L in {max(T - spec.S, 0), max(T - spec.S - 5, 0)}:
            got = _walk_region(spec, region, T, L)
            want = single_pass.block_decode_1p_plain(spec, _t(x), T, soft,
                                                     "bits", L)
            np.testing.assert_array_equal(got, want.numpy(), err_msg=f"T={T}")


def _bfly_code(rng, K, n):
    """A random poly-symmetric rate-1/n code of constraint length K."""
    top = 1 << (K - 1)
    g = tuple(int(top | 1 | (rng.integers(0, top >> 1) << 1))
              for _ in range(n))
    return port.CodeSpec(K=K, g=g)


def test_channel_regions_fit_as_before():
    """Rounding a channel's region up to 16 bytes never takes a T past the
    227 KB (a multiple of 16) that `smem_bytes` admits: at NS 64 ... 256
    the stride fits exactly where the region does."""
    for NS in (64, 128, 256):
        spec = port.CodeSpec(K=NS.bit_length(), g=(0o1 | 1 << (
            NS.bit_length() - 1),) * 2)
        for T in range(1, 232448 * 8 // NS + 64, 7):
            stride = _channel_region(T, NS)[0]
            fits = single_pass.smem_bytes(spec, T) <= single_pass.SMEM_BYTES
            assert (stride <= single_pass.SMEM_BYTES) == fits, (NS, T)


# ---------------------------------------------------------------------------
# The wide template (`block_1p_wide`, NS 512 ... 4096): the wide forward's
# rounds (csrc/acs_round.cuh) writing each step's words into the channel's
# rows, then the warp's walk over rows.

_CSRC = Path(kernels.__file__).resolve().parent.parent / "csrc"


def _wide():
    """tests/test_torch_wide.py, whose numpy model of the wide forward's
    rounds (`_round_model`) the wide template's test shares."""
    path = Path(__file__).resolve().parent / "test_torch_wide.py"
    spec = importlib.util.spec_from_file_location("_torch_wide_model", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


_ROUND_MODEL = _wide()._round_model


def _wide_template_steps():
    """NS -> the steps a round R at which csrc/block_1p.cu's dispatch
    switch (`launch_wide`) launches the wide template."""
    src = (_CSRC / "block_1p.cu").read_text()
    return {int(ns): int(r) for ns, _, r in re.findall(
        r"case (\d+): return launch_round<(\d+), (\d+)>", src)}


_WIDE_STEPS = _wide_template_steps()
WIDE_CASES = [(NS, mode, n) for NS in (512, 1024) for mode in ("hard", "soft")
              for n in range(1, 9)]


@pytest.mark.parametrize("NS,mode,n", WIDE_CASES,
                         ids=[f"NS{c[0]}_{c[1]}_n{c[2]}" for c in WIDE_CASES])
def test_wide_template_round_model(NS, mode, n):
    """The wide template's rounds at the R its switch launches, modelled by
    test_torch_wide.py's model of the two-pass wide forward (closed groups,
    the swizzled exchange, ballots, packed fields joined by shuffles; soft:
    the round's tables from the LLRs floored at -127), write into the
    region's rows exactly the plain forward's words, at every T mod R, T <
    R, whole rounds and the longest single-pass T; the warp's walk over
    those rows gives `block_decode_1p_plain`'s bits, whole and cut."""
    R = _WIDE_STEPS[NS]
    assert NS >> R >= 32
    soft = mode == "soft"
    rng = np.random.default_rng(NS + 16 * n + len(mode))
    spec = _bfly_code(rng, NS.bit_length(), n)
    cb = np.asarray(port.ops.trellis.butterfly_coded_bits(spec), np.int64)
    iv = port.ops.viterbi.init_metric_value(spec)
    top = 32768 * 8 // NS // 48 * 48
    assert single_pass.use_single_pass(spec, top)
    assert not single_pass.use_single_pass(spec, top + 1)
    for T in sorted(set(range(1, 2 * R + 1)) | {top}):
        B = 2
        if soft:
            x = rng.integers(-128, 128, (B, T, n)).astype(np.int8)
            words, _ = kernels.acs.acs_forward_batch_soft_plain(spec, _t(x),
                                                                127)
        else:
            x = rng.integers(0, 1 << n, (B, T)).astype(np.uint8)
            words, _ = kernels.acs.acs_forward_batch_plain(spec, _t(x))
        rows, _ = _ROUND_MODEL(NS, n, cb, x, None, iv, R,
                               (-127, 127) if soft else None)
        np.testing.assert_array_equal(rows, words.numpy(), err_msg=f"T={T}")
        region = rows.view(np.uint32).reshape(B, -1)
        for L in sorted({max(T - spec.S, 0), max(T - spec.S - 5, 0)}):
            got = _walk_region(spec, region, T, L, cols=False)
            want = single_pass.block_decode_1p_plain(spec, _t(x), T, soft,
                                                     "bits", L)
            np.testing.assert_array_equal(got, want.numpy(),
                                          err_msg=f"T={T} L={L}")


def test_wide_template_shared_memory_fits_what_the_wrapper_admits():
    """The wide template's dispatch covers NS = 512 ... 4096 at R with
    blocks of NS >> R >= 8R threads (the soft round's table threads), and
    its shared memory (`wide_smem`: the metric buffers, the rows, then the
    larger of the walk's scratch and the soft round's tables and LLRs, as
    acs_round.cuh sizes them) fits the card's 227 KB at every T that
    `smem_bytes` admits."""
    assert sorted(_WIDE_STEPS) == [512, 1024, 2048, 4096]
    header = (_CSRC / "acs_round.cuh").read_text()
    tab_step = int(re.search(r"constexpr int kTabStep = (\d+);",
                             header).group(1))
    for NS, R in _WIDE_STEPS.items():
        assert NS >> R >= max(32, 8 * R)
        spec = port.CodeSpec(K=NS.bit_length(), g=(1 | NS,) * 5)
        tables = 4 * (2 * R * tab_step + 2 * R * 8)
        for T in range(1, 232448 * 8 // NS + 64, 3):
            walk = 4 * 64 + 4 * -(-T // 32)
            kernel = 8 * NS + T * NS // 8 + max(walk, tables)
            if single_pass.smem_bytes(spec, T) <= single_pass.SMEM_BYTES:
                assert kernel <= single_pass.SMEM_BYTES, (NS, T)
