"""The port's CRC module and CRC-aided list decode against the JAX package,
on inputs made with numpy.  Tolerance: exact equality of every bit, flag and
index; list metrics are compared as differences within a channel (the JAX
kernels renormalise them, the port subtracts each channel's least).

Three tests share one interpret-mode run of the JAX package's soft wrap and
list decodes on LTE_TBCC_K7 (its 16-bit soft route at qmax = 7): the soft
CRC-list chain, the list metrics and the -128 probe.  The rest compares with
the JAX CRC functions, the numpy LFSR oracle and the JAX scans.
"""

import functools

import numpy as np
import pytest
import torch

import jax

import convolutionalencdec_tpu as ref
from convolutionalencdec_tpu.kernels import tailbiting as ref_ktb
from convolutionalencdec_tpu.ops import crc as ref_crc
from convolutionalencdec_tpu.ops import tailbiting as ref_tb

import convolutionalencdec_tpu_torch as port
from convolutionalencdec_tpu_torch.kernels import tailbiting as ktb
from convolutionalencdec_tpu_torch.ops import crc

PRESETS = ["CRC6_NR", "CRC8_LTE", "CRC11_NR", "CRC16_CCITT", "CRC24A",
           "CRC24B"]
SPECS = PRESETS + ["init_xor"]


def _crcs(name):
    if name == "init_xor":
        return (ref_crc.CrcSpec(16, 0x1021, init=0xFFFF, xor_out=0xFFFF),
                crc.CrcSpec(16, 0x1021, init=0xFFFF, xor_out=0xFFFF))
    return getattr(ref_crc, name), getattr(crc, name)


def _as_int(bits):
    return int("".join(map(str, bits)), 2)


@pytest.mark.parametrize("name", PRESETS)
def test_presets_match_reference(name):
    want, got = _crcs(name)
    for field in ("width", "poly", "init", "xor_out"):
        assert getattr(got, field) == getattr(want, field), field
    assert getattr(port, name) is got


@pytest.mark.parametrize("name", SPECS)
def test_crc_bits_match_reference_and_oracle(name):
    want_spec, spec = _crcs(name)
    rng = np.random.default_rng(42 + spec.width)
    for L in (spec.width, 40, 121):
        bits = rng.integers(0, 2, (5, L), dtype=np.uint8)
        got = crc.crc_bits(spec, torch.from_numpy(bits))
        assert got.dtype == torch.uint8 and got.shape == (5, spec.width)
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(ref_crc.crc_bits(want_spec, bits)))
        M, c = crc._crc_matrix(spec, L)
        M_ref, c_ref = ref_crc._crc_matrix(want_spec, L)
        np.testing.assert_array_equal(M, M_ref)
        np.testing.assert_array_equal(c, c_ref)
        for i in range(5):
            oracle = crc.crc_remainder_np(spec, bits[i])
            assert oracle == ref_crc.crc_remainder_np(want_spec, bits[i])
            assert _as_int(got[i].tolist()) == oracle, (L, i)


def test_crc_bits_keep_leading_dims():
    rng = np.random.default_rng(5)
    bits = rng.integers(0, 2, (2, 3, 57), dtype=np.uint8)
    got = crc.crc_bits(crc.CRC16_CCITT, bits, device="cpu")
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(ref_crc.crc_bits(ref_crc.CRC16_CCITT, bits)))


def test_check_value_0x31c3():
    """"123456789" in ASCII, MSb-first: CRC-16/XMODEM (poly 0x1021, init 0,
    no reflection, no xor_out) is the published check value 0x31C3."""
    bits = np.unpackbits(np.frombuffer(b"123456789", np.uint8))
    assert crc.crc_remainder_np(crc.CRC16_CCITT, bits) == 0x31C3
    got = crc.crc_bits(crc.CRC16_CCITT, torch.from_numpy(bits[None]))[0]
    assert _as_int(got.tolist()) == 0x31C3


@pytest.mark.parametrize("name", ["CRC8_LTE", "CRC16_CCITT", "CRC24A"])
def test_append_check_round_trip(name):
    want_spec, spec = _crcs(name)
    rng = np.random.default_rng(7)
    msgs = rng.integers(0, 2, (16, 100), dtype=np.uint8)
    block = crc.crc_append(spec, torch.from_numpy(msgs))
    assert block.shape == (16, 100 + spec.width)
    np.testing.assert_array_equal(
        block.numpy(), np.asarray(ref_crc.crc_append(want_spec, msgs)))
    assert crc.crc_check(spec, block).all()
    bad = block.clone()
    for i in range(16):                 # any single-bit flip is detected
        bad[i, rng.integers(0, block.shape[1])] ^= 1
    ok = crc.crc_check(spec, bad)
    assert ok.dtype == torch.bool and not ok.any()
    np.testing.assert_array_equal(
        ok.numpy(), np.asarray(ref_crc.crc_check(want_spec, bad.numpy())))


@pytest.mark.parametrize("kwargs", [
    dict(width=0, poly=1), dict(width=33, poly=1), dict(width=8, poly=0x1FF),
    dict(width=8, poly=7, init=0x100), dict(width=8, poly=7, xor_out=0x100),
], ids=["w0", "w33", "poly", "init", "xor_out"])
def test_crcspec_validation_matches_reference(kwargs):
    with pytest.raises(ValueError):
        ref_crc.CrcSpec(**kwargs)
    with pytest.raises(ValueError):
        crc.CrcSpec(**kwargs)


# ---------------------------------------------------------------------------
# The CRC-aided list decode.


def _dci_batch(ref_spec, B, L, seed, noise=4):
    """CRC16-attached blocks of L bits, tail-biting encoded, as int8 LLRs:
    magnitudes 0..7 with the coded bit's sign plus uniform noise in
    [-noise, noise], clipped to +-7, and 3% of them -128, 127 or -127."""
    rng = np.random.default_rng(seed)
    payload = rng.integers(0, 2, (B, L - 16), dtype=np.uint8)
    msgs = np.asarray(ref_crc.crc_append(ref_crc.CRC16_CCITT, payload))
    coded = np.asarray(ref_tb.encode_tailbiting(ref_spec, msgs))
    planes = np.stack([(coded >> j) & 1 for j in range(ref_spec.n)], -1)
    q = (1 - 2 * planes.astype(np.int32)) * rng.integers(0, 8, planes.shape)
    q = np.clip(q + rng.integers(-noise, noise + 1, q.shape), -7, 7)
    strong = rng.random(q.shape) < 0.03
    q = np.where(strong, rng.choice(np.array([-128, 127, -127]), q.shape), q)
    return msgs, q.astype(np.int8)


def _ref_crc_soft_scans(ref_spec, q, list_size, qclip):
    """The JAX CRC-list chain composed from its scans at the kernel routes'
    wraps and its own `_crc_select`, on the LLRs clipped to +-qclip where
    its route clips (qclip < 127; -128 stays on its 16-bit route)."""
    T = q.shape[1]
    wraps = ref_ktb.kernel_wraps(ref_spec, T)
    wl = ref_ktb.list_wrap(ref_spec, T)
    q32 = q.astype(np.int32)
    if qclip < 127:
        q32 = np.clip(q32, -qclip, qclip)
    plain = jax.vmap(lambda x: ref_tb.viterbi_decode_tailbiting_soft(
        ref_spec, x, wraps))(q32)
    cands, _ = jax.vmap(lambda x: ref_tb.viterbi_decode_tailbiting_list_soft(
        ref_spec, x, list_size, wl))(q32)
    return [np.asarray(a) for a in
            ref_ktb._crc_select(ref_crc.CRC16_CCITT, plain, cands)]


def _check_chain(got, want):
    bits, ok, chosen = got
    assert bits.dtype == torch.uint8 and ok.dtype == torch.bool
    assert chosen.dtype == torch.int32
    for g, w in zip((bits, ok, chosen), want):
        np.testing.assert_array_equal(g.numpy(), w)


def test_select_matches_reference():
    """`_crc_select` on candidate sets where the wrap decode passes, where
    only a later candidate does, and where nothing does."""
    rng = np.random.default_rng(3)
    B, Lc, T = 6, 3, 40
    payload = rng.integers(0, 2, (B, 1 + Lc, T - 16), dtype=np.uint8)
    allb = np.array(ref_crc.crc_append(ref_crc.CRC16_CCITT, payload))
    corrupt = rng.random((B, 1 + Lc)) < 0.6
    allb[..., 0] ^= corrupt.astype(np.uint8)
    want = ref_ktb._crc_select(ref_crc.CRC16_CCITT, allb[:, 0], allb[:, 1:])
    got = ktb._crc_select(crc.CRC16_CCITT, torch.from_numpy(allb[:, 0]),
                          torch.from_numpy(allb[:, 1:]))
    _check_chain(got, [np.asarray(w) for w in want])


@pytest.mark.parametrize("name", ["NASA_K7", "LTE_TBCC_K7"])
def test_crc_chains_match_reference_scans(name):
    """The hard and soft CRC chains on the kernel route (plain versions on
    CPU tensors) against the JAX scans at the same wraps, with the JAX
    selection; the rescue and never-worse properties hold."""
    ref_spec, spec = getattr(ref, name), port.PRESETS[name]
    msgs, q = _dci_batch(ref_spec, 8, 64, seed=11, noise=5)
    got = ktb.viterbi_decode_batch_tailbiting_crc_soft(
        spec, crc.CRC16_CCITT, torch.from_numpy(q), 4)
    qclip = port.kernels.soft_qclip(spec, 7)
    assert qclip == (7 if name == "NASA_K7" else 127)
    _check_chain(got, _ref_crc_soft_scans(ref_spec, q, 4, qclip))
    planes = (q < 0).astype(np.uint8)
    seg = sum(planes[..., j] << j for j in range(ref_spec.n)).astype(np.uint8)
    hard = ktb.viterbi_decode_batch_tailbiting_crc(spec, crc.CRC16_CCITT,
                                                   seg, 4, device="cpu")
    wraps, wl = ref_ktb.kernel_wraps(ref_spec, 64), ref_ktb.list_wrap(
        ref_spec, 64)
    plain = jax.vmap(lambda s: ref_tb.viterbi_decode_tailbiting(
        ref_spec, s, wraps))(seg)
    cands, _ = jax.vmap(lambda s: ref_tb.viterbi_decode_tailbiting_list(
        ref_spec, s, 4, wl))(seg)
    want = ref_ktb._crc_select(ref_crc.CRC16_CCITT, plain, cands)
    _check_chain(hard, [np.asarray(w) for w in want])
    bits, ok, _ = got
    plain_right = (ktb.viterbi_decode_batch_tailbiting_soft(
        spec, torch.from_numpy(q)).numpy() == msgs).all(1)
    right = (bits.numpy() == msgs).all(1)
    assert not (plain_right & ~right).any()
    assert crc.crc_check(crc.CRC16_CCITT, bits[ok]).all()


def test_punctured_and_ratematched_chains_match_their_parts():
    """The punctured chain equals depuncture + the soft chain, the
    rate-matched one derate_match + the soft chain, and both recover clean
    blocks."""
    spec = port.LTE_TBCC_K7
    rng = np.random.default_rng(21)
    B, L = 4, 56
    payload = rng.integers(0, 2, (B, L - 16), dtype=np.uint8)
    msgs = crc.crc_append(crc.CRC16_CCITT, torch.from_numpy(payload))
    cbits = port.segments_to_bits(port.encode_tailbiting(spec, msgs), spec.n)
    pattern = ((1, 1), (1, 0), (1, 0))
    tx = port.puncture_bits(cbits, pattern, L)
    rx = (1 - 2 * tx.to(torch.int32)) * 5
    one = ktb.viterbi_decode_batch_tailbiting_punctured_crc(
        spec, crc.CRC16_CCITT, rx, pattern, L, 4)
    q = port.depuncture_llrs(rx.to(torch.int8), pattern, L).reshape(B, L, 3)
    two = ktb.viterbi_decode_batch_tailbiting_crc_soft(spec, crc.CRC16_CCITT,
                                                       q, 4)
    for a, b in zip(one, two):
        assert torch.equal(a, b)
    assert torch.equal(one[0], msgs) and one[1].all()
    E = 288
    rx = (1 - 2 * port.rate_match(cbits, spec, L, E).to(torch.int32)) * 3
    one = ktb.viterbi_decode_batch_tailbiting_ratematched_crc(
        spec, crc.CRC16_CCITT, rx, L)
    q = port.derate_match(rx, spec, L, qmax=7)
    two = ktb.viterbi_decode_batch_tailbiting_crc_soft(
        spec, crc.CRC16_CCITT, q, 8)
    for a, b in zip(one, two):
        assert torch.equal(a, b)
    assert torch.equal(one[0], msgs) and one[1].all()
    assert (one[2] == 0).all()


@functools.lru_cache(maxsize=None)
def _reference_kernel_run():
    """One interpret-mode run of the JAX package's soft wrap decode and soft
    list decode (list 4) on LTE_TBCC_K7, its 16-bit soft route at qmax 7,
    shared by the three tests below (each call takes ~25 s).  The batch is
    6 DCI-like blocks and 4 rows of LLRs from {-128, -127, 127, 0}, where
    ties make -128 against -127 show.

    Returns (msgs, q, wrap bits, list bits, list metrics)."""
    msgs, q_dci = _dci_batch(ref.LTE_TBCC_K7, 6, 56, seed=4, noise=6)
    q_probe = np.random.default_rng(0).choice(
        np.array([-128, -127, 127, 0]), (4, 56, 3),
        p=[.3, .2, .3, .2]).astype(np.int8)
    q = np.concatenate([q_dci, q_probe])
    plain = ref_ktb.viterbi_decode_batch_tailbiting_soft(
        ref.LTE_TBCC_K7, q, None, True)
    cands, metrics = ref_ktb.viterbi_decode_batch_tailbiting_list_soft(
        ref.LTE_TBCC_K7, q, 4, None, True)
    return msgs, q, np.asarray(plain), np.asarray(cands), np.asarray(metrics)


def test_crc_soft_matches_reference_kernels_interpret():
    """The soft CRC-list chain against the JAX package's kernels: its
    `viterbi_decode_batch_tailbiting_crc_soft` is the wrap decode, the list
    decode and `_crc_select` (kernels/tailbiting.py:384-388), here run as
    those calls in interpret mode.  Bits, ok and chosen are equal."""
    msgs, q, plain, cands, _ = _reference_kernel_run()
    want = ref_ktb._crc_select(ref_crc.CRC16_CCITT, plain, cands)
    got = ktb.viterbi_decode_batch_tailbiting_crc_soft(
        port.LTE_TBCC_K7, crc.CRC16_CCITT, torch.from_numpy(q), 4)
    _check_chain(got, [np.asarray(w) for w in want])
    bits, ok, chosen = got
    right = (bits[:6].numpy() == msgs).all(1)
    assert ok[:6].numpy()[right].all() and not ok[6:].any()
    assert (chosen[:6] > 0).any(), "a block is rescued by a list candidate"


def test_list_soft_matches_reference_kernels_interpret():
    """The soft list decode against the JAX package's kernels: candidate
    bits equal, metric differences within each channel equal."""
    _, q, _, want_bits, want_m = _reference_kernel_run()
    bits, metrics = ktb.viterbi_decode_batch_tailbiting_list_soft(
        port.LTE_TBCC_K7, torch.from_numpy(q), 4)
    assert bits.shape == (10, 4, 56) and metrics.dtype == torch.int32
    np.testing.assert_array_equal(bits.numpy(), want_bits)
    want_m = want_m.astype(np.int64)
    np.testing.assert_array_equal(metrics.numpy() - metrics.numpy()[:, :1],
                                  want_m - want_m[:, :1])
    assert (metrics[:, 0] == 0).all() and (metrics.diff(dim=1) >= 0).all()


def test_minus_128_on_the_16_bit_route_matches_reference_kernel():
    """The JAX 16-bit soft kernel's pack adds 128 and never floors
    (kernels/acs_swar.py:1282), so -128 costs 128: on the probe rows its
    wrap and list decodes equal the unfloored JAX scans and not the floored
    ones (which differ from probe row 1, bit 0 of the wrap decode, and row
    0, candidate 0, bit 39 of the list), and the port's equal them
    (ROADMAP.md section 3)."""
    ref_spec, spec = ref.LTE_TBCC_K7, port.LTE_TBCC_K7
    assert port.select_kernel(spec, "soft", 7) == port.kernels.SOFT
    assert port.kernels.swar_layout_supported(spec)
    _, q, plain, cands, _ = _reference_kernel_run()
    q32 = q[6:].astype(np.int32)
    wraps = ref_ktb.kernel_wraps(ref_spec, 56)
    wl = ref_ktb.list_wrap(ref_spec, 56)
    results = []
    for x in (q32, np.maximum(q32, -127)):
        results.append((
            np.asarray(jax.vmap(lambda r: ref_tb.viterbi_decode_tailbiting_soft(
                ref_spec, r, wraps))(x)),
            np.asarray(jax.vmap(
                lambda r: ref_tb.viterbi_decode_tailbiting_list_soft(
                    ref_spec, r, 4, wl))(x)[0])))
    (wrap_u, list_u), (wrap_f, list_f) = results
    assert np.argwhere(wrap_u != wrap_f)[0].tolist() == [1, 0]
    assert np.argwhere(list_u != list_f)[0].tolist() == [0, 0, 39]
    np.testing.assert_array_equal(plain[6:], wrap_u)
    np.testing.assert_array_equal(cands[6:], list_u)
    got = ktb.viterbi_decode_batch_tailbiting_soft(spec, torch.from_numpy(q))
    np.testing.assert_array_equal(got[6:].numpy(), wrap_u)
    # The block routes keep their floor.
    words, _ = port.kernels.acs_forward_batch_soft(
        spec, torch.from_numpy(q), 127)
    floored, _ = port.kernels.acs_forward_batch_soft(
        spec, torch.from_numpy(np.maximum(q, -127)), 127)
    assert torch.equal(words, floored)
