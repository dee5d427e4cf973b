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
32 KiB boundary.
"""

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
