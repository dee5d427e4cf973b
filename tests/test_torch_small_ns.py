"""The port's block decodes of small-state butterfly codes (NS = 2 ... 32,
K = 2 ... 6) on the CPU, where each kernel wrapper takes its plain version
(the CUDA kernels run only on the card, where chip_smoke.py holds them to
these plain versions).

Every entry the small codes now reach on the card (block bits and bytes,
soft bits and bytes, punctured hard and soft, ragged hard and soft) is held
bit for bit against `jax.vmap(viterbi_decode)`, `viterbi_decode_soft` and
the ragged scans of the JAX package, on noisy, garbage (tie-heavy) and
-128 inputs; and twice against the JAX package's small-state kernels
(TPU kernel K12, hard and soft) in interpret mode.
"""

import numpy as np
import pytest
import torch

import jax

import convolutionalencdec_tpu as ref
from convolutionalencdec_tpu.kernels import acs_pallas as ref_acs
from convolutionalencdec_tpu.ops import metrics as ref_metrics
from convolutionalencdec_tpu.ops import puncture as ref_puncture
from convolutionalencdec_tpu.ops import viterbi as ref_viterbi

import convolutionalencdec_tpu_torch as port
from convolutionalencdec_tpu_torch import kernels
from convolutionalencdec_tpu_torch.kernels import acs

# K = 2 (NS = 2, one state bit: S = 1), 3, 5 (the GSM-length preset), 6
# (NS = 32, a whole 32-bit word), and a rate-1/9 K=5 code: n > 8 decodes
# soft only, on the wide forward's runtime-n instantiation on the card.
CODES = {
    "K2": dict(K=2, g=(0o3, 0o3)),
    "K3": dict(K=3, g=(0o7, 0o5)),
    "K5_23_35": None,
    "K6": dict(K=6, g=(0o53, 0o75, 0o61)),
}
N9 = dict(K=5, g=(0o21, 0o23, 0o25, 0o27, 0o31, 0o33, 0o35, 0o37, 0o23))
B, L = 5, 61


def _specs(name):
    if CODES[name] is None:
        return getattr(ref, name), port.PRESETS[name]
    return ref.CodeSpec(**CODES[name]), port.CodeSpec(**CODES[name])


def _segments(spec, kind, seed, B=B, L=L):
    """(msgs, uint8 segments [B, L + S]): encoded and hit at 8% by nonzero
    XOR masks, or uniform garbage (tie-heavy)."""
    rng = np.random.default_rng(seed)
    msgs = rng.integers(0, 2, (B, L), dtype=np.uint8)
    coded = port.encode_bits(spec, torch.from_numpy(msgs))[0].numpy().copy()
    if kind == "garbage":
        return msgs, rng.integers(0, 1 << spec.n, coded.shape).astype(
            np.uint8)
    hit = rng.random(coded.shape) < 0.08
    return msgs, coded ^ (hit * rng.integers(1, 1 << spec.n, coded.shape)
                          ).astype(np.uint8)


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


def _scan(ref_spec, coded):
    return np.asarray(jax.vmap(lambda c: ref.viterbi_decode(ref_spec, c))(
        coded))


def _soft_scan(ref_spec, q):
    """The JAX soft scan on LLRs floored at -127 (every block route)."""
    q = np.maximum(q.astype(np.int32), -127)
    return np.asarray(jax.vmap(
        lambda x: ref.viterbi_decode_soft(ref_spec, x))(q))


@pytest.mark.parametrize("kind", ["noisy", "garbage"])
@pytest.mark.parametrize("name", list(CODES))
def test_hard_entries_match_vmapped_scan(name, kind):
    ref_spec, spec = _specs(name)
    assert kernels.select_kernel(spec) == kernels.BUTTERFLY
    _, coded = _segments(spec, kind, 3 + list(CODES).index(name))
    seg = torch.from_numpy(coded)
    want = _scan(ref_spec, coded)
    np.testing.assert_array_equal(
        kernels.viterbi_decode_batch(spec, seg).numpy(), want)
    np.testing.assert_array_equal(
        kernels.viterbi_decode_batch(spec, seg, L - 13).numpy(),
        want[:, :L - 13])
    np.testing.assert_array_equal(
        kernels.viterbi_decode_batch_bytes(spec, seg, L - 13).numpy(),
        np.packbits(want[:, :L - 13], axis=1))


@pytest.mark.parametrize("kind", ["noisy", "int8"])
@pytest.mark.parametrize("name", list(CODES) + ["N9"])
def test_soft_entries_match_vmapped_scan(name, kind):
    """No clip on these codes' soft route (the 8-bit rule needs NS >= 64);
    -128 floored at -127, as JAX's `_as_int8_qllrs`."""
    if name == "N9":
        ref_spec, spec = ref.CodeSpec(**N9), port.CodeSpec(**N9)
    else:
        ref_spec, spec = _specs(name)
    assert kernels.select_kernel(spec, "soft") == kernels.SOFT
    assert kernels.soft_qclip(spec, 7) == 127
    _, coded = _segments(spec, "noisy", 11)
    q = _llrs(spec, coded, kind, 12)
    want = _soft_scan(ref_spec, q)
    qt = torch.from_numpy(q)
    np.testing.assert_array_equal(
        kernels.viterbi_decode_batch_soft(spec, qt).numpy(), want)
    np.testing.assert_array_equal(
        kernels.viterbi_decode_batch_soft_bytes(spec, qt, L - 5).numpy(),
        np.packbits(want[:, :L - 5], axis=1))


@pytest.mark.parametrize("name", ["K3", "K5_23_35"])
def test_punctured_entries_match_reference(name):
    """Hard and soft punctured streams (rate 3/4): the depunctured +-1 or
    int8 LLRs through the JAX soft scan."""
    ref_spec, spec = _specs(name)
    pattern = port.ops.puncture.PUNCTURE_3_4
    _, coded = _segments(spec, "noisy", 21)
    T = coded.shape[1]
    bits = np.stack([(coded >> j) & 1 for j in range(spec.n)],
                    -1).reshape(B, T * spec.n)
    rx = np.array(ref_puncture.puncture_bits(bits, pattern, T))
    q_hard = np.asarray(ref_puncture.depuncture_llrs(
        ref_metrics.hard_bits_to_qllrs(rx), pattern, T))
    want = _soft_scan(ref_spec, q_hard.reshape(B, T, spec.n))
    got = kernels.viterbi_decode_batch_punctured(spec, torch.from_numpy(rx),
                                                 pattern, T)
    np.testing.assert_array_equal(got.numpy(), want)
    q = _llrs(spec, coded, "int8", 22).reshape(B, T * spec.n)
    q_rx = np.array(ref_puncture.puncture_bits(q, pattern, T))
    full = np.asarray(ref_puncture.depuncture_llrs(q_rx, pattern, T))
    want = _soft_scan(ref_spec, full.reshape(B, T, spec.n))
    got = kernels.viterbi_decode_batch_punctured_soft(
        spec, torch.from_numpy(q_rx), pattern, T)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["K2", "K5_23_35", "K6"])
def test_ragged_entries_match_reference(name):
    """Per-channel lengths 0, 1, S, S + 1 and T: the JAX ragged scans (the
    JAX package scans this decode for NS < 64)."""
    ref_spec, spec = _specs(name)
    _, coded = _segments(spec, "noisy", 31)
    T = coded.shape[1]
    lens = np.array([0, 1, spec.S, spec.S + 1, T], np.int32)
    want = np.asarray(ref_viterbi.viterbi_decode_ragged(ref_spec, coded,
                                                        lens))
    seg, lt = torch.from_numpy(coded), torch.from_numpy(lens)
    np.testing.assert_array_equal(
        kernels.viterbi_decode_batch_ragged(spec, seg, lt).numpy(), want)
    np.testing.assert_array_equal(
        kernels.viterbi_decode_batch_bytes_ragged(spec, seg, lt).numpy(),
        np.packbits(want, axis=1))
    q = _llrs(spec, coded, "int8", 32)
    want = np.asarray(ref_metrics.viterbi_decode_ragged_soft(
        ref_spec, np.maximum(q, -127), lens))
    np.testing.assert_array_equal(
        kernels.viterbi_decode_batch_soft_bytes_ragged(
            spec, torch.from_numpy(q), lt).numpy(),
        np.packbits(want, axis=1))


@pytest.mark.parametrize("name", list(CODES))
def test_one_word_layout_round_trip(name):
    """W = 1 word per step below 32 states: bit p * NS/2 + b for state
    2b + p, bits NS..31 zero; unpack inverts pack."""
    _, spec = _specs(name)
    NS = spec.num_states
    assert acs.decision_words(spec) == 1
    rng = np.random.default_rng(NS)
    dec = torch.from_numpy(rng.integers(0, 2, (3, 7, NS), dtype=np.uint8))
    words = acs.pack_decisions(spec, dec)
    assert words.shape == (3, 7, 1) and words.dtype == torch.int32
    w = words[..., 0].to(torch.int64) & 0xFFFFFFFF
    assert not (w >> NS).any()
    for s in range(NS):
        i = (s >> 1) + (s & 1) * NS // 2
        assert torch.equal((w >> i) & 1, dec[..., s].to(torch.int64)), s
    assert torch.equal(acs.unpack_decisions(spec, words), dec)


def test_interpreted_small_state_kernels_match():
    """One interpret-mode call each of the JAX package's K12 hard and soft
    kernels on K5_23_35 (B = 2, T = 100): bit for bit the port's entries."""
    ref_spec, spec = _specs("K5_23_35")
    _, coded = _segments(spec, "noisy", 51, B=2, L=96)
    want = np.asarray(ref_acs.viterbi_decode_batch(ref_spec, coded, None,
                                                   True))
    np.testing.assert_array_equal(
        kernels.viterbi_decode_batch(spec, torch.from_numpy(coded)).numpy(),
        want)
    q = _llrs(spec, coded, "int8", 52)
    want = np.asarray(ref_acs.viterbi_decode_batch_soft(ref_spec, q, None,
                                                        True))
    np.testing.assert_array_equal(
        kernels.viterbi_decode_batch_soft(spec, torch.from_numpy(q)).numpy(),
        want)
