"""The port's plain reference decoders against the JAX package's scans,
bit for bit, on noisy inputs made with numpy."""

import numpy as np
import pytest
import torch

import jax

import convolutionalencdec_tpu as ref
from convolutionalencdec_tpu.ops import viterbi as ref_viterbi

import convolutionalencdec_tpu_torch as port
from convolutionalencdec_tpu_torch.ops import viterbi as port_viterbi

SPEC_NAMES = ["NASA_K7", "REF_K7", "NASA_K7_R13", "LTE_TBCC_K7",
              "K9_561_753", "TOY_K3", "K5_23_35", "K3k2"]
K3K2 = dict(K=3, k=2, g=(0o17, 0o06, 0o13))
NOISE = [0.03, 0.25]
B, L = 4, 62
MESSAGE_BITS = [56, 62]  # a multiple of 8, and not


def _specs(name):
    if name == "K3k2":
        return ref.CodeSpec(**K3K2), port.CodeSpec(**K3K2)
    return getattr(ref, name), port.PRESETS[name]


def _noisy_segments(spec, p):
    rng = np.random.default_rng(int(p * 100) + spec.K * 7 + spec.n)
    msgs = rng.integers(0, 2, (B, L), dtype=np.uint8)
    coded = port.encode_bits(spec, torch.from_numpy(msgs))[0].numpy().copy()
    flip = rng.random(coded.shape) < p
    coded ^= (flip * rng.integers(1, 1 << spec.n, coded.shape)).astype(np.uint8)
    return coded


@pytest.mark.parametrize("p", NOISE)
@pytest.mark.parametrize("name", SPEC_NAMES)
def test_forward_matches_reference(name, p):
    ref_spec, spec = _specs(name)
    coded = _noisy_segments(spec, p)
    seg = torch.from_numpy(coded)
    assert port_viterbi.init_metric_value(spec) == \
        ref_viterbi.init_metric_value(ref_spec)
    init = np.random.default_rng(1).integers(
        0, 9, (B, spec.num_states)).astype(np.int32)

    bm = np.array(ref_viterbi.hard_step_metrics(ref_spec, coded))
    np.testing.assert_array_equal(
        port_viterbi.hard_step_metrics(spec, seg).numpy(), bm)
    want_d, want_m = jax.vmap(
        lambda b: ref_viterbi.viterbi_forward(ref_spec, b))(bm)
    got_d, got_m = port_viterbi.viterbi_forward(spec, torch.from_numpy(bm))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    if not spec.has_poly_symmetry:
        return
    for start in (None, init):
        want_d, want_m = jax.vmap(
            lambda c, i: ref_viterbi.viterbi_forward_butterfly(ref_spec, c, i),
            in_axes=(0, None if start is None else 0))(coded, start)
        got_d, got_m = port_viterbi.viterbi_forward_butterfly(
            spec, seg, None if start is None else torch.from_numpy(start))
        np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
        np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))


@pytest.mark.parametrize("p", NOISE)
@pytest.mark.parametrize("name", SPEC_NAMES)
def test_decode_matches_reference(name, p):
    ref_spec, spec = _specs(name)
    coded = _noisy_segments(spec, p)
    seg = torch.from_numpy(coded)

    decisions, _ = port_viterbi.viterbi_forward(
        spec, port_viterbi.hard_step_metrics(spec, seg))
    want_tb = jax.vmap(lambda d: ref_viterbi.traceback_terminated(
        ref_spec, d))(decisions.numpy())
    np.testing.assert_array_equal(
        port_viterbi.traceback_terminated(spec, decisions).numpy(),
        np.asarray(want_tb))

    want_bits = np.asarray(
        jax.vmap(lambda c: ref.viterbi_decode(ref_spec, c))(coded))
    np.testing.assert_array_equal(port.viterbi_decode(spec, seg).numpy(),
                                  want_bits)
    np.testing.assert_array_equal(want_tb, want_bits)
    for mb in MESSAGE_BITS:
        want = jax.vmap(
            lambda c: ref.viterbi_decode_bytes(ref_spec, c, mb))(coded)
        got = port.viterbi_decode_bytes(spec, seg, mb)
        assert got.shape == (B, (mb + 7) // 8)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _random_specs(seed, count):
    """Valid random (K, k, g) with k in {1, 2}, n <= 4 (the pattern of
    tests/test_fuzz_specs.py)."""
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < count:
        k = int(rng.integers(1, 3))
        K = int(rng.integers(2, {1: 8, 2: 4}[k] + 1))
        n = int(rng.integers(max(2, k), 5))
        g = tuple(int(rng.integers(1, 1 << (k * K))) for _ in range(n))
        try:
            ref.CodeSpec(K=K, k=k, g=g)
        except ValueError:
            continue
        out.append(dict(K=K, k=k, g=g))
    return out


FUZZ = _random_specs(20261016, 6)


@pytest.mark.parametrize(
    "kwargs", FUZZ,
    ids=[f"K{a['K']}k{a['k']}n{len(a['g'])}" for a in FUZZ])
def test_fuzz_random_specs_decode_matches_reference(kwargs):
    """Equivalence, not message recovery: a random code may be
    catastrophic."""
    ref_spec, spec = ref.CodeSpec(**kwargs), port.CodeSpec(**kwargs)
    rng = np.random.default_rng(spec.K * 100 + spec.k * 10 + spec.n)
    msgs = rng.integers(0, 2, (3, 24 * spec.k), dtype=np.uint8)
    coded = np.array(ref.encode_bits(ref_spec, msgs)[0])
    np.testing.assert_array_equal(
        port.encode_bits(spec, torch.from_numpy(msgs))[0].numpy(), coded)
    flip = rng.random(coded.shape) < 0.05
    coded ^= (flip * rng.integers(1, 1 << spec.n, coded.shape)).astype(np.uint8)
    want = jax.vmap(lambda c: ref.viterbi_decode(ref_spec, c))(coded)
    got = port.kernels.viterbi_decode_batch(spec, torch.from_numpy(coded))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
