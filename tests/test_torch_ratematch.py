"""The port's LTE rate matching (36.212 5.1.4.2) against the JAX package, on
inputs made with numpy: the index maps, `rate_match` and `derate_match`,
on integer and float values.  Tolerance: exact equality (float inputs are
multiples of 1/4, so every sum of copies is exact in any order)."""

import numpy as np
import pytest
import torch

import convolutionalencdec_tpu as ref
from convolutionalencdec_tpu.ops import ratematch as ref_rm

import convolutionalencdec_tpu_torch as port
from convolutionalencdec_tpu_torch.ops import ratematch as rm

DS = [1, 31, 32, 33, 56, 120]


def _spec(n):
    """A reference and a port spec with n coded bits."""
    name = {2: "NASA_K7", 3: "LTE_TBCC_K7"}[n]
    return getattr(ref, name), port.PRESETS[name]


def _lengths(n, D):
    """E below, at and above n D."""
    return sorted({max(1, n * D // 2), n * D - 1 or 1, n * D, 2 * n * D + 7})


@pytest.mark.parametrize("D", DS)
@pytest.mark.parametrize("n", [2, 3])
def test_index_maps_match_reference(n, D):
    np.testing.assert_array_equal(rm.subblock_interleave_map(D),
                                  ref_rm.subblock_interleave_map(D))
    np.testing.assert_array_equal(rm.circular_buffer_map(n, D),
                                  ref_rm.circular_buffer_map(n, D))
    assert sorted(rm.circular_buffer_map(n, D)) == list(range(n * D))
    for E in _lengths(n, D):
        got = rm.ratematch_indices(n, D, E)
        assert got.dtype == np.int32 and got.shape == (E,)
        np.testing.assert_array_equal(got, ref_rm.ratematch_indices(n, D, E))


def _values(rng, shape, kind):
    if kind == "int":
        return rng.integers(-9, 10, shape).astype(np.int32)
    return (rng.integers(-40, 41, shape) / 4).astype(np.float32)


@pytest.mark.parametrize("kind", ["int", "float"])
@pytest.mark.parametrize("n", [2, 3])
def test_rate_match_matches_reference(n, kind):
    ref_spec, spec = _spec(n)
    rng = np.random.default_rng(n)
    for D in (31, 56):
        coded = _values(rng, (3, D * n), kind)
        for E in _lengths(n, D):
            got = rm.rate_match(torch.from_numpy(coded), spec, D, E)
            want = np.asarray(ref_rm.rate_match(coded, ref_spec, D, E))
            assert got.dtype == torch.from_numpy(want).dtype
            np.testing.assert_array_equal(got.numpy(), want)
            seg = coded.reshape(3, D, n)
            got = rm.rate_match_segments(seg, spec, E, device="cpu")
            np.testing.assert_array_equal(
                got.numpy(),
                np.asarray(ref_rm.rate_match_segments(seg, ref_spec, E)))


@pytest.mark.parametrize("qmax", [None, 7])
@pytest.mark.parametrize("kind", ["int", "float"])
@pytest.mark.parametrize("n", [2, 3])
def test_derate_match_matches_reference(n, kind, qmax):
    ref_spec, spec = _spec(n)
    rng = np.random.default_rng(10 * n + (qmax or 0))
    for D in (33, 56):
        for E in _lengths(n, D):
            llrs = _values(rng, (2, 3, E), kind)
            got = rm.derate_match(torch.from_numpy(llrs), spec, D, qmax)
            want = np.asarray(ref_rm.derate_match(llrs, ref_spec, D, qmax))
            assert got.shape == (2, 3, D, n)
            assert got.dtype == torch.from_numpy(want).dtype, (got.dtype,
                                                               want.dtype)
            np.testing.assert_array_equal(got.numpy(), want)


def test_derate_match_combines_every_copy():
    """At E = 2 n D + 7 every codeword slot receives two or three copies,
    and the sum is the slot's value times its copy count."""
    _, spec = _spec(3)
    D = 56
    E = 2 * 3 * D + 7
    values = torch.arange(1, 3 * D + 1, dtype=torch.int32)[None]
    rx = rm.rate_match(values, spec, D, E)
    combined = rm.derate_match(rx, spec, D).reshape(1, -1)
    counts = torch.bincount(torch.from_numpy(
        rm.ratematch_indices(3, D, E)).long(), minlength=3 * D)
    assert set(counts.tolist()) == {2, 3}
    assert torch.equal(combined, values * counts.to(torch.int32))


def test_rejects_empty_lengths():
    for fn, args in ((rm.subblock_interleave_map, (0,)),
                     (rm.ratematch_indices, (3, 10, 0))):
        with pytest.raises(ValueError):
            fn(*args)
