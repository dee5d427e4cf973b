"""The port's channel models against the JAX package's, on inputs made with
numpy.  Deterministic functions are held exactly (float ones within 1e-6
relative); the random channels draw from different generators, so they are
held to their distributions."""

import math

import numpy as np
import pytest
import torch

import jax

from convolutionalencdec_tpu.ops import channel as ref_channel

from convolutionalencdec_tpu_torch.ops import channel


@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_segments_bits_round_trip_matches_reference(n):
    rng = np.random.default_rng(n)
    segs = rng.integers(0, 1 << n, (4, 37), dtype=np.uint8)
    bits = channel.segments_to_bits(torch.from_numpy(segs), n)
    want = np.asarray(ref_channel.segments_to_bits(segs, n))
    np.testing.assert_array_equal(bits.numpy(), want)
    assert bits.dtype == torch.uint8 and bits.shape == (4, 37 * n)
    # Generator j's bit sits at position j within a segment.
    for j in range(n):
        np.testing.assert_array_equal(bits.numpy()[:, j::n], (segs >> j) & 1)
    back = channel.bits_to_segments(bits, n)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(ref_channel.bits_to_segments(want, n)))
    np.testing.assert_array_equal(back.numpy(), segs)


def test_bpsk_modulate_and_hard_decision_match_reference():
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 2, (5, 64), dtype=np.uint8)
    sym = channel.bpsk_modulate(torch.from_numpy(bits))
    assert sym.dtype == torch.float32
    np.testing.assert_array_equal(sym.numpy(),
                                  np.asarray(ref_channel.bpsk_modulate(bits)))
    llr = rng.normal(0, 3, (5, 64)).astype(np.float32)
    llr[0, :4] = [0.0, -0.0, 1e-30, -1e-30]
    hard = channel.hard_decision(torch.from_numpy(llr))
    assert hard.dtype == torch.uint8
    np.testing.assert_array_equal(hard.numpy(),
                                  np.asarray(ref_channel.hard_decision(llr)))
    # A positive LLR favours bit 0.
    np.testing.assert_array_equal(
        channel.hard_decision(channel.bpsk_modulate(torch.from_numpy(bits)))
        .numpy(), bits)


@pytest.mark.parametrize("ebn0_db, rate", [(3.0, 0.5), (-1.5, 1 / 3),
                                           (6.0, 0.75)])
def test_bpsk_llr_matches_reference(ebn0_db, rate):
    y = np.random.default_rng(4).normal(0, 1.5, (3, 50)).astype(np.float32)
    got = channel.bpsk_llr(torch.from_numpy(y), ebn0_db, rate).numpy()
    want = np.asarray(ref_channel.bpsk_llr(y, ebn0_db, rate))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("snr_db", [-3.0, 0.0, 2.5, 7.0])
def test_uncoded_ber_bpsk_matches_reference(snr_db):
    for oversample in (1, 4):
        got = channel.uncoded_ber_bpsk(snr_db, oversample)
        want = ref_channel.uncoded_ber_bpsk(snr_db, oversample)
        assert got == pytest.approx(want, rel=1e-6)


def test_awgn_statistics():
    """Different random streams from JAX's: the noise std is within 2% of
    sqrt(1 / (2 Es/N0)) and its mean within 5 sigma / sqrt(N) of 0, on 10^6
    samples from a seeded generator."""
    ebn0_db, rate, bps = 2.0, 0.5, 2
    N = 10 ** 6
    symbols = torch.from_numpy(
        channel.bpsk_modulate(torch.zeros(N, dtype=torch.uint8)).numpy())
    rx = channel.awgn(symbols, ebn0_db, rate, bps,
                      generator=torch.Generator().manual_seed(11))
    assert rx.dtype == torch.float32 and rx.shape == (N,)
    sigma = math.sqrt(1.0 / (2.0 * 10 ** (ebn0_db / 10) * rate * bps))
    noise = (rx - symbols).double()
    assert abs(float(noise.std()) / sigma - 1.0) < 0.02
    assert abs(float(noise.mean())) < 5 * sigma / math.sqrt(N)
    again = channel.awgn(symbols, ebn0_db, rate, bps,
                         generator=torch.Generator().manual_seed(11))
    assert torch.equal(rx, again)
    ref = np.asarray(ref_channel.awgn(jax.random.PRNGKey(11),
                                      symbols.numpy(), ebn0_db, rate, bps))
    assert abs(float(np.std(ref - symbols.numpy())) / sigma - 1.0) < 0.02


def test_bsc_bits_statistics():
    p, shape = 0.05, (64, 1024)
    bits = np.random.default_rng(2).integers(0, 2, shape, dtype=np.uint8)
    got = channel.bsc(torch.from_numpy(bits), p,
                      torch.Generator().manual_seed(3))
    want = np.asarray(ref_channel.bsc(jax.random.PRNGKey(3), bits, p))
    assert got.dtype == torch.uint8
    trials = bits.size
    sigma = math.sqrt(p * (1 - p) / trials)
    for out in (got.numpy(), want):
        assert set(np.unique(out)) <= {0, 1}
        assert abs((out != bits).mean() - p) < 5 * sigma
