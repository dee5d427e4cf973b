"""The whole slices, encode -> BSC -> byte decode and encode -> BPSK over
AWGN -> LLRs -> quantizer -> soft byte decode, through the port and through
the JAX package, on the same messages and the same channel noise (made with
numpy and given to both)."""

import numpy as np
import pytest
import torch

import jax

import convolutionalencdec_tpu as ref
from convolutionalencdec_tpu.ops import bits as ref_bits
from convolutionalencdec_tpu.ops import channel as ref_channel
from convolutionalencdec_tpu.ops import metrics as ref_metrics

import convolutionalencdec_tpu_torch as port

B, L = 16, 256
BER_LIMIT = 2e-3  # bench.py's sanity bound at 3% segment corruption


@pytest.mark.parametrize("name", ["NASA_K7", "NASA_K7_R13"])
def test_slice_matches_reference_chain(name):
    ref_spec, spec = getattr(ref, name), port.PRESETS[name]
    rng = np.random.default_rng(9865)
    msgs = rng.integers(0, 2, (B, L), dtype=np.uint8)
    flip = rng.random((B, L + spec.S)) < 0.03
    mask = (flip * rng.integers(1, 1 << spec.n, flip.shape)).astype(np.uint8)

    ref_coded = np.asarray(ref.encode_bits(ref_spec, msgs)[0]) ^ mask
    ref_out = np.asarray(jax.vmap(
        lambda c: ref.viterbi_decode_bytes(ref_spec, c))(ref_coded))

    seg, final_state = port.encode_bits(spec, torch.from_numpy(msgs))
    assert not final_state.any()
    rx = seg ^ torch.from_numpy(mask)
    np.testing.assert_array_equal(rx.numpy(), ref_coded)
    out = port.viterbi_decode_batch_bytes(spec, rx)
    assert out.dtype == torch.uint8 and out.shape == (B, L // 8)
    np.testing.assert_array_equal(out.numpy(), ref_out)

    ber = float((np.unpackbits(out.numpy(), axis=1) != msgs).mean())
    assert ber < BER_LIMIT, ber


def test_slice_with_port_channel_decodes():
    """The port's own BSC (torch generator) at a 1% coded-bit flip rate:
    the decoded BER stays under the bound."""
    spec = port.NASA_K7
    rng = np.random.default_rng(4)
    msgs = torch.from_numpy(rng.integers(0, 2, (B, L), dtype=np.uint8))
    seg, _ = port.encode_bits(spec, msgs)
    rx = port.bsc_segments(seg, spec.n, 0.01, torch.Generator().manual_seed(4))
    assert (rx != seg).any()
    out = port.viterbi_decode_batch(spec, rx)
    assert float((out != msgs).double().mean()) < BER_LIMIT


def test_soft_slice_matches_reference_chain():
    """NASA_K7 at Eb/N0 = 3 dB: BPSK, numpy noise, `bpsk_llr`,
    `quantize_llrs` (automatic scale), `viterbi_decode_batch_soft_bytes`.
    The JAX chain ends in its soft scan on the LLRs clipped to +-7, which
    is what its 8-bit soft kernel decodes."""
    ref_spec, spec = ref.NASA_K7, port.NASA_K7
    ebn0_db, rate = 3.0, spec.rate
    rng = np.random.default_rng(9865)
    msgs = rng.integers(0, 2, (B, L), dtype=np.uint8)
    T = L + spec.S
    sigma = np.sqrt(1.0 / (2.0 * 10 ** (ebn0_db / 10) * rate))
    noise = (rng.standard_normal((B, T * spec.n)) * sigma).astype(np.float32)

    coded = np.asarray(ref.encode_bits(ref_spec, msgs)[0])
    sym = np.asarray(ref_channel.bpsk_modulate(
        ref_channel.segments_to_bits(coded, spec.n)))
    ref_q = np.asarray(ref_metrics.quantize_llrs(
        ref_channel.bpsk_llr(sym + noise, ebn0_db, rate)))
    ref_bits_out = np.asarray(jax.vmap(
        lambda q: ref_metrics.viterbi_decode_soft(ref_spec, q))(
            np.clip(ref_q, -7, 7).reshape(B, T, spec.n)))
    ref_out = np.asarray(ref_bits.pack_bits(ref_bits_out))

    seg, _ = port.encode_bits(spec, msgs, device="cpu")
    rx = port.bpsk_modulate(port.segments_to_bits(seg, spec.n)) + \
        torch.from_numpy(noise)
    q = port.quantize_llrs(port.bpsk_llr(rx, ebn0_db, rate))
    np.testing.assert_array_equal(q.numpy(), ref_q)
    out = port.viterbi_decode_batch_soft_bytes(spec, q.reshape(B, T, spec.n))
    assert out.dtype == torch.uint8 and out.shape == (B, L // 8)
    np.testing.assert_array_equal(out.numpy(), ref_out)
    soft_ber = float((np.unpackbits(out.numpy(), axis=1) != msgs).mean())
    hard = port.viterbi_decode_batch_bytes(spec, port.bits_to_segments(
        port.hard_decision(q), spec.n))
    hard_ber = float((np.unpackbits(hard.numpy(), axis=1) != msgs).mean())
    assert soft_ber < 2e-3 and hard_ber > soft_ber, (soft_ber, hard_ber)
