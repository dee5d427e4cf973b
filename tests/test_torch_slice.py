"""The whole slice, encode -> BSC -> byte decode, through the port and
through the JAX package, on the same messages and the same channel noise
(made with numpy and given to both)."""

import numpy as np
import pytest
import torch

import jax

import convolutionalencdec_tpu as ref

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
