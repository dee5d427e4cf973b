"""The port's encoder, bit packing and BSC channel against the JAX
package's, on inputs made with numpy."""

import numpy as np
import pytest
import torch

import convolutionalencdec_tpu as ref
from convolutionalencdec_tpu.ops import bits as ref_bits
from convolutionalencdec_tpu.ops import channel as ref_channel

import convolutionalencdec_tpu_torch as port
from convolutionalencdec_tpu_torch.ops import bits as port_bits

SPEC_ARGS = [
    dict(K=7, g=(0o133, 0o171)),
    dict(K=5, g=(0o23, 0o35, 0o27)),
    dict(K=9, g=(0o561, 0o753)),
    dict(K=3, k=2, g=(0o17, 0o06, 0o13)),
    dict(K=4, k=2, g=(0o64, 0o52, 0o71)),
]
SPEC_IDS = ["K7", "K5n3", "K9", "K3k2", "K4k2"]


@pytest.mark.parametrize("terminate", [True, False], ids=["term", "open"])
@pytest.mark.parametrize("kwargs", SPEC_ARGS, ids=SPEC_IDS)
def test_encode_bits_matches_reference(kwargs, terminate):
    ref_spec, spec = ref.CodeSpec(**kwargs), port.CodeSpec(**kwargs)
    rng = np.random.default_rng(spec.K * 10 + spec.k)
    B, L = 5, 36 * spec.k
    msgs = rng.integers(0, 2, (B, L), dtype=np.uint8)
    states = rng.integers(0, spec.num_states, B).astype(np.int32)
    for init in (None, states):
        want_seg, want_state = ref.encode_bits(ref_spec, msgs, terminate,
                                               initial_state=init)
        got_seg, got_state = port.encode_bits(
            spec, torch.from_numpy(msgs), terminate,
            initial_state=None if init is None else torch.from_numpy(init))
        assert got_seg.dtype == torch.uint8 and got_state.dtype == torch.int32
        np.testing.assert_array_equal(got_seg.numpy(), np.asarray(want_seg))
        np.testing.assert_array_equal(got_state.numpy(),
                                      np.asarray(want_state))


@pytest.mark.parametrize("kwargs", SPEC_ARGS, ids=SPEC_IDS)
def test_encode_bytes_matches_reference(kwargs):
    ref_spec, spec = ref.CodeSpec(**kwargs), port.CodeSpec(**kwargs)
    rng = np.random.default_rng(7)
    data = rng.integers(0, 256, (3, 6), dtype=np.uint8)
    want = np.asarray(ref.encode_bytes(ref_spec, data))
    got = port.encode_bytes(spec, torch.from_numpy(data))
    np.testing.assert_array_equal(got.numpy(), want)


def test_golden_k3_vector():
    got = port.encode_bytes(port.TOY_K3,
                            torch.tensor([0b01101000], dtype=torch.uint8))
    assert got.tolist() == [0, 3, 0, 2, 2, 3, 1, 0, 0, 0]


@pytest.mark.parametrize("shape", [(9,), (4, 9), (2, 3, 5)])
def test_pack_unpack_match_reference(shape):
    rng = np.random.default_rng(3)
    data = rng.integers(0, 256, shape, dtype=np.uint8)
    bits = rng.integers(0, 2, shape[:-1] + (8 * shape[-1],), dtype=np.uint8)
    np.testing.assert_array_equal(
        port_bits.unpack_bits(torch.from_numpy(data)).numpy(),
        np.asarray(ref_bits.unpack_bits(data)))
    np.testing.assert_array_equal(
        port_bits.pack_bits(torch.from_numpy(bits)).numpy(),
        np.asarray(ref_bits.pack_bits(bits)))
    with pytest.raises(ValueError):
        port_bits.pack_bits(torch.zeros((2, 7), dtype=torch.uint8))


def test_pack_unpack_place_inputs_by_the_device_rule(monkeypatch):
    """A tensor keeps its device; a numpy input goes to the card, and with
    no CUDA device raises unless device='cpu'.  The parity of 32-bit words
    equals the JAX package's numpy parity."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = np.arange(6, dtype=np.uint8).reshape(2, 3)
    bits = np.unpackbits(data, axis=1)
    for fn, x in ((port_bits.unpack_bits, data), (port_bits.pack_bits, bits)):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(x)
        assert fn(x, device="cpu").device.type == "cpu"
        assert fn(torch.from_numpy(x)).device.type == "cpu"
    np.testing.assert_array_equal(
        port_bits.pack_bits(bits, device="cpu").numpy(), data)
    words = np.random.default_rng(4).integers(0, 1 << 32, 64,
                                               dtype=np.uint64)
    words = words.astype(np.uint32)
    np.testing.assert_array_equal(port_bits.parity32_np(words),
                                  ref_bits.parity32_np(words))


def test_bsc_segments_statistics_match_reference():
    """Different random streams, so the gate is statistical: each coded bit
    flips with probability p in both, within 5 standard deviations."""
    import jax
    n, p, shape = 2, 0.1, (64, 512)
    segs = np.random.default_rng(1).integers(0, 1 << n, shape, dtype=np.uint8)
    gen = torch.Generator().manual_seed(5)
    got = port.bsc_segments(torch.from_numpy(segs), n, p, gen)
    want = np.asarray(ref_channel.bsc_segments(jax.random.PRNGKey(5), segs,
                                               n, p))
    assert got.dtype == torch.uint8 and got.shape == segs.shape
    trials = segs.size * n
    sigma = np.sqrt(p * (1 - p) / trials)
    for out in (got.numpy(), want):
        diff = np.bitwise_xor(out, segs)
        assert diff.max() < (1 << n)
        rate = np.unpackbits(diff[..., None], axis=-1).sum() / trials
        assert abs(rate - p) < 5 * sigma, rate
    again = port.bsc_segments(torch.from_numpy(segs), n, p,
                              torch.Generator().manual_seed(5))
    assert torch.equal(got, again)
    assert torch.equal(port.bsc_segments(torch.from_numpy(segs), n, 0.0),
                       torch.from_numpy(segs))
