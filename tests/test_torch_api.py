"""The port's public surface against the JAX package's: the names it
exports, the order of every shared function's parameters, and the inputs
that once bound a JAX argument to the port's `device` (each now gives the
JAX answer)."""

import importlib
import inspect

import numpy as np
import pytest
import torch

import convolutionalencdec_tpu as ref
from convolutionalencdec_tpu.ops import bits as ref_bits
from convolutionalencdec_tpu.ops import encode as ref_encode
from convolutionalencdec_tpu.ops import viterbi as ref_viterbi

import convolutionalencdec_tpu_torch as port
from convolutionalencdec_tpu_torch.ops import bits as port_bits
from convolutionalencdec_tpu_torch.ops import encode as port_encode
from convolutionalencdec_tpu_torch.ops import viterbi as port_viterbi

MODULES = ["", ".ops.bits", ".ops.channel", ".ops.crc", ".ops.encode",
           ".ops.lte", ".ops.maxlogmap", ".ops.metrics", ".ops.puncture",
           ".ops.ratematch", ".ops.streaming", ".ops.tailbiting",
           ".ops.trellis", ".ops.turbo", ".ops.viterbi", ".kernels",
           ".harness", ".harness.ber", ".harness.bounds", ".harness.curve",
           ".harness.speed", ".utils", ".utils.telemetry"]
# Kept on purpose: the port's channel draws from a torch.Generator where the
# JAX functions take a key first, and its traceback takes batched start
# states.
KEPT = {"awgn", "bsc", "bsc_segments", "traceback_terminated"}


def _positional(fn):
    sig = inspect.signature(fn)
    return [p.name for p in sig.parameters.values()
            if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]


def _shared_functions(suffix):
    ref_mod = importlib.import_module("convolutionalencdec_tpu" + suffix)
    port_mod = importlib.import_module("convolutionalencdec_tpu_torch"
                                       + suffix)
    for name in sorted(set(dir(ref_mod)) & set(dir(port_mod))):
        a, b = getattr(ref_mod, name), getattr(port_mod, name)
        if (name.startswith("_") or not callable(a) or not callable(b)
                or inspect.isclass(a) or inspect.isclass(b)):
            continue
        yield name, a, b


def test_top_level_exports_every_reference_name():
    """Every name of the JAX package's `__all__`, but the subpackage not
    ported yet (ROADMAP.md queue 1 item 5)."""
    missing = [n for n in ref.__all__ if n not in port.__all__]
    assert missing == ["parallel"]
    for name in port.__all__:
        assert hasattr(port, name), name
    for name in ("channel", "crc", "lte", "maxlogmap", "metrics", "puncture",
                 "ratematch", "tailbiting", "turbo"):
        assert getattr(port, name) is getattr(port.ops, name)


@pytest.mark.parametrize("suffix", [m for m in MODULES
                                    if m.startswith((".harness", ".utils"))])
def test_harness_and_utils_have_every_reference_name(suffix):
    """Each public function, class and constant the JAX module defines."""
    ref_mod = importlib.import_module("convolutionalencdec_tpu" + suffix)
    port_mod = importlib.import_module("convolutionalencdec_tpu_torch"
                                       + suffix)
    names = [n for n, v in vars(ref_mod).items()
             if not n.startswith("_") and not inspect.ismodule(v)
             and (getattr(v, "__module__", None) == ref_mod.__name__
                  or n.isupper())]
    assert [n for n in names if not hasattr(port_mod, n)] == []
    if hasattr(ref_mod, "__all__"):
        assert port_mod.__all__ == ref_mod.__all__


@pytest.mark.parametrize("suffix", MODULES, ids=lambda s: s or "top")
def test_shared_functions_take_reference_parameters_in_order(suffix):
    """The JAX function's positional parameters (less `interpret`, which
    only the TPU has) come first, in its order; `device` after them."""
    checked = 0
    for name, a, b in _shared_functions(suffix):
        want = [p for p in _positional(a) if p != "interpret"]
        got = _positional(b)
        if "device" in got:
            assert got.index("device") >= len(want), name
        got = [p for p in got if p != "device"]
        if name in KEPT:
            continue
        assert got[:len(want)] == want, (name, want, got)
        checked += 1
    assert checked > 0


def test_encode_bytes_terminate_positional():
    """ROADMAP fault 1: `encode_bytes(spec, data, False)` does not
    terminate."""
    data = np.array([[0b01101000, 0xA5]], np.uint8)
    want = np.asarray(ref.encode_bytes(ref.NASA_K7, data, False))
    assert want.tolist() == [[0, 3, 1, 1, 3, 1, 2, 1, 0, 3, 3, 1, 3, 1, 1, 1]]
    t = torch.from_numpy(data)
    np.testing.assert_array_equal(port.encode_bytes(port.NASA_K7, t, False),
                                  want)
    np.testing.assert_array_equal(
        port.encode_bytes(port.NASA_K7, t, terminate=False), want)
    np.testing.assert_array_equal(
        port.encode_bytes(port.NASA_K7, t),
        np.asarray(ref.encode_bytes(ref.NASA_K7, data)))


def test_pack_unpack_bit_order_positional():
    """ROADMAP fault 2: the second positional argument is the bit order."""
    one = np.array([[1, 0, 0, 0, 0, 0, 0, 0]], np.uint8)
    assert port_bits.pack_bits(torch.from_numpy(one), "little").tolist() \
        == np.asarray(ref_bits.pack_bits(one, "little")).tolist() == [[1]]
    byte = np.array([[1]], np.uint8)
    assert port_bits.unpack_bits(torch.from_numpy(byte), "little").tolist() \
        == np.asarray(ref_bits.unpack_bits(byte, "little")).tolist() \
        == one.tolist()
    rng = np.random.default_rng(5)
    data = rng.integers(0, 256, (3, 4), dtype=np.uint8)
    bits = rng.integers(0, 2, (3, 32), dtype=np.uint8)
    for order in ("big", "little"):
        np.testing.assert_array_equal(
            port_bits.unpack_bits(torch.from_numpy(data), order),
            np.asarray(ref_bits.unpack_bits(data, order)))
        np.testing.assert_array_equal(
            port_bits.pack_bits(torch.from_numpy(bits), bit_order=order),
            np.asarray(ref_bits.pack_bits(bits, order)))
        np.testing.assert_array_equal(port_bits.unpack_bits_np(data, order),
                                      ref_bits.unpack_bits_np(data, order))
        np.testing.assert_array_equal(port_bits.pack_bits_np(bits, order),
                                      ref_bits.pack_bits_np(bits, order))


def test_bit_helpers_match_reference():
    words = np.random.default_rng(6).integers(-2 ** 31, 2 ** 31, 64,
                                               dtype=np.int64)
    words = words.astype(np.int32)
    np.testing.assert_array_equal(
        port_bits.parity32(torch.from_numpy(words)),
        np.asarray(ref_bits.parity32(words)))
    np.testing.assert_array_equal(
        port_bits.popcount32(torch.from_numpy(words)),
        np.asarray(ref_bits.popcount32(words)))
    for value, width in ((0b1011, 4), (0x3A, 9), (5, 3)):
        for newest_first in (False, True):
            np.testing.assert_array_equal(
                port_bits.int_to_bits(value, width, newest_first),
                ref_bits.int_to_bits(value, width, newest_first))


def test_encoder_oracles_match_reference():
    rng = np.random.default_rng(8)
    for spec, ref_spec in ((port.NASA_K7, ref.NASA_K7),
                           (port.CodeSpec(K=3, k=2, g=(0o17, 0o06, 0o13)),
                            ref.CodeSpec(K=3, k=2, g=(0o17, 0o06, 0o13)))):
        for state in range(0, spec.num_states, 3):
            for u in range(spec.num_edges_per_state):
                assert port_encode.encode_one_input(spec, state, u) == \
                    ref_encode.encode_one_input(ref_spec, state, u)
        bits = rng.integers(0, 2, 20 * spec.k, dtype=np.uint8)
        for terminate in (True, False):
            np.testing.assert_array_equal(
                port_encode.encode_bits_np(spec, bits, terminate, 1),
                ref_encode.encode_bits_np(ref_spec, bits, terminate, 1))


def _nasa_metrics():
    """ROADMAP fault 3's input: NASA_K7, 32 random bits, encoded; the hard
    branch metrics [38, 2, 64]."""
    bits = np.random.default_rng(1).integers(0, 2, 32, dtype=np.uint8)
    coded = np.array(ref.encode_bits(ref.NASA_K7, bits)[0])
    return coded, np.array(ref_viterbi.hard_step_metrics(ref.NASA_K7, coded))


def test_viterbi_forward_collect_metrics_positional():
    """ROADMAP fault 3: `viterbi_forward(spec, bm, True)` collects the
    metric history and starts at the known-start metrics."""
    _, bm = _nasa_metrics()
    assert bm.shape == (38, 2, 64)
    want = ref_viterbi.viterbi_forward(ref.NASA_K7, bm, True)
    bm_t = torch.from_numpy(bm)[None]
    got = port_viterbi.viterbi_forward(port.NASA_K7, bm_t, True)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(w))
    assert got[2].shape == (1, 38, 64)
    # initial_metrics still reaches the start, by keyword.
    init = np.arange(64, dtype=np.int32)
    want = ref_viterbi.viterbi_forward(ref.NASA_K7, bm, False, init)
    got = port_viterbi.viterbi_forward(port.NASA_K7, bm_t,
                                       initial_metrics=torch.from_numpy(init))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(w))


def test_viterbi_decode_use_butterfly_matches_reference():
    coded, _ = _nasa_metrics()
    seg = torch.from_numpy(coded)[None]
    for use_butterfly in (None, True, False):
        want = np.asarray(ref.viterbi_decode(ref.NASA_K7, coded,
                                             use_butterfly))
        np.testing.assert_array_equal(
            port.viterbi_decode(port.NASA_K7, seg, use_butterfly)[0], want)


PLAIN_DECODERS = [
    ("viterbi_decode", lambda x, **kw: port.viterbi_decode(
        port.NASA_K7, x, **kw)),
    ("viterbi_decode_bytes", lambda x, **kw: port.viterbi_decode_bytes(
        port.NASA_K7, x, **kw)),
    ("hard_step_metrics", lambda x, **kw: port.ops.hard_step_metrics(
        port.NASA_K7, x, **kw)),
    ("viterbi_forward_butterfly",
     lambda x, **kw: port.viterbi_forward_butterfly(port.NASA_K7, x,
                                                    **kw)[0]),
    ("viterbi_forward", lambda x, **kw: port.viterbi_forward(
        port.NASA_K7, np.zeros((1, 14, 2, 64), np.int32) if x is None else x,
        **kw)[0]),
    ("traceback_terminated", lambda x, **kw: port.traceback_terminated(
        port.NASA_K7, np.zeros((1, 14, 64), np.uint8) if x is None else x,
        **kw)),
]


@pytest.mark.parametrize("name", [n for n, _ in PLAIN_DECODERS])
def test_plain_decoders_place_numpy_inputs_by_the_device_rule(
        name, monkeypatch):
    """ROADMAP fault 4: a numpy input goes to the card (and with no CUDA
    device raises) unless `device="cpu"`; a tensor keeps its device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = dict(PLAIN_DECODERS)[name]
    generated = name in ("viterbi_forward", "traceback_terminated")
    x = None if generated else np.zeros((1, 14), np.uint8)
    with pytest.raises(RuntimeError, match="CUDA"):
        call(x)
    got = call(x, device="cpu")
    assert got.device.type == "cpu"
    if not generated:
        assert torch.equal(got, call(torch.from_numpy(x)))


def test_circular_extend_takes_axis():
    x = np.arange(2 * 13 * 3).reshape(2, 13, 3)
    got = port.tailbiting.circular_extend(torch.from_numpy(x), 4, 6, axis=1)
    want = np.asarray(ref.tailbiting.circular_extend(x, 4, 6, axis=1))
    np.testing.assert_array_equal(got.numpy(), want)

