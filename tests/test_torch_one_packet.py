"""One-packet inputs and non-finite LLRs, port against the JAX package.

The JAX package's decoders take one packet: segments [T] or LLRs [T, n].
The port's are batched, and each of them also takes that one-packet input,
giving the JAX function's output shapes (ROADMAP.md section 3, fault 1).
`quantize_llrs` maps a NaN to 0 as the JAX cast does (fault 2).  Inputs
are made with numpy and handed to both packages.
"""

import numpy as np
import pytest
import torch

import convolutionalencdec_tpu as ref
from convolutionalencdec_tpu.ops import metrics as ref_metrics
from convolutionalencdec_tpu.ops import viterbi as ref_viterbi

import convolutionalencdec_tpu_torch as port
from convolutionalencdec_tpu_torch.ops import metrics as port_metrics
from convolutionalencdec_tpu_torch.ops import viterbi as port_viterbi

# function -> (preset, input: "hard" segments [T], "soft" LLRs [T, n] or
# "metrics" [T, 2^k, NS]; packet: "block" or "tailbiting"; keyword args).
CASES = {
    "viterbi_decode": ("NASA_K7", "hard", "block", {}),
    "viterbi_decode_bytes": ("NASA_K7", "hard", "block", {}),
    "viterbi_decode_soft": ("NASA_K7", "soft", "block", {}),
    "viterbi_decode_stream": ("NASA_K7", "hard", "block", {}),
    "viterbi_decode_stream_soft": ("NASA_K7", "soft", "block",
                                   {"traceback_len": 24}),
    "viterbi_forward": ("NASA_K7", "metrics", "block", {}),
    "viterbi_forward_butterfly": ("NASA_K7", "hard", "block", {}),
    "viterbi_forward_butterfly_soft": ("NASA_K7", "soft", "block", {}),
    "maxlogmap_llrs": ("NASA_K7", "soft", "block", {}),
    "maxlogmap_decode": ("NASA_K7", "soft", "block", {"terminated": False}),
    "viterbi_decode_tailbiting": ("LTE_TBCC_K7", "hard", "tailbiting", {}),
    "viterbi_decode_tailbiting_soft": ("LTE_TBCC_K7", "soft", "tailbiting",
                                       {}),
    "viterbi_decode_tailbiting_exact": ("TOY_K3", "hard", "tailbiting", {}),
    "viterbi_decode_tailbiting_list": ("LTE_TBCC_K7", "hard", "tailbiting",
                                       {"list_size": 4}),
    "viterbi_decode_tailbiting_list_soft": ("LTE_TBCC_K7", "soft",
                                            "tailbiting", {"list_size": 3}),
}
L = 40


def _functions(name):
    if name == "viterbi_forward_butterfly_soft":
        return (ref_metrics.viterbi_forward_butterfly_soft,
                port_metrics.viterbi_forward_butterfly_soft)
    return getattr(ref, name), getattr(port, name)


def _one_packet(spec, kind, packet, seed):
    """numpy input of one packet: the encoded message hit by noise."""
    rng = np.random.default_rng(seed)
    msg = rng.integers(0, 2, L, dtype=np.uint8)
    if packet == "block":
        seg = np.asarray(ref.encode_bits(spec, msg)[0], np.uint8)
    else:
        seg = np.asarray(ref.encode_tailbiting(spec, msg), np.uint8)
    if kind == "hard" or kind == "metrics":
        flips = (rng.random(seg.shape) < 0.05).astype(np.uint8)
        seg = seg ^ (flips * rng.integers(1, 1 << spec.n, seg.shape,
                                          dtype=np.uint8))
        if kind == "metrics":
            return np.array(ref_viterbi.hard_step_metrics(spec, seg))
        return seg
    bits = (seg[:, None] >> np.arange(spec.n)) & 1            # [T, n]
    q = (1 - 2 * bits.astype(np.int32)) * rng.integers(1, 8, bits.shape)
    return np.where(rng.random(q.shape) < 0.1, -q, q).astype(np.int32)


@pytest.mark.parametrize("name", sorted(CASES))
def test_one_packet_input_matches_reference(name):
    """A [T] (or [T, n]) input gives the JAX function's output: its values,
    dtypes' values and shapes, with no batch axis."""
    preset, kind, packet, kwargs = CASES[name]
    ref_fn, port_fn = _functions(name)
    x = _one_packet(getattr(ref, preset), kind, packet,
                    seed=len(name) + 7 * len(kwargs))
    want = ref_fn(getattr(ref, preset), x, **kwargs)
    got = port_fn(getattr(port, preset), torch.from_numpy(x), **kwargs)
    if not isinstance(want, tuple):
        want, got = (want,), (got,)
    assert isinstance(got, tuple) and len(got) == len(want)
    for w, g in zip(want, got):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.numpy(), w)
    # The batched call of the same packet gives the same rows.
    batched = port_fn(getattr(port, preset), torch.from_numpy(x[None]),
                      **kwargs)
    if not isinstance(batched, tuple):
        batched = (batched,)
    for b, g in zip(batched, got):
        assert torch.equal(b[0], g)


def test_one_packet_numpy_input_and_initial_metrics():
    """A numpy one-packet input with `device="cpu"`, and the one-packet
    forward from [NS] initial metrics."""
    spec = ref.NASA_K7
    seg = _one_packet(spec, "hard", "block", seed=3)
    np.testing.assert_array_equal(
        port.viterbi_decode(port.NASA_K7, seg, device="cpu").numpy(),
        np.asarray(ref.viterbi_decode(spec, seg)))
    init = np.random.default_rng(4).integers(0, 30, 64).astype(np.int32)
    want = ref.viterbi_forward_butterfly(spec, seg, init)
    got = port.viterbi_forward_butterfly(port.NASA_K7, torch.from_numpy(seg),
                                         torch.from_numpy(init))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_quantize_llrs_nan_and_inf_match_reference():
    """NaN becomes 0; +-inf clips to +-qmax at a finite scale; with the
    default scale one NaN or +-inf gives all zeros, as JAX's cast gives."""
    nan, inf = float("nan"), float("inf")
    cases = [
        ([[nan, 1.0, 2.0]], 7, 1.0),
        ([[nan, -nan, 0.4], [inf, -inf, -2.6]], 7, 1.0),
        ([[inf, 1.0, -3.0, 0.5]], 7, 0.5),
        ([[nan, 1.0, 2.0], [3.0, -4.0, 5.0]], 7, None),
        ([[inf, 1.0, 2.0]], 7, None),
        ([[-inf, 1.0, -2.0]], 31, None),
        ([[1.5, -2.5, 0.5, 40.0]], 7, None),
    ]
    for llrs, qmax, scale in cases:
        x = np.asarray(llrs, np.float32)
        want = np.asarray(ref_metrics.quantize_llrs(x, qmax, scale))
        got = port_metrics.quantize_llrs(torch.from_numpy(x), qmax, scale)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    assert port_metrics.quantize_llrs(
        torch.tensor([[nan, 1.0, 2.0]]), 7, 1.0).tolist() == [[0, 1, 2]]


def test_one_packet_helper_keeps_batched_calls():
    """`one_packet` adds and drops the batch axis only for a one-packet
    input; a batched input and the function's errors pass through."""
    calls = []

    @port_viterbi.one_packet(2)
    def fn(spec, x, scale=1):
        calls.append(tuple(x.shape))
        return x * scale, x.sum(-1)

    a, b = fn(None, torch.ones(5, dtype=torch.int32), scale=2)
    assert a.tolist() == [2] * 5 and b.item() == 5
    a, b = fn(None, np.ones((3, 5), np.int32))
    assert a.shape == (3, 5) and b.shape == (3,)
    assert calls == [(1, 5), (3, 5)]
    with pytest.raises(ValueError):
        port.viterbi_decode(port.NASA_K7, torch.zeros((2, 3, 4),
                                                      dtype=torch.uint8))
