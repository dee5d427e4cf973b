"""The port's tail-biting path against the JAX package, on inputs made with
numpy: the encoder, `circular_extend`, `viterbi_forward` with initial
metrics, the wrap, list and exact scans, the kernel routes (their plain
versions on CPU tensors), the multi-walk traceback's plain version, and the
edges the reference pins.  Tolerance: exact equality of every bit; list
metrics as differences within a channel.

One test runs the JAX package's tail-biting kernels in interpret mode: the
hard byte decode of LTE_TBCC_K7 with L % 8 != 0 (the -128 probe of its soft
route is in test_torch_crc.py).  The rest compares with the JAX scans.
"""

import numpy as np
import pytest
import torch

import jax

import convolutionalencdec_tpu as ref
from convolutionalencdec_tpu.kernels import tailbiting as ref_ktb
from convolutionalencdec_tpu.ops import tailbiting as ref_tb
from convolutionalencdec_tpu.ops import viterbi as ref_viterbi

import convolutionalencdec_tpu_torch as port
from convolutionalencdec_tpu_torch.kernels import acs
from convolutionalencdec_tpu_torch.kernels import tailbiting as ktb
from convolutionalencdec_tpu_torch.ops import metrics, tailbiting, viterbi

K2_ARGS = dict(K=3, k=2, g=(0o17, 0o06, 0o13))
SCAN_SPECS = ["TOY_K3", "k2", "NASA_K7", "LTE_TBCC_K7"]
KERNEL_SPECS = ["NASA_K7", "LTE_TBCC_K7", "K9_561_753"]


def _specs(name):
    if name == "k2":
        return ref.CodeSpec(**K2_ARGS), port.CodeSpec(**K2_ARGS)
    return getattr(ref, name), port.PRESETS[name]


def _noisy(ref_spec, B, L, p, seed):
    """Tail-biting packets of random L-bit messages, each segment hit with
    probability p by a nonzero XOR mask: (msgs, segments [B, L / k])."""
    rng = np.random.default_rng(seed)
    msgs = rng.integers(0, 2, (B, L), dtype=np.uint8)
    coded = np.asarray(ref_tb.encode_tailbiting(ref_spec, msgs)).copy()
    flip = rng.random(coded.shape) < p
    coded ^= (flip * rng.integers(1, 1 << ref_spec.n, coded.shape)).astype(
        np.uint8)
    return msgs, coded


def _soft(ref_spec, coded, seed, lo=1, hi=7):
    """int8 LLRs [B, T, n] whose sign follows each coded bit, magnitudes in
    [lo, hi], 5% sign flips and 3% erasures."""
    rng = np.random.default_rng(seed)
    planes = np.stack([(coded >> j) & 1 for j in range(ref_spec.n)], -1)
    q = (1 - 2 * planes.astype(np.int32)) * rng.integers(lo, hi + 1,
                                                         planes.shape)
    q = np.where(rng.random(q.shape) < 0.05, -q, q)
    return np.where(rng.random(q.shape) < 0.03, 0, q).astype(np.int8)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ---------------------------------------------------------------------------
# Encoder, extension, forward with initial metrics.


@pytest.mark.parametrize("name", SCAN_SPECS)
def test_encode_tailbiting_matches_reference(name):
    ref_spec, spec = _specs(name)
    rng = np.random.default_rng(7)
    bits = rng.integers(0, 2, (3, 64), dtype=np.uint8)
    got = tailbiting.encode_tailbiting(spec, _t(bits))
    want = np.asarray(jax.vmap(
        lambda b: ref_tb.encode_tailbiting(ref_spec, b))(bits))
    assert got.dtype == torch.uint8 and got.shape == (3, 64 // spec.k)
    np.testing.assert_array_equal(got.numpy(), want)
    state = tailbiting.tail_state(spec, bits, device="cpu")
    np.testing.assert_array_equal(
        state.numpy(), np.asarray(ref_tb.tail_state(ref_spec, bits)))
    # Circular: encoding from the tail state ends in it.
    _, final = port.encode_bits(spec, _t(bits), terminate=False,
                                initial_state=state)
    assert torch.equal(final, state)
    with pytest.raises(ValueError, match="k\\*S"):
        tailbiting.encode_tailbiting(spec, _t(bits[:, :spec.k * spec.S - spec.k]))


def test_encode_tailbiting_rejects_partial_symbol():
    _, spec = _specs("k2")
    with pytest.raises(ValueError, match="multiple of k"):
        tailbiting.encode_tailbiting(spec, torch.zeros((2, 9),
                                                       dtype=torch.uint8))


@pytest.mark.parametrize("wl,wr", [(3, 5), (0, 0), (13, 2), (29, 40)])
def test_circular_extend_matches_reference(wl, wr):
    x = np.arange(2 * 13 * 3).reshape(2, 13, 3)
    for axis in (1, -1):
        got = tailbiting.circular_extend(_t(x), wl, wr, axis=axis)
        want = np.asarray(ref_tb.circular_extend(x, wl, wr, axis=axis))
        np.testing.assert_array_equal(got.numpy(), want)


def test_normalize_wrap_matches_reference():
    spec = port.NASA_K7
    for wrap in (None, 17, (9, 4)):
        assert tailbiting.normalize_wrap(spec, wrap) == \
            ref_tb._normalize_wrap(ref.NASA_K7, wrap)


@pytest.mark.parametrize("name", ["TOY_K3", "k2", "NASA_K7"])
def test_viterbi_forward_initial_metrics_matches_reference(name):
    ref_spec, spec = _specs(name)
    _, coded = _noisy(ref_spec, 3, 30, 0.1, seed=3)
    rng = np.random.default_rng(4)
    inits = rng.integers(0, 50, (3, spec.num_states)).astype(np.int32)
    bm = ref_viterbi.hard_step_metrics(ref_spec, coded)
    want_d, want_m = jax.vmap(lambda b, i: ref_viterbi.viterbi_forward(
        ref_spec, b, initial_metrics=i))(bm, inits)
    got_d, got_m = viterbi.viterbi_forward(
        spec, viterbi.hard_step_metrics(spec, _t(coded)),
        initial_metrics=_t(inits))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    # One [NS] vector for every channel.
    got_d, got_m = viterbi.viterbi_forward(
        spec, viterbi.hard_step_metrics(spec, _t(coded)),
        initial_metrics=_t(inits[0]))
    want_d, want_m = jax.vmap(lambda b: ref_viterbi.viterbi_forward(
        ref_spec, b, initial_metrics=inits[0]))(bm)
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))


# ---------------------------------------------------------------------------
# The scans.


@pytest.mark.parametrize("name", SCAN_SPECS)
def test_wrap_scans_match_reference(name):
    ref_spec, spec = _specs(name)
    msgs, coded = _noisy(ref_spec, 3, 96, 0.04, seed=len(name))
    for wrap in (None, (11, 50)):
        got = tailbiting.viterbi_decode_tailbiting(spec, _t(coded), wrap)
        want = jax.vmap(lambda c: ref_tb.viterbi_decode_tailbiting(
            ref_spec, c, wrap))(coded)
        assert got.shape == (3, 96) and got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() == msgs).mean() > 0.95
    q = _soft(ref_spec, coded, seed=5)
    got = tailbiting.viterbi_decode_tailbiting_soft(spec, _t(q))
    want = jax.vmap(lambda x: ref_tb.viterbi_decode_tailbiting_soft(
        ref_spec, x))(q.astype(np.int32))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", SCAN_SPECS)
def test_list_scans_match_reference(name):
    ref_spec, spec = _specs(name)
    _, coded = _noisy(ref_spec, 3, 80, 0.05, seed=20 + len(name))
    size = min(4, spec.num_states)
    got_b, got_m = tailbiting.viterbi_decode_tailbiting_list(
        spec, _t(coded), size)
    want_b, want_m = jax.vmap(lambda c: ref_tb.viterbi_decode_tailbiting_list(
        ref_spec, c, size))(coded)
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    q = _soft(ref_spec, coded, seed=6)
    got_b, got_m = tailbiting.viterbi_decode_tailbiting_list_soft(
        spec, _t(q), size, 9)
    want_b, want_m = jax.vmap(
        lambda x: ref_tb.viterbi_decode_tailbiting_list_soft(
            ref_spec, x, size, 9))(q.astype(np.int32))
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))


@pytest.mark.parametrize("name", SCAN_SPECS)
def test_exact_scan_matches_reference(name):
    ref_spec, spec = _specs(name)
    msgs, coded = _noisy(ref_spec, 2, 40, 0.05, seed=30 + len(name))
    got = tailbiting.viterbi_decode_tailbiting_exact(spec, _t(coded))
    want = jax.vmap(lambda c: ref_tb.viterbi_decode_tailbiting_exact(
        ref_spec, c))(coded)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# The kernel routes on CPU tensors, against the JAX scans at their wraps.


@pytest.mark.parametrize("L", [150, 131, 40])
@pytest.mark.parametrize("name", KERNEL_SPECS)
def test_kernel_wrap_routes_match_reference_scans(name, L):
    ref_spec, spec = _specs(name)
    msgs, coded = _noisy(ref_spec, 3, L, 0.03, seed=L)
    wraps = ktb.kernel_wraps(spec, L)
    assert wraps == ref_ktb.kernel_wraps(ref_spec, L)
    want = np.asarray(jax.vmap(lambda c: ref_tb.viterbi_decode_tailbiting(
        ref_spec, c, wraps))(coded))
    got = ktb.viterbi_decode_batch_tailbiting(spec, _t(coded))
    np.testing.assert_array_equal(got.numpy(), want)
    got = ktb.viterbi_decode_batch_tailbiting_bytes(spec, _t(coded))
    np.testing.assert_array_equal(
        got.numpy(), np.packbits(want, axis=1))
    q = _soft(ref_spec, coded, seed=L, hi=12)
    for qmax in (7, 31):
        qclip = port.kernels.soft_qclip(spec, qmax)
        want = np.asarray(jax.vmap(
            lambda x: ref_tb.viterbi_decode_tailbiting_soft(
                ref_spec, x, wraps))(np.clip(q.astype(np.int32), -qclip,
                                             qclip)))
        got = ktb.viterbi_decode_batch_tailbiting_soft(spec, _t(q), qmax=qmax)
        np.testing.assert_array_equal(got.numpy(), want)
        got = ktb.viterbi_decode_batch_tailbiting_soft_bytes(spec, _t(q),
                                                             qmax=qmax)
        np.testing.assert_array_equal(got.numpy(), np.packbits(want, axis=1))


@pytest.mark.parametrize("name", KERNEL_SPECS)
def test_kernel_list_routes_match_reference_scans(name):
    ref_spec, spec = _specs(name)
    _, coded = _noisy(ref_spec, 4, 72, 0.05, seed=50)
    wl = ktb.list_wrap(spec, 72)
    assert wl == ref_ktb.list_wrap(ref_spec, 72)
    got_b, got_m = ktb.viterbi_decode_batch_tailbiting_list(spec, _t(coded),
                                                            8)
    want_b, want_m = jax.vmap(lambda c: ref_tb.viterbi_decode_tailbiting_list(
        ref_spec, c, 8, wl))(coded)
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))
    want_m = np.asarray(want_m)
    np.testing.assert_array_equal(got_m.numpy(), want_m - want_m[:, :1])
    q = _soft(ref_spec, coded, seed=51)
    got_b, got_m = ktb.viterbi_decode_batch_tailbiting_list_soft(
        spec, _t(q), 3, wrap=10)
    want_b, want_m = jax.vmap(
        lambda x: ref_tb.viterbi_decode_tailbiting_list_soft(
            ref_spec, x, 3, ktb.list_wrap(spec, 72, 10)))(q.astype(np.int32))
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))
    want_m = np.asarray(want_m)
    np.testing.assert_array_equal(got_m.numpy(), want_m - want_m[:, :1])


def test_generic_codes_take_the_plain_scans_on_the_cpu():
    """A K=10 poly-symmetric code (NS = 512) is on the kernels (the wide
    forward and walk): on a CPU tensor their plain versions equal the scan
    at the kernel wraps; on any other device the wrappers take it.  A K=16
    code (NS = 32768) is beyond the kernels and raises there."""
    args = dict(K=10, g=(0o1167, 0o1545))
    ref_spec, spec = ref.CodeSpec(**args), port.CodeSpec(**args)
    assert acs.kernel_supports(spec)
    msgs, coded = _noisy(ref_spec, 2, 40, 0.02, seed=8)
    wraps = ktb.kernel_wraps(spec, 40)
    want = jax.vmap(lambda c: ref_tb.viterbi_decode_tailbiting(
        ref_spec, c, wraps))(coded)
    got = ktb.viterbi_decode_batch_tailbiting(spec, _t(coded))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="not supported"):
        ktb.viterbi_decode_batch_tailbiting(spec, _t(coded).to("meta"))
    k16 = port.CodeSpec(K=16, g=(0o104723, 0o153545))
    assert not acs.kernel_supports(k16)
    with pytest.raises(NotImplementedError, match="tail-biting"):
        ktb.viterbi_decode_batch_tailbiting(
            k16, torch.zeros((2, 40), dtype=torch.uint8, device="meta"))


# ---------------------------------------------------------------------------
# The multi-walk traceback's plain version.


def _numpy_walks(spec, dec, starts, live, out_start, out_steps):
    """One walk at a time over uint8 [B, T, NS] decisions."""
    B, T, _ = dec.shape
    out = np.zeros(starts.shape + (out_steps,), np.uint8)
    for b in range(B):
        for w in range(starts.shape[1]):
            cur = int(starts[b, w])
            for t in range(T - 1, out_start - 1, -1):
                if t < out_start + out_steps:
                    out[b, w, t - out_start] = cur & 1
                d = int(dec[b, t, cur]) if t < live else 0
                cur = (cur >> 1) | (d << (spec.S - 1))
    return out


@pytest.mark.parametrize("name", ["NASA_K7", "K9_561_753"])
def test_multi_walk_plain_matches_numpy_walk(name):
    _, spec = _specs(name)
    rng = np.random.default_rng(9)
    B, T, NS = 3, 45, spec.num_states
    dec = rng.integers(0, 2, (B, T, NS), dtype=np.uint8)
    words = acs.pack_decisions(spec, _t(dec))
    for NW in (1, 2, 8, NS):
        starts = rng.integers(0, NS, (B, NW)).astype(np.int32)
        for live, out_start, out_steps in ((T, 0, T), (T, 16, 29), (0, 5, 7),
                                           (spec.S, 0, 20), (T - 1, 40, 5),
                                           (T, T, 0)):
            want = _numpy_walks(spec, dec, starts, live, out_start, out_steps)
            got = acs.traceback_batch_multi(spec, words, _t(starts), live,
                                            out_start, out_steps)
            assert got.shape == (B, NW, out_steps)
            np.testing.assert_array_equal(got.numpy(), want)
            got = acs.traceback_batch_multi(spec, words, _t(starts), live,
                                            out_start, out_steps, "bytes")
            np.testing.assert_array_equal(
                got.numpy(), np.packbits(want, axis=-1))
    # The one-walk masked traceback is its NW = 1, out_start = 0 case.
    starts = _t(rng.integers(0, NS, (B, 1)).astype(np.int32))
    assert torch.equal(
        acs.traceback_batch_multi(spec, words, starts, 30, 0, 40)[:, 0],
        acs.traceback_batch_masked(spec, words, starts[:, 0], 30, 40))


def test_multi_walk_rejects_bad_arguments():
    spec = port.NASA_K7
    words = torch.zeros((2, 10, 2), dtype=torch.int32)
    starts = torch.zeros((2, 3), dtype=torch.int32)
    for bad in (starts[:, :0], torch.zeros((2, 65), dtype=torch.int32),
                starts.to(torch.int64), starts[:1], starts[:, 0]):
        with pytest.raises(ValueError, match="NW|start_states"):
            acs.traceback_batch_multi(spec, words, bad, 10, 0, 10)
    for live, out_start, out_steps in ((11, 0, 10), (10, 5, 6), (10, -1, 3)):
        with pytest.raises(ValueError):
            acs.traceback_batch_multi(spec, words, starts, live, out_start,
                                      out_steps)
    asymmetric = port.CodeSpec(K=7, g=(0o134, 0o171))
    with pytest.raises(NotImplementedError):
        acs.traceback_batch_multi(asymmetric, words, starts, 10, 0, 10)


def test_soft_forward_floor_option():
    """floor=False keeps -128 (only with qclip = 127); the default floors
    it at -127, as every block route does."""
    spec = port.LTE_TBCC_K7
    q = torch.tensor([[[-128, 5, -128], [127, -128, 0]]], dtype=torch.int8)
    assert acs.condition_qllrs(q, 127, floor=False).min() == -128
    assert acs.condition_qllrs(q, 127).min() == -127
    zeros = torch.zeros((1, spec.num_states), dtype=torch.int32)
    _, fm = acs.acs_forward_batch_soft(spec, q, 127, zeros, floor=False)
    _, want = metrics.viterbi_forward_butterfly_soft(spec, q.to(torch.int32),
                                                     zeros)
    assert torch.equal(fm, want)
    _, fm_floored = acs.acs_forward_batch_soft(spec, q, 127, zeros)
    assert not torch.equal(fm, fm_floored)
    with pytest.raises(ValueError, match="floor=False"):
        acs.acs_forward_batch_soft(spec, q, 7, zeros, floor=False)


# ---------------------------------------------------------------------------
# The edges the reference pins.


def test_list_size_bounds_match_reference():
    spec = port.NASA_K7
    seg = np.zeros((2, 48), np.uint8)
    q = np.zeros((2, 48, 2), np.int8)
    for size in (0, spec.num_states + 1):
        with pytest.raises(ValueError, match="list_size"):
            ref_ktb.viterbi_decode_batch_tailbiting_list(
                ref.NASA_K7, seg, size, None, True)
        with pytest.raises(ValueError, match="list_size"):
            ref_tb.viterbi_decode_tailbiting_list(ref.NASA_K7, seg[0], size)
        for fn, x in ((ktb.viterbi_decode_batch_tailbiting_list, seg),
                      (ktb.viterbi_decode_batch_tailbiting_list_soft, q),
                      (tailbiting.viterbi_decode_tailbiting_list, seg),
                      (tailbiting.viterbi_decode_tailbiting_list_soft, q)):
            with pytest.raises(ValueError, match="list_size"):
                fn(spec, _t(x), size)
        with pytest.raises(ValueError, match="list_size"):
            ktb.viterbi_decode_batch_tailbiting_crc(
                spec, port.CRC16_CCITT, _t(seg), size)
    got, _ = ktb.viterbi_decode_batch_tailbiting_list(spec, _t(seg), 64)
    assert got.shape == (2, 64, 48)


def test_kernel_entries_need_ns_64():
    seg = torch.zeros((2, 48), dtype=torch.uint8)
    q = torch.zeros((2, 48, 2), dtype=torch.int8)
    spec = port.K5_23_35
    for fn, x in ((ktb.viterbi_decode_batch_tailbiting, seg),
                  (ktb.viterbi_decode_batch_tailbiting_bytes, seg),
                  (ktb.viterbi_decode_batch_tailbiting_soft, q),
                  (ktb.viterbi_decode_batch_tailbiting_soft_bytes, q),
                  (ktb.viterbi_decode_batch_tailbiting_list, seg)):
        with pytest.raises(ValueError, match="NS >= 64"):
            fn(spec, x)
    with pytest.raises(ValueError, match="NS >= 64"):
        ref_ktb.viterbi_decode_batch_tailbiting(ref.K5_23_35, seg.numpy(),
                                                None, True)
    with pytest.raises(ValueError):   # TOY_K3 is not poly-symmetric
        ktb.viterbi_decode_batch_tailbiting(port.TOY_K3, seg)


def test_exact_oracle_envelope():
    """T n = 2^20 is refused, as in the JAX package (the exclusion metric
    must exceed every real path metric)."""
    for name, T in (("NASA_K7", 1 << 19), ("LTE_TBCC_K7", 349526)):
        ref_spec, spec = _specs(name)
        assert T * spec.n >= 1 << 20 > (T - 1) * spec.n
        with pytest.raises(ValueError, match="exclusion"):
            ref_tb.viterbi_decode_tailbiting_exact(ref_spec,
                                                   np.zeros((T,), np.uint8))
        with pytest.raises(ValueError, match="exclusion"):
            tailbiting.viterbi_decode_tailbiting_exact(
                spec, torch.zeros((1, T), dtype=torch.uint8))


# ---------------------------------------------------------------------------
# The JAX kernels in interpret mode.


def test_bytes_match_reference_kernel_interpret():
    """The hard byte decode of LTE_TBCC_K7 at L % 8 = 5 against the JAX
    kernels in interpret mode."""
    ref_spec, spec = ref.LTE_TBCC_K7, port.LTE_TBCC_K7
    msgs, coded = _noisy(ref_spec, 3, 61, 0.04, seed=61)
    want = np.asarray(ref_ktb.viterbi_decode_batch_tailbiting_bytes(
        ref_spec, coded, None, True))
    got = ktb.viterbi_decode_batch_tailbiting_bytes(spec, _t(coded))
    assert got.shape == (3, 8)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (np.unpackbits(want, axis=1)[:, :61] == msgs).mean() > 0.97
