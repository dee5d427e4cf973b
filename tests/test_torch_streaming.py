"""The port's streaming path against the JAX package, on inputs made with
numpy: the plain stream decodes, the streaming encoder and decoders, the
stream kernel's and the masked traceback's plain versions, the carried-state
conversions, and the block-speed stream.  Tolerance: exact equality of all
bits, and of carried metrics after subtracting each channel's minimum.

On the CPU each wrapper takes its plain version; the CUDA kernels themselves
are held to those plain versions on the card by chip_smoke.py.  Two tests run
the JAX package's stream kernel in interpret mode (hard, and soft with -128
among the LLRs) and one runs its block-speed stream in interpret mode; every
other comparison is against the JAX scans.
"""

import numpy as np
import pytest
import torch

import jax

import convolutionalencdec_tpu as ref
from convolutionalencdec_tpu.kernels import acs_swar as ref_swar
from convolutionalencdec_tpu.ops import metrics as ref_metrics
from convolutionalencdec_tpu.ops import streaming as ref_streaming
from convolutionalencdec_tpu.ops import viterbi as ref_viterbi

import convolutionalencdec_tpu_torch as port
from convolutionalencdec_tpu_torch.kernels import acs, stream
from convolutionalencdec_tpu_torch.ops import streaming, viterbi

STREAM_SPECS = ["NASA_K7", "REF_K7", "NASA_K7_R13", "K9_561_753", "K5_23_35",
                "TOY_K3"]
CUTS = [96, 149]   # then the rest: a kernel-sized prefix, a ragged middle
NON_SYMMETRIC = dict(K=7, k=1, g=(0o134, 0o171))


def _specs(name):
    return getattr(ref, name), port.PRESETS[name]


def _coded(ref_spec, B, L, p, seed):
    """Terminated packets [B, L + S] of random messages, each segment hit
    with probability p by a nonzero XOR mask; returns (msgs, segments)."""
    rng = np.random.default_rng(seed)
    msgs = rng.integers(0, 2, (B, L), dtype=np.uint8)
    coded = np.asarray(ref.encode_bits(ref_spec, msgs)[0]).copy()
    flip = rng.random(coded.shape) < p
    coded ^= (flip * rng.integers(1, 1 << ref_spec.n, coded.shape)).astype(
        np.uint8)
    return msgs, coded


def _soft(ref_spec, coded, lo, hi, seed):
    """LLRs whose sign follows each coded bit, magnitudes in [lo, hi], 4%
    sign flips and 2% erasures; int32 [..., T, n]."""
    rng = np.random.default_rng(seed)
    planes = np.stack([(coded >> j) & 1 for j in range(ref_spec.n)], axis=-1)
    q = (1 - 2 * planes.astype(np.int32)) * rng.integers(lo, hi + 1,
                                                         planes.shape)
    q = np.where(rng.random(q.shape) < 0.04, -q, q)
    return np.where(rng.random(q.shape) < 0.02, 0, q).astype(np.int32)


def _renormed(m):
    m = np.asarray(m).astype(np.int64)
    return m - m.min(axis=-1, keepdims=True)


def _feed(decode, x, cuts, t=torch.from_numpy):
    """Each call's output of `decode(chunk, last)` over `x` [B, T, ...] cut
    at `cuts` and the rest, the last call with last=True; `t` makes a
    chunk."""
    edges = [c for c in cuts if c < x.shape[1]] + [x.shape[1]]
    out, prev = [], 0
    for i, e in enumerate(edges):
        out.append(np.asarray(decode(t(x[:, prev:e]),
                                     last=i == len(edges) - 1)))
        prev = e
    return out


def _call(dec, method="decode"):
    """`dec.<method>` as a function of (chunk, last)."""
    return lambda chunk, last: getattr(dec, method)(chunk, last)


# ---------------------------------------------------------------------------
# Module 1: the plain stream decodes.


@pytest.mark.parametrize("mode", ["hard", "soft"])
@pytest.mark.parametrize("name", STREAM_SPECS)
def test_stream_decode_matches_reference(name, mode):
    ref_spec, spec = _specs(name)
    _, coded = _coded(ref_spec, 3, 70, 0.05, seed=len(name))
    if mode == "hard":
        got = viterbi.viterbi_decode_stream(spec, torch.from_numpy(coded))
        want = [ref_viterbi.viterbi_decode_stream(ref_spec, c) for c in coded]
        got_w = viterbi.viterbi_decode_stream(spec, coded, ref_spec.S + 1,
                                              device="cpu")
        want_w = [ref_viterbi.viterbi_decode_stream(ref_spec, c,
                                                    ref_spec.S + 1)
                  for c in coded]
    else:
        q = _soft(ref_spec, coded, 1, 40, seed=len(name))
        got = viterbi.viterbi_decode_stream_soft(spec, torch.from_numpy(q))
        want = [ref_viterbi.viterbi_decode_stream_soft(ref_spec, x) for x in q]
        got_w = viterbi.viterbi_decode_stream_soft(spec, q, ref_spec.S + 1,
                                                   device="cpu")
        want_w = [ref_viterbi.viterbi_decode_stream_soft(ref_spec, x,
                                                         ref_spec.S + 1)
                  for x in q]
    assert got.dtype == torch.uint8 and got.shape == (3, 70)
    np.testing.assert_array_equal(got.numpy(), np.stack(want))
    np.testing.assert_array_equal(got_w.numpy(), np.stack(want_w))


def test_stream_decode_guards():
    spec = port.NASA_K7
    seg = torch.zeros((2, 64), dtype=torch.uint8)
    with pytest.raises(ValueError, match="shorter than traceback"):
        viterbi.viterbi_decode_stream(spec, seg[:, :34])
    with pytest.raises(ValueError, match="must exceed S"):
        viterbi.viterbi_decode_stream(spec, seg, spec.S)
    with pytest.raises(ValueError, match="must exceed S"):
        viterbi.viterbi_decode_stream_soft(
            spec, torch.zeros((2, 64, 2), dtype=torch.int32), spec.S)


# ---------------------------------------------------------------------------
# Module 2: the streaming classes.


def test_streaming_encoder_matches_reference():
    ref_spec, spec = _specs("NASA_K7")
    bits = np.random.default_rng(41).integers(0, 2, 300, dtype=np.uint8)
    want_enc, got_enc = ref_streaming.StreamingEncoder(ref_spec), \
        streaming.StreamingEncoder(spec, device="cpu")
    for packet in range(2):
        for a, b in ((0, 100), (100, 140), (140, 300)):
            last = b == 300
            got = got_enc.encode(bits[a:b], last=last)
            want = want_enc.encode(bits[a:b], last=last)
            assert got.dtype == torch.uint8 and got.device.type == "cpu"
            np.testing.assert_array_equal(got.numpy(), want,
                                          err_msg=f"{packet} {a}:{b}")
    got_enc.encode(bits[:10])
    got_enc.reset()
    np.testing.assert_array_equal(
        got_enc.encode(bits, last=True).numpy(),
        np.asarray(ref.encode_bits(ref_spec, bits)[0]))


@pytest.mark.parametrize("mode", ["hard", "soft"])
def test_streaming_decoder_matches_reference(mode):
    """Call by call over ragged cuts, two packets, bits and bytes; soft
    chunks are int32 LLRs beyond the int8 range."""
    ref_spec, spec = _specs("NASA_K7")
    soft = mode == "soft"
    want_dec = ref_streaming.StreamingDecoder(ref_spec, soft=soft)
    got_dec = streaming.StreamingDecoder(spec, soft=soft, device="cpu")
    for packet, (L, cuts) in enumerate(((180, [53, 121]),
                                        (251, [1, 40, 41, 200]))):
        msgs, coded = _coded(ref_spec, 1, L, 0.03, seed=43 + packet)
        x = _soft(ref_spec, coded, 100, 300, seed=packet) if soft else coded
        method = "decode_bytes" if packet else "decode"
        got = _feed(_call(got_dec, method), x, cuts,
                    t=lambda a: torch.from_numpy(a[0]))
        want = _feed(_call(want_dec, method), x, cuts, t=lambda a: a[0])
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w, err_msg=f"{mode} {method}")
        if not packet:
            np.testing.assert_array_equal(np.concatenate(got), msgs[0])


def test_streaming_decoder_short_packets():
    """Packets shorter than the window decode to exactly their message
    (the flush trims register-init filler by consumed steps)."""
    ref_spec, spec = _specs("NASA_K7")
    rng = np.random.default_rng(53)
    want_dec = ref_streaming.StreamingDecoder(ref_spec)
    got_dec = streaming.StreamingDecoder(spec, device="cpu")
    for L in (1, 5, 10, 28, 29, 40):
        msg = rng.integers(0, 2, L, dtype=np.uint8)
        coded = np.array(ref.encode_bits(ref_spec, msg)[0])
        got = got_dec.decode(torch.from_numpy(coded), last=True)
        assert got.shape == (L,), L
        np.testing.assert_array_equal(got.numpy(), msg)
        np.testing.assert_array_equal(got.numpy(),
                                      want_dec.decode(coded, last=True))
    msg = rng.integers(0, 2, 12, dtype=np.uint8)
    coded = torch.from_numpy(np.array(ref.encode_bits(ref_spec, msg)[0]))
    assert got_dec.decode(coded[:7]).shape == (0,)
    np.testing.assert_array_equal(got_dec.decode(coded[7:], last=True).numpy(),
                                  msg)
    with pytest.raises(ValueError, match="last=True chunk"):
        got_dec.decode(coded[:0], last=True)


@pytest.mark.parametrize("use_kernel", [None, False])
@pytest.mark.parametrize("mode", ["hard", "soft"])
def test_streaming_batch_matches_reference(mode, use_kernel):
    """Call by call against the JAX class on its scan route, over the cuts
    [96, 149, T] with an empty chunk first, bits and bytes.  The port's
    default route is the stream kernel's plain version on the CPU."""
    ref_spec, spec = _specs("NASA_K7")
    soft = mode == "soft"
    B = 4
    _, coded = _coded(ref_spec, B, 250, 0.03, seed=23)
    # No -128: the JAX scan route does not floor it (see ROADMAP.md).
    x = _soft(ref_spec, coded, 1, 127, seed=23) if soft else coded
    got_dec = streaming.StreamingDecoderBatch(spec, B, use_kernel=use_kernel,
                                              soft=soft, device="cpu")
    assert got_dec.use_kernel == (use_kernel is None)
    want_dec = ref_streaming.StreamingDecoderBatch(ref_spec, B,
                                                   use_kernel=False, soft=soft)
    empty = x[:, :0]
    assert got_dec.decode(torch.from_numpy(empty)).shape == (B, 0)
    assert want_dec.decode(empty).shape == (B, 0)
    for method in ("decode", "decode_bytes"):
        got = _feed(_call(got_dec, method), x, CUTS)
        want = _feed(_call(want_dec, method), x, CUTS, t=lambda a: a)
        for i, (g, w) in enumerate(zip(got, want)):
            np.testing.assert_array_equal(g, w, err_msg=f"{method} call {i}")
    with pytest.raises(ValueError, match="last=True chunk"):
        got_dec.decode(torch.from_numpy(empty), last=True)


@pytest.mark.parametrize("mode", ["hard", "soft"])
def test_stream_kernel_plain_matches_interpreted_pallas_kernel(mode):
    """`kernels.stream`'s plain version against the JAX stream kernel in
    interpret mode (its class pads B = 4 to 256): the emits, and the
    carried state in both of the JAX package's layouts."""
    ref_spec, spec = _specs("NASA_K7")
    soft = mode == "soft"
    B, W = 4, ref_spec.traceback_len
    _, coded = _coded(ref_spec, B, 90, 0.03, seed=29)
    x = coded
    if soft:
        x = _soft(ref_spec, coded, 1, 127, seed=29)
        x.reshape(-1)[::13] = -128   # floored to -127 on both sides
        x = x.astype(np.int8)
    want_dec = ref_streaming.StreamingDecoderBatch(
        ref_spec, B, use_kernel=True, interpret=True, soft=soft)
    got_dec = streaming.StreamingDecoderBatch(spec, B, soft=soft,
                                              device="cpu")
    want = np.asarray(want_dec.decode(x))
    got = got_dec.decode(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)
    metrics, registers = stream.stream_state_to_reference(got_dec._state, W,
                                                          layout="class")
    np.testing.assert_array_equal(_renormed(metrics),
                                  _renormed(want_dec._metrics))
    np.testing.assert_array_equal(registers, np.asarray(want_dec._registers))
    planes = stream.stream_state_to_reference(got_dec._state, W)
    lo, hi = ref_streaming._registers_to_planes(want_dec._registers)
    want_planes = np.stack([np.asarray(want_dec._metrics).T, lo, hi])
    np.testing.assert_array_equal(planes[1:], want_planes[1:])
    np.testing.assert_array_equal(_renormed(planes[0].T),
                                  _renormed(want_planes[0].T))


def test_minus_128_is_floored_on_every_route():
    """The JAX class floors int8 -128 to -127 on its kernel prefix but not
    on its scan route, so its answer depends on how the stream is cut (see
    ROADMAP.md section 3).  The port floors on every route: its scan route
    equals its kernel route, and the JAX scan first differs at bit 54."""
    ref_spec, spec = _specs("NASA_K7")
    rng = np.random.default_rng(5)
    q = rng.choice(np.array([-128, -127, 127, 126, 1, -1, 0], np.int8),
                   (1, 96, 2))
    want_scan = np.asarray(ref_streaming.StreamingDecoderBatch(
        ref_spec, 1, use_kernel=False, soft=True).decode(q))
    got = [streaming.StreamingDecoderBatch(spec, 1, use_kernel=uk, soft=True,
                                           device="cpu").decode(
        torch.from_numpy(q)).numpy() for uk in (None, False)]
    np.testing.assert_array_equal(got[0], got[1])
    assert np.flatnonzero(got[0][0] != want_scan[0])[0] == 54
    floored = np.maximum(q, -127).astype(np.int8)
    np.testing.assert_array_equal(got[0], np.asarray(
        ref_streaming.StreamingDecoderBatch(ref_spec, 1, use_kernel=False,
                                            soft=True).decode(floored)))


@pytest.mark.parametrize("layout", ["class", "kernel"])
def test_streaming_batch_handover_from_reference(layout):
    """Two chunks in the JAX class, its state carried across, the rest in
    the port: the whole equals the JAX class decoding the stream."""
    ref_spec, spec = _specs("NASA_K7")
    B, W = 4, ref_spec.traceback_len
    msgs, coded = _coded(ref_spec, B, 250, 0.03, seed=61)
    whole = ref_streaming.StreamingDecoderBatch(ref_spec, B, use_kernel=False)
    want = _feed(_call(whole), coded, CUTS, t=lambda a: a)
    first = ref_streaming.StreamingDecoderBatch(ref_spec, B, use_kernel=False)
    head = [np.asarray(first.decode(coded[:, :CUTS[0]])),
            np.asarray(first.decode(coded[:, CUTS[0]:CUTS[1]]))]
    reference = (np.asarray(first._metrics), np.asarray(first._registers))
    if layout == "kernel":
        lo, hi = ref_streaming._registers_to_planes(first._registers)
        reference = np.stack([reference[0].T, lo, hi])
    state = stream.stream_state_from_reference(reference, W, device="cpu")
    for use_kernel in (True, False):
        dec = streaming.StreamingDecoderBatch(spec, B, use_kernel=use_kernel,
                                              device="cpu")
        dec.resume(state, first._count)
        tail = dec.decode(torch.from_numpy(coded[:, CUTS[1]:]), last=True)
        for i, (g, w) in enumerate(zip(head + [tail.numpy()], want)):
            np.testing.assert_array_equal(g, w, err_msg=f"call {i}")
    np.testing.assert_array_equal(np.concatenate(want, axis=1), msgs)


@pytest.mark.parametrize("W", [7, 32, 33, 64])
def test_stream_state_conversions_round_trip(W):
    rng = np.random.default_rng(W)
    B, NS = 3, 64
    metrics = rng.integers(5, 900, (B, NS)).astype(np.int32)
    symbols = rng.integers(0, 2, (B, NS, W)).astype(np.uint8)
    state = stream.stream_state_from_reference((metrics, symbols), W,
                                               device="cpu")
    assert state.metrics.dtype == torch.int32
    assert state.registers.dtype == torch.int64
    np.testing.assert_array_equal(state.metrics.numpy(), _renormed(metrics))
    m, r = stream.stream_state_to_reference(state, W, layout="class")
    np.testing.assert_array_equal(r, symbols)
    planes = stream.stream_state_to_reference(state, W)
    assert planes.shape == (3, NS, B) and planes.dtype == np.int32
    lo, hi = ref_streaming._registers_to_planes(symbols)
    np.testing.assert_array_equal(planes[1], np.asarray(lo))
    np.testing.assert_array_equal(planes[2], np.asarray(hi))
    again = stream.stream_state_from_reference(planes, W, device="cpu")
    assert torch.equal(again.metrics, state.metrics)
    assert torch.equal(again.registers, state.registers)
    with pytest.raises(ValueError):
        stream.stream_state_from_reference((metrics, symbols), W + 1,
                                           device="cpu")


def test_stream_kernel_wrappers_plain_route():
    """The wrappers on CPU tensors: a state carried across a cut equals one
    call, the carried metrics have minimum 0, and a fresh state is the
    known start."""
    ref_spec, spec = _specs("K9_561_753")
    _, coded = _coded(ref_spec, 3, 120, 0.05, seed=3)
    x = torch.from_numpy(coded)
    fresh = stream.stream_state_init(spec, 3, "cpu")
    assert fresh.metrics[:, 0].eq(0).all()
    assert fresh.metrics[:, 1:].eq(viterbi.init_metric_value(spec)).all()
    sym, st = stream.stream_decode_batch(spec, x, fresh, 40)
    sym1, st1 = stream.stream_decode_batch(spec, x[:, :51], fresh, 40)
    sym2, st2 = stream.stream_decode_batch(spec, x[:, 51:], st1, 40)
    assert torch.equal(torch.cat([sym1, sym2], 1), sym)
    assert torch.equal(st2.metrics, st.metrics)
    assert torch.equal(st2.registers, st.registers)
    assert st.metrics.min(dim=1).values.eq(0).all()
    assert (st.registers >> 40).eq(0).all()
    sym0, st0 = stream.stream_decode_batch(spec, x[:, :0], st, 40)
    assert sym0.shape == (3, 0) and torch.equal(st0.registers, st.registers)
    assert stream.stream_kernel_supports(spec, 64)
    assert not stream.stream_kernel_supports(spec, 65)
    assert not stream.stream_kernel_supports(port.TOY_K3)
    with pytest.raises(ValueError):
        stream.stream_decode_batch(spec, x, fresh, 65)
    with pytest.raises(ValueError):
        stream.stream_decode_batch_soft(spec, x, fresh, 40)
    k2 = port.CodeSpec(K=3, k=2, g=(0o17, 0o06, 0o13))
    with pytest.raises(ValueError, match="k = 2"):
        stream.stream_decode_batch(k2, x, stream.stream_state_init(k2, 3,
                                                                   "cpu"))


def test_streaming_batch_non_symmetric_code(monkeypatch):
    """A k=1 NS=64 code without poly symmetry: the default route is the
    scan; an explicit kernel route runs the kernel's plain version on the
    CPU and raises NotImplementedError where the kernel would launch."""
    ref_spec, spec = (ref.CodeSpec(**NON_SYMMETRIC),
                      port.CodeSpec(**NON_SYMMETRIC))
    assert not spec.has_poly_symmetry
    msgs, coded = _coded(ref_spec, 4, 250, 0.0, seed=5)
    want = np.stack([ref_viterbi.viterbi_decode_stream(ref_spec, c)
                     for c in coded])
    for use_kernel in (None, True):
        dec = streaming.StreamingDecoderBatch(spec, 4, use_kernel=use_kernel,
                                              device="cpu")
        assert dec.use_kernel == bool(use_kernel)
        got = np.concatenate(_feed(_call(dec), coded, [128]), axis=1)
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(want, msgs)
    monkeypatch.setattr(stream, "_check_device", lambda t: True)
    dec = streaming.StreamingDecoderBatch(spec, 4, use_kernel=True,
                                          device="cpu")
    with pytest.raises(NotImplementedError, match="stream_k1_decode takes"):
        dec.decode(torch.from_numpy(coded[:, :48]))
    with pytest.raises(ValueError, match="traceback_len <= 64"):
        streaming.StreamingDecoderBatch(port.NASA_K7, 4, traceback_len=65,
                                        use_kernel=True, device="cpu")
    assert not streaming.StreamingDecoderBatch(
        port.NASA_K7, 4, traceback_len=65, device="cpu").use_kernel


def test_streaming_batch_short_packets():
    ref_spec, spec = _specs("NASA_K7")
    rng = np.random.default_rng(59)
    dec = streaming.StreamingDecoderBatch(spec, 3, device="cpu")
    for L in (1, 10, 29, 40):
        msgs = rng.integers(0, 2, (3, L), dtype=np.uint8)
        coded = torch.from_numpy(np.array(ref.encode_bits(ref_spec,
                                                          msgs)[0]))
        assert dec.decode(coded[:, :0]).shape == (3, 0)
        out = torch.cat([dec.decode(coded[:, :4]),
                         dec.decode(coded[:, 4:], last=True)], 1)
        np.testing.assert_array_equal(out.numpy(), msgs, err_msg=str(L))


# ---------------------------------------------------------------------------
# The masked traceback (K2m).


def _numpy_walk(spec, dec, starts, live, out_steps):
    """Walk uint8 decisions [B, T, NS] back from `starts` at step T - 1,
    decisions at steps >= live read as 0; bits of steps < out_steps."""
    B, T, _ = dec.shape
    cur = starts.astype(np.int64).copy()
    bits = np.zeros((B, T), np.uint8)
    for t in range(T - 1, -1, -1):
        d = dec[np.arange(B), t, cur] if t < live else np.zeros(B, np.int64)
        bits[:, t] = cur & 1
        cur = (cur >> 1) | (d.astype(np.int64) << (spec.S - 1))
    return bits[:, :out_steps]


@pytest.mark.parametrize("name", ["NASA_K7", "K9_561_753"])
def test_traceback_masked_plain_matches_numpy_walk(name):
    spec = port.PRESETS[name]
    rng = np.random.default_rng(7)
    B, T = 5, 61
    dec = rng.integers(0, 2, (B, T, spec.num_states)).astype(np.uint8)
    words = acs.pack_decisions(spec, torch.from_numpy(dec))
    starts = rng.integers(0, spec.num_states, B).astype(np.int32)
    for live in (0, spec.S, T - 1, T):
        for out_steps in (0, 13, T):
            want = _numpy_walk(spec, dec, starts, live, out_steps)
            got = acs.traceback_batch_masked(spec, words,
                                             torch.from_numpy(starts), live,
                                             out_steps)
            np.testing.assert_array_equal(got.numpy(), want,
                                          err_msg=f"{live} {out_steps}")
            got = acs.traceback_batch_masked(spec, words,
                                             torch.from_numpy(starts), live,
                                             out_steps, out="bytes")
            np.testing.assert_array_equal(
                got.numpy(), np.packbits(want, axis=1).reshape(B, -1))
    with pytest.raises(ValueError, match="live_steps"):
        acs.traceback_batch_masked(spec, words, torch.from_numpy(starts),
                                   T + 1, T)
    with pytest.raises(ValueError, match="start_states"):
        acs.traceback_batch_masked(spec, words,
                                   torch.from_numpy(starts).long(), T, T)


# ---------------------------------------------------------------------------
# The block-speed stream.


def test_block_streaming_matches_interpreted_pallas_kernels():
    """Call by call against the JAX class in interpret mode, at the smallest
    shape that crosses a kept-lookahead boundary: B = 4, three calls."""
    ref_spec, spec = _specs("NASA_K7")
    _, coded = _coded(ref_spec, 4, 150, 0.03, seed=67)
    want_dec = ref_streaming.BlockStreamingDecoderBatch(ref_spec, 4,
                                                        interpret=True)
    got_dec = streaming.BlockStreamingDecoderBatch(spec, 4, device="cpu")
    want = _feed(_call(want_dec), coded, [60, 110], t=lambda a: a)
    got = _feed(_call(got_dec), coded, [60, 110])
    assert [g.shape[1] for g in got] == [0, 48, 102]
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"call {i}")


def _one_shot(ref_spec, coded):
    return np.asarray(jax.vmap(lambda c: ref.viterbi_decode(ref_spec, c))(
        coded))


@pytest.mark.parametrize("cuts", [[200, 410, 460], [48], [33, 77, 300, 555],
                                  [706]], ids=["a", "b", "c", "d"])
def test_block_streaming_matches_one_shot(cuts):
    ref_spec, spec = _specs("NASA_K7")
    msgs, coded = _coded(ref_spec, 4, 700, 0.03, seed=71)
    want = _one_shot(ref_spec, coded)
    dec = streaming.BlockStreamingDecoderBatch(spec, 4, device="cpu")
    got = _feed(_call(dec), coded, cuts)
    assert got[-1].dtype == np.uint8
    np.testing.assert_array_equal(np.concatenate(got, axis=1), want)
    # The decoder resets at last=True: a second stream decodes the same.
    again = _feed(_call(dec), coded, cuts)
    np.testing.assert_array_equal(np.concatenate(again, axis=1), want)


def test_block_streaming_rate13():
    ref_spec, spec = _specs("NASA_K7_R13")
    _, coded = _coded(ref_spec, 4, 300, 0.03, seed=79)
    dec = streaming.BlockStreamingDecoderBatch(spec, 4, device="cpu")
    got = _feed(_call(dec), coded, [100, 200])
    np.testing.assert_array_equal(np.concatenate(got, axis=1),
                                  _one_shot(ref_spec, coded))


@pytest.mark.parametrize("qmax", [7, 31])
def test_block_streaming_soft_matches_one_shot(qmax):
    """Both soft routes: qmax 7 clips to +-7 (the 8-bit kernel's route),
    qmax 31 only floors -128."""
    ref_spec, spec = _specs("NASA_K7")
    _, coded = _coded(ref_spec, 4, 400, 0.03, seed=73)
    q = _soft(ref_spec, coded, 1, 127, seed=qmax)
    q.reshape(-1)[::11] = -128
    q = q.astype(np.int8)
    cond = np.maximum(q.astype(np.int32), -127)
    if ref_swar.swar8_soft_supported(ref_spec, qmax):
        cond = np.clip(cond, -qmax, qmax)
    assert (qmax == 7) == ref_swar.swar8_soft_supported(ref_spec, qmax)
    want = np.asarray(jax.vmap(
        lambda x: ref_metrics.viterbi_decode_soft(ref_spec, x))(cond))
    dec = streaming.BlockStreamingDecoderBatch(spec, 4, soft=True, qmax=qmax,
                                               device="cpu")
    got = _feed(_call(dec), q, [144, 250])
    np.testing.assert_array_equal(np.concatenate(got, axis=1), want)


def test_block_streaming_rejects():
    with pytest.raises(ValueError, match="SWAR"):
        streaming.BlockStreamingDecoderBatch(port.TOY_K3, 4, device="cpu")
    with pytest.raises(ValueError, match="SWAR"):
        streaming.BlockStreamingDecoderBatch(port.TOY_K3, 4, soft=True,
                                             device="cpu")
    for la in (0, 6):
        with pytest.raises(ValueError, match="lookahead"):
            streaming.BlockStreamingDecoderBatch(port.NASA_K7, 4,
                                                 lookahead=la, device="cpu")
    dec = streaming.BlockStreamingDecoderBatch(port.NASA_K7, 4, device="cpu")
    assert dec.decode(torch.zeros((4, 0), dtype=torch.uint8),
                      last=True).shape == (4, 0)
    with pytest.raises(ValueError, match="batch"):
        dec.decode(torch.zeros((3, 48), dtype=torch.uint8))


def test_package_exports_streaming():
    for name in ("StreamingEncoder", "StreamingDecoder",
                 "StreamingDecoderBatch", "BlockStreamingDecoderBatch"):
        assert getattr(port, name) is getattr(streaming, name)
        assert name in port.__all__
        assert hasattr(ref_streaming, name)
    assert port.streaming is streaming and ref.streaming is ref_streaming
    assert port.viterbi_decode_stream is viterbi.viterbi_decode_stream
