"""The narrow walk's schedule (csrc/traceback_k1.cu, `narrow_walk_kernel`:
the terminated, masked and ragged walks of `traceback_k1`,
`traceback_k1_masked` and `traceback_k1_ragged` at NS = 2 ... 256, TPU
kernels K2, K2m, K2r and K11's walk, one word a step at NS = 2 ... 32, TPU
kernel K12's walks, and the list walk of `traceback_k1_multi` at NS = 2
... 256, TPU kernel K6), modelled in numpy, against the port's plain walks;
the plain walks against the JAX package's traceback and ragged epilogue on
the same words; and the walk's dispatch lines.

The kernel runs only on the card, where chip_smoke.py holds it to the plain
walks; here a model done the way the kernel does it (windows, a segment a
lane, warm-up guesses, the top-down check and its walks again, the masked
steps' shifted bits, each ragged channel from its own top with its row
past its bits zeroed, each lane's whole output bytes; the list walk's rows
on the decisions from step out_start up, read from the windows that the
first row of their channel in the warp stages) is held bit for bit to
them.  The walk's constants are read from the source by chip_smoke.py's
helpers, never copied here.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import convolutionalencdec_tpu as ref
from convolutionalencdec_tpu.ops import viterbi as ref_viterbi

import convolutionalencdec_tpu_torch as port
from convolutionalencdec_tpu_torch.kernels import acs

ROOT = Path(__file__).resolve().parent.parent
SOURCE = ROOT / "convolutionalencdec_tpu_torch" / "csrc" / "traceback_k1.cu"


def _smoke():
    """chip_smoke.py, whose readers of csrc/traceback_k1.cu the model
    shares."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


_SMOKE = _smoke()
#: NS -> (G, warm-up steps), as chip_smoke.py reads them.
_LINES = {ns: rest for ns, *rest in _SMOKE.narrow_walk_lines()}
#: The lines of several words a step and of one word a step.
_WIDE = sorted(ns for ns in _LINES if ns >= 64)
_ONE_WORD = sorted(ns for ns in _LINES if ns < 64)
#: NS -> (G, warm-up steps) of the list walk's lines.
_MULTI_LINES = {ns: rest for ns, *rest in _SMOKE.narrow_multi_lines()}


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _spec(NS, rng, n=2):
    """A random poly-symmetric code with NS states and n generators."""
    K = NS.bit_length()
    return port.CodeSpec(K=K, g=tuple(
        (1 << (K - 1)) | 1 | (int(rng.integers(0, 1 << (K - 2))) << 1)
        for _ in range(n)))


def _garbage(rng, B, T, NS):
    """Uniform decision words: warm-up guesses go wrong (at NS >= 64)."""
    return rng.integers(-2 ** 31, 2 ** 31,
                        (B, T, max(NS // 32, 1))).astype(np.int32)


def _sparse(rng, B, T, NS):
    """Words with a bit set one time in 8: survivors merge within a few
    steps, so most guesses hold and a few segments are walked again."""
    return _garbage(rng, B, T, NS) & _garbage(rng, B, T, NS) & \
        _garbage(rng, B, T, NS)


def _noisy(rng, spec, B, T):
    """The plain forward's words of 3%-corrupted packets of T steps."""
    msgs = rng.integers(0, 2, (B, max(T - spec.S, 1)), dtype=np.uint8)
    seg = _SMOKE.corrupt(rng, _SMOKE.encode_reference_np(spec, msgs)[:, :T],
                         0.03, spec.n)
    return acs.acs_forward_batch_plain(spec, _t(seg))[0].numpy()


def _narrow_walk_model(NS, G, WU, words, t_top, T, starts, widths, rng,
                       lengths=None):
    """numpy model of `narrow_walk_kernel`, done the way the kernel does it.

    Channel b walks from state starts[b] (None: 0) at step T - 1; the steps
    [t_top, T) are masked (decision 0: the start shifts right a step each),
    so the walk proper starts at step t_top - 1 from starts[b] >> (T -
    t_top).  Ragged (`lengths`, with t_top = T): channel b walks from state
    0 at step t_b - 1, t_b = clamp(lengths[b], 0, T), and keeps msg_b =
    min(max(t_b - S, 0), L) bits of a row of L; a channel with none walks
    nothing.  C = `narrow_walk_lanes(t_top, G)` lanes a channel (ragged:
    from T, never from the lengths), lane l owning the segment [lo + l G,
    lo + l G + G) of each window [lo, lo + C G) on the grid of multiples of
    C G, the top window first; a window wholly above a channel's top is
    nothing to it.  A lane guesses the state at its segment's top by a
    warm-up of WU steps from state 0, or from the window's top state where
    the warm-up reaches it; then walks its segment, all lanes in lock step,
    each step's bit MSb first into a byte stored to the window's bytes at
    the byte's lowest step, the state there beside it.  In rounds, each
    lane whose start differs from the end of the segment above walks again
    from that state, stopping where the state at a byte's lowest step
    equals its earlier walk's (its end is then the earlier end).  The top
    segment's first byte starts with the masked steps' bits above t_top.
    For each row width L in `widths`: ragged, the bytes (bits) past each
    channel's bits are written 0 first; with starts, the masked steps' bits
    from the byte boundary above t_top on; then each window's bits below
    min(the channel's bits, its top, or the byte boundary above t_top in
    the top window), as bits or as bytes with the bits past them masked;
    the rows start as 0xA5 and the shared bytes as random.  Asserts that
    each lane stores only bytes of its own segment.  Returns ({L: (bits
    uint8 [B, L], bytes uint8 [B, ceil(L / 8)])}, segments walked
    again)."""
    B, T_stride, _ = words.shape
    S = NS.bit_length() - 1
    w64 = words.astype(np.int64) & 0xFFFFFFFF
    rows = np.arange(B)[:, None]
    C = _SMOKE.narrow_walk_lanes(t_top, G)
    WS, GB = C * G, G // 8
    lanes = np.arange(C)
    s0 = (np.zeros(B, np.int64) if starts is None
          else np.asarray(starts, np.int64) & (NS - 1))
    if lengths is None:
        tops = np.full(B, t_top, np.int64)
    else:
        t_b = np.clip(np.asarray(lengths, np.int64), 0, T_stride)
        tops = np.where(t_b > S, t_b, 0)
    hi_all = tops[:, None]

    def masked_bit(t):
        k = T - 1 - t
        return (s0 >> k) & 1 if 0 <= k < S else np.zeros(B, np.int64)

    top = s0 >> (T - t_top) if T - t_top < S else np.zeros(B, np.int64)
    top8 = (tops + 7) & ~7
    head = np.zeros(B, np.int64)
    if lengths is None:
        for t in range(t_top, top8[0]):
            head |= masked_bit(t) << (7 - (t & 7))

    def step(t, cur):
        i = (cur >> 1) | ((cur & 1) << (S - 1))
        d = (w64[rows, np.clip(t, 0, T_stride - 1), i >> 5]
             >> (i & 31)) & 1
        return (cur >> 1) | (d << (S - 1))

    stage = rng.integers(0, 256, (B, C * GB)).astype(np.int64)
    ck = rng.integers(0, NS, (B, C * GB)).astype(np.int64)
    outs = {L: (np.full((B, L), 0xA5, np.uint8),
                np.full((B, (L + 7) // 8), 0xA5, np.uint8)) for L in widths}
    msgs = {L: (np.full(B, L) if lengths is None
                else np.minimum(np.maximum(t_b - S, 0), L)) for L in widths}
    if lengths is not None:
        for L, (bits, out_bytes) in outs.items():
            for b in range(B):
                bits[b, msgs[L][b]:] = 0
                out_bytes[b, (msgs[L][b] + 7) // 8:] = 0
    if starts is not None:
        for L, (bits, out_bytes) in outs.items():
            for p in range(top8[0], L):
                bits[:, p] = masked_bit(p)
            for m in range(top8[0] // 8, (L + 7) // 8):
                v = np.zeros(B, np.int64)
                for q in range(8):
                    if m * 8 + q < L:
                        v |= masked_bit(m * 8 + q) << (7 - q)
                out_bytes[:, m] = v

    def walk(hi, lo_t, cur, on, acc, lo, emit, again=None):
        """Lanes `on` from step hi - 1 down to lo_t (per lane), in lock
        step; returns the states at step lo_t - 1.  `again`: the earlier
        walks' ends, where a walk stops on meeting its earlier walk."""
        hi, lo_t = np.broadcast_to(hi, (B, C)), np.broadcast_to(lo_t, (B, C))
        cur, on, acc = cur.copy(), on.copy(), acc.copy()
        for s in range(int(np.max(np.where(on, hi - lo_t, 0), initial=0))):
            t = hi - 1 - s
            act = on & (t >= lo_t)
            if emit:
                acc = np.where(act, acc | ((cur & 1) << (7 - (t & 7))), acc)
                store = act & ((t & 7) == 0)
                r, l = np.nonzero(store)
                m = (t[r, l] - lo) >> 3
                assert np.all((l * GB <= m) & (m < (l + 1) * GB))
                stage[r, m] = acc[r, l]
                acc = np.where(store, 0, acc)
                if again is not None:
                    met = np.zeros_like(store)
                    met[r, l] = ck[r, m] == cur[r, l]
                    cur = np.where(met, again, cur)
                    act &= ~met
                    on &= ~met
                    r, l = np.nonzero(store & ~met)
                    m = (t[r, l] - lo) >> 3
                ck[r, m] = cur[r, l]
            cur = np.where(act, step(t, cur), cur)
        return cur

    rewalks = 0
    zeros = np.zeros((B, C), np.int64)
    for j in reversed(range(-(-int(tops.max(initial=0)) // WS))):
        lo = j * WS
        hi = np.minimum(lo + WS, hi_all)                      # [B, 1]
        a = lo + lanes * G
        b = np.minimum(a + G, hi)                             # [B, C]
        mine = a < hi
        top_seg = b == hi
        guessing = mine & ~top_seg
        t0 = np.minimum(b - 1 + WU, hi - 1)
        x = np.where(t0 == hi - 1, top[:, None], 0)
        start = np.where(guessing, walk(t0 + 1, b, x, guessing, zeros, lo,
                                        False), top[:, None])
        acc = np.where(b == hi_all, head[:, None], 0)
        end = np.where(mine, walk(b, a, start, mine, acc, lo, True), 0)
        while True:
            above = np.concatenate([end[:, 1:], end[:, -1:]], axis=1)
            redo = mine & ~top_seg & (above != start)
            if not redo.any():
                break
            rewalks += int(redo.sum())
            start = np.where(redo, above, start)
            end = np.where(redo, walk(b, a, start, redo, zeros, lo, True,
                                      end), end)
        top = end[:, 0]
        staged = stage.astype(np.uint8)
        for L, (bits, out_bytes) in outs.items():
            h = hi[:, 0]
            bit_hi = np.minimum(np.where(h == tops, top8, h), msgs[L])
            for c in np.nonzero(bit_hi > lo)[0]:
                bh = int(bit_hi[c])
                bits[c, lo:bh] = np.unpackbits(staged[c])[:bh - lo]
                m_lo, m_hi = lo // 8, (bh + 7) // 8
                out_bytes[c, m_lo:m_hi] = staged[c, :m_hi - m_lo]
                if bh % 8:
                    out_bytes[c, m_hi - 1] &= 0xFF << (8 - bh % 8) & 0xFF
    return outs, rewalks


def _assert_rows(outs, want):
    """Each width's model bits and bytes against the plain walk's bits."""
    for L, (bits, out_bytes) in outs.items():
        np.testing.assert_array_equal(bits, want[:, :L].numpy())
        np.testing.assert_array_equal(
            out_bytes, port.ops.viterbi.pad_and_pack(want[:, :L]).numpy())


def _terminated(NS, words, t_actual, rng, wu=None):
    """The model's terminated walk against `traceback_batch_plain`, whole
    and cut messages; returns the segments walked again."""
    G, WU = _LINES[NS]
    spec = _spec(NS, rng)
    full = t_actual - spec.S
    outs, rewalks = _narrow_walk_model(
        NS, G, WU if wu is None else wu, words, t_actual, t_actual, None,
        sorted({full, _SMOKE.cut_bits(full)}), rng)
    _assert_rows(outs, acs.traceback_batch_plain(spec, _t(words), t_actual,
                                                 full, "bits"))
    return rewalks


def _masked(NS, words, starts, live, rng, wu=None):
    """The model's masked walk against `traceback_batch_masked_plain`,
    out_steps T and a cut one; returns the segments walked again."""
    G, WU = _LINES[NS]
    spec = _spec(NS, rng)
    T = words.shape[1]
    outs, rewalks = _narrow_walk_model(
        NS, G, WU if wu is None else wu, words, live, T, starts,
        sorted({T, _SMOKE.cut_bits(T)}), rng)
    _assert_rows(outs, acs.traceback_batch_masked_plain(
        spec, _t(words), _t(np.asarray(starts, np.int32)), live, T, "bits"))
    return rewalks


def _ragged(NS, words, lengths, rng, wu=None):
    """The model's ragged walk against `traceback_batch_ragged_plain`, rows
    of T - S bits and a cut one; returns the segments walked again."""
    G, WU = _LINES[NS]
    spec = _spec(NS, rng)
    T = words.shape[1]
    full = max(T - spec.S, 0)
    widths = sorted({full, _SMOKE.cut_bits(full)} - {0})
    outs, rewalks = _narrow_walk_model(
        NS, G, WU if wu is None else wu, words, T, T, None, widths, rng,
        lengths)
    lens = _t(np.asarray(lengths, np.int32))
    _assert_rows(outs, acs.traceback_batch_ragged_plain(spec, _t(words), lens,
                                                        full, "bits"))
    return rewalks


def _multi(NS, words, starts, live, out_start, widths, rng, spec=None):
    """The model's list walk against `traceback_batch_multi_plain`: row
    b NW + w the masked walk from starts[b, w] on channel b's words from
    step out_start up (T - out_start steps, the live ones below live -
    out_start), at the list walk's line, the row reading the windows that
    the first row of its channel in the warp stages (the kernel's c0:
    asserted to be of the same channel and warp, its slot within the
    channels the launch sizes the warp's shared memory for); rows of each
    width in
    `widths`.  Returns (segments walked again, the plain walk's bits
    [B, NW, max(widths)])."""
    G, WU = _MULTI_LINES[NS]
    spec = spec or _spec(NS, rng)
    B, T = words.shape[:2]
    NW = starts.shape[1]
    steps = T - out_start
    t_top = min(max(live - out_start, 0), steps)
    CPW = 32 // _SMOKE.narrow_walk_lanes(t_top, G)
    rows = np.arange(B * NW)
    chan = rows // NW
    stager = np.maximum(chan * NW, rows // CPW * CPW)
    assert np.all((stager // NW == chan) & (stager // CPW == rows // CPW)
                  & (stager <= rows))
    # Each channel's staged rows: its slot among the warp's channels, fewer
    # than the K the launch sizes a warp's shared memory for.
    slot = chan - rows // CPW * CPW // NW
    assert np.all(slot < min(CPW, (CPW + NW - 2) // NW + 1))
    outs, rewalks = _narrow_walk_model(
        NS, G, WU, words[stager // NW, out_start:], t_top, steps,
        starts.reshape(-1), widths, rng)
    want = acs.traceback_batch_multi_plain(
        spec, _t(words), _t(starts.astype(np.int32)), live, out_start,
        max(widths), "bits")
    _assert_rows(outs, want.reshape(B * NW, -1))
    return rewalks, want.numpy()


def _jax_multi(NS, spec, words, starts, live, out_start, steps):
    """The JAX package's traceback of each (channel, walk): decisions past
    `live` zeroed, from starts[b, w] at step T - 1 with no padding, sliced
    to the window [out_start, out_start + steps) as its list epilogue
    (ops/tailbiting.py `_list_from_forward`) slices it."""
    rspec = ref.CodeSpec(K=spec.K, g=spec.g)
    dec = acs.unpack_decisions(spec, _t(words)).numpy()
    dec[:, live:] = 0

    def one(d, s):
        bits = ref_viterbi.traceback_terminated(rspec, d, num_pad=0,
                                                start_state=s)
        return jax.lax.slice_in_dim(bits, out_start, out_start + steps)

    return np.asarray(jax.vmap(lambda d, ss: jax.vmap(
        lambda s: one(d, s))(ss))(jnp.asarray(dec),
                                  jnp.asarray(starts.astype(np.int32))))


# At each NS of the list walk's switch: "windows" a code's noisy words over
# four segments a walk from out_start 3 (min(8, NS) walks, live T - 5, the
# rows whole and cut) and, over two windows, words that send guesses wrong
# (garbage; rotating words below 64 states) with min(NS, 16) walks from
# out_start 48 (walks again asserted); "edges" the tail-biting DCI shape (144 steps, out_start 88,
# min(8, NS) walks; the JAX traceback too), every step masked (live below
# out_start), a window of one step (out_start T - 1) and T = 1.
_MULTI_CASES = [(NS, which) for NS in sorted(_MULTI_LINES)
                for which in ("windows", "edges")]


@pytest.mark.parametrize("NS,which", _MULTI_CASES,
                         ids=[f"NS{ns}-{w}" for ns, w in _MULTI_CASES])
def test_list_walk_schedule_model_matches_plain_and_jax(NS, which):
    """The list walk's schedule (a masked walk a row on the decisions from
    step out_start up, the byte grid from out_start, a channel's windows
    staged once for its walks in the warp), modelled in numpy at its
    line's G and warm-up, gives the plain list walk's bits and bytes bit
    for bit; at the tail-biting DCI shape the plain walk gives the JAX
    traceback's window."""
    G, _ = _MULTI_LINES[NS]
    rng = np.random.default_rng(NS + 17 * len(which))
    S = NS.bit_length() - 1
    nw = min(8, NS)
    if which == "windows":
        spec = _spec(NS, rng, 3)
        T = 3 * G + 21
        words = _noisy(rng, spec, 2, T)
        _multi(NS, words, rng.integers(0, NS, (2, nw)), T - 5, 3,
               sorted({T - 3, _SMOKE.cut_bits(T - 3)}), rng, spec)
        T = 32 * G + 45
        words = (_garbage(rng, 2, T, NS) if NS >= 64
                 else _SMOKE.rotating_words(rng, 2, T, NS))
        rewalks, _ = _multi(NS, words, rng.integers(0, NS, (2, min(NS, 16))),
                            T, 48, [T - 48], rng)
        assert rewalks > 0
    else:
        spec = _spec(NS, rng, 3)
        T = 144
        words = _noisy(rng, spec, 3, T)
        starts = rng.integers(0, NS, (3, nw))
        _, bits = _multi(NS, words, starts, T, 88, [56], rng, spec)
        np.testing.assert_array_equal(
            bits, _jax_multi(NS, spec, words, starts, T, 88, 56))
        _multi(NS, words, starts, 50, 88, [56, 19], rng)
        _multi(NS, words, starts, T - 2, T - 1, [1], rng)
        _multi(NS, words[:1, :1], starts[:1], 1, 0, [1], rng)


# At each NS of the dispatch switch, at its line's G and warm-up:
# "noisy" the forward's words of noisy packets over two windows, the walk
# from t_actual two below the rows' length, and with no warm-up (every
# guess from state 0: segments walked again, asserted); "edges" T = 1, 5
# and 9 masked at every live and t_actual = S + 3 (a short walk packs
# channels into a warp); "garbage" uniform words over a window and a step,
# terminated (re-walks asserted) and masked at live 0, S, T - 1 and T from
# random starts; "windows" four windows of sparse words, terminated, and
# masked at a live a window below T with no warm-up.
_CASES = [(NS, which) for NS in _WIDE
          for which in ("noisy", "edges", "garbage", "windows")]


@pytest.mark.parametrize("NS,which", _CASES,
                         ids=[f"NS{ns}-{w}" for ns, w in _CASES])
def test_narrow_walk_schedule_model_matches_plain_walks(NS, which):
    """The narrow walk's windows, lanes a channel, warm-ups, guesses,
    top-down check and walks again, masked steps and whole output bytes,
    modelled in numpy, give the plain terminated and masked walks' bits
    and bytes bit for bit."""
    G, WU = _LINES[NS]
    rng = np.random.default_rng(NS + 7 * len(which))
    S = NS.bit_length() - 1
    if which == "noisy":
        spec = _spec(NS, rng, 4)
        words = _noisy(rng, spec, 3, 32 * G + 21)
        T = words.shape[1]
        _terminated(NS, words, T - 2, rng)
        assert _terminated(NS, words, T - 2, rng, wu=0) > 0
        _masked(NS, words, rng.integers(0, NS, 3), T, rng)
    elif which == "edges":
        for T in (1, 5, 9):
            words = _garbage(rng, 3, T, NS)
            for live in sorted({0, min(S, T), T - 1, T}):
                _masked(NS, words, rng.integers(0, NS, 3), live, rng)
        _terminated(NS, _garbage(rng, 3, S + 5, NS), S + 3, rng)
    elif which == "garbage":
        T = 32 * G + 1
        words = _garbage(rng, 2, T, NS)
        assert _terminated(NS, words, T, rng) > 0
        for live in (0, S, T - 1, T):
            _masked(NS, words, rng.integers(0, NS, 2), live, rng)
    else:
        T = 96 * G + 37
        words = _sparse(rng, 1, T, NS)
        _terminated(NS, words, T - 3, rng)
        _masked(NS, words, rng.integers(0, NS, 1), T - 32 * G, rng, wu=0)


# At each NS of one word a step, the terminated walk only: "edges" the
# shortest walks (t_actual = S + 1: one bit, S + 3, 9) and t_actual = G + 1
# and 32 G - 3 on random words; "noisy" the forward's words over two
# windows from t_actual two below the rows' length (not a multiple of 8),
# also with no warm-up (walks again asserted); "random" uniform words over
# four windows, and words whose decisions rotate the state (no two
# survivors meet: guesses from state 0 go wrong, walks again asserted).
_ONE_WORD_CASES = [(NS, which) for NS in _ONE_WORD
                   for which in ("edges", "noisy", "random")]


@pytest.mark.parametrize("NS,which", _ONE_WORD_CASES,
                         ids=[f"NS{ns}-{w}" for ns, w in _ONE_WORD_CASES])
def test_narrow_walk_one_word_model_matches_plain_walk(NS, which):
    """The narrow walk at one decision word a step (the state's bit at i =
    (s >> 1) | ((s & 1) << (S - 1)) of the word; S = 1 and 2 included,
    where a warm-up from state 0 is most often right and the top-down
    check carries the rest), modelled in numpy at its line's G and
    warm-up, gives the plain terminated walk's bits and bytes bit for
    bit."""
    G, WU = _LINES[NS]
    rng = np.random.default_rng(NS + 11 * len(which))
    S = NS.bit_length() - 1
    if which == "edges":
        for t_actual in sorted({S + 1, S + 3, 9, G + 1, 32 * G - 3}):
            _terminated(NS, _garbage(rng, 3, t_actual + 2, NS), t_actual,
                        rng)
    elif which == "noisy":
        spec = _spec(NS, rng, 3)
        words = _noisy(rng, spec, 3, 32 * G + 21)
        T = words.shape[1]
        _terminated(NS, words, T - 2, rng)
        assert _terminated(NS, words, T - 2, rng, wu=0) > 0
    else:
        T = 96 * G + 37
        _terminated(NS, _garbage(rng, 2, T, NS), T, rng)
        words = _SMOKE.rotating_words(rng, 2, T, NS)
        assert _terminated(NS, words, T - 3, rng) > 0


# At each NS of one word a step, the masked and the ragged walk: "masked"
# T = 1, 5 and 9 at every live, uniform words over a window and a step at
# live 0, S, T - 1 and T, and over four windows words whose decisions
# rotate the state, from live T and from a live a window below T with no
# warm-up (walks again asserted on both); "ragged" the edge lengths and
# random ones over one window of uniform words (a short walk packs
# channels into a warp) and over four windows of the forward's words,
# also with no warm-up, and of rotating words (walks again asserted).
_ONE_WORD_MODE_CASES = [(NS, which) for NS in _ONE_WORD
                        for which in ("masked", "ragged")]


@pytest.mark.parametrize("NS,which", _ONE_WORD_MODE_CASES,
                         ids=[f"NS{ns}-{w}" for ns, w in _ONE_WORD_MODE_CASES])
def test_narrow_walk_one_word_masked_and_ragged_match_plain_walks(NS, which):
    """The narrow walk's masked and ragged modes at one decision word a step
    (S = 1 ... 5), modelled in numpy at the dispatch line's G and warm-up
    (each channel from its own top or from its shifted start, the masked
    steps' bits written without a walk, a ragged row past its bits written
    0), give the plain masked and ragged walks' bits and bytes bit for bit
    into rows first filled with 0xA5."""
    G, WU = _LINES[NS]
    rng = np.random.default_rng(NS + 13 * len(which))
    S = NS.bit_length() - 1
    if which == "masked":
        for T in (1, 5, 9):
            words = _garbage(rng, 3, T, NS)
            for live in sorted({0, min(S, T), T - 1, T}):
                _masked(NS, words, rng.integers(0, NS, 3), live, rng)
        T = 32 * G + 1
        words = _garbage(rng, 2, T, NS)
        for live in (0, S, T - 1, T):
            _masked(NS, words, rng.integers(0, NS, 2), live, rng)
        T = 96 * G + 37
        words = _SMOKE.rotating_words(rng, 2, T, NS)
        assert _masked(NS, words, rng.integers(0, NS, 2), T, rng) > 0
        assert _masked(NS, words, rng.integers(0, NS, 2), T - 32 * G, rng,
                       wu=0) > 0
    else:
        T = S + 5
        _ragged(NS, _garbage(rng, 9, T, NS),
                _SMOKE.narrow_ragged_lengths(rng, 9, T, S), rng)
        T = 96 * G + 37
        words = _noisy(rng, _spec(NS, rng, 3), 12, T)
        _ragged(NS, words, _SMOKE.narrow_ragged_lengths(rng, 12, T, S), rng)
        lens = _SMOKE.narrow_ragged_lengths(rng, 12, T, S)
        assert _ragged(NS, words, lens, rng, wu=0) > 0
        words = _SMOKE.rotating_words(rng, 12, T, NS)
        assert _ragged(NS, words, lens, rng) > 0


@pytest.mark.parametrize("NS", _WIDE)
def test_narrow_walk_ragged_model_matches_plain_walk(NS):
    """The ragged walk's schedule (each channel from its own top on the
    launch's window grid, lanes a channel from T, a channel with no bits
    walking nothing, its row past its bits written 0), modelled in numpy,
    gives the plain ragged walk's bits and bytes into rows first filled
    with 0xA5: the edge lengths and random ones over one window (a short
    walk packs channels into a warp), over four windows of the forward's
    words and of garbage words (re-walks asserted), and without warm-ups."""
    G, WU = _LINES[NS]
    rng = np.random.default_rng(NS + 3)
    S = NS.bit_length() - 1
    spec = _spec(NS, rng, 4)
    T = S + 5
    words = _garbage(rng, 9, T, NS)
    _ragged(NS, words, _SMOKE.narrow_ragged_lengths(rng, 9, T, S), rng)
    T = 96 * G + 37
    words = _noisy(rng, spec, 12, T)
    _ragged(NS, words, _SMOKE.narrow_ragged_lengths(rng, 12, T, S), rng)
    lens = _SMOKE.narrow_ragged_lengths(rng, 12, T, S)
    assert _ragged(NS, words, lens, rng, wu=0) > 0
    words = _garbage(rng, 12, T, NS)
    assert _ragged(NS, words, lens, rng) > 0


@pytest.mark.parametrize("NS", sorted(_LINES))
def test_narrow_walk_plain_walks_match_the_jax_traceback(NS):
    """The plain walks the model is held to give the JAX package's
    traceback on the same words (unpacked to decisions), at several words
    a step and at one: terminated from state 0, masked (decisions past
    `live` zeroed, no padding dropped) from random starts, and ragged at
    the edge lengths through the JAX ragged epilogue."""
    rng = np.random.default_rng(NS + 99)
    G = _LINES[NS][0]
    spec = _spec(NS, rng, 4)
    rspec = ref.CodeSpec(K=spec.K, g=spec.g)
    words = _noisy(rng, spec, 3, G + 29)
    T = words.shape[1]
    dec = acs.unpack_decisions(spec, _t(words)).numpy()
    want = jax.vmap(lambda d: ref_viterbi.traceback_terminated(rspec, d))(
        jnp.asarray(dec))
    got = acs.traceback_batch_plain(spec, _t(words), T, T - spec.S, "bits")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    starts = rng.integers(0, NS, 3)
    live = T - 5
    dec[:, live:] = 0
    want = jax.vmap(lambda d, s: ref_viterbi.traceback_terminated(
        rspec, d, num_pad=0, start_state=s))(jnp.asarray(dec),
                                              jnp.asarray(starts))
    got = acs.traceback_batch_masked_plain(
        spec, _t(words), _t(starts.astype(np.int32)), live, T, "bits")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # Ragged, at the edge lengths (the JAX epilogue takes them clamped, as
    # its decoders pass them).
    lens = np.clip(_SMOKE.narrow_ragged_lengths(rng, 8, T, spec.S)[[0, 3, 5]],
                   0, T)
    dec = acs.unpack_decisions(spec, _t(words)).numpy()
    want = ref_viterbi.ragged_epilogue(rspec, jnp.asarray(dec),
                                       jnp.asarray(lens.astype(np.int32)), T)
    got = acs.traceback_batch_ragged_plain(
        spec, _t(words), _t(lens.astype(np.int32)), T - spec.S, "bits")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_narrow_walk_dispatch_covers_64_to_256():
    """The narrow walk's dispatch switch has exactly one line for each of
    NS = 2, 4, ..., 256, each with segments of whole output bytes and whole
    blocks of warm-up; each segment's staged rows at a pitch of an odd
    number of 16-byte chunks; the staged windows, the output bytes and
    their states (as the source sizes them) within a block's shared memory
    on the card (227 KiB); the terminated, masked and ragged walks take it
    at every NS, the ragged one with its lengths and the launch's T for its
    lanes a channel; the list walk at every NS through its own switch (one
    line an NS, the same rules; the tail-biting DCI walk of 56 steps in one
    window), on the decisions from out_start up; and no other walk is left
    in the file (the thread-a-channel `traceback_k1_kernel` is gone)."""
    lines = _SMOKE.narrow_walk_lines()
    multi = _SMOKE.narrow_multi_lines()
    assert [ns for ns, *_ in lines] == [2, 4, 8, 16, 32, 64, 128, 256]
    assert [ns for ns, *_ in multi] == [2, 4, 8, 16, 32, 64, 128, 256]
    for NS, G, WU in multi:
        assert G % 8 == 0 and WU % 8 == 0 and WU >= 0
        pitch, smem = _SMOKE.narrow_walk_smem(NS, G)
        assert pitch % 4 == 0 and (pitch // 4) % 2 == 1
        assert smem <= 227 * 1024
        assert _SMOKE.narrow_walk_lanes(56, G) * G >= 56
    for NS, G, WU in lines:
        assert G % 8 == 0 and WU % 8 == 0 and WU >= 0
        pitch, smem = _SMOKE.narrow_walk_smem(NS, G)
        assert pitch % 4 == 0 and (pitch // 4) % 2 == 1
        assert smem <= 227 * 1024
        # A main-path walk (2054 steps) takes 32 lanes a channel; the
        # tail-biting decode's 192 steps fewer, with channels sharing a warp.
        assert _SMOKE.narrow_walk_lanes(2054, G) == 32
        C = _SMOKE.narrow_walk_lanes(192, G)
        assert C * G >= 192 and (C == 1 or (C // 2) * G < 192)
    src = SOURCE.read_text()

    def body(name):
        start = src.index(f"\nint {name}(")
        return src[start:src.index("\n}\n", start)]

    for name in ("terminated", "masked", "ragged"):
        text = body(name)
        assert "return launch_narrow_walk(a, NS," in text
        assert "if (" not in text and "launch<" not in text
    ragged = body("ragged")
    assert "static_cast<const int32_t*>(lengths)" in ragged
    # The ragged launch's t_top and T are the rows' T: C comes from T.
    assert "B, T, T, T," in ragged
    # The masked launch's t_top is `live`, its T the rows' T.
    assert "B, T, live, T, out_steps," in body("masked")
    # Every NS instantiates the ragged mode: no guard on the state count.
    mode = src[src.index("int launch_narrow_mode("):]
    mode = mode[:mode.index("\n}\n")]
    assert "kRagged>(a, s);" in mode and "if constexpr (LOGNS" not in mode
    text = body("multi")
    assert "launch_multi_walk(a, NS," in text and "launch<" not in text
    # Rows B NW, T_stride T, t_top and T from out_start, nw and the base.
    assert "B * NW, T," in text and "NW, out_start};" in text
    assert "min(max(live - out_start, 0), steps), steps, out_steps" in text
    for gone in ("traceback_k1_kernel", "enum class Walk", "kThreads",
                 "kWide", "TB_LAUNCH"):
        assert gone not in src, gone
    assert src.count("__global__") == 1
    # The wrappers' kernel names are those of the C entries.
    assert acs._walk_kernel(port.NASA_K7) == "traceback_k1"
    assert acs._walk_kernel(port.NASA_K7, "_masked") == "traceback_k1_masked"
    assert acs._walk_kernel(port.NASA_K7, "_ragged") == "traceback_k1_ragged"
    assert acs._walk_kernel(port.NASA_K7, "_multi") == "traceback_k1_multi"
