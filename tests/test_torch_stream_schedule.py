"""The register-exchange stream decode's schedule (csrc/stream_k1.cu,
`stream_k1_kernel`, TPU kernel K5, hard and soft), modelled in numpy,
against the port's stream scan (ops/viterbi.stream_scan through
kernels/stream.py's plain versions) and the JAX package's streaming
decode (ops/streaming.decode_chunk, decode_chunk_soft), bit for bit.

The kernel runs only on the card, where chip_smoke.py holds it to its plain
version; here a model done the way the kernel does it is held to both:
a hard segment's bit i as the LLR 1 - 2 bit and the metrics without the
relu(-q) sums; no survivor register moves; each step's decisions are the
two ballots of each 32-butterfly group (lanes 0-15 even destinations
first, lanes 16-31 odd ones), kept in a ring of kRing steps and turned
into decision words (bit p NS/2 + b for state 2b + p) after each block of
32 steps; the argmin of each step as the least of each state's (metric -
lb) << 8 | state, the difference clamped (lb: the last block's last least
metric less kDrop); each step's symbol emitted after its block by
walking W - 1 steps back from its argmin state through the ring, or, where
the walk runs out of the call's steps, from the carried register of the
state reached; the registers out walked back W steps from the call's last
step.  The ring's size and the packing's constants are read from its
source.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import convolutionalencdec_tpu as ref
from convolutionalencdec_tpu.ops import streaming as ref_streaming

import convolutionalencdec_tpu_torch as port
from convolutionalencdec_tpu_torch.kernels import stream as kstream
from convolutionalencdec_tpu_torch.ops.trellis import butterfly_coded_bits

SOURCE = (Path(__file__).resolve().parent.parent / "convolutionalencdec_tpu_torch"
          / "csrc" / "stream_k1.cu").read_text()
RING = int(re.search(r"constexpr int kRing = (\d+);", SOURCE).group(1))
DROP = 1 << int(re.search(r"constexpr int kDrop = 1 << (\d+);", SOURCE).group(1))
CLAMP = (1 << int(re.search(r"constexpr unsigned kClamp = \(1u << (\d+)\) - 1u;",
                            SOURCE).group(1))) - 1
BLOCK = 32


def _model(spec, x, soft, W, m_in, r_in):
    """numpy model of `stream_k1_kernel`: (symbols uint8 [B, T], metrics
    int32 [B, NS] less their minimum, registers uint64 [B, NS]) of segments
    x [B, T] or LLRs x [B, T, n] from metrics m_in and registers r_in."""
    NS = spec.num_states
    BPL, HALF, S, n = NS // 64, NS // 2, spec.S, spec.n
    B, T = x.shape[:2]
    cb = butterfly_coded_bits(spec).astype(np.int64)
    bits = (cb[:, None] >> np.arange(n)) & 1                  # [NS/2, n]
    if soft:
        x = np.maximum(x.astype(np.int64), -127)
    else:  # a segment's bit i as the LLR 1 - 2 bit
        x = 1 - 2 * ((x[..., None].astype(np.int64) >> np.arange(n)) & 1)
    m = m_in.astype(np.int64).copy()
    reg = r_in.astype(np.uint64)                               # the copy
    ring = np.zeros((B, RING, NS // 32), np.int64)
    keys = np.zeros((B, T), np.int64)
    sym = np.zeros((B, T), np.uint8)
    lanes = np.arange(32)
    cand = 32 * np.arange(2 * BPL)[:, None] + lanes            # [2BPL, 32]
    rows = np.arange(B)

    def walk(xs, t, steps):
        """Back `steps` decisions from states xs at step t (per channel)."""
        xs, t = xs.copy(), t.copy()
        for k in range(int(steps.max(initial=0))):
            go = k < steps
            i = ((xs & 1) << (S - 1)) | (xs >> 1)
            w = ring[rows, t % RING, i >> 5]
            d = (w >> (i & 31)) & 1
            xs = np.where(go, (xs >> 1) | (d << (S - 1)), xs)
            t = t - 1
        return xs

    def emit(block):
        """The symbols of a block's steps from their argmin states."""
        for tt in block:
            key = keys[:, tt]
            if tt >= W - 1:
                sym[:, tt] = walk(key, np.full(B, tt), np.full(B, W - 1)) & 1
            else:
                y0 = walk(key, np.full(B, tt), np.full(B, tt + 1))
                sym[:, tt] = (reg[rows, y0] >> np.uint64(W - 2 - tt)) & 1

    lb = m.min(1) - DROP                                       # [B]
    for t0 in range(0, T, BLOCK):
        steps = min(BLOCK, T - t0)
        for t in range(t0, t0 + steps):
            f = x[:, t] @ bits.T                                # [B, NS/2]
            fc = x[:, t].sum(1)[:, None] - f
            lo, hi = m[:, :HALF], m[:, HALF:]
            a0, a1, b0, b1 = lo + f, hi + fc, lo + fc, hi + f
            de, do = a0 > a1, b0 > b1
            m = np.stack([np.minimum(a0, a1), np.minimum(b0, b1)],
                         2).reshape(B, NS)
            # Ballots d1, d2 of group j; lane 0's raw store, turned into
            # words after the block (byte_perm 0x7610).
            up = (lanes >= 16)[None, None]
            e = de.reshape(B, BPL, 32)
            o = do.reshape(B, BPL, 32)
            d1 = (np.where(up, o, e).astype(np.int64) << lanes).sum(-1)
            d2 = (np.where(up, e, o).astype(np.int64) << lanes).sum(-1)
            lo16, hi16 = 0xFFFF, 0xFFFF0000
            ring[:, t % RING, :BPL] = (d1 & lo16) | (d2 & hi16)
            ring[:, t % RING, BPL:] = (d2 & lo16) | (d1 & hi16)
            # Each state packed as (metric - lb) << 8 | state, the
            # difference clamped; each lane's least, then the warp's.
            diff = m[:, cand] - lb[:, None, None]               # [B, 2BPL, 32]
            assert diff.min() >= 0
            packed = (np.minimum(diff, CLAMP) << 8) | cand
            last = packed.min(1).min(1)
            assert (last >> 8).max() < CLAMP and np.array_equal(
                (last >> 8) + lb, m.min(1))
            keys[:, t] = last & 0xFF
        lb = lb + (last >> 8) - DROP
        emit(range(t0, t0 + steps))  # the block's emits, after it
    # The registers out: W steps back from the call's last step.
    out = np.zeros((B, NS), np.uint64)
    for state in range(NS):
        xs = np.full(B, state)
        r = np.zeros(B, np.uint64)
        k, t = 0, T - 1
        while k < W and t >= 0:
            r |= (xs & 1).astype(np.uint64) << np.uint64(k)
            xs = walk(xs, np.full(B, t), np.ones(B, np.int64))
            k, t = k + 1, t - 1
        if k < W:
            r |= reg[rows, xs] << np.uint64(k)
        out[:, state] = r & np.uint64((1 << W) - 1 if W < 64 else 2 ** 64 - 1)
    m = m - m.min(1, keepdims=True)
    return sym, m.astype(np.int32), out


def _to_symbols(r, W):
    """uint64 registers [B, NS] -> uint8 [B, NS, W], the newest first."""
    return ((r[..., None] >> np.arange(W, dtype=np.uint64)) & 1).astype(
        np.uint8)


def _inputs(spec, rng, B, T, soft):
    """Hard: segments of random messages hit at 8% and a garbage row;
    soft: LLRs over the whole int8 range, -128 among them, 20% erased."""
    n = spec.n
    if soft:
        q = rng.integers(-128, 128, (B, T, n))
        q[rng.random(q.shape) < 0.2] = 0
        q.reshape(-1)[::17] = -128
        return q.astype(np.int8)
    msgs = rng.integers(0, 2, (B, T), dtype=np.uint8)
    seg = port.encode_bits(spec, torch.from_numpy(msgs),
                           terminate=False)[0].numpy()[:, :T]
    hit = rng.random(seg.shape) < 0.08
    seg = seg ^ (hit * rng.integers(1, 1 << n, seg.shape)).astype(np.uint8)
    seg[-1] = rng.integers(0, 1 << n, T)
    return seg.astype(np.uint8)


def _plain(spec, x, soft, W, state):
    fn = (kstream.stream_decode_batch_soft_plain if soft
          else kstream.stream_decode_batch_plain)
    sym, st = fn(spec, torch.from_numpy(x), state, W)
    return (sym.numpy(), st.metrics.numpy(),
            st.registers.numpy().view(np.uint64))


# (preset, W, soft): W = 2, 7, 35, 64 hard and soft between them; NS 64,
# 128 and 256.
CASES = [("NASA_K7", 2, False), ("NASA_K7", 7, True), ("NASA_K7", 35, False),
         ("NASA_K7", 64, True), ("K8", 35, True), ("K9_561_753", 7, False)]
K8 = dict(K=8, g=(0o247, 0o371))


@pytest.mark.parametrize("name,W,soft", CASES,
                         ids=[f"{c[0]}-W{c[1]}-{'soft' if c[2] else 'hard'}"
                              for c in CASES])
def test_stream_schedule_model_matches_the_scans(name, W, soft):
    """From a carried state (random metrics and W-bit registers), over
    T = 2 x 50 steps in one call and in two calls cut at 50 (the state
    carried; the second call's first W - 1 emits reach into the carried
    registers), B = 3: the model's symbols, metrics less their minimum and
    registers equal the port's scan; at W = 35 (NS 64 hard, NS 128 soft),
    the JAX package's streaming decode of each channel (vmapped) as
    well."""
    if name == "K8":
        spec, rspec = port.CodeSpec(**K8), ref.CodeSpec(**K8)
    else:
        spec, rspec = port.PRESETS[name], getattr(ref, name)
    NS = spec.num_states
    rng = np.random.default_rng(W + NS)
    B, L = 3, 50
    x = _inputs(spec, rng, B, 2 * L, soft)
    m0 = rng.integers(0, 300, (B, NS)).astype(np.int32)
    r0 = rng.integers(0, 2 ** 63, (B, NS), dtype=np.uint64)
    r0 &= np.uint64((1 << W) - 1 if W < 64 else 2 ** 64 - 1)
    state = kstream.StreamState(torch.from_numpy(m0),
                                torch.from_numpy(r0.view(np.int64)))
    got = _model(spec, x, soft, W, m0, r0)
    want = _plain(spec, x, soft, W, state)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    # Cut at L: the second call from the first one's state.
    first = _model(spec, x[:, :L], soft, W, m0, r0)
    second = _model(spec, x[:, L:], soft, W, first[1], first[2])
    np.testing.assert_array_equal(
        np.concatenate([first[0], second[0]], 1), got[0])
    np.testing.assert_array_equal(second[1], got[1])
    np.testing.assert_array_equal(second[2], got[2])
    if W != 35:
        return
    chunk = (ref_streaming.decode_chunk_soft if soft
             else ref_streaming.decode_chunk)
    xin = np.maximum(x.astype(np.int32), -127) if soft else x
    st = ref_streaming.DecoderState(jnp.asarray(m0), jnp.asarray(
        _to_symbols(r0, W)), jnp.zeros(B, jnp.int32))
    run = jax.vmap(lambda s, c: chunk(rspec, s, c, W))
    syms = []
    for part in (xin[:, :L], xin[:, L:]):
        st, sym, _ = run(st, part)
        syms.append(np.asarray(sym))
    np.testing.assert_array_equal(np.concatenate(syms, 1), got[0])
    m = np.asarray(st.metrics)
    np.testing.assert_array_equal(m - m.min(1, keepdims=True), got[1])
    np.testing.assert_array_equal(np.asarray(st.registers),
                                  _to_symbols(got[2], W))


def test_stream_model_short_calls():
    """Calls shorter than W (T = 0, 1, 5) and one of a block and a step
    (T = 33) from a carried state at W = 35 and 64: the model equals the
    port's scan."""
    spec = port.NASA_K7
    rng = np.random.default_rng(7)
    for W in (35, 64):
        for T in (0, 1, 5, 33):
            for soft in (False, True):
                x = _inputs(spec, rng, 2, T, soft)
                m0 = rng.integers(0, 300, (2, 64)).astype(np.int32)
                r0 = rng.integers(0, 2 ** 63, (2, 64), dtype=np.uint64)
                r0 &= np.uint64((1 << W) - 1 if W < 64 else 2 ** 64 - 1)
                state = kstream.StreamState(
                    torch.from_numpy(m0), torch.from_numpy(r0.view(np.int64)))
                got = _model(spec, x, soft, W, m0, r0)
                want = _plain(spec, x, soft, W, state)
                for a, b in zip(got, want):
                    np.testing.assert_array_equal(a, b)
