"""The port's LTE turbo chain (ops/lte.py) against the JAX package's,
exactly, on the same numpy-made inputs: tail multiplexing, the turbo
rate-matching maps, segmentation, DL-SCH, and the one-call encode and
decode.  One interpreted call of the JAX early-exit decoder (its Pallas
kernels) holds the port's early exit to it; everything else is held to the
JAX scans, which the JAX package's own tests hold to those kernels."""

import numpy as np
import pytest
import torch

from convolutionalencdec_tpu.ops import lte as ref
from convolutionalencdec_tpu.ops import turbo as ref_turbo
from convolutionalencdec_tpu.ops.crc import CRC24B as REF_CRC24B
from convolutionalencdec_tpu.ops.crc import crc_append as ref_crc_append

from convolutionalencdec_tpu_torch.ops import lte as pl

KEYS = ("sys", "par1", "par2", "sys_tail1", "par_tail1", "sys_tail2",
        "par_tail2")


def _to_np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_constants_and_qpp():
    assert pl.LTE_BLOCK_SIZES == ref.LTE_BLOCK_SIZES
    assert pl.Z_MAX == ref.Z_MAX
    assert pl.TURBO_SUBBLOCK_PERM == ref.TURBO_SUBBLOCK_PERM
    pi = pl.lte_qpp(1024)
    pi[0] = 99                                   # a fresh copy each call
    np.testing.assert_array_equal(pl.lte_qpp(1024), ref.lte_qpp(1024))
    with pytest.raises(ValueError, match="LTE turbo block size"):
        pl.lte_qpp(1000)


@pytest.mark.parametrize("batch", [False, True])
def test_mux_and_demux_match_reference(batch):
    rng = np.random.default_rng(3)
    L = 48
    shape = (3, L) if batch else (L,)
    bits = rng.integers(0, 2, shape, dtype=np.uint8)
    perm = ref.lte_qpp(L)
    enc = (ref_turbo.turbo_encode_batch_np if batch
           else ref_turbo.turbo_encode_np)(ref_turbo.RscSpec(), bits, perm)
    want = ref.turbo_mux_streams(enc)
    got_np = pl.turbo_mux_streams(enc)
    got_t = pl.turbo_mux_streams({k: torch.from_numpy(v)
                                  for k, v in enc.items()})
    np.testing.assert_array_equal(got_np, want)
    np.testing.assert_array_equal(got_t.numpy(), want)
    soft = (1 - 2 * want.astype(np.int32)) * rng.integers(1, 9, want.shape)
    for got, ref_f in zip(pl.turbo_demux_tails(torch.from_numpy(soft)),
                          ref.turbo_demux_tails(soft)):
        np.testing.assert_array_equal(got.numpy(), ref_f)
    for got, key in zip(pl.turbo_demux_tails(want), KEYS):
        np.testing.assert_array_equal(got, enc[key])


@pytest.mark.parametrize("D", [44, 108, 1028])
def test_ratematch_maps_match_reference(D):
    for F in (0, 20):
        np.testing.assert_array_equal(pl._turbo_w_map(D, F),
                                      ref._turbo_w_map(D, F))
    for rv in range(4):
        for Ncb in (None, 2 * D):
            for F, E in ((0, 3 * D - 17), (20, 4 * D + 5)):
                np.testing.assert_array_equal(
                    pl.turbo_ratematch_indices(D, E, rv, Ncb, F),
                    ref.turbo_ratematch_indices(D, E, rv, Ncb, F))


@pytest.mark.parametrize("E_of_D", [lambda D: 2 * D, lambda D: 4 * D + 3],
                         ids=["punctured", "repeated"])
def test_rate_match_and_derate_match_reference(E_of_D):
    rng = np.random.default_rng(11)
    D, F = 108, 20
    E = E_of_D(D)
    for rv in (0, 2):
        d = rng.integers(0, 2, (3, 3, D), dtype=np.uint8)
        np.testing.assert_array_equal(
            pl.rate_match_turbo(torch.from_numpy(d), E, rv, F=F).numpy(),
            np.asarray(ref.rate_match_turbo(d, E, rv, F=F)))
        llrs = rng.integers(-31, 32, (3, E)).astype(np.int32)
        for qmax, filler in ((None, 0), (15, 15)):
            got = pl.derate_match_turbo(torch.from_numpy(llrs), D, rv, F=F,
                                        qmax=qmax, filler_llr=filler)
            want = ref.derate_match_turbo(llrs, D, rv, F=F, qmax=qmax,
                                          filler_llr=filler)
            assert got.dtype == torch.int32 and got.shape == (3, 3, D)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_segmentation_matches_reference():
    sizes = list(range(1, 200, 7)) + [6143, 6144, 6145, 6200, 12288,
                                      20000, 30000, 61440, 75376]
    sizes += list(ref.LTE_BLOCK_SIZES[::9])
    for B in sizes:
        assert pl.segment_sizes(B) == ref.segment_sizes(B), B
        assert pl._segment_layout(B) == ref._segment_layout(B), B
        assert pl.dlsch_block_sizes(B) == ref.dlsch_block_sizes(B), B
    with pytest.raises(ValueError):
        pl.segment_sizes(0)
    for G, C in ((9000, 2), (18840, 3), (1000, 1)):
        assert pl.dlsch_rate_match_sizes(G, C) == ref.dlsch_rate_match_sizes(
            G, C)
    with pytest.raises(ValueError):
        pl.dlsch_rate_match_sizes(1001, 2)
    rng = np.random.default_rng(2)
    for B in (100, 6200, 13000):
        bits = rng.integers(0, 2, B, dtype=np.uint8)
        got, F = pl.segment_tb(bits)
        want, F_ref = ref.segment_tb(bits)
        assert F == F_ref and len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(pl.desegment_tb(got, F), bits)


def test_encoders_match_reference():
    rng = np.random.default_rng(9)
    L, E = 104, 3 * (104 + 4) - 40
    bits = rng.integers(0, 2, (3, L), dtype=np.uint8)
    for rv, F in ((0, 0), (1, 20)):
        np.testing.assert_array_equal(
            pl.lte_turbo_encode(bits[0], E, rv, F=F),
            ref.lte_turbo_encode(bits[0], E, rv, F=F))
    got = pl.lte_turbo_encode_batch(torch.from_numpy(bits), E)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        ref.lte_turbo_encode_batch(bits, E)))


def _channel(rng, msgs, E, flip, mag=8):
    tx = np.asarray(ref.lte_turbo_encode_batch(msgs, E))
    q = (1 - 2 * tx.astype(np.int32)) * rng.integers(1, mag + 1, tx.shape)
    return np.where(rng.random(q.shape) < flip, -q, q).astype(np.int32)


@pytest.mark.parametrize("L", [40, 104])
def test_lte_turbo_decode_matches_reference(L):
    """Both routes on CPU tensors (the kernel's plain version and the
    plain exchange) against the JAX scan decoder, batched and 1-D."""
    rng = np.random.default_rng(L)
    msgs = rng.integers(0, 2, (5, L), dtype=np.uint8)
    q = _channel(rng, msgs, 3 * (L + 4) - 8, 0.12)
    wb, wl = ref.lte_turbo_decode(q, L, n_iters=3)
    for use_kernel in (None, False):
        gb, gl = pl.lte_turbo_decode(torch.from_numpy(q), L, n_iters=3,
                                     use_kernel=use_kernel)
        np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
        np.testing.assert_array_equal(gb.numpy(), np.asarray(wb))
    one_b, one_l = pl.lte_turbo_decode(torch.from_numpy(q[2]), L, n_iters=3)
    assert one_b.shape == (L,)
    np.testing.assert_array_equal(one_l.numpy(), np.asarray(wl)[2])


def test_lte_turbo_decode_early_matches_reference_kernels():
    """One interpreted call of the JAX early-exit chain (its Pallas MAP
    kernels): rows 0-3 clean, rows 4-7 with 12% of the LLRs flipped; bits,
    LLRs, CRC verdicts and the iteration count equal, both routes, and
    no false accept."""
    rng = np.random.default_rng(41)
    B, L = 8, 40
    payload = rng.integers(0, 2, (B, L - 24), dtype=np.uint8)
    msgs = np.array(ref_crc_append(REF_CRC24B, payload))
    E = 3 * (L + 4)
    tx = np.asarray(ref.lte_turbo_encode_batch(msgs, E))
    q = ((1 - 2 * tx.astype(np.int32)) * 8).astype(np.int32)
    flip = rng.random(q.shape) < 0.12
    flip[:4] = False
    q = np.where(flip, -q, q)
    want = ref.lte_turbo_decode_early(q, L, max_iters=4, interpret=True)
    for use_kernel in (None, False):
        got = pl.lte_turbo_decode_early(torch.from_numpy(q), L, max_iters=4,
                                        use_kernel=use_kernel)
        for g, w in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(_to_np(g), np.asarray(w))
        assert got[3] == int(want[3])
    bits, _, ok, _ = got
    assert ok[:4].all()
    assert not (ok & (bits != torch.from_numpy(msgs)).any(1)).any()
    one = pl.lte_turbo_decode_early(torch.from_numpy(q[0]), L)
    assert one[0].shape == (L,) and bool(one[2]) and one[3] == 1


def test_dlsch_two_block_transport_block_matches_reference():
    """A = 6180: two code blocks of 3136, 20 fillers in the first."""
    rng = np.random.default_rng(17)
    A, G = 6180, 2 * 3 * (3136 + 4)
    assert pl.dlsch_block_sizes(A) == ([3136, 3136], 20)
    payload = rng.integers(0, 2, A, dtype=np.uint8)
    tx = pl.lte_dlsch_encode(payload, G, device="cpu")
    np.testing.assert_array_equal(tx.numpy(), np.asarray(
        ref.lte_dlsch_encode(payload, G)))
    q = (1 - 2 * tx.numpy().astype(np.int32)) * rng.integers(1, 9, G)
    q = np.where(rng.random(G) < 0.05, -q, q).astype(np.int32)
    want = ref.lte_dlsch_decode(q, A, n_iters=2)
    got = pl.lte_dlsch_decode(torch.from_numpy(q), A, n_iters=2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert bool(got[1]) and np.array_equal(got[0].numpy(), payload)
