"""The port's turbo code (ops/turbo.py, kernels/turbo.py) against the JAX
package's, exactly, on the same numpy-made inputs: the RSC spec and its
tables, the QPP maps, the encode operator and the encoders, the
constituent MAP scan and the exchange.  The kernel entries run on CPU
tensors (their plain route); the JAX Pallas kernels are held to the same
scans by the JAX package's own tests."""

import dataclasses
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from convolutionalencdec_tpu.ops import turbo as ref

from convolutionalencdec_tpu_torch.kernels import turbo as kt
from convolutionalencdec_tpu_torch.ops import turbo as pt

RSC_ARGS = [dict(), dict(K=5, g_fb=0o23, g_fw=0o35),
            dict(K=3, g_fb=0o7, g_fw=0o5)]
RSC_IDS = ["lte", "K5", "K3"]
LTE = pt.RscSpec()
REF_LTE = ref.RscSpec()


def _vmap_map(*fields):
    return np.asarray(jax.vmap(lambda *x: ref.rsc_maxlogmap(REF_LTE, *x))(
        *fields))


def _fields(rng, B, L, S, apriori):
    def draw(mag, shape):
        return rng.integers(-mag, mag + 1, shape).astype(np.int32)
    return [draw(31, (B, L)), draw(31, (B, L)), draw(apriori, (B, L)),
            draw(31, (B, S)), draw(31, (B, S))]


@pytest.mark.parametrize("kwargs", RSC_ARGS, ids=RSC_IDS)
def test_rsc_spec_and_tables_match_reference(kwargs):
    r, p = ref.RscSpec(**kwargs), pt.RscSpec(**kwargs)
    assert dataclasses.asdict(r) == dataclasses.asdict(p)
    assert (p.S, p.num_states) == (r.S, r.num_states)
    assert pt.RscSpec.from_reference(r) == p
    for got, want in zip(pt.rsc_tables(p), ref.rsc_tables(r)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    for s in range(p.num_states):
        assert pt.rsc_tail_input(p, s) == ref.rsc_tail_input(r, s)
        for u in (0, 1):
            assert pt.rsc_step(p, s, u) == ref.rsc_step(r, s, u)
    np.testing.assert_array_equal(pt._rsc_impulse(p, 50),
                                  ref._rsc_impulse(r, 50))


@pytest.mark.parametrize("kwargs", [dict(g_fb=0o3), dict(g_fw=0o25)],
                         ids=["no_input_tap", "too_wide"])
def test_rsc_spec_validation_matches_reference(kwargs):
    with pytest.raises(ValueError):
        ref.RscSpec(**kwargs)
    with pytest.raises(ValueError):
        pt.RscSpec(**kwargs)


def test_all_qpp_maps_match_reference():
    assert pt.QPP_TABLE == ref.QPP_TABLE and len(pt.QPP_TABLE) == 188
    for L in pt.QPP_TABLE:
        np.testing.assert_array_equal(pt.qpp_interleaver(L),
                                      ref.qpp_interleaver(L))
    np.testing.assert_array_equal(pt.qpp_interleaver(40, 3, 10),
                                  ref.qpp_interleaver(40, 3, 10))
    for args in ((41,), (40, 2, 10)):       # not a table size; not a QPP
        with pytest.raises(ValueError):
            ref.qpp_interleaver(*args)
        with pytest.raises(ValueError):
            pt.qpp_interleaver(*args)


@pytest.mark.parametrize("L", [40, 1000, 6144])
def test_encode_operator_matches_reference(L):
    for got, want in zip(pt._rsc_encode_blocks(LTE, L),
                         ref._rsc_encode_blocks(REF_LTE, L)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kwargs", RSC_ARGS, ids=RSC_IDS)
def test_encoders_match_reference(kwargs):
    r, p = ref.RscSpec(**kwargs), pt.RscSpec(**kwargs)
    rng = np.random.default_rng(5)
    L = 104
    bits = rng.integers(0, 2, (4, L), dtype=np.uint8)
    perm = ref.qpp_interleaver(L)
    for got, want in zip(pt.rsc_encode_np(p, bits[0]),
                         ref.rsc_encode_np(r, bits[0])):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(pt.rsc_encode_batch_np(p, bits),
                         ref.rsc_encode_batch_np(r, bits)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(pt.rsc_encode_batch(p, torch.from_numpy(bits)),
                         ref.rsc_encode_batch(r, bits)):
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    enc_np = pt.turbo_encode_np(p, bits[0], perm)
    want_np = ref.turbo_encode_np(r, bits[0], perm)
    enc_b = pt.turbo_encode_batch_np(p, bits, perm)
    want_b = ref.turbo_encode_batch_np(r, bits, perm)
    enc_t = pt.turbo_encode_batch(p, torch.from_numpy(bits), perm)
    want_t = ref.turbo_encode_batch(r, bits, perm)
    assert set(enc_t) == set(want_t) == set(enc_np)
    for key in want_t:
        np.testing.assert_array_equal(enc_np[key], want_np[key])
        np.testing.assert_array_equal(enc_b[key], want_b[key])
        np.testing.assert_array_equal(enc_t[key].numpy(),
                                      np.asarray(want_t[key]))


@pytest.mark.parametrize("L", [6, 24, 37, 47, 61, 136])
def test_rsc_maxlogmap_matches_reference(L):
    """The plain scan and the kernel entry on CPU tensors against the JAX
    scan, a-priori to +-4000."""
    for key in kt.LAUNCHES:
        kt.LAUNCHES[key] = 0
    rng = np.random.default_rng(L)
    fields = _fields(rng, 5, L, LTE.S, 4000)
    want = _vmap_map(*fields)
    tensors = [torch.from_numpy(x) for x in fields]
    np.testing.assert_array_equal(pt.rsc_maxlogmap(LTE, *tensors).numpy(),
                                  want)
    np.testing.assert_array_equal(
        kt.rsc_maxlogmap_batch_kernel(LTE, *tensors).numpy(), want)
    assert not any(kt.LAUNCHES.values())


def test_rsc_maxlogmap_at_the_clamp_contract():
    """A-priori at the full +-LA_CLAMP exchange bound, channel LLRs to
    +-8192: the case behind the kernels' margin arguments."""
    rng = np.random.default_rng(2024)
    B, L = 3, 104
    fields = _fields(rng, B, L, LTE.S, pt.LA_CLAMP)
    for i in (0, 1, 3, 4):
        fields[i] = fields[i] * 264
    fields[2][:, ::7] = pt.LA_CLAMP
    fields[2][:, 3::7] = -pt.LA_CLAMP
    assert pt.LA_CLAMP == ref.LA_CLAMP and pt.BIG == ref.BIG
    got = kt.rsc_maxlogmap_batch_kernel(
        LTE, *(torch.from_numpy(x) for x in fields))
    np.testing.assert_array_equal(got.numpy(), _vmap_map(*fields))


KERNEL_SOURCE = (Path(kt.__file__).resolve().parent.parent / "csrc"
                 / "turbo_rsc.cu")


def _kernel_constant(name: str) -> str:
    """The value of `constexpr ... name = VALUE;` in csrc/turbo_rsc.cu."""
    return re.search(rf"constexpr \w+ {name} = (\w+);",
                     KERNEL_SOURCE.read_text()).group(1)


def _schedule_model(rsc, l_sys, l_par, l_apriori, l_sys_tail, l_par_tail,
                    R):
    """A numpy model of `turbo_rsc_map`'s schedule (csrc/turbo_rsc.cu), in
    np.int32: the alpha walk and the beta walk (after its S tail steps) go
    in rounds of 32 steps from both ends, alpha on chunk k and beta on
    chunk 2m - 1 - k in round k (nC = ceil(L / 32) chunks, m = ceil(nC /
    2), a chunk >= nC idle); steps past L hold.  Rounds k < m - 1 store the
    walk's metric at the chunk's start (a checkpoint); round m - 1 hands
    each step's metric (x before the step) to the other walk's slot 31 - j
    of its chunk.  Rounds k >= m emit, reading the other recursion's slot
    j at step j: alpha by destination (w_u over the edges into a state with
    input u), beta by source, the NS-way minima taken over the states.
    Their slots come from the hand-over (round m) or from a helper's replay
    of the other recursion over the chunk from its checkpoint, without
    renormalisation (the kernel's helper replays it a round ahead).  Every
    R steps (j % R == R - 1) a walk takes its least metric and subtracts it
    at j % R == R / 2 - 1.  Asserts the note's margin: the walks' finite
    metrics in [-(3R/2) mb, (3R/2 + 2S) mb], a replay's within 32 mb more,
    excluded ones (alpha's first S steps) within S mb of BIG.  Returns
    int32 [B, L]."""
    nxt, par, prev, pu = pt.rsc_tables(rsc)
    zp = par[pu, prev]
    B, L = l_sys.shape
    S, NS = rsc.S, rsc.num_states
    lu = (l_sys + l_apriori).astype(np.int32)
    lp = l_par.astype(np.int32)
    mb = int(np.abs(np.concatenate([lu, l_sys_tail], 1)).max()
             + np.abs(np.concatenate([lp, l_par_tail], 1)).max())
    big, inf = np.int32(pt.BIG), np.iinfo(np.int32).max
    nC = -(-L // 32)
    m = -(-nC // 2)
    slots = np.zeros((B, nC, 32, NS), np.int32)   # the hand-over
    ckpt = np.zeros((B, nC, NS), np.int32)
    lapp = np.zeros((B, L), np.int32)

    def edge_sums(d, x, u_t, p_t):
        u_t, p_t = u_t[:, None], p_t[:, None]
        if d > 0:
            return [x[:, prev[e]] + pu[e] * u_t + zp[e] * p_t
                    for e in (0, 1)]
        return [x[:, nxt[u]] + u * u_t + par[u] * p_t for u in (0, 1)]

    def check(x, slack=0):
        fin = x < big // 2
        lo = -(3 * R // 2 + slack) * mb
        hi = (3 * R // 2 + 2 * S + slack) * mb
        assert lo <= x[fin].min(initial=0) and x[fin].max(initial=0) <= hi
        assert (np.abs(x[~fin].astype(np.int64) - pt.BIG) <= S * mb).all()

    def step_of(d, c, j):
        return 32 * c + (j if d > 0 else 31 - j)

    def replay(d, c):
        """Recursion d over chunk c from its checkpoint: its slots."""
        x, out = ckpt[:, c].copy(), np.zeros((B, 32, NS), np.int32)
        for j in range(32):
            t = step_of(d, c, j)
            out[:, 31 - j] = x
            if t < L:
                x = np.minimum(*edge_sums(d, x, lu[:, t], lp[:, t]))
            check(x, slack=32)
        return out

    x, pend = {}, {}
    for d in (1, -1):
        x[d] = np.full((B, NS), big, np.int32)
        x[d][:, 0] = 0
        pend[d] = np.zeros((B, 1), np.int32)
    for t in range(S - 1, -1, -1):
        x[-1] = np.minimum(*edge_sums(-1, x[-1], l_sys_tail[:, t],
                                      l_par_tail[:, t]))
    for k in range(2 * m):
        for d in (1, -1):
            c = k if d > 0 else 2 * m - 1 - k
            if c >= nC:
                continue
            if k < m - 1:
                ckpt[:, c] = x[d]
            if k >= m:
                other = slots[:, c] if k == m else replay(-d, c)
            for j in range(32):
                t = step_of(d, c, j)
                if t < L:
                    c0, c1 = edge_sums(d, x[d], lu[:, t], lp[:, t])
                    if k == m - 1:
                        slots[:, c, 31 - j] = x[d]
                    elif k >= m:
                        o = other[:, j]
                        v0, v1 = c0 + o, c1 + o
                        if d > 0:
                            w0 = np.minimum(np.where(pu[0] == 0, v0, inf),
                                            np.where(pu[1] == 0, v1, inf))
                            w1 = np.minimum(np.where(pu[0] == 1, v0, inf),
                                            np.where(pu[1] == 1, v1, inf))
                        else:
                            w0, w1 = v0, v1
                        lapp[:, t] = w1.min(1) - w0.min(1)
                    x[d] = np.minimum(c0, c1)
                if j % R == R // 2 - 1:
                    x[d] = x[d] - pend[d]
                if j % R == R - 1:
                    pend[d] = x[d].min(1, keepdims=True)
                check(x[d])
    return lapp


# The kernel's state counts: NS = 8 (LTE), 4, 2, and an 8-state code whose
# two edges into a state carry the same input (no D^S feedback tap: the
# kernel's emit without the swap).
MODEL_CODES = {"NS8": dict(), "NS4": dict(K=3, g_fb=0o7, g_fw=0o5),
               "NS2": dict(K=2, g_fb=0o3, g_fw=0o2),
               "NS8_same_u": dict(K=4, g_fb=0o12, g_fw=0o15)}
MODEL_LENGTHS = (1, 6, 7, 8, 9, 40, 47, 61, 136, 1024, "clamp")
MODEL_CASES = [(code, L) for code in ("NS8", "NS4", "NS2")
               for L in MODEL_LENGTHS] + [
    ("NS8_same_u", L) for L in (9, 47, 1024, "clamp")]


@pytest.mark.parametrize("code, L", MODEL_CASES,
                         ids=[f"{c}-{L}" for c, L in MODEL_CASES])
def test_schedule_model_matches_reference(code, L):
    """The numpy model of the kernel's schedule, at the kernel's
    renormalisation period, against the JAX scan and the port's; L lands
    the meeting point on and off a chunk edge, and "clamp" is the
    LA_CLAMP contract case."""
    kwargs = MODEL_CODES[code]
    r, p = ref.RscSpec(**kwargs), pt.RscSpec(**kwargs)
    if L == "clamp":
        fields = _fields(np.random.default_rng(2024), 3, 104, p.S,
                         pt.LA_CLAMP)
        for i in (0, 1, 3, 4):
            fields[i] = fields[i] * 264
        fields[2][:, ::7] = pt.LA_CLAMP
        fields[2][:, 3::7] = -pt.LA_CLAMP
    else:
        fields = _fields(np.random.default_rng(L + p.S), 3, L, p.S, 4000)
    want = np.asarray(jax.vmap(lambda *x: ref.rsc_maxlogmap(r, *x))(*fields))
    np.testing.assert_array_equal(
        pt.rsc_maxlogmap(p, *(torch.from_numpy(x) for x in fields)).numpy(),
        want)
    R = int(_kernel_constant("kRenorm"))
    np.testing.assert_array_equal(_schedule_model(p, *fields, R), want)


def _noisy_fields(rng, B, L, flip):
    """LLRs of magnitude 1..7 of a random turbo codeword, `flip` of them
    with the wrong sign."""
    perm = ref.qpp_interleaver(L)
    bits = rng.integers(0, 2, (B, L), dtype=np.uint8)
    enc = ref.turbo_encode_batch_np(REF_LTE, bits, perm)
    out = []
    for key in ("sys", "par1", "par2", "sys_tail1", "par_tail1",
                "sys_tail2", "par_tail2"):
        x = ((1 - 2 * enc[key].astype(np.int32))
             * rng.integers(1, 8, enc[key].shape))
        out.append(np.where(rng.random(x.shape) < flip, -x, x)
                   .astype(np.int32))
    return out, perm, bits


def test_exchange_floor_division():
    """clip(floor(3 le / 4)) on negative odd extrinsics: the JAX `//`."""
    le = torch.tensor([-7, -5, -3, -1, 0, 1, 3, 5, -(1 << 20), 1 << 20],
                      dtype=torch.int32)
    want = np.clip((3 * le.numpy()) // 4, -ref.LA_CLAMP, ref.LA_CLAMP)
    np.testing.assert_array_equal(pt._scaled_apriori(le).numpy(), want)
    assert pt._scaled_apriori(le)[0] == -6      # -21 / 4 floors to -6


def test_turbo_decode_batch_matches_reference():
    """Three iterations at 15% flips: the exchange rounds negative odd
    extrinsics (pinned below), so a truncating division would differ."""
    rng = np.random.default_rng(7)
    fields, perm, _ = _noisy_fields(rng, 4, 40, 0.15)
    l_sys, l_par1, _, st1, pt1 = (torch.from_numpy(x) for x in fields[:5])
    le1 = pt.rsc_maxlogmap(LTE, l_sys, l_par1, torch.zeros_like(l_sys), st1,
                           pt1) - l_sys
    assert ((le1 < 0) & (le1 % 4 != 0)).any()
    wb, wl = ref.turbo_decode_batch(REF_LTE, *fields, perm=perm, n_iters=3)
    tensors = [torch.from_numpy(x) for x in fields]
    gb, gl = pt.turbo_decode_batch(LTE, *tensors, perm=perm, n_iters=3)
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    np.testing.assert_array_equal(gb.numpy(), np.asarray(wb))
    kb, kl = kt.turbo_decode_batch_kernel(LTE, *tensors, perm=perm,
                                          n_iters=3)
    assert torch.equal(kb, gb) and torch.equal(kl, gl)
    one_b, one_l = pt.turbo_decode(LTE, *(t[1] for t in tensors), perm=perm,
                                   n_iters=3)
    rb, rl = ref.turbo_decode(REF_LTE, *(x[1] for x in fields),
                              perm=tuple(int(p) for p in perm), n_iters=3)
    np.testing.assert_array_equal(one_l.numpy(), np.asarray(rl))
    np.testing.assert_array_equal(one_b.numpy(), np.asarray(rb))


def test_early_kernel_entry_on_cpu_latches():
    """The early entry on CPU tensors: a clean batch stops after one
    iteration; a noisy one never false-accepts and returns its latched
    bits; zero iterations return zeros."""
    from convolutionalencdec_tpu_torch.ops.crc import CRC24B, crc_append
    rng = np.random.default_rng(41)
    B, L = 6, 40
    perm = ref.qpp_interleaver(L)
    msgs = crc_append(CRC24B, torch.from_numpy(
        rng.integers(0, 2, (B, L - 24), dtype=np.uint8)))
    enc = pt.turbo_encode_batch(LTE, msgs, perm)
    keys = ("sys", "par1", "par2", "sys_tail1", "par_tail1", "sys_tail2",
            "par_tail2")
    clean = [(1 - 2 * enc[k].to(torch.int32)) * 8 for k in keys]
    bits, lapp, ok, iters = kt.turbo_decode_batch_kernel_early(
        LTE, *clean, perm=perm, crc=CRC24B)
    assert iters == 1 and bool(ok.all()) and torch.equal(bits, msgs)
    noisy = [torch.where(torch.from_numpy(rng.random(x.shape) < 0.2), -x, x)
             for x in clean]
    bits, lapp, ok, iters = kt.turbo_decode_batch_kernel_early(
        LTE, *noisy, perm=perm, crc=CRC24B, max_iters=3)
    assert 1 <= iters <= 3
    assert not (ok & (bits != msgs).any(1)).any()
    fixed_b, fixed_l = kt.turbo_decode_batch_kernel(LTE, *noisy, perm=perm,
                                                    n_iters=iters)
    assert torch.equal(bits[~ok], fixed_b[~ok])
    assert torch.equal(lapp[~ok], fixed_l[~ok])
    bits, lapp, ok, iters = kt.turbo_decode_batch_kernel_early(
        LTE, *noisy, perm=perm, crc=CRC24B, max_iters=0)
    assert iters == 0 and not bits.any() and not lapp.any() and not ok.any()


def test_kernel_entry_errors():
    k5 = pt.RscSpec(K=5, g_fb=0o23, g_fw=0o35)
    assert kt.turbo_kernel_supported(LTE) and not kt.turbo_kernel_supported(k5)
    z = torch.zeros((1, 8), dtype=torch.int32)
    zt = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="NS <= 8"):
        kt.rsc_maxlogmap_batch_kernel(k5, z, z, z, zt, zt)
    with pytest.raises(ValueError, match="CrcSpec"):
        kt.turbo_decode_batch_kernel_early(
            LTE, z, z, z, zt[:, :3], zt[:, :3], zt[:, :3], zt[:, :3],
            perm=np.arange(8))
    with pytest.raises(ValueError, match="tails"):
        kt.rsc_maxlogmap_batch_kernel(LTE, z, z, z, zt, zt)
    with pytest.raises(ValueError, match="interleaver"):
        pt.turbo_decode_batch(LTE, z, z, z, zt[:, :3], zt[:, :3], zt[:, :3],
                              zt[:, :3], perm=np.arange(7))
