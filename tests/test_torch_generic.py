"""The port's generic-k block decode on the CPU: any rate-k/n code, and the
asymmetric k = 1 ones, through `viterbi_decode_batch(_bytes)`,
`viterbi_decode_batch_generic` and `viterbi_decode_batch_k2`.

A CPU tensor takes each wrapper's plain version (the CUDA kernels run only
on the card, where chip_smoke.py holds them to these plain versions).  Here
the entries are held bit for bit against `jax.vmap(viterbi_decode)` of the
JAX package, and once each against its generic-k kernel (K9) and its k = 2
kernel (K10) in interpret mode.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

import convolutionalencdec_tpu as ref
from convolutionalencdec_tpu.kernels.acs_k2 import (
    viterbi_decode_batch_k2 as ref_decode_k2)
from convolutionalencdec_tpu.kernels.acs_pallas import (
    viterbi_decode_batch_generic as ref_decode_generic)

import convolutionalencdec_tpu_torch as port
from convolutionalencdec_tpu_torch import kernels
from convolutionalencdec_tpu_torch.kernels import generic
from convolutionalencdec_tpu_torch.ops.trellis import edge_coded_bits

# TOY_K3 is a preset; the others by their CodeSpec arguments: a K=3 k=2 code
# (NS = 16), the main path's codes on the card (chip_smoke.py GENERIC_MAIN:
# punctured rate-1/2 codes written as rate-k/n trellises, see
# test_main_path_codes_are_punctured_mother_codes), an asymmetric K=7 code,
# and the k = 2, NS = 64 code of the JAX package's own K10 test and
# generic-k sizing (scripts/generic_k_pricing.py).
CODES = {
    "TOY_K3": None,
    "K3k2": dict(K=3, k=2, g=(0o17, 0o06, 0o13)),
    "k2_NS64": dict(K=4, k=2, g=(0o133, 0o171, 0o266)),
    "k2_NS256": dict(K=5, k=2, g=(0o561, 0o753, 0o1342)),
    "k3_NS64": dict(K=3, k=3, g=(0o133, 0o171, 0o266, 0o744)),
    "K7_134_171": dict(K=7, g=(0o134, 0o171)),
    "k2_NS64_pricing": dict(K=4, k=2, g=(0o64, 0o52, 0o71)),
}
ENTRY_CODES = ["TOY_K3", "K3k2", "k2_NS64", "k2_NS256", "k3_NS64",
               "K7_134_171"]
B, SYMBOLS = 6, 60


def _specs(name):
    if CODES[name] is None:
        return getattr(ref, name), port.PRESETS[name]
    return ref.CodeSpec(**CODES[name]), port.CodeSpec(**CODES[name])


def _segments(spec, kind, B, symbols, seed):
    """uint8 [B, T] segments: encoded and hit at 10% by nonzero XOR masks,
    or uniform garbage (tie-heavy)."""
    rng = np.random.default_rng(seed)
    msgs = rng.integers(0, 2, (B, symbols * spec.k), dtype=np.uint8)
    coded = port.encode_bits(spec, torch.from_numpy(msgs))[0].numpy().copy()
    if kind == "garbage":
        return rng.integers(0, 1 << spec.n, coded.shape).astype(np.uint8)
    hit = rng.random(coded.shape) < 0.1
    return coded ^ (hit * rng.integers(1, 1 << spec.n, coded.shape)).astype(
        np.uint8)


def _cut(full):
    """A message length below `full` and not a multiple of 8."""
    cut = full - 13
    return cut - 1 if cut % 8 == 0 else cut


@pytest.mark.parametrize("kind", ["noisy", "garbage"])
@pytest.mark.parametrize("name", ENTRY_CODES)
def test_entries_match_vmapped_scan(name, kind):
    ref_spec, spec = _specs(name)
    coded = _segments(spec, kind, B, SYMBOLS, 3 + ENTRY_CODES.index(name))
    seg = torch.from_numpy(coded)
    want = np.asarray(jax.vmap(lambda c: ref.viterbi_decode(ref_spec, c))(
        coded))
    full = want.shape[1]
    assert full == (coded.shape[1] - spec.S) * spec.k
    entries = [kernels.viterbi_decode_batch,
               kernels.viterbi_decode_batch_generic]
    if generic.k2_supported(spec):
        entries.append(kernels.viterbi_decode_batch_k2)
    for entry in entries:
        np.testing.assert_array_equal(entry(spec, seg).numpy(), want)
        np.testing.assert_array_equal(entry(spec, seg, _cut(full)).numpy(),
                                      want[:, :_cut(full)])
    for mb in (full, _cut(full)):
        want_bytes = np.asarray(jax.vmap(
            lambda c: ref.viterbi_decode_bytes(ref_spec, c, mb))(coded))
        np.testing.assert_array_equal(
            kernels.viterbi_decode_batch_bytes(spec, seg, mb).numpy(),
            want_bytes)


def test_interpreted_generic_kernel_matches():
    """One interpret-mode call of the JAX generic-k kernels (K9)."""
    ref_spec, spec = _specs("K3k2")
    coded = _segments(spec, "noisy", 4, 30, 41)
    want = np.asarray(ref_decode_generic(ref_spec, coded, None, True))
    seg = torch.from_numpy(coded)
    np.testing.assert_array_equal(
        kernels.viterbi_decode_batch_generic(spec, seg).numpy(), want)
    np.testing.assert_array_equal(
        kernels.viterbi_decode_batch(spec, seg).numpy(), want)


def test_interpreted_k2_kernel_matches():
    """One interpret-mode call of the JAX k = 2 kernels (K10), on garbage:
    the nested min's tie order against the lowest-e rule."""
    ref_spec, spec = _specs("k2_NS64")
    coded = _segments(spec, "garbage", 2, 20, 43)
    want = np.asarray(ref_decode_k2(ref_spec, coded, None, True))
    seg = torch.from_numpy(coded)
    np.testing.assert_array_equal(
        kernels.viterbi_decode_batch_k2(spec, seg).numpy(), want)
    np.testing.assert_array_equal(
        kernels.viterbi_decode_batch_bytes(spec, seg).numpy(),
        np.packbits(want, axis=1))


@pytest.mark.parametrize("name, mother, pattern", [
    ("k2_NS64", "NASA_K7", "PUNCTURE_2_3"),      # IEEE 802.11a rate 2/3
    ("k2_NS256", "K9_561_753", "PUNCTURE_2_3"),
    ("k3_NS64", "NASA_K7", "PUNCTURE_3_4"),      # IEEE 802.11a rate 3/4
])
def test_main_path_codes_are_punctured_mother_codes(name, mother, pattern):
    """Each main-path code sends, bit for bit, what its rate-1/2 mother code
    sends through the puncturing pattern of period k: the same code on a
    trellis of k input bits per step."""
    _, spec = _specs(name)
    mother, pattern = port.PRESETS[mother], getattr(port.ops.puncture,
                                                    pattern)
    assert len(pattern[0]) == spec.k and spec.S * spec.k == mother.S
    msgs = torch.from_numpy(np.random.default_rng(53).integers(
        0, 2, (3, 45 * spec.k), dtype=np.uint8))
    seg = port.encode_bits(mother, msgs)[0]
    want = port.puncture_bits(port.segments_to_bits(seg, 2), pattern,
                              seg.shape[1])
    got = port.segments_to_bits(port.encode_bits(spec, msgs)[0], spec.n)
    assert torch.equal(got, want)


ROUND_TRIP_CODES = list(CODES) + ["K11_asymmetric"]


def _port_spec(name):
    if name == "K11_asymmetric":   # NS = 1024, the generic kernel's largest
        return port.CodeSpec(K=11, g=(0o2345, 0o3170))
    return _specs(name)[1]


@pytest.mark.parametrize("name", ROUND_TRIP_CODES)
def test_decision_planes_round_trip_and_layout(name):
    """Bit b of e at state d is bit d % 32 of word d // 32 of plane b; the
    bits past NS are 0 (NS < 32 included)."""
    spec = _port_spec(name)
    NS, k = spec.num_states, spec.k
    W = (NS + 31) // 32
    rng = np.random.default_rng(NS + k)
    dec = torch.from_numpy(rng.integers(0, 1 << k, (3, 5, NS)).astype(
        np.uint8))
    planes = generic.pack_decisions_generic(spec, dec)
    assert planes.dtype == torch.int32 and planes.shape == (3, 5, k, W)
    assert torch.equal(generic.unpack_decisions_generic(spec, planes), dec)
    words = planes.numpy().astype(np.int64) & 0xFFFFFFFF
    bits = (words[..., None] >> np.arange(32)) & 1          # [3, 5, k, W, 32]
    bits = bits.reshape(3, 5, k, W * 32)
    assert not bits[..., NS:].any()
    e = (bits[..., :NS] << np.arange(k)[:, None]).sum(axis=2)
    np.testing.assert_array_equal(e, dec.numpy())


@pytest.mark.parametrize("name", ROUND_TRIP_CODES)
def test_edge_tables_split_every_edge_code(name):
    """The kernels' NS + 2^k table bytes give every edge's coded segment:
    code(src = (d >> k) | e << (S-1)k, u = d & (2^k - 1)) = seg_d[d] ^
    seg_e[e]."""
    spec = _port_spec(name)
    seg_d, seg_e = generic.edge_tables(spec)
    ec = edge_coded_bits(spec)
    E, k = spec.num_edges_per_state, spec.k
    d = np.arange(spec.num_states)[None, :]
    e = np.arange(E)[:, None]
    src = (d >> k) | (e << ((spec.S - 1) * k))
    np.testing.assert_array_equal(ec[d & (E - 1), src],
                                  seg_d[None, :] ^ seg_e[:, None])


def test_select_kernel_generic_routes():
    """The JAX dispatch order: k = 2, NS = 64 to K2 first, then the generic
    kernels; codes past both and soft decodes of the rest stay GENERIC;
    butterfly codes, K5_23_35 included, ride the butterfly kernels."""
    assert kernels.select_kernel(_specs("K3k2")[1]) == kernels.GENERIC_K
    assert kernels.select_kernel(_specs("k2_NS64")[1]) == kernels.K2
    assert kernels.select_kernel(_specs("k2_NS64_pricing")[1]) == kernels.K2
    for name in ("TOY_K3", "k2_NS256", "k3_NS64", "K7_134_171"):
        assert kernels.select_kernel(_specs(name)[1]) == kernels.GENERIC_K
    assert kernels.select_kernel(_port_spec("K11_asymmetric")) == \
        kernels.GENERIC_K
    assert kernels.select_kernel(port.CodeSpec(K=12, g=(0o4345, 0o3170))) \
        == kernels.GENERIC                         # NS = 2048
    assert kernels.select_kernel(port.K5_23_35) == kernels.BUTTERFLY
    assert kernels.select_kernel(port.NASA_K7) == kernels.BUTTERFLY
    assert kernels.select_kernel(port.TOY_K3, "soft") == kernels.GENERIC


def test_k2_wrappers_reject_other_codes():
    _, spec = _specs("K3k2")
    seg = torch.zeros((2, 12), dtype=torch.uint8)
    planes, _ = generic.acs_forward_batch_generic(spec, seg)
    for call in (lambda: generic.acs_forward_batch_k2(spec, seg),
                 lambda: generic.acs_forward_batch_k2_plain(spec, seg),
                 lambda: generic.traceback_batch_k2(spec, planes, 12, 8),
                 lambda: generic.traceback_batch_k2_plain(spec, planes, 12,
                                                          8),
                 lambda: kernels.viterbi_decode_batch_k2(spec, seg),
                 lambda: kernels.viterbi_decode_batch_k2(port.TOY_K3, seg)):
        with pytest.raises(ValueError, match="k = 2 and 64 states"):
            call()


@pytest.mark.parametrize("name", ["TOY_K3", "k2_NS64", "k3_NS64"])
def test_wrappers_on_cpu_tensors_take_the_plain_versions(name):
    """Planes and final metrics equal to the scan's, the traceback's bits
    and bytes equal to the reference traceback's; no launch counted."""
    for key in generic.LAUNCHES:
        generic.LAUNCHES[key] = 0
    _, spec = _specs(name)
    seg = torch.from_numpy(_segments(spec, "noisy", 3, 40, 47))
    T = seg.shape[1]
    dec, fm = port.viterbi_forward(spec, port.ops.hard_step_metrics(spec,
                                                                    seg))
    want_bits = port.traceback_terminated(spec, dec)
    pairs = [(generic.acs_forward_batch_generic,
              generic.traceback_batch_generic)]
    if generic.k2_supported(spec):
        pairs.append((generic.acs_forward_batch_k2,
                      generic.traceback_batch_k2))
    for forward, traceback in pairs:
        planes, got_fm = forward(spec, seg)
        assert torch.equal(generic.unpack_decisions_generic(spec, planes), dec)
        assert torch.equal(got_fm, fm)
        for mb in (want_bits.shape[1], _cut(want_bits.shape[1]), 0):
            assert torch.equal(traceback(spec, planes, T, mb, "bits"),
                               want_bits[:, :mb])
            assert torch.equal(traceback(spec, planes, T, mb, "bytes"),
                               port.ops.viterbi.pad_and_pack(
                                   want_bits[:, :mb]))
    assert not any(generic.LAUNCHES.values())


def test_wrappers_reject_bad_arguments():
    _, spec = _specs("K3k2")
    seg = torch.zeros((2, 12), dtype=torch.uint8)
    planes, _ = generic.acs_forward_batch_generic(spec, seg)
    with pytest.raises(ValueError, match="uint8"):
        generic.acs_forward_batch_generic(spec, seg.to(torch.int32))
    with pytest.raises(ValueError, match="message_bits"):
        generic.traceback_batch_generic(spec, planes, 12, 2 * 10 + 1)
    with pytest.raises(ValueError, match="t_actual"):
        generic.traceback_batch_generic(spec, planes, 13, 8)
    with pytest.raises(ValueError, match="out"):
        generic.traceback_batch_generic(spec, planes, 12, 8, out="words")
    with pytest.raises(ValueError, match="do not match"):
        generic.traceback_batch_generic(_specs("k2_NS256")[1], planes, 12, 8)
    # Butterfly codes are the butterfly kernels'.
    for bfly in (port.NASA_K7, port.K5_23_35):
        with pytest.raises(NotImplementedError, match="butterfly kernels"):
            generic.acs_forward_batch_generic(bfly, seg)


# --- The forward kernel's schedule, modelled in numpy -------------------------

def _forward_shapes():
    """(k, log2 NS, log2 lanes a channel) of each case of the dispatch
    switch in csrc/acs_generic.cu (`launch_generic_forward`)."""
    src = (Path(kernels.__file__).resolve().parent.parent / "csrc"
           / "acs_generic.cu").read_text()
    return [tuple(map(int, m)) for m in re.findall(
        r"launch_forward<(\d+), (\d+), (\d+)(?:, \d+)*>\(GENERIC_ARGS\)", src)]


def _staged_steps(words):
    """csrc/acs_generic.cu `staged_steps`: steps staged a chunk."""
    r = 32
    while r > 2 and r * words > 512:
        r >>= 1
    return r


def _prmt(lo, hi, sel):
    """PTX prmt.b32 (default mode) on int64 arrays: byte j of the result is
    byte sel_j & 7 of {hi:lo}, or that byte's sign bit replicated when
    sel_j & 8."""
    out = np.zeros(np.broadcast(lo, hi, sel).shape, np.int64)
    for j in range(4):
        s = (sel >> (4 * j)) & 15
        src = np.where((s & 7) < 4, lo, hi)
        byte = (src >> (8 * (s & 3))) & 0xFF
        byte = np.where(s & 8, np.where(byte & 0x80, 0xFF, 0), byte)
        out |= byte << (8 * j)
    return out


def _argmin_tree(v):
    """`argmin_tree` along the last axis: strict < compares in a tree, the
    lower indices on the left, so ties keep the lowest index."""
    v = v.copy()
    E = v.shape[-1]
    ix = np.broadcast_to(np.arange(E), v.shape).copy()
    w = 1
    while w < E:
        for i in range(0, E, 2 * w):
            p = v[..., i + w] < v[..., i]
            v[..., i] = np.where(p, v[..., i + w], v[..., i])
            ix[..., i] = np.where(p, ix[..., i + w], ix[..., i])
        w *= 2
    return v[..., 0], ix[..., 0]


def _generic_forward_model(k, logns, logc, n, seg_d, seg_e, seg, init_value):
    """numpy model of csrc/acs_generic.cu's `generic_forward_kernel`, done
    the way the kernel does it.  C = 2^logc lanes a channel, 32 / C
    channels a warp; lane l owns destinations l*DPL .. l*DPL + DPL - 1, in
    NGL groups from group (l*DPL) >> k on (U of each group's destinations).
    Each group's 2^k sources s + e*G come from the channel's row of the last
    step's metrics in shared memory, or (DPL = 1) by __shfl_sync from lane
    s + e*G of the channel.  k <= 3: the lane takes the branch metric from a byte permute of the
    step's table D_x, x = r ^ seg_e[e] (n <= 3), or popc, and the
    candidates meet in `argmin_tree`.  k >= 4: the sources eight at a time,
    a tree each, strict < across the eights, popc.  Plane b's bits: a lane's
    whole words (DPL >= 32), a ballot over the warp cut to the channel
    (DPL = 1), or fields at their word offsets joined over LW lanes by XOR
    shuffles, the first lane of the LW storing the word; words staged R
    steps and written a channel's run at a time.  Returns (planes int32
    [B, T, k, W], final metrics int32 [B, NS])."""
    B, T = seg.shape
    E, NS = 1 << k, 1 << logns
    G, C, CPW, DPL = NS >> k, 1 << logc, 32 >> logc, NS >> logc
    small_e = k <= 3
    NGL, U = max(DPL // E, 1), min(DPL, E)
    W = (NS + 31) // 32
    KW = k * W
    LW = 1 if DPL >= 32 else min(NS, 32) // DPL
    R = _staged_steps(CPW * KW)
    ham = small_e and n <= 3
    BP = -(-B // CPW) * CPW                  # whole warps; padded rows r = 0
    segp = np.zeros((BP, T), np.int64)
    segp[:B] = seg
    lane = np.arange(C)
    first = lane * DPL
    dest = first[:, None] + np.arange(DPL)   # [C, DPL]
    sd = seg_d.astype(np.int64)[dest] | (0x8880 if ham else 0)
    se = seg_e.astype(np.int64)
    pop = np.array([[bin(x ^ c).count("1") for c in range(8)]
                    for x in range(8)], np.int64)
    pop_lo = (pop[:, :4] << (8 * np.arange(4))).sum(-1)
    pop_hi = (pop[:, 4:] << (8 * np.arange(4))).sum(-1)
    m = np.broadcast_to(np.where(dest == 0, 0, init_value),
                        (BP, C, DPL)).astype(np.int64)
    row = m.reshape(BP, NS)                  # the shared row, natural order
    planes = np.zeros((BP, T, KW), np.int64)
    nmask = (1 << n) - 1
    for t0 in range(0, T, R):
        steps = min(R, T - t0)
        stage = np.zeros((BP, R, KW), np.int64)
        for s in range(steps):
            r = segp[:, t0 + s] & nmask
            if small_e:
                src = ((first >> k)[:, None, None] + np.arange(NGL)[:, None]
                       + np.arange(E) * G)   # [C, NGL, E]
                if DPL == 1:                 # __shfl_sync from lane src
                    v = m[:, src, 0]
                else:                        # the shared row
                    v = row[:, src]          # [BP, C, NGL, E]
                sdq = sd.reshape(C, NGL, U)  # [C, q, u]
                if ham:
                    x = r[:, None] ^ se      # [BP, E]
                    bm = _prmt(pop_lo[x][:, None, None, None, :],
                               pop_hi[x][:, None, None, None, :],
                               sdq[None, :, :, :, None])
                else:
                    bm = np.bitwise_count(
                        r[:, None, None, None, None]
                        ^ sdq[None, :, :, :, None] ^ se).astype(np.int64)
                best, ix = _argmin_tree(v[:, :, :, None, :] + bm)
            else:
                src = (first >> k)[:, None] + np.arange(E) * G  # [C, E]
                sv = m[:, src, 0] if DPL == 1 else row[:, src]  # [BP, C, E]
                cand = sv[:, :, None, :] + np.bitwise_count(
                    r[:, None, None, None] ^ sd[None, :, :, None]
                    ^ se).astype(np.int64)
                best = np.full(cand.shape[:-1], 2 ** 31 - 1, np.int64)
                ix = np.zeros(cand.shape[:-1], np.int64)
                for e0 in range(0, E, 8):
                    b8, at = _argmin_tree(cand[..., e0:e0 + 8])
                    p = b8 < best
                    best = np.where(p, b8, best)
                    ix = np.where(p, e0 + at, ix)
            m = best.reshape(BP, C, DPL)
            ix = ix.reshape(BP, C, DPL)
            row = m.reshape(BP, NS)
            for b in range(k):
                bits = (ix >> b) & 1         # [BP, C, DPL]
                if DPL >= 32:
                    words = (bits.reshape(BP, C, DPL // 32, 32)
                             << np.arange(32)).sum(-1)
                    at = b * W + (first[:, None] >> 5) + np.arange(DPL // 32)
                    stage[:, s, at] = words
                elif DPL == 1:
                    ballot = (bits[..., 0].reshape(-1, 32)
                              << np.arange(32)).sum(-1)    # per warp
                    c = np.arange(BP) % CPW
                    mask = (1 << C) - 1
                    stage[:, s, b * W] = (np.repeat(ballot, CPW) >> (c * C)) \
                        & mask
                else:
                    field = (bits << np.arange(DPL)).sum(-1) << (first & 31)
                    x = 1
                    while x < LW:            # __shfl_xor_sync(field, x)
                        field = field | field[:, lane ^ x]
                        x *= 2
                    own = (lane & (LW - 1)) == 0
                    stage[:, s, b * W + (first[own] >> 5)] = field[:, own]
        planes[:, t0:t0 + steps] = stage[:, :steps]
    planes = planes[:B].reshape(B, T, k, W)
    planes = np.where(planes >= 2 ** 31, planes - 2 ** 32, planes)
    return planes.astype(np.int32), row[:B].astype(np.int32)


# Every shape of the kernel's dispatch, each at three T: one step (n 1 ... 3,
# the byte-permute metric where k <= 3), S + 1 (n 4 ...
# 8, POPC), and one past a staging run, R + 1 (n 1 ... 8 in turn); B one
# more than the channels a warp (two rows when a warp holds one channel).
_MODEL_CASES = [
    (k, logns, logc, n, which)
    for i, (k, logns, logc) in enumerate(_forward_shapes())
    for which, n in (("one", 1 + i % 3), ("S+1", 4 + i % 5),
                     ("R+1", 1 + i % 8))]


@pytest.mark.parametrize("k,logns,logc,n,which", _MODEL_CASES)
def test_forward_schedule_model_matches_plain_forward(k, logns, logc, n,
                                                      which):
    """The generic forward's lanes, exchange, branch metric and word
    packing, modelled in numpy, give the plain forward's planes and final
    metrics bit for bit on a random code."""
    rng = np.random.default_rng(1000 * k + 10 * logns + n)
    K = logns // k + 1
    spec = port.CodeSpec(K=K, k=k, g=tuple(
        int(x) for x in rng.integers(1, 1 << (k * K), n)))
    cpw = 32 >> logc
    W = (spec.num_states + 31) // 32
    T = {"one": 1, "S+1": spec.S + 1,
         "R+1": _staged_steps(cpw * k * W) + 1}[which]
    B = cpw + 1 if cpw > 1 else 2
    seg = rng.integers(0, 1 << n, (B, T)).astype(np.uint8)
    seg_d, seg_e = generic.edge_tables(spec)
    planes, fm = _generic_forward_model(
        k, logns, logc, n, seg_d, seg_e, seg,
        port.ops.viterbi.init_metric_value(spec))
    planes_p, fm_p = generic.acs_forward_batch_generic_plain(
        spec, torch.from_numpy(seg))
    np.testing.assert_array_equal(planes, planes_p.numpy())
    np.testing.assert_array_equal(fm, fm_p.numpy())


def test_forward_dispatch_covers_every_admitted_shape():
    """The dispatch switch instantiates the forward for exactly the 25
    (k, NS) shapes `generic_kernel_supports` admits, NS = 2^(k S) <= 1024,
    k <= 8, each with lanes a channel that divide a warp and the state
    count."""
    shapes = _forward_shapes()
    admitted = {(k, k * S) for k in range(1, generic.MAX_K + 1)
                for S in range(1, 11) if k * S <= 10}
    assert len(shapes) == len(admitted) == 25
    assert {(k, logns) for k, logns, _ in shapes} == admitted
    assert all(0 <= logc <= min(5, logns) for _, logns, logc in shapes)


# --- The walk kernel's schedule, modelled in numpy ----------------------------

def _walk_shapes():
    """(k, log2 NS, log2 lanes a channel, log2 channels a warp, log2 steps
    a segment, warm-up steps) of each case of the walk's dispatch switch in
    csrc/acs_generic.cu (`launch_generic_walk`)."""
    src = (Path(kernels.__file__).resolve().parent.parent / "csrc"
           / "acs_generic.cu").read_text()
    return [tuple(map(int, m)) for m in re.findall(
        r"launch_walk<(\d+), (\d+), (\d+), (\d+), (\d+), (\d+)>\(WALK_ARGS\)",
        src)]


def _generic_walk_model(k, logns, logc, logg, wu, planes, t_actual,
                        lengths, rng):
    """numpy model of csrc/acs_generic.cu's `generic_walk_kernel`, done the
    way the kernel does it.  C = 2^logc lanes a channel; windows of C G
    steps (G = 2^logg) on the grid of multiples of C G, the top one first;
    lane l owns the segment [lo + l G, lo + l G + G) of window [lo, hi).  A
    lane guesses the state at its segment's top by a warm-up of `wu` steps
    from state 0, or from the window's top state where the warm-up reaches
    the window's top (so the top segment's start is exact), then walks its
    segment, its symbols MSb first into an accumulator of Q = 8 / gcd(k, 8)
    steps whose bytes it stores to the window's output bytes at the group's
    lowest step.  Then, in rounds, every lane whose start differs from the
    state the segment above ended in walks again from that state, until no
    lane differs; the window's lowest segment's end is the next window's top
    state.  The window's bytes (left as they were in the shared buffer where
    no lane stores) are written out for each message length in `lengths`,
    as bits or as bytes with the bits past the length masked.  Asserts that
    each lane stores only bytes of its own segment.  Returns ({length:
    (bits uint8 [B, length], bytes uint8 [B, ceil(length / 8)])}, segments
    walked again)."""
    B = planes.shape[0]
    S, C, G = logns // k, 1 << logc, 1 << logg
    WS = C * G
    Q = 8 // np.gcd(k, 8)
    QB = Q * k // 8
    words = planes.astype(np.int64) & 0xFFFFFFFF        # [B, T, k, W]
    rows = np.arange(B)[:, None]
    lanes = np.arange(C)

    def step(t, cur):
        w = words[rows, t, :, cur >> 5]                  # [B, C, k]
        e = (((w >> (cur & 31)[..., None]) & 1)
             << np.arange(k)).sum(-1)
        return (cur >> k) | (e << (logns - k))

    outs = {L: (np.zeros((B, L), np.uint8),
                np.zeros((B, (L + 7) // 8), np.uint8)) for L in lengths}
    stage = rng.integers(0, 256, (B, WS * k // 8)).astype(np.int64)
    top = np.zeros(B, np.int64)
    rewalks = 0
    for j in reversed(range(-(-t_actual // WS))):
        lo, hi = j * WS, min(j * WS + WS, t_actual)
        a = lo + lanes * G
        b = np.minimum(a + G, hi)
        mine = np.broadcast_to(a < hi, (B, C))
        top_seg = b == hi
        own_lo = ((a - lo) * k) // 8                     # a lane's own bytes
        own_hi = own_lo + G * k // 8

        def walk(lo_t, hi_t, cur, active, emit):
            """Steps hi_t - 1 down to lo_t (per lane) of the active lanes,
            all lanes a step at a time."""
            acc = np.zeros_like(cur)
            for tau in range(int(np.max(hi_t - lo_t, initial=0))):
                t = hi_t - 1 - tau                       # [C]
                on = active & (t >= lo_t)
                if not on.any():
                    break
                tt = np.broadcast_to(np.clip(t, 0, t_actual - 1), cur.shape)
                jq = t & (Q - 1)
                if emit:
                    acc = np.where(on, acc | ((cur & ((1 << k) - 1))
                                              << (k * (Q - 1 - jq))), acc)
                cur = np.where(on, step(tt, cur), cur)
                if emit:
                    store = on & (jq == 0)
                    r, l = np.nonzero(store)
                    at = ((t[l] - lo) * k) // 8
                    assert np.all((own_lo[l] <= at) & (at + QB <= own_hi[l]))
                    for m in range(QB):
                        stage[r, at + m] = (acc[r, l] >> (8 * (QB - 1 - m))) \
                            & 0xFF
                    acc = np.where(store, 0, acc)
            return cur

        t0 = np.minimum(b - 1 + wu, hi - 1)
        x = np.where(t0 == hi - 1, top[:, None], 0)
        start = walk(b, t0 + 1, x, mine & ~top_seg, False)
        start = np.where(top_seg, top[:, None], start)
        end = walk(a, b, start, mine, True)
        while True:
            above = np.concatenate([end[:, 1:], end[:, -1:]], axis=1)
            redo = mine & ~top_seg & (above != start)
            if not redo.any():
                break
            rewalks += int(redo.sum())
            start = np.where(redo, above, start)
            end = np.where(redo, walk(a, b, start, redo, True), end)
        top = end[:, 0]
        staged = stage.astype(np.uint8)
        for L, (bits, out_bytes) in outs.items():
            bit_lo, bit_hi = lo * k, min(hi * k, L)
            if bit_hi <= bit_lo:
                continue
            bits[:, bit_lo:bit_hi] = np.unpackbits(
                staged, axis=1)[:, :bit_hi - bit_lo]
            m_lo, m_hi = bit_lo // 8, (bit_hi + 7) // 8
            out_bytes[:, m_lo:m_hi] = staged[:, :m_hi - m_lo]
            if bit_hi % 8:
                out_bytes[:, m_hi - 1] &= 0xFF << (8 - bit_hi % 8) & 0xFF
    return outs, rewalks


def _random_planes(rng, k, NS, B, T):
    """Uniform decision words, the bits past NS zero: guesses go wrong."""
    words = rng.integers(-2 ** 31, 2 ** 31, (B, T, k, (NS + 31) // 32))
    if NS < 32:
        words &= (1 << NS) - 1
    return words.astype(np.int32)


# Every shape of the walk's dispatch at: one step; S + 1 steps; a
# segment's steps - 1 and + 1; one past a window with t_actual two below
# T_stride (random planes, the kernel's warm-up); and one past a window at
# a warm-up of 0 (every guess but the top segment's from state 0), where
# segments must be walked again.  Three channels; the whole message and a
# cut one, not a multiple of 8.
_WALK_CASES = [(shape, which) for shape in _walk_shapes()
               for which in ("one", "S+1", "G-1", "G+1", "window+1",
                             "no warm-up")]


@pytest.mark.parametrize("shape,which", _WALK_CASES,
                         ids=[f"k{s[0]}_NS{1 << s[1]}-{w}"
                              for s, w in _WALK_CASES])
def test_walk_schedule_model_matches_plain_walk(shape, which):
    """The generic walk's windows, segments, warm-ups, guesses, top-down
    check and re-walks, and each lane's whole output bytes, modelled in
    numpy, give the plain traceback's bits and bytes bit for bit."""
    k, logns, logc, _, logg, wu = shape
    rng = np.random.default_rng(100 * k + logns + len(which))
    S, G, WS = logns // k, 1 << logg, (1 << logc) << logg
    spec = port.CodeSpec(K=S + 1, k=k, g=tuple(
        int(x) for x in rng.integers(1, 1 << (k * (S + 1)), 2)))
    t_actual = {"one": 1, "S+1": S + 1, "G-1": max(G - 1, S),
                "G+1": G + 1, "window+1": WS + 1,
                "no warm-up": WS + 1}[which]
    T = t_actual + (2 if which == "window+1" else 0)
    planes = _random_planes(rng, k, 1 << logns, 3, T)
    full = max(t_actual - S, 0) * k
    cut = max(full - 13, 0)
    cut -= 1 if cut % 8 == 0 and cut > 0 else 0
    warm = 0 if which == "no warm-up" else wu
    outs, walked_again = _generic_walk_model(
        k, logns, logc, logg, warm, planes, t_actual, sorted({full, cut}),
        rng)
    want = generic.traceback_batch_generic_plain(
        spec, torch.from_numpy(planes), t_actual, full, "bits")
    for L, (bits, out_bytes) in outs.items():
        np.testing.assert_array_equal(bits, want[:, :L].numpy())
        np.testing.assert_array_equal(
            out_bytes, port.ops.viterbi.pad_and_pack(want[:, :L]).numpy())
    if which == "no warm-up":
        assert walked_again > 0


def test_walk_dispatch_covers_every_admitted_shape():
    """The walk's dispatch switch instantiates the walk for exactly the 25
    (k, NS) shapes `generic_kernel_supports` admits, each with lanes and
    channels that fit a warp, segments of whole output bytes and whole
    unrolled blocks, and the two windows of staged words fitting a block's
    (one warp's) shared memory."""
    shapes = _walk_shapes()
    admitted = {(k, k * S) for k in range(1, generic.MAX_K + 1)
                for S in range(1, 11) if k * S <= 10}
    assert len(shapes) == len(admitted) == 25
    assert {(k, logns) for k, logns, *_ in shapes} == admitted
    for k, logns, logc, logcpw, logg, wu in shapes:
        G = 1 << logg
        q = 8 // np.gcd(k, 8)
        unrolled = max(q, 4)
        assert logc + logcpw <= 5
        assert G % unrolled == 0 and wu % unrolled == 0
        segw = G * k * (((1 << logns) + 31) // 32)
        pitch = segw + (4 if segw % 8 == 0 else 8)
        smem = (2 * (1 << logcpw) * (1 << logc) * pitch * 4
                + (1 << logcpw) * (((1 << logc) * G * k // 8 + 15) & ~15)
                + 8 * 2 + 15) & ~15
        assert smem <= 232448
