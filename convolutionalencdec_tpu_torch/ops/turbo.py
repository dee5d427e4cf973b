"""Turbo codes: parallel-concatenated RSC with iterative max-log-MAP.

Port of `convolutionalencdec_tpu/ops/turbo.py`: the LTE data-channel code
(36.212 5.1.3.2), two 8-state recursive systematic convolutional (RSC)
encoders g = (13, 15) octal coupled by a QPP interleaver, decoded by
exchanging extrinsic LLRs between two max-log-MAP (min-sum BCJR) passes.
The trellis tables, the encoders' numpy oracles, the QPP table and the
encode operator are numpy (copied: the port imports nothing of the JAX
package); the batched encode, the constituent MAP scan and the exchange are
torch.

Everything lives in the integer min-sum cost domain of `ops/metrics.py`:
quantized LLRs in, positive favours bit 0, costs exact in int32.
`rsc_maxlogmap` is the plain version of the CUDA kernel in
`kernels/turbo.py`; the exchange (`turbo_iteration`, 3/4 extrinsic
scaling with floor division, the a-priori clamp) is shared by the plain
decoders here and the kernel decoders there, so the two cannot drift.

Every function takes `device=None`: a tensor input keeps its device, any
other input goes to `device` (default the card).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .._device import as_tensor
from .bits import parity32_np
from .crc import crc_check

#: Exclusion constant of the scan, as `ops.maxlogmap.BIG`.
BIG = 1 << 28

#: Clamp of the exchanged a-priori LLRs (part of the algorithm, as in the
#: JAX package).  With |l_apriori| <= 2^17 and channel LLRs of a few
#: quantizer steps, every branch metric stays below 2^18 in magnitude,
#: which bounds the kernel's renormalised metrics (csrc/turbo_rsc.cu) and
#: keeps the scan's unrenormalised int32 path costs below 2^31 up to the
#: largest LTE block.
LA_CLAMP = 1 << 17


@dataclasses.dataclass(frozen=True)
class RscSpec:
    """A rate-1/2 recursive systematic convolutional constituent.

    Polynomials in the Proakis big-endian convention over K bits (MSB =
    newest input): `g_fb` is the feedback polynomial g0 (its MSB term is
    the current input), `g_fw` the parity polynomial g1.  Default = the
    LTE turbo constituent (36.212 5.1.3.2): K=4, g0=13, g1=15 octal.
    """
    K: int = 4
    g_fb: int = 0o13
    g_fw: int = 0o15

    def __post_init__(self):
        if not (self.g_fb >> (self.K - 1)) & 1:
            raise ValueError("feedback polynomial must tap the current input")
        for g in (self.g_fb, self.g_fw):
            if g >= (1 << self.K):
                raise ValueError("polynomial wider than K bits")

    @property
    def S(self) -> int:
        return self.K - 1

    @property
    def num_states(self) -> int:
        return 1 << self.S

    @classmethod
    def from_reference(cls, spec_like) -> "RscSpec":
        """The port's `RscSpec` for any object with the fields `K, g_fb,
        g_fw` (for example the JAX package's `RscSpec`): the code and the
        interleaver are the turbo decoder's only parameters."""
        return cls(K=int(spec_like.K), g_fb=int(spec_like.g_fb),
                   g_fw=int(spec_like.g_fw))


def rsc_step(rsc: RscSpec, state: int, u: int) -> tuple[int, int, int]:
    """One RSC trellis step: the register holds the last S feedback
    outputs w (newest at the MSB).  Returns (next_state, systematic_bit,
    parity_bit)."""
    S = rsc.S
    fb_taps = rsc.g_fb & ((1 << S) - 1)          # D^1..D^S terms
    w = u ^ int(parity32_np(np.uint32(state & fb_taps)))
    window = (w << S) | state                     # K bits, newest at MSB
    z = int(parity32_np(np.uint32(window & rsc.g_fw)))
    nxt = (window >> 1) & ((1 << S) - 1)
    return nxt, u, z


def rsc_tail_input(rsc: RscSpec, state: int) -> int:
    """The input bit that zeroes the feedback (termination: w = 0, so the
    register shifts toward 0; S such steps reach state 0)."""
    fb_taps = rsc.g_fb & ((1 << rsc.S) - 1)
    return int(parity32_np(np.uint32(state & fb_taps)))


@functools.lru_cache(maxsize=None)
def rsc_tables(rsc: RscSpec):
    """(nxt, par, prev, pu), int32 [2, NS] each: for (u, state) the next
    state and parity bit; for (e, dst) the e-th predecessor and the input
    bit on that edge.  All derived from `rsc_step`, so encoder and decoder
    cannot disagree."""
    NS = rsc.num_states
    nxt = np.zeros((2, NS), np.int32)
    par = np.zeros((2, NS), np.int32)
    for s in range(NS):
        for u in range(2):
            ns, _, z = rsc_step(rsc, s, u)
            nxt[u, s], par[u, s] = ns, z
    prev = np.zeros((2, NS), np.int32)
    pu = np.zeros((2, NS), np.int32)
    fill = np.zeros(NS, np.int64)
    for s in range(NS):
        for u in range(2):
            d = nxt[u, s]
            prev[fill[d], d] = s
            pu[fill[d], d] = u
            fill[d] += 1
    assert (fill == 2).all(), "RSC trellis must be 2-regular"
    return nxt, par, prev, pu


def rsc_encode_np(rsc: RscSpec, bits: np.ndarray):
    """NumPy RSC encode of one block with termination: (sys [L], par [L],
    sys_tail [S], par_tail [S]); the tail systematic bits are the forced
    termination inputs."""
    bits = np.asarray(bits, np.uint8)
    s = 0
    sys_, par = np.empty_like(bits), np.empty_like(bits)
    for i, u in enumerate(bits):
        s, x, z = rsc_step(rsc, s, int(u))
        sys_[i], par[i] = x, z
    st, pt = np.empty(rsc.S, np.uint8), np.empty(rsc.S, np.uint8)
    for i in range(rsc.S):
        u = rsc_tail_input(rsc, s)
        s, x, z = rsc_step(rsc, s, u)
        st[i], pt[i] = x, z
    assert s == 0
    return sys_, par, st, pt


def rsc_encode_batch_np(rsc: RscSpec, bits: np.ndarray):
    """Table-driven RSC encode of a [B, L] batch, one numpy step per
    trellis step (the outputs of `rsc_encode_np`)."""
    bits = np.asarray(bits, np.uint8)
    B, L = bits.shape
    nxt, par, _, _ = rsc_tables(rsc)
    tail_u = np.array([rsc_tail_input(rsc, s) for s in range(rsc.num_states)],
                      np.uint8)
    s = np.zeros(B, np.int32)
    parity = np.empty((B, L), np.uint8)
    for t in range(L):
        u = bits[:, t]
        parity[:, t] = par[u, s]
        s = nxt[u, s]
    st = np.empty((B, rsc.S), np.uint8)
    pt = np.empty((B, rsc.S), np.uint8)
    for i in range(rsc.S):
        u = tail_u[s]
        st[:, i] = u
        pt[:, i] = par[u, s]
        s = nxt[u, s]
    assert (s == 0).all()
    return bits, parity, st, pt


def _streams(sys_, par1, par2, t1, t2) -> dict:
    return {"sys": sys_, "par1": par1, "par2": par2,
            "sys_tail1": t1[0], "par_tail1": t1[1],
            "sys_tail2": t2[0], "par_tail2": t2[1]}


def turbo_encode_batch_np(rsc: RscSpec, bits: np.ndarray, perm: np.ndarray):
    """Batched `turbo_encode_np`: [B, L] bits -> dict of [B, ...] streams."""
    bits = np.asarray(bits, np.uint8)
    sys_, par1, st1, pt1 = rsc_encode_batch_np(rsc, bits)
    _, par2, st2, pt2 = rsc_encode_batch_np(rsc, bits[:, np.asarray(perm)])
    return _streams(sys_, par1, par2, (st1, pt1), (st2, pt2))


def turbo_encode_np(rsc: RscSpec, bits: np.ndarray, perm: np.ndarray):
    """LTE turbo encode of one block (numpy oracle): the systematic `sys`
    [L], parities `par1`, `par2` [L], and each constituent's termination
    fields `sys_tail1`, `par_tail1`, `sys_tail2`, `par_tail2` [S]."""
    bits = np.asarray(bits, np.uint8)
    sys_, par1, st1, pt1 = rsc_encode_np(rsc, bits)
    _, par2, st2, pt2 = rsc_encode_np(rsc, bits[np.asarray(perm)])
    return _streams(sys_, par1, par2, (st1, pt1), (st2, pt2))


# ---------------------------------------------------------------------------
# Batched encode: the recursion is GF(2)-linear in the input bits (an IIR
# filter g_fw(D)/g_fb(D)), so the parity of a batch is one block-Toeplitz
# matrix product reduced mod 2, as the CRC is (`ops/crc.py`).  The product
# is float32 `torch.matmul`: 0/1 inputs and sums of at most _ENC_BLOCK (or
# L for the final state), exact.

#: Toeplitz block edge of the encode operator.
_ENC_BLOCK = 512


@functools.lru_cache(maxsize=None)
def _rsc_impulse(rsc: RscSpec, n: int) -> np.ndarray:
    """First n samples of the impulse response of 1/g_fb(D): the feedback
    sequence w for input delta (u_0 = 1)."""
    S = rsc.S
    fb = rsc.g_fb & ((1 << S) - 1)
    h = np.zeros(n, np.uint8)
    s = 0
    for t in range(n):
        u = 1 if t == 0 else 0
        w = u ^ (bin(s & fb).count("1") & 1)
        h[t] = w
        s = ((w << S) | s) >> 1
    return h


@functools.lru_cache(maxsize=None)
def _rsc_encode_blocks(rsc: RscSpec, L: int):
    """Block-Toeplitz encode operator for (u @ T) & 1.

    Parity = u convolved with hz, the impulse response of g_fw/g_fb; with
    Kb-wide blocks that is nb block products against nb distinct (Kb, Kb)
    blocks Td[d][a, b] = hz[d Kb + b - a], plus an (L, S) matrix of h
    columns for the final state.  Returns (Td [nb, Kb, Kb] int8, Tt [L, S]
    int8, Lp)."""
    S = rsc.S
    Kb = min(_ENC_BLOCK, -(-L // 8) * 8)
    Lp = -(-L // Kb) * Kb
    nb = Lp // Kb
    h = _rsc_impulse(rsc, Lp).astype(np.int64)
    hz = np.zeros(Lp, np.int64)
    for j in range(S + 1):
        if (rsc.g_fw >> j) & 1:
            lag = S - j
            hz[lag:] ^= h[:Lp - lag] if lag else h
    a = np.arange(Kb)[:, None]
    b = np.arange(Kb)[None, :]
    Td = np.zeros((nb, Kb, Kb), np.int8)
    for d in range(nb):
        idx = d * Kb + b - a
        Td[d] = np.where(idx >= 0, hz[np.clip(idx, 0, Lp - 1)], 0)
    j = np.arange(L)[:, None]
    Tt = np.zeros((L, S), np.int8)
    for i in range(S):
        d2 = (L - S + i) - j[:, 0]
        Tt[:, i] = np.where(d2 >= 0, h[np.clip(d2, 0, Lp - 1)], 0)
    return Td, Tt, Lp


@functools.lru_cache(maxsize=16)
def _encode_tensors(rsc: RscSpec, L: int, device: torch.device):
    """(Td float32 [nb, Kb, Kb], Tt float32 [L, S], Lp) on `device`."""
    Td, Tt, Lp = _rsc_encode_blocks(rsc, L)
    return (torch.as_tensor(Td, dtype=torch.float32, device=device),
            torch.as_tensor(Tt, dtype=torch.float32, device=device), Lp)


def _parity_of(x: torch.Tensor, mask: int) -> torch.Tensor:
    """Elementwise parity of (x & mask)."""
    out = torch.zeros_like(x)
    for b in range(mask.bit_length()):
        if (mask >> b) & 1:
            out ^= (x >> b) & 1
    return out


def rsc_encode_batch(rsc: RscSpec, bits, device=None):
    """Batched RSC encode: [B, L] bits -> (sys, par, sys_tail, par_tail),
    uint8, the outputs of `rsc_encode_batch_np`, with no sequential
    recurrence: the parity is a block-Toeplitz product mod 2 and the
    termination fields follow from the final state in S steps."""
    bits = as_tensor(bits, torch.uint8, device)
    B, L = bits.shape
    S = rsc.S
    Td, Tt, Lp = _encode_tensors(rsc, L, bits.device)
    nb, Kb, _ = Td.shape
    U = torch.zeros((B, Lp), dtype=torch.float32, device=bits.device)
    U[:, :L] = bits
    U = U.reshape(B, nb, Kb)
    acc = torch.zeros((B, nb, Kb), dtype=torch.float32, device=bits.device)
    for d in range(nb):
        # parity block j receives input block j - d through Toeplitz block d
        acc[:, d:] += torch.matmul(U[:, :nb - d], Td[d])
    z = (acc.to(torch.int32) & 1).to(torch.uint8).reshape(B, Lp)[:, :L]
    # The final state's bit i is w_{L-S+i} = u . h-column i.
    st_acc = torch.matmul(bits.to(torch.float32), Tt).to(torch.int32) & 1
    s = torch.zeros(B, dtype=torch.int32, device=bits.device)
    for i in range(S):
        s |= st_acc[:, i] << i
    fb = rsc.g_fb & ((1 << S) - 1)
    fw_low = rsc.g_fw & ((1 << S) - 1)     # the tail steps force w = 0
    st, pt = [], []
    for _ in range(S):
        st.append(_parity_of(s, fb))
        pt.append(_parity_of(s, fw_low))
        s = s >> 1
    return (bits, z, torch.stack(st, dim=1).to(torch.uint8),
            torch.stack(pt, dim=1).to(torch.uint8))


def turbo_encode_batch(rsc: RscSpec, bits, perm, device=None) -> dict:
    """Batched turbo encode: [B, L] bits -> dict of uint8 streams (the keys
    and shapes of `turbo_encode_batch_np`)."""
    bits = as_tensor(bits, torch.uint8, device)
    sys_, par1, st1, pt1 = rsc_encode_batch(rsc, bits)
    pi = torch.as_tensor(np.asarray(perm), dtype=torch.long,
                         device=bits.device)
    _, par2, st2, pt2 = rsc_encode_batch(rsc, bits[:, pi])
    return _streams(sys_, par1, par2, (st1, pt1), (st2, pt2))


# ---------------------------------------------------------------------------
# QPP interleaver (36.212 5.1.3.2.3): pi(i) = (f1 i + f2 i^2) mod L.

#: 36.212 Table 5.1.3-3: block length K -> (f1, f2).
QPP_TABLE = {
    40: (3, 10), 48: (7, 12), 56: (19, 42), 64: (7, 16),
    72: (7, 18), 80: (11, 20), 88: (5, 22), 96: (11, 24),
    104: (7, 26), 112: (41, 84), 120: (103, 90), 128: (15, 32),
    136: (9, 34), 144: (17, 108), 152: (9, 38), 160: (21, 120),
    168: (101, 84), 176: (21, 44), 184: (57, 46), 192: (23, 48),
    200: (13, 50), 208: (27, 52), 216: (11, 36), 224: (27, 56),
    232: (85, 58), 240: (29, 60), 248: (33, 62), 256: (15, 32),
    264: (17, 198), 272: (33, 68), 280: (103, 210), 288: (19, 36),
    296: (19, 74), 304: (37, 76), 312: (19, 78), 320: (21, 120),
    328: (21, 82), 336: (115, 84), 344: (193, 86), 352: (21, 44),
    360: (133, 90), 368: (81, 46), 376: (45, 94), 384: (23, 48),
    392: (243, 98), 400: (151, 40), 408: (155, 102), 416: (25, 52),
    424: (51, 106), 432: (47, 72), 440: (91, 110), 448: (29, 168),
    456: (29, 114), 464: (247, 58), 472: (29, 118), 480: (89, 180),
    488: (91, 122), 496: (157, 62), 504: (55, 84), 512: (31, 64),
    528: (17, 66), 544: (35, 68), 560: (227, 420), 576: (65, 96),
    592: (19, 74), 608: (37, 76), 624: (41, 234), 640: (39, 80),
    656: (185, 82), 672: (43, 252), 688: (21, 86), 704: (155, 44),
    720: (79, 120), 736: (139, 92), 752: (23, 94), 768: (217, 48),
    784: (25, 98), 800: (17, 80), 816: (127, 102), 832: (25, 52),
    848: (239, 106), 864: (17, 48), 880: (137, 110), 896: (215, 112),
    912: (29, 114), 928: (15, 58), 944: (147, 118), 960: (29, 60),
    976: (59, 122), 992: (65, 124), 1008: (55, 84), 1024: (31, 64),
    1056: (17, 66), 1088: (171, 204), 1120: (67, 140), 1152: (35, 72),
    1184: (19, 74), 1216: (39, 76), 1248: (19, 78), 1280: (199, 240),
    1312: (21, 82), 1344: (211, 252), 1376: (21, 86), 1408: (43, 88),
    1440: (149, 60), 1472: (45, 92), 1504: (49, 846), 1536: (71, 48),
    1568: (13, 28), 1600: (17, 80), 1632: (25, 102), 1664: (183, 104),
    1696: (55, 954), 1728: (127, 96), 1760: (27, 110), 1792: (29, 112),
    1824: (29, 114), 1856: (57, 116), 1888: (45, 354), 1920: (31, 120),
    1952: (59, 610), 1984: (185, 124), 2016: (113, 420), 2048: (31, 64),
    2112: (17, 66), 2176: (171, 136), 2240: (209, 420), 2304: (253, 216),
    2368: (367, 444), 2432: (265, 456), 2496: (181, 468), 2560: (39, 80),
    2624: (27, 164), 2688: (127, 504), 2752: (143, 172), 2816: (43, 88),
    2880: (29, 300), 2944: (45, 92), 3008: (157, 188), 3072: (47, 96),
    3136: (13, 28), 3200: (111, 240), 3264: (443, 204), 3328: (51, 104),
    3392: (51, 212), 3456: (451, 192), 3520: (257, 220), 3584: (57, 336),
    3648: (313, 228), 3712: (271, 232), 3776: (179, 236), 3840: (331, 120),
    3904: (363, 244), 3968: (375, 248), 4032: (127, 168), 4096: (31, 64),
    4160: (33, 130), 4224: (43, 264), 4288: (33, 134), 4352: (477, 408),
    4416: (35, 138), 4480: (233, 280), 4544: (357, 142), 4608: (337, 480),
    4672: (37, 146), 4736: (71, 444), 4800: (71, 120), 4864: (37, 152),
    4928: (39, 462), 4992: (127, 234), 5056: (39, 158), 5120: (39, 80),
    5184: (31, 96), 5248: (113, 902), 5312: (41, 166), 5376: (251, 336),
    5440: (43, 170), 5504: (21, 86), 5568: (43, 174), 5632: (45, 176),
    5696: (45, 178), 5760: (161, 120), 5824: (89, 182), 5888: (323, 184),
    5952: (47, 186), 6016: (23, 94), 6080: (47, 190), 6144: (263, 480),
}


def qpp_interleaver(L: int, f1: int | None = None,
                    f2: int | None = None) -> np.ndarray:
    """QPP permutation pi with pi[i] = (f1 i + f2 i^2) mod L, int32 [L].

    Defaults to `QPP_TABLE[L]`.  Raises ValueError unless the result is a
    permutation (QPP is bijective only under the standard's divisibility
    conditions on f1, f2)."""
    if f1 is None or f2 is None:
        if L not in QPP_TABLE:
            raise ValueError(
                f"L={L} is not an LTE turbo block size; pass f1, f2")
        f1, f2 = QPP_TABLE[L]
    i = np.arange(L, dtype=np.int64)
    pi = ((f1 * i + f2 * i * i) % L).astype(np.int32)
    if np.unique(pi).size != L:
        raise ValueError(f"(f1={f1}, f2={f2}) is not a QPP for L={L}")
    return pi


# ---------------------------------------------------------------------------
# Constituent max-log-MAP with a-priori input: the plain version of the
# CUDA kernel `kernels/turbo.rsc_maxlogmap_batch_kernel`.

def _fields(device, *xs) -> list[torch.Tensor]:
    """The LLR fields as int32 tensors on one device (the first one's)."""
    first = as_tensor(xs[0], torch.int32, device)
    return [first] + [as_tensor(x, torch.int32, first.device)
                      for x in xs[1:]]


def rsc_maxlogmap(rsc: RscSpec, l_sys, l_par, l_apriori, l_sys_tail,
                  l_par_tail, device=None) -> torch.Tensor:
    """A-posteriori LLRs of a batch of RSC blocks via max-log-MAP.

    All inputs are integer LLRs (positive favours bit 0): l_sys, l_par,
    l_apriori [B, L] per message step, l_sys_tail, l_par_tail [B, S] per
    termination step (channel terms only).  Returns int32 [B, L]; the
    extrinsic for the exchange is lapp - l_sys - l_apriori.

    The scan: BIG = 2^28 exclusion, int32, no renormalisation; beta
    anchored at state 0 through the S tail steps, where the input is left
    free (the trellis is 2-regular and the zero-feedback path from each
    state is unique, so this admits exactly the termination paths).
    """
    l_sys, l_par, l_apriori, l_st, l_pt = _fields(
        device, l_sys, l_par, l_apriori, l_sys_tail, l_par_tail)
    B, L = l_sys.shape
    NS = rsc.num_states
    dev = l_sys.device
    nxt, par, prev, pu = (torch.as_tensor(t, dtype=torch.long, device=dev)
                          for t in rsc_tables(rsc))
    lu = torch.cat([l_sys + l_apriori, l_st], dim=1)         # [B, L + S]
    lp = torch.cat([l_par, l_pt], dim=1)
    u = torch.arange(2, dtype=torch.int32, device=dev)[:, None]
    # bm[b, t, u, s] = u lu_t + par[u, s] lp_t
    bm = (u * lu[:, :, None, None]
          + par.to(torch.int32) * lp[:, :, None, None])      # [B, T, 2, NS]
    bm_in = bm[:, :, pu, prev]                               # edge e into d
    T = L + rsc.S

    def anchored() -> torch.Tensor:
        m = torch.full((B, NS), BIG, dtype=torch.int32, device=dev)
        m[:, 0] = 0
        return m

    alphas = torch.empty((B, L, NS), dtype=torch.int32, device=dev)
    m = anchored()
    for t in range(L):
        alphas[:, t] = m
        m = torch.amin(m[:, prev] + bm_in[:, t], dim=1)
    b = anchored()
    per_u = torch.empty((B, L, 2), dtype=torch.int32, device=dev)
    for t in range(T - 1, -1, -1):
        cand = bm[:, t] + b[:, nxt]                          # [B, 2(u), NS(s)]
        if t < L:
            per_u[:, t] = torch.amin(alphas[:, t, None, :] + cand, dim=2)
        b = torch.amin(cand, dim=1)
    return per_u[:, :, 1] - per_u[:, :, 0]


# ---------------------------------------------------------------------------
# The exchange.

def perm_tensors(perm, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The interleaver and its inverse as long tensors on `device`."""
    pi = np.asarray(perm, np.int64)
    inv = np.empty_like(pi)
    inv[pi] = np.arange(pi.size)
    return (torch.as_tensor(pi, device=device),
            torch.as_tensor(inv, device=device))


def _scaled_apriori(le: torch.Tensor) -> torch.Tensor:
    """clip(floor(3 le / 4), +-LA_CLAMP): the 3/4 max-log correction with
    floor division (as the JAX `//`), then the a-priori clamp."""
    return torch.clamp(torch.div(3 * le, 4, rounding_mode="floor"),
                       -LA_CLAMP, LA_CLAMP)


def turbo_iteration(map_fn, rsc: RscSpec, fields, pi: torch.Tensor,
                    inv: torch.Tensor, la1: torch.Tensor):
    """One full exchange DEC1 -> interleave -> DEC2 -> de-interleave.

    `map_fn` is the constituent MAP (`rsc_maxlogmap` or the kernel's
    wrapper), `fields` the seven int32 tensors (l_sys, l_par1, l_par2,
    l_sys_tail1, l_par_tail1, l_sys_tail2, l_par_tail2) plus l_sys
    interleaved as an eighth.  Returns (la1 of the next iteration, lapp:
    DEC2's a-posteriori LLRs de-interleaved)."""
    l_sys, l_par1, l_par2, st1, pt1, st2, pt2, l_sys_i = fields
    lapp1 = map_fn(rsc, l_sys, l_par1, la1, st1, pt1)
    le1 = lapp1 - l_sys - la1
    la2 = _scaled_apriori(le1[:, pi])
    lapp2 = map_fn(rsc, l_sys_i, l_par2, la2, st2, pt2)
    le2 = lapp2 - l_sys_i - la2
    return _scaled_apriori(le2)[:, inv], lapp2[:, inv]


def exchange_setup(rsc: RscSpec, perm, device, *fields):
    """(fields with l_sys interleaved appended, pi, inv, B, L) of a batch:
    the seven LLR fields as int32 tensors on one device."""
    fields = _fields(device, *fields)
    B, L = fields[0].shape
    if np.asarray(perm).shape != (L,):
        raise ValueError(f"the interleaver must have L = {L} entries")
    pi, inv = perm_tensors(perm, fields[0].device)
    return fields + [fields[0][:, pi]], pi, inv, B, L


def decode_fixed(map_fn, rsc: RscSpec, fields, perm, n_iters: int,
                 device=None):
    """`n_iters` exchanges through `map_fn`: (uint8 bits [B, L], int32
    lapp [B, L])."""
    fields, pi, inv, B, L = exchange_setup(rsc, perm, device, *fields)
    la1 = torch.zeros((B, L), dtype=torch.int32, device=fields[0].device)
    lapp = torch.zeros_like(la1)
    for _ in range(n_iters):
        la1, lapp = turbo_iteration(map_fn, rsc, fields, pi, inv, la1)
    return (lapp < 0).to(torch.uint8), lapp


def decode_early(map_fn, rsc: RscSpec, fields, perm, crc, max_iters: int,
                 device=None):
    """Exchanges through `map_fn` until every block's CRC passes or
    `max_iters`: (bits [B, L], lapp [B, L], ok bool [B], iterations used,
    an int).  A block latches its first CRC-passing bits and LLRs; a block
    that never passes returns the last iteration's.  The stop test reads
    `ok.all()` on the host after each iteration (one synchronisation per
    iteration)."""
    fields, pi, inv, B, L = exchange_setup(rsc, perm, device, *fields)
    dev = fields[0].device
    la1 = torch.zeros((B, L), dtype=torch.int32, device=dev)
    lapp = torch.zeros_like(la1)
    ok = torch.zeros(B, dtype=torch.bool, device=dev)
    best_bits = torch.zeros((B, L), dtype=torch.uint8, device=dev)
    best_lapp = torch.zeros_like(la1)
    it = 0
    while it < max_iters and not bool(ok.all()):
        la1, lapp = turbo_iteration(map_fn, rsc, fields, pi, inv, la1)
        bits = (lapp < 0).to(torch.uint8)
        okb = crc_check(crc, bits)
        newly = (okb & ~ok)[:, None]
        best_bits = torch.where(newly, bits, best_bits)
        best_lapp = torch.where(newly, lapp, best_lapp)
        ok = ok | okb
        it += 1
    bits = torch.where(ok[:, None], best_bits, (lapp < 0).to(torch.uint8))
    lapp = torch.where(ok[:, None], best_lapp, lapp)
    return bits, lapp, ok, it


def turbo_decode_batch(rsc: RscSpec, l_sys, l_par1, l_par2, l_sys_tail1,
                       l_par_tail1, l_sys_tail2, l_par_tail2, perm,
                       n_iters: int = 6, device=None):
    """Iterative turbo decode of a batch, the plain exchange over
    `rsc_maxlogmap`.

    Args:
      l_sys, l_par1, l_par2: [B, L] integer channel LLRs of the systematic
        and the two parity streams (positive favours 0; punctured
        positions are 0).
      l_*_tail1/2: [B, S] LLRs of each constituent's termination field.
      perm: the interleaver, [L] (e.g. `qpp_interleaver(L)`).
      n_iters: full DEC1 -> DEC2 exchanges.

    Returns (uint8 [B, L] decoded bits, int32 [B, L] final a-posteriori
    LLRs).  The extrinsic is scaled by 3/4 with floor division and the
    exchanged a-priori clamped to +-LA_CLAMP, as in the JAX package.
    """
    return decode_fixed(rsc_maxlogmap, rsc,
                        (l_sys, l_par1, l_par2, l_sys_tail1, l_par_tail1,
                         l_sys_tail2, l_par_tail2), perm, n_iters, device)


def turbo_decode(rsc: RscSpec, l_sys, l_par1, l_par2, l_sys_tail1,
                 l_par_tail1, l_sys_tail2, l_par_tail2, perm,
                 n_iters: int = 6, device=None):
    """`turbo_decode_batch` of one block: [L] fields and [S] tails in,
    (uint8 [L] bits, int32 [L] LLRs) out."""
    fields = _fields(device, l_sys, l_par1, l_par2, l_sys_tail1,
                     l_par_tail1, l_sys_tail2, l_par_tail2)
    bits, lapp = turbo_decode_batch(rsc, *(f[None] for f in fields),
                                    perm=perm, n_iters=n_iters)
    return bits[0], lapp[0]
