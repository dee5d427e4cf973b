"""LTE transport-channel processing for turbo-coded channels (36.212 5.1).

Port of `convolutionalencdec_tpu/ops/lte.py`: code-block segmentation
(5.1.2, CRC24B per block, filler bits), trellis-termination multiplexing
(5.1.3.2.2), turbo rate matching (5.1.4.1: three sub-block interleavers,
systematic-first bit collection with the parity streams interlaced,
circular-buffer selection with redundancy versions and a soft-buffer
limit), the DL-SCH chain, and the one-call turbo encode and decode.

Every procedure that permutes or selects bits is a static numpy index map
(copied from the JAX package, which the port does not import): rate
matching is one gather, de-rate-matching one int32 `index_add_`
(repetitions chase-combine; never-sent positions stay at the zero-LLR
erasure; filler bits re-enter as strong LLRs).

The decoders take `use_kernel=None`: the turbo kernel (`kernels/turbo.py`)
wherever `turbo_kernel_supported(rsc)`, its plain version on a CPU tensor;
`use_kernel=False` asks for the plain exchange over `ops.turbo
.rsc_maxlogmap`.  Both give the same bits, bit for bit.  Every entry takes
`device=None`: a tensor keeps its device, any other input goes to the card
unless `device="cpu"`.
"""

from __future__ import annotations

import bisect
import functools

import numpy as np
import torch

from .._device import as_tensor
from .crc import CRC24A, CRC24B, crc_append, crc_check
from .turbo import (QPP_TABLE, RscSpec, decode_early, decode_fixed,
                    qpp_interleaver, rsc_maxlogmap, turbo_encode_batch,
                    turbo_encode_np)

#: Valid turbo code block sizes, ascending.
LTE_BLOCK_SIZES = tuple(sorted(QPP_TABLE))

#: LTE max code block size (36.212 5.1.2).
Z_MAX = 6144

#: 36.212 Table 5.1.4-1: inter-column permutation of the TURBO sub-block
#: interleaver (not the convolutional Table 5.1.4-2 of `ops.ratematch`).
TURBO_SUBBLOCK_PERM = (
    0, 16, 8, 24, 4, 20, 12, 28, 2, 18, 10, 26, 6, 22, 14, 30,
    1, 17, 9, 25, 5, 21, 13, 29, 3, 19, 11, 27, 7, 23, 15, 31,
)

NCOLS = 32


@functools.lru_cache(maxsize=None)
def _lte_qpp_cached(L: int) -> np.ndarray:
    if L not in QPP_TABLE:
        raise ValueError(f"L={L} is not an LTE turbo block size")
    return qpp_interleaver(L)


def lte_qpp(L: int) -> np.ndarray:
    """The standard interleaver for block size L (in the table), a fresh
    copy of the cached map."""
    return _lte_qpp_cached(L).copy()


# ---------------------------------------------------------------------------
# 5.1.3.2.2: the 12 tail bits onto the three stream tails (D = L + 4).

def _ns(x):
    """(stack, concatenate) for torch tensors or numpy arrays."""
    if isinstance(x, torch.Tensor):
        return (lambda xs, axis: torch.stack(xs, dim=axis),
                lambda xs, axis: torch.cat(xs, dim=axis))
    return np.stack, np.concatenate


def turbo_mux_streams(enc: dict):
    """Multiplex an encoder's stream dict into d [..., 3, L + 4]: d0 the
    systematic, d1 parity 1, d2 parity 2, and the 12 termination bits in
    the standard's interlaced order in the last 4 positions.  One block
    ([L] streams) or a batch ([B, L]); numpy in, numpy out, torch in,
    torch out."""
    stack, cat = _ns(enc["sys"])
    sys_, p1, p2 = enc["sys"], enc["par1"], enc["par2"]
    x, z = enc["sys_tail1"], enc["par_tail1"]
    xp, zp = enc["sys_tail2"], enc["par_tail2"]
    if x.shape[-1] != 3:
        raise ValueError("LTE termination multiplexing needs S=3 (8-state)")

    def t(*cols):
        return stack(list(cols), -1)

    d0 = cat([sys_, t(x[..., 0], z[..., 1], xp[..., 0], zp[..., 1])], -1)
    d1 = cat([p1, t(z[..., 0], x[..., 2], zp[..., 0], xp[..., 2])], -1)
    d2 = cat([p2, t(x[..., 1], z[..., 2], xp[..., 1], zp[..., 2])], -1)
    return stack([d0, d1, d2], -2)


def turbo_demux_tails(d):
    """Invert `turbo_mux_streams` on (soft) streams [..., 3, D]: the seven
    fields of the turbo decoders, (l_sys, l_par1, l_par2, sys_tail1,
    par_tail1, sys_tail2, par_tail2), messages [..., L] and tails
    [..., 3]."""
    stack, _ = _ns(d)
    d0, d1, d2 = d[..., 0, :], d[..., 1, :], d[..., 2, :]
    L = d0.shape[-1] - 4
    sys_tail1 = stack([d0[..., L], d2[..., L], d1[..., L + 1]], -1)
    par_tail1 = stack([d1[..., L], d0[..., L + 1], d2[..., L + 1]], -1)
    sys_tail2 = stack([d0[..., L + 2], d2[..., L + 2], d1[..., L + 3]], -1)
    par_tail2 = stack([d1[..., L + 2], d0[..., L + 3], d2[..., L + 3]], -1)
    return (d0[..., :L], d1[..., :L], d2[..., :L],
            sys_tail1, par_tail1, sys_tail2, par_tail2)


# ---------------------------------------------------------------------------
# 5.1.4.1: turbo rate matching as a static index map.

@functools.lru_cache(maxsize=None)
def _turbo_w_map(D: int, F: int) -> np.ndarray:
    """The turbo circular buffer w as flat source indices: int32
    [3 R 32], entry p the source (stream D + k, stream-major) of buffer
    position p, or -1 for a <NULL> (sub-block padding, or one of the F
    filler positions of streams 0 and 1).  v0 first, then v1 and v2
    interlaced; v0/v1 use the Table 5.1.4-1 column permutation, v2 the
    shifted map pi(k) = (P[k/R] + 32 (k % R) + 1) mod KP."""
    R = -(-D // NCOLS)
    KP = R * NCOLS
    ND = KP - D
    v01 = np.empty(KP, np.int32)
    r = np.arange(R)
    for j, c in enumerate(TURBO_SUBBLOCK_PERM):
        v01[j * R:(j + 1) * R] = r * NCOLS + c - ND
    v01[v01 < 0] = -1
    v01_f = v01.copy()
    v01_f[(v01_f >= 0) & (v01_f < F)] = -1
    k = np.arange(KP)
    perm = np.asarray(TURBO_SUBBLOCK_PERM, np.int64)
    pi = (perm[k // R] + NCOLS * (k % R) + 1) % KP
    v2 = (pi - ND).astype(np.int32)
    v2[v2 < 0] = -1

    def tag(v, stream):
        out = v.copy()
        out[out >= 0] += stream * D
        return out

    w = np.empty(3 * KP, np.int32)
    w[:KP] = tag(v01_f, 0)
    w[KP::2] = tag(v01_f, 1)
    w[KP + 1::2] = tag(v2, 2)
    return w


@functools.lru_cache(maxsize=None)
def _turbo_ratematch_indices_cached(D: int, E: int, rv: int,
                                    Ncb: int | None, F: int) -> np.ndarray:
    R = -(-D // NCOLS)
    Kw = 3 * R * NCOLS
    Ncb = Kw if Ncb is None else min(Ncb, Kw)
    w = _turbo_w_map(D, F)[:Ncb]
    k0 = R * (2 * (-(-Ncb // (8 * R))) * rv + 2)
    sel = w[(k0 + np.arange(Ncb)) % Ncb]
    sel = sel[sel >= 0]
    if sel.size == 0:
        raise ValueError("soft buffer holds no transmittable bits")
    return np.tile(sel, -(-E // sel.size))[:E].astype(np.int32)


def turbo_ratematch_indices(D: int, E: int, rv: int = 0,
                            Ncb: int | None = None, F: int = 0) -> np.ndarray:
    """Bit-selection source indices of one turbo-coded block: int32 [E],
    the flat sources (stream D + k) of the sent bits in order (start at
    k0 = R (2 ceil(Ncb / 8R) rv + 2), wrap modulo Ncb, skip <NULL>s).  A
    fresh copy of the cached map."""
    return _turbo_ratematch_indices_cached(D, E, rv, Ncb, F).copy()


@functools.lru_cache(maxsize=64)
def _index_tensor(D: int, E: int, rv: int, Ncb, F: int,
                  device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_turbo_ratematch_indices_cached(D, E, rv, Ncb, F),
                           dtype=torch.long, device=device)


def rate_match_turbo(d, E: int, rv: int = 0, Ncb: int | None = None,
                     F: int = 0, device=None) -> torch.Tensor:
    """Rate-match turbo streams d [..., 3, D] to E bits: one gather."""
    d = as_tensor(d, device=device)
    D = d.shape[-1]
    flat = d.reshape(d.shape[:-2] + (3 * D,))
    return torch.index_select(flat, -1,
                              _index_tensor(D, E, rv, Ncb, F, d.device))


def derate_match_turbo(llrs, D: int, rv: int = 0, Ncb: int | None = None,
                       F: int = 0, qmax: int | None = None,
                       filler_llr: int = 0, device=None) -> torch.Tensor:
    """Invert `rate_match_turbo` on received LLRs [..., E]: int32
    [..., 3, D].  Repeated copies of a coded bit add (chase combining),
    never-sent positions stay 0, `qmax` clips the combined LLRs, and the
    F filler positions of streams 0 and 1 (known zeros) get
    `filler_llr`."""
    llrs = as_tensor(llrs, torch.int32, device)
    E = llrs.shape[-1]
    idx = _index_tensor(D, E, rv, Ncb, F, llrs.device)
    flat = torch.zeros(llrs.shape[:-1] + (3 * D,), dtype=torch.int32,
                       device=llrs.device)
    flat.index_add_(-1, idx, llrs)
    if qmax is not None:
        flat = torch.clamp(flat, -qmax, qmax)
    if F:
        flat[..., :F] = filler_llr                 # stream 0
        flat[..., D:D + F] = filler_llr            # stream 1
    return flat.reshape(llrs.shape[:-1] + (3, D))


# ---------------------------------------------------------------------------
# 5.1.2: code block segmentation.

def segment_sizes(B: int) -> tuple[int, int, int, int, int]:
    """(C, Kp, Km, Cp, Cm) of a B-bit segmentation input: C blocks, Cp of
    size Kp and Cm of size Km (B' includes the per-block CRC24B only when
    C > 1)."""
    if B < 1:
        raise ValueError("B must be positive")
    if B <= Z_MAX:
        C, Bp = 1, B
    else:
        C = -(-B // (Z_MAX - 24))
        Bp = B + 24 * C
    sizes = LTE_BLOCK_SIZES
    kp_i = bisect.bisect_left(sizes, -(-Bp // C))
    if kp_i >= len(sizes):
        raise ValueError("block too large for the size table")
    Kp = sizes[kp_i]
    if C == 1:
        return 1, Kp, 0, 1, 0
    Km = sizes[kp_i - 1] if kp_i > 0 else 0
    Cm = (C * Kp - Bp) // (Kp - Km) if Km else 0
    return C, Kp, Km, C - Cm, Cm


def _segment_layout(B: int) -> tuple[list[int], int]:
    """Per-block sizes in transmission order (the Cm smaller blocks first)
    and the filler count F: the one source of the layout for both
    `segment_tb` and `dlsch_block_sizes`."""
    C, Kp, Km, Cp, Cm = segment_sizes(B)
    F = Cm * Km + Cp * Kp - (B + (24 * C if C > 1 else 0))
    return [Km] * Cm + [Kp] * Cp, F


def segment_tb(bits):
    """Segment a transport block (TB CRC attached) into code blocks:
    (blocks, F), a list of C uint8 numpy arrays (fillers prepended to the
    first, CRC24B appended to each when C > 1) and the filler count."""
    bits = np.asarray(bits, np.uint8).reshape(-1)
    sizes, F = _segment_layout(bits.size)
    C = len(sizes)
    blocks, pos = [], 0
    for c, K in enumerate(sizes):
        take = (K - 24 if C > 1 else K) - (F if c == 0 else 0)
        seg = bits[pos:pos + take]
        pos += take
        if c == 0:
            seg = np.concatenate([np.zeros(F, np.uint8), seg])
        if C > 1:
            seg = crc_append(CRC24B, torch.from_numpy(seg)).numpy()
        blocks.append(seg)
    assert pos == bits.size
    return blocks, F


def desegment_tb(blocks, F: int) -> np.ndarray:
    """Invert `segment_tb`: strip the fillers and the per-block CRC24B."""
    C = len(blocks)
    out = []
    for c, b in enumerate(blocks):
        b = np.asarray(b, np.uint8)
        if C > 1:
            b = b[:-24]
        if c == 0:
            b = b[F:]
        out.append(b)
    return np.concatenate(out)


# ---------------------------------------------------------------------------
# 5.1: the DL-SCH transport-block chain; the same-shaped code blocks of a
# TB encode and decode in one batched call.

def dlsch_block_sizes(A: int) -> tuple[list[int], int]:
    """Per-block sizes (transmission order) and F for an A-bit payload
    (CRC24A appended before segmentation)."""
    return _segment_layout(A + 24)


def dlsch_rate_match_sizes(G: int, C: int, n_l: int = 1,
                           qm: int = 2) -> list[int]:
    """E per code block for G channel bits (36.212 5.1.4.1.2)."""
    unit = n_l * qm
    if G % unit:
        raise ValueError("G must be a multiple of N_L * Q_m")
    Gp = G // unit
    gamma = Gp % C
    return [unit * (Gp // C) if k <= C - gamma - 1 else unit * (-(-Gp // C))
            for k in range(C)]


def _dlsch_groups(sizes: list[int], Es: list[int], F: int) -> dict:
    """Block indices grouped by identical (L, E, F): one call each."""
    groups: dict = {}
    for c, (L, E) in enumerate(zip(sizes, Es)):
        groups.setdefault((L, E, F if c == 0 else 0), []).append(c)
    return groups


def lte_dlsch_encode(payload, G: int, rv: int = 0, n_l: int = 1,
                     qm: int = 2, rsc: RscSpec = RscSpec(),
                     device=None) -> torch.Tensor:
    """The 5.1 transmit chain of one transport block: payload [A] -> CRC24A
    -> segmentation -> one `lte_turbo_encode_batch` per block shape ->
    concatenation.  Returns uint8 [G] channel bits on `device`."""
    # Segmentation is host-side numpy: the payload comes to the CPU.
    payload = torch.as_tensor(payload, dtype=torch.uint8).cpu()
    blocks, F = segment_tb(crc_append(CRC24A, payload).numpy())
    Es = dlsch_rate_match_sizes(G, len(blocks), n_l, qm)
    outs: list = [None] * len(blocks)
    for (L, E, Fk), idxs in _dlsch_groups([b.size for b in blocks], Es,
                                          F).items():
        batch = np.stack([blocks[i] for i in idxs])
        tx = lte_turbo_encode_batch(batch, E, rv=rv, rsc=rsc, F=Fk,
                                    device=device)
        for j, i in enumerate(idxs):
            outs[i] = tx[j]
    return torch.cat(outs, dim=-1)


def lte_dlsch_decode(llrs, A: int, rv: int = 0, n_iters: int = 6,
                     n_l: int = 1, qm: int = 2, rsc: RscSpec = RscSpec(),
                     qmax: int | None = 31, use_kernel: bool | None = None,
                     device=None):
    """Receive chain of one transport block ([G] LLRs) or a batch
    ([Bt, G]): split per 5.1.5 / 5.1.4.1.2, decode every same-shaped code
    block in one `lte_turbo_decode`, check the per-block CRC24B (C > 1),
    reassemble, check and strip CRC24A.

    Returns (payload uint8 [..., A], tb_ok bool [...], block_ok bool
    [..., C]); `tb_ok` is the CRC24A verdict AND every block's CRC24B."""
    llrs = as_tensor(llrs, torch.int32, device)
    squeeze = llrs.dim() == 1
    if squeeze:
        llrs = llrs[None]
    lead = llrs.shape[:-1]
    G = llrs.shape[-1]
    sizes, F = dlsch_block_sizes(A)
    C = len(sizes)
    Es = dlsch_rate_match_sizes(G, C, n_l, qm)
    offs = np.concatenate([[0], np.cumsum(Es)])
    dec_blocks: list = [None] * C
    for (L, E, Fk), idxs in _dlsch_groups(sizes, Es, F).items():
        chunk = torch.stack([llrs[..., offs[i]:offs[i] + E] for i in idxs],
                            dim=-2)                        # [..., n, E]
        bits, _ = lte_turbo_decode(chunk.reshape(-1, E), L, rv=rv,
                                   n_iters=n_iters, rsc=rsc, qmax=qmax,
                                   F=Fk, use_kernel=use_kernel)
        bits = bits.reshape(lead + (len(idxs), L))
        for j, i in enumerate(idxs):
            dec_blocks[i] = bits[..., j, :]
    if C > 1:
        block_ok = torch.stack([crc_check(CRC24B, b) for b in dec_blocks],
                               dim=-1)
        dec_blocks = [b[..., :-24] for b in dec_blocks]
    else:
        block_ok = torch.ones(lead + (1,), dtype=torch.bool,
                              device=llrs.device)
    dec_blocks[0] = dec_blocks[0][..., F:]
    tb = torch.cat(dec_blocks, dim=-1)                     # [..., A + 24]
    tb_ok = crc_check(CRC24A, tb) & torch.all(block_ok, dim=-1)
    payload = tb[..., :A]
    if squeeze:
        payload, tb_ok, block_ok = payload[0], tb_ok[0], block_ok[0]
    return payload, tb_ok, block_ok


# ---------------------------------------------------------------------------
# The one-call transport-channel chain of code blocks.

def lte_turbo_encode(bits, E: int, rv: int = 0, rsc: RscSpec = RscSpec(),
                     Ncb: int | None = None, F: int = 0) -> np.ndarray:
    """Encode one code block (its length in `LTE_BLOCK_SIZES`) to E
    channel bits with the numpy encoder: uint8 numpy [E].  The F filler
    positions are <NULL> for bit selection and never sent."""
    bits = np.asarray(bits, np.uint8)
    d = turbo_mux_streams(turbo_encode_np(rsc, bits, lte_qpp(bits.size)))
    idx = turbo_ratematch_indices(d.shape[-1], E, rv, Ncb, F)
    return d.reshape(-1)[idx].astype(np.uint8)


def lte_turbo_encode_batch(bits, E: int, rv: int = 0,
                           rsc: RscSpec = RscSpec(), Ncb: int | None = None,
                           F: int = 0, device=None) -> torch.Tensor:
    """Batched transmit chain: [B, L] bits -> uint8 [B, E] channel bits
    (the block-Toeplitz encode of both constituents, the tail multiplex,
    the rate-matching gather).  L must be in `LTE_BLOCK_SIZES`."""
    bits = as_tensor(bits, torch.uint8, device)
    d = turbo_mux_streams(turbo_encode_batch(rsc, bits,
                                             lte_qpp(bits.shape[-1])))
    return rate_match_turbo(d, E, rv, Ncb, F).to(torch.uint8)


def _receive_fields(llrs, L: int, rv: int, Ncb, qmax, F: int, device):
    """(the seven decoder fields, the interleaver, squeeze) of received
    LLRs [E] or [B, E]: de-rate-matching with the fillers at +qmax, the
    tail demultiplex."""
    llrs = as_tensor(llrs, torch.int32, device)
    squeeze = llrs.dim() == 1
    if squeeze:
        llrs = llrs[None]
    d = derate_match_turbo(llrs, L + 4, rv, Ncb, F=F, qmax=qmax,
                           filler_llr=0 if qmax is None else qmax)
    return turbo_demux_tails(d), lte_qpp(L), squeeze


def _map_route(rsc: RscSpec, use_kernel: bool | None):
    """The constituent MAP of a decode: the kernel's wrapper (its plain
    version on a CPU tensor) unless `use_kernel` is False or the kernel
    does not take `rsc`."""
    from ..kernels.turbo import (rsc_maxlogmap_batch_kernel,
                                 turbo_kernel_supported)
    if use_kernel is None:
        use_kernel = turbo_kernel_supported(rsc)
    return rsc_maxlogmap_batch_kernel if use_kernel else rsc_maxlogmap


def lte_turbo_decode(llrs, L: int, rv: int = 0, n_iters: int = 6,
                     rsc: RscSpec = RscSpec(), Ncb: int | None = None,
                     qmax: int | None = 31, F: int = 0,
                     use_kernel: bool | None = None, device=None):
    """Decode received LLRs [E] or [B, E] (positive favours 0) back to L
    bits: de-rate-matching (chase combining), tail demultiplex, `n_iters`
    max-log-MAP exchanges.  Returns (uint8 bits [..., L], int32
    a-posteriori LLRs [..., L])."""
    fields, perm, squeeze = _receive_fields(llrs, L, rv, Ncb, qmax, F,
                                            device)
    bits, lapp = decode_fixed(_map_route(rsc, use_kernel), rsc, fields, perm,
                              n_iters)
    return (bits[0], lapp[0]) if squeeze else (bits, lapp)


def lte_turbo_decode_early(llrs, L: int, crc=None, rv: int = 0,
                           max_iters: int = 8, rsc: RscSpec = RscSpec(),
                           Ncb: int | None = None, qmax: int | None = 31,
                           F: int = 0, use_kernel: bool | None = None,
                           device=None):
    """Batched receive chain with CRC-gated early termination: as
    `lte_turbo_decode`, but the exchanges stop once every block's CRC
    passes (or at `max_iters`); see `kernels.turbo
    .turbo_decode_batch_kernel_early`.

    `crc` must be the CRC the decoded block carries in its last 24 bits:
    the default CRC24B matches the code blocks of a segmented (C > 1)
    transport block; a single-block transport block carries only CRC24A.
    Returns (bits [..., L], lapp [..., L], ok bool [...], iterations
    used, an int)."""
    crc = crc or CRC24B
    fields, perm, squeeze = _receive_fields(llrs, L, rv, Ncb, qmax, F,
                                            device)
    bits, lapp, ok, iters = decode_early(_map_route(rsc, use_kernel), rsc,
                                         fields, perm, crc, max_iters)
    if squeeze:
        return bits[0], lapp[0], ok[0], iters
    return bits, lapp, ok, iters
