"""Eb/N0 BER and BLER curve runners over real AWGN/BPSK.

Port of `convolutionalencdec_tpu/harness/curve.py`.  The reference
codebase's berCurveCoded.m plots analytic hard and soft expectations
(berCurveCoded.m:46-51); these runners measure the paths end to end
(encode -> BPSK -> AWGN -> LLR -> [quantize | slice] -> decode), one JSON
line per point:

  * `run_curve`: hard and soft coded BER through `viterbi_decode_batch` /
    `viterbi_decode_batch_soft`, on whichever route the code takes (for a
    rate-1/5 or lower K = 7 code: the single-pass kernel);
  * `run_bler_curve_tbcc`: the CRC-aided tail-biting list decode against
    the plain wrap decode, with the CRC false-accept rate;
  * `run_bler_curve_turbo`, `run_harq_ir_turbo`, `run_turbo_acceptance`:
    the LTE turbo chain, HARQ incremental redundancy against chase
    combining, and the statistical gate against `TURBO_EXPECTED`.

Everything runs on `device` (default the CUDA card) through the batched
kernel entries: on the card their CUDA kernels, on a CPU their plain
versions.  Each point draws its messages and noise from a
`torch.Generator` seeded with `seed`, whose numbers are not `jax.random`'s:
the curves agree with the JAX package's statistically.

    python -m convolutionalencdec_tpu_torch.harness.curve [--tbcc|--turbo|--harq] [Eb/N0 ...]
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from .._device import resolve
from ..kernels.decode import viterbi_decode_batch, viterbi_decode_batch_soft
from ..ops.channel import (awgn, bits_to_segments, bpsk_llr, bpsk_modulate,
                           hard_decision, segments_to_bits)
from ..ops.encode import encode_bits
from ..ops.metrics import quantize_llrs
from ..params import NASA_K7, CodeSpec
from .ber import random_bits


def _channel(x_bits, ebn0_db: float, rate: float, generator, qmax=None):
    """BPSK over AWGN: (float LLRs, their int32 quantization at `qmax`)."""
    rx = awgn(bpsk_modulate(x_bits), ebn0_db, rate, generator=generator)
    llr = bpsk_llr(rx, ebn0_db, rate)
    q = quantize_llrs(llr) if qmax is None else quantize_llrs(llr, qmax=qmax)
    return llr, q


def _curve_batch(spec: CodeSpec, generator, n_packets: int, packet_bits: int,
                 ebn0_db: float, device):
    """One batch: (hard bit errors, soft bit errors, bits), the errors as
    tensors on the device."""
    msgs = random_bits(generator, (n_packets, packet_bits), device)
    coded, _ = encode_bits(spec, msgs)
    llr, q = _channel(segments_to_bits(coded, spec.n), ebn0_db, spec.rate,
                      generator)
    hard_segs = bits_to_segments(hard_decision(llr), spec.n)
    q = q.reshape(n_packets, -1, spec.n).to(torch.int8)
    hard_err = (viterbi_decode_batch(spec, hard_segs) != msgs).sum()
    soft_err = (viterbi_decode_batch_soft(spec, q) != msgs).sum()
    return hard_err, soft_err, msgs.numel()


def _emit(point: dict, verbose: bool) -> dict:
    if verbose:
        print(json.dumps(point), flush=True)
    return point


def run_curve(spec: CodeSpec = NASA_K7, ebn0_points=None, *,
              n_packets: int = 2000, packet_bits: int = 2048,
              batch: int = 500, seed: int = 1, verbose: bool = True,
              device=None):
    """Measure hard and soft coded BER across Eb/N0 points.

    Returns a list of dicts (one per point): ebn0_db, hard_ber, soft_ber,
    bits.
    """
    device = resolve(device)
    if ebn0_points is None:
        ebn0_points = [0.0, 1.0, 2.0, 3.0, 4.0, 5.0, 6.0]
    results = []
    for ebn0 in ebn0_points:
        gen = torch.Generator(device=device).manual_seed(seed)
        h_err = s_err = 0
        total = done = 0
        while done < n_packets:
            nb = min(batch, n_packets - done)
            he, se, tot = _curve_batch(spec, gen, nb, packet_bits, ebn0,
                                       device)
            h_err, s_err = h_err + he, s_err + se
            total += tot
            done += nb
        results.append(_emit({
            "ebn0_db": ebn0,
            "hard_ber": int(h_err) / total,
            "soft_ber": int(s_err) / total,
            "bits": total,
        }, verbose))
    return results


def _tbcc_bler_batch(spec: CodeSpec, crc, generator, n_packets: int,
                     payload_bits: int, list_size: int, ebn0_db: float,
                     device):
    """One TBCC batch: (plain block errors, list block errors, false
    accepts, n), the counts as tensors on the device."""
    from ..kernels.tailbiting import (viterbi_decode_batch_tailbiting_crc_soft,
                                      viterbi_decode_batch_tailbiting_soft)
    from ..ops.crc import crc_append
    from ..ops.tailbiting import encode_tailbiting
    payload = random_bits(generator, (n_packets, payload_bits), device)
    msgs = crc_append(crc, payload)
    coded = encode_tailbiting(spec, msgs)
    _, q = _channel(segments_to_bits(coded, spec.n), ebn0_db, spec.rate,
                    generator)
    q = q.reshape(n_packets, -1, spec.n).to(torch.int8)
    plain = viterbi_decode_batch_tailbiting_soft(spec, q)
    out, ok, _ = viterbi_decode_batch_tailbiting_crc_soft(spec, crc, q,
                                                         list_size)
    plain_blk = (plain != msgs).any(dim=1)
    list_blk = (out != msgs).any(dim=1)
    false_acc = ok & list_blk      # CRC passed but the block is wrong
    return plain_blk.sum(), list_blk.sum(), false_acc.sum(), n_packets


def run_bler_curve_tbcc(spec: CodeSpec = None, crc=None, ebn0_points=None,
                        *, n_packets: int = 4096, payload_bits: int = 104,
                        list_size: int = 8, batch: int = 1024,
                        seed: int = 7, verbose: bool = True, device=None):
    """Measured block-error curve of the CRC-aided tail-biting list decode
    against the plain soft wrap decode, on short LTE-control-channel-style
    blocks over AWGN/BPSK (default LTE_TBCC_K7 + CRC16_CCITT), with the CRC
    false-accept rate (passing candidates that are wrong blocks).

    Returns a list of dicts, one per Eb/N0 point.
    """
    from ..ops.crc import CRC16_CCITT
    from ..params import LTE_TBCC_K7
    device = resolve(device)
    spec = spec or LTE_TBCC_K7
    crc = crc or CRC16_CCITT
    if ebn0_points is None:
        ebn0_points = [0.0, 1.0, 2.0, 3.0]
    results = []
    for ebn0 in ebn0_points:
        gen = torch.Generator(device=device).manual_seed(seed)
        pb = lb = fa = 0
        total = done = 0
        while done < n_packets:
            nb = min(batch, n_packets - done)
            p, l_, f, n_ = _tbcc_bler_batch(spec, crc, gen, nb, payload_bits,
                                            list_size, ebn0, device)
            pb, lb, fa = pb + p, lb + l_, fa + f
            total += n_
            done += nb
        results.append(_emit({
            "ebn0_db": ebn0,
            "plain_bler": int(pb) / total,
            "crc_list_bler": int(lb) / total,
            "false_accept": int(fa) / total,
            "blocks": total,
        }, verbose))
    return results


def _turbo_bler_batch(generator, n_blocks: int, L: int, E: int, n_iters: int,
                      ebn0_db: float, use_kernel: bool | None, device):
    """One turbo batch over AWGN/BPSK: (bit errors, block errors, false
    accepts, n).  Eb/N0 is per message bit at code rate L/E, CRC24B counted
    as payload.  (A block equal to its message always passes its CRC, so
    "CRC rejects a correct block" cannot happen here.)"""
    from ..ops.crc import CRC24B, crc_append, crc_check
    from ..ops.lte import lte_turbo_decode, lte_turbo_encode_batch
    payload = random_bits(generator, (n_blocks, L - 24), device)
    msgs = crc_append(CRC24B, payload)
    _, q = _channel(lte_turbo_encode_batch(msgs, E), ebn0_db, L / E,
                    generator, qmax=31)
    dec, _ = lte_turbo_decode(q, L, n_iters=n_iters, use_kernel=use_kernel)
    errs = dec != msgs
    blk = errs.any(dim=1)
    ok = crc_check(CRC24B, dec)
    return errs.sum(), blk.sum(), (ok & blk).sum(), n_blocks


def run_bler_curve_turbo(ebn0_points=None, *, L: int = 6144,
                         E: int | None = None, n_blocks: int = 2048,
                         batch: int = 256, n_iters: int = 6,
                         seed: int = 11, use_kernel: bool | None = None,
                         verbose: bool = True, device=None):
    """Measured BER/BLER curve of the LTE turbo chain over AWGN/BPSK:
    CRC24B payloads, the 36.212 encode, rate match and decode, CRC false
    accepts counted.  Defaults to the rate-1/3 L = 6144 mother code.
    `use_kernel` picks the constituent MAP (`ops.lte.lte_turbo_decode`;
    default the kernel).

    Returns a list of dicts, one per Eb/N0 point.
    """
    device = resolve(device)
    if E is None:
        E = 3 * (L + 4)
    if ebn0_points is None:
        ebn0_points = [0.0, 0.4, 0.8, 1.2]
    results = []
    for ebn0 in ebn0_points:
        gen = torch.Generator(device=device).manual_seed(seed)
        be = blk = fa = 0
        total = done = 0
        while done < n_blocks:
            nb = min(batch, n_blocks - done)
            b, k_, f, n_ = _turbo_bler_batch(gen, nb, L, E, n_iters, ebn0,
                                             use_kernel, device)
            be, blk, fa = be + b, blk + k_, fa + f
            total += n_
            done += nb
        results.append(_emit({
            "ebn0_db": ebn0,
            "ber": int(be) / (total * L),
            "bler": int(blk) / total,
            "false_accept": int(fa) / total,
            "blocks": total,
        }, verbose))
    return results


def _harq_batch(generator, n_blocks: int, L: int, E: int, rv_seq: tuple,
                n_iters: int, ebn0_db: float, use_kernel: bool | None,
                device):
    """One HARQ batch: per transmission count, block errors of incremental
    redundancy (the rv sequence) and of chase combining (rv 0 repeated).

    Returns (ir block errors [T], chase block errors [T], n).  Eb/N0 is per
    message bit per transmission, rate L/E.
    """
    from ..kernels.turbo import turbo_decode_batch_kernel
    from ..ops.crc import CRC24B, crc_append
    from ..ops.lte import (derate_match_turbo, lte_qpp, lte_turbo_encode_batch,
                           turbo_demux_tails)
    from ..ops.turbo import RscSpec, turbo_decode_batch
    rsc = RscSpec()
    payload = random_bits(generator, (n_blocks, L - 24), device)
    msgs = crc_append(CRC24B, payload)
    pi = lte_qpp(L)
    decode = (turbo_decode_batch if use_kernel is False
              else turbo_decode_batch_kernel)

    def block_errors(buf):
        fields = turbo_demux_tails(torch.clamp(buf, -255, 255))
        bits, _ = decode(rsc, *fields, pi, n_iters)
        return (bits != msgs).any(dim=1).sum()

    ir = torch.zeros((n_blocks, 3, L + 4), dtype=torch.int32, device=device)
    ch = torch.zeros_like(ir)
    ir_blk, ch_blk = [], []
    for rv in rv_seq:
        for mode, rv_t in (("ir", rv), ("ch", rv_seq[0])):
            tx = lte_turbo_encode_batch(msgs, E, rv=rv_t)
            _, q = _channel(tx, ebn0_db, L / E, generator, qmax=31)
            add = derate_match_turbo(q, L + 4, rv=rv_t)
            if mode == "ir":
                ir = ir + add
            else:
                ch = ch + add
        ir_blk.append(block_errors(ir))
        ch_blk.append(block_errors(ch))
    return torch.stack(ir_blk), torch.stack(ch_blk), n_blocks


def run_harq_ir_turbo(*, L: int = 1024, E: int | None = None,
                      ebn0_db: float = -4.5, rv_seq=(0, 2, 3, 1),
                      n_blocks: int = 1024, batch: int = 256,
                      n_iters: int = 6, seed: int = 13,
                      use_kernel: bool | None = None, verbose: bool = True,
                      device=None):
    """Measured HARQ evidence: BLER against transmission count for 36.212
    incremental redundancy (redundancy versions `rv_seq` accumulated by
    `derate_match_turbo`) against chase combining (rv 0 repeated) at the
    same per-transmission Eb/N0.  Each transmission carries E bits
    (default 1.25 L, heavily punctured), so later rv rounds reveal fresh
    parity: the IR gain.

    Returns a list of dicts, one per transmission count.
    """
    device = resolve(device)
    if E is None:
        E = int(1.25 * L)
    ir = np.zeros(len(rv_seq), np.int64)
    ch = np.zeros(len(rv_seq), np.int64)
    total = done = 0
    gen = torch.Generator(device=device).manual_seed(seed)
    while done < n_blocks:
        nb = min(batch, n_blocks - done)
        i_, c_, n_ = _harq_batch(gen, nb, L, E, tuple(rv_seq), n_iters,
                                 ebn0_db, use_kernel, device)
        ir += i_.cpu().numpy()
        ch += c_.cpu().numpy()
        total += n_
        done += nb
    return [_emit({
        "tx_count": t + 1,
        "rv": list(rv_seq[:t + 1]),
        "ir_bler": float(ir[t] / total),
        "chase_bler": float(ch[t] / total),
        "ebn0_db_per_tx": ebn0_db,
        "blocks": total,
    }, verbose) for t in range(len(rv_seq))]


#: Turbo acceptance constants (berTestK7's pattern, berTestK7.c:95-100,
#: applied to the turbo chain): expected BER and BLER from the independent
#: C++ implementation (convolutionalencdec_tpu/native/turbo_oracle.cpp, its
#: own mt19937 generator; rate 1/3, E = 3L + 12, the qmax = 31 quantizer,
#: 6 max-log iterations with 3/4 extrinsic scaling), keyed by (L, ebn0_db).
#: Waterfall points: seed 9865, 20000 blocks at L = 1024 / 6000 at
#: L = 6144; the tail points (1024, 1.0) and (6144, 0.7) from campaigns of
#: >= 1100 block-error events each (262,143 blocks at L = 1024, 163,839 at
#: L = 6144), so the per-side BLER sampling error is ~3% and the 15% gate
#: means something at every point.
TURBO_EXPECTED = {
    (1024, 0.5): {"ber": 1.6995e-2, "bler": 0.2997},
    (1024, 1.0): {"ber": 1.0654e-4, "bler": 4.299e-3},
    (6144, 0.4): {"ber": 9.3565e-3, "bler": 0.6497},
    (6144, 0.7): {"ber": 7.901e-6, "bler": 6.824e-3},
}


def run_turbo_acceptance(points=((1024, 0.5), (6144, 0.4)), *,
                         n_blocks: int = 4096, batch: int = 512,
                         tolerance: float = 0.15, n_iters: int = 6,
                         seed: int = 11, use_kernel: bool | None = None,
                         verbose: bool = True, device=None):
    """Statistical acceptance of the turbo chain against `TURBO_EXPECTED`:
    the measured BER and BLER must fall within `tolerance` relative error
    (15%: block errors are burstier than the bit errors of berTestK7's
    10% gate).  `points` entries are (L, ebn0_db) or (L, ebn0_db,
    n_blocks), the latter sizing a tail point for enough error events.

    Returns a list of dicts with a `passed` flag per point.
    """
    results = []
    for point in points:
        (L, ebn0), nb = point[:2], (point[2] if len(point) > 2
                                    else n_blocks)
        exp = TURBO_EXPECTED[(L, ebn0)]
        pt = run_bler_curve_turbo(
            ebn0_points=[ebn0], L=L, n_blocks=nb, batch=batch,
            n_iters=n_iters, seed=seed, use_kernel=use_kernel,
            verbose=False, device=device)[0]
        rel_ber = abs(pt["ber"] - exp["ber"]) / exp["ber"]
        rel_bler = abs(pt["bler"] - exp["bler"]) / exp["bler"]
        pt.update(L=L, expected_ber=exp["ber"], expected_bler=exp["bler"],
                  rel_err_ber=rel_ber, rel_err_bler=rel_bler,
                  passed=bool(rel_ber <= tolerance
                              and rel_bler <= tolerance))
        results.append(_emit(pt, verbose))
    return results


if __name__ == "__main__":
    args = sys.argv[1:]
    which = args.pop(0) if args and args[0].startswith("--") else ""
    pts = [float(a) for a in args] or None
    if which == "--tbcc":
        run_bler_curve_tbcc(ebn0_points=pts)
    elif which == "--turbo":
        run_bler_curve_turbo(ebn0_points=pts)
    elif which == "--harq":
        run_harq_ir_turbo()
    else:
        run_curve(ebn0_points=pts)
