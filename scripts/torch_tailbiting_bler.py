#!/usr/bin/env python3
"""Block error rates of the port's tail-biting receive chain over seeds.

    python3 scripts/torch_tailbiting_bler.py [--seeds 1 2 3] [--blocks 16384]
                                             [--ebn0 2.0] [--device cuda]

DCI-sized blocks (LTE_TBCC_K7, 40-bit payload + CRC16, list 8), BPSK over
AWGN at the given Eb/N0 (rate 1/3), 3-bit LLRs: for each seed (payload and
noise drawn by a torch.Generator of that seed on the device) it prints the
wrap decode's BLER, the CRC-list chain's BLER, the blocks it rescued and the
false accepts (CRC passed, block wrong).  BLER is a property of the
algorithm and the channel, so any device gives the same numbers for a seed
up to the generator's stream.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    import torch
    sys.path.insert(0, str(ROOT))
    import convolutionalencdec_tpu_torch as fec
    parser = argparse.ArgumentParser()
    parser.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3])
    parser.add_argument("--blocks", type=int, default=16384)
    parser.add_argument("--ebn0", type=float, default=2.0)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    dev = torch.device(args.device)
    spec, crc = fec.LTE_TBCC_K7, fec.CRC16_CCITT
    B = args.blocks
    for seed in args.seeds:
        gen = torch.Generator(device=dev).manual_seed(seed)
        payload = torch.randint(0, 2, (B, 40), generator=gen, device=dev,
                                dtype=torch.uint8)
        blocks = fec.crc_append(crc, payload)
        cbits = fec.segments_to_bits(fec.encode_tailbiting(spec, blocks),
                                     spec.n)
        rx = fec.awgn(fec.bpsk_modulate(cbits), args.ebn0, spec.rate,
                      generator=gen)
        q = fec.quantize_llrs(fec.bpsk_llr(rx, args.ebn0, spec.rate))
        q = q.reshape(B, -1, spec.n).to(torch.int8)
        plain = fec.viterbi_decode_batch_tailbiting_soft(spec, q)
        bits, ok, _ = fec.viterbi_decode_batch_tailbiting_crc_soft(
            spec, crc, q, 8)
        plain_right = (plain == blocks).all(1)
        right = (bits == blocks).all(1)
        print(f"seed {seed}: {B} blocks at Eb/N0 {args.ebn0} dB on "
              f"{dev.type}: wrap decode BLER "
              f"{1 - plain_right.float().mean().item():.5f}, CRC-list BLER "
              f"{1 - right.float().mean().item():.5f}, rescued "
              f"{int((right & ~plain_right).sum())}, lost "
              f"{int((plain_right & ~right).sum())}, false accepts "
              f"{int((ok & ~right).sum())}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
