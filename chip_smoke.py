#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port once on one NVIDIA GPU, and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. environment: the card (nvidia-smi), torch's CUDA, nvcc;
  2. build: compile csrc/*.cu for sm_90a (one nvcc per source, in parallel)
     and print the build time and the compiler's register/spill report;
  3. kernel against plain version on the card, every kernel-route preset
     and a K=8 code at B = 37, L = 203, plus the smallest shapes:
     - hard: light (3%) and heavy (25%) segment corruption; decision words,
       final metrics, bytes and bits;
     - soft: LLRs drawn from +-7, full int8 with -128, +-1, and +-7 with 20%
       zeros, each at qclip 7 and 127; decision words, final metrics, also
       from carried and from all-zero initial metrics, and the soft entry
       points' bits and bytes;
     - ragged: lengths 0, 1, S, S+1, T and random ones, bytes and bits;
  4. hard main path at full size: bench.py's working set (NASA_K7,
     B = 2048 channels x L = 2048 bits, numpy seed 9865, 3% segment
     corruption), encoded on the card and decoded with
     `viterbi_decode_batch_bytes`; BER < 2e-3, bytes equal to the plain
     decode on the card, both kernels' launch counters > 0;
  5. soft main path at full size: the same messages, BPSK over AWGN at
     Eb/N0 = 3 dB (a seeded generator on the card), `bpsk_llr`,
     `quantize_llrs(qmax=7)`, `viterbi_decode_batch_soft_bytes`; bytes equal
     to the plain soft decode on the card, soft BER in [3e-4, 1.3e-3], the
     hard decode of the same received values at least 10x the soft BER,
     launches of the soft forward and the traceback > 0;
  6. ragged and punctured at full size: lengths uniform in [S+1, T]
     through `viterbi_decode_batch_soft_bytes_ragged` and
     `viterbi_decode_batch_bytes_ragged`, and PUNCTURE_3_4 through
     `viterbi_decode_batch_punctured_soft`; each equal to its plain route
     on the card, launches > 0, BER printed;
  7. streaming kernels against plain versions on the card, small sizes:
     `stream_k1_decode` (hard at 3% and 25%, soft on +-7, full int8 with
     -128 and 20% erasures; W = 2, 7, 32, 33, 35, 63, 64 on NASA_K7, one
     of them and 2 or 63 on the others; fresh and carried state; T = 1,
     T off every multiple of 8, B = 1) on NASA_K7, NASA_K7_R13 (NS = 64),
     a K=8 code (NS = 128) and K9_561_753 (NS = 256), and
     `traceback_k1_masked`
     with random start states and live steps 0, S, T - 1, T;
  8. streaming main path at full width: NASA_K7, B = 2048 packets of
     L = 2048 bits (T = 2054), W = 35, fed in 9 calls (8 x 256 steps, then
     6, the last holding the termination), hard (the segments of phase 4)
     and soft (the LLRs of phase 5), through `StreamingDecoderBatch` and
     `BlockStreamingDecoderBatch`; each equal to its plain route on the
     card, within the BER gates, launches of both new kernels > 0;
  9. times: median and minimum of 20 calls on distinct inputs, CUDA events,
     for each kernel (the stream kernel also at one 256-step call of the
     streaming feed, hard and soft), the whole hard and soft byte
     decodes, the soft and hard ragged and the punctured soft decodes of
     phase 6 and the whole
     9-call packet through each streaming class (also its wall time to the
     card's finish and the host's time to enqueue it), beside the plain
     version's time and the kernel's bound;
 10. tail-biting kernels against plain versions on the card, small sizes:
     `traceback_k1_multi` on NASA_K7, LTE_TBCC_K7, K9_561_753 and a K=8
     code (NW = 1, 2, 8, NS; live steps 0, S, T - 1, T; windows from step
     0, 3, 48, T - 56 and T - 1, from 3 also cut; T = 1, B = 1, B = 0), the
     soft forward without the -128 floor, and every tail-biting entry
     (wrap, bytes, soft, list, CRC, rate-matched) against its plain route
     at L = 20 (below the wrap), 131 (L % 8 != 0) and 203;
 11. tail-biting main path at full size: (a) LTE_TBCC_K7 DCI-sized blocks
     (40-bit payload + CRC16, B = 16384) over AWGN at Eb/N0 = 2 dB through
     the soft CRC-list chain (list 8) and, rate-matched to E = 288 channel
     bits, the rate-matched chain; equal to the plain route on the card,
     no block the wrap decode got right lost, CRC-list BLER <= the wrap
     decode's, the wrap decode's in [0.016, 0.030], false accepts <= 1e-3;
     (b) the tail-biting hard byte decode at bench.py's size (BER < 2e-3)
     and (c) its soft twin over AWGN at 3 dB (BER <= 1.3e-3), each equal to
     its plain route on the card; launches of K1, K4, K2m and K6 > 0; the
     wrap decode's K4 at (a)'s size against its plain version; times of K6,
     K2m and that K4 at (a)'s size, of each whole call, and (a)'s wall and
     host-enqueue times;
 12. max-log-MAP and turbo kernels against plain versions on the card,
     small sizes: `maxlogmap_k1` on NASA_K7, NASA_K7_R13, K9_561_753, a
     K=8 code and random codes at NS = 128 and 256 with n = 5..8 (T = S +
     1, 32, 48, 203 at B = 37; +-7, int8 with -128, 20% erasures;
     terminated and not; B = 1; and at the kernel's 32-step blocks and
     checkpoints: T = 1, S + 1, 31, 32, 33, 63, 64, 65 at B = 1 and 5 with
     those LLRs and with +-127 and -128 among 20% erasures, T = 2054 at
     B = 5), `turbo_rsc_map` at L = 40, 47, 61, 104,
     1024, 6144 (a-priori +-31 and +-4000), the LA_CLAMP contract case and
     B = 1, at its round edges (L = 1, 2, 7, 8, 9, 63, 64, 65, 2047; B = 5
     and 3) and on codes of 4 and 2 states and an 8-state code whose edges
     into a state carry one input (L = 47, 1024), and every new public entry (the turbo decodes fixed and early,
     `lte_turbo_decode(_early)`, `maxlogmap_llrs_batch_kernel` at L = 40
     and 104, `lte_dlsch_decode` of a two-block transport block) against
     its plain route;
 13. soft-output main paths at full size: (h) `maxlogmap_llrs_batch_kernel`
     on phase 5's LLRs (equal to the plain version on the card, sign BER in
     the soft window, share of bits off the soft Viterbi decode < 2.6e-3);
     (i) bench.py --turbo's serving point (2048 blocks of 1000 bits +
     CRC24B, E = 2056, AWGN at 2.0 dB, qmax 31) through
     `lte_turbo_decode_early` + `pack_bits`: bytes, bits, lapp, ok and the
     iteration count equal to the plain route on the card, no false
     accept, accept rate > 0.99, 3..8 iterations; a fixed 6-iteration
     `lte_turbo_decode` equal to its plain route; launches of both kernels
     > 0; times of both kernels, of (h), and of (i) with its wall and
     host-enqueue times;
 14. generic-k kernels against plain versions on the card, small sizes:
     `acs_generic_forward` and `traceback_generic` (and, on the k = 2,
     NS = 64 codes, their k2 instantiations) on TOY_K3, a K=3 k=2 code
     (NS = 16), an asymmetric K=7 code, the main-path codes below and the
     three codes of scripts/generic_k_pricing.py,
     at B = 37 with 3% and 25% segment corruption and on uniform garbage
     (tie-heavy), and at B = 1, at T = S + 1, and at a message length below
     the full one and not a multiple of 8: decision planes, final metrics,
     bits and bytes, and the public entries against the plain decode; the
     BER of each code's plain decode at 3%; the forward and the walk at
     every instantiation of their dispatch switches (the walk on random
     decision planes, which send its guesses wrong, and on the forward's;
     B = 1 and 2 CPW + 3; T = 1, S + 1, 31, 32, 33, 100, and 5,000 at
     B = 3; t_actual = T and T - 2; whole and cut messages; bits and
     bytes);
 15. generic-k main path at full width (B = 2048): the IEEE 802.11a
     rate-2/3 code as a k = 2 trellis (NS = 64, the k2 route, L = 2048),
     the K=9 (561, 753) code punctured to rate 2/3 as a k = 2 trellis
     (NS = 256) and the 802.11a rate-3/4 code as a k = 3 trellis (NS = 64;
     T = 512 each: the shapes of scripts/generic_k_pricing.py:45-51) and
     TOY_K3 (L = 2048), encoded on
     the card, 3% of the segments hit, through `viterbi_decode_batch_bytes`
     and `viterbi_decode_batch`; each equal to the plain decode on the card,
     BER < 0.1, launches of the route's kernels > 0; times of each kernel
     and each whole decode, and of the runtime-k kernels on the k2 code's
     input beside its instantiation;
 16. small and wide butterfly kernels against plain versions on the card,
     small sizes: random poly-symmetric codes at NS = 2, 4, 8, 16, 32 with
     n = 1..8 (`acs_small_forward`, `acs_soft_small_forward`, the one-word
     walks; soft n = 9 and 12 on the wide forward's runtime-n
     instantiation), at NS = 64 and 256 with n = 5..8 (K1, K4), at
     NS = 512, 1024, 4096, 16384 with n = 2..8 (`acs_wide_forward`,
     `acs_soft_wide_forward`, `traceback_wide`, `_ragged`; soft n = 9);
     noisy and garbage segments, four LLR draws; T = 1, S, S + 1, B = 1, 0;
     all four walks (`traceback_wide_masked`, `_multi` and the one-word
     ones) at NS = 16 and 16384; the hard wide forward's rounds at
     NS = 512, 2048, 8192 and 16384 for every T mod R and T < R (R from
     its dispatch switch), fresh and carried metrics, noisy and garbage
     segments; the soft wide forward's rounds at the same NS and T (R from
     its own switch), n = 1..8 in turn and an n = 9 code, noisy and
     garbage int8 LLRs (-128 included) under the three conditionings
     (clamps [-7, 7], [-127, 127], [-128, 127]), fresh and carried
     metrics; the four segment walks (`traceback_wide`, `_masked`,
     `_ragged`, `_multi`) at every line of their dispatch switch
     (NS = 512 ... 16384) on the forward's and on garbage words, B = 3,
     T = 1, 5, S + 5 and a window of 16-step segments less 5 at the 8
     warps a walk these launches take, terminated (t_actual = T, T - 2)
     and masked (live 0, S, T - 1, T; random starts), and on 8 rows
     ragged (lengths 0, 1, S, S + 1, T - 1, T, past T, negative) and list
     (NW = 1 from step 13, NW = 4 from T // 3 with live T - 9), whole and
     cut rows, bits and bytes; then over more than one window: 1025
     channels (one warp a walk, the main paths' launch shape) over three
     windows of the forward's and of garbage words, and 8 channels (8
     warps a walk) over two windows of garbage words, all four walks and
     the ragged edge lengths, the plain walks on 32 rows; the JAX names
     of the fused kernels
     (`kernels.fused`) at init_chunk 0, -1 and 1 against their plain routes
     and the block decode;
 17. small-state main path (k): K5_23_35 at bench.py's working set (B =
     2048 x L = 2048, 3% segment corruption, seed 9865): hard bytes (BER <
     5e-3), soft bytes over AWGN at 3 dB (qmax 7), ragged hard bytes; each
     equal to its plain route on the card, launches of the small kernels
     and the one-word walks > 0; at the end of the run (after the timing
     phases) the CUDA kernels of one call of each under torch.profiler:
     the hard, soft and ragged decodes' walk and a masked walk on (k)'s
     forward words are `narrow_walk_kernel`;
 18. wide main path (l): the K=15 rate-1/4 Galileo code (NS = 16384) at the
     same size: hard bytes (BER < 2e-3), soft bytes at 3 dB, the K11 names
     (hard forward + `traceback_batch_fused`, soft forward +
     `traceback_batch_fused_masked`), ragged hard bytes and the tail-biting
     list decode of 64 packets; each equal to its plain route on 64 rows
     (the list on 8), the ragged walk also with the edge lengths on its
     first rows and the list walk also with one walk a packet and from a
     step that is not a multiple of 8 (each walk over the whole batch, its
     launch shape on the path), launches of every wide kernel > 0; times
     of each kernel and decode (the ragged and list decodes too) at (k)
     (20 calls) and (l) (5 calls);
 19. the single-pass block decode (`block_decode_1p`, csrc/block_1p.cu)
     against its plain version on the card: random poly-symmetric codes at
     NS = 64, 128, 256 (n = 5..8 hard and soft, soft n = 9); the wide
     template's rounds at every line of its switch (NS = 512, 1024, 2048,
     4096): n = 1 ... 8 hard and soft at T = 1 ... 2R (every T mod R,
     T < R), S, S + 1 and the longest single-pass T, soft n = 9 (the
     barrier-a-step template) at R + 1 and the longest T; at NS = 64, 128,
     256 also the warp kernel's edges:
     T = 20, 31, 32, 33, 97 at B = 37 and 6, and the longest single-pass
     T (4080, 2016, 1008) with garbage segments of a random and of a
     catastrophic code (the walk's guesses wrong, counted); noisy and
     garbage segments, four LLR draws, bits and bytes of whole and cut
     messages; B = 1, 0; each case on the SINGLE_PASS route, each launch
     counted;
 20. single-pass main path (m): the rate-1/6 K = 7 code at bench.py's
     working set (3% segment corruption; AWGN at 3 dB, qmax 7) through
     `viterbi_decode_batch_bytes`, `viterbi_decode_batch` and
     `viterbi_decode_batch_soft_bytes`; each equal to its plain route on
     the card, K13 launched and K1/K4/K2 not; hard BER < 2e-3, the hard
     decisions of the 3 dB channel below the union bound (60 distances),
     soft below them; times of each decode and of K13 alone, hard and
     soft, and of K13 on (a)'s input (equal to (a)'s bytes) in turns with
     (a)'s two-pass decode;
 21. harness path (n): `run_curve` of that code at 0..3 dB (2048 packets,
     K13 in every hard and soft call) beside `bound_curve` (40 distances);
     berTestK7's acceptance run (`run_reference_ber_test`, NASA_K7, 65,536
     packets a point) within its 10% gate at all three points; one
     `bench_decode` tick; `kernel_traffic` at (a) and (m).
 22. the narrow walk (`traceback_k1` and `traceback_k1_masked` at
     NS = 2 ... 256: `narrow_walk_kernel`) against the plain walks on the
     card at every line of its dispatch switch: the forward's
     words of a random code's noisy packets, garbage words and a
     catastrophic code's words (below 64 states words whose decisions
     rotate the state, 10% of the steps garbage; its guesses wrong,
     counted), B = 37 over one to four windows (T = 1,
     5, 9, S + 3, G + 1, 32 G - 5, 32 G, 32 G + 1, 96 G + 37, 96 G + 38)
     and B = 1, terminated (t_actual T, T - 2) and masked (live 0, S,
     T - 1, T, random starts), whole and cut rows, bits and bytes, each
     launch counted;
     slices of a batch (odd and even T) and a base 4 bytes past a 16-byte
     line; at NS >= 64 the K11 names against their plain routes; the
     ragged walk (`traceback_k1_ragged`, the same kernel, each channel from
     its own top) on the same batches where T >= S (below 64 states the
     masked and ragged walks skip the noisy and garbage batches of four
     windows, whose plain walks took most of the phase's time), lengths
     0, 1, S,
     S + 1, T - 1, T, past T and negative, then random, rows of T - S
     bits and a cut one, bits and bytes, by the wrapper and by the C
     entry into rows first filled with 0xA5;
 23. the narrow soft forward (`acs_soft_k1_forward` at NS = 64, 128, 256,
     csrc/acs_soft_k1.cu) against its plain version on the card at every
     line of its dispatch, n = 1 ... 8 each: B = 37 at T = 0, 1, 31, 32,
     33, 192, 288, 2054 and B = 1 at T = 33, LLRs over the whole int8
     range, qclip 7 and 127 with the -127 floor and the -128 route, from
     the default start and from carried metrics; words and final metrics,
     each launch counted.  Phase 11 also holds it at (f)'s wrap decode
     and times it there;
 24. the small-state forward (`acs_small_forward` and
     `acs_soft_small_forward` at NS = 2, 4, 8, 16, 32, csrc/acs_small.cu)
     against its plain versions on the card at every line of its
     dispatch, n = 1 ... 8 hard and soft: B = 37 (no multiple of the
     channels a warp) at T = 0, 1, 31, 33 and, at n = 2, 2054, and B = 1
     at T = 33; noisy and garbage segments, LLRs over the whole int8 range
     at qclip 7 and 127 with the -127 floor and the -128 route; from the
     default start, and at two n an NS (one of each template) from carried
     metrics; words and final metrics, each launch counted;
 25. the hard narrow forward (`acs_k1_forward` at NS = 64, 128, 256, the
     hard entry of csrc/acs_soft_k1.cu's template) against its plain
     version on the card at every line of its dispatch, n = 1 ... 8: B = 37
     (no multiple of the 4 warps a block) at T = 0, 1, 31, 33 and, at
     n = 2 and 6, 2054, and B = 1 at T = 33; uniform segments; from the
     default start and from carried metrics; words and final metrics, each
     launch counted;
 26. the list walk (`traceback_k1_multi` at NS = 2 ... 256, the narrow
     walk's multi mode) against its plain version on the card at every
     line of its dispatch switch: noisy and garbage words at the
     tail-biting DCI trellis's 144 steps and garbage at S + 5 (B = 37),
     catastrophic-code (below 64 states rotating) words over two windows
     (B = 3), B = 1, and at NS >= 64 a base 4 bytes past a 16-byte line;
     NW = 1, 2, 8, NS; live 0, S, T - 1, T; windows from step 0, 3, 48,
     T - 56 and T - 1 to the end, and from 3 cut; bits and bytes; each
     launch counted;
 27. single-pass wide main path (o) (run after phase 20's times): the
     rate-1/5 K = 10 code of tests/test_torch_wide.py (NS = 512) at
     B = 2048 and its longest single-pass T, 480 steps (L = 471), 3%
     segment corruption and AWGN at 3 dB (qmax 7), through
     `viterbi_decode_batch_bytes` and `viterbi_decode_batch_soft_bytes`;
     each equal to its plain route and to `block_decode_1p_plain` on the
     card, K13 launched and the two-pass wide kernels not; hard BER
     < 2e-3, soft below the hard decisions of the same values; times of
     each decode and of K13's wide template alone, hard and soft, in turns
     with the two-pass wide kernels called directly on the same input.

The line before the last is one JSON object {"kernels": [...]}; the one
before it is the card's name and power limit; the last is {"ok": true,
"device": {"platform": "gpu", "kind": ..., "count": ...}}.  Uses torch and
numpy only.
"""

from __future__ import annotations

import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

KERNEL_PRESETS = ["NASA_K7", "REF_K7", "NASA_K7_R13", "LTE_TBCC_K7",
                  "K9_561_753"]
NOISE = [0.03, 0.25]
SMALL_B, SMALL_L = 37, 203
MAIN_B, MAIN_L, MAIN_SEED, MAIN_NOISE = 2048, 2048, 9865, 0.03
BER_LIMIT = 2e-3
EBN0_DB, QMAX = 3.0, 7
# RESULTS.md:84 measured 6.28e-4 for the 3-bit soft path and 3.10e-2 for
# the hard path at Eb/N0 = 3 dB: properties of the algorithm, not of a
# device.
SOFT_BER_WINDOW = (3e-4, 1.3e-3)
HARD_OVER_SOFT = 10.0
TIMED_CALLS = 20
# 0.1 s at 1.98 GHz: longer than the host takes to queue TIMED_CALLS calls
# of any function timed here (a streaming class's 9-call packet takes it
# about 3 ms), so that device times hold no gaps left by the host.
QUEUE_SLEEP_CYCLES = 200_000_000
KERNELS = ("acs_k1_forward", "traceback_k1", "acs_soft_k1_forward",
           "traceback_k1_ragged", "stream_k1_decode", "traceback_k1_masked",
           "traceback_k1_multi", "maxlogmap_k1", "turbo_rsc_map",
           "acs_generic_forward", "traceback_generic",
           "acs_generic_k2_forward", "traceback_generic_k2",
           "acs_small_forward", "acs_soft_small_forward", "traceback_k1 w1",
           "traceback_k1_ragged w1", "acs_wide_forward",
           "acs_soft_wide_forward", "traceback_wide", "traceback_wide_ragged",
           "traceback_wide_masked", "traceback_wide_multi",
           "block_decode_1p", "block_decode_1p wide")
# Rows of the kernels line that count one template of a C entry on the
# paths of one main path: row -> (the entry's launch key, the paths' prefix).
# The one-word (NS <= 32) walks' launches are the walk's at (k), whose code
# has 16 states; K13's wide template's are K13's at (o); the entry's own
# row counts the other paths.
SPLIT_ROWS = {"traceback_k1 w1": ("traceback_k1", "small "),
              "traceback_k1_ragged w1": ("traceback_k1_ragged", "small "),
              "block_decode_1p wide": ("block_decode_1p", "(o) ")}
SOURCES = {
    "acs_k1_forward": ("convolutionalencdec_tpu_torch/csrc/acs_soft_k1.cu",
                       "convolutionalencdec_tpu/kernels/acs_swar.py:847"),
    "traceback_k1": ("convolutionalencdec_tpu_torch/csrc/traceback_k1.cu",
                     "convolutionalencdec_tpu/kernels/acs_swar.py:877"),
    "acs_soft_k1_forward": (
        "convolutionalencdec_tpu_torch/csrc/acs_soft_k1.cu",
        "convolutionalencdec_tpu/kernels/acs_swar.py:1262 and :1381"),
    "traceback_k1_ragged": (
        "convolutionalencdec_tpu_torch/csrc/traceback_k1.cu",
        "convolutionalencdec_tpu/kernels/acs_swar.py:975"),
    "stream_k1_decode": (
        "convolutionalencdec_tpu_torch/csrc/stream_k1.cu",
        "convolutionalencdec_tpu/kernels/acs_pallas.py:1457 and :1524"),
    "traceback_k1_masked": (
        "convolutionalencdec_tpu_torch/csrc/traceback_k1.cu",
        "convolutionalencdec_tpu/kernels/acs_swar.py:920"),
    "traceback_k1_multi": (
        "convolutionalencdec_tpu_torch/csrc/traceback_k1.cu",
        "convolutionalencdec_tpu/kernels/acs_swar.py:655"),
    "maxlogmap_k1": (
        "convolutionalencdec_tpu_torch/csrc/maxlogmap_k1.cu",
        "convolutionalencdec_tpu/kernels/maxlogmap_pallas.py:328 and :347"),
    "turbo_rsc_map": (
        "convolutionalencdec_tpu_torch/csrc/turbo_rsc.cu",
        "convolutionalencdec_tpu/kernels/turbo_pallas.py:283 and :300"),
    "acs_generic_forward": (
        "convolutionalencdec_tpu_torch/csrc/acs_generic.cu",
        "convolutionalencdec_tpu/kernels/acs_pallas.py:2004"),
    "traceback_generic": (
        "convolutionalencdec_tpu_torch/csrc/acs_generic.cu",
        "convolutionalencdec_tpu/kernels/acs_pallas.py:2039"),
    "acs_generic_k2_forward": (
        "convolutionalencdec_tpu_torch/csrc/acs_generic.cu",
        "convolutionalencdec_tpu/kernels/acs_k2.py:345"),
    "traceback_generic_k2": (
        "convolutionalencdec_tpu_torch/csrc/acs_generic.cu",
        "convolutionalencdec_tpu/kernels/acs_k2.py:531"),
    "acs_small_forward": (
        "convolutionalencdec_tpu_torch/csrc/acs_small.cu",
        "convolutionalencdec_tpu/kernels/acs_pallas.py:271"),
    "acs_soft_small_forward": (
        "convolutionalencdec_tpu_torch/csrc/acs_small.cu",
        "convolutionalencdec_tpu/kernels/acs_pallas.py:489"),
    "traceback_k1 w1": (
        "convolutionalencdec_tpu_torch/csrc/traceback_k1.cu",
        "convolutionalencdec_tpu/kernels/acs_pallas.py:308"),
    "traceback_k1_ragged w1": (
        "convolutionalencdec_tpu_torch/csrc/traceback_k1.cu",
        "convolutionalencdec_tpu/kernels/acs_swar.py:975 (one-word "
        "instantiation; the JAX package scans NS < 64, "
        "acs_pallas.py:1708-1722)"),
    "acs_wide_forward": (
        "convolutionalencdec_tpu_torch/csrc/acs_wide.cu",
        "convolutionalencdec_tpu/kernels/acs_pallas.py:1004 and "
        "acs_swar.py:847 at NS >= 512"),
    "acs_soft_wide_forward": (
        "convolutionalencdec_tpu_torch/csrc/acs_wide.cu",
        "convolutionalencdec_tpu/kernels/acs_pallas.py:1134 and "
        "acs_swar.py:1262 at NS >= 512"),
    "traceback_wide": (
        "convolutionalencdec_tpu_torch/csrc/traceback_wide.cu",
        "convolutionalencdec_tpu/kernels/acs_pallas.py:1069 and "
        "acs_swar.py:877 at NS >= 512"),
    "traceback_wide_ragged": (
        "convolutionalencdec_tpu_torch/csrc/traceback_wide.cu",
        "convolutionalencdec_tpu/kernels/acs_swar.py:975 at NS >= 512"),
    "traceback_wide_masked": (
        "convolutionalencdec_tpu_torch/csrc/traceback_wide.cu",
        "convolutionalencdec_tpu/kernels/acs_pallas.py:1069 and "
        "acs_swar.py:920 at NS >= 512"),
    "traceback_wide_multi": (
        "convolutionalencdec_tpu_torch/csrc/traceback_wide.cu",
        "convolutionalencdec_tpu/kernels/acs_swar.py:655 at NS >= 512"),
    "block_decode_1p": (
        "convolutionalencdec_tpu_torch/csrc/block_1p.cu",
        "convolutionalencdec_tpu/kernels/acs_pallas.py:2174"),
    "block_decode_1p wide": (
        "convolutionalencdec_tpu_torch/csrc/block_1p.cu",
        "convolutionalencdec_tpu/kernels/acs_pallas.py:2174 (the wide "
        "template, NS 512-4096)"),
}
# Streaming: the comparison phase's presets and windows, the main path's
# window and feed (8 calls of 256 steps, then the 6 termination steps).
STREAM_PRESETS = ["NASA_K7", "NASA_K7_R13", "K9_561_753"]
STREAM_WINDOWS = (2, 7, 32, 33, 35, 63, 64)
# The windows every other code (NS = 64, 128, 256) is also held at, one a
# draw in turn (so each at hard and soft): the shortest and the longest but
# one (the walk back W - 1 steps through the kernel's ring of decisions,
# and into the carried registers).
STREAM_EDGE_WINDOWS = (2, 63)
MAIN_W = 35
STREAM_FEED = (256,) * 8 + (6,)
# Tail-biting: the comparison phase's presets and lengths (below the wrap,
# L % 8 != 0, the comparison size); the main path's DCI-sized blocks (LTE
# PDCCH: 40-bit payload + CRC16 on LTE_TBCC_K7, rate-matched to aggregation
# level 4 = 4 CCEs x 72 bits), list size, Eb/N0 and gates.
TB_PRESETS = ["NASA_K7", "LTE_TBCC_K7", "K9_561_753"]
TB_LENGTHS = (20, 131, SMALL_L)
TB_WINDOW = 48
DCI_PAYLOAD, DCI_B, DCI_LIST, DCI_E, DCI_EBN0 = 40, 16384, 8, 288, 2.0
# RESULTS_r03.md:64 measured a plain soft wrap BLER of 0.0226 and a CRC-list
# BLER of 0.0214 over 8192 such blocks at 2 dB: properties of the algorithm.
PLAIN_BLER_WINDOW = (0.016, 0.030)
FALSE_ACCEPT_LIMIT = 1e-3
# The wrappers the tail-biting entries call, and the block stream's.
TB_WRAPPERS = ("acs_forward_batch", "acs_forward_batch_soft",
               "traceback_batch_masked", "traceback_batch_multi")
BLOCK_STREAM_WRAPPERS = ("acs_forward_batch", "acs_forward_batch_soft",
                         "traceback_batch", "traceback_batch_masked")
# Max-log-MAP: the comparison phase's presets and lengths (T = S + 1, a
# chunk's 32 steps and two off a multiple of 32), and the main path's BER
# gate on the sign decisions (the soft window) and on the share of bits
# that differ from the soft Viterbi decode of the same LLRs: bitwise MAP
# and sequence ML err on the same bursts, not always on the same bits.
MAP_PRESETS = ["NASA_K7", "NASA_K7_R13", "K9_561_753"]
MAP_LENGTHS = (32, 48, 203)
# The kernel's edges: its steps run in unrolled blocks of 32, one a
# checkpoint, the last a loop (T around one and two blocks, one step);
# B = 1 and 5 (a block's warps partly empty); the n = 5..8 kernels at the
# larger NS; and the main path's T at B = 5.
MAP_EDGE_T = (1, 31, 32, 33, 63, 64, 65)
MAP_EDGE_B = (1, 5)
MAP_WIDE_NS = (128, 256)
MAP_VITERBI_DIFFER_LIMIT = 2.6e-3
# Turbo: the comparison phase's block lengths (every L mod 3, the largest
# LTE block), the serving point of bench.py --turbo (B code blocks of 1000
# payload bits + CRC24B = L, rate-matched to E = 2 (L + 4), BPSK over AWGN
# at 2.0 dB, qmax 31, CRC-gated early exit within 8 iterations) and its
# gates.  CURVES_EARLYTERM_r05.json records 6 iterations and accept rate
# 1.0 at this point: properties of the algorithm and the draw.
TURBO_LENGTHS = (40, 47, 61, 104, 1024, 6144)
# `turbo_rsc_map`'s edges: lengths around its 32-step rounds (the meeting
# point of the two walks on and off a round's edge), B = 3 (a partly empty
# warp), and codes of 4 and 2 states and an 8-state one whose edges into a
# state carry one input (its emit without the swap).
RSC_EDGE_LENGTHS = (1, 2, 7, 8, 9, 63, 64, 65, 2047)
RSC_SMALL_CODES = (("NS4", dict(K=3, g_fb=0o7, g_fw=0o5)),
                   ("NS2", dict(K=2, g_fb=0o3, g_fw=0o2)),
                   ("NS8_same_u", dict(K=4, g_fb=0o12, g_fw=0o15)))
RSC_SMALL_LENGTHS = (47, 1024)
TURBO_B, TURBO_L, TURBO_EBN0, TURBO_QMAX, TURBO_MAX_ITERS = (
    2048, 1024, 2.0, 31, 8)
TURBO_E = 2 * (TURBO_L + 4)
TURBO_ACCEPT_MIN = 0.99
TURBO_ITERS_WINDOW = (3, 8)
TURBO_FIXED_ITERS = 6
# Generic-k: the comparison phase's codes and message length in symbols,
# and the main path's codes with their message bits.  The main path takes
# the shapes that scripts/generic_k_pricing.py:45-51 priced (k = 2 with
# NS = 64 and 256, k = 3 with NS = 64; T = 512, the k = 2, NS = 64 one at
# L = 2048 instead, T = 1027) and TOY_K3 at L = 2048 (T = 2050).  The
# pricing script's generators are no codes to decode (the k = 3 one has
# n = k = 3, rate 1; the comparison phase prints their BER), so the main
# path decodes standard codes of the same K and k: a rate-1/2 mother code
# punctured with period k is a rate-k/n code whose register holds k new
# bits and the mother's K - 1 old ones.  Step p of the period (message bit
# p of the symbol) taps the mother's generator shifted left by p (CodeSpec's
# newest-first order), and the kept bits go out in the pattern's order
# (tests/test_torch_generic.py holds each code's encoder to the mother's,
# punctured):
#   k2_NS64:  NASA_K7 (133, 171) with PUNCTURE_2_3, the rate-2/3 mode of
#             IEEE 802.11a-1999 17.3.5.6 (sent A0 B0 A1);
#   k2_NS256: K9_561_753 (3GPP TS 25.212 4.2.3.1) with PUNCTURE_2_3;
#   k3_NS64:  NASA_K7 with PUNCTURE_3_4, 802.11a's rate 3/4 (A0 B0 A1 B2).
# The comparison phase holds the kernels to their plain versions on both
# sets.  The first code runs on the k2 route (its kernels count as K10),
# the others on the runtime-k kernels (K9); the kernels line reports K9 at
# GENERIC_K9_CODE.
GENERIC_SMALL_CODES = (
    ("TOY_K3", "TOY_K3"),
    ("K3k2", dict(K=3, k=2, g=(0o17, 0o06, 0o13))),
    ("K7_134_171", dict(K=7, g=(0o134, 0o171))),
    ("k2_NS64_pricing", dict(K=4, k=2, g=(0o64, 0o52, 0o71))),
    ("k2_NS256_pricing", dict(K=5, k=2, g=(0o1633, 0o1255, 0o1117))),
    ("k3_NS64_pricing", dict(K=3, k=3, g=(0o715, 0o663, 0o557))),
)
GENERIC_SMALL_SYMBOLS = 67
GENERIC_MAIN = (
    ("k2_NS64", dict(K=4, k=2, g=(0o133, 0o171, 0o266)), 2048),
    ("k2_NS256", dict(K=5, k=2, g=(0o561, 0o753, 0o1342)), (512 - 4) * 2),
    ("k3_NS64", dict(K=3, k=3, g=(0o133, 0o171, 0o266, 0o744)),
     (512 - 2) * 3),
    ("TOY_K3", "TOY_K3", 2048),
)
GENERIC_K9_CODE = "k2_NS256"
# tests/test_kernels.py:166's gate on these codes at 3% segment corruption.
GENERIC_BER_LIMIT = 0.1
# Small and wide butterfly codes: the comparison phase's state counts (n =
# 1..8 at the small ones, 5..8 at 64 and 256, 2..8 at the wide ones) and
# message lengths; the main paths' codes at bench.py's working set:
#   (k) K5_23_35 (NS = 16; K = 5 is GSM's speech and control channels'
#       constraint length), hard BER < 5e-3 (the plain decoder reads
#       1.75e-3 on 256 rows of this input on a CPU);
#   (l) the K = 15 rate-1/4 code of the Galileo experiment (Dolinar, "A New
#       Code for Galileo", TDA Progress Report 42-93, 1988), the widest a
#       deployed Viterbi decoder has read (NS = 16384), BER < 2e-3.  Its
#       plain route runs on WIDE_PLAIN_ROWS rows: the plain forward's
#       unpacked decisions take B x T x NS bytes (69 GB at B = 2048).
BFLY_SMALL_NS = (2, 4, 8, 16, 32)
BFLY_MID_NS = (64, 256)
BFLY_WIDE_NS = (512, 1024, 4096, 16384)
BFLY_SMALL_L, BFLY_WIDE_L = 61, 40
# The hard wide forward's round checks: these NS, T = WIDE_ROUND_M * R + j.
WIDE_ROUND_NS, WIDE_ROUND_M = (512, 2048, 8192, 16384), 10
SMALL_MAIN = "K5_23_35"
SMALL_BER_LIMIT = 5e-3
WIDE_MAIN = dict(K=15, g=(0o46321, 0o51271, 0o63667, 0o70535))
WIDE_BER_LIMIT = 2e-3
WIDE_PLAIN_ROWS = 64
# The wide walks' checks over more than one window hold the plain walks'
# result on this many rows of each batch.
WIDE_WINDOW_ROWS = 32
WIDE_LIST_B, WIDE_LIST_SIZE = 64, 4
WIDE_TIMED_CALLS = 5
# The wrappers the K11 names call.
FUSED_WRAPPERS = ("acs_forward_batch", "acs_forward_batch_soft",
                  "traceback_batch_masked")
# The single-pass block decode (TPU kernel K13, csrc/block_1p.cu): the
# comparison phase's state counts (n = 5..8 hard and soft, soft n = 9 too,
# at 64..256; n = 5..8 at 512..4096, at their longest single-pass T and at
# T = 1, S, S + 1) and the main path (m): the rate-1/6 K = 7 code (NS = 64,
# n = 6: the JAX package sends its block decodes to K13) at bench.py's
# working set, 16.5 KB of decisions per channel.  Its gates: the hard
# decode of the 3% segment channel below BER_LIMIT (bench.py's gate: the
# segment channel's flips are not independent bits, so no union bound
# covers it); the hard decisions of the 3 dB AWGN channel (a memoryless
# BSC of crossover Q(sqrt(2 R Eb/N0)), the union bound's own model) below
# the union bound summed over the first SP_GATE_DMAX distances (d_free is
# 30; a partial sum of positive terms, so stricter than the whole bound:
# the first 40 sum to 4.6e-3, below the 6.7e-3 a CPU run of the plain
# decoder measures there, the first 60 to 2.4e-2); the soft decode of the
# same values below that hard one.  The curve (n) prints bound_curve's
# 40-distance bounds beside each point.
SP_MID_NS = (64, 128, 256)
SP_MAIN = dict(K=7, g=(0o133, 0o171, 0o165, 0o117, 0o127, 0o155))
SP_MAIN_N = len(SP_MAIN["g"])
SP_DMAX = 40
SP_GATE_DMAX = 60
# (o): K13's wide template at its first main-path size: the rate-1/5
# K = 10 code of tests/test_torch_wide.py (NS = 512, n = 5: not a SWAR
# code, so the JAX package sends its short packets to K13) at B = 2048 and
# the longest single-pass T at NS = 512, 480 steps (L = 471); the same
# seed, channels and gates as (m).
SP_WIDE_MAIN = dict(K=10, g=(0o1167, 0o1545, 0o1337, 0o1071, 0o1423))
SP_WIDE_T = 480
# (n): the curve's points and size, and berTestK7's acceptance run: 2x the
# 30k packets the -3 dB point needs (RESULTS.md:12-21) at every point.
CURVE_POINTS = (0.0, 1.0, 2.0, 3.0)
CURVE_PACKETS = 2048
BER_TEST_PACKETS = 65536
# The card's peaks for the bound (H100 SXM; NVIDIA's data sheet and Hopper
# white paper): 3.35 TB/s of HBM, and int32 at 132 SMs x 64 INT32 lanes x
# 1.98 GHz boost = 16.7 T operations/s.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
ACS_OPS = 6        # per butterfly and step: 4 adds, 2 compare-selects
TRACEBACK_OPS = 4  # per step: bit select, shift, or, emit
# Stream decode beyond the ACS: per state and step a compare and a select
# of the argmin.  A step's symbol is bit W - 1 of the argmin state's
# register, that is the input W - 1 steps back along its survivor: a walk
# of W - 1 steps through the decisions at TRACEBACK_OPS a step (fewer
# operations than moving every state's register, 8 int32 operations a
# butterfly and step, once W - 1 < 2 NS: always, at W <= 64 and NS >= 64);
# and each call's registers out, W bits a state, a walk of W steps each.
ARGMIN_OPS = 2
# Max-log-MAP: three butterfly passes (forward, replay, beta) of ACS_OPS
# each, and per state and step an add and a min of the emit.  The RSC MAP:
# about 20 per state and step over its forward, replay and beta.
MAP_PASSES = 3
EMIT_OPS = 2
RSC_OPS = 20


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def corrupt(rng, coded, p, n):
    """bench.py's channel: each segment is hit with probability p by a
    nonzero XOR mask."""
    flip = rng.random(coded.shape) < p
    mask = flip * rng.integers(1, 1 << n, coded.shape)
    return coded ^ mask.astype(coded.dtype)


def encode_reference_np(spec, msgs):
    """Independent encoder for the check: walk the trellis tables."""
    import numpy as np
    from convolutionalencdec_tpu_torch.ops.trellis import (edge_coded_bits,
                                                           next_state_table)
    ec, ns = edge_coded_bits(spec), next_state_table(spec)
    bits = np.concatenate(
        [msgs, np.zeros((msgs.shape[0], spec.S), np.uint8)], axis=1)
    state = np.zeros(msgs.shape[0], np.int64)
    out = np.empty(bits.shape, np.uint8)
    for t in range(bits.shape[1]):
        out[:, t] = ec[bits[:, t], state]
        state = ns[bits[:, t], state]
    return out


def max_abs_diff(a, b) -> int:
    import torch
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def device_times(fn, inputs) -> list[float]:
    """Per-call device milliseconds: calls enqueued back to back with an
    event between each, one synchronise at the end.  The card first spins
    for QUEUE_SLEEP_CYCLES, so that the host has queued the calls before
    the card reaches them: a call shorter than its host work is then timed
    without the gaps the host would leave."""
    import torch
    for x in inputs[:3]:
        fn(x)
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(len(inputs) + 1)]
    torch.cuda._sleep(QUEUE_SLEEP_CYCLES)
    events[0].record()
    for i, x in enumerate(inputs):
        fn(x)
        events[i + 1].record()
    torch.cuda.synchronize()
    return [events[i].elapsed_time(events[i + 1]) for i in range(len(inputs))]


def time_once(fn):
    """(result, device milliseconds) of one call."""
    import torch
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    result = fn()
    end.record()
    torch.cuda.synchronize()
    return result, start.elapsed_time(end)


def launch_counters(acs):
    """Every kernel wrapper module's launch counts."""
    from convolutionalencdec_tpu_torch.kernels import (generic, maxlogmap,
                                                       single_pass, turbo)
    return (acs.LAUNCHES, maxlogmap.LAUNCHES, turbo.LAUNCHES,
            generic.LAUNCHES, single_pass.LAUNCHES)


def drive(acs, fn):
    """Run `fn` with every launch count set to 0 just before and read just
    after: (result, launches of that run)."""
    import torch
    torch.cuda.synchronize()
    counters = launch_counters(acs)
    for counts in counters:
        for key in counts:
            counts[key] = 0
    result = fn()
    torch.cuda.synchronize()
    return result, {k: v for counts in counters for k, v in counts.items()}


def cuda_kernel_names(fn) -> set:
    """The names of the CUDA kernels one call of `fn` runs, as
    torch.profiler records them (CUPTI)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = {e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA}
    require(bool(names), "the profiler recorded the call's kernels")
    return names


def ber_of_bytes(out, msgs, lengths=None) -> float:
    """Bit error rate of decoded bytes against the sent message bits; with
    lengths, only the live bits (t < t_b - S) of each row count."""
    import numpy as np
    got = np.unpackbits(out.cpu().numpy(), axis=1)[:, :msgs.shape[1]]
    if lengths is None:
        return float((got != msgs).mean())
    live = np.arange(msgs.shape[1])[None, :] < lengths[:, None]
    return float(((got != msgs) & live).sum() / live.sum())


def soft_channel(fec, spec, msgs_dev, generator, rate):
    """Encode on the card, BPSK over AWGN at EBN0_DB, channel LLRs: returns
    (segments [B, T], float32 LLRs [B, T * n]) on the card."""
    seg, _ = fec.encode_bits(spec, msgs_dev)
    symbols = fec.bpsk_modulate(fec.segments_to_bits(seg, spec.n))
    rx = fec.awgn(symbols, EBN0_DB, rate, generator=generator)
    return seg, fec.bpsk_llr(rx, EBN0_DB, rate)


def phase_environment(build):
    import torch
    card = nvidia_smi("name,power.limit")
    print(f"[env] nvidia-smi: {card}")
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"torch.version.cuda {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}")
    nvcc = build.find_nvcc()
    nvcc_version = subprocess.run([nvcc, "--version"], capture_output=True,
                                  text=True, check=True).stdout.strip()
    print(f"[env] nvcc {nvcc}: {nvcc_version.splitlines()[-1]}")
    print(f"[env] triton installed: "
          f"{importlib.util.find_spec('triton') is not None}; "
          f"jax installed: {importlib.util.find_spec('jax') is not None}")
    return card


def phase_build(build):
    t0 = time.perf_counter()
    seconds = build.build()
    build.library()
    print(f"[build] nvcc {seconds:.2f} s (0 when an up-to-date library was "
          f"reused), build+load "
          f"{time.perf_counter() - t0:.2f} s -> {build.LIBRARY}")
    for line in build.BUILD_LOG.read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"[build] {line.strip()}")


def compare_one(fec, acs, spec, seg, err, lengths):
    """Kernel against plain version on one batch of segments on the card:
    decision words, final metrics (also from carried initial metrics),
    and the traceback's bytes and bits for each message length."""
    import torch
    T = seg.shape[1]
    words, fm = acs.acs_forward_batch(spec, seg)
    words_p, fm_p = acs.acs_forward_batch_plain(spec, seg)
    require(torch.equal(words, words_p), f"{spec} decision words")
    require(torch.equal(fm, fm_p), f"{spec} final metrics")
    words2, fm2 = acs.acs_forward_batch(spec, seg, initial_metrics=fm)
    words2_p, fm2_p = acs.acs_forward_batch_plain(spec, seg, fm_p)
    require(torch.equal(words2, words2_p) and torch.equal(fm2, fm2_p),
            f"{spec} carried initial metrics")
    err["acs_k1_forward"] = max(
        err["acs_k1_forward"], max_abs_diff(words, words_p),
        max_abs_diff(fm, fm_p), max_abs_diff(words2, words2_p),
        max_abs_diff(fm2, fm2_p))
    for L in lengths:
        for out in ("bytes", "bits"):
            got = acs.traceback_batch(spec, words, T, L, out)
            want = acs.traceback_batch_plain(spec, words_p, T, L, out)
            require(torch.equal(got, want), f"{spec} L={L} decoded {out}")
            err["traceback_k1"] = max(err["traceback_k1"],
                                      max_abs_diff(got, want))
    bits = fec.viterbi_decode_batch(spec, seg)
    require(torch.equal(bits, fec.viterbi_decode(spec, seg)),
            f"{spec} viterbi_decode_batch")
    return words


def compare_ragged(acs, spec, words, err, rng, key="traceback_k1_ragged"):
    """`traceback_batch_ragged` against its plain version on one batch of
    decision words: lengths 0, 1, S, S+1, T and random ones (some past T,
    some negative: clamped), bytes and bits, full and cut row widths; the
    largest difference goes to err[key]."""
    import numpy as np
    import torch
    B, T, _ = words.shape
    edge = [0, 1, spec.S, spec.S + 1, T]
    lens = np.concatenate([edge, rng.integers(-3, T + 4, max(B - 5, 0))])[:B]
    lens = torch.from_numpy(lens.astype(np.int32)).to(words.device)
    for width in sorted({T - spec.S, max(T - spec.S - 13, 0)}):
        for out in ("bytes", "bits"):
            got = acs.traceback_batch_ragged(spec, words, lens, width, out)
            want = acs.traceback_batch_ragged_plain(
                spec, words, lens.clamp(0, T), width, out)
            require(torch.equal(got, want),
                    f"{spec} ragged {out} width {width}")
            err[key] = max(err[key], max_abs_diff(got, want))


def soft_draws(rng, shape):
    """The LLR distributions the soft kernel is held to."""
    import numpy as np
    pm7 = rng.integers(-7, 8, shape)
    return {
        "+-7": pm7,
        "int8": rng.integers(-128, 128, shape),
        "+-1": rng.choice(np.array([-1, 1]), shape),
        "+-7, 20% zeros": np.where(rng.random(shape) < 0.2, 0, pm7),
    }


def compare_soft(fec, acs, spec, q, qclip, err, key="acs_soft_k1_forward"):
    """Soft kernel against plain version on one batch of int8 LLRs: words,
    final metrics, carried and all-zero initial metrics; the largest
    difference goes to err[key]."""
    import torch
    words, fm = acs.acs_forward_batch_soft(spec, q, qclip)
    words_p, fm_p = acs.acs_forward_batch_soft_plain(spec, q, qclip)
    require(torch.equal(words, words_p) and torch.equal(fm, fm_p),
            f"{spec} soft words and final metrics, qclip {qclip}")
    zero = torch.zeros_like(fm)
    diffs = [max_abs_diff(words, words_p), max_abs_diff(fm, fm_p)]
    for init, init_p in ((fm, fm_p), (zero, zero)):
        w2, m2 = acs.acs_forward_batch_soft(spec, q, qclip, init)
        w2_p, m2_p = acs.acs_forward_batch_soft_plain(spec, q, qclip, init_p)
        require(torch.equal(w2, w2_p) and torch.equal(m2, m2_p),
                f"{spec} soft initial metrics, qclip {qclip}")
        diffs += [max_abs_diff(w2, w2_p), max_abs_diff(m2, m2_p)]
    err[key] = max(err[key], *diffs)
    return words


def phase_compare(fec, acs, dev, err):
    """Kernels against plain versions on the card: every kernel-route
    preset with B and L off every power of two, a K=8 code (the NS = 128
    instantiation), and the smallest shapes."""
    import numpy as np
    import torch
    rng = np.random.default_rng(2026)

    def noisy(spec, B, L, p):
        msgs = rng.integers(0, 2, (B, L), dtype=np.uint8)
        seg, _ = fec.encode_bits(spec, torch.from_numpy(msgs).to(dev))
        return torch.from_numpy(
            corrupt(rng, seg.cpu().numpy(), p, spec.n)).to(dev)

    cases = [(name, fec.PRESETS[name]) for name in KERNEL_PRESETS]
    cases.append(("K8_247_371", fec.CodeSpec(K=8, g=(0o247, 0o371))))
    for name, spec in cases:
        require(fec.select_kernel(spec) == fec.kernels.BUTTERFLY,
                f"{name} on the kernel route")
        for p in NOISE:
            seg = noisy(spec, SMALL_B, SMALL_L, p)
            words = compare_one(fec, acs, spec, seg, err,
                                (SMALL_L, SMALL_L - 13))
            compare_ragged(acs, spec, words, err, rng)
            print(f"[compare] {name:12s} p={p:.2f} B={SMALL_B} "
                  f"T={seg.shape[1]}: words, final metrics, bytes, bits and "
                  "ragged bytes and bits equal to the plain versions")
        T = SMALL_L + spec.S
        for label, draw in soft_draws(rng, (SMALL_B, T, spec.n)).items():
            q = torch.from_numpy(draw.astype(np.int8)).to(dev)
            for qclip in (QMAX, 127):
                words = compare_soft(fec, acs, spec, q, qclip, err)
            compare_ragged(acs, spec, words, err, rng)
            qmax = QMAX if label != "int8" else 127
            qc = fec.kernels.soft_qclip(spec, qmax)
            want = fec.viterbi_decode_soft(spec, acs.condition_qllrs(q, qc))
            got = fec.viterbi_decode_batch_soft(spec, q, qmax=qmax)
            require(torch.equal(got, want), f"{name} soft bits {label}")
            got = fec.viterbi_decode_batch_soft_bytes(spec, q, SMALL_L - 13,
                                                      qmax=qmax)
            want = fec.ops.viterbi.pad_and_pack(want[:, :SMALL_L - 13])
            require(torch.equal(got, want), f"{name} soft bytes {label}")
            print(f"[compare] {name:12s} soft {label:15s} B={SMALL_B} T={T}: "
                  f"qclip {QMAX} and 127, words, final metrics (default, "
                  f"carried, zero start), route {fec.select_kernel(spec, 'soft', qmax)}"
                  " bits and bytes, ragged equal")
    for B, L in ((1, 5), (3, 0), (33, 40)):
        seg = noisy(fec.NASA_K7, B, L, 0.25)
        words = compare_one(fec, acs, fec.NASA_K7, seg, err, (L,))
        compare_ragged(acs, fec.NASA_K7, words, err, rng)
        q = torch.from_numpy(
            rng.integers(-128, 128, (B, L + 6, 2)).astype(np.int8)).to(dev)
        words = compare_soft(fec, acs, fec.NASA_K7, q, QMAX, err)
        compare_ragged(acs, fec.NASA_K7, words, err, rng)
        print(f"[compare] NASA_K7      edge B={B} L={L}: hard, soft and "
              "ragged equal")


def phase_main(fec, acs, dev, err):
    """bench.py's working set through the port's hard entry point.  Returns
    (messages, segments on the card, launches of the run, plain ms)."""
    import numpy as np
    import torch
    from convolutionalencdec_tpu_torch.ops.viterbi import viterbi_decode_bytes
    spec = fec.NASA_K7
    rng = np.random.default_rng(MAIN_SEED)
    msgs = rng.integers(0, 2, (MAIN_B, MAIN_L), dtype=np.uint8)
    seg, _ = fec.encode_bits(spec, torch.from_numpy(msgs).to(dev))
    require(np.array_equal(seg.cpu().numpy(), encode_reference_np(spec, msgs)),
            "encode on the card equals the trellis-walk encoder")
    seg = torch.from_numpy(
        corrupt(rng, seg.cpu().numpy(), MAIN_NOISE, spec.n)).to(dev)
    T = seg.shape[1]

    out, launches = drive(acs, lambda: fec.viterbi_decode_batch_bytes(spec,
                                                                      seg))
    require(launches["acs_k1_forward"] > 0 and launches["traceback_k1"] > 0,
            f"both kernels launched on the main path: {launches}")
    require(tuple(out.shape) == (MAIN_B, MAIN_L // 8)
            and out.dtype == torch.uint8, f"output shape {tuple(out.shape)}")
    ber = ber_of_bytes(out, msgs)
    require(ber < BER_LIMIT, f"BER {ber} < {BER_LIMIT}")

    plain_ms = {}
    plain_out, plain_ms["decode"] = time_once(
        lambda: viterbi_decode_bytes(spec, seg))
    require(torch.equal(out, plain_out),
            "main-path bytes equal to the plain decode on the card")
    words, fm = acs.acs_forward_batch(spec, seg)
    (words_p, fm_p), plain_ms["acs_k1_forward"] = time_once(
        lambda: acs.acs_forward_batch_plain(spec, seg))
    require(torch.equal(words, words_p) and torch.equal(fm, fm_p),
            "main-path decision words and final metrics")
    tb_p, plain_ms["traceback_k1"] = time_once(
        lambda: acs.traceback_batch_plain(spec, words_p, T, MAIN_L, "bytes"))
    require(torch.equal(tb_p, out), "main-path plain traceback bytes")
    err["acs_k1_forward"] = max(err["acs_k1_forward"],
                                max_abs_diff(words, words_p),
                                max_abs_diff(fm, fm_p))
    err["traceback_k1"] = max(err["traceback_k1"], max_abs_diff(out, tb_p))
    print(f"[main] NASA_K7 B={MAIN_B} L={MAIN_L} T={T} p={MAIN_NOISE}: "
          f"BER {ber:.4e} (< {BER_LIMIT}), bytes equal to the plain decode "
          f"on the card, launches {launches}")
    return msgs, seg, launches, plain_ms


def phase_soft(fec, acs, dev, err, msgs):
    """The soft main path at full size.  Returns (int8 LLRs [B, T, n] on
    the card, launches of the run, plain ms)."""
    import torch
    spec = fec.NASA_K7
    gen = torch.Generator(device=dev).manual_seed(MAIN_SEED)
    msgs_dev = torch.from_numpy(msgs).to(dev)
    seg, llr = soft_channel(fec, spec, msgs_dev, gen, spec.rate)
    B, T = seg.shape
    q = fec.quantize_llrs(llr, qmax=QMAX).reshape(B, T, spec.n).to(
        torch.int8)
    require(fec.select_kernel(spec, "soft", QMAX) == fec.kernels.SOFT8,
            "NASA_K7 at qmax 7 on the 8-bit soft route")

    out, launches = drive(acs, lambda: fec.viterbi_decode_batch_soft_bytes(
        spec, q, qmax=QMAX))
    require(launches["acs_soft_k1_forward"] > 0
            and launches["traceback_k1"] > 0,
            f"soft forward and traceback launched on the soft path: "
            f"{launches}")
    require(tuple(out.shape) == (MAIN_B, MAIN_L // 8), "soft output shape")
    plain_ms = {}
    qc = acs.condition_qllrs(q, QMAX)
    plain_bits, plain_ms["soft_decode"] = time_once(
        lambda: fec.viterbi_decode_soft(spec, qc))
    require(torch.equal(out, fec.ops.viterbi.pad_and_pack(plain_bits)),
            "soft bytes equal to the plain soft decode on the card")
    words, fm = acs.acs_forward_batch_soft(spec, q, QMAX)
    (words_p, fm_p), plain_ms["acs_soft_k1_forward"] = time_once(
        lambda: acs.acs_forward_batch_soft_plain(spec, q, QMAX))
    require(torch.equal(words, words_p) and torch.equal(fm, fm_p),
            "soft main-path decision words and final metrics")
    err["acs_soft_k1_forward"] = max(err["acs_soft_k1_forward"],
                                     max_abs_diff(words, words_p),
                                     max_abs_diff(fm, fm_p))
    soft_ber = ber_of_bytes(out, msgs)
    hard_seg = fec.bits_to_segments(fec.hard_decision(llr), spec.n)
    hard_ber = ber_of_bytes(fec.viterbi_decode_batch_bytes(spec, hard_seg),
                            msgs)
    lo, hi = SOFT_BER_WINDOW
    require(lo <= soft_ber <= hi, f"soft BER {soft_ber} in [{lo}, {hi}]")
    require(hard_ber >= HARD_OVER_SOFT * soft_ber,
            f"hard BER {hard_ber} >= {HARD_OVER_SOFT} x soft BER {soft_ber}")
    print(f"[soft] NASA_K7 B={MAIN_B} L={MAIN_L} T={T} AWGN Eb/N0 "
          f"{EBN0_DB} dB, qmax {QMAX}: soft BER {soft_ber:.4e} (in "
          f"[{lo}, {hi}]), hard BER of the same received values "
          f"{hard_ber:.4e} (x{hard_ber / soft_ber:.1f}), bytes equal to the "
          f"plain soft decode on the card, launches {launches}")
    return q, launches, plain_ms


def phase_ragged_punctured(fec, acs, dev, err):
    """Ragged and punctured decodes at full size.  Returns ((the ragged
    decodes' int8 LLRs and hard segments, their lengths on the card, the
    punctured decode's LLRs), launches of the runs, plain ms)."""
    import numpy as np
    import torch
    spec = fec.NASA_K7
    T = MAIN_L + spec.S
    rng = np.random.default_rng(MAIN_SEED)
    msgs = rng.integers(0, 2, (MAIN_B, MAIN_L), dtype=np.uint8)
    lens_np = rng.integers(spec.S + 1, T + 1, MAIN_B).astype(np.int32)
    # Zero each message past t_b - S: the first t_b segments of the full
    # encoding are then that channel's terminated packet.
    live = np.arange(MAIN_L)[None, :] < (lens_np - spec.S)[:, None]
    msgs = msgs * live.astype(np.uint8)
    lens = torch.from_numpy(lens_np).to(dev)
    gen = torch.Generator(device=dev).manual_seed(MAIN_SEED + 1)
    seg, llr = soft_channel(fec, spec, torch.from_numpy(msgs).to(dev), gen,
                            spec.rate)
    q = fec.quantize_llrs(llr, qmax=QMAX).reshape(MAIN_B, T, spec.n).to(
        torch.int8)
    hard_seg = fec.bits_to_segments(fec.hard_decision(llr), spec.n)
    launches = {}
    plain_ms = {}

    out, launches["soft ragged"] = drive(
        acs, lambda: fec.viterbi_decode_batch_soft_bytes_ragged(spec, q, lens))
    want, plain_ms["soft ragged decode"] = time_once(
        lambda: fec.ops.viterbi.pad_and_pack(fec.viterbi_decode_ragged_soft(
            spec, acs.condition_qllrs(q, QMAX), lens)))
    require(torch.equal(out, want), "soft ragged bytes equal to the plain "
            "route on the card")
    soft_ber = ber_of_bytes(out, msgs, lens_np - spec.S)
    words, _ = acs.acs_forward_batch_soft(spec, q, QMAX)
    got = acs.traceback_batch_ragged(spec, words, lens, MAIN_L, "bytes")
    want_tb, plain_ms["traceback_k1_ragged"] = time_once(
        lambda: acs.traceback_batch_ragged_plain(spec, words, lens, MAIN_L,
                                                 "bytes"))
    require(torch.equal(got, want_tb) and torch.equal(got, out),
            "ragged traceback equal to its plain version at full size")
    err["traceback_k1_ragged"] = max(err["traceback_k1_ragged"],
                                     max_abs_diff(got, want_tb))

    out, launches["hard ragged"] = drive(
        acs, lambda: fec.viterbi_decode_batch_bytes_ragged(spec, hard_seg,
                                                           lens))
    want, plain_ms["hard ragged decode"] = time_once(
        lambda: fec.ops.viterbi.pad_and_pack(fec.viterbi_decode_ragged(
            spec, hard_seg, lens)))
    require(torch.equal(out, want), "hard ragged bytes equal to the plain "
            "route on the card")
    hard_ber = ber_of_bytes(out, msgs, lens_np - spec.S)

    pattern = fec.PUNCTURE_3_4
    rate = fec.punctured_rate(spec, pattern)
    gen = torch.Generator(device=dev).manual_seed(MAIN_SEED + 2)
    msgs_p = np.random.default_rng(MAIN_SEED + 2).integers(
        0, 2, (MAIN_B, MAIN_L), dtype=np.uint8)
    seg_p, _ = fec.encode_bits(spec, torch.from_numpy(msgs_p).to(dev))
    sent = fec.puncture_bits(fec.segments_to_bits(seg_p, spec.n), pattern, T)
    rx = fec.awgn(fec.bpsk_modulate(sent), EBN0_DB, rate, generator=gen)
    qp = fec.quantize_llrs(fec.bpsk_llr(rx, EBN0_DB, rate), qmax=QMAX)
    out, launches["punctured soft"] = drive(
        acs, lambda: fec.viterbi_decode_batch_punctured_soft(spec, qp,
                                                             pattern, T))
    full = fec.depuncture_llrs(qp.to(torch.int8), pattern, T)
    want, plain_ms["punctured soft decode"] = time_once(
        lambda: fec.viterbi_decode_soft(spec, acs.condition_qllrs(
            full.reshape(MAIN_B, T, spec.n), QMAX)))
    require(torch.equal(out, want), "punctured soft bits equal to the plain "
            "route on the card")
    punct_ber = float((out.cpu().numpy() != msgs_p).mean())

    for path, counts in launches.items():
        used = ("acs_soft_k1_forward" if "soft" in path else "acs_k1_forward",
                "traceback_k1" if "punctured" in path else "traceback_k1_ragged")
        require(all(counts[k] > 0 for k in used),
                f"{path}: kernels {used} launched: {counts}")
    print(f"[ragged] NASA_K7 B={MAIN_B} Tmax={T} lengths uniform in "
          f"[{spec.S + 1}, {T}] (mean {lens_np.mean():.1f}), AWGN Eb/N0 "
          f"{EBN0_DB} dB: soft ragged BER {soft_ber:.4e}, hard ragged BER "
          f"{hard_ber:.4e}; both equal to their plain routes on the card")
    print(f"[punctured] NASA_K7 PUNCTURE_3_4 (rate {rate:.4f}) B={MAIN_B} "
          f"L={MAIN_L}, AWGN Eb/N0 {EBN0_DB} dB: BER {punct_ber:.4e}, equal "
          "to the plain route on the card")
    print(f"[ragged/punctured] launches {launches}")
    return (q, hard_seg, lens, qp), launches, plain_ms


def stream_draws(rng, spec, B, T):
    """The inputs the stream kernel is held to: (label, soft, tensor)."""
    import numpy as np
    import torch
    msgs = rng.integers(0, 2, (B, max(T - spec.S, 0)), dtype=np.uint8)
    coded = encode_reference_np(spec, msgs)[:, :T]
    out = [(f"hard {p:.2f}", False,
            torch.from_numpy(corrupt(rng, coded, p, spec.n))) for p in NOISE]
    for label, draw in soft_draws(rng, (B, T, spec.n)).items():
        if label != "+-1":
            out.append((f"soft {label}", True,
                        torch.from_numpy(draw.astype(np.int8))))
    return out


def check_stream(err, what, got, want):
    """`stream_k1_decode`'s (symbols, state) equal to its plain
    version's."""
    (sym, st), (sym_p, st_p) = got, want
    require(sym.shape == sym_p.shape, f"{what}: stream symbols' shape")
    diffs = [max_abs_diff(sym, sym_p), max_abs_diff(st.metrics, st_p.metrics),
             max_abs_diff(st.registers, st_p.registers)]
    require(not any(diffs), f"{what}: stream symbols and state")
    err["stream_k1_decode"] = max(err["stream_k1_decode"], *diffs)


def compare_stream(stream, spec, x, soft, W, err, cut):
    """`stream_k1_decode` against its plain version: one call from the
    fresh state, then the same input in two calls split at `cut` (the
    second from the carried state)."""
    dec, plain = ((stream.stream_decode_batch_soft,
                   stream.stream_decode_batch_soft_plain) if soft else
                  (stream.stream_decode_batch, stream.stream_decode_batch_plain))
    st = st_p = stream.stream_state_init(spec, x.shape[0], x.device)
    for part in [x] if cut is None else [x[:, :cut], x[:, cut:]]:
        got, want = dec(spec, part, st, W), plain(spec, part, st_p, W)
        check_stream(err, f"{spec} W={W} soft={soft} T={part.shape[1]}",
                     got, want)
        st, st_p = got[1], want[1]


def compare_masked(acs, spec, words, err, rng, key="traceback_k1_masked"):
    """`traceback_batch_masked` against its plain version: random start
    states, live steps 0, S, T - 1 and T, bits and bytes; the largest
    difference goes to err[key]."""
    import numpy as np
    import torch
    B, T, _ = words.shape
    starts = torch.from_numpy(rng.integers(0, spec.num_states, B).astype(
        np.int32)).to(words.device)
    for live in sorted({0, min(spec.S, T), max(T - 1, 0), T}):
        for out_steps in sorted({T, max(T - 13, 0)}):
            for out in ("bits", "bytes"):
                got = acs.traceback_batch_masked(spec, words, starts, live,
                                                 out_steps, out)
                want = acs.traceback_batch_masked_plain(
                    spec, words, starts, live, out_steps, out)
                require(torch.equal(got, want),
                        f"{spec} masked live={live} out={out_steps} {out}")
                err[key] = max(err[key], max_abs_diff(got, want))


def phase_compare_stream(fec, acs, stream, dev, err):
    """The streaming kernels against their plain versions on the card."""
    import numpy as np
    rng = np.random.default_rng(2027)
    T = SMALL_L + 6
    cases = [(name, fec.PRESETS[name]) for name in STREAM_PRESETS]
    cases.append(("K8_247_371", fec.CodeSpec(K=8, g=(0o247, 0o371))))
    for name, spec in cases:
        draws = stream_draws(rng, spec, SMALL_B, T)
        for i, (label, soft, x) in enumerate(draws):
            x = x.to(dev)
            windows = (STREAM_WINDOWS if name == "NASA_K7" else tuple(sorted(
                {STREAM_WINDOWS[i % len(STREAM_WINDOWS)],
                 STREAM_EDGE_WINDOWS[i % len(STREAM_EDGE_WINDOWS)]})))
            for W in windows:
                require(stream.stream_kernel_supports(spec, W),
                        f"{name} W={W} on the stream kernel")
                compare_stream(stream, spec, x, soft, W, err, None)
                compare_stream(stream, spec, x, soft, W, err, 77)
            if not soft:
                words, _ = acs.acs_forward_batch(spec, x)
                compare_masked(acs, spec, words, err, rng)
            print(f"[compare] {name:12s} stream {label:15s} B={SMALL_B} "
                  f"T={T} W={','.join(map(str, windows))}: symbols and "
                  "states equal (fresh, and carried across a cut at 77)"
                  + ("; masked traceback equal" if not soft else ""))
    spec = fec.NASA_K7
    for B, T, cut in ((SMALL_B, 1, None), (SMALL_B, 13, 5), (1, 209, 100),
                      (3, 0, None)):
        for label, soft, x in stream_draws(rng, spec, B, T):
            compare_stream(stream, spec, x.to(dev), soft, MAIN_W, err, cut)
        words, _ = acs.acs_forward_batch(spec, stream_draws(
            rng, spec, B, T)[0][2].to(dev))
        compare_masked(acs, spec, words, err, rng)
        print(f"[compare] NASA_K7      stream edge B={B} T={T}: hard and "
              "soft symbols and states, masked traceback equal")


def feed(dec, x):
    """The main path's stream: `x` [B, T, ...] in the calls of STREAM_FEED,
    the last one with last=True; returns the calls' bits concatenated."""
    import torch
    out, at = [], 0
    for i, t in enumerate(STREAM_FEED):
        out.append(dec.decode(x[:, at:at + t], last=i == len(STREAM_FEED) - 1))
        at += t
    return torch.cat(out, dim=1)


class plain_routes:
    """Within this block, `module` calls the plain versions of the kernel
    wrappers `names` (its plain route on the card)."""

    def __init__(self, module, acs, names):
        self.module, self.acs, self.names = module, acs, names

    def __enter__(self):
        self.saved = {n: getattr(self.module, n) for n in self.names}
        for n in self.names:
            setattr(self.module, n, getattr(self.acs, n + "_plain"))

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.module, n, fn)


def phase_stream(fec, acs, dev, err, msgs, seg, q):
    """The streaming main path at full width: both classes, hard and soft.
    Returns (launches by path, plain ms by path)."""
    import torch
    from convolutionalencdec_tpu_torch.ops import streaming
    spec = fec.NASA_K7
    B, T = seg.shape
    require(sum(STREAM_FEED) == T, "the feed covers the packet")
    block_hard = fec.viterbi_decode_batch(spec, seg)
    block_soft = fec.viterbi_decode_batch_soft(spec, q, qmax=QMAX)
    launches, plain_ms = {}, {}
    for soft, x, block in ((False, seg, block_hard), (True, q, block_soft)):
        kind = "soft" if soft else "hard"
        block_ber = float((block.cpu().numpy() != msgs).mean())
        dec = fec.StreamingDecoderBatch(spec, B, MAIN_W, soft=soft,
                                        device=dev)
        require(dec.use_kernel, "NASA_K7 streams on the kernel route")
        out, launches[f"stream {kind}"] = drive(acs, lambda: feed(dec, x))
        require(tuple(out.shape) == (B, MAIN_L), f"stream {kind} shape")
        plain_dec = fec.StreamingDecoderBatch(
            spec, B, MAIN_W, use_kernel=False, soft=soft, device=dev)
        want, plain_ms[f"stream {kind}"] = time_once(
            lambda: feed(plain_dec, x))
        require(torch.equal(out, want),
                f"stream {kind} bits equal to the plain scan on the card")
        ber = float((out.cpu().numpy() != msgs).mean())
        require(ber < BER_LIMIT if not soft else ber <= SOFT_BER_WINDOW[1],
                f"stream {kind} BER {ber}")
        print(f"[stream] StreamingDecoderBatch {kind} B={B} L={MAIN_L} "
              f"W={MAIN_W}, calls {list(STREAM_FEED)}: BER {ber:.4e} (block "
              f"decode on the same data {block_ber:.4e}), equal to the plain "
              f"scan on the card, launches {launches[f'stream {kind}']}")

        bdec = fec.BlockStreamingDecoderBatch(spec, B, soft=soft, qmax=QMAX,
                                              device=dev)
        out, launches[f"block stream {kind}"] = drive(acs, lambda: feed(bdec,
                                                                        x))
        require(tuple(out.shape) == (B, MAIN_L), f"block stream {kind} shape")
        with plain_routes(streaming, acs, BLOCK_STREAM_WRAPPERS):
            pdec = fec.BlockStreamingDecoderBatch(spec, B, soft=soft,
                                                  qmax=QMAX, device=dev)
            want, plain_ms[f"block stream {kind}"] = time_once(
                lambda: feed(pdec, x))
        require(torch.equal(out, want), f"block stream {kind} bits equal to "
                "its plain route on the card")
        ber = float((out.cpu().numpy() != msgs).mean())
        require(ber < BER_LIMIT if not soft else ber <= SOFT_BER_WINDOW[1],
                f"block stream {kind} BER {ber}")
        differ = int((out != block).sum())
        print(f"[stream] BlockStreamingDecoderBatch {kind} B={B} "
              f"L={MAIN_L}: BER {ber:.4e}, {differ} bits differ from the "
              f"one-shot block decode, equal to its plain route on the card,"
              f" launches {launches[f'block stream {kind}']}")
    for path in ("stream hard", "stream soft"):
        require(launches[path]["stream_k1_decode"] > 0,
                f"{path}: stream_k1_decode launched")
    for path in ("block stream hard", "block stream soft"):
        require(launches[path]["traceback_k1_masked"] > 0
                and launches[path]["traceback_k1"] > 0,
                f"{path}: traceback_k1_masked and traceback_k1 launched")
    return launches, plain_ms


def interior_buffer(acs, spec, seg):
    """A pending buffer of an interior block-stream call at the main path's
    feed (48 kept + 240 new steps) and its start states."""
    import torch
    words, m = acs.acs_forward_batch(spec, seg[:, :288])
    return words, torch.argmin(m, dim=1).to(torch.int32)


def stream_plain_kernel_ms(fec, acs, stream, seg, q, err):
    """The streaming kernels against their plain versions at the main-path
    size, one 2054-step call (hard and soft) and one interior pending
    buffer; returns the plain versions' ms."""
    import torch
    spec = fec.NASA_K7
    fresh = stream.stream_state_init(spec, seg.shape[0], seg.device)
    plain_ms = {}
    for key, x, dec, plain in (
            ("stream_k1_decode", seg, stream.stream_decode_batch,
             stream.stream_decode_batch_plain),
            ("stream_k1_decode soft", q, stream.stream_decode_batch_soft,
             stream.stream_decode_batch_soft_plain)):
        got = dec(spec, x, fresh, MAIN_W)
        want, plain_ms[key] = time_once(lambda: plain(spec, x, fresh, MAIN_W))
        check_stream(err, f"{key} at the main-path size", got, want)
    words, starts = interior_buffer(acs, spec, seg)
    got = acs.traceback_batch_masked(spec, words, starts, 288, 240)
    want, plain_ms["traceback_k1_masked"] = time_once(
        lambda: acs.traceback_batch_masked_plain(spec, words, starts, 288,
                                                 240))
    require(torch.equal(got, want), "masked traceback at the main-path size "
            "equal to its plain version")
    err["traceback_k1_masked"] = max(err["traceback_k1_masked"],
                                     max_abs_diff(got, want))
    print(f"[stream] main-path size B={seg.shape[0]} T={seg.shape[1]} "
          f"W={MAIN_W}: stream_k1_decode hard and soft and "
          "traceback_k1_masked (288 steps, 240 out) equal to their plain "
          "versions")
    return plain_ms


def wall_times(fn, inputs) -> list[float]:
    """Per-call host milliseconds from the call to the card's finishing it
    (one synchronise per call): what a caller that waits for each packet
    sees, host work included."""
    import torch
    for x in inputs[:3]:
        fn(x)
    torch.cuda.synchronize()
    out = []
    for x in inputs:
        t0 = time.perf_counter()
        fn(x)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def host_times(fn, inputs) -> list[float]:
    """Per-call host milliseconds to enqueue `fn` (no synchronise inside):
    the host's own work per call, whether or not the card waits for it."""
    import torch
    torch.cuda.synchronize()
    out = []
    for x in inputs:
        t0 = time.perf_counter()
        fn(x)
        out.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return out


def phase_times(fec, acs, seg, q, rp_in):
    """Device ms of TIMED_CALLS calls on distinct inputs (row rotations of
    the main-path inputs; `rp_in` those of phase 6)."""
    import torch
    q_ragged, hard_ragged, lens, qp = rp_in
    spec = fec.NASA_K7
    T = seg.shape[1]
    bufs = [torch.roll(seg, r + 1, dims=0) for r in range(TIMED_CALLS)]
    runs = {"acs_k1_forward": device_times(
        lambda s: acs.acs_forward_batch(spec, s), bufs)}
    decs = [acs.acs_forward_batch(spec, s)[0] for s in bufs]
    runs["traceback_k1"] = device_times(
        lambda d: acs.traceback_batch(spec, d, T, MAIN_L, "bytes"), decs)
    del decs
    runs["decode"] = device_times(
        lambda s: fec.viterbi_decode_batch_bytes(spec, s), bufs)
    del bufs
    qbufs = [torch.roll(q, r + 1, dims=0) for r in range(TIMED_CALLS)]
    runs["acs_soft_k1_forward"] = device_times(
        lambda x: acs.acs_forward_batch_soft(spec, x, QMAX), qbufs)
    runs["soft_decode"] = device_times(
        lambda x: fec.viterbi_decode_batch_soft_bytes(spec, x, qmax=QMAX),
        qbufs)
    del qbufs
    decs = [acs.acs_forward_batch_soft(spec, torch.roll(q_ragged, r + 1,
                                                        dims=0), QMAX)[0]
            for r in range(TIMED_CALLS)]
    lens_r = [torch.roll(lens, r + 1) for r in range(TIMED_CALLS)]
    pairs = list(zip(decs, lens_r))
    runs["traceback_k1_ragged"] = device_times(
        lambda p: acs.traceback_batch_ragged(spec, p[0], p[1], MAIN_L,
                                             "bytes"), pairs)
    del decs, pairs
    # The whole ragged (c) and punctured (d) decodes.
    pairs = [(torch.roll(q_ragged, r + 1, dims=0), lens_r[r])
             for r in range(TIMED_CALLS)]
    runs["soft ragged decode"] = device_times(
        lambda p: fec.viterbi_decode_batch_soft_bytes_ragged(spec, *p), pairs)
    pairs = [(torch.roll(hard_ragged, r + 1, dims=0), lens_r[r])
             for r in range(TIMED_CALLS)]
    runs["hard ragged decode"] = device_times(
        lambda p: fec.viterbi_decode_batch_bytes_ragged(spec, *p), pairs)
    del pairs
    T = seg.shape[1]
    runs["punctured soft decode"] = device_times(
        lambda x: fec.viterbi_decode_batch_punctured_soft(
            spec, x, fec.PUNCTURE_3_4, T),
        [torch.roll(qp, r + 1, dims=0) for r in range(TIMED_CALLS)])
    from convolutionalencdec_tpu_torch.kernels import stream
    B = seg.shape[0]
    fresh = stream.stream_state_init(spec, B, seg.device)
    bufs = [torch.roll(seg, r + 1, dims=0) for r in range(TIMED_CALLS)]
    runs["stream_k1_decode"] = device_times(
        lambda s: stream.stream_decode_batch(spec, s, fresh, MAIN_W), bufs)
    # One call of the main path's feed: 256 steps.
    runs["stream_k1_decode 256"] = device_times(
        lambda s: stream.stream_decode_batch(spec, s, fresh, MAIN_W),
        [s[:, :STREAM_FEED[0]].contiguous() for s in bufs])
    pend =[interior_buffer(acs, spec, s) for s in bufs]
    runs["traceback_k1_masked"] = device_times(
        lambda p: acs.traceback_batch_masked(spec, p[0], p[1], 288, 240), pend)
    del pend
    qbufs = [torch.roll(q, r + 1, dims=0) for r in range(TIMED_CALLS)]
    runs["stream_k1_decode soft"] = device_times(
        lambda x: stream.stream_decode_batch_soft(spec, x, fresh, MAIN_W),
        qbufs)
    runs["stream_k1_decode soft 256"] = device_times(
        lambda x: stream.stream_decode_batch_soft(spec, x, fresh, MAIN_W),
        [x[:, :STREAM_FEED[0]].contiguous() for x in qbufs])
    # The whole 9-call packet through each class, a new decoder per packet:
    # device time between events, and the host's wall time to the finish.
    for kind, xs in (("hard", bufs), ("soft", qbufs)):
        soft = kind == "soft"
        for path, make in (
                ("stream", lambda: fec.StreamingDecoderBatch(
                    spec, B, MAIN_W, soft=soft, device=seg.device)),
                ("block stream", lambda: fec.BlockStreamingDecoderBatch(
                    spec, B, soft=soft, qmax=QMAX, device=seg.device))):
            runs[f"{path} {kind}"] = device_times(
                lambda x: feed(make(), x), xs)
            runs[f"{path} {kind} wall"] = wall_times(
                lambda x: feed(make(), x), xs)
            runs[f"{path} {kind} host"] = host_times(
                lambda x: feed(make(), x), xs)
    del bufs, qbufs
    print(f"[time] after timing: clocks.sm, power.draw, power.limit, "
          f"temperature: {nvidia_smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")
    return runs


def multi_windows(T):
    """(out_start, out_steps) of the list walk's windows on T steps: from
    step 0, 3, TB_WINDOW (a multiple of 8), T - 56 (the tail-biting DCI
    window's start at 144 steps) and T - 1, each to the end, and from step
    3 cut to a length that is not a multiple of 8."""
    out = {(start, T - start) for start in (0, 3, TB_WINDOW, T - 56, T - 1)
           if 0 <= start <= T}
    if T >= 3:
        out.add((3, cut_bits(T - 3)))
    return sorted(out)


def compare_multi(acs, spec, words, err, rng, key="traceback_k1_multi"):
    """`traceback_batch_multi` against its plain version on one batch of
    words: NW = 1, 2, 8 and NS random start states per channel, live steps
    0, S, T - 1 and T, the windows of `multi_windows`, bits and bytes, each
    call one launch counted; the largest difference goes to err[key].  The
    plain walks of a live count run once, all NW sets at once from step 0:
    a window's bits are the steps' bits of the walk from T - 1, which does
    not depend on where it stops.  Returns the cases."""
    import numpy as np
    import torch
    B, T, _ = words.shape
    NS = spec.num_states
    nws = sorted({1, 2, 8, NS} & set(range(1, NS + 1)))
    starts = [torch.from_numpy(rng.integers(0, NS, (B, nw)).astype(
        np.int32)).to(words.device) for nw in nws]
    every = torch.cat(starts, 1)
    cases = 0
    for live in sorted({0, min(spec.S, T), max(T - 1, 0), T}):
        whole = acs.traceback_batch_multi_plain(spec, words, every, live, 0,
                                                T, "bits")
        # The plain version called with one window, against the slice.
        w0 = min(TB_WINDOW, T)
        require(torch.equal(whole[:, :, w0:], acs.traceback_batch_multi_plain(
            spec, words, every, live, w0, T - w0, "bits")),
                f"{spec} multi plain window at {w0}")
        at = 0
        for nw, st in zip(nws, starts):
            rows = whole[:, at:at + nw]
            at += nw
            for start, steps in multi_windows(T):
                bits = rows[:, :, start:start + steps]
                for out in ("bits", "bytes"):
                    want = bits if out == "bits" else acs.pad_and_pack(bits)
                    case = (f"{spec} {key} B={B} T={T} NW={nw} live={live} "
                            f"window=({start}, {steps}) {out}")
                    before = acs.LAUNCHES[key]
                    got = acs.traceback_batch_multi(spec, words, st, live,
                                                    start, steps, out)
                    require(acs.LAUNCHES[key] == before + (B > 0),
                            f"{case}: a launch counted")
                    require(torch.equal(got, want),
                            f"{case}: equal to the plain version")
                    err[key] = max(err[key], max_abs_diff(got, want))
                    cases += 1
    return cases


def tb_inputs(fec, rng, spec, B, L, dev):
    """CRC16-attached tail-biting blocks of L bits (L >= 16): (blocks,
    segments hit at 3% by nonzero XOR masks, int8 LLRs of the clean coded
    bits with magnitudes 1..7, 8% sign flips, 2% of them -128, 127 or -127,
    and int LLRs of the coded bits rate-matched to n L + 37)."""
    import numpy as np
    import torch
    payload = rng.integers(0, 2, (B, L - 16), dtype=np.uint8)
    blocks = fec.crc_append(fec.CRC16_CCITT, torch.from_numpy(payload).to(
        dev))
    clean = fec.encode_tailbiting(spec, blocks)
    seg = torch.from_numpy(corrupt(rng, clean.cpu().numpy(), 0.03,
                                   spec.n)).to(dev)
    cbits = fec.segments_to_bits(clean, spec.n).cpu().numpy().astype(np.int32)
    q = (1 - 2 * cbits) * rng.integers(1, 8, cbits.shape)
    q = np.where(rng.random(q.shape) < 0.08, -q, q)
    strong = rng.random(q.shape) < 0.02
    q = np.where(strong, rng.choice(np.array([-128, 127, -127]), q.shape), q)
    q = torch.from_numpy(q.astype(np.int8)).to(dev)
    rx = fec.rate_match(q.to(torch.int32), spec, L, spec.n * L + 37)
    return blocks, seg, q.reshape(B, L, spec.n), rx


def phase_compare_tailbiting(fec, acs, dev, err):
    """The multi-walk traceback against its plain version, and every
    tail-biting entry against its plain route, on the card."""
    import numpy as np
    import torch
    from convolutionalencdec_tpu_torch.kernels import tailbiting as ktb
    rng = np.random.default_rng(2028)
    cases = [(name, fec.PRESETS[name]) for name in TB_PRESETS]
    cases.append(("K8_247_371", fec.CodeSpec(K=8, g=(0o247, 0o371))))
    for name, spec in cases:
        zeros = torch.zeros((SMALL_B, spec.num_states), dtype=torch.int32,
                            device=dev)
        for p in NOISE:
            msgs = rng.integers(0, 2, (SMALL_B, SMALL_L), dtype=np.uint8)
            seg = torch.from_numpy(corrupt(
                rng, encode_reference_np(spec, msgs), p, spec.n)).to(dev)
            words, _ = acs.acs_forward_batch(spec, seg, zeros)
            compare_multi(acs, spec, words, err, rng)
        print(f"[compare] {name:12s} multi B={SMALL_B} T={seg.shape[1]}: "
              "NW 1/2/8/NS, live 0/S/T-1/T, windows from 0, 3, "
              f"{TB_WINDOW}, T - 56, T - 1 (from 3 also cut), bits and "
              "bytes equal to the plain version")
    spec = fec.NASA_K7
    for B, T in ((1, 5), (3, 1), (0, 40), (SMALL_B, 1)):
        seg = torch.from_numpy(rng.integers(0, 4, (B, T)).astype(
            np.uint8)).to(dev)
        words, _ = acs.acs_forward_batch(spec, seg)
        compare_multi(acs, spec, words, err, rng)
        print(f"[compare] NASA_K7      multi edge B={B} T={T}: equal")

    crc = fec.CRC16_CCITT
    for name, spec in cases:
        for L in TB_LENGTHS:
            blocks, seg, q, rx = tb_inputs(fec, rng, spec, SMALL_B, L, dev)
            if fec.kernels.swar_layout_supported(spec):
                # The 16-bit route's forward keeps -128 (floor=False).
                zeros = torch.zeros((SMALL_B, spec.num_states),
                                    dtype=torch.int32, device=dev)
                got = acs.acs_forward_batch_soft(spec, q, 127, zeros, False)
                want = acs.acs_forward_batch_soft_plain(spec, q, 127, zeros,
                                                        False)
                require(all(torch.equal(a, b) for a, b in zip(got, want)),
                        f"{name} L={L} soft forward without the floor")
                err["acs_soft_k1_forward"] = max(
                    err["acs_soft_k1_forward"],
                    *(max_abs_diff(a, b) for a, b in zip(got, want)))
            calls = {
                "wrap": lambda: ktb.viterbi_decode_batch_tailbiting(spec, seg),
                "wrap bytes": lambda: ktb.viterbi_decode_batch_tailbiting_bytes(
                    spec, seg),
                "soft": lambda: ktb.viterbi_decode_batch_tailbiting_soft(
                    spec, q),
                "soft bytes":
                    lambda: ktb.viterbi_decode_batch_tailbiting_soft_bytes(
                        spec, q),
                "list": lambda: ktb.viterbi_decode_batch_tailbiting_list(
                    spec, seg, 8),
                "soft list":
                    lambda: ktb.viterbi_decode_batch_tailbiting_list_soft(
                        spec, q, 8),
                "crc": lambda: ktb.viterbi_decode_batch_tailbiting_crc(
                    spec, crc, seg, 8),
                "crc soft": lambda: ktb.viterbi_decode_batch_tailbiting_crc_soft(
                    spec, crc, q, 8),
                "rate-matched":
                    lambda: ktb.viterbi_decode_batch_tailbiting_ratematched_crc(
                        spec, crc, rx, L, 8),
            }
            for what, fn in calls.items():
                got = fn()
                with plain_routes(ktb, acs, TB_WRAPPERS):
                    want = fn()
                pairs = (zip(got, want) if isinstance(got, tuple)
                         else [(got, want)])
                require(all(torch.equal(a, b) for a, b in pairs),
                        f"{name} L={L} tail-biting {what} equal to its "
                        "plain route")
            right = (ktb.viterbi_decode_batch_tailbiting_crc_soft(
                spec, crc, q, 8)[0] == blocks).all(1).float().mean()
            print(f"[compare] {name:12s} tail-biting B={SMALL_B} L={L}: "
                  f"{', '.join(calls)} equal to their plain routes "
                  f"(soft CRC-list blocks right {float(right):.3f})")


def tb_forward_inputs(fec, ktb, spec, q):
    """The arguments after `spec` of K4 in the soft wrap decode of int8
    LLRs `q` [B, T, n]: (the LLRs extended by the wraps, qclip, the uniform
    start, floor)."""
    import torch
    B, T = q.shape[:2]
    wl, wr = ktb.kernel_wraps(spec, T)
    zeros = torch.zeros((B, spec.num_states), dtype=torch.int32,
                        device=q.device)
    qclip, floor = ktb._soft_route(spec, QMAX)
    return (fec.ops.tailbiting.circular_extend(q, wl, wr, axis=1), qclip,
            zeros, floor)


def tb_kernel_inputs(fec, ktb, acs, spec, q):
    """The inputs of K2m in the soft wrap decode and of K6 in the soft list
    decode of int8 LLRs `q`: ((words, starts, live, out_steps),
    (words, starts [B, DCI_LIST], live, out_start, out_steps))."""
    import torch
    T = q.shape[1]
    ext, qclip, zeros, floor = tb_forward_inputs(fec, ktb, spec, q)
    words, fm = acs.acs_forward_batch_soft(spec, ext, qclip, zeros, floor)
    start = torch.argmin(fm, dim=1).to(torch.int32)
    masked = (words, start, words.shape[1], ktb.kernel_wraps(spec, T)[0] + T)
    wl = ktb.list_wrap(spec, T)
    words, fm = acs.acs_forward_batch_soft(
        spec, fec.ops.tailbiting.circular_extend(q, wl, 0, axis=1), qclip,
        zeros, floor)
    states, _ = fec.ops.tailbiting.list_candidates(fm, DCI_LIST)
    return masked, (words, states, words.shape[1], wl, T)


def dci_channel(fec, spec, blocks, dev):
    """DCI-sized blocks over BPSK/AWGN at DCI_EBN0, quantized at QMAX: the
    rate-1/3 LLRs int8 [B, D, n] and the LLRs of the blocks rate-matched to
    DCI_E channel bits, int32 [B, DCI_E]."""
    import torch
    B, D = blocks.shape
    cbits = fec.segments_to_bits(fec.encode_tailbiting(spec, blocks), spec.n)
    gen = torch.Generator(device=dev).manual_seed(MAIN_SEED + 3)
    rx = fec.awgn(fec.bpsk_modulate(cbits), DCI_EBN0, spec.rate,
                  generator=gen)
    q = fec.quantize_llrs(fec.bpsk_llr(rx, DCI_EBN0, spec.rate), qmax=QMAX)
    rate = D / DCI_E
    tx = fec.rate_match(cbits, spec, D, DCI_E)
    rx = fec.awgn(fec.bpsk_modulate(tx), DCI_EBN0, rate, generator=gen)
    qr = fec.quantize_llrs(fec.bpsk_llr(rx, DCI_EBN0, rate), qmax=QMAX)
    return q.reshape(B, D, spec.n).to(torch.int8), qr


def phase_tailbiting(fec, acs, dev, err):
    """The tail-biting main path at full size: (a) the DCI-sized soft
    CRC-list chain and its rate-matched twin, (b) the hard and (c) the soft
    tail-biting byte decodes at bench.py's size.  Returns (inputs for the
    timing phase, launches by path, plain ms, a summary)."""
    import numpy as np
    import torch
    from convolutionalencdec_tpu_torch.kernels import tailbiting as ktb
    spec, crc = fec.LTE_TBCC_K7, fec.CRC16_CCITT
    require(fec.select_kernel(spec, "soft", QMAX) == fec.kernels.SOFT,
            "LTE_TBCC_K7 at qmax 7 on the 16-bit soft route")
    rng = np.random.default_rng(MAIN_SEED)
    payload = rng.integers(0, 2, (DCI_B, DCI_PAYLOAD), dtype=np.uint8)
    blocks = fec.crc_append(crc, torch.from_numpy(payload).to(dev))
    D = blocks.shape[1]
    q, qr = dci_channel(fec, spec, blocks, dev)
    launches, plain_ms, summary = {}, {}, {}

    def crc_soft(x):
        return ktb.viterbi_decode_batch_tailbiting_crc_soft(spec, crc, x,
                                                            DCI_LIST)

    got, launches["tailbiting crc soft"] = drive(acs, lambda: crc_soft(q))
    with plain_routes(ktb, acs, TB_WRAPPERS):
        want, plain_ms["tailbiting crc soft"] = time_once(lambda: crc_soft(q))
    require(all(torch.equal(a, b) for a, b in zip(got, want)),
            "CRC-list chain: bits, ok and chosen equal to the plain route "
            "on the card")
    bits, ok, chosen = got
    require(tuple(bits.shape) == (DCI_B, D), "CRC-list chain shape")
    plain = ktb.viterbi_decode_batch_tailbiting_soft(spec, q)
    plain_right = (plain == blocks).all(1)
    right = (bits == blocks).all(1)
    plain_bler = 1 - float(plain_right.float().mean())
    list_bler = 1 - float(right.float().mean())
    false_accepts = float((ok & ~right).float().mean())
    lost = int((plain_right & ~right).sum())
    lo, hi = PLAIN_BLER_WINDOW
    require(lost == 0, f"{lost} blocks the wrap decode got right are lost")
    require(list_bler <= plain_bler, f"CRC-list BLER {list_bler} <= wrap "
            f"decode BLER {plain_bler}")
    require(lo <= plain_bler <= hi, f"wrap decode BLER {plain_bler} in "
            f"[{lo}, {hi}]")
    require(false_accepts <= FALSE_ACCEPT_LIMIT,
            f"false accepts {false_accepts} <= {FALSE_ACCEPT_LIMIT}")
    summary.update(plain_bler=plain_bler, crc_list_bler=list_bler,
                   false_accepts=false_accepts,
                   rescued=int((right & ~plain_right).sum()),
                   chosen_from_list=int((chosen > 0).sum()))

    got, launches["tailbiting rate-matched"] = drive(
        acs, lambda: ktb.viterbi_decode_batch_tailbiting_ratematched_crc(
            spec, crc, qr, D, DCI_LIST))
    want = crc_soft(fec.derate_match(qr, spec, D, qmax=QMAX))
    require(all(torch.equal(a, b) for a, b in zip(got, want)),
            "rate-matched chain equal to derate_match + the CRC-list chain")
    summary["ratematched_bler"] = 1 - float(
        (got[0] == blocks).all(1).float().mean())
    print(f"[tailbiting] LTE_TBCC_K7 + CRC16, B={DCI_B} blocks of D={D} "
          f"bits, list {DCI_LIST}, AWGN Eb/N0 {DCI_EBN0} dB, qmax {QMAX}: "
          f"wrap decode BLER {plain_bler:.4e} (in [{lo}, {hi}]), CRC-list "
          f"BLER {list_bler:.4e}, {summary['rescued']} rescued, 0 lost, "
          f"false accepts {false_accepts:.2e}; rate-matched to E={DCI_E}: "
          f"BLER {summary['ratematched_bler']:.4e}; equal to the plain "
          f"route and to derate_match + the chain; launches "
          f"{launches['tailbiting crc soft']}")

    masked, multi = tb_kernel_inputs(fec, ktb, acs, spec, q)
    got = acs.traceback_batch_multi(spec, *multi)
    want, plain_ms["traceback_k1_multi"] = time_once(
        lambda: acs.traceback_batch_multi_plain(spec, *multi))
    require(torch.equal(got, want), "multi-walk traceback at (a)'s size")
    err["traceback_k1_multi"] = max(err["traceback_k1_multi"],
                                    max_abs_diff(got, want))
    got = acs.traceback_batch_masked(spec, *masked)
    want, plain_ms["traceback_k1_masked tailbiting"] = time_once(
        lambda: acs.traceback_batch_masked_plain(spec, *masked))
    require(torch.equal(got, want), "masked traceback at (a)'s size")
    err["traceback_k1_masked"] = max(err["traceback_k1_masked"],
                                     max_abs_diff(got, want))
    fwd = tb_forward_inputs(fec, ktb, spec, q)
    got = acs.acs_forward_batch_soft(spec, *fwd)
    want, plain_ms["acs_soft_k1_forward (f)"] = time_once(
        lambda: acs.acs_forward_batch_soft_plain(spec, *fwd))
    require(all(torch.equal(a, b) for a, b in zip(got, want)),
            "the wrap decode's soft forward at (a)'s size: words and final "
            "metrics")
    err["acs_soft_k1_forward"] = max(err["acs_soft_k1_forward"],
                                     *map(max_abs_diff, got, want))

    # (b) and (c): bench.py's messages, tail-biting encoded.
    spec = fec.NASA_K7
    rng = np.random.default_rng(MAIN_SEED)
    msgs = rng.integers(0, 2, (MAIN_B, MAIN_L), dtype=np.uint8)
    clean = fec.encode_tailbiting(spec, torch.from_numpy(msgs).to(dev))
    seg = torch.from_numpy(corrupt(rng, clean.cpu().numpy(), MAIN_NOISE,
                                   spec.n)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(MAIN_SEED + 5)
    rx = fec.awgn(fec.bpsk_modulate(fec.segments_to_bits(clean, spec.n)),
                  EBN0_DB, spec.rate, generator=gen)
    qb = fec.quantize_llrs(fec.bpsk_llr(rx, EBN0_DB, spec.rate), qmax=QMAX)
    qb = qb.reshape(MAIN_B, MAIN_L, spec.n).to(torch.int8)
    for path, fn, x, limit in (
            ("tailbiting hard bytes",
             ktb.viterbi_decode_batch_tailbiting_bytes, seg, BER_LIMIT),
            ("tailbiting soft bytes",
             ktb.viterbi_decode_batch_tailbiting_soft_bytes, qb,
             SOFT_BER_WINDOW[1])):
        out, launches[path] = drive(acs, lambda: fn(spec, x))
        with plain_routes(ktb, acs, TB_WRAPPERS):
            want, plain_ms[path] = time_once(lambda: fn(spec, x))
        require(torch.equal(out, want), f"{path} equal to the plain route "
                "on the card")
        require(tuple(out.shape) == (MAIN_B, MAIN_L // 8), f"{path} shape")
        ber = ber_of_bytes(out, msgs)
        require(ber < limit if "hard" in path else ber <= limit,
                f"{path} BER {ber} within {limit}")
        summary[f"{path.split()[1]}_bytes_ber"] = ber
        print(f"[tailbiting] NASA_K7 B={MAIN_B} L={MAIN_L} {path}: BER "
              f"{ber:.4e} (limit {limit}), equal to the plain route on the "
              f"card, launches {launches[path]}")
    used = {"tailbiting crc soft": ("acs_soft_k1_forward",
                                    "traceback_k1_masked",
                                    "traceback_k1_multi"),
            "tailbiting rate-matched": ("acs_soft_k1_forward",
                                        "traceback_k1_masked",
                                        "traceback_k1_multi"),
            "tailbiting hard bytes": ("acs_k1_forward",
                                      "traceback_k1_masked"),
            "tailbiting soft bytes": ("acs_soft_k1_forward",
                                      "traceback_k1_masked")}
    for path, kernels in used.items():
        require(all(launches[path][k] > 0 for k in kernels),
                f"{path}: kernels {kernels} launched: {launches[path]}")
    return (q, qr, seg, qb), launches, plain_ms, summary


def tailbiting_times(fec, acs, inputs):
    """Device ms of TIMED_CALLS calls on distinct inputs (row rotations)
    of K6, K2m and the wrap decode's K4 at (a)'s size and of each whole
    tail-biting call; (a)'s wall and host-enqueue ms too."""
    import torch
    from convolutionalencdec_tpu_torch.kernels import tailbiting as ktb
    q, qr, seg, qb = inputs
    spec, crc = fec.LTE_TBCC_K7, fec.CRC16_CCITT
    D = q.shape[1]
    runs = {}
    pend = [tb_kernel_inputs(fec, ktb, acs, spec, torch.roll(q, r + 1, 0))
            for r in range(TIMED_CALLS)]
    runs["traceback_k1_multi"] = device_times(
        lambda p: acs.traceback_batch_multi(spec, *p[1]), pend)
    runs["traceback_k1_masked tailbiting"] = device_times(
        lambda p: acs.traceback_batch_masked(spec, *p[0]), pend)
    del pend
    fwd = [tb_forward_inputs(fec, ktb, spec, torch.roll(q, r + 1, 0))
           for r in range(TIMED_CALLS)]
    runs["acs_soft_k1_forward (f)"] = device_times(
        lambda a: acs.acs_forward_batch_soft(spec, *a), fwd)
    del fwd
    qbufs = [torch.roll(q, r + 1, 0) for r in range(TIMED_CALLS)]

    def chain(x):
        return ktb.viterbi_decode_batch_tailbiting_crc_soft(spec, crc, x,
                                                            DCI_LIST)

    runs["tailbiting crc soft"] = device_times(chain, qbufs)
    runs["tailbiting crc soft wall"] = wall_times(chain, qbufs)
    runs["tailbiting crc soft host"] = host_times(chain, qbufs)
    runs["tailbiting rate-matched"] = device_times(
        lambda x: ktb.viterbi_decode_batch_tailbiting_ratematched_crc(
            spec, crc, x, D, DCI_LIST),
        [torch.roll(qr, r + 1, 0) for r in range(TIMED_CALLS)])
    del qbufs
    spec = fec.NASA_K7
    runs["tailbiting hard bytes"] = device_times(
        lambda s: ktb.viterbi_decode_batch_tailbiting_bytes(spec, s),
        [torch.roll(seg, r + 1, 0) for r in range(TIMED_CALLS)])
    runs["tailbiting soft bytes"] = device_times(
        lambda x: ktb.viterbi_decode_batch_tailbiting_soft_bytes(spec, x),
        [torch.roll(qb, r + 1, 0) for r in range(TIMED_CALLS)])
    return runs


def map_draws(rng, shape):
    """The LLR distributions the max-log-MAP kernel is held to."""
    import numpy as np
    pm7 = rng.integers(-7, 8, shape)
    return {"+-7": pm7, "int8": rng.integers(-128, 128, shape),
            "+-7, 20% zeros": np.where(rng.random(shape) < 0.2, 0, pm7)}


def map_edge_cases(rng, spec):
    """Yields (B, T, label, int LLRs [B, T, n]) of the max-log-MAP kernel's
    edges at `spec`: T in MAP_EDGE_T and S + 1 at each B of MAP_EDGE_B,
    each of `map_draws` and the extremes (+-127 and -128, 20% erasures);
    the main path's T (MAIN_L + S) at B = 5 over the whole int8 range."""
    import numpy as np
    for T in sorted(set(MAP_EDGE_T) | {spec.S + 1}):
        for B in MAP_EDGE_B:
            shape = (B, T, spec.n)
            draws = map_draws(rng, shape)
            draws["+-127, -128, 20% zeros"] = np.where(
                rng.random(shape) < 0.2, 0,
                rng.choice(np.array([-128, -127, 127]), shape))
            for label, draw in draws.items():
                yield B, T, label, draw
    T = MAIN_L + spec.S
    yield 5, T, "int8", rng.integers(-128, 128, (5, T, spec.n))


def compare_map(km, spec, q, terminated, err):
    """`maxlogmap_k1` against its plain version on one batch of LLRs."""
    import torch
    got = km.maxlogmap_llrs_batch_kernel(spec, q, terminated)
    want = km.maxlogmap_llrs_batch_plain(spec, q, terminated)
    require(torch.equal(got, want), f"{spec} max-log-MAP T={q.shape[1]} "
            f"terminated={terminated}")
    err["maxlogmap_k1"] = max(err["maxlogmap_k1"], max_abs_diff(got, want))


def turbo_fields(rng, B, L, S, apriori, dev):
    """Random int32 RSC MAP inputs at qmax 31: (l_sys, l_par, l_apriori,
    l_sys_tail, l_par_tail); the a-priori drawn from +-apriori."""
    import numpy as np
    import torch

    def draw(mag, shape):
        return torch.from_numpy(rng.integers(-mag, mag + 1, shape).astype(
            np.int32)).to(dev)
    return (draw(TURBO_QMAX, (B, L)), draw(TURBO_QMAX, (B, L)),
            draw(apriori, (B, L)), draw(TURBO_QMAX, (B, S)),
            draw(TURBO_QMAX, (B, S)))


def compare_rsc(kt, rsc, fields, err, what):
    """`turbo_rsc_map` against its plain version on one batch."""
    import torch
    got = kt.rsc_maxlogmap_batch_kernel(rsc, *fields)
    want = kt.rsc_maxlogmap_batch_plain(rsc, *fields)
    require(torch.equal(got, want), f"RSC MAP {what}")
    err["turbo_rsc_map"] = max(err["turbo_rsc_map"], max_abs_diff(got, want))


def equal_outputs(got, want) -> bool:
    """Tensors (or ints) of two routes' tuples all equal."""
    import torch
    return all(torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
               for a, b in zip(got, want))


def turbo_channel(fec, msgs, E, ebn0, generator, qmax=TURBO_QMAX):
    """LTE-turbo encode [B, L] blocks to E bits, BPSK over AWGN at `ebn0`
    from `generator`, quantized channel LLRs: int32 [B, E]."""
    L = msgs.shape[1]
    tx = fec.lte_turbo_encode_batch(msgs, E)
    rate = L / E
    rx = fec.awgn(fec.bpsk_modulate(tx), ebn0, rate, generator=generator)
    return fec.quantize_llrs(fec.bpsk_llr(rx, ebn0, rate), qmax=qmax)


def phase_compare_soft_output(fec, dev, err):
    """The max-log-MAP and RSC MAP kernels against their plain versions,
    and every new public entry against its plain route, on the card."""
    import numpy as np
    import torch
    from convolutionalencdec_tpu_torch.kernels import maxlogmap as km
    from convolutionalencdec_tpu_torch.kernels import turbo as kt
    from convolutionalencdec_tpu_torch.ops import turbo as ot
    rng = np.random.default_rng(2029)
    cases = [(name, fec.PRESETS[name]) for name in MAP_PRESETS]
    cases.append(("K8_247_371", fec.CodeSpec(K=8, g=(0o247, 0o371))))
    cases += [(f"NS{NS}_n{n}", bfly_spec(fec, rng, NS, n))
              for NS in MAP_WIDE_NS for n in range(5, 9)]
    for name, spec in cases:
        require(km.maxlogmap_supported(spec), f"{name} on the MAP kernel")
        for T in (spec.S + 1,) + MAP_LENGTHS:
            for label, draw in map_draws(rng, (SMALL_B, T, spec.n)).items():
                q = torch.from_numpy(draw.astype(np.int8)).to(dev)
                for terminated in (True, False):
                    compare_map(km, spec, q, terminated, err)
        edges = 0
        for B, T, label, draw in map_edge_cases(rng, spec):
            q = torch.from_numpy(draw.astype(np.int8)).to(dev)
            for terminated in (True, False):
                compare_map(km, spec, q, terminated, err)
                edges += 1
        print(f"[compare] {name:12s} max-log-MAP B={SMALL_B} T=S+1,"
              f"{','.join(map(str, MAP_LENGTHS))}: +-7, int8 with -128, 20% "
              f"erasures, terminated and not; {edges} edge cases (T = "
              f"{', '.join(map(str, MAP_EDGE_T))}, S + 1 at B = "
              f"{', '.join(map(str, MAP_EDGE_B))}, also +-127 and -128 with "
              f"erasures; T = {MAIN_L + spec.S} at B = 5): equal to the "
              "plain version")
    for T in (1, 7, 40):
        q = torch.from_numpy(rng.integers(-128, 128, (1, T, 2)).astype(
            np.int8)).to(dev)
        compare_map(km, fec.NASA_K7, q, True, err)
    print("[compare] NASA_K7      max-log-MAP edge B=1 T=1,7,40: equal")

    rsc = fec.RscSpec()
    for L in TURBO_LENGTHS:
        for apriori in (TURBO_QMAX, 4000):
            compare_rsc(kt, rsc, turbo_fields(rng, 5, L, rsc.S, apriori, dev),
                        err, f"L={L} a-priori +-{apriori}")
    # The LA_CLAMP contract case (tests/test_turbo_kernel.py:57-77's shape):
    # a-priori at the full clamp, channel LLRs to +-8192.
    B, L = 3, 104
    big = turbo_fields(rng, B, L, rsc.S, ot.LA_CLAMP, dev)
    big = [x * (8192 // TURBO_QMAX) if i != 2 else x
           for i, x in enumerate(big)]
    big[2][:, ::7] = ot.LA_CLAMP
    big[2][:, 3::7] = -ot.LA_CLAMP
    compare_rsc(kt, rsc, big, err, "LA_CLAMP contract")
    for L in (40, 6144):
        compare_rsc(kt, rsc, turbo_fields(rng, 1, L, rsc.S, 4000, dev), err,
                    f"B=1 L={L}")
    print(f"[compare] RSC MAP L={','.join(map(str, TURBO_LENGTHS))} (B=5, "
          "a-priori +-31 and +-4000), the LA_CLAMP contract case, B=1: "
          "equal to the plain version")
    for L in RSC_EDGE_LENGTHS:
        for B in (5, 3):
            compare_rsc(kt, rsc, turbo_fields(rng, B, L, rsc.S, 4000, dev),
                        err, f"B={B} L={L}")
    for name, kwargs in RSC_SMALL_CODES:
        small = fec.RscSpec(**kwargs)
        for L in RSC_SMALL_LENGTHS:
            for B in (3, 2 * 32 // small.num_states + 3):
                compare_rsc(kt, small, turbo_fields(rng, B, L, small.S, 4000,
                                                    dev),
                            err, f"{name} B={B} L={L}")
    print(f"[compare] RSC MAP L={','.join(map(str, RSC_EDGE_LENGTHS))} at "
          f"B=5 and 3; {', '.join(n for n, _ in RSC_SMALL_CODES)} at "
          f"L={','.join(map(str, RSC_SMALL_LENGTHS))}, B=3 and 2 (32/NS)+3: "
          "equal to the plain version")

    crc = fec.CRC24B
    for L in (40, 104):
        payload = rng.integers(0, 2, (8, L - 24), dtype=np.uint8)
        msgs = fec.crc_append(crc, torch.from_numpy(payload).to(dev))
        gen = torch.Generator(device=dev).manual_seed(L)
        q = turbo_channel(fec, msgs, 3 * (L + 4), 0.5, gen, qmax=15)
        q_maps = torch.from_numpy(rng.integers(-128, 128, (8, L + 6, 2))
                                  .astype(np.int8)).to(dev)
        fields, perm, _ = fec.ops.lte._receive_fields(q, L, 0, None, 15, 0,
                                                      None)
        calls = {
            "turbo_decode_batch_kernel": (
                lambda: fec.turbo_decode_batch_kernel(rsc, *fields, perm,
                                                      n_iters=3),
                lambda: fec.turbo_decode_batch(rsc, *fields, perm,
                                               n_iters=3)),
            "turbo_decode_batch_kernel_early": (
                lambda: fec.turbo_decode_batch_kernel_early(
                    rsc, *fields, perm, crc=crc, max_iters=4),
                lambda: ot.decode_early(ot.rsc_maxlogmap, rsc, fields, perm,
                                        crc, 4)),
            "lte_turbo_decode": (
                lambda: fec.lte_turbo_decode(q, L, n_iters=3, qmax=15),
                lambda: fec.lte_turbo_decode(q, L, n_iters=3, qmax=15,
                                             use_kernel=False)),
            "lte_turbo_decode_early": (
                lambda: fec.lte_turbo_decode_early(q, L, max_iters=4,
                                                   qmax=15),
                lambda: fec.lte_turbo_decode_early(q, L, max_iters=4,
                                                   qmax=15,
                                                   use_kernel=False)),
            "maxlogmap_llrs_batch_kernel": (
                lambda: (fec.maxlogmap_llrs_batch_kernel(fec.NASA_K7,
                                                         q_maps),),
                lambda: (km.maxlogmap_llrs_batch_plain(fec.NASA_K7,
                                                       q_maps),)),
        }
        for what, (fn, plain) in calls.items():
            require(equal_outputs(fn(), plain()), f"L={L} {what} equal to "
                    "its plain route")
        print(f"[compare] turbo entries B=8 L={L} at 0.5 dB: "
              f"{', '.join(calls)} equal to their plain routes")
    # A two-block transport block (A = 6180: two blocks of 3136, 20
    # fillers in the first), three iterations.
    A, G = 6180, 2 * 3 * (3136 + 4)
    payload = rng.integers(0, 2, A, dtype=np.uint8)
    tx = fec.lte_dlsch_encode(payload, G, device=dev)
    q = (1 - 2 * tx.to(torch.int32)) * 6
    q = torch.where(torch.from_numpy(rng.random(G) < 0.1).to(dev), -q, q)
    got = fec.lte_dlsch_decode(q, A, n_iters=3)
    want = fec.lte_dlsch_decode(q, A, n_iters=3, use_kernel=False)
    require(equal_outputs(got, want), "lte_dlsch_decode equal to its plain "
            "route")
    require(bool(got[1]) and np.array_equal(got[0].cpu().numpy(), payload),
            "the two-block transport block decodes")
    print(f"[compare] lte_dlsch_decode A={A} (2 blocks, 20 fillers), 10% "
          "flipped: equal to its plain route, TB CRC passes")


def phase_maxlogmap(fec, acs, dev, err, msgs, q):
    """(h): max-log-MAP LLRs of phase 5's LLRs at full size.  Returns
    (launches, plain ms, a summary)."""
    import torch
    from convolutionalencdec_tpu_torch.kernels import maxlogmap as km
    spec = fec.NASA_K7
    llrs, launches = drive(acs, lambda: fec.maxlogmap_llrs_batch_kernel(spec,
                                                                        q))
    require(launches["maxlogmap_k1"] > 0, f"maxlogmap_k1 launched: "
            f"{launches}")
    B, T = q.shape[:2]
    require(tuple(llrs.shape) == (B, T) and llrs.dtype == torch.int32,
            "max-log-MAP output shape")
    want, plain_ms = time_once(lambda: km.maxlogmap_llrs_batch_plain(spec, q))
    require(torch.equal(llrs, want), "max-log-MAP LLRs equal to the plain "
            "version on the card")
    err["maxlogmap_k1"] = max(err["maxlogmap_k1"], max_abs_diff(llrs, want))
    L = T - spec.S
    bits = (llrs[:, :L] < 0).to(torch.uint8)
    ber = float((bits.cpu().numpy() != msgs).mean())
    viterbi = fec.viterbi_decode_batch_soft(spec, q, qmax=QMAX)
    differ = float((bits != viterbi).float().mean())
    lo, hi = SOFT_BER_WINDOW
    require(lo <= ber <= hi, f"max-log-MAP BER {ber} in [{lo}, {hi}]")
    require(differ < MAP_VITERBI_DIFFER_LIMIT, f"max-log-MAP and soft "
            f"Viterbi differ on {differ} of the bits")
    require(bool((llrs[:, L:] > 0).all()), "termination steps favour 0")
    print(f"[maxlogmap] NASA_K7 B={B} T={T} AWGN Eb/N0 {EBN0_DB} dB, qmax "
          f"{QMAX}: sign BER {ber:.4e} (in [{lo}, {hi}]), {differ:.4e} of "
          f"the bits differ from the soft Viterbi decode (< "
          f"{MAP_VITERBI_DIFFER_LIMIT}), LLRs equal to the plain version on "
          f"the card, launches {launches}")
    return launches, {"maxlogmap_k1": plain_ms, "maxlogmap": plain_ms}, {
        "ber": ber, "differ_from_viterbi": differ}


def serve_turbo(fec, q, use_kernel=None):
    """bench.py --turbo's serving call: the early-exit receive chain and
    the packed message bytes."""
    bits, lapp, ok, iters = fec.lte_turbo_decode_early(
        q, TURBO_L, max_iters=TURBO_MAX_ITERS, use_kernel=use_kernel)
    return fec.pack_bits(bits), bits, lapp, ok, iters


def phase_turbo(fec, acs, dev, err):
    """(i): the turbo serving point at full size.  Returns (the received
    LLRs, launches by path, plain ms, a summary)."""
    import numpy as np
    import torch
    from convolutionalencdec_tpu_torch.kernels import turbo as kt
    rng = np.random.default_rng(MAIN_SEED)
    payload = rng.integers(0, 2, (TURBO_B, TURBO_L - 24), dtype=np.uint8)
    msgs = fec.crc_append(fec.CRC24B, torch.from_numpy(payload).to(dev))
    gen = torch.Generator(device=dev).manual_seed(MAIN_SEED + 6)
    q = turbo_channel(fec, msgs, TURBO_E, TURBO_EBN0, gen)
    require(tuple(q.shape) == (TURBO_B, TURBO_E), "turbo channel shape")
    launches, plain_ms = {}, {}

    got, launches["turbo serving"] = drive(acs, lambda: serve_turbo(fec, q))
    packed, bits, lapp, ok, iters = got
    want, plain_ms["turbo serving"] = time_once(
        lambda: serve_turbo(fec, q, use_kernel=False))
    require(equal_outputs(got, want), "turbo serving: bytes, bits, lapp, ok "
            "and iterations equal to the plain route on the card")
    require(tuple(packed.shape) == (TURBO_B, TURBO_L // 8), "packed shape")
    wrong = (bits != msgs).any(1)
    false_accepts = int((ok & wrong).sum())
    accept = float(ok.float().mean())
    block_errors = int(wrong.sum())
    require(false_accepts == 0, f"{false_accepts} false accepts")
    require(accept > TURBO_ACCEPT_MIN, f"accept rate {accept} > "
            f"{TURBO_ACCEPT_MIN}")
    lo, hi = TURBO_ITERS_WINDOW
    require(lo <= iters <= hi, f"iterations {iters} in [{lo}, {hi}]")
    print(f"[turbo] LTE turbo B={TURBO_B} L={TURBO_L} ({TURBO_L - 24} + CRC24B) E="
          f"{TURBO_E}, AWGN Eb/N0 {TURBO_EBN0} dB, qmax {TURBO_QMAX}: "
          f"{iters} iterations, accept rate {accept:.4f}, {block_errors} "
          f"blocks wrong, {false_accepts} false accepts; equal to the plain "
          f"route on the card, launches {launches['turbo serving']}")

    got, launches["turbo fixed"] = drive(acs, lambda: fec.lte_turbo_decode(
        q, TURBO_L, n_iters=TURBO_FIXED_ITERS))
    want, plain_ms["turbo fixed"] = time_once(lambda: fec.lte_turbo_decode(
        q, TURBO_L, n_iters=TURBO_FIXED_ITERS, use_kernel=False))
    require(equal_outputs(got, want), "fixed-iteration turbo decode equal "
            "to the plain route on the card")
    fixed_wrong = int((got[0] != msgs).any(1).sum())
    print(f"[turbo] lte_turbo_decode {TURBO_FIXED_ITERS} iterations: "
          f"{fixed_wrong} blocks wrong, equal to the plain route on the "
          f"card, launches {launches['turbo fixed']}")
    for path, counts in launches.items():
        require(counts["turbo_rsc_map"] > 0, f"{path}: turbo_rsc_map "
                f"launched: {counts}")

    # One MAP call of the first iteration at this size, against the plain.
    fields, _, _ = fec.ops.lte._receive_fields(q, TURBO_L, 0, None,
                                               TURBO_QMAX, 0, None)
    args = map_call_args(fields)
    got = kt.rsc_maxlogmap_batch_kernel(fec.RscSpec(), *args)
    want, plain_ms["turbo_rsc_map"] = time_once(
        lambda: kt.rsc_maxlogmap_batch_plain(fec.RscSpec(), *args))
    require(torch.equal(got, want), "RSC MAP at the serving size")
    err["turbo_rsc_map"] = max(err["turbo_rsc_map"], max_abs_diff(got, want))
    summary = {"iters_used": iters, "accept_rate": accept,
               "false_accepts": false_accepts, "block_errors": block_errors,
               "fixed_block_errors": fixed_wrong}
    return q, launches, plain_ms, summary


def map_call_args(fields):
    """DEC1's inputs in the first iteration (a-priori 0) from the decoder's
    seven fields."""
    import torch
    l_sys, l_par1, _, st1, pt1, _, _ = fields
    return (l_sys, l_par1, torch.zeros_like(l_sys), st1, pt1)


def soft_output_times(fec, q_map, q_turbo):
    """Device ms of TIMED_CALLS calls on distinct inputs (row rotations) of
    K7 and K8 at their main-path sizes, (h) whole, and (i) whole with its
    wall and host-enqueue ms, and the fixed-iteration decode."""
    import torch
    from convolutionalencdec_tpu_torch.kernels import turbo as kt
    spec = fec.NASA_K7
    L = q_map.shape[1] - spec.S
    runs = {}
    qbufs = [torch.roll(q_map, r + 1, 0) for r in range(TIMED_CALLS)]
    runs["maxlogmap_k1"] = device_times(
        lambda x: fec.maxlogmap_llrs_batch_kernel(spec, x), qbufs)
    runs["maxlogmap"] = device_times(
        lambda x: (fec.maxlogmap_llrs_batch_kernel(spec, x)[:, :L] < 0).to(
            torch.uint8), qbufs)
    del qbufs
    tbufs = [torch.roll(q_turbo, r + 1, 0) for r in range(TIMED_CALLS)]
    fields = [fec.ops.lte._receive_fields(x, TURBO_L, 0, None, TURBO_QMAX,
                                          0, None)[0] for x in tbufs]
    rsc = fec.RscSpec()
    runs["turbo_rsc_map"] = device_times(
        lambda f: kt.rsc_maxlogmap_batch_kernel(rsc, *map_call_args(f)),
        fields)
    del fields
    runs["turbo serving"] = device_times(lambda x: serve_turbo(fec, x), tbufs)
    runs["turbo serving wall"] = wall_times(lambda x: serve_turbo(fec, x),
                                            tbufs)
    runs["turbo serving host"] = host_times(lambda x: serve_turbo(fec, x),
                                            tbufs)
    runs["turbo fixed"] = device_times(
        lambda x: fec.lte_turbo_decode(x, TURBO_L, n_iters=TURBO_FIXED_ITERS),
        tbufs)
    return runs


def generic_spec(fec, code):
    """A CodeSpec from a preset name or CodeSpec arguments."""
    return fec.PRESETS[code] if isinstance(code, str) else fec.CodeSpec(**code)


def generic_pairs(gk, spec):
    """(forward name, traceback name, forward, its plain version, traceback,
    its plain version) of the runtime-k kernels and, for a k = 2, NS = 64
    code, of their k2 instantiation."""
    pairs = [("acs_generic_forward", "traceback_generic",
              gk.acs_forward_batch_generic, gk.acs_forward_batch_generic_plain,
              gk.traceback_batch_generic, gk.traceback_batch_generic_plain)]
    if gk.k2_supported(spec):
        pairs.append(("acs_generic_k2_forward", "traceback_generic_k2",
                      gk.acs_forward_batch_k2, gk.acs_forward_batch_k2_plain,
                      gk.traceback_batch_k2, gk.traceback_batch_k2_plain))
    return pairs


def cut_bits(full: int) -> int:
    """A message length below `full` and not a multiple of 8 (0 when
    `full` leaves no such length)."""
    cut = max(full - 13, 0)
    return cut - 1 if cut % 8 == 0 and cut > 0 else cut


def compare_generic(fec, gk, spec, seg, err):
    """The generic-k kernels against their plain versions on one batch of
    segments on the card: decision planes, final metrics, and the
    traceback's bits and bytes at the full message and at `cut_bits`; and
    the public entries' bits and bytes against the plain decode.  Returns
    the plain decode's bits."""
    import torch
    T = seg.shape[1]
    full = (T - spec.S) * spec.k
    for fname, tname, fwd, fwd_p, tb, tb_p in generic_pairs(gk, spec):
        planes, fm = fwd(spec, seg)
        planes_p, fm_p = fwd_p(spec, seg)
        require(torch.equal(planes, planes_p) and torch.equal(fm, fm_p),
                f"{spec} {fname} planes and final metrics")
        err[fname] = max(err[fname], max_abs_diff(planes, planes_p),
                         max_abs_diff(fm, fm_p))
        for L in sorted({full, cut_bits(full)}):
            for out in ("bytes", "bits"):
                got = tb(spec, planes, T, L, out)
                want = tb_p(spec, planes_p, T, L, out)
                require(torch.equal(got, want),
                        f"{spec} {tname} L={L} {out}")
                err[tname] = max(err[tname], max_abs_diff(got, want))
    want = fec.viterbi_decode(spec, seg)
    entries = {"viterbi_decode_batch": fec.viterbi_decode_batch,
               "viterbi_decode_batch_generic":
                   fec.viterbi_decode_batch_generic}
    if gk.k2_supported(spec):
        entries["viterbi_decode_batch_k2"] = fec.viterbi_decode_batch_k2
    for what, fn in entries.items():
        require(torch.equal(fn(spec, seg), want),
                f"{spec} {what} equal to the plain decode")
    cut = cut_bits(full)
    require(torch.equal(fec.viterbi_decode_batch_bytes(spec, seg, cut),
                        fec.ops.viterbi.pad_and_pack(want[:, :cut])),
            f"{spec} viterbi_decode_batch_bytes at {cut} bits")
    return want


def generic_forward_shapes(source=None):
    """(k, log2 NS, log2 lanes a channel) of each case of the generic
    forward's dispatch switch in csrc/acs_generic.cu (or `source`)."""
    import re
    src = Path(source or ROOT / SOURCES["acs_generic_forward"][0]).read_text()
    return [tuple(map(int, m)) for m in re.findall(
        r"launch_forward<(\d+), (\d+), (\d+)(?:, \d+)*>\(GENERIC_ARGS\)", src)]


def compare_generic_shapes(fec, gk, dev, err, rng):
    """Every instantiation of the generic forward against the plain forward
    on the card: at each (k, NS) of its dispatch switch a random code (n = 1
    ... 8 in turn; at k = 1 not a butterfly code), noisy and garbage segments, B = 1 and B = 2 CPW + 3
    (CPW: the shape's channels a warp, a block's), T = 1, S + 1, 31, 32,
    33 and 100; planes and final metrics, through both entries at k = 2,
    NS = 64."""
    import numpy as np
    import torch
    for i, (k, logns, logc) in enumerate(generic_forward_shapes()):
        n, K, cpw = 1 + i % 8, logns // k + 1, 32 >> logc
        spec = None
        while spec is None or not gk.generic_kernel_supports(spec):
            spec = fec.CodeSpec(K=K, k=k, g=tuple(
                int(x) for x in rng.integers(1, 1 << (k * K), n)))
        cases = 0
        for kind in ("noisy", "garbage"):
            for B in (1, 2 * cpw + 3):
                for T in (1, spec.S + 1, 31, 32, 33, 100):
                    x = rng.integers(0, 1 << n, (B, T)).astype(np.uint8)
                    if kind == "noisy" and T > spec.S:
                        msgs = rng.integers(0, 2, (B, (T - spec.S) * k),
                                            dtype=np.uint8)
                        coded = fec.encode_bits(spec, torch.from_numpy(
                            msgs).to(dev))[0].cpu().numpy()
                        x = corrupt(rng, coded, 0.1, n)
                    seg = torch.from_numpy(x).to(dev)
                    planes_p, fm_p = gk.acs_forward_batch_generic_plain(spec,
                                                                        seg)
                    for fname, _, fwd, _, _, _ in generic_pairs(gk, spec):
                        planes, fm = fwd(spec, seg)
                        require(torch.equal(planes, planes_p)
                                and torch.equal(fm, fm_p),
                                f"{spec} {fname} B={B} T={T} {kind}: planes "
                                "and final metrics")
                        err[fname] = max(err[fname],
                                         max_abs_diff(planes, planes_p),
                                         max_abs_diff(fm, fm_p))
                        cases += 1
        print(f"[compare] generic forward k={k} NS={1 << logns} n={n}: "
              f"{cpw} channels a warp ({1 << logc} lanes a channel), "
              f"{cases} cases (noisy, garbage; B = 1, {2 * cpw + 3}; T = 1, "
              f"S+1, 31, 32, 33, 100): planes and final metrics equal to "
              "the plain forward")


def generic_walk_shapes(source=None):
    """(k, log2 NS, log2 lanes a channel, log2 channels a warp, log2 steps
    a segment, warm-up steps) of each case of the generic walk's dispatch
    switch in csrc/acs_generic.cu (or `source`)."""
    import re
    src = Path(source or ROOT / SOURCES["traceback_generic"][0]).read_text()
    return [tuple(map(int, m)) for m in re.findall(
        r"launch_walk<(\d+), (\d+), (\d+), (\d+), (\d+), (\d+)>"
        r"\(WALK_ARGS\)", src)]


def compare_generic_walks(fec, gk, dev, err, rng):
    """Every instantiation of the generic walk against the plain walk on
    the card: at each (k, NS) of its dispatch switch a random code, on
    uniform decision words (bits past NS zero: most guesses go wrong, so
    segments are walked again) and on the forward's planes of random
    segments; B = 1 and 2 CPW + 3 (CPW: the shape's channels a warp, a
    block's) at T = 1, S + 1, 31, 32, 33 and 100, and B = 3 at T = 5000
    (several windows); t_actual = T and T - 2 (within T_stride); the whole
    message and `cut_bits` of it; bits and bytes; through both entries at
    k = 2, NS = 64."""
    import numpy as np
    import torch
    pad_and_pack = fec.ops.viterbi.pad_and_pack
    for i, (k, logns, logc, logcpw, logg, wu) in enumerate(
            generic_walk_shapes()):
        n, K, cpw = 1 + i % 8, logns // k + 1, 1 << logcpw
        NS, S = 1 << logns, logns // k
        spec = None
        while spec is None or not gk.generic_kernel_supports(spec):
            spec = fec.CodeSpec(K=K, k=k, g=tuple(
                int(x) for x in rng.integers(1, 1 << (k * K), n)))
        walks = [(t, tb) for _, t, _, _, tb, _ in generic_pairs(gk, spec)]
        runs = [(B, T) for B in (1, 2 * cpw + 3)
                for T in (1, S + 1, 31, 32, 33, 100)] + [(3, 5000)]
        cases = 0
        for kind in ("random", "forward"):
            for B, T in runs:
                if kind == "random":
                    words = rng.integers(-2 ** 31, 2 ** 31,
                                         (B, T, k, (NS + 31) // 32))
                    if NS < 32:
                        words &= (1 << NS) - 1
                    planes = torch.from_numpy(words.astype(np.int32)).to(dev)
                else:
                    planes = gk.acs_forward_batch_generic(
                        spec, torch.from_numpy(rng.integers(
                            0, 1 << n, (B, T)).astype(np.uint8)).to(dev))[0]
                for ta in sorted({T, T - 2} & set(range(S, T + 1))):
                    full = (ta - S) * k
                    want = gk.traceback_batch_generic_plain(spec, planes, ta,
                                                            full, "bits")
                    for L in sorted({full, cut_bits(full)}):
                        for out in ("bytes", "bits"):
                            ref = (pad_and_pack(want[:, :L]) if out == "bytes"
                                   else want[:, :L])
                            for tname, tb in walks:
                                got = tb(spec, planes, ta, L, out)
                                require(torch.equal(got, ref),
                                        f"{spec} {tname} {kind} B={B} T={T} "
                                        f"t_actual={ta} L={L} {out}")
                                err[tname] = max(err[tname],
                                                 max_abs_diff(got, ref))
                                cases += 1
        print(f"[compare] generic walk k={k} NS={NS}: {1 << logc} lanes a "
              f"channel, {cpw} channel(s) a warp, {1 << logg} steps a "
              f"segment, warm-up {wu}; {cases} cases (random and forward "
              f"planes; B = 1, {2 * cpw + 3}: T = 1, S+1, 31, 32, 33, 100; "
              "B = 3: T = 5000; t_actual = T, T - 2; whole and cut "
              "messages): bits and bytes equal to the plain walk")


def phase_compare_generic(fec, gk, dev, err):
    """The generic-k kernels against their plain versions on the card, on
    every code of the slice, noisy and garbage inputs and the edges, and
    the forward and the walk at every instantiation of their dispatch
    switches."""
    import numpy as np
    import torch
    rng = np.random.default_rng(2030)
    cases = [(name, generic_spec(fec, code)) for name, code in (
        GENERIC_SMALL_CODES + tuple(c[:2] for c in GENERIC_MAIN[:3]))]

    def encoded(spec, B, symbols):
        msgs = rng.integers(0, 2, (B, symbols * spec.k), dtype=np.uint8)
        seg, _ = fec.encode_bits(spec, torch.from_numpy(msgs).to(dev))
        return msgs, seg.cpu().numpy()

    for name, spec in cases:
        route = fec.select_kernel(spec)
        require(route == (fec.kernels.K2 if gk.k2_supported(spec)
                          else fec.kernels.GENERIC_K),
                f"{name} on the generic-k routes ({route})")
        msgs, clean = encoded(spec, SMALL_B, GENERIC_SMALL_SYMBOLS)
        draws = {f"p={p:.2f}": corrupt(rng, clean, p, spec.n) for p in NOISE}
        draws["garbage"] = rng.integers(0, 1 << spec.n, clean.shape).astype(
            np.uint8)
        draws["B=1"] = corrupt(
            rng, encoded(spec, 1, GENERIC_SMALL_SYMBOLS)[1], 0.25, spec.n)
        draws["T=S+1"] = corrupt(rng, encoded(spec, SMALL_B, 1)[1], 0.25,
                                 spec.n)
        bits = {label: compare_generic(fec, gk, spec,
                                       torch.from_numpy(seg).to(dev), err)
                for label, seg in draws.items()}
        ber = float((bits[f"p={NOISE[0]:.2f}"].cpu().numpy() != msgs).mean())
        print(f"[compare] {name:16s} generic-k route {route}, B={SMALL_B} "
              f"T={clean.shape[1]}: {', '.join(draws)}: planes, final "
              "metrics, bits and bytes equal to the plain versions, entries "
              f"equal to the plain decode; BER at p={NOISE[0]} {ber:.4f}")
    compare_generic_shapes(fec, gk, dev, err, rng)
    compare_generic_walks(fec, gk, dev, err, rng)


def phase_generic(fec, acs, gk, dev, err):
    """The generic-k main path at full width.  Returns (inputs for the
    timing phase, launches by path, plain ms, a summary)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(MAIN_SEED)
    inputs, launches, plain_ms, summary = [], {}, {}, {}
    for name, code, L in GENERIC_MAIN:
        spec = generic_spec(fec, code)
        msgs = rng.integers(0, 2, (MAIN_B, L), dtype=np.uint8)
        seg, _ = fec.encode_bits(spec, torch.from_numpy(msgs).to(dev))
        seg = torch.from_numpy(corrupt(rng, seg.cpu().numpy(), MAIN_NOISE,
                                       spec.n)).to(dev)
        T = seg.shape[1]
        route = fec.select_kernel(spec)
        fname, tname, fwd, fwd_p, tb, tb_p = generic_pairs(gk, spec)[-1]
        out, launches[f"generic {name} bytes"] = drive(
            acs, lambda: fec.viterbi_decode_batch_bytes(spec, seg))
        bits, launches[f"generic {name} bits"] = drive(
            acs, lambda: fec.viterbi_decode_batch(spec, seg))
        for path in (f"generic {name} bytes", f"generic {name} bits"):
            require(launches[path][fname] > 0 and launches[path][tname] > 0,
                    f"{path}: {fname} and {tname} launched: {launches[path]}")
        want, plain_ms[f"generic {name}"] = time_once(
            lambda: fec.viterbi_decode(spec, seg))
        require(tuple(bits.shape) == (MAIN_B, L) and torch.equal(bits, want),
                f"{name}: bits equal to the plain decode on the card")
        require(torch.equal(out, fec.ops.viterbi.pad_and_pack(want)),
                f"{name}: bytes equal to the plain decode on the card")
        del want
        planes, fm = fwd(spec, seg)
        (planes_p, fm_p), plain_ms[f"{fname} {name}"] = time_once(
            lambda: fwd_p(spec, seg))
        require(torch.equal(planes, planes_p) and torch.equal(fm, fm_p),
                f"{name}: {fname} planes and final metrics at full size")
        got_p, plain_ms[f"{tname} {name}"] = time_once(
            lambda: tb_p(spec, planes_p, T, L, "bytes"))
        require(torch.equal(got_p, out), f"{name}: plain {tname} bytes")
        err[fname] = max(err[fname], max_abs_diff(planes, planes_p),
                         max_abs_diff(fm, fm_p))
        err[tname] = max(err[tname], max_abs_diff(out, got_p))
        del planes_p, fm_p, got_p
        ber = ber_of_bytes(out, msgs)
        require(ber < GENERIC_BER_LIMIT, f"{name}: BER {ber} < "
                f"{GENERIC_BER_LIMIT}")
        summary[name] = {"spec": str(spec), "route": route, "T": T, "L": L,
                         "ber": ber}
        inputs.append((name, spec, seg, L))
        print(f"[generic] {name} ({spec}) route {route}, B={MAIN_B} T={T} "
              f"L={L} p={MAIN_NOISE}: BER {ber:.4e} (< {GENERIC_BER_LIMIT}),"
              f" bits and bytes equal to the plain decode on the card, "
              f"launches {launches[f'generic {name} bytes']}")
    return inputs, launches, plain_ms, summary


def generic_times(fec, gk, inputs):
    """Device ms of TIMED_CALLS calls on distinct inputs (row rotations) of
    each generic-k kernel and each whole byte decode at the main path's
    sizes, and of the runtime-k kernels on the k2 code's inputs."""
    import torch
    runs = {}
    for name, spec, seg, L in inputs:
        T = seg.shape[1]
        bufs = [torch.roll(seg, r + 1, dims=0) for r in range(TIMED_CALLS)]
        for fname, tname, fwd, _, tb, _ in generic_pairs(gk, spec):
            runs[f"{fname} {name}"] = device_times(
                lambda s: fwd(spec, s), bufs)
            planes = [fwd(spec, s)[0] for s in bufs]
            runs[f"{tname} {name}"] = device_times(
                lambda p: tb(spec, p, T, L, "bytes"), planes)
            del planes
        runs[f"generic {name}"] = device_times(
            lambda s: fec.viterbi_decode_batch_bytes(spec, s), bufs)
        del bufs
    return runs


# ---------------------------------------------------------------------------
# Small and wide butterfly codes: TPU kernel K12 (NS < 64), K11 (the fused
# int32 kernels) and the SWAR kernels at NS >= 512, on csrc/acs_small.cu,
# csrc/acs_wide.cu, the one-word walks of csrc/traceback_k1.cu and the wide
# walks of csrc/traceback_wide.cu.


def nonzero(launches):
    """Launches by path, the kernels launched only."""
    return {p: {k: v for k, v in c.items() if v} for p, c in launches.items()}


def walk_key(acs, spec, mode=""):
    """The kernels line's row of a walk's launch: the wide walk's at
    NS >= 512; the one-word instantiation's own row (" w1") for the
    terminated and ragged walks at NS <= 32; else the walk's."""
    name = acs._walk_kernel(spec, mode)
    if spec.num_states < 64 and mode in ("", "_ragged"):
        name += " w1"
    return name


def bfly_spec(fec, rng, NS, n):
    """A random poly-symmetric k = 1 code with NS states and n generators:
    each taps the newest and the oldest bit, the bits between at random."""
    K = NS.bit_length()
    inner = 1 << max(K - 2, 0)
    return fec.CodeSpec(K=K, g=tuple(
        (1 << (K - 1)) | 1 | (int(rng.integers(0, inner)) << 1 if K > 2 else 0)
        for _ in range(n)))


def compare_bfly_hard(fec, acs, spec, seg, err, rng):
    """The hard forward of `spec`'s size and its walks against their plain
    versions on one batch of segments: words and final metrics (also from
    carried metrics), terminated bits and bytes at two lengths, ragged, and
    `viterbi_decode_batch` against the plain decode.  Returns the words."""
    import torch
    T = seg.shape[1]
    fk = acs._forward_kernel(spec, False)
    words, fm = acs.acs_forward_batch(spec, seg)
    words_p, fm_p = acs.acs_forward_batch_plain(spec, seg)
    require(torch.equal(words, words_p) and torch.equal(fm, fm_p),
            f"{spec} {fk} words and final metrics")
    words2, fm2 = acs.acs_forward_batch(spec, seg, initial_metrics=fm)
    words2_p, fm2_p = acs.acs_forward_batch_plain(spec, seg, fm_p)
    require(torch.equal(words2, words2_p) and torch.equal(fm2, fm2_p),
            f"{spec} {fk} carried initial metrics")
    err[fk] = max(err[fk], max_abs_diff(words, words_p),
                  max_abs_diff(fm, fm_p), max_abs_diff(words2, words2_p),
                  max_abs_diff(fm2, fm2_p))
    if T < spec.S:
        return words  # no terminated packet is this short
    tk = walk_key(acs, spec)
    full = T - spec.S
    for L in sorted({full, cut_bits(full)}):
        for out in ("bytes", "bits"):
            got = acs.traceback_batch(spec, words, T, L, out)
            want = acs.traceback_batch_plain(spec, words_p, T, L, out)
            require(torch.equal(got, want), f"{spec} {tk} L={L} {out}")
            err[tk] = max(err[tk], max_abs_diff(got, want))
    compare_ragged(acs, spec, words, err, rng, walk_key(acs, spec, "_ragged"))
    require(torch.equal(fec.viterbi_decode_batch(spec, seg),
                        fec.viterbi_decode(spec, seg)),
            f"{spec} viterbi_decode_batch equal to the plain decode")
    return words


def compare_bfly_soft(fec, acs, spec, q, err):
    """The soft forward of `spec`'s size against its plain version at qclip
    QMAX and 127 (default, carried and zero start), and
    `viterbi_decode_batch_soft` against the plain soft decode."""
    import torch
    fk = acs._forward_kernel(spec, True)
    for qclip in (QMAX, 127):
        compare_soft(fec, acs, spec, q, qclip, err, fk)
    qc = fec.kernels.soft_qclip(spec, QMAX)
    require(torch.equal(fec.viterbi_decode_batch_soft(spec, q, qmax=QMAX),
                        fec.viterbi_decode_soft(spec,
                                                acs.condition_qllrs(q, qc))),
            f"{spec} viterbi_decode_batch_soft equal to the plain decode")


def rows_to_bits(rows):
    """JAX's packed rows uint8 [T/8, B] (bit j of row g = step 8g + j) ->
    bits uint8 [B, T]."""
    import torch
    shifts = torch.arange(8, dtype=torch.int32, device=rows.device)
    B = rows.shape[1]
    return ((rows.T.to(torch.int32)[..., None] >> shifts) & 1).reshape(
        B, -1).to(torch.uint8)


def pad_steps(x, multiple):
    """x [B, T, ...] padded with zero steps to a multiple of `multiple`."""
    import torch
    pad = -x.shape[1] % multiple
    if not pad:
        return x
    return torch.cat([x, x.new_zeros((x.shape[0], pad) + x.shape[2:])], 1)


def compare_fused(fec, acs, spec, seg, q, err, rng):
    """The JAX names of the fused kernels (K11) on the kernels against
    their plain routes and the block decode: forwards at init_chunk 0, -1
    and 1 (hard and soft), `traceback_batch_fused` and the masked form
    from random one-hot starts over a live prefix."""
    import numpy as np
    import torch
    from convolutionalencdec_tpu_torch.kernels import fused
    T = seg.shape[1]
    seg_p, q_p = pad_steps(seg, 8), pad_steps(q, 8)
    Tp = seg_p.shape[1]
    B = seg.shape[0]
    for soft, x in ((False, seg_p), (True, q_p)):
        fwd = (fused.acs_forward_batch_fused_soft if soft
               else fused.acs_forward_batch_fused)
        fk = acs._forward_kernel(spec, soft)
        for init_chunk in (0, -1, 1):
            words, fm = fwd(spec, x, init_chunk)
            with plain_routes(fused, acs, FUSED_WRAPPERS):
                words_p, fm_p = fwd(spec, x, init_chunk)
            require(torch.equal(words, words_p) and torch.equal(fm, fm_p),
                    f"{spec} fused forward soft={soft} init_chunk "
                    f"{init_chunk}")
            err[fk] = max(err[fk], max_abs_diff(words, words_p),
                          max_abs_diff(fm, fm_p))
        words, _ = fwd(spec, x)
        mk = walk_key(acs, spec, "_masked")
        rows = fused.traceback_batch_fused(spec, words, T)
        with plain_routes(fused, acs, FUSED_WRAPPERS):
            rows_p = fused.traceback_batch_fused(spec, words, T)
        require(torch.equal(rows, rows_p), f"{spec} traceback_batch_fused")
        block = (fec.viterbi_decode_batch_soft(spec, q, qmax=127) if soft
                 else fec.viterbi_decode_batch(spec, seg))
        require(torch.equal(rows_to_bits(rows)[:, :T - spec.S], block),
                f"{spec} traceback_batch_fused rows equal to the block "
                f"decode (soft={soft})")
        live = int(rng.integers(spec.S, T + 1))
        gmask = np.zeros((Tp // 8, 1), np.int32)
        gmask[:live // 8] = 0xFF
        if live % 8:
            gmask[live // 8] = (1 << (live % 8)) - 1
        h = torch.zeros((spec.num_states, B), dtype=torch.uint8,
                        device=seg.device)
        h[torch.from_numpy(rng.integers(0, spec.num_states, B)).to(
            seg.device), torch.arange(B, device=seg.device)] = 1
        rows = fused.traceback_batch_fused_masked(spec, words, gmask, h)
        with plain_routes(fused, acs, FUSED_WRAPPERS):
            rows_p = fused.traceback_batch_fused_masked(spec, words, gmask, h)
        require(torch.equal(rows, rows_p),
                f"{spec} traceback_batch_fused_masked live={live}")
        err[mk] = max(err[mk], max_abs_diff(rows, rows_p))


def wide_round_steps(source=None, soft=False):
    """NS -> the steps a round R at which the dispatch switch of
    csrc/acs_wide.cu (or of `source`, a copy of it) launches the hard wide
    forward (`soft`: the soft one, n <= 8), a block of NS >> R threads."""
    import re
    src = Path(source or ROOT / SOURCES["acs_wide_forward"][0]).read_text()
    launch = "launch_soft_round" if soft else "launch_round"
    return {int(ns): int(r) for ns, _, r in re.findall(
        rf"case (\d+): return {launch}<(\d+), (\d+)>", src)}


def wide_walk_consts(source=None):
    """The wide walk's constants (`kGCap`, `kWarm`, `kSegs`, `kWarps`,
    `kFill`) as csrc/traceback_wide.cu (or `source`, a copy of it) sets
    them."""
    import re
    src = Path(source or ROOT / SOURCES["traceback_wide"][0]).read_text()
    return {name: int(re.search(rf"constexpr int {name} = (\d+);",
                                src).group(1))
            for name in ("kGCap", "kWarm", "kSegs", "kWarps", "kFill")}


def wide_walk_lines(source=None):
    """[(NS, G's cap, warm-up steps, segments a window)] of each wide NS:
    its line of the wide walk's dispatch switch in csrc/traceback_wide.cu
    (or in `source`, a copy of it), with the file's three constants
    (`kGCap`, `kWarm`, `kSegs`), the same at every NS."""
    import re
    src = Path(source or ROOT / SOURCES["traceback_wide"][0]).read_text()
    c = wide_walk_consts(source)
    return [(int(ns), c["kGCap"], c["kWarm"], c["kSegs"])
            for ns, log in re.findall(
                r"case (\d+): return launch_walk<(\d+), M>\(a, s\);", src)
            if int(ns) == 1 << int(log)]


def wide_walk_warps(walks, source=None):
    """P, the warps a block of the wide walk takes when a launch walks
    `walks` (channel, walk) pairs: the most, up to the file's `kWarps`,
    that keep walks x P within its `kFill` (`launch_walk` in
    csrc/traceback_wide.cu, or in `source`, a copy of it): with kWarps 8
    and kFill 2048, 8 up to 256 walks, 4 up to 512, 2 up to 1024 and 1
    from 1025."""
    c = wide_walk_consts(source)
    warps = 1
    while warps < c["kWarps"] and walks * warps * 2 <= c["kFill"]:
        warps *= 2
    return warps


def wide_walk_lengths(S, spw, warps):
    """The step counts, each within one window of a walk of `warps` warps,
    at which the wide walks are held to their plain versions: 1, 5 (below
    a segment), S + 5 and warps x spw x 16 - 5 (segments of 16 steps, 5
    short of a window)."""
    return (1, 5, S + 5, warps * spw * 16 - 5)


def wide_walk_windows(spw, gcap, warps, windows):
    """Steps that take a walk of `warps` warps over `windows` windows: the
    G cap's windows (warps x spw x gcap steps each) but the top one, which
    holds 37 steps."""
    return (windows - 1) * warps * spw * gcap + 37


def compare_wide_walks(fec, acs, dev, err, rng):
    """The four wide walks (`traceback_wide`, `_masked`, `_ragged` and
    `_multi`, csrc/traceback_wide.cu) against their plain versions at every
    line of their dispatch switch (NS = 512 ... 16384): a random rate-1/4
    code; the forward's words of 3%-corrupted packets and uniform garbage
    words (which send the warm-up guesses wrong, so segments are walked
    again); B = 3 at `wide_walk_lengths` of the warps its launches take
    (one window: `compare_wide_windows` takes more); terminated at
    t_actual = T and T - 2 (rows longer than the packet),
    the whole message and a cut one; masked from random starts at live 0,
    S, T - 1 and T, out_steps T and a cut one; ragged (`compare_wide_ragged`)
    and list (`compare_wide_multi`) on 8 rows of the same kind; bits and
    bytes."""
    import numpy as np
    import torch
    pad_and_pack = fec.ops.viterbi.pad_and_pack
    warps = wide_walk_warps(3)  # 8 rows and 8 x 4 list walks take as many
    for NS, gcap, wu, spw in wide_walk_lines():
        spec = bfly_spec(fec, rng, NS, 4)
        S, cases = spec.S, 0
        for T in wide_walk_lengths(S, spw, warps):
            for kind in ("noisy", "garbage"):
                if kind == "garbage":
                    rows = torch.from_numpy(rng.integers(
                        -2 ** 31, 2 ** 31, (8, T, NS // 32)).astype(
                            np.int32)).to(dev)
                else:
                    msgs = rng.integers(0, 2, (8, max(T - S, 1)),
                                        dtype=np.uint8)
                    seg = fec.encode_bits(spec, torch.from_numpy(msgs).to(
                        dev))[0][:, :T]
                    seg = torch.from_numpy(corrupt(
                        rng, seg.cpu().numpy(), NOISE[0], spec.n)).to(dev)
                    rows = acs.acs_forward_batch(spec, seg)[0]
                cases += compare_wide_ragged(fec, acs, spec, rows, err, rng)
                cases += compare_wide_multi(fec, acs, spec, rows, err, rng)
                words = rows[:3]
                for ta in sorted({T, T - 2} & set(range(S, T + 1))):
                    full = ta - S
                    want = acs.traceback_batch_plain(spec, words, ta, full,
                                                     "bits")
                    for L in sorted({full, cut_bits(full)}):
                        for out in ("bits", "bytes"):
                            ref = (pad_and_pack(want[:, :L]) if out == "bytes"
                                   else want[:, :L])
                            got = acs.traceback_batch(spec, words, ta, L, out)
                            require(torch.equal(got, ref),
                                    f"{spec} traceback_wide {kind} T={T} "
                                    f"t_actual={ta} L={L} {out}")
                            err["traceback_wide"] = max(
                                err["traceback_wide"], max_abs_diff(got, ref))
                            cases += 1
                starts = torch.from_numpy(rng.integers(0, NS, 3).astype(
                    np.int32)).to(dev)
                for live in sorted({0, min(S, T), T - 1, T}):
                    want = acs.traceback_batch_masked_plain(
                        spec, words, starts, live, T, "bits")
                    for L in sorted({T, cut_bits(T)}):
                        for out in ("bits", "bytes"):
                            ref = (pad_and_pack(want[:, :L]) if out == "bytes"
                                   else want[:, :L])
                            got = acs.traceback_batch_masked(
                                spec, words, starts, live, L, out)
                            require(torch.equal(got, ref),
                                    f"{spec} traceback_wide_masked {kind} "
                                    f"T={T} live={live} L={L} {out}")
                            err["traceback_wide_masked"] = max(
                                err["traceback_wide_masked"],
                                max_abs_diff(got, ref))
                            cases += 1
                del words, rows
        print(f"[compare] wide walks NS={NS}: G cap {gcap}, warm-up {wu}, "
              f"{spw} segments a warp, {warps} warps a walk; {cases} cases "
              "(forward and garbage words; B = 3: T = "
              f"{', '.join(map(str, wide_walk_lengths(S, spw, warps)))}; "
              "terminated and masked, whole and cut rows; ragged and list "
              "on 8 rows): bits and bytes equal to the plain walks")


def compare_wide_windows(fec, acs, dev, err, rng):
    """The four wide walks over more than one window, at every line of
    their dispatch switch, against their plain versions on the first
    WIDE_WINDOW_ROWS rows: a batch of one warp a walk (the main paths'
    launch shape: B = 2048 at (l)), the smallest such B, over three
    windows, on the forward's words of 3%-corrupted packets and on
    garbage words; and 8 rows (8 warps a walk, as the checks of one
    window take) over two windows of garbage words.  Terminated at
    t_actual = T - 2, masked at live T - 1 from random starts, ragged and
    list as `compare_wide_ragged` and `compare_wide_multi` (the edge
    lengths, NW = 1 and 4 from steps 13 and T // 3); whole and cut rows,
    bits and bytes."""
    import numpy as np
    import torch
    one = wide_walk_consts()["kFill"] // 2 + 1
    require(wide_walk_warps(one) == 1, f"{one} walks take one warp")
    R = WIDE_WINDOW_ROWS
    for NS, gcap, wu, spw in wide_walk_lines():
        spec = bfly_spec(fec, rng, NS, 4)
        S, cases, shapes = spec.S, 0, []
        for B, windows, kind in ((one, 3, "noisy"), (one, 3, "garbage"),
                                 (8, 2, "garbage")):
            warps = wide_walk_warps(B)
            T = wide_walk_windows(spw, gcap, warps, windows)
            if kind == "garbage":
                gen = torch.Generator(device=dev).manual_seed(
                    int(rng.integers(1 << 62)))
                words = torch.randint(0, 256, (B, T, NS // 8),
                                      dtype=torch.uint8, device=dev,
                                      generator=gen).view(torch.int32)
            else:
                msgs = rng.integers(0, 2, (B, T - S), dtype=np.uint8)
                seg = fec.encode_bits(spec, torch.from_numpy(msgs).to(
                    dev))[0]
                seg = torch.from_numpy(corrupt(rng, seg.cpu().numpy(),
                                               NOISE[0], spec.n)).to(dev)
                words = acs.acs_forward_batch(spec, seg)[0]
                del seg
            cases += compare_wide_ragged(fec, acs, spec, words, err, rng,
                                         rows=R)
            cases += compare_wide_multi(fec, acs, spec, words, err, rng,
                                        rows=R)
            top = words[:R]
            full = T - 2 - S
            want = acs.traceback_batch_plain(spec, top, T - 2, full, "bits")
            starts = torch.from_numpy(rng.integers(0, NS, B).astype(
                np.int32)).to(dev)
            want_m = acs.traceback_batch_masked_plain(spec, top, starts[:R],
                                                      T - 1, T, "bits")
            for L in (full, cut_bits(full)):
                for out in ("bits", "bytes"):
                    ref = want[:, :L]
                    ref_m = want_m[:, :L]
                    if out == "bytes":
                        ref = fec.ops.viterbi.pad_and_pack(ref)
                        ref_m = fec.ops.viterbi.pad_and_pack(ref_m)
                    got = acs.traceback_batch(spec, words, T - 2, L, out)[:R]
                    got_m = acs.traceback_batch_masked(spec, words, starts,
                                                       T - 1, L, out)[:R]
                    require(torch.equal(got, ref), f"{spec} traceback_wide "
                            f"{kind} B={B} T={T} L={L} {out}")
                    require(torch.equal(got_m, ref_m),
                            f"{spec} traceback_wide_masked {kind} B={B} "
                            f"T={T} L={L} {out}")
                    err["traceback_wide"] = max(err["traceback_wide"],
                                                max_abs_diff(got, ref))
                    err["traceback_wide_masked"] = max(
                        err["traceback_wide_masked"],
                        max_abs_diff(got_m, ref_m))
                    cases += 2
            shapes.append(f"B={B} T={T} {kind}, a walk on {warps} warp(s)")
            del words, top, want, want_m
        print(f"[compare] wide walks NS={NS} over windows: {cases} cases "
              f"({'; '.join(shapes)}; the plain walks on {R} rows): bits "
              "and bytes equal")


def compare_wide_ragged(fec, acs, spec, words, err, rng, lens=None,
                        rows=None):
    """`traceback_wide_ragged` against its plain version on one batch of
    decision words: lengths 0, 1, S, S + 1, T - 1, T, T + 3 and -2 (clamped
    to [0, T]) then random ones, or `lens`; row widths T - S and a cut one,
    bits and bytes (none below S steps).  The walk takes the whole batch,
    the plain version its first `rows` rows (default all).  Returns the
    cases held."""
    import numpy as np
    import torch
    B, T, _ = words.shape
    S = spec.S
    if T < S:
        return 0
    if lens is None:
        edge = [0, 1, S, S + 1, T - 1, T, T + 3, -2]
        lens = torch.from_numpy(np.concatenate(
            [edge, rng.integers(0, T + 1, max(B - 8, 0))])[:B].astype(
                np.int32)).to(words.device)
    R = B if rows is None else rows
    want = acs.traceback_batch_ragged_plain(spec, words[:R],
                                            lens[:R].clamp(0, T), T - S,
                                            "bits")
    cases = 0
    for L in sorted({T - S, cut_bits(T - S)}):
        for out in ("bits", "bytes"):
            ref = (fec.ops.viterbi.pad_and_pack(want[:, :L]) if out == "bytes"
                   else want[:, :L])
            got = acs.traceback_batch_ragged(spec, words, lens, L, out)[:R]
            require(torch.equal(got, ref), f"{spec} traceback_wide_ragged "
                    f"B={B} T={T} L={L} {out} lengths {lens.tolist()[:8]}")
            err["traceback_wide_ragged"] = max(err["traceback_wide_ragged"],
                                               max_abs_diff(got, ref))
            cases += 1
    return cases


def compare_wide_multi(fec, acs, spec, words, err, rng, calls=None,
                       rows=None):
    """`traceback_wide_multi` against its plain version on one batch of
    decision words: NW = 1 from out_start min(13, T) (not a multiple of 8)
    with every step live, and NW = 4 from out_start T // 3 with live
    T - 9, or `calls` [(starts [B, NW], live, out_start)]; random starts;
    the window to step T and one 11 steps shorter, bits and bytes.  The
    walk takes the whole batch, the plain version its first `rows` rows
    (default all).  Returns the cases held."""
    import numpy as np
    import torch
    B, T, _ = words.shape
    NS = spec.num_states
    R = B if rows is None else rows
    if calls is None:
        calls = [(rng.integers(0, NS, (B, nw)), live, start)
                 for nw, live, start in ((1, T, min(13, T)),
                                         (4, max(T - 9, 0), T // 3))]
    cases = 0
    for starts, live, start in calls:
        starts = torch.as_tensor(starts, dtype=torch.int32,
                                 device=words.device)
        want = acs.traceback_batch_multi_plain(spec, words[:R], starts[:R],
                                               live, start, T - start,
                                               "bits")
        for steps in sorted({T - start, max(T - start - 11, 0)}):
            for out in ("bits", "bytes"):
                ref = want[..., :steps]
                if out == "bytes":
                    ref = fec.ops.viterbi.pad_and_pack(ref)
                got = acs.traceback_batch_multi(spec, words, starts, live,
                                                start, steps, out)[:R]
                require(torch.equal(got, ref),
                        f"{spec} traceback_wide_multi B={B} T={T} "
                        f"NW={starts.shape[1]} live={live} "
                        f"out_start={start} out_steps={steps} {out}")
                err["traceback_wide_multi"] = max(
                    err["traceback_wide_multi"], max_abs_diff(got, ref))
                cases += 1
    return cases


def compare_wide_rounds(fec, acs, dev, err, rng):
    """The hard wide forward's rounds (R steps in registers between two
    barriers, the last round T mod R steps) against the plain forward at
    NS = WIDE_ROUND_NS: T = m*R + j for every residue j of the launch's R
    and every T < R, fresh and carried start metrics, noisy and garbage
    segments."""
    import numpy as np
    import torch
    steps = wide_round_steps()
    for NS in WIDE_ROUND_NS:
        R = steps[NS]
        spec = bfly_spec(fec, rng, NS, 4)
        lengths = list(range(1, R)) + [WIDE_ROUND_M * R + j for j in range(R)]
        for T in lengths:
            for kind in ("noisy", "garbage"):
                if kind == "garbage":
                    seg = rng.integers(0, 1 << spec.n, (SMALL_B, T))
                else:
                    seg = corrupt(rng, encode_reference_np(spec, rng.integers(
                        0, 2, (SMALL_B, T), dtype=np.uint8))[:, :T],
                        NOISE[0], spec.n)
                seg = torch.from_numpy(seg.astype(np.uint8)).to(dev)
                words, fm = acs.acs_forward_batch(spec, seg)
                words_p, fm_p = acs.acs_forward_batch_plain(spec, seg)
                words2, fm2 = acs.acs_forward_batch(spec, seg.flip(0), fm)
                words2_p, fm2_p = acs.acs_forward_batch_plain(
                    spec, seg.flip(0), fm_p)
                require(torch.equal(words, words_p) and torch.equal(fm, fm_p)
                        and torch.equal(words2, words2_p)
                        and torch.equal(fm2, fm2_p),
                        f"{spec} acs_wide_forward R={R} T={T} {kind}")
                err["acs_wide_forward"] = max(
                    err["acs_wide_forward"], max_abs_diff(words, words_p),
                    max_abs_diff(fm, fm_p), max_abs_diff(words2, words2_p),
                    max_abs_diff(fm2, fm2_p))
        print(f"[compare] NS={NS:5d} acs_wide_forward: R={R}, {NS >> R} "
              f"threads a block; T = {lengths} (every T mod R, T < R), "
              "noisy and garbage, fresh and carried metrics: words and "
              "final metrics equal")


def compare_wide_soft_rounds(fec, acs, dev, err, rng):
    """The soft wide forward's rounds (the hard one's schedule, edge metrics
    from a shared-memory table a step) against the plain forward at
    NS = WIDE_ROUND_NS: T = m*R + j for every residue j of the launch's R
    and every T < R, noisy and garbage LLRs over the whole int8 range (-128
    included), the three conditionings (clamp to [-7, 7], [-127, 127],
    [-128, 127]) and n = 1 ... 8 in turn, fresh and carried start metrics;
    and an n = 9 code, which keeps the barrier-a-step kernel."""
    import numpy as np
    import torch
    steps = wide_round_steps(soft=True)
    modes = ((QMAX, True), (127, True), (127, False))
    for NS in WIDE_ROUND_NS:
        R = steps[NS]
        lengths = list(range(1, R)) + [WIDE_ROUND_M * R + j for j in range(R)]
        cases = [(T, kind) for T in lengths for kind in ("noisy", "garbage")]
        cases.append((lengths[-1], "n = 9"))
        for i, (T, kind) in enumerate(cases):
            n = 9 if kind == "n = 9" else 1 + i % 8
            qclip, floor = modes[i % 3]
            spec = bfly_spec(fec, rng, NS, n)
            if kind == "noisy":
                # Encoded bits as LLRs of magnitude 1..7, 10% of them
                # flipped, 5% saturated at +-127 or -128.
                bits = (encode_reference_np(spec, rng.integers(
                    0, 2, (SMALL_B, T), dtype=np.uint8))[:, :T, None]
                        >> np.arange(n)) & 1
                q = (1 - 2 * bits.astype(np.int64)) * rng.integers(
                    1, 8, bits.shape)
                q = np.where(rng.random(q.shape) < 0.1, -q, q)
                sat = rng.choice(np.array([127, -127, -128]), q.shape)
                q = np.where(rng.random(q.shape) < 0.05, sat, q)
            else:
                q = rng.integers(-128, 128, (SMALL_B, T, n))
            q = torch.from_numpy(q.astype(np.int8)).to(dev)
            words, fm = acs.acs_forward_batch_soft(spec, q, qclip, None, floor)
            words_p, fm_p = acs.acs_forward_batch_soft_plain(spec, q, qclip,
                                                             None, floor)
            q2 = q.flip(0).contiguous()
            words2, fm2 = acs.acs_forward_batch_soft(spec, q2, qclip, fm,
                                                     floor)
            words2_p, fm2_p = acs.acs_forward_batch_soft_plain(
                spec, q2, qclip, fm_p, floor)
            require(torch.equal(words, words_p) and torch.equal(fm, fm_p)
                    and torch.equal(words2, words2_p)
                    and torch.equal(fm2, fm2_p),
                    f"{spec} acs_soft_wide_forward R={R} T={T} {kind} "
                    f"qclip={qclip} floor={floor}")
            err["acs_soft_wide_forward"] = max(
                err["acs_soft_wide_forward"], max_abs_diff(words, words_p),
                max_abs_diff(fm, fm_p), max_abs_diff(words2, words2_p),
                max_abs_diff(fm2, fm2_p))
        print(f"[compare] NS={NS:5d} acs_soft_wide_forward: R={R}, "
              f"{NS >> R} threads a block; T = {lengths} (every T mod R, "
              "T < R), noisy and garbage int8 LLRs, clamps [-7, 7], "
              "[-127, 127], [-128, 127], n = 1..8 and 9, fresh and carried "
              "metrics: words and final metrics equal")


def phase_compare_butterfly(fec, acs, dev, err):
    """The small and wide butterfly kernels against their plain versions on
    the card: random poly-symmetric codes at every small NS with n = 1..8
    (soft also n = 9 and 12), at NS = 64 and 256 with n = 5..8, at every
    wide NS with n = 2..8 (soft also n = 9); noisy and garbage inputs; the
    edge shapes; all four walks at NS = 16 and 16384; the K11 names."""
    import numpy as np
    import torch
    rng = np.random.default_rng(2031)

    def segments(spec, B, L, kind):
        msgs = rng.integers(0, 2, (B, L), dtype=np.uint8)
        coded = encode_reference_np(spec, msgs)
        if kind == "garbage":
            coded = rng.integers(0, 1 << spec.n, coded.shape).astype(np.uint8)
        else:
            coded = corrupt(rng, coded, NOISE[0], spec.n)
        return torch.from_numpy(coded).to(dev)

    def llrs(spec, B, T, label):
        return torch.from_numpy(soft_draws(rng, (B, T, spec.n))[label].astype(
            np.int8)).to(dev)

    cases = [(NS, n, n <= 8) for NS in BFLY_SMALL_NS for n in range(1, 9)]
    cases += [(NS, n, False) for NS in BFLY_SMALL_NS for n in (9, 12)]
    cases += [(NS, n, True) for NS in BFLY_MID_NS for n in range(5, 9)]
    cases += [(NS, n, True) for NS in BFLY_WIDE_NS for n in range(2, 9)]
    cases += [(NS, 9, False) for NS in BFLY_WIDE_NS]
    for i, (NS, n, hard) in enumerate(cases):
        spec = bfly_spec(fec, rng, NS, n)
        L = BFLY_WIDE_L if NS >= 512 else BFLY_SMALL_L
        T = L + spec.S
        what = []
        if hard:
            require(fec.select_kernel(spec) == fec.kernels.BUTTERFLY,
                    f"{spec} on the butterfly route")
            kinds = ("noisy", "garbage") if i % 2 == 0 else ("noisy",)
            for kind in kinds:
                compare_bfly_hard(fec, acs, spec, segments(spec, SMALL_B, L,
                                                           kind), err, rng)
            what.append(f"hard {'/'.join(kinds)} ({acs._forward_kernel(spec, False)})")
        require(fec.select_kernel(spec, "soft") in (fec.kernels.SOFT,
                                                    fec.kernels.SOFT8),
                f"{spec} on a soft butterfly route")
        label = ("int8", "+-7", "+-7, 20% zeros")[i % 3]
        compare_bfly_soft(fec, acs, spec, llrs(spec, SMALL_B, T, label), err)
        what.append(f"soft {label} ({acs._forward_kernel(spec, True)})")
        print(f"[compare] NS={NS:5d} n={n:2d} {str(spec.g):40s} B={SMALL_B} "
              f"T={T}: {', '.join(what)}: words, final metrics, walks and "
              "entries equal")
    # Edge shapes at each family's sizes.
    for NS in (2, 16, 32, 512, 16384):
        spec = bfly_spec(fec, rng, NS, 3)
        for B, L in ((SMALL_B, 0), (1, BFLY_SMALL_L), (3, 1)):
            seg = segments(spec, B, L, "noisy")
            compare_bfly_hard(fec, acs, spec, seg, err, rng)
            compare_bfly_soft(fec, acs, spec,
                              llrs(spec, B, seg.shape[1], "int8"), err)
        for B, T in ((SMALL_B, 1), (0, 7)):
            seg = segments(spec, B, T, "noisy")[:, :T].contiguous()
            words = compare_bfly_hard(fec, acs, spec, seg, err, rng) if B \
                else acs.acs_forward_batch(spec, seg)[0]
            require(tuple(words.shape) == (B, T, acs.decision_words(spec)),
                    f"{spec} B={B} T={T} words' shape")
            compare_masked(acs, spec, words, err, rng,
                           walk_key(acs, spec, "_masked"))
        print(f"[compare] NS={NS:5d} edges: T = S, S + 1, 1; B = 1, 0: hard, "
              "soft and walks equal")
    # All four walks at NS = 16 and 16384.
    for NS in (16, 16384):
        spec = bfly_spec(fec, rng, NS, 2)
        seg = segments(spec, SMALL_B, BFLY_WIDE_L, "noisy")
        words = compare_bfly_hard(fec, acs, spec, seg, err, rng)
        compare_masked(acs, spec, words, err, rng,
                       walk_key(acs, spec, "_masked"))
        compare_multi(acs, spec, words, err, rng,
                      walk_key(acs, spec, "_multi"))
        print(f"[compare] NS={NS:5d} walks: terminated, ragged, masked, "
              "multi (NW 1, 2, 8, NS) equal")
    compare_wide_rounds(fec, acs, dev, err, rng)
    compare_wide_soft_rounds(fec, acs, dev, err, rng)
    compare_wide_walks(fec, acs, dev, err, rng)
    compare_wide_windows(fec, acs, dev, err, rng)
    # The K11 names, on an n = 6 code at NS = 64 and on (l)'s code.
    for spec in (bfly_spec(fec, rng, 64, 6), fec.CodeSpec(**WIDE_MAIN)):
        seg = segments(spec, SMALL_B, BFLY_WIDE_L + 3, "noisy")
        q = llrs(spec, SMALL_B, seg.shape[1], "int8")
        compare_fused(fec, acs, spec, seg, q, err, rng)
        print(f"[compare] {spec}: acs_forward_batch_fused(_soft) at "
              "init_chunk 0, -1, 1, traceback_batch_fused(_masked) equal "
              "to their plain routes and to the block decode")


def phase_small(fec, acs, dev, err):
    """(k): SMALL_MAIN at bench.py's working set through the hard byte
    decode, the soft byte decode over AWGN at 3 dB (qmax 7) and the ragged
    hard byte decode.  Returns (inputs for timing, launches by path, plain
    ms, summary)."""
    import numpy as np
    import torch
    from convolutionalencdec_tpu_torch.ops.viterbi import viterbi_decode_bytes
    spec = fec.PRESETS[SMALL_MAIN]
    rng = np.random.default_rng(MAIN_SEED)
    msgs = rng.integers(0, 2, (MAIN_B, MAIN_L), dtype=np.uint8)
    seg, _ = fec.encode_bits(spec, torch.from_numpy(msgs).to(dev))
    require(np.array_equal(seg.cpu().numpy(), encode_reference_np(spec, msgs)),
            f"{SMALL_MAIN} encode on the card equals the trellis walk")
    seg = torch.from_numpy(
        corrupt(rng, seg.cpu().numpy(), MAIN_NOISE, spec.n)).to(dev)
    T = seg.shape[1]
    launches, plain_ms = {}, {}

    out, launches["small hard"] = drive(
        acs, lambda: fec.viterbi_decode_batch_bytes(spec, seg))
    want, plain_ms["small hard"] = time_once(
        lambda: viterbi_decode_bytes(spec, seg))
    require(torch.equal(out, want), "(k) hard bytes equal to the plain "
            "decode on the card")
    hard_ber = ber_of_bytes(out, msgs)
    require(hard_ber < SMALL_BER_LIMIT, f"(k) hard BER {hard_ber} < "
            f"{SMALL_BER_LIMIT}")
    words, fm = acs.acs_forward_batch(spec, seg)
    (words_p, fm_p), plain_ms["acs_small_forward"] = time_once(
        lambda: acs.acs_forward_batch_plain(spec, seg))
    require(torch.equal(words, words_p) and torch.equal(fm, fm_p),
            "(k) words and final metrics at full size")
    tb_p, plain_ms["traceback_k1 w1"] = time_once(
        lambda: acs.traceback_batch_plain(spec, words_p, T, MAIN_L, "bytes"))
    require(torch.equal(tb_p, out), "(k) plain traceback bytes")
    err["acs_small_forward"] = max(err["acs_small_forward"],
                                   max_abs_diff(words, words_p),
                                   max_abs_diff(fm, fm_p))
    err["traceback_k1 w1"] = max(err["traceback_k1 w1"],
                                 max_abs_diff(out, tb_p))
    # The masked walk at NS = 16 on the forward's words: random starts,
    # the last 9 steps masked, every step's bit out.
    starts = torch.from_numpy(rng.integers(0, spec.num_states, MAIN_B).astype(
        np.int32)).to(dev)
    got = acs.traceback_batch_masked(spec, words, starts, T - 9, T, "bits")
    tb_p, plain_ms["traceback_k1_masked (k)"] = time_once(
        lambda: acs.traceback_batch_masked_plain(spec, words_p, starts, T - 9,
                                                 T, "bits"))
    require(torch.equal(got, tb_p), "(k) masked walk equal to the plain walk")
    err["traceback_k1_masked"] = max(err["traceback_k1_masked"],
                                     max_abs_diff(got, tb_p))
    del words_p, fm_p

    gen = torch.Generator(device=dev).manual_seed(MAIN_SEED)
    _, llr = soft_channel(fec, spec, torch.from_numpy(msgs).to(dev), gen,
                          spec.rate)
    q = fec.quantize_llrs(llr, qmax=QMAX).reshape(MAIN_B, T, spec.n).to(
        torch.int8)
    require(fec.select_kernel(spec, "soft", QMAX) == fec.kernels.SOFT
            and fec.kernels.soft_qclip(spec, QMAX) == 127,
            f"{SMALL_MAIN} soft on the any-int8 route")
    out_s, launches["small soft"] = drive(
        acs, lambda: fec.viterbi_decode_batch_soft_bytes(spec, q, qmax=QMAX))
    qc = acs.condition_qllrs(q, 127)
    want_s, plain_ms["small soft"] = time_once(
        lambda: fec.viterbi_decode_soft(spec, qc))
    require(torch.equal(out_s, fec.ops.viterbi.pad_and_pack(want_s)),
            "(k) soft bytes equal to the plain soft decode on the card")
    words, fm = acs.acs_forward_batch_soft(spec, q, 127)
    (words_p, fm_p), plain_ms["acs_soft_small_forward"] = time_once(
        lambda: acs.acs_forward_batch_soft_plain(spec, q, 127))
    require(torch.equal(words, words_p) and torch.equal(fm, fm_p),
            "(k) soft words and final metrics at full size")
    err["acs_soft_small_forward"] = max(err["acs_soft_small_forward"],
                                        max_abs_diff(words, words_p),
                                        max_abs_diff(fm, fm_p))
    del words_p, fm_p
    soft_ber = ber_of_bytes(out_s, msgs)

    rng_r = np.random.default_rng(MAIN_SEED + 1)
    lens_np = rng_r.integers(spec.S + 1, T + 1, MAIN_B).astype(np.int32)
    live = np.arange(MAIN_L)[None, :] < (lens_np - spec.S)[:, None]
    msgs_r = msgs * live.astype(np.uint8)
    seg_r, _ = fec.encode_bits(spec, torch.from_numpy(msgs_r).to(dev))
    seg_r = torch.from_numpy(
        corrupt(rng_r, seg_r.cpu().numpy(), MAIN_NOISE, spec.n)).to(dev)
    lens = torch.from_numpy(lens_np).to(dev)
    out_r, launches["small ragged"] = drive(
        acs, lambda: fec.viterbi_decode_batch_bytes_ragged(spec, seg_r, lens))
    want_r, plain_ms["small ragged"] = time_once(
        lambda: fec.ops.viterbi.pad_and_pack(fec.viterbi_decode_ragged(
            spec, seg_r, lens)))
    require(torch.equal(out_r, want_r), "(k) ragged bytes equal to the plain "
            "route on the card")
    words, _ = acs.acs_forward_batch(spec, seg_r)
    tb_p, plain_ms["traceback_k1_ragged w1"] = time_once(
        lambda: acs.traceback_batch_ragged_plain(spec, words, lens, MAIN_L,
                                                 "bytes"))
    require(torch.equal(tb_p, out_r), "(k) plain ragged traceback bytes")
    err["traceback_k1_ragged w1"] = max(err["traceback_k1_ragged w1"],
                                        max_abs_diff(out_r, tb_p))
    ragged_ber = ber_of_bytes(out_r, msgs_r, lens_np - spec.S)
    for path, used in (("small hard", ("acs_small_forward", "traceback_k1")),
                       ("small soft", ("acs_soft_small_forward",
                                       "traceback_k1")),
                       ("small ragged", ("acs_small_forward",
                                         "traceback_k1_ragged"))):
        require(all(launches[path][k] > 0 for k in used),
                f"{path}: {used} launched: {launches[path]}")
    summary = {"spec": str(spec), "T": T, "hard_ber": hard_ber,
               "soft_ber": soft_ber, "ragged_ber": ragged_ber}
    print(f"[small] (k) {SMALL_MAIN} B={MAIN_B} L={MAIN_L} T={T} "
          f"p={MAIN_NOISE}: hard BER {hard_ber:.4e} (< {SMALL_BER_LIMIT}); "
          f"soft BER at {EBN0_DB} dB {soft_ber:.4e}; ragged BER "
          f"{ragged_ber:.4e}; each equal to its plain route on the card; "
          f"launches {nonzero(launches)}")
    return (spec, seg, q, seg_r, lens), launches, plain_ms, summary


def small_walk_kernels(fec, acs, small_in) -> dict:
    """(k)'s walks by CUDA kernel, from one call of each decode under
    torch.profiler (after the timing phases, which it would disturb): the
    hard, soft and ragged decodes' walk and the masked walk at NS = 16 on
    (k)'s forward words (from random starts, live T - 9) are all
    `narrow_walk_kernel`.  Returns path -> the walk kernels' names."""
    import re
    import numpy as np
    import torch
    spec, seg, q, seg_r, lens = small_in
    words = acs.acs_forward_batch(spec, seg)[0]
    T = words.shape[1]
    starts = torch.from_numpy(np.random.default_rng(MAIN_SEED).integers(
        0, spec.num_states, MAIN_B).astype(np.int32)).to(seg.device)
    walks = {}
    for path, call in (
            ("small hard", lambda: fec.viterbi_decode_batch_bytes(spec, seg)),
            ("small soft", lambda: fec.viterbi_decode_batch_soft_bytes(
                spec, q, qmax=QMAX)),
            ("small ragged", lambda: fec.viterbi_decode_batch_bytes_ragged(
                spec, seg_r, lens)),
            ("small masked", lambda: acs.traceback_batch_masked(
                spec, words, starts, T - 9, T, "bits"))):
        kernel = "narrow_walk_kernel"
        names = cuda_kernel_names(call)
        walks[path] = sorted({m.group(0) for m in (
            re.search(r"\w*(?:walk|traceback)\w*<[^>]*>", n) for n in names)
            if m})
        require(any(kernel in n for n in names),
                f"{path}: {kernel} ran: {sorted(names)}")
    print(f"[small] (k) walk kernels by path: {walks}")
    return walks


def phase_wide(fec, acs, dev, err):
    """(l): WIDE_MAIN at bench.py's working set through the hard and soft
    byte decodes, the K11 names, the ragged hard byte decode and the
    tail-biting list decode of WIDE_LIST_B packets; each against its plain
    route on WIDE_PLAIN_ROWS rows (8 for the list).  Returns (inputs for
    timing, launches by path, plain ms, summary)."""
    import numpy as np
    import torch
    from convolutionalencdec_tpu_torch.kernels import fused
    from convolutionalencdec_tpu_torch.kernels import tailbiting as ktb
    from convolutionalencdec_tpu_torch.ops.viterbi import viterbi_decode_bytes
    spec = fec.CodeSpec(**WIDE_MAIN)
    R = WIDE_PLAIN_ROWS
    rng = np.random.default_rng(MAIN_SEED)
    msgs = rng.integers(0, 2, (MAIN_B, MAIN_L), dtype=np.uint8)
    seg, _ = fec.encode_bits(spec, torch.from_numpy(msgs).to(dev))
    require(np.array_equal(seg[:R].cpu().numpy(),
                           encode_reference_np(spec, msgs[:R])),
            "(l) encode on the card equals the trellis walk")
    seg = torch.from_numpy(
        corrupt(rng, seg.cpu().numpy(), MAIN_NOISE, spec.n)).to(dev)
    T = seg.shape[1]
    launches, plain_ms = {}, {}

    out, launches["wide hard"] = drive(
        acs, lambda: fec.viterbi_decode_batch_bytes(spec, seg))
    want, plain_ms["wide hard"] = time_once(
        lambda: viterbi_decode_bytes(spec, seg[:R]))
    require(torch.equal(out[:R], want), "(l) hard bytes equal to the plain "
            f"decode on the card ({R} rows)")
    hard_ber = ber_of_bytes(out, msgs)
    require(hard_ber < WIDE_BER_LIMIT, f"(l) hard BER {hard_ber} < "
            f"{WIDE_BER_LIMIT}")
    words, fm = acs.acs_forward_batch(spec, seg[:R])
    (words_p, fm_p), plain_ms["acs_wide_forward"] = time_once(
        lambda: acs.acs_forward_batch_plain(spec, seg[:R]))
    require(torch.equal(words, words_p) and torch.equal(fm, fm_p),
            f"(l) words and final metrics ({R} rows)")
    tb = acs.traceback_batch(spec, words, T, MAIN_L, "bytes")
    tb_p, plain_ms["traceback_wide"] = time_once(
        lambda: acs.traceback_batch_plain(spec, words_p, T, MAIN_L, "bytes"))
    require(torch.equal(tb, tb_p) and torch.equal(tb, out[:R]),
            "(l) traceback bytes")
    err["acs_wide_forward"] = max(err["acs_wide_forward"],
                                  max_abs_diff(words, words_p),
                                  max_abs_diff(fm, fm_p))
    err["traceback_wide"] = max(err["traceback_wide"], max_abs_diff(tb, tb_p))
    del words_p, fm_p

    gen = torch.Generator(device=dev).manual_seed(MAIN_SEED)
    _, llr = soft_channel(fec, spec, torch.from_numpy(msgs).to(dev), gen,
                          spec.rate)
    q = fec.quantize_llrs(llr, qmax=QMAX).reshape(MAIN_B, T, spec.n).to(
        torch.int8)
    del llr
    require(fec.select_kernel(spec, "soft", QMAX) == fec.kernels.SOFT
            and fec.kernels.soft_qclip(spec, QMAX) == 127,
            "(l) soft on the JAX package's 16-bit route")
    out_s, launches["wide soft"] = drive(
        acs, lambda: fec.viterbi_decode_batch_soft_bytes(spec, q, qmax=QMAX))
    qc = acs.condition_qllrs(q[:R], 127)
    want_s, plain_ms["wide soft"] = time_once(
        lambda: fec.viterbi_decode_soft(spec, qc))
    require(torch.equal(out_s[:R], fec.ops.viterbi.pad_and_pack(want_s)),
            f"(l) soft bytes equal to the plain soft decode ({R} rows)")
    words, fm = acs.acs_forward_batch_soft(spec, q[:R], 127)
    (words_p, fm_p), plain_ms["acs_soft_wide_forward"] = time_once(
        lambda: acs.acs_forward_batch_soft_plain(spec, q[:R], 127))
    require(torch.equal(words, words_p) and torch.equal(fm, fm_p),
            f"(l) soft words and final metrics ({R} rows)")
    err["acs_soft_wide_forward"] = max(err["acs_soft_wide_forward"],
                                       max_abs_diff(words, words_p),
                                       max_abs_diff(fm, fm_p))
    del words, words_p, fm_p
    soft_ber = ber_of_bytes(out_s, msgs)
    require(soft_ber <= hard_ber or soft_ber < WIDE_BER_LIMIT,
            f"(l) soft BER {soft_ber}")

    # The K11 names on the same inputs, padded to whole 8-step rows.
    seg_p, q_p = pad_steps(seg, 8), pad_steps(q, 8)
    Tp = seg_p.shape[1]
    gmask = np.zeros((Tp // 8, 1), np.int32)
    gmask[:T // 8] = 0xFF
    gmask[T // 8] = (1 << (T % 8)) - 1
    h0 = torch.zeros((spec.num_states, MAIN_B), dtype=torch.uint8, device=dev)
    h0[0] = 1

    def fused_chain():
        words, _ = fused.acs_forward_batch_fused(spec, seg_p)
        rows = fused.traceback_batch_fused(spec, words, T)
        del words
        words, _ = fused.acs_forward_batch_fused_soft(spec, q_p)
        rows_s = fused.traceback_batch_fused_masked(spec, words, gmask, h0)
        return rows, rows_s, words

    (rows, rows_s, words_f), launches["wide fused"] = drive(acs, fused_chain)
    for r, o, what in ((rows, out, "hard"), (rows_s, out_s, "soft")):
        require(torch.equal(fec.ops.viterbi.pad_and_pack(
            rows_to_bits(r)[:, :MAIN_L]), o),
            f"(l) K11 names' {what} rows equal to the {what} byte decode")
    zeros = torch.zeros(R, dtype=torch.int32, device=dev)
    got = acs.traceback_batch_masked(spec, words_f[:R], zeros, T, Tp, "bits")
    want, plain_ms["traceback_wide_masked"] = time_once(
        lambda: acs.traceback_batch_masked_plain(spec, words_f[:R], zeros, T,
                                                 Tp, "bits"))
    require(torch.equal(got, want), f"(l) masked walk ({R} rows)")
    err["traceback_wide_masked"] = max(err["traceback_wide_masked"],
                                       max_abs_diff(got, want))
    del words_f, rows, rows_s, h0

    rng_r = np.random.default_rng(MAIN_SEED + 1)
    lens_np = rng_r.integers(spec.S + 1, T + 1, MAIN_B).astype(np.int32)
    live = np.arange(MAIN_L)[None, :] < (lens_np - spec.S)[:, None]
    msgs_r = msgs * live.astype(np.uint8)
    seg_r, _ = fec.encode_bits(spec, torch.from_numpy(msgs_r).to(dev))
    seg_r = torch.from_numpy(
        corrupt(rng_r, seg_r.cpu().numpy(), MAIN_NOISE, spec.n)).to(dev)
    lens = torch.from_numpy(lens_np).to(dev)
    out_r, launches["wide ragged"] = drive(
        acs, lambda: fec.viterbi_decode_batch_bytes_ragged(spec, seg_r, lens))
    words, _ = acs.acs_forward_batch(spec, seg_r[:R])
    got = acs.traceback_batch_ragged(spec, words, lens[:R], MAIN_L, "bytes")
    want, plain_ms["traceback_wide_ragged"] = time_once(
        lambda: acs.traceback_batch_ragged_plain(spec, words, lens[:R], MAIN_L,
                                                 "bytes"))
    want_r = fec.ops.viterbi.pad_and_pack(fec.viterbi_decode_ragged(
        spec, seg_r[:R], lens[:R]))
    require(torch.equal(got, want) and torch.equal(out_r[:R], want_r),
            f"(l) ragged bytes equal to the plain route ({R} rows)")
    err["traceback_wide_ragged"] = max(err["traceback_wide_ragged"],
                                       max_abs_diff(got, want))
    # The edge lengths (0, 1, S, S + 1, T - 1, T, past T, negative) on the
    # first rows, the walk over the whole batch (its launch shape on this
    # path) and the plain one on R rows, bits and bytes, whole and cut rows.
    edge = lens.clone()
    edge[:8] = torch.tensor([0, 1, spec.S, spec.S + 1, T - 1, T, T + 3, -2],
                            dtype=torch.int32)
    del words
    words, _ = acs.acs_forward_batch(spec, seg_r)
    compare_wide_ragged(fec, acs, spec, words, err, rng_r, edge, rows=R)
    del words
    ragged_ber = ber_of_bytes(out_r, msgs_r, lens_np - spec.S)

    msgs_t = rng.integers(0, 2, (WIDE_LIST_B, MAIN_L), dtype=np.uint8)
    seg_t = fec.encode_tailbiting(spec, torch.from_numpy(msgs_t).to(dev))
    seg_t = torch.from_numpy(
        corrupt(rng, seg_t.cpu().numpy(), MAIN_NOISE, spec.n)).to(dev)
    (bits_t, metrics_t), launches["wide list"] = drive(
        acs, lambda: fec.viterbi_decode_batch_tailbiting_list(
            spec, seg_t, WIDE_LIST_SIZE))
    with plain_routes(ktb, acs, TB_WRAPPERS):
        want_b, want_m = ktb.viterbi_decode_batch_tailbiting_list(
            spec, seg_t[:8], WIDE_LIST_SIZE)
    require(torch.equal(bits_t[:8], want_b) and torch.equal(metrics_t[:8],
                                                            want_m),
            "(l) tail-biting list equal to its plain route (8 rows)")
    wl = ktb.list_wrap(spec, MAIN_L)
    ext = fec.tailbiting.circular_extend(seg_t, wl, 0, axis=1)
    words, fm = acs.acs_forward_batch(spec, ext, torch.zeros(
        (WIDE_LIST_B, spec.num_states), dtype=torch.int32, device=dev))
    starts = torch.argsort(fm, dim=1, stable=True)[:, :WIDE_LIST_SIZE].to(
        torch.int32)
    Te = ext.shape[1]
    got = acs.traceback_batch_multi(spec, words[:8], starts[:8], Te, wl,
                                    MAIN_L)
    want, plain_ms["traceback_wide_multi"] = time_once(
        lambda: acs.traceback_batch_multi_plain(spec, words[:8], starts[:8],
                                                Te, wl, MAIN_L))
    require(torch.equal(got, want), "(l) multi walk (8 rows)")
    err["traceback_wide_multi"] = max(err["traceback_wide_multi"],
                                      max_abs_diff(got, want))
    # One walk a packet (NW = 1), and a window from a step that is not a
    # multiple of 8 with the last 9 steps masked, bits and bytes: the walk
    # over all the packets (NW = 4: this path's launch shape), the plain
    # one on 8.
    odd = wl - wl % 8 + 5
    compare_wide_multi(fec, acs, spec, words, err, rng,
                       [(starts[:, :1], Te, wl), (starts, Te - 9, odd)],
                       rows=8)
    list_ber = float((bits_t[:, 0].cpu().numpy() != msgs_t).mean())
    for path, used in (("wide hard", ("acs_wide_forward", "traceback_wide")),
                       ("wide soft", ("acs_soft_wide_forward",
                                      "traceback_wide")),
                       ("wide fused", ("acs_wide_forward",
                                       "acs_soft_wide_forward",
                                       "traceback_wide_masked")),
                       ("wide ragged", ("acs_wide_forward",
                                        "traceback_wide_ragged")),
                       ("wide list", ("acs_wide_forward",
                                      "traceback_wide_multi"))):
        require(all(launches[path][k] > 0 for k in used),
                f"{path}: {used} launched: {launches[path]}")
    dec_gb = MAIN_B * T * acs.decision_words(spec) * 4 / 1e9
    summary = {"spec": str(spec), "T": T, "hard_ber": hard_ber,
               "soft_ber": soft_ber, "ragged_ber": ragged_ber,
               "list_ber": list_ber, "decision_gb": dec_gb,
               "plain_rows": R}
    print(f"[wide] (l) {spec} B={MAIN_B} L={MAIN_L} T={T} p={MAIN_NOISE}: "
          f"hard BER {hard_ber:.4e} (< {WIDE_BER_LIMIT}), soft BER at "
          f"{EBN0_DB} dB {soft_ber:.4e}, ragged BER {ragged_ber:.4e}, "
          f"tail-biting list ({WIDE_LIST_B} packets, {WIDE_LIST_SIZE} "
          f"candidates) candidate-0 BER {list_ber:.4e}; decision words "
          f"{dec_gb:.2f} GB per call; each equal to its plain route on "
          f"{R} rows (the list on 8); launches {nonzero(launches)}")
    inputs = (spec, seg, q, lens, words, starts, Te, wl, seg_r, seg_t)
    return inputs, launches, plain_ms, summary


def butterfly_times(fec, acs, small_in, wide_in):
    """Device ms of the small and wide kernels and decodes at (k) and (l):
    TIMED_CALLS calls on row rotations at (k), WIDE_TIMED_CALLS at (l) (its
    forward takes tens of ms), the wide walks alternating between two
    forwards' decisions (8.65 GB each)."""
    import numpy as np
    import torch
    runs = {}
    spec, seg, q, seg_r, lens = small_in
    T = seg.shape[1]
    bufs = [torch.roll(seg, r + 1, dims=0) for r in range(TIMED_CALLS)]
    runs["acs_small_forward"] = device_times(
        lambda s: acs.acs_forward_batch(spec, s), bufs)
    decs = [acs.acs_forward_batch(spec, s)[0] for s in bufs]
    runs["traceback_k1 w1"] = device_times(
        lambda d: acs.traceback_batch(spec, d, T, MAIN_L, "bytes"), decs)
    lens_r = [torch.roll(lens, r + 1) for r in range(TIMED_CALLS)]
    runs["traceback_k1_ragged w1"] = device_times(
        lambda p: acs.traceback_batch_ragged(spec, p[0], p[1], MAIN_L,
                                             "bytes"), list(zip(decs, lens_r)))
    starts = torch.from_numpy(np.random.default_rng(MAIN_SEED).integers(
        0, spec.num_states, (TIMED_CALLS, seg.shape[0])).astype(np.int32)).to(
            seg.device)
    runs["traceback_k1_masked (k)"] = device_times(
        lambda p: acs.traceback_batch_masked(spec, p[0], p[1], T - 9, T,
                                             "bits"), list(zip(decs, starts)))
    del decs
    runs["small hard"] = device_times(
        lambda s: fec.viterbi_decode_batch_bytes(spec, s), bufs)
    rbufs = [torch.roll(seg_r, r + 1, dims=0) for r in range(TIMED_CALLS)]
    runs["small ragged"] = device_times(
        lambda p: fec.viterbi_decode_batch_bytes_ragged(spec, p[0], p[1]),
        list(zip(rbufs, lens_r)))
    del bufs, rbufs
    qbufs = [torch.roll(q, r + 1, dims=0) for r in range(TIMED_CALLS)]
    runs["acs_soft_small_forward"] = device_times(
        lambda x: acs.acs_forward_batch_soft(spec, x, 127), qbufs)
    runs["small soft"] = device_times(
        lambda x: fec.viterbi_decode_batch_soft_bytes(spec, x, qmax=QMAX),
        qbufs)
    del qbufs

    spec, seg, q, lens, list_words, starts, Te, wl, seg_r, seg_t = wide_in
    T = seg.shape[1]
    n = WIDE_TIMED_CALLS
    bufs = [torch.roll(seg, r + 1, dims=0) for r in range(n)]
    runs["acs_wide_forward"] = device_times(
        lambda s: acs.acs_forward_batch(spec, s), bufs)
    pair = [acs.acs_forward_batch(spec, s)[0] for s in bufs[:2]]
    decs = [pair[r % 2] for r in range(n)]
    runs["traceback_wide"] = device_times(
        lambda d: acs.traceback_batch(spec, d, T, MAIN_L, "bytes"), decs)
    lens_r = [torch.roll(lens, r + 1) for r in range(n)]
    runs["traceback_wide_ragged"] = device_times(
        lambda p: acs.traceback_batch_ragged(spec, p[0], p[1], MAIN_L,
                                             "bytes"), list(zip(decs, lens_r)))
    zeros = torch.zeros(seg.shape[0], dtype=torch.int32, device=seg.device)
    runs["traceback_wide_masked"] = device_times(
        lambda d: acs.traceback_batch_masked(spec, d, zeros, T, T, "bits"),
        decs)
    del pair, decs
    runs["wide hard"] = device_times(
        lambda s: fec.viterbi_decode_batch_bytes(spec, s), bufs)
    del bufs
    qbufs = [torch.roll(q, r + 1, dims=0) for r in range(n)]
    runs["acs_soft_wide_forward"] = device_times(
        lambda x: acs.acs_forward_batch_soft(spec, x, 127), qbufs)
    runs["wide soft"] = device_times(
        lambda x: fec.viterbi_decode_batch_soft_bytes(spec, x, qmax=QMAX),
        qbufs)
    del qbufs
    rolled = [torch.roll(starts, r, dims=0) for r in range(n)]
    runs["traceback_wide_multi"] = device_times(
        lambda st: acs.traceback_batch_multi(spec, list_words, st, Te, wl,
                                             MAIN_L), rolled)
    rbufs = [torch.roll(seg_r, r + 1, dims=0) for r in range(n)]
    runs["wide ragged"] = device_times(
        lambda p: fec.viterbi_decode_batch_bytes_ragged(spec, p[0], p[1]),
        list(zip(rbufs, lens_r)))
    del rbufs
    tbufs = [torch.roll(seg_t, r + 1, dims=0) for r in range(n)]
    runs["wide list"] = device_times(
        lambda x: fec.viterbi_decode_batch_tailbiting_list(
            spec, x, WIDE_LIST_SIZE), tbufs)
    del tbufs
    print(f"[time] (l) timed with {n} calls each (its forward takes tens of "
          f"ms); (k) with {TIMED_CALLS}")
    return runs


# ---------------------------------------------------------------------------
# The narrow walk: the terminated, masked and ragged walks at NS = 2 ... 256
# (TPU kernels K2, K12's walks, K2m, K2r and K11's walk),
# `narrow_walk_kernel` in csrc/traceback_k1.cu.

#: The narrow walk's checks: the batch, not a multiple of any channel count
#: a warp holds.
NARROW_B = 37


def narrow_walk_lines(source=None):
    """[(NS, G, warm-up steps)] of each line of the narrow walk's dispatch
    switch (`launch_narrow_walk` in csrc/traceback_k1.cu, or in `source`, a
    copy of it): segments of G steps, a lane's guess a warm-up of that many
    steps."""
    import re
    src = Path(source or ROOT / SOURCES["traceback_k1"][0]).read_text()
    return [(int(ns), 1 << int(lg), int(wu))
            for ns, log, lg, wu in re.findall(
                r"case (\d+): return launch_narrow<(\d+), (\d+), (\d+)>"
                r"\(a, s\);", src)
            if int(ns) == 1 << int(log)]


def narrow_multi_lines(source=None):
    """[(NS, G, warm-up steps)] of each line of the list walk's dispatch
    switch (`launch_multi_walk` in csrc/traceback_k1.cu, or in `source`):
    the narrow walk's multi mode, segments of G steps, a lane's guess a
    warm-up of that many steps."""
    import re
    src = Path(source or ROOT / SOURCES["traceback_k1_multi"][0]).read_text()
    return [(int(ns), 1 << int(lg), int(wu))
            for ns, log, lg, wu in re.findall(
                r"case (\d+): return launch_multi<(\d+), (\d+), (\d+)>"
                r"\(a, s\);", src)
            if int(ns) == 1 << int(log)]


def narrow_walk_smem(NS, G, source=None):
    """(pitch in words, shared bytes a block) of the narrow walk at NS with
    segments of G steps, from the pad and the window count of `NarrowShape`
    in csrc/traceback_k1.cu (or `source`): NB windows of 32 segments at a
    pitch of G W + pad words, a window's output bytes and their states, NB
    mbarriers, rounded up to 16 bytes (the list walk stages fewer rows)."""
    import re
    src = Path(source or ROOT / SOURCES["traceback_k1"][0]).read_text()
    pad = int(re.search(r"int P = SEGW \+ (\d+);", src).group(1))
    nb = int(re.search(r"int NB = (\d+);", src).group(1))
    pitch = G * max(NS // 32, 1) + pad
    smem = nb * 32 * pitch * 4 + 2 * 32 * (G // 8) + 8 * nb
    return pitch, (smem + 15) & ~15


def narrow_walk_lanes(t_top, G):
    """C, the lanes a channel of a narrow walk whose top step is t_top - 1:
    the fewest, a power of two up to 32, whose segments of G steps hold the
    walk in one window (`launch_narrow_kernel`); 32 / C channels share a
    warp."""
    segs, C = -(-t_top // G), 1
    while C < 32 and C < segs:
        C *= 2
    return C


def narrow_walk_lengths(S, G):
    """The step counts at which the narrow walk is held to the plain walks:
    1, 5, 9 (a byte and a step), S + 3, G + 1 (a step past a segment),
    32 G - 5, 32 G and 32 G + 1 (about a window of 32 lanes) and 96 G + 37
    and 96 G + 38 (four windows), in rising order, each once."""
    return tuple(sorted({1, 5, 9, S + 3, G + 1, 32 * G - 5, 32 * G,
                         32 * G + 1, 96 * G + 37, 96 * G + 38}))


def narrow_walk_guesses_wrong(words, T, t_top, starts, G, WU,
                              NS=None) -> int:
    """How many of the narrow walk's first-pass segment starts are wrong on
    these words, over all rows (each such segment is walked again): the
    walk from `starts` (None: state 0) at step T - 1, decision 0 at steps
    >= t_top, in windows of C G steps (`narrow_walk_lanes`) top down; a
    segment's guess is a warm-up of WU steps from state 0 above it, or from
    the window's top state where the warm-up reaches it.  NS: the states
    (default: 32 a word, as at NS >= 32)."""
    import numpy as np
    w = words.cpu().numpy().view(np.uint32)
    B, NS = w.shape[0], NS or w.shape[2] * 32
    S = NS.bit_length() - 1
    rows = np.arange(B)

    def step(t, cur):
        i = (cur >> 1) | ((cur & 1) << (S - 1))
        return (cur >> 1) | (((w[rows, t, i >> 5] >> (i & 31)) & 1)
                             << (S - 1))

    s0 = (np.zeros(B, np.int64) if starts is None
          else starts.cpu().numpy().astype(np.int64) & (NS - 1))
    cur = s0 >> (T - t_top) if T - t_top < S else np.zeros(B, np.int64)
    truth = np.empty((max(t_top, 1), B), np.int64)
    for t in range(t_top - 1, -1, -1):
        truth[t] = cur
        cur = step(t, cur)
    WS = narrow_walk_lanes(t_top, G) * G
    wrong = 0
    for lo in range(0, t_top, WS):
        hi = min(lo + WS, t_top)
        for b in range(lo + G, hi, G):  # each segment top but the window's
            t0 = min(b - 1 + WU, hi - 1)
            x = truth[hi - 1] if t0 == hi - 1 else np.zeros(B, np.int64)
            for t in range(t0, b - 1, -1):
                x = step(t, x)
            wrong += int((x != truth[b - 1]).sum())
    return wrong


def narrow_walk_cases(S, T):
    """The walks at which the narrow walk is held on one batch of T steps:
    ("terminated", t_actual, L, out) at t_actual T and T - 2 (rows longer
    than the packet), L the whole message and a cut one; ("masked", live,
    L, out) at live 0, S, T - 1 and T, L = T and a cut one; out "bits" and
    "bytes"."""
    for ta in sorted({T, T - 2} & set(range(S, T + 1))):
        for L in sorted({ta - S, cut_bits(ta - S)}):
            for out in ("bits", "bytes"):
                yield "terminated", ta, L, out
    for live in sorted({0, min(S, T), T - 1, T}):
        for L in sorted({T, cut_bits(T)}):
            for out in ("bits", "bytes"):
                yield "masked", live, L, out


def narrow_walk_words(fec, acs, code, rng, dev, kind, B, T):
    """B rows of T steps of decision words at `code`'s NS: "noisy" the
    forward's words of `code`'s 3%-corrupted packets, "garbage" uniform
    words, "catastrophic" the forward's words of the catastrophic code of
    that NS (`SP_CATASTROPHIC`: survivors that never merge) over garbage
    segments, or below 64 states `rotating_words`."""
    import numpy as np
    import torch
    NS = code.num_states
    if kind == "garbage":
        return torch.from_numpy(rng.integers(
            -2 ** 31, 2 ** 31, (B, T, max(NS // 32, 1))).astype(
                np.int32)).to(dev)
    if kind == "catastrophic" and NS < 64:
        return torch.from_numpy(rotating_words(rng, B, T, NS)).to(dev)
    if kind == "catastrophic":
        g = SP_CATASTROPHIC[NS]
        code = fec.CodeSpec(K=NS.bit_length(), g=g + g)
        seg = rng.integers(0, 1 << code.n, (B, T)).astype(np.uint8)
    else:
        msgs = rng.integers(0, 2, (B, max(T - code.S, 1)), dtype=np.uint8)
        seg = corrupt(rng, encode_reference_np(code, msgs)[:, :T], NOISE[0],
                      code.n)
    return acs.acs_forward_batch(code, torch.from_numpy(
        np.ascontiguousarray(seg)).to(dev))[0]


def rotating_words(rng, B, T, NS):
    """int32 [B, T, 1] one-word decisions (NS <= 32) under which 90% of
    the steps rotate the state (each state's decision is the bit it shifts
    out: no two survivors meet) and 10% are uniform garbage, which moves
    the walk off state 0: most warm-up guesses are wrong and stay wrong."""
    import numpy as np
    S = NS.bit_length() - 1
    # State s's decision is bit i = (s >> 1) | ((s & 1) << (S - 1)), and
    # s & 1 is bit S - 1 of i: the bits i >= NS / 2 are set.
    rot = np.int64(((1 << NS) - 1) ^ ((1 << (NS // 2)) - 1))
    words = rng.integers(-2 ** 31, 2 ** 31, (B, T, 1))
    words = np.where(rng.random((B, T, 1)) < 0.9, rot, words)
    return (words & 0xFFFFFFFF).astype(np.uint32).view(np.int32)


def narrow_walk_batches(fec, acs, spec, rng, dev, G):
    """The batches of decision words on which the narrow walk at `spec`'s
    NS, segments of G steps, is held: yields (what, words, guessed),
    `guessed` where the walk's wrong first-pass guesses are counted.
    B = NARROW_B at `narrow_walk_lengths` (one to four windows; a short walk
    packs channels into a warp), noisy and garbage words; at the longest,
    garbage and catastrophic words (guessed) and B = 1; the offset bases at
    32 G + 1 and 32 G + 2 steps: a slice of a batch (`words[1:]`, odd T: 8
    bytes past a 16-byte line at NS = 64) and a base 4 bytes past one (a
    word a step)."""
    import torch
    W = max(spec.num_states // 32, 1)
    lengths = narrow_walk_lengths(spec.S, G)

    def words(kind, B, T):
        return narrow_walk_words(fec, acs, spec, rng, dev, kind, B, T)

    for T in lengths:
        for kind in ("noisy", "garbage"):
            yield kind, words(kind, NARROW_B, T), False
    top = lengths[-1]
    for kind in ("garbage", "catastrophic"):
        yield kind, words(kind, NARROW_B, top), True
    yield "noisy", words("noisy", 1, top), False
    for T in (32 * G + 1, 32 * G + 2):
        big = words("noisy", NARROW_B + 1, T)
        flat = torch.empty(NARROW_B * T * W + 1, dtype=torch.int32,
                           device=dev)
        flat[1:] = big[1:].reshape(-1)
        for what, x in (("slice", big[1:]),
                        ("4-byte base", flat[1:].view(NARROW_B, T, W))):
            require(x.is_contiguous(), f"{what} contiguous")
            yield what, x, False


def compare_narrow_walk(fec, acs, spec, words, err, rng, what,
                        masked=True) -> int:
    """`traceback_batch` and `traceback_batch_masked` on one batch of
    decision words at NS 2-256 against their plain versions at each of
    `narrow_walk_cases` (`masked`: the masked ones too), masked from random
    starts; each call one launch counted, each difference under its row of
    the kernels line (`walk_key`).  Returns the cases."""
    import numpy as np
    import torch
    pad_and_pack = fec.ops.viterbi.pad_and_pack
    B, T = words.shape[:2]
    starts = torch.from_numpy(rng.integers(0, spec.num_states, B).astype(
        np.int32)).to(words.device)
    plain, cases = {}, 0
    for mode, t, L, out in narrow_walk_cases(spec.S, T):
        if mode == "masked" and not masked:
            continue
        if (mode, t) not in plain:
            plain[mode, t] = (
                acs.traceback_batch_plain(spec, words, t, t - spec.S, "bits")
                if mode == "terminated" else acs.traceback_batch_masked_plain(
                    spec, words, starts, t, T, "bits"))
        ref = plain[mode, t][:, :L]
        if out == "bytes":
            ref = pad_and_pack(ref)
        if mode == "terminated":
            key, row, case = "traceback_k1", walk_key(acs, spec), \
                f"t_actual={t}"
            call = lambda: acs.traceback_batch(spec, words, t, L, out)
        else:
            key, row, case = "traceback_k1_masked", "traceback_k1_masked", \
                f"live={t}"
            call = lambda: acs.traceback_batch_masked(spec, words, starts, t,
                                                      L, out)
        case = f"{spec} {row} {what} B={B} T={T} {case} L={L} {out}"
        before = acs.LAUNCHES[key]
        got = call()
        require(acs.LAUNCHES[key] == before + 1, f"{case}: a launch counted")
        require(torch.equal(got, ref), f"{case}: equal to the plain walk")
        err[row] = max(err[row], max_abs_diff(got, ref))
        cases += 1
    return cases


def narrow_ragged_lengths(rng, B, T, S):
    """Lengths of a ragged batch of B channels of T steps: 0, 1, S, S + 1,
    T - 1, T, past T and negative, then random ones in [-3, T + 3]."""
    import numpy as np
    edge = [0, 1, S, S + 1, T - 1, T, T + 5, -4]
    return np.concatenate([edge, rng.integers(-3, T + 4, max(B - 8, 0))])[
        :B].astype(np.int32)


def compare_narrow_ragged(fec, acs, spec, words, err, rng, what) -> int:
    """`traceback_batch_ragged` on one batch of decision words at NS 2-256
    against its plain version: `narrow_ragged_lengths`, rows of T - S bits
    and a cut one, bits and bytes, each call one launch counted; and the
    same walks by the C entry into rows first filled with 0xA5, so that a
    byte the walk leaves unwritten shows; each difference under its row of
    the kernels line (`walk_key`: the one-word row below 64 states).
    Returns the cases."""
    import torch
    from convolutionalencdec_tpu_torch.kernels import _build
    B, T = words.shape[:2]
    S, NS = spec.S, spec.num_states
    if T < S:
        return 0
    lens = torch.from_numpy(narrow_ragged_lengths(rng, B, T, S)).to(
        words.device)
    stream = torch.cuda.current_stream(words.device).cuda_stream
    key, cases = "traceback_k1_ragged", 0
    row = walk_key(acs, spec, "_ragged")
    full = T - S
    for L in sorted({full, cut_bits(full)}):
        want_bits = acs.traceback_batch_ragged_plain(spec, words, lens, L,
                                                     "bits")
        for out in ("bits", "bytes"):
            ref = want_bits if out == "bits" else \
                fec.ops.viterbi.pad_and_pack(want_bits)
            case = f"{spec} {key} {what} B={B} T={T} L={L} {out}"
            before = acs.LAUNCHES[key]
            got = acs.traceback_batch_ragged(spec, words, lens, L, out)
            require(acs.LAUNCHES[key] == before + 1,
                    f"{case}: a launch counted")
            require(torch.equal(got, ref), f"{case}: equal to the plain walk")
            filled = torch.full_like(ref, 0xA5)
            _build.check(key, _build.library().traceback_k1_ragged(
                words.data_ptr(), lens.data_ptr(), filled.data_ptr(), B, T,
                NS, S, L, int(out == "bytes"), stream))
            require(torch.equal(filled, ref),
                    f"{case}: every byte of 0xA5-filled rows written")
            err[row] = max(err[row], max_abs_diff(got, ref),
                           max_abs_diff(filled, ref))
            cases += 1
    return cases


def phase_compare_narrow_walks(fec, acs, dev, err):
    """The narrow walk (`traceback_k1`, `traceback_k1_masked` and
    `traceback_k1_ragged` at NS = 2 ... 256) against the plain walks on the
    card, at every line of its dispatch switch: a random rate-1/4 code's
    batches of `narrow_walk_batches` (noisy, garbage and catastrophic-code
    words, one to four windows, B = 1, the offset bases), each at every
    case of `compare_narrow_walk` and, where T >= S, of
    `compare_narrow_ragged` (below 64 states the masked and ragged walks
    on every batch but the garbage ones of four windows and the noisy one
    of 96 G + 38 steps, whose plain walks at G 32 and 64 made most of the
    phase's time: the noisy words of 96 G + 37 steps and the garbage and
    rotating words of 96 G + 38 hold them at four windows), the wrong
    first-pass
    guesses counted on the garbage and catastrophic words (required on
    both at NS >= 64, on the rotating words below: garbage words merge a
    small state's survivors within a few steps); at NS >= 64 the K11 names
    (`kernels.fused.traceback_batch_fused`, `_masked` from one-hot starts
    over a live prefix) against their plain routes."""
    import numpy as np
    import torch
    from convolutionalencdec_tpu_torch.kernels import fused
    rng = np.random.default_rng(2051)
    for NS, G, WU in narrow_walk_lines():
        spec = bfly_spec(fec, rng, NS, 4)
        S = spec.S
        cases, ragged, wrong = 0, 0, []
        for what, words, guessed in narrow_walk_batches(fec, acs, spec, rng,
                                                        dev, G):
            deep = (NS >= 64 or guessed or words.shape[1] <= 32 * G + 2
                    or (what == "noisy" and words.shape[1] == 96 * G + 37))
            cases += compare_narrow_walk(fec, acs, spec, words, err, rng,
                                         what, deep)
            if deep:
                ragged += compare_narrow_ragged(fec, acs, spec, words, err,
                                                rng, what)
            if guessed:
                T = words.shape[1]
                wrong.append(narrow_walk_guesses_wrong(words, T, T, None, G,
                                                       WU, NS))
                require(wrong[-1] > 0 or (NS < 64 and what == "garbage"),
                        f"NS={NS} {what} T={T}: the walk's guesses are "
                        "wrong somewhere")
        lengths = narrow_walk_lengths(S, G)
        if NS < 64:
            print(f"[compare] narrow walk NS={NS}: G {G}, warm-up {WU}; "
                  f"{cases} cases (B={NARROW_B}: T = "
                  f"{', '.join(map(str, lengths))}, noisy and garbage words; "
                  f"T={lengths[-1]} garbage and rotating words: "
                  f"{' / '.join(map(str, wrong))} wrong first-pass guesses; "
                  "B=1; slice and 4-byte bases; terminated and masked, "
                  f"whole and cut rows, bits and bytes) and {ragged} ragged "
                  "cases (the edge lengths, also into 0xA5 rows) equal to "
                  "the plain walks")
            continue
        # The K11 names at T a multiple of 8, over two windows.
        T = 32 * G + 8
        words = narrow_walk_words(fec, acs, spec, rng, dev, "noisy", NARROW_B,
                                  T)
        rows = fused.traceback_batch_fused(spec, words, T - 3)
        with plain_routes(fused, acs, FUSED_WRAPPERS):
            rows_p = fused.traceback_batch_fused(spec, words, T - 3)
        require(torch.equal(rows, rows_p), f"{spec} traceback_batch_fused")
        live = int(rng.integers(S, T + 1))
        gmask = np.zeros((T // 8, 1), np.int32)
        gmask[:live // 8] = 0xFF
        if live % 8:
            gmask[live // 8] = (1 << (live % 8)) - 1
        h = torch.zeros((NS, NARROW_B), dtype=torch.uint8, device=dev)
        h[torch.from_numpy(rng.integers(0, NS, NARROW_B)).to(dev),
          torch.arange(NARROW_B, device=dev)] = 1
        rows = fused.traceback_batch_fused_masked(spec, words, gmask, h)
        with plain_routes(fused, acs, FUSED_WRAPPERS):
            rows_p = fused.traceback_batch_fused_masked(spec, words, gmask, h)
        require(torch.equal(rows, rows_p),
                f"{spec} traceback_batch_fused_masked live={live}")
        err["traceback_k1_masked"] = max(err["traceback_k1_masked"],
                                         max_abs_diff(rows, rows_p))
        print(f"[compare] narrow walk NS={NS}: G {G}, warm-up {WU}; {cases} "
              f"cases (B={NARROW_B}: T = {', '.join(map(str, lengths))}, "
              f"noisy and garbage words; T={lengths[-1]} garbage and "
              f"catastrophic words: {' / '.join(map(str, wrong))} wrong "
              "first-pass guesses; B=1; slice and 4-byte bases; terminated "
              "and masked, whole and cut rows, bits and bytes) and "
              f"{ragged} ragged cases (the edge lengths, also into 0xA5 "
              "rows) equal to the plain walks; the K11 names equal to their "
              "plain routes")


# ---------------------------------------------------------------------------
# The narrow soft forward (TPU kernels K4 and K3 at NS 64-256,
# csrc/acs_soft_k1.cu) at every line of its dispatch.

#: Its checks' step counts (below a block, a block's edges, (f)'s wrap
#: steps, 288 and (a)'s T) and conditionings (qclip, floor, initial metrics
#: given): the 8-bit route's clip, the block routes' -127 floor, the
#: tail-biting route's -128, from the default start and carried metrics.
SOFT_FORWARD_T = (0, 1, 31, 32, 33, 192, 288, 2054)
SOFT_FORWARD_CONDITIONS = ((QMAX, True, False), (QMAX, True, True),
                           (127, True, False), (127, False, False),
                           (127, False, True))


def soft_forward_lines(source=None):
    """[(NS, butterflies a lane)] of the narrow forward's NS switch
    (`launch_forward` in csrc/acs_soft_k1.cu, or in `source`), which both
    `acs_soft_k1_forward` and `acs_k1_forward` take; each line launches one
    template for n <= 4 and one for n = 5..8."""
    import re
    src = Path(source or ROOT / SOURCES["acs_soft_k1_forward"][0]).read_text()
    return [(int(ns), int(bpl)) for ns, bpl in re.findall(
        r"case (\d+): ok = launch_n<(\d+), kHard>\(a, s\);", src)]


def compare_soft_forward(acs, spec, q, qclip, floor, init, err, what):
    """`acs_forward_batch_soft` on one batch against its plain version:
    words and final metrics, one launch counted."""
    import torch
    key = "acs_soft_k1_forward"
    before = acs.LAUNCHES[key]
    got = acs.acs_forward_batch_soft(spec, q, qclip, init, floor)
    want = acs.acs_forward_batch_soft_plain(spec, q, qclip, init, floor)
    case = f"{spec} {key} {what} qclip={qclip} floor={floor} " \
           f"init={init is not None}"
    require(acs.LAUNCHES[key] == before + (q.shape[0] > 0),
            f"{case}: a launch counted")
    require(all(torch.equal(a, b) for a, b in zip(got, want)),
            f"{case}: words and final metrics equal to the plain version")
    err[key] = max(err[key], *map(max_abs_diff, got, want))


def phase_compare_soft_forward(fec, acs, dev, err):
    """The narrow soft forward against its plain version on the card at
    every line of its dispatch: NS = 64, 128, 256, each n = 1 ... 8 (one and
    two packed registers), a random code, int8 LLRs over the whole range
    (-128 and 127 among them), B = NARROW_B (not a multiple of the warps a
    block) at every SOFT_FORWARD_T under every SOFT_FORWARD_CONDITIONS
    (T = 2054: the first and the last), and B = 1 at T = 33."""
    import numpy as np
    import torch
    rng = np.random.default_rng(2067)
    cases = 0
    for NS, _ in soft_forward_lines():
        for n in range(1, 9):
            spec = bfly_spec(fec, rng, NS, n)
            for B, T in [(NARROW_B, T) for T in SOFT_FORWARD_T] + [(1, 33)]:
                draw = rng.integers(-128, 128, (B, T, n))
                draw.reshape(-1)[::13] = -128
                draw.reshape(-1)[5::17] = 127
                q = torch.from_numpy(draw.astype(np.int8)).to(dev)
                conditions = SOFT_FORWARD_CONDITIONS
                if T == SOFT_FORWARD_T[-1]:
                    conditions = conditions[:1] + conditions[-1:]
                for qclip, floor, given in conditions:
                    init = None
                    if given:
                        init = torch.from_numpy(rng.integers(
                            0, 6000, (B, NS)).astype(np.int32)).to(dev)
                    compare_soft_forward(acs, spec, q, qclip, floor, init,
                                         err, f"B={B} T={T}")
                    cases += 1
        print(f"[compare] narrow soft forward NS={NS}: n = 1..8, B = "
              f"{NARROW_B} at T = {', '.join(map(str, SOFT_FORWARD_T))} "
              "and B = 1, qclip 7 / 127 / -128 route, default and carried "
              "metrics: words and final metrics equal to the plain version")
    return cases


#: The small-state forward's checks (K12's forward, `acs_small_forward` and
#: `acs_soft_small_forward` at NS = 2 ... 32, csrc/acs_small.cu): B, no
#: multiple of the channels a warp holds (64/NS), at each T (no step, one, a
#: 32-step block less one and a block and one; (k)'s T at the n of
#: SMALL_FORWARD_LONG_N only), and B = 1 at T = 33; soft under each
#: (qclip, floor) of SMALL_FORWARD_SOFT (the 8-bit route's clip, the block
#: routes' -127 floor, the tail-biting route's -128) from the default
#: start; at T < 2054 also from carried metrics (hard, and soft at the -127
#: floor) at the n of `small_forward_carried_n`.
SMALL_FORWARD_B = 37
SMALL_FORWARD_T = (0, 1, 31, 33, 2054)
SMALL_FORWARD_LONG_N = (2,)
SMALL_FORWARD_SOFT = ((QMAX, True), (127, True), (127, False))


def small_forward_carried_n(i: int) -> tuple:
    """The n at which the i-th NS of the small forward's dispatch is held
    from carried metrics: one of each template (n <= 4, n = 5 ... 8),
    turning through n = 1 ... 8 over the NS."""
    return 1 + i % 4, 5 + i % 4


def small_forward_lines(source=None):
    """The NS of the small forward's dispatch switch (`launch_ns` in
    csrc/acs_small.cu, or in `source`)."""
    import re
    src = Path(source or ROOT / SOURCES["acs_small_forward"][0]).read_text()
    lines = [int(ns) for ns in re.findall(
        r"case (\d+): launch<\1, kHard, NP>\(a, s\); return true;", src)]
    require(lines == list(BFLY_SMALL_NS),
            f"the small forward's dispatch lines {lines} are NS 2 ... 32")
    return lines


def compare_small_forward(acs, spec, x, soft, qclip, floor, init, err,
                          what):
    """The small forward on one batch against its plain version: words and
    final metrics, one launch counted."""
    import torch
    key = acs._forward_kernel(spec, soft)
    before = acs.LAUNCHES[key]
    if soft:
        got = acs.acs_forward_batch_soft(spec, x, qclip, init, floor)
        want = acs.acs_forward_batch_soft_plain(spec, x, qclip, init, floor)
    else:
        got = acs.acs_forward_batch(spec, x, init)
        want = acs.acs_forward_batch_plain(spec, x, init)
    case = (f"{spec} {key} {what} init={init is not None}"
            + (f" qclip={qclip} floor={floor}" if soft else ""))
    require(acs.LAUNCHES[key] == before + (x.shape[0] > 0),
            f"{case}: a launch counted")
    require(all(torch.equal(a, b) for a, b in zip(got, want)),
            f"{case}: words and final metrics equal to the plain version")
    err[key] = max(err[key], *map(max_abs_diff, got, want))


def phase_compare_small_forward(fec, acs, dev, err):
    """The small forward against its plain versions on the card at every
    line of its dispatch (NS = 2, 4, 8, 16, 32), each n = 1 ... 8 hard and
    soft, a random code: noisy segments (every third row garbage) and int8
    LLRs over the whole range (-128 and 127 among them), at every
    SMALL_FORWARD_T (2054 at n = 2) and B = 1 at T = 33; hard from the
    default start, soft under every SMALL_FORWARD_SOFT from the default
    start (2054: the -127 floor); below T = 2054 at the n of
    `small_forward_carried_n` also hard and soft at the -127 floor from
    carried metrics.  Returns the cases."""
    import numpy as np
    import torch
    rng = np.random.default_rng(2075)
    cases = 0
    for i, NS in enumerate(small_forward_lines()):
        for n in range(1, 9):
            spec = bfly_spec(fec, rng, NS, n)
            for B, T in ([(SMALL_FORWARD_B, T) for T in SMALL_FORWARD_T]
                         + [(1, 33)]):
                if T == SMALL_FORWARD_T[-1] and n not in SMALL_FORWARD_LONG_N:
                    continue
                msgs = rng.integers(0, 2, (B, max(T - spec.S, 0)),
                                    dtype=np.uint8)
                coded = encode_reference_np(spec, msgs)[:, :T]
                coded = np.concatenate(
                    [coded, np.zeros((B, T - coded.shape[1]), np.uint8)], 1)
                coded = corrupt(rng, coded, NOISE[0], n)
                coded[::3] = rng.integers(0, 1 << n, coded[::3].shape)
                seg = torch.from_numpy(coded.astype(np.uint8)).to(dev)
                draw = rng.integers(-128, 128, (B, T, n))
                draw.reshape(-1)[::13] = -128
                draw.reshape(-1)[5::17] = 127
                q = torch.from_numpy(draw.astype(np.int8)).to(dev)
                init = torch.from_numpy(rng.integers(0, 6000, (B, NS)).astype(
                    np.int32)).to(dev)
                what = f"B={B} T={T}"
                starts = ((None, init) if n in small_forward_carried_n(i)
                          and T != SMALL_FORWARD_T[-1] else (None,))
                for given in starts:
                    compare_small_forward(acs, spec, seg, False, 0, True,
                                          given, err, what)
                    soft = (SMALL_FORWARD_SOFT[1:2] if given is not None
                            or T == SMALL_FORWARD_T[-1]
                            else SMALL_FORWARD_SOFT)
                    for qclip, floor in soft:
                        compare_small_forward(acs, spec, q, True, qclip,
                                              floor, given, err, what)
                    cases += 1 + len(soft)
        print(f"[compare] small forward NS={NS}: n = 1..8 hard and soft, B "
              f"= {SMALL_FORWARD_B} at T = "
              f"{', '.join(map(str, SMALL_FORWARD_T))} and B = 1, qclip 7 / "
              "127 / -128 route, default metrics and carried ones at n = "
              f"{small_forward_carried_n(i)}: words and final metrics equal "
              "to the plain versions")
    return cases


#: The hard narrow forward's checks (K1, `acs_k1_forward` at NS = 64, 128,
#: 256, csrc/acs_soft_k1.cu): B = NARROW_B (no multiple of the 4 warps a
#: block) at each T (no step, one, a 32-step block less one and a block and
#: one from the default start and from carried metrics; (a)'s T at the n of
#: HARD_FORWARD_LONG_N, one a template, from both), and B = 1 at T = 33.
HARD_FORWARD_T = (0, 1, 31, 33, 2054)
HARD_FORWARD_LONG_N = (2, 6)


def compare_hard_forward(acs, spec, seg, init, err, what):
    """`acs_forward_batch` on one batch against its plain version: words
    and final metrics, one launch counted."""
    import torch
    key = "acs_k1_forward"
    before = acs.LAUNCHES[key]
    got = acs.acs_forward_batch(spec, seg, init)
    want = acs.acs_forward_batch_plain(spec, seg, init)
    case = f"{spec} {key} {what} init={init is not None}"
    require(acs.LAUNCHES[key] == before + (seg.shape[0] > 0),
            f"{case}: a launch counted")
    require(all(torch.equal(a, b) for a, b in zip(got, want)),
            f"{case}: words and final metrics equal to the plain version")
    err[key] = max(err[key], *map(max_abs_diff, got, want))


def phase_compare_hard_forward(fec, acs, dev, err):
    """The hard narrow forward against its plain version on the card at
    every line of its dispatch: NS = 64, 128, 256, each n = 1 ... 8 (one
    and two packed registers), a random code, uniform segments of n bits,
    B = NARROW_B at every HARD_FORWARD_T (T = 2054 at HARD_FORWARD_LONG_N
    only) and B = 1 at T = 33, from the default start and from carried
    metrics."""
    import numpy as np
    import torch
    rng = np.random.default_rng(2071)
    cases = 0
    for NS, _ in soft_forward_lines():
        for n in range(1, 9):
            spec = bfly_spec(fec, rng, NS, n)
            shapes = [(NARROW_B, T) for T in HARD_FORWARD_T
                      if T != HARD_FORWARD_T[-1] or n in HARD_FORWARD_LONG_N]
            for B, T in shapes + [(1, 33)]:
                seg = torch.from_numpy(rng.integers(0, 1 << n, (B, T)).astype(
                    np.uint8)).to(dev)
                init = torch.from_numpy(rng.integers(0, 6000, (B, NS)).astype(
                    np.int32)).to(dev)
                for given in (None, init):
                    compare_hard_forward(acs, spec, seg, given, err,
                                         f"B={B} T={T}")
                    cases += 1
        print(f"[compare] hard narrow forward NS={NS}: n = 1..8, B = "
              f"{NARROW_B} at T = {', '.join(map(str, HARD_FORWARD_T))} (T = "
              f"{HARD_FORWARD_T[-1]} at n = {HARD_FORWARD_LONG_N}) and B = 1, "
              "default and carried metrics: words and final metrics equal to "
              "the plain version")
    return cases


def multi_walk_batches(fec, acs, spec, rng, dev, G):
    """The batches of decision words on which the list walk at `spec`'s NS
    (segments of G steps) is held: yields (what, words).  B = NARROW_B at
    the tail-biting DCI trellis's 144 steps (noisy and garbage words) and
    at S + 5 steps; B = 3 over two windows (32 G + 45 steps) of words that
    send guesses wrong (`narrow_walk_words`' catastrophic ones); B = 1; at
    NS >= 64 a base 4 bytes past a 16-byte line (a word a step)."""
    import torch
    W = max(spec.num_states // 32, 1)

    def words(kind, B, T):
        return narrow_walk_words(fec, acs, spec, rng, dev, kind, B, T)

    for kind in ("noisy", "garbage"):
        yield kind, words(kind, NARROW_B, 144)
    yield "garbage", words("garbage", NARROW_B, spec.S + 5)
    yield "catastrophic", words("catastrophic", 3, 32 * G + 45)
    yield "noisy", words("noisy", 1, 57)
    if spec.num_states >= 64:
        T = 3 * G + 5
        big = words("noisy", 5, T)
        flat = torch.empty(5 * T * W + 1, dtype=torch.int32, device=dev)
        flat[1:] = big.reshape(-1)
        yield "4-byte base", flat[1:].view(5, T, W)


def phase_compare_list_walk(fec, acs, dev, err):
    """The list walk (`traceback_k1_multi`, the narrow walk's multi mode)
    against its plain version on the card at every line of its dispatch
    switch (NS = 2 ... 256): a random rate-1/4 code's `multi_walk_batches`,
    each at every case of `compare_multi` (NW = 1, 2, 8, NS; live 0, S,
    T - 1, T; `multi_windows`; bits and bytes).  Returns the cases."""
    import numpy as np
    rng = np.random.default_rng(2073)
    cases = 0
    for NS, G, WU in narrow_multi_lines():
        spec = bfly_spec(fec, rng, NS, 4)
        n, shapes = 0, []
        for what, words in multi_walk_batches(fec, acs, spec, rng, dev, G):
            n += compare_multi(acs, spec, words, err, rng)
            shapes.append(f"{what} B={words.shape[0]} T={words.shape[1]}")
        cases += n
        print(f"[compare] list walk NS={NS}: G {G}, warm-up {WU}; {n} cases "
              f"({'; '.join(shapes)}: NW 1/2/8/NS, live 0/S/T-1/T, windows "
              "from 0, 3, 48, T - 56, T - 1 (from 3 also cut), bits and "
              "bytes) equal to the plain version")
    return cases


# ---------------------------------------------------------------------------
# The single-pass block decode: TPU kernel K13 on csrc/block_1p.cu, the
# main path (m) and the harness path (n).


def compare_single_pass(fec, sp, spec, x, soft, err, T=None, routed=True):
    """`block_decode_1p` against its plain version on the card at T steps
    (default all of x's): bits and MSb-first bytes, each of the whole
    message and of a cut one (the plain version packs and cuts its bits,
    so one plain run serves all four); the route says SINGLE_PASS wherever
    `use_single_pass` holds (`routed`: a code the SWAR rules leave to it),
    and each launch counts.  Returns the plain version's bits."""
    import torch
    T = x.shape[1] if T is None else T
    B = x.shape[0]
    mode = "soft" if soft else "hard"
    if routed and sp.use_single_pass(spec, T):
        require(fec.select_kernel(spec, mode, T=T) == fec.kernels.SINGLE_PASS,
                f"{spec} {mode} T={T} on the SINGLE_PASS route")
    full = max(T - spec.S, 0)
    cut = cut_bits(full)
    row = "block_decode_1p wide" if spec.num_states >= 512 else \
        "block_decode_1p"
    want = sp.block_decode_1p_plain(spec, x, T, soft)
    pack = fec.ops.viterbi.pad_and_pack
    for out, L, expect in (("bits", full, want),
                           ("bytes", cut, pack(want[:, :cut])),
                           ("bits", cut, want[:, :cut]),
                           ("bytes", full, pack(want))):
        before = sp.LAUNCHES["block_decode_1p"]
        got = sp.block_decode_1p(spec, x, T, soft, out, L)
        torch.cuda.synchronize()
        require(sp.LAUNCHES["block_decode_1p"] == before + (B > 0),
                f"{spec} {mode} T={T} B={B}: one launch counted")
        require(torch.equal(got, expect), f"{spec} {mode} T={T} B={B} {out} "
                f"L={L} equal to the plain version")
        err[row] = max(err[row], max_abs_diff(got, expect))
    return want


def walk_guesses_wrong(words, T, S) -> int:
    """How many of csrc/block_1p.cu's walk guesses are wrong on these
    words, over all rows: lane l guesses the state at the top of its
    segment [l G, (l + 1) G) by walking from state 0 64 steps above
    (`walk`, kWarmup); each wrong guess makes lane 0 walk that segment
    again."""
    import numpy as np
    w = words.cpu().numpy().view(np.uint32)
    rows = np.arange(w.shape[0])
    top = S - 1

    def step(t, cur):
        i = (cur >> 1) | ((cur & 1) << top)
        return (cur >> 1) | (((w[rows, t, i >> 5] >> (i & 31)) & 1) << top)

    truth = np.empty((T, w.shape[0]), np.int64)
    cur = np.zeros(w.shape[0], np.int64)
    for t in range(T - 1, -1, -1):
        truth[t] = cur
        cur = step(t, cur)
    G = (((T + 31) >> 5) + 7) & ~7
    wrong = 0
    for lane in range(32):
        hi = min(min(lane * G, T) + G, T)
        if hi < T:
            x = np.zeros(w.shape[0], np.int64)
            for t in range(min(hi - 1 + 64, T - 1), hi - 1, -1):
                x = step(t, x)
            wrong += int((x != truth[hi - 1]).sum())
    return wrong


#: Catastrophic poly-symmetric codes at NS = 64, 128, 256 (each generator of
#: even weight: all share the factor 1 + D), whose survivors never merge.
SP_CATASTROPHIC = {64: (0o161, 0o107, 0o145), 128: (0o305, 0o231, 0o353),
                   256: (0o603, 0o445, 0o707)}
#: The warp kernel's edge lengths (its steps run in unrolled blocks of 32,
#: the last block a loop), besides each NS's longest single-pass T.
SP_EDGE_T = (20, 31, 32, 33, 97)
SP_EDGE_B = (SMALL_B, 6)


def compare_single_pass_edges(fec, sp, err, rng, segments, llrs):
    """The warp kernel (NS = 64, 128, 256) at its edges against its plain
    version: T < 32, a multiple of 32, between, and the longest
    single-pass T (4080, 2016, 1008); B odd, and B not a multiple of
    a block's 4 channels; noisy and garbage segments, LLRs over the whole
    int8 range; at the longest T garbage segments of a random and of a
    catastrophic code, on which the walk's guesses are wrong (counted on
    the plain words), so that its segments are walked again; whole and
    cut messages, bits and bytes."""
    import torch
    from convolutionalencdec_tpu_torch.kernels import acs
    for NS in SP_MID_NS:
        spec = bfly_spec(fec, rng, NS, 6)
        g = SP_CATASTROPHIC[NS]
        catastrophic = fec.CodeSpec(K=NS.bit_length(), g=g + g)
        top = 32768 * 8 // NS // 48 * 48
        require(sp.use_single_pass(spec, top)
                and not sp.use_single_pass(spec, top + 1),
                f"NS={NS}: {top} is the longest single-pass T")
        for T in SP_EDGE_T:
            for B in SP_EDGE_B:
                for kind in ("noisy", "garbage"):
                    compare_single_pass(fec, sp, spec,
                                        segments(spec, B, T, kind), False,
                                        err)
                compare_single_pass(fec, sp, spec, llrs(spec, B, T, 1), True,
                                    err)
        wrong = {}
        for name, code in (("random", spec), ("catastrophic", catastrophic)):
            seg = segments(code, SMALL_B, top, "garbage")
            compare_single_pass(fec, sp, code, seg, False, err)
            words, _ = acs.acs_forward_batch_plain(code, seg)
            wrong[name] = walk_guesses_wrong(words, top, code.S)
            require(wrong[name] > 0, f"NS={NS} {name} garbage T={top}: the "
                    "walk's guesses are wrong somewhere")
        compare_single_pass(fec, sp, spec, llrs(spec, SMALL_B, top, 1), True,
                            err)
        print(f"[compare] K13 NS={NS:5d} edges T={SP_EDGE_T} x B={SP_EDGE_B}"
              f" (noisy, garbage, int8 LLRs) and T={top} (garbage: "
              f"{wrong['random']} / {wrong['catastrophic']} wrong walk "
              f"guesses of {32 * SMALL_B}, random / catastrophic code; "
              "LLRs): whole and cut bits and bytes equal, each launch "
              "counted")


def single_pass_round_steps(source=None):
    """NS -> the steps a round R at which the dispatch switch of
    csrc/block_1p.cu (or of `source`, a copy of it) launches K13's wide
    template (hard and soft n <= 8), a block of NS >> R threads."""
    return wide_round_steps(source or ROOT / SOURCES["block_decode_1p"][0])


def compare_single_pass_rounds(fec, sp, err, rng, segments, llrs):
    """K13's wide template (the wide forward's rounds) at every line of its
    dispatch switch (`single_pass_round_steps`: NS = 512 ... 4096) against
    the plain version: random codes at n = 1 ... 8, hard and soft, at
    T = 1 ... 2R (every T mod R, T < R, whole rounds) and the longest
    single-pass T (and S, S + 1), B = SMALL_B; noisy and garbage segments
    and the four LLR draws (-128 among them) in turn; where the route is
    SINGLE_PASS (n >= 5) and T > S, `viterbi_decode_batch` and
    `viterbi_decode_batch_soft_bytes` on the same inputs equal to the plain
    bits and bytes; and soft n = 9, still on the barrier-a-step template,
    at R + 1 and the longest T.  Returns the cases."""
    import torch
    pack = fec.ops.viterbi.pad_and_pack
    cases = 0
    for NS, R in sorted(single_pass_round_steps().items()):
        top = 32768 * 8 // NS // 48 * 48
        lengths = sorted(set(range(1, 2 * R + 1)) | {NS.bit_length() - 1,
                                                      NS.bit_length(), top})
        for n in range(1, 9):
            spec = bfly_spec(fec, rng, NS, n)
            for T in lengths:
                kind = ("noisy", "garbage")[(n + T) % 2]
                seg = segments(spec, SMALL_B, T, kind)
                want = compare_single_pass(fec, sp, spec, seg, False, err,
                                           routed=n >= 5)
                q = llrs(spec, SMALL_B, T, n + T)
                want_q = compare_single_pass(fec, sp, spec, q, True, err,
                                             routed=n >= 5)
                cases += 2
                if n >= 5 and T > spec.S:
                    require(torch.equal(fec.viterbi_decode_batch(spec, seg),
                                        want),
                            f"{spec} viterbi_decode_batch T={T}")
                    require(torch.equal(fec.viterbi_decode_batch_soft_bytes(
                        spec, q), pack(want_q)),
                        f"{spec} viterbi_decode_batch_soft_bytes T={T}")
        spec = bfly_spec(fec, rng, NS, 9)
        for T in (R + 1, top):
            compare_single_pass(fec, sp, spec, llrs(spec, SMALL_B, T, T),
                                True, err)
            cases += 1
        print(f"[compare] K13 wide NS={NS:5d} R={R}: n = 1 ... 8 hard and "
              f"soft at T = {lengths}, soft n = 9 at T = {R + 1}, {top}: "
              "whole and cut bits and bytes equal, each launch counted; "
              "n = 5 ... 8 at T > S through viterbi_decode_batch and "
              "viterbi_decode_batch_soft_bytes equal")
    return cases


def phase_compare_single_pass(fec, dev, err):
    """K13 against its plain version on the card: random poly-symmetric
    codes at NS = 64, 128, 256 (n = 5..8 hard and soft, soft n = 9) at
    L = SMALL_L; noisy and garbage segments, four LLR draws; the warp
    kernel's edges (`compare_single_pass_edges`); the wide template's rounds
    (`compare_single_pass_rounds`); B = 1, 0; each decode entry on those
    inputs equal to the plain version."""
    import numpy as np
    import torch
    from convolutionalencdec_tpu_torch.kernels import single_pass as sp
    rng = np.random.default_rng(2041)

    def segments(spec, B, T, kind):
        msgs = rng.integers(0, 2, (B, max(T - spec.S, 0)), dtype=np.uint8)
        coded = encode_reference_np(spec, msgs)[:, :T]
        if kind == "garbage":
            coded = rng.integers(0, 1 << spec.n, coded.shape).astype(np.uint8)
        else:
            coded = corrupt(rng, coded, NOISE[0], spec.n)
        return torch.from_numpy(np.ascontiguousarray(coded)).to(dev)

    labels = list(soft_draws(rng, (1, 1, 1)))

    def llrs(spec, B, T, i):
        draw = soft_draws(rng, (B, T, spec.n))[labels[i % len(labels)]]
        return torch.from_numpy(draw.astype(np.int8)).to(dev)

    cases = [(NS, n) for NS in SP_MID_NS for n in range(5, 10)]
    for i, (NS, n) in enumerate(cases):
        spec = bfly_spec(fec, rng, NS, n)
        lengths = (SMALL_L + spec.S,)
        for T in lengths:
            if n <= 8:
                kind = ("noisy", "garbage")[i % 2]
                seg = segments(spec, SMALL_B, T, kind)
                want = compare_single_pass(fec, sp, spec, seg, False, err)
                if T > spec.S:
                    require(torch.equal(fec.viterbi_decode_batch(spec, seg),
                                        want),
                            f"{spec} viterbi_decode_batch T={T}")
            q = llrs(spec, SMALL_B, T, i)
            want = compare_single_pass(fec, sp, spec, q, True, err)
            if T > spec.S:
                require(torch.equal(fec.viterbi_decode_batch_soft_bytes(
                    spec, q), fec.ops.viterbi.pad_and_pack(want)),
                    f"{spec} viterbi_decode_batch_soft_bytes T={T}")
        print(f"[compare] K13 NS={NS:5d} n={n} {str(spec.g):42s} B={SMALL_B} "
              f"T={lengths}: {'hard and ' if n <= 8 else ''}soft bits and "
              "bytes equal, routes SINGLE_PASS")
    compare_single_pass_edges(fec, sp, err, rng, segments, llrs)
    compare_single_pass_rounds(fec, sp, err, rng, segments, llrs)
    # Edge batches, and one input padded past t_actual.
    for NS in (64, 512):
        spec = bfly_spec(fec, rng, NS, 6)
        for B in (1, 0):
            compare_single_pass(fec, sp, spec, segments(spec, B, 40, "noisy"),
                                False, err)
            compare_single_pass(fec, sp, spec, llrs(spec, B, 40, 1), True,
                                err)
        seg = segments(spec, 3, 48, "noisy")
        compare_single_pass(fec, sp, spec, seg, False, err, T=45)
        print(f"[compare] K13 NS={NS:5d} edges: B = 1, 0; T = 45 of 48 "
              "columns: equal")


def phase_single_pass(fec, acs, dev, err):
    """(m): SP_MAIN at bench.py's working set through
    `viterbi_decode_batch_bytes`, `viterbi_decode_batch` (3% segment
    corruption) and `viterbi_decode_batch_soft_bytes` (AWGN at 3 dB, qmax
    7), each equal to its plain route on the card; K13 launched and K1/K2
    not; the BER gates.  Returns (inputs for timing, launches by path,
    plain ms, summary)."""
    import numpy as np
    import torch
    from convolutionalencdec_tpu_torch.harness import bounds as hb
    from convolutionalencdec_tpu_torch.kernels import single_pass as sp
    from convolutionalencdec_tpu_torch.ops.viterbi import viterbi_decode_bytes
    spec = fec.CodeSpec(**SP_MAIN)
    rng = np.random.default_rng(MAIN_SEED)
    msgs = rng.integers(0, 2, (MAIN_B, MAIN_L), dtype=np.uint8)
    seg, _ = fec.encode_bits(spec, torch.from_numpy(msgs).to(dev))
    require(np.array_equal(seg.cpu().numpy(), encode_reference_np(spec, msgs)),
            "(m) encode on the card equals the trellis walk")
    seg = torch.from_numpy(
        corrupt(rng, seg.cpu().numpy(), MAIN_NOISE, spec.n)).to(dev)
    T = seg.shape[1]
    require(fec.select_kernel(spec, T=T) == fec.kernels.SINGLE_PASS
            and fec.select_kernel(spec, "soft", QMAX, T) ==
            fec.kernels.SINGLE_PASS, "(m) hard and soft on SINGLE_PASS")
    launches, plain_ms = {}, {}

    out, launches["single pass hard"] = drive(
        acs, lambda: fec.viterbi_decode_batch_bytes(spec, seg))
    want, plain_ms["single pass hard"] = time_once(
        lambda: viterbi_decode_bytes(spec, seg))
    require(torch.equal(out, want), "(m) hard bytes equal to the plain "
            "decode on the card")
    bits, launches["single pass bits"] = drive(
        acs, lambda: fec.viterbi_decode_batch(spec, seg))
    want_bits, plain_ms["block_decode_1p"] = time_once(
        lambda: sp.block_decode_1p_plain(spec, seg, T, False))
    require(torch.equal(bits, want_bits)
            and torch.equal(fec.ops.viterbi.pad_and_pack(bits), out),
            "(m) hard bits equal to the plain version and to the bytes")
    err["block_decode_1p"] = max(err["block_decode_1p"],
                                 max_abs_diff(out, want),
                                 max_abs_diff(bits, want_bits))
    hard_ber = ber_of_bytes(out, msgs)
    require(hard_ber < BER_LIMIT, f"(m) hard BER {hard_ber} < {BER_LIMIT}")

    gen = torch.Generator(device=dev).manual_seed(MAIN_SEED)
    _, llr = soft_channel(fec, spec, torch.from_numpy(msgs).to(dev), gen,
                          spec.rate)
    q = fec.quantize_llrs(llr, qmax=QMAX).reshape(MAIN_B, T, spec.n).to(
        torch.int8)
    out_s, launches["single pass soft"] = drive(
        acs, lambda: fec.viterbi_decode_batch_soft_bytes(spec, q, qmax=QMAX))
    qc = acs.condition_qllrs(q, 127)
    want_s, plain_ms["single pass soft"] = time_once(
        lambda: fec.viterbi_decode_soft(spec, qc))
    require(torch.equal(out_s, fec.ops.viterbi.pad_and_pack(want_s)),
            "(m) soft bytes equal to the plain soft decode on the card")
    err["block_decode_1p"] = max(err["block_decode_1p"], max_abs_diff(
        out_s, fec.ops.viterbi.pad_and_pack(want_s)))
    soft_ber = ber_of_bytes(out_s, msgs)
    hard_seg = fec.bits_to_segments(fec.hard_decision(llr), spec.n)
    awgn_hard_ber = ber_of_bytes(fec.viterbi_decode_batch_bytes(spec,
                                                                hard_seg),
                                 msgs)
    del llr, hard_seg
    hard_bound = hb.union_bound_ber(spec, EBN0_DB, "hard", SP_GATE_DMAX)
    require(awgn_hard_ber <= hard_bound, f"(m) hard BER {awgn_hard_ber} of "
            f"the {EBN0_DB} dB hard decisions <= the union bound "
            f"{hard_bound} ({SP_GATE_DMAX} distances)")
    require(soft_ber < awgn_hard_ber, f"(m) soft BER {soft_ber} below the "
            f"hard BER of the same received values {awgn_hard_ber}")
    for path in launches:
        used = launches[path]
        require(used["block_decode_1p"] > 0 and not used["acs_k1_forward"]
                and not used["traceback_k1"]
                and not used["acs_soft_k1_forward"],
                f"(m) {path}: K13 launched, K1/K4/K2 not: {nonzero({path: used})}")
    crossover = hb.qfunc((2 * spec.rate * 10 ** (EBN0_DB / 10)) ** 0.5)
    summary = {
        "spec": str(spec), "T": T, "decision_kb_per_channel":
            T * spec.num_states / 8 / 1024,
        "hard_ber": hard_ber, "soft_ber": soft_ber,
        "awgn_hard_ber": awgn_hard_ber, "awgn_crossover": crossover,
        "awgn_hard_bound": hard_bound, "gate_dmax": SP_GATE_DMAX,
        "awgn_hard_bound_dmax40": hb.union_bound_ber(spec, EBN0_DB, "hard",
                                                     SP_DMAX),
        "soft_bound": hb.union_bound_ber(spec, EBN0_DB, "soft",
                                         SP_GATE_DMAX),
        "soft_bound_dmax40": hb.union_bound_ber(spec, EBN0_DB, "soft",
                                                SP_DMAX)}
    print(f"[single pass] (m) {spec} B={MAIN_B} L={MAIN_L} T={T}: hard BER "
          f"at {MAIN_NOISE} segment corruption {hard_ber:.4e} (< "
          f"{BER_LIMIT}); at {EBN0_DB} dB: hard decisions (crossover "
          f"{crossover:.4f}) {awgn_hard_ber:.4e} <= union bound "
          f"{hard_bound:.4e} ({SP_GATE_DMAX} distances; slack "
          f"x{hard_bound / awgn_hard_ber:.2f}; 40 distances "
          f"{summary['awgn_hard_bound_dmax40']:.4e}), soft {soft_ber:.4e} "
          f"< that hard BER (x{awgn_hard_ber / max(soft_ber, 1e-12):.1f}; "
          f"soft bound {summary['soft_bound']:.4e}); each equal to its "
          f"plain route on the card; launches {nonzero(launches)}")
    return (spec, seg, q), launches, plain_ms, summary


def single_pass_times(fec, spec_in, seg_a):
    """Device ms at (m): each decode and `block_decode_1p` alone, hard and
    soft; and at (a)'s input (NASA_K7): K13 called directly, in turns with
    (a)'s two-pass decode (K1 + K2), its bytes equal to (a)'s."""
    import torch
    from convolutionalencdec_tpu_torch.kernels import single_pass as sp
    spec, seg, q = spec_in
    T = seg.shape[1]
    runs = {}
    bufs = [torch.roll(seg, r + 1, dims=0) for r in range(TIMED_CALLS)]
    runs["block_decode_1p"] = device_times(
        lambda s: sp.block_decode_1p(spec, s, T, False, "bytes", MAIN_L), bufs)
    runs["single pass hard"] = device_times(
        lambda s: fec.viterbi_decode_batch_bytes(spec, s), bufs)
    runs["single pass bits"] = device_times(
        lambda s: fec.viterbi_decode_batch(spec, s), bufs)
    qbufs = [torch.roll(q, r + 1, dims=0) for r in range(TIMED_CALLS)]
    runs["block_decode_1p soft"] = device_times(
        lambda x: sp.block_decode_1p(spec, x, T, True, "bytes", MAIN_L),
        qbufs)
    runs["single pass soft"] = device_times(
        lambda x: fec.viterbi_decode_batch_soft_bytes(spec, x, qmax=QMAX),
        qbufs)
    del bufs, qbufs
    nasa = fec.NASA_K7
    Ta = seg_a.shape[1]
    want = fec.viterbi_decode_batch_bytes(nasa, seg_a)
    got = sp.block_decode_1p(nasa, seg_a, Ta, False, "bytes", MAIN_L)
    require(torch.equal(got, want), "K13 on (a)'s input equal to (a)'s bytes")
    bufs = [torch.roll(seg_a, r + 1, dims=0) for r in range(TIMED_CALLS)]
    for turn in ("1", "2"):
        runs[f"two-pass at (a) {turn}"] = device_times(
            lambda s: fec.viterbi_decode_batch_bytes(nasa, s), bufs)
        runs[f"block_decode_1p at (a) {turn}"] = device_times(
            lambda s: sp.block_decode_1p(nasa, s, Ta, False, "bytes",
                                         MAIN_L), bufs)
    for key in ("two-pass at (a)", "block_decode_1p at (a)"):
        runs[key] = runs.pop(f"{key} 1") + runs.pop(f"{key} 2")
    return runs


def phase_single_pass_wide(fec, acs, dev, err):
    """(o): SP_WIDE_MAIN at B = MAIN_B, T = SP_WIDE_T through
    `viterbi_decode_batch_bytes` (3% segment corruption) and
    `viterbi_decode_batch_soft_bytes` (AWGN at 3 dB, qmax 7), each equal to
    its plain route on the card and to `block_decode_1p_plain`; K13
    launched and the two-pass wide kernels not; hard BER < BER_LIMIT, the
    soft BER below the hard decisions' of the same values.  Returns (inputs
    for timing, launches by path, plain ms, summary)."""
    import numpy as np
    import torch
    from convolutionalencdec_tpu_torch.kernels import single_pass as sp
    from convolutionalencdec_tpu_torch.ops.viterbi import viterbi_decode_bytes
    spec = fec.CodeSpec(**SP_WIDE_MAIN)
    L = SP_WIDE_T - spec.S
    rng = np.random.default_rng(MAIN_SEED)
    msgs = rng.integers(0, 2, (MAIN_B, L), dtype=np.uint8)
    seg, _ = fec.encode_bits(spec, torch.from_numpy(msgs).to(dev))
    require(np.array_equal(seg.cpu().numpy(), encode_reference_np(spec, msgs)),
            "(o) encode on the card equals the trellis walk")
    seg = torch.from_numpy(
        corrupt(rng, seg.cpu().numpy(), MAIN_NOISE, spec.n)).to(dev)
    T = seg.shape[1]
    require(T == SP_WIDE_T and sp.use_single_pass(spec, T)
            and not sp.use_single_pass(spec, T + 1),
            f"(o) T = {T} is the longest single-pass T")
    require(fec.select_kernel(spec, T=T) == fec.kernels.SINGLE_PASS
            and fec.select_kernel(spec, "soft", QMAX, T) ==
            fec.kernels.SINGLE_PASS, "(o) hard and soft on SINGLE_PASS")
    launches, plain_ms = {}, {}
    pack = fec.ops.viterbi.pad_and_pack

    out, launches["(o) hard"] = drive(
        acs, lambda: fec.viterbi_decode_batch_bytes(spec, seg))
    want, plain_ms["(o) hard"] = time_once(
        lambda: viterbi_decode_bytes(spec, seg))
    require(torch.equal(out, want), "(o) hard bytes equal to the plain "
            "decode on the card")
    bits, plain_ms["block_decode_1p wide"] = time_once(
        lambda: sp.block_decode_1p_plain(spec, seg, T, False))
    require(torch.equal(pack(bits), out),
            "(o) hard bytes equal to block_decode_1p_plain")
    err["block_decode_1p wide"] = max(err["block_decode_1p wide"],
                                      max_abs_diff(out, want))
    hard_ber = ber_of_bytes(out, msgs)
    require(hard_ber < BER_LIMIT, f"(o) hard BER {hard_ber} < {BER_LIMIT}")

    gen = torch.Generator(device=dev).manual_seed(MAIN_SEED)
    _, llr = soft_channel(fec, spec, torch.from_numpy(msgs).to(dev), gen,
                          spec.rate)
    q = fec.quantize_llrs(llr, qmax=QMAX).reshape(MAIN_B, T, spec.n).to(
        torch.int8)
    out_s, launches["(o) soft"] = drive(
        acs, lambda: fec.viterbi_decode_batch_soft_bytes(spec, q, qmax=QMAX))
    qc = acs.condition_qllrs(q, 127)
    want_s, plain_ms["(o) soft"] = time_once(
        lambda: fec.viterbi_decode_soft(spec, qc))
    require(torch.equal(out_s, pack(want_s)),
            "(o) soft bytes equal to the plain soft decode on the card")
    bits_s, plain_ms["block_decode_1p wide soft"] = time_once(
        lambda: sp.block_decode_1p_plain(spec, q, T, True))
    require(torch.equal(pack(bits_s), out_s),
            "(o) soft bytes equal to block_decode_1p_plain")
    err["block_decode_1p wide"] = max(err["block_decode_1p wide"],
                                      max_abs_diff(out_s, pack(want_s)))
    soft_ber = ber_of_bytes(out_s, msgs)
    hard_seg = fec.bits_to_segments(fec.hard_decision(llr), spec.n)
    awgn_hard_ber = ber_of_bytes(fec.viterbi_decode_batch_bytes(spec,
                                                                hard_seg),
                                 msgs)
    del llr, hard_seg
    require(soft_ber < awgn_hard_ber, f"(o) soft BER {soft_ber} below the "
            f"hard BER of the same received values {awgn_hard_ber}")
    for path, used in launches.items():
        require(used["block_decode_1p"] > 0 and not used["acs_wide_forward"]
                and not used["acs_soft_wide_forward"]
                and not used["traceback_wide"],
                f"{path}: K13 launched, the two-pass wide kernels not: "
                f"{nonzero({path: used})}")
    summary = {"spec": str(spec), "T": T, "L": L,
               "decision_kb_per_channel": T * spec.num_states / 8 / 1024,
               "round_steps": single_pass_round_steps()[spec.num_states],
               "hard_ber": hard_ber, "soft_ber": soft_ber,
               "awgn_hard_ber": awgn_hard_ber}
    print(f"[single pass] (o) {spec} B={MAIN_B} L={L} T={T}: hard BER at "
          f"{MAIN_NOISE} segment corruption {hard_ber:.4e} (< {BER_LIMIT}); "
          f"at {EBN0_DB} dB: hard decisions {awgn_hard_ber:.4e}, soft "
          f"{soft_ber:.4e}; each equal to its plain route on the card; "
          f"launches {nonzero(launches)}")
    return (spec, seg, q), launches, plain_ms, summary


def single_pass_wide_times(fec, acs, spec_in):
    """Device ms at (o): each decode, and K13 alone, hard and soft, in turns
    with the two-pass wide kernels called directly on the same input (the
    forward, then the terminated walk: `acs_wide_forward` or
    `acs_soft_wide_forward`, then `traceback_wide`), their bytes equal to
    K13's."""
    import torch
    from convolutionalencdec_tpu_torch.kernels import single_pass as sp
    spec, seg, q = spec_in
    T = seg.shape[1]
    L = T - spec.S
    runs = {}
    bufs = [torch.roll(seg, r + 1, dims=0) for r in range(TIMED_CALLS)]
    qbufs = [torch.roll(q, r + 1, dims=0) for r in range(TIMED_CALLS)]
    runs["(o) hard"] = device_times(
        lambda s: fec.viterbi_decode_batch_bytes(spec, s), bufs)
    runs["(o) soft"] = device_times(
        lambda x: fec.viterbi_decode_batch_soft_bytes(spec, x, qmax=QMAX),
        qbufs)

    def two_pass(x, soft):
        words = (acs.acs_forward_batch_soft(spec, x, 127) if soft
                 else acs.acs_forward_batch(spec, x))[0]
        return acs.traceback_batch(spec, words, T, L, "bytes")

    for soft, xs in ((False, bufs), (True, qbufs)):
        tag = " soft" if soft else ""
        require(torch.equal(two_pass(xs[0], soft), sp.block_decode_1p(
            spec, xs[0], T, soft, "bytes", L)),
            f"(o){tag}: the two-pass kernels' bytes equal K13's")
        for turn in ("1", "2"):
            runs[f"two-pass{tag} at (o) {turn}"] = device_times(
                lambda x: two_pass(x, soft), xs)
            runs[f"block_decode_1p wide{tag} {turn}"] = device_times(
                lambda x: sp.block_decode_1p(spec, x, T, soft, "bytes", L),
                xs)
        for key in (f"two-pass{tag} at (o)", f"block_decode_1p wide{tag}"):
            runs[key] = runs.pop(f"{key} 1") + runs.pop(f"{key} 2")
    return runs


def phase_harness(fec, acs, dev, seg_a):
    """(n): `run_curve` on SP_MAIN at CURVE_POINTS (K13 in its hard and its
    soft calls) beside `bound_curve`; berTestK7's acceptance run on NASA_K7
    at its 10% gate; one `bench_decode` tick on SP_MAIN; the traffic model
    at (a) and (m).  Returns (launches by path, summary)."""
    import torch
    from convolutionalencdec_tpu_torch import harness, utils
    from convolutionalencdec_tpu_torch.harness import speed
    spec = fec.CodeSpec(**SP_MAIN)
    launches = {}
    t0 = time.perf_counter()
    curve, launches["harness curve"] = drive(acs, lambda: harness.run_curve(
        spec, list(CURVE_POINTS), n_packets=CURVE_PACKETS, packet_bits=MAIN_L,
        batch=CURVE_PACKETS, seed=MAIN_SEED, verbose=False, device=dev))
    curve_s = time.perf_counter() - t0
    require(launches["harness curve"]["block_decode_1p"] ==
            2 * len(CURVE_POINTS), f"(n) K13 launched by every hard and soft "
            f"call of the curve: {nonzero(launches)}")
    bound = harness.bound_curve(spec, CURVE_POINTS, SP_DMAX)
    for pt, b in zip(curve, bound):
        pt.update(hard_bound=b["hard_ber_bound"],
                  soft_bound=b["soft_ber_bound"])
        require(pt["soft_ber"] <= pt["hard_ber"],
                f"(n) soft BER below hard at {pt['ebn0_db']} dB: {pt}")
        print(f"[harness] (n) run_curve {pt['ebn0_db']:.1f} dB: hard BER "
              f"{pt['hard_ber']:.4e} (union bound {pt['hard_bound']:.4e}), "
              f"soft {pt['soft_ber']:.4e} (bound {pt['soft_bound']:.4e}), "
              f"{pt['bits']} bits")
    t0 = time.perf_counter()
    ber, launches["harness berTestK7"] = drive(
        acs, lambda: harness.run_reference_ber_test(
            fec.NASA_K7, n_packets=BER_TEST_PACKETS, batch=MAIN_B,
            verbose=False, device=dev))
    ber_s = time.perf_counter() - t0
    for r in ber:
        print(f"[harness] (n) berTestK7 {r.snr_db:+.0f} dB: coded BER "
              f"{r.measured_coded_ber:.6e} vs {r.expected_coded_ber:.6e} "
              f"({100 * r.relative_error:.2f}%), channel "
              f"{r.measured_uncoded_ber:.5e} vs {r.uncoded_ber:.5e}, "
              f"{r.bits_tested} bits [{'PASS' if r.passed else 'FAIL'}]")
        require(r.passed, f"(n) berTestK7 at {r.snr_db} dB within 10%")
    require(launches["harness berTestK7"]["acs_k1_forward"] > 0,
            "(n) berTestK7 on the kernels")
    mbps, launches["harness bench"] = drive(acs, lambda: speed.bench_decode(
        spec, batch=MAIN_B, packet_bits=MAIN_L, seconds=0.0, device=dev))
    require(launches["harness bench"]["block_decode_1p"] > 0,
            "(n) bench_decode on K13")
    print(f"[harness] (n) bench_decode tick ({speed.NBUF} calls): "
          f"{mbps:.1f} decoded Mbit/s on {spec}")
    traffic = {}
    for what, code in (("(a)", fec.NASA_K7), ("(m)", spec)):
        print(f"[harness] {what} {utils.traffic_report(code, MAIN_B, seg_a.shape[1])}")
        traffic[what] = {m: utils.kernel_traffic(code, MAIN_B,
                                                 seg_a.shape[1], m)
                         for m in utils.telemetry.MODES}
    summary = {"curve": curve, "curve_s": curve_s, "ber_test": [
        dataclass_dict(r) for r in ber], "ber_test_s": ber_s,
        "bench_decode_mbps": mbps, "traffic": traffic}
    return launches, summary


def dataclass_dict(r) -> dict:
    import dataclasses
    return dict(dataclasses.asdict(r), relative_error=r.relative_error,
                passed=r.passed)


def stream_work(B: int, T: int, NS: int, W: int):
    """(bytes, int32 operations) of one `stream_k1_decode` call of T
    steps on B channels: the ACS and the argmin every step, the symbol's
    walk of W - 1 steps, each state's register out (module constants)."""
    return (2 * B * T + 2 * B * NS * 12,
            B * T * (NS // 2 * ACS_OPS + NS * ARGMIN_OPS
                     + (W - 1) * TRACEBACK_OPS)
            + B * NS * W * TRACEBACK_OPS)


def bounds(lens_sum: int, generic_shapes, bfly_shapes):
    """(bound ms, what bounds it) of each kernel on this run's main-path
    inputs: the larger of the bytes it must move (each input read once,
    each output written once) over HBM_BYTES_PER_S and its int32 operations
    over INT32_OPS_PER_S.  `generic_shapes`: (name, spec, T, L) of each
    generic-k main-path code; its kernels' keys end in the name.
    `bfly_shapes`: (spec, T, lens_sum) of (k) and of (l), and (B, steps,
    walks) of (l)'s list walk."""
    work = {}
    (sspec, sT, slens), (wspec, wT, wlens), (lB, lsteps, lwalks) = bfly_shapes
    B, L = MAIN_B, MAIN_L
    for pre, spec, T, lens, walk in (
            ("acs_small_forward", sspec, sT, slens, "traceback_k1"),
            ("acs_wide_forward", wspec, wT, wlens, "traceback_wide")):
        NS, n = spec.num_states, spec.n
        # One decision bit per state and step (the small kernels' words pad
        # 16 states to 32 bits: padding, not work); the wide walk needs one
        # 32-byte sector of decisions per step, the one-word walk the step's
        # NS/8 bytes.
        dec = B * T * NS // 8
        ops = B * T * NS // 2 * ACS_OPS
        per_step = 32 if NS >= 512 else NS // 8
        soft_pre = pre.replace("acs_", "acs_soft_")
        work[pre] = (B * T + dec + B * NS * 4, ops)
        work[soft_pre] = (B * T * n + dec + B * NS * 4, ops)
        suffix = " w1" if NS < 64 else ""
        work[walk + suffix] = (B * T * per_step + B * L // 8,
                               B * T * TRACEBACK_OPS)
        work[walk + "_ragged" + suffix] = (
            lens * per_step + 4 * B + B * L // 8, lens * TRACEBACK_OPS)
    # (k)'s masked walk: all T steps from random starts, one bit per step
    # out.
    work["traceback_k1_masked (k)"] = (
        B * sT * sspec.num_states // 8 + 4 * B + B * sT, B * sT * TRACEBACK_OPS)
    # (l)'s K11 masked walk: all T steps from state 0, one bit per step out;
    # its list: `lwalks` walks of each of `lB` packets over `lsteps` steps.
    work["traceback_wide_masked"] = (B * wT * 32 + 4 * B + B * wT,
                                     B * wT * TRACEBACK_OPS)
    work["traceback_wide_multi"] = (
        lB * lwalks * lsteps * 32 + 4 * lB * lwalks + lB * lwalks * lsteps,
        lB * lwalks * lsteps * TRACEBACK_OPS)
    # K13 at (m) and at (a)'s input (both NS = 64, T = L + 6): the inputs in
    # and the bytes out, no decisions; the ACS's operations.
    T = MAIN_L + 6
    sp_ops = B * T * 64 // 2 * ACS_OPS
    sp_out = B * MAIN_L // 8
    work["block_decode_1p"] = (B * T + sp_out, sp_ops)
    work["block_decode_1p at (a)"] = work["block_decode_1p"]
    work["block_decode_1p soft"] = (B * T * SP_MAIN_N + sp_out, sp_ops)
    # K13's wide template at (o): the same count at NS = 512, T = 480.
    NS_o, n_o, T_o = 1 << (SP_WIDE_MAIN["K"] - 1), len(SP_WIDE_MAIN["g"]), \
        SP_WIDE_T
    o_ops = B * T_o * NS_o // 2 * ACS_OPS
    o_out = B * ((T_o - SP_WIDE_MAIN["K"] + 1 + 7) // 8)
    work["block_decode_1p wide"] = (B * T_o + o_out, o_ops)
    work["block_decode_1p wide soft"] = (B * T_o * n_o + o_out, o_ops)
    for name, spec, T, L in generic_shapes:
        # Segments in, one decision bit per state, step and input bit and
        # the final metrics out (the kernels' int32 words hold 32 - NS
        # zeros per step when NS < 32: padding, not counted); per state and
        # step 2^k adds and 2^k - 1 compare-selects.  The traceback reads
        # the decision bits and writes the bytes, TRACEBACK_OPS per decoded
        # bit.
        NS, k = spec.num_states, spec.k
        planes = -(-MAIN_B * T * k * NS // 8)
        fwd = (MAIN_B * T + planes + MAIN_B * NS * 4,
               MAIN_B * T * NS * (2 * (1 << k) - 1))
        tb = (planes + MAIN_B * ((L + 7) // 8), MAIN_B * L * TRACEBACK_OPS)
        for family in ("acs_generic_forward", "acs_generic_k2_forward"):
            work[f"{family} {name}"] = fwd
        for family in ("traceback_generic", "traceback_generic_k2"):
            work[f"{family} {name}"] = tb
    B, L, NS, n = MAIN_B, MAIN_L, 64, 2
    T = L + 6
    dec_bytes = B * T * NS // 8
    fm_bytes = B * NS * 4
    acs_ops = B * T * NS // 2 * ACS_OPS
    work.update({
        "acs_k1_forward": (B * T + dec_bytes + fm_bytes, acs_ops),
        "acs_soft_k1_forward": (B * T * n + dec_bytes + fm_bytes, acs_ops),
        "traceback_k1": (dec_bytes + B * L // 8, B * T * TRACEBACK_OPS),
        # Only the steps below each channel's length are needed.
        "traceback_k1_ragged": (lens_sum * NS // 8 + 4 * B + B * L // 8,
                                lens_sum * TRACEBACK_OPS),
        # Hard segments in, one symbol byte per step out, the carried state
        # (int32 metric + int64 register per state) in and out; at (a)'s
        # size and at one 256-step call of the streaming feed.
        "stream_k1_decode": stream_work(B, T, NS, MAIN_W),
        "stream_k1_decode 256": stream_work(B, STREAM_FEED[0], NS, MAIN_W),
        # One interior call's pending buffer: 288 steps of words and the
        # start states in, the bits of 240 steps out.
        "traceback_k1_masked": (B * 288 * NS // 8 + 4 * B + B * 240,
                                B * 288 * TRACEBACK_OPS),
        # (h): the int8 LLRs read twice (forward and replay), the int32
        # LLRs written once.
        "maxlogmap_k1": (2 * B * T * n + 4 * B * T,
                         B * T * (NS // 2 * ACS_OPS * MAP_PASSES
                                  + NS * EMIT_OPS)),
    })
    # (i): one MAP call, three int32 fields and two tails in, lapp out.
    Bt, Lt, NSt, St = TURBO_B, TURBO_L, 8, 3
    work["turbo_rsc_map"] = (4 * Bt * (4 * Lt + 2 * St),
                             RSC_OPS * NSt * Bt * Lt)
    # Tail-biting at (a)'s size (LTE_TBCC_K7, NS = 64): K6 walks the list
    # trellis's last D steps (the message window) for each of DCI_LIST
    # starts, one output byte per bit; K2m walks the whole two-sided wrap
    # trellis and emits the bits of its first wl + D steps.
    from convolutionalencdec_tpu_torch import LTE_TBCC_K7
    from convolutionalencdec_tpu_torch.kernels.tailbiting import kernel_wraps
    B, D, walks = DCI_B, DCI_PAYLOAD + 16, DCI_LIST
    wl, wr = kernel_wraps(LTE_TBCC_K7, D)
    Te = wl + D + wr
    work["traceback_k1_multi"] = (
        B * D * NS // 8 + 4 * B * walks + B * walks * D,
        B * walks * D * TRACEBACK_OPS)
    work["traceback_k1_masked tailbiting"] = (
        B * Te * NS // 8 + 4 * B + B * (wl + D), B * Te * TRACEBACK_OPS)
    # K4 in the wrap decode: its LLRs and the uniform start in, the words
    # and the final metrics out.
    n = LTE_TBCC_K7.n
    work["acs_soft_k1_forward (f)"] = (
        B * Te * n + B * Te * NS // 8 + 2 * B * NS * 4,
        B * Te * NS // 2 * ACS_OPS)
    out = {}
    for name, (nbytes, ops) in work.items():
        by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        by_ops = ops / INT32_OPS_PER_S * 1e3
        out[name] = ((by_bytes, "bytes") if by_bytes >= by_ops
                     else (by_ops, "operations"))
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    try:
        import convolutionalencdec_tpu_torch as fec
    except ImportError as exc:
        print(f"chip_smoke: the port package is missing: {exc}",
              file=sys.stderr)
        return 1
    from convolutionalencdec_tpu_torch.kernels import _build, acs, stream
    from convolutionalencdec_tpu_torch.kernels import generic as gk
    dev = torch.device("cuda", 0)

    card = phase_environment(_build)
    phase_build(_build)
    err = dict.fromkeys(KERNELS, 0)
    t0 = time.perf_counter()
    phase_compare(fec, acs, dev, err)
    print(f"[compare] {time.perf_counter() - t0:.1f} s")
    msgs, seg, hard_launches, plain_ms = phase_main(fec, acs, dev, err)
    q, soft_launches, soft_plain = phase_soft(fec, acs, dev, err, msgs)
    rp_in, rp_launches, rp_plain = phase_ragged_punctured(fec, acs, dev, err)
    lens = rp_in[2]
    plain_ms.update(soft_plain, **rp_plain)
    t0 = time.perf_counter()
    phase_compare_stream(fec, acs, stream, dev, err)
    print(f"[compare] streaming kernels {time.perf_counter() - t0:.1f} s")
    stream_launches, stream_plain = phase_stream(fec, acs, dev, err, msgs,
                                                 seg, q)
    plain_ms.update(stream_plain)
    plain_ms.update(stream_plain_kernel_ms(fec, acs, stream, seg, q, err))
    t0 = time.perf_counter()
    phase_compare_tailbiting(fec, acs, dev, err)
    print(f"[compare] tail-biting {time.perf_counter() - t0:.1f} s")
    tb_in, tb_launches, tb_plain, tb_summary = phase_tailbiting(fec, acs, dev,
                                                                err)
    plain_ms.update(tb_plain)
    t0 = time.perf_counter()
    phase_compare_soft_output(fec, dev, err)
    print(f"[compare] soft-output {time.perf_counter() - t0:.1f} s")
    map_launches, map_plain, map_summary = phase_maxlogmap(fec, acs, dev, err,
                                                           msgs, q)
    plain_ms.update(map_plain)
    q_turbo, turbo_launches, turbo_plain, turbo_summary = phase_turbo(
        fec, acs, dev, err)
    plain_ms.update(turbo_plain)
    t0 = time.perf_counter()
    phase_compare_generic(fec, gk, dev, err)
    print(f"[compare] generic-k {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    gen_in, gen_launches, gen_plain, gen_summary = phase_generic(
        fec, acs, gk, dev, err)
    plain_ms.update(gen_plain)
    print(f"[generic] main path {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_compare_butterfly(fec, acs, dev, err)
    print(f"[compare] small and wide butterfly codes "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    small_in, small_launches, small_plain, small_summary = phase_small(
        fec, acs, dev, err)
    wide_in, wide_launches, wide_plain, wide_summary = phase_wide(
        fec, acs, dev, err)
    plain_ms.update(small_plain, **wide_plain)
    print(f"[small/wide] main paths {time.perf_counter() - t0:.1f} s")
    runs = phase_times(fec, acs, seg, q, rp_in)
    runs.update(tailbiting_times(fec, acs, tb_in))
    runs.update(soft_output_times(fec, q, q_turbo))
    runs.update(generic_times(fec, gk, gen_in))
    t0 = time.perf_counter()
    runs.update(butterfly_times(fec, acs, small_in, wide_in))
    print(f"[time] small and wide butterfly codes "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_compare_single_pass(fec, dev, err)
    print(f"[compare] single pass {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    sp_in, sp_launches, sp_plain, sp_summary = phase_single_pass(fec, acs,
                                                                 dev, err)
    plain_ms.update(sp_plain)
    print(f"[single pass] main path {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    runs.update(single_pass_times(fec, sp_in, seg))
    print(f"[time] single pass {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    spw_in, spw_launches, spw_plain, spw_summary = phase_single_pass_wide(
        fec, acs, dev, err)
    plain_ms.update(spw_plain)
    runs.update(single_pass_wide_times(fec, acs, spw_in))
    print(f"[single pass] (o) main path and times "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    harness_launches, harness_summary = phase_harness(fec, acs, dev, seg)
    print(f"[harness] {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_compare_narrow_walks(fec, acs, dev, err)
    print(f"[compare] narrow walks {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    cases = phase_compare_soft_forward(fec, acs, dev, err)
    print(f"[compare] narrow soft forward: {cases} cases "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    cases = phase_compare_small_forward(fec, acs, dev, err)
    print(f"[compare] small forward: {cases} cases "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    cases = phase_compare_hard_forward(fec, acs, dev, err)
    print(f"[compare] hard narrow forward: {cases} cases "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    cases = phase_compare_list_walk(fec, acs, dev, err)
    print(f"[compare] list walk: {cases} cases "
          f"{time.perf_counter() - t0:.1f} s")
    small_summary["walk_kernels"] = small_walk_kernels(fec, acs, small_in)

    # Launch counts: the sum over the main-path runs, each read just after.
    # A one-word row counts its walk's launches at (k) only.
    by_path = {"hard": hard_launches, "soft": soft_launches, **rp_launches,
               **stream_launches, **tb_launches, "maxlogmap": map_launches,
               **turbo_launches, **gen_launches, **small_launches,
               **wide_launches, **sp_launches, **spw_launches,
               **harness_launches}

    def path_launches(name):
        """A row's launches: a split row's on its main path's paths, the
        entry's own row's on the others."""
        if name in SPLIT_ROWS:
            key, prefix = SPLIT_ROWS[name]
            return {p: c[key] for p, c in by_path.items()
                    if p.startswith(prefix)}
        other = tuple(prefix for key, prefix in SPLIT_ROWS.values()
                      if key == name)
        return {p: c[name] for p, c in by_path.items()
                if not (other and p.startswith(other))}

    launches = {k: sum(path_launches(k).values()) for k in KERNELS}
    bits_per_call = MAIN_B * MAIN_L
    dci_bits = DCI_B * (DCI_PAYLOAD + 16)
    turbo_bits = TURBO_B * TURBO_L
    generic_bits = {name: MAIN_B * L for name, _, _, L in gen_in}
    o_bits = MAIN_B * (SP_WIDE_T - spw_in[0].S)
    med = {key: statistics.median(ms) for key, ms in runs.items()}
    for key, ms in med.items():
        plain = plain_ms.get(key.removesuffix(" wall").removesuffix(" host"))
        code = key.rsplit(" ", 1)[-1]
        bits = (generic_bits[code] if code in generic_bits
                else o_bits if "(o)" in key or "1p wide" in key
                else WIDE_LIST_B * MAIN_L
                if key in ("traceback_wide_multi", "wide list")
                else dci_bits if "tailbiting c" in key or "rate-matched" in key
                or key.endswith(("multi", "masked tailbiting", "(f)"))
                else turbo_bits if key.startswith("turbo")
                else bits_per_call)
        print(f"[time] {key:22s} median {ms:.4f} ms, min {min(runs[key]):.4f}"
              f" ms of {TIMED_CALLS} = {bits / (ms * 1e3):.1f} "
              f"decoded Mbit/s; plain "
              f"{'-' if plain is None else f'{plain:.1f}'} ms [{card}]")
    small_spec, small_seg, _, _, small_lens = small_in
    wide_spec, wide_seg, _, wide_lens = wide_in[:4]
    bound = bounds(int(lens.clamp(0, seg.shape[1]).sum()),
                   [(name, spec, x.shape[1], L) for name, spec, x, L in gen_in],
                   ((small_spec, small_seg.shape[1],
                     int(small_lens.clamp(0, small_seg.shape[1]).sum())),
                    (wide_spec, wide_seg.shape[1],
                     int(wide_lens.clamp(0, wide_seg.shape[1]).sum())),
                    (WIDE_LIST_B, MAIN_L, WIDE_LIST_SIZE)))
    # The generic-k kernels' numbers are those of one main-path code: K10's
    # of the k2 code, K9's of GENERIC_K9_CODE.
    k2_code = GENERIC_MAIN[0][0]
    timed_as = {name: f"{name} {code}" for name, code in (
        ("acs_generic_forward", GENERIC_K9_CODE),
        ("traceback_generic", GENERIC_K9_CODE),
        ("acs_generic_k2_forward", k2_code),
        ("traceback_generic_k2", k2_code))}
    kernels = []
    for name in KERNELS:
        source, replaces = SOURCES[name]
        key = timed_as.get(name, name)
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "launches_by_path": path_launches(name),
            "max_abs_err": err[name], "ms": med[key],
            "min_ms": min(runs[key]), "plain_ms": plain_ms[key],
            "bound_ms": bound[key][0], "bound_by": bound[key][1],
            "library_ms": None})
        require(launches[name] > 0, f"{name} launched on the main paths")
        require(err[name] == 0, f"{name} equal to its plain version")
    # Every code each generic-k kernel ran on.  The k2 kernels' plain
    # versions are the runtime-k ones', timed once per code on its route.
    twins = {"acs_generic_forward": "acs_generic_k2_forward",
             "traceback_generic": "traceback_generic_k2"}
    twins.update({v: k for k, v in twins.items()})
    for name in twins:
        kernels[KERNELS.index(name)]["by_code"] = {
            code: {"ms": med[f"{name} {code}"],
                   "min_ms": min(runs[f"{name} {code}"]),
                   "plain_ms": plain_ms.get(f"{name} {code}", plain_ms.get(
                       f"{twins[name]} {code}")),
                   "bound_ms": bound[f"{name} {code}"][0],
                   "bound_by": bound[f"{name} {code}"][1]}
            for code in generic_bits if f"{name} {code}" in med}
    generic = {"codes": gen_summary, "k2_instantiation_vs_runtime_k": {
        kind: {"k2_ms": med[f"{k2} {k2_code}"],
               "runtime_k_ms": med[f"{rt} {k2_code}"]}
        for kind, rt, k2 in (("forward", "acs_generic_forward",
                              "acs_generic_k2_forward"),
                             ("traceback", "traceback_generic",
                              "traceback_generic_k2"))}}
    for code in generic_bits:
        path = f"generic {code}"
        generic["codes"][code].update(
            ms=med[path], min_ms=min(runs[path]), plain_ms=plain_ms[path],
            mbps=generic_bits[code] / (med[path] * 1e3))
    # (l)'s plain versions ran on its first rows, its kernels were timed
    # with fewer calls.
    for name in KERNELS:
        if "wide" in name:
            kernels[KERNELS.index(name)].update(
                plain_rows=8 if name == "traceback_wide_multi"
                else WIDE_PLAIN_ROWS, timed_calls=WIDE_TIMED_CALLS)
    butterfly = {"small": dict(small_summary), "wide": dict(wide_summary)}
    for kind, paths in (("small", ("small hard", "small soft",
                                   "small ragged")),
                        ("wide", ("wide hard", "wide soft", "wide ragged",
                                  "wide list"))):
        for path in paths:
            bits = WIDE_LIST_B * MAIN_L if path == "wide list" \
                else bits_per_call
            butterfly[kind][path] = {
                "ms": med[path], "min_ms": min(runs[path]),
                "plain_ms": plain_ms.get(path),
                "mbps": bits / (med[path] * 1e3)}
    butterfly["wide"]["plain_rows"] = WIDE_PLAIN_ROWS
    k13 = kernels[KERNELS.index("block_decode_1p")]
    k13.update({f"{what}_{stat}": f(runs[key]) for what, key in (
        ("soft", "block_decode_1p soft"), ("at_a", "block_decode_1p at (a)"),
        ("two_pass_at_a", "two-pass at (a)")) for stat, f in (
        ("ms", statistics.median), ("min_ms", min))})
    k13.update(soft_bound_ms=bound["block_decode_1p soft"][0],
               soft_bound_by=bound["block_decode_1p soft"][1])
    k13w = kernels[KERNELS.index("block_decode_1p wide")]
    k13w.update({f"{what}_{stat}": f(runs[key]) for what, key in (
        ("soft", "block_decode_1p wide soft"),
        ("two_pass", "two-pass at (o)"),
        ("two_pass_soft", "two-pass soft at (o)")) for stat, f in (
        ("ms", statistics.median), ("min_ms", min))})
    k13w.update(soft_plain_ms=plain_ms["block_decode_1p wide soft"],
                soft_bound_ms=bound["block_decode_1p wide soft"][0],
                soft_bound_by=bound["block_decode_1p wide soft"][1],
                round_steps=spw_summary["round_steps"])
    single_pass = {"m": dict(sp_summary), "n": harness_summary,
                   "o": dict(spw_summary)}
    for path in ("(o) hard", "(o) soft"):
        single_pass["o"][path] = {
            "ms": med[path], "min_ms": min(runs[path]),
            "plain_ms": plain_ms.get(path), "mbps": o_bits / (med[path] * 1e3)}
    for path, bits in (("single pass hard", bits_per_call),
                       ("single pass bits", bits_per_call),
                       ("single pass soft", bits_per_call)):
        single_pass["m"][path] = {
            "ms": med[path], "min_ms": min(runs[path]),
            "plain_ms": plain_ms.get(path),
            "mbps": bits / (med[path] * 1e3)}
    soft_stream = "stream_k1_decode soft"
    kernels[KERNELS.index("stream_k1_decode")].update(
        soft_ms=med[soft_stream], soft_min_ms=min(runs[soft_stream]),
        soft_plain_ms=plain_ms[soft_stream],
        ms_256_steps=med["stream_k1_decode 256"],
        soft_ms_256_steps=med["stream_k1_decode soft 256"],
        bound_ms_256_steps=bound["stream_k1_decode 256"][0],
        bound_by_256_steps=bound["stream_k1_decode 256"][1])
    f_soft = "acs_soft_k1_forward (f)"
    kernels[KERNELS.index("acs_soft_k1_forward")].update(
        f_ms=med[f_soft], f_min_ms=min(runs[f_soft]),
        f_plain_ms=plain_ms[f_soft], f_bound_ms=bound[f_soft][0],
        f_bound_by=bound[f_soft][1])
    k_masked = "traceback_k1_masked (k)"
    kernels[KERNELS.index("traceback_k1_masked")].update(
        k_ms=med[k_masked], k_min_ms=min(runs[k_masked]),
        k_plain_ms=plain_ms[k_masked], k_bound_ms=bound[k_masked][0],
        k_bound_by=bound[k_masked][1])
    tb_masked = "traceback_k1_masked tailbiting"
    kernels[KERNELS.index("traceback_k1_masked")].update(
        tailbiting_ms=med[tb_masked], tailbiting_min_ms=min(runs[tb_masked]),
        tailbiting_plain_ms=plain_ms[tb_masked],
        tailbiting_bound_ms=bound[tb_masked][0],
        tailbiting_bound_by=bound[tb_masked][1])
    tailbiting = dict(tb_summary)
    for path in ("tailbiting crc soft", "tailbiting rate-matched",
                 "tailbiting hard bytes", "tailbiting soft bytes"):
        bits = dci_bits if "bytes" not in path else bits_per_call
        tailbiting[path] = {
            "ms": med[path], "min_ms": min(runs[path]),
            "plain_ms": plain_ms.get(path),
            "mbps": bits / (med[path] * 1e3)}
    tailbiting["tailbiting crc soft"].update(
        wall_ms=med["tailbiting crc soft wall"],
        host_ms=med["tailbiting crc soft host"],
        blocks_per_s=DCI_B / (med["tailbiting crc soft"] * 1e-3))
    streams = {}
    for path in ("stream hard", "stream soft", "block stream hard",
                 "block stream soft"):
        streams[path] = {
            "ms": med[path], "min_ms": min(runs[path]),
            "wall_ms": med[f"{path} wall"], "host_ms": med[f"{path} host"],
            "plain_ms": plain_ms[path],
            "mbps": bits_per_call / (med[path] * 1e3),
            "wall_mbps": bits_per_call / (med[f"{path} wall"] * 1e3)}
    maxlogmap = dict(map_summary, ms=med["maxlogmap"],
                     min_ms=min(runs["maxlogmap"]),
                     plain_ms=plain_ms["maxlogmap"],
                     mbps=bits_per_call / (med["maxlogmap"] * 1e3))
    turbo = dict(turbo_summary)
    for path in ("turbo serving", "turbo fixed"):
        turbo[path] = {"ms": med[path], "min_ms": min(runs[path]),
                       "plain_ms": plain_ms[path],
                       "mbps": turbo_bits / (med[path] * 1e3)}
    turbo["turbo serving"].update(
        wall_ms=med["turbo serving wall"], host_ms=med["turbo serving host"],
        wall_mbps=turbo_bits / (med["turbo serving wall"] * 1e3))
    print(json.dumps({
        "kernels": kernels, "decode_ms": med["decode"],
        "decode_min_ms": min(runs["decode"]),
        "decode_plain_ms": plain_ms["decode"],
        "decode_mbps": bits_per_call / (med["decode"] * 1e3),
        "soft_decode_ms": med["soft_decode"],
        "soft_decode_min_ms": min(runs["soft_decode"]),
        "soft_decode_plain_ms": plain_ms["soft_decode"],
        "soft_decode_mbps": bits_per_call / (med["soft_decode"] * 1e3),
        "ragged_punctured": {
            path: {"ms": med[path], "min_ms": min(runs[path]),
                   "plain_ms": plain_ms[path]}
            for path in ("soft ragged decode", "hard ragged decode",
                         "punctured soft decode")},
        "streams": streams, "tailbiting": tailbiting,
        "maxlogmap": maxlogmap, "turbo": turbo, "generic": generic,
        "butterfly": butterfly, "single_pass": single_pass}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
