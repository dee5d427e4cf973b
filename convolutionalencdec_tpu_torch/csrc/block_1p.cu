// Single-pass block decode: the forward ACS and the traceback of a batch of
// terminated packets in one launch, the decisions kept in shared memory.
//
// Replaces the TPU kernel `_block_decode_1p` in
// convolutionalencdec_tpu/kernels/acs_pallas.py (its pallas_call at :2174,
// kernel body `_block_kernel_fused_1p` at :2092): forward chunks, then the
// walk back over them, with the packed decisions in a VMEM scratch that
// never goes to HBM.  It computes what that kernel computes, not how: no
// 3-stage relabelling, no MXU edge-metric matrix, no CHUNK_F or B_TILE
// padding, no phase axis in the grid; the decisions live in shared memory
// between the two phases of one block.
//
// Semantics (bit for bit those of acs_soft_k1.cu (hard and soft) / acs_wide.cu
// followed by traceback_k1.cu's terminated walk, i.e. of
// ops/viterbi.viterbi_decode and ops/metrics.viterbi_decode_soft):
//   ties keep the low source; state 0 starts at 0, every other state at
//   init_value; int32 metrics are never renormalised; soft LLRs are used as
//   max(q, -127) (the block routes' floor; no clip: the routes that reach
//   this kernel have qclip 127); a coded bit past the eighth is absent
//   from the uint8 coded-bit table and costs relu(-q) (acs_wide.cu's rule
//   for n > 8).  The walk starts in state 0 at step T - 1: the forward runs
//   exactly the T live steps, which is what the TPU kernel's group masks
//   (`_group_masks`, acs_pallas.py:1025-1034) do to its padded steps.
//   Steps t < message_bits emit the state's low bit.
//
// Layouts:
//   in    uint8 [B, T] segments (hard, n <= 8), or int8 [B, T, n] LLRs
//   cb    int32 [NS/2]   coded segment of edge (src b, input 0)
//   out   uint8 [B, message_bits] bits, or [B, ceil(message_bits / 8)]
//         bytes, MSb-first, the trailing byte zero-padded
//   shared memory per channel: T * NS/8 bytes of decision words, then 64
//   words of the walk's scratch (NS 64-256: first the forward's staged
//   inputs) and its decoded bits, ceil(T / 32) words (`channel_bytes`).
//   Rows, the layout of acs_soft_k1.cu: W = NS/32 words per step, the decision
//   of state s = 2b + p at step t bit i % 32 of word t W + i / 32,
//   i = p*NS/2 + b.  NS 64-256 keeps its steps below T - T % 32 as
//   columns instead, NS words per block of 32 steps: the decision of
//   state 2b + p at step t is bit t % 32 of word
//   (t / 32) NS + 64 (b / 32) + 32 h + b % 32, h = p XOR (b % 32 >= 16);
//   the last T % 32 steps are rows, at the same words as above.
//
// What bounds it on this card: NS/2 butterflies per step (6 int32
// operations each) in a recurrence that is sequential in T, and then a
// dependent walk of T steps.  Device memory sees only the inputs and the
// decoded output: the two-pass route writes and reads back T * NS/8 bytes
// of decisions per channel (33.7 MB at NASA_K7, B = 2048, T = 2054), this
// kernel none.  What it pays instead is shared memory: a channel holds
// T * NS/8 bytes (16.4 KB at NS = 64, T = 2054), so an SM holds 12
// channels (a block also takes 1 KB of the SM's 228 KB) where the two-pass
// forward holds 16 or more: at B = 2048 the batch runs in two waves, the
// second too short of warps to hide the step's dependent chain.  At
// NS = 512 and T = 480 (30 KB of decisions and 4 KB of metrics) an SM
// holds 6 channels, and 2048 channels run in 2.6 waves.
//
// What the design does about that:
//   NS 64-256 (`block_1p_warp`): one warp per channel, metrics in
//   registers.  The steps run in blocks of 32, fully unrolled (a plain
//   loop for the last, shorter block).  In a whole block a lane keeps its
//   own decisions, one bit a step, in a register per butterfly and
//   destination (a column), and after the block stores those words once:
//   a step takes no ballot and stores nothing.  The last block takes the
//   step's words by __ballot_sync instead, lane s keeping step s's, and
//   stores them as rows (one vector store a lane).  A block's inputs are
//   loaded a block ahead, one step a lane, and staged in the walk's
//   scratch, from which every lane reads the step's input by a broadcast
//   load: no shuffle carries an input (but the soft sum of the coded bits
//   past the eighth, for n > 8).
//   The butterfly permutation takes two shuffles per butterfly a lane, not
//   four: lanes 0-15 send the metric of their even destination, lanes
//   16-31 that of their odd one, in the first shuffle, and the other in the
//   second, so that no two lanes pull the same lane in one shuffle; which
//   of em and emc a lane adds to which source is fixed per lane (its edge
//   codes are complemented where needed), so no select precedes a shuffle,
//   and a lane picks its two sources from the two shuffles by its parity.
//   A soft step adds no relu(-q) sums: every state's metric moves by the
//   same sum(relu(-q)) a step, which changes no comparison, so em is the
//   sum of the step's LLRs over the edge's 1 bits (one or two __dp4a of the
//   packed LLR bytes against 0/1 byte masks) and emc the step's LLR sum
//   less em: the same decisions, metrics offset by a constant a step.
//   Four warps per block while a channel's decisions take at most 4 KB,
//   else one, so that blocks pack the SM's 227 KB as finely as its
//   decisions allow; each channel's region starts on 16 bytes.
//   NS 512-4096, hard and soft n <= 8 (`block_1p_wide`): one block per
//   channel on acs_wide.cu's rounds (acs_round.cuh): R trellis steps a
//   round in registers, G = NS >> R threads a channel, each owning one
//   closed group of butterflies, one __syncthreads a round (the metrics'
//   exchange, double-buffered), the decision words of step j of a round
//   packed as acs_round_kernel packs them and stored straight into the
//   channel's rows in shared memory (no staging copy: the region is the
//   stage).  Soft: the round's per-step edge-metric tables, built from its
//   LLRs conditioned as max(q, -127) two rounds ahead
//   (acs_soft_round_kernel's pipeline), in the walk's scratch until the
//   walk.  R by NS in `launch_wide`, as measured (PERF.md section 6).
//   The soft round's table threads run their loop over the LLRs unrolled
//   to 8 (their loads issue together: at NS 4096 the soft kernel also
//   drops from 144 to 120 registers, two channels an SM where it held
//   one), and the channel's inputs are prefetched into L2 as the kernel
//   starts; together 0.3108 -> 0.2246 ms at NS 4096, 0.4004 -> 0.3796 at
//   NS 512.  The last, part-full wave: nothing is done about it.  At NS
//   512 and T = 480 a channel takes 35 KB of shared memory, 6 an SM, so
//   2048 channels run in 2.6 waves, the third 59% full; the barrier-a-
//   step template it replaced had the same occupancy by shared memory.
//   Soft n > 8 stays on the barrier-a-step template
//   (`block_1p_wide_steps`: acs_wide.cu's acs_soft_wide_kernel, NS/2
//   butterflies over min(NS/2, 1024) threads, metrics double-buffered in
//   shared memory, each step's sums staged 64 steps at a time).
//   Both: after the last step one warp walks the words back from state 0,
//   exactly, its 32 lanes on 32 segments of the packet at once (`walk`: a
//   guessed start per segment, walked again where it differs from the
//   state the segment above ends in); the walk is a chain of dependent
//   shared-memory loads, T of them for one thread, about T/32 + 64 for a
//   lane.  The channel's threads then write the row out, coalesced.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "acs_round.cuh"

namespace {

constexpr int kMaxSmem = 232448;       // 227 KB: a block's most
constexpr int kSmallChannel = 4096;    // bytes; up to this, 4 warps a block
constexpr int kWideThreads = 1024;
constexpr int kChunk = 64;             // wide: steps staged at a time

// The walk, by the 32 lanes of one warp, exactly.  Lane l owns the steps
// [l G, (l + 1) G) (G = ceil(T / 32) rounded up to a multiple of 8) and
// guesses the state at its top step: it walks from state 0 at step
// kWarmup steps above (or from step T - 1, where the guess is exact) down
// to its segment, then walks its segment from the guess, writing the bits
// of its steps < message_bits, LSB first, to bits[t / 8] (its own bytes).
// Paths from different states merge within a few constraint lengths, so
// the guesses are right as a rule; lane 0 then checks them from the top
// segment down (a guess must equal the state the walk of the segment
// above reached, the top segment's start is exact) and walks again, from
// the right state, each segment whose guess was wrong.  `xy` is 64 words
// of scratch: the guesses, then the states each segment's walk reached.
// With COLS, steps t < tcol are stored as columns, the rest as rows (see
// the header); without, every step is a row (the wide template).
constexpr int kWarmup = 64;

template <bool COLS>
__device__ __forceinline__ unsigned walk_step(const uint32_t* dec, int W,
                                              int top, int t, unsigned cur,
                                              int tcol) {
  unsigned d;
  // State cur = 2b + p: lane b % 32's column h, bit t % 32.
  if (COLS && t < tcol) {
    const unsigned b = cur >> 1;
    const unsigned h = (cur & 1u) ^ ((b >> 4) & 1u);
    d = dec[(size_t)(t >> 5) * (32 * W) + ((b >> 5) << 6) + (h << 5) +
            (b & 31u)] >> (t & 31);
  } else {
    const unsigned i = (cur >> 1) | ((cur & 1u) << top);
    d = dec[(size_t)t * W + (i >> 5)] >> (i & 31u);
  }
  return (cur >> 1) | ((d & 1u) << top);
}

// Walk steps hi - 1 down to lo from state `cur` at step hi - 1, writing the
// bits of the steps < message_bits; returns the state at step lo - 1.
template <bool COLS>
__device__ unsigned walk_segment(const uint32_t* dec, uint8_t* bits, int W,
                                 int top, int lo, int hi, int message_bits,
                                 unsigned cur, int tcol) {
  unsigned acc = 0u;
  for (int t = hi - 1; t >= lo; --t) {
    if (t < message_bits) acc |= (cur & 1u) << (t & 7);
    cur = walk_step<COLS>(dec, W, top, t, cur, tcol);
    if ((t & 7) == 0) {
      bits[t >> 3] = (uint8_t)acc;
      acc = 0u;
    }
  }
  return cur;
}

template <bool COLS>
__device__ void walk(const uint32_t* dec, uint8_t* bits, uint32_t* xy, int T,
                     int W, int S, int message_bits, int lane, int tcol) {
  const int top = S - 1;
  const int G = (((T + 31) >> 5) + 7) & ~7;
  const int lo = min(lane * G, T);
  const int hi = min(lo + G, T);
  unsigned x = 0u;
  // Kept a loop: as nvcc 12.9 unrolls it for sm_90a, the card stops the
  // kernel with an illegal-instruction error whenever it runs.
#pragma unroll 1
  for (int t = min(hi - 1 + kWarmup, T - 1); t >= hi; --t) {
    x = walk_step<COLS>(dec, W, top, t, x, tcol);
  }
  xy[lane] = x;
  xy[32 + lane] =
      walk_segment<COLS>(dec, bits, W, top, lo, hi, message_bits, x, tcol);
  __syncwarp();
  if (lane == 0) {
    for (int l = 30; l >= 0; --l) {
      const int l_lo = min(l * G, T), l_hi = min(l_lo + G, T);
      const unsigned start = xy[32 + l + 1];
      if (l_hi < T && xy[l] != start) {
        xy[32 + l] = walk_segment<COLS>(dec, bits, W, top, l_lo, l_hi,
                                        message_bits, start, tcol);
      }
    }
  }
  __syncwarp();
}

// The channel's output row from the walk's bits, by `threads` threads.
__device__ void emit(const uint8_t* bits, uint8_t* row, int message_bits,
                     int emit_bytes, int tid, int threads) {
  if (emit_bytes) {
    for (int i = tid; i < (message_bits + 7) >> 3; i += threads) {
      row[i] = (uint8_t)(__brev((unsigned)bits[i]) >> 24);  // MSb first
    }
  } else {
    for (int e = tid; e < message_bits; e += threads) {
      row[e] = (uint8_t)((bits[e >> 3] >> (e & 7)) & 1u);
    }
  }
}

// Bytes of shared memory one channel's decisions, walk bits and walk
// scratch take.
__host__ __device__ inline size_t channel_bytes(int T, int NS) {
  return (size_t)T * (NS / 8) + 4 * (size_t)((T + 31) / 32) + 4 * 64;
}

// The distance between two channels' regions in a block: channel_bytes
// rounded up to 16 bytes, so that every region takes vector stores.  It
// never exceeds the 227 KB that channel_bytes fits in, itself a multiple
// of 16.
__host__ __device__ inline size_t channel_stride(int T, int NS) {
  return (channel_bytes(T, NS) + 15) & ~(size_t)15;
}

template <int BPL, int NQ, bool SOFT, bool REST>  // NS = 64 BPL; soft:
__global__ void __launch_bounds__(128)            // NQ = min(n, 8), REST n > 8
block_1p_warp(const uint8_t* __restrict__ in, const int32_t* __restrict__ cb,
              uint8_t* __restrict__ out, int B, int T, int n, int S,
              int message_bits, int emit_bytes, int init_value) {
  constexpr int NS = 64 * BPL;
  constexpr int W = NS / 32;
  extern __shared__ __align__(16) uint32_t smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int ch = blockIdx.x * (blockDim.x >> 5) + warp;
  if (ch >= B) return;  // uniform across the warp; no block barrier below
  uint32_t* dec = smem + warp * channel_stride(T, NS) / 4;
  uint32_t* xy = dec + (size_t)T * W;
  uint8_t* bits = reinterpret_cast<uint8_t*>(xy + 64);
  // The forward stages a block's inputs in the walk's scratch: soft, the
  // packed LLRs of step t0 + l at uint2 l (32 x 8 bytes); hard, the
  // segment of step t0 + l at byte l of the first 16-byte line of it.
  uint2* stage_soft = reinterpret_cast<uint2*>(xy);
  uint8_t* stage_hard = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(xy) + 15) & ~(uintptr_t)15);

  // Lane l owns butterflies b = 32 j + l (j < BPL): sources b and b + NS/2
  // (metrics lo, hi), destinations 2b and 2b + 1.  The first shuffle
  // carries the metric of the even destination from lanes 0-15 and of the
  // odd one from lanes 16-31, the second the other; so f1, the branch
  // metric added to lo in the destination sent first, is em on lanes 0-15
  // and emc on lanes 16-31 (whose edge codes are complemented), f2 the
  // other.
  const bool upper = lane & 16;
  const bool odd = lane & 1;
  const int nmask = (1 << min(n, 8)) - 1;
  unsigned code[BPL];           // hard: coded segment of f1's edge
  unsigned mlo[BPL], mhi[BPL];  // soft: f1's coded bits 0-3, 4-7, 0/1 bytes
  int lo[BPL], hi[BPL];
#pragma unroll
  for (int j = 0; j < BPL; ++j) {
    const int b = 32 * j + lane;
    const unsigned c = upper ? ~(unsigned)cb[b] : (unsigned)cb[b];
    code[j] = c;
    mlo[j] = mhi[j] = 0u;
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      if (i < 4) {
        mlo[j] |= ((c >> i) & 1u) << (8 * i);
      } else {
        mhi[j] |= ((c >> i) & 1u) << (8 * (i - 4));
      }
    }
    lo[j] = (b == 0) ? 0 : init_value;
    hi[j] = init_value;
  }
  const int rest_sel = upper ? -1 : 0;  // REST: emc holds the bits past 8
  // The first shuffle's metrics come to lane r from lane r / 2 (even r)
  // or 16 + r / 2 (odd r), the second's from the other: from pair i, x1
  // is the metric of state 64 i + r + 32 odd, x2 that of the other one.
  const int src1 = (odd ? 16 : 0) + (lane >> 1);
  const int src2 = src1 ^ 16;

  // Raw inputs of step t0 + lane, loaded a block ahead and first used by
  // the next block (a lane past T keeps what it had: its stage entry is
  // never read).  No value is chosen for t >= T: a select would wait for
  // the load where it is issued.
  const uint8_t* row = in + (size_t)ch * T * (SOFT ? n : 1);
  unsigned raw[SOFT ? NQ : 1] = {};  // bytes as loaded
  auto fetch = [&](int t) {
    if (t < T) {
#pragma unroll
      for (int i = 0; i < (SOFT ? NQ : 1); ++i) {
        raw[i] = row[(size_t)t * (SOFT ? n : 1) + i];
      }
    }
  };
  fetch(lane);

  unsigned col[2 * BPL];  // whole blocks: bit s, the lane's decisions at s
  unsigned buf[2 * BPL];  // the last block: lane s, step s's ballots
  // One step: x the segment (hard) or LLRs 0-3 and y LLRs 4-7 (soft), r the
  // sum of the LLRs past the eighth (REST); `whole`: a step of a block of 32.
  auto step = [&](int s, unsigned x, unsigned y, int r, auto whole) {
    int f1[BPL], f2[BPL];
    if constexpr (SOFT) {
      const int ones = 0x01010101;
      const int sum = NQ > 4 ? __dp4a((int)x, ones, __dp4a((int)y, ones, r))
                             : __dp4a((int)x, ones, r);
#pragma unroll
      for (int j = 0; j < BPL; ++j) {
        const int rs = REST ? (r & rest_sel) : 0;
        f1[j] = NQ > 4 ? __dp4a((int)x, (int)mlo[j],
                                __dp4a((int)y, (int)mhi[j], rs))
                       : __dp4a((int)x, (int)mlo[j], rs);
        f2[j] = sum - f1[j];
      }
    } else {
#pragma unroll
      for (int j = 0; j < BPL; ++j) {
        f1[j] = __popc((x ^ code[j]) & nmask);
        f2[j] = n - f1[j];
      }
    }
    int v1[BPL], v2[BPL];
#pragma unroll
    for (int j = 0; j < BPL; ++j) {
      const int u1 = lo[j] + f1[j], w1 = hi[j] + f2[j];
      const int u2 = lo[j] + f2[j], w2 = hi[j] + f1[j];
      const bool g1 = u1 > w1, g2 = u2 > w2;  // ties keep the low source
      if constexpr (decltype(whole)::value) {
        if (g1) col[j] |= 1u << s;
        if (g2) col[BPL + j] |= 1u << s;
      } else {
        const unsigned d1 = __ballot_sync(kFullMask, g1);
        const unsigned d2 = __ballot_sync(kFullMask, g2);
        if (lane == s) {
          buf[j] = d1;
          buf[BPL + j] = d2;
        }
      }
      v1[j] = min(u1, w1);
      v2[j] = min(u2, w2);
    }
    int next[2 * BPL];  // next-step metric of state 32 m + lane
#pragma unroll
    for (int i = 0; i < BPL; ++i) {
      const int x1 = __shfl_sync(kFullMask, v1[i], src1);
      const int x2 = __shfl_sync(kFullMask, v2[i], src2);
      next[2 * i] = odd ? x2 : x1;
      next[2 * i + 1] = odd ? x1 : x2;
    }
#pragma unroll
    for (int j = 0; j < BPL; ++j) {
      lo[j] = next[j];
      hi[j] = next[BPL + j];
    }
  };

  for (int t0 = 0; t0 < T; t0 += 32) {
    const int steps = min(32, T - t0);
    unsigned x = 0u, y = 0u;
    int r_mine = 0;
    if constexpr (SOFT) {
#pragma unroll
      for (int i = 0; i < NQ; ++i) {
        const unsigned q = (unsigned)max((int)(int8_t)raw[i], -127) & 0xffu;
        if (i < 4) {
          x |= q << (8 * i);
        } else {
          y |= q << (8 * (i - 4));
        }
      }
      if constexpr (REST) {
        if (lane < steps) {
          const int8_t* src = reinterpret_cast<const int8_t*>(row) +
                              (size_t)(t0 + lane) * n;
          for (int i = 8; i < n; ++i) r_mine += max((int)src[i], -127);
        }
      }
    } else {
      x = raw[0];
    }
    __syncwarp();  // the last block's reads of the stage are done
    if constexpr (SOFT) {
      stage_soft[lane] = make_uint2(x, y);
    } else {
      stage_hard[lane] = (uint8_t)x;
    }
    __syncwarp();
    fetch(t0 + 32 + lane);
    if (steps == 32) {
#pragma unroll
      for (int w = 0; w < 2 * BPL; ++w) col[w] = 0u;
      uint4 line = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int s = 0; s < 32; ++s) {
        unsigned a = 0u, b = 0u;
        if constexpr (SOFT) {
          const uint2 v = stage_soft[s];
          a = v.x;
          b = v.y;
        } else {
          if ((s & 15) == 0) {
            line = reinterpret_cast<const uint4*>(stage_hard)[s >> 4];
          }
          const unsigned word = (s & 12) == 0 ? line.x : (s & 12) == 4 ? line.y
                                : (s & 12) == 8 ? line.z : line.w;
          a = word >> (8 * (s & 3));
        }
        step(s, a, b, REST ? __shfl_sync(kFullMask, r_mine, s) : 0,
             std::true_type{});
      }
      // The block's columns: word 64 j + 32 h + lane, h = 1 for the
      // second shuffle's destination.
#pragma unroll
      for (int j = 0; j < BPL; ++j) {
        dec[(size_t)t0 * W + 64 * j + lane] = col[j];
        dec[(size_t)t0 * W + 64 * j + 32 + lane] = col[BPL + j];
      }
    } else {
#pragma unroll
      for (int w = 0; w < 2 * BPL; ++w) buf[w] = 0u;
#pragma unroll 1
      for (int s = 0; s < steps; ++s) {
        unsigned a = 0u, b = 0u;
        if constexpr (SOFT) {
          const uint2 v = stage_soft[s];
          a = v.x;
          b = v.y;
        } else {
          a = stage_hard[s];
        }
        step(s, a, b, REST ? __shfl_sync(kFullMask, r_mine, s) : 0,
             std::false_type{});
      }
      // Lane s's ballots into step t0 + s's row: the even states (i = b)
      // from d1 on lanes 0-15 and d2 on lanes 16-31, the odd ones the
      // other way round.
      if (lane < steps) {
        uint32_t wd[W];
#pragma unroll
        for (int j = 0; j < BPL; ++j) {
          wd[j] = __byte_perm(buf[j], buf[BPL + j], 0x7610);
          wd[BPL + j] = __byte_perm(buf[BPL + j], buf[j], 0x7610);
        }
        uint32_t* dst = dec + (size_t)(t0 + lane) * W;
        if constexpr (W == 2) {
          *reinterpret_cast<uint2*>(dst) = make_uint2(wd[0], wd[1]);
        } else {
#pragma unroll
          for (int k = 0; k < W / 4; ++k) {
            reinterpret_cast<uint4*>(dst)[k] = make_uint4(
                wd[4 * k], wd[4 * k + 1], wd[4 * k + 2], wd[4 * k + 3]);
          }
        }
      }
    }
  }
  __syncwarp();
  walk<true>(dec, bits, xy, T, W, S, message_bits, lane, T & ~31);
  const int row_len = emit_bytes ? (message_bits + 7) / 8 : message_bits;
  emit(bits, out + (size_t)ch * row_len, message_bits, emit_bytes, lane, 32);
}

// NS 512-4096, hard and soft n <= 8: the wide forward's rounds
// (acs_round.cuh, acs_wide.cu's header), R steps a round in registers, one
// barrier a round, each round's decision words stored by `Round::step`
// straight into the channel's rows (the region is the stage), then the
// walk.  Shared memory: the two metric buffers, the rows, then the walk's
// scratch and bits, which hold the soft forward's round tables and LLRs
// until the walk (`wide_smem`).
template <int LOGNS, int R, bool SOFT, bool HI>  // HI: soft n > 4
__global__ void __launch_bounds__((1 << LOGNS) >> R, 1)
block_1p_wide(const uint8_t* __restrict__ in, const int32_t* __restrict__ cb,
              uint8_t* __restrict__ out, int T, int n, int S,
              int message_bits, int emit_bytes, int init_value) {
  using Rd = Round<LOGNS, R>;
  constexpr int NS = Rd::NS, G = Rd::G, M = Rd::M, W = Rd::W;
  static_assert(!SOFT || G >= 8 * R, "8R table threads, R * 8 LLR loaders");
  extern __shared__ int4 smem4[];
  int* const buf0 = reinterpret_cast<int*>(smem4);
  int* const buf1 = buf0 + NS;
  int32_t* const dec = buf1 + NS;
  uint32_t* const xy = reinterpret_cast<uint32_t*>(dec + (size_t)T * W);
  uint8_t* const bits = reinterpret_cast<uint8_t*>(xy + 64);
  int* const tab0 = reinterpret_cast<int*>(xy);
  int* const tab1 = tab0 + R * kTabStep;
  int* const sq0 = tab1 + R * kTabStep;
  int* const sq1 = sq0 + R * 8;
  const int c = threadIdx.x;
  const int lane = c & 31, warp = c >> 5;
  const int ch = blockIdx.x;

  uint32_t cbp[R][Rd::CBW];
  Rd::template load_cb<SOFT && !HI>(cbp, cb, c);
  int m[M];
#pragma unroll
  for (int i = 0; i < M; ++i) m[i] = (c + i * G == 0) ? 0 : init_value;
  const int rd_base = Rd::phys(c);
  int* wb = buf0;
  int t = 0;
  // The channel's inputs into L2 at the start, a 128-byte line a thread,
  // so that the rounds' loads do not wait on device memory.
  const int row_bytes = T * (SOFT ? n : 1);
  const char* const row0 =
      reinterpret_cast<const char*>(in) + (size_t)ch * row_bytes;
  for (int i = c * 128; i < row_bytes; i += G * 128) {
    asm volatile("prefetch.global.L2 [%0];\n" ::"l"(row0 + i));
  }
  if constexpr (SOFT) {
    // As acs_soft_round_kernel: the LLRs of round r + 2 loaded as round r
    // starts, stored conditioned (the -127 floor) as it ends, when the
    // table threads build round r + 1's tables from that round's.
    const int8_t* row = reinterpret_cast<const int8_t*>(row0);
    const int tn = T * n, rn = R * n;
    if (c < rn) {
      sq0[c] = c < tn ? condition(row[c], -127, 127) : 0;
      sq1[c] = rn + c < tn ? condition(row[rn + c], -127, 127) : 0;
    }
    __syncthreads();
    build_tables<R, HI, 8>(tab0, sq0, c, n);
    __syncthreads();
    const int* tab = tab0;
    int* sq = sq0;
    for (; t + R <= T; t += R) {
      const int ahead = (t + 2 * R) * n + c;
      const int8_t q_ahead = (c < rn && ahead < tn) ? row[ahead] : 0;
      Rd::template soft_round<false, HI>(m, cbp, tab, R, dec + (size_t)t * W,
                                         warp, lane);
      Rd::scatter(m, wb, c);
      int* const sq_next = (sq == sq0) ? sq1 : sq0;
      if (c < rn) sq[c] = condition(q_ahead, -127, 127);
      build_tables<R, HI, 8>(tab == tab0 ? tab1 : tab0, sq_next, c, n);
      __syncthreads();
      Rd::gather(m, wb, c, rd_base);
      wb = (wb == buf0) ? buf1 : buf0;
      tab = (tab == tab0) ? tab1 : tab0;
      sq = sq_next;
    }
    if (T > t) {
      Rd::template soft_round<true, HI>(m, cbp, tab, T - t,
                                        dec + (size_t)t * W, warp, lane);
    }
  } else {
    const uint8_t* row = reinterpret_cast<const uint8_t*>(row0);
    const int nmask = (1 << n) - 1;
    for (; t + R <= T; t += R) {
      Rd::template round<false>(m, cbp, row + t, R, n, nmask,
                                dec + (size_t)t * W, warp, lane);
      Rd::scatter(m, wb, c);
      __syncthreads();
      Rd::gather(m, wb, c, rd_base);
      wb = (wb == buf0) ? buf1 : buf0;
    }
    if (T > t) {
      Rd::template round<true>(m, cbp, row + t, T - t, n, nmask,
                               dec + (size_t)t * W, warp, lane);
    }
  }
  __syncthreads();  // every row written, every table read
  if (c < 32) {
    walk<false>(reinterpret_cast<const uint32_t*>(dec), bits, xy, T, W, S,
                message_bits, lane, 0);
  }
  __syncthreads();
  const int row_len = emit_bytes ? (message_bits + 7) / 8 : message_bits;
  emit(bits, out + (size_t)ch * row_len, message_bits, emit_bytes, c, G);
}

// NS 512-4096, soft n > 8 (`block_1p_wide_steps`): one block per channel,
// acs_wide.cu's barrier-a-step forward (NS/2 butterflies over min(NS/2,
// 1024) threads, metrics double-buffered in shared memory, one
// __syncthreads per step), each step's sums staged kChunk steps at a time,
// the decision words beside the metrics.
template <int BPT>
__global__ void __launch_bounds__(kWideThreads)
block_1p_wide_steps(const int8_t* __restrict__ in,
                    const int32_t* __restrict__ cb, uint8_t* __restrict__ out,
                    int T, int NS, int n, int S, int message_bits,
                    int emit_bytes, int init_value) {
  extern __shared__ int4 smem4[];  // 16-byte aligned
  int4* stage = smem4;             // kChunk steps: {base, Q, q0-3, q4-7}
  int* m_cur = reinterpret_cast<int*>(smem4 + kChunk);
  int* m_nxt = m_cur + NS;
  uint32_t* dec = reinterpret_cast<uint32_t*>(m_nxt + NS);
  uint32_t* xy = dec + (size_t)T * (NS / 32);
  uint8_t* bits = reinterpret_cast<uint8_t*>(xy + 64);
  const int H = NS / 2;
  const int W = NS / 32;
  const int tid = threadIdx.x;
  const int threads = blockDim.x;
  const int lane = tid & 31;
  const int ch = blockIdx.x;

  for (int s = tid; s < NS; s += threads) m_cur[s] = (s == 0) ? 0 : init_value;
  int cbl[BPT];
#pragma unroll
  for (int j = 0; j < BPT; ++j) cbl[j] = cb[j * threads + tid];

  const int8_t* row = in + (size_t)ch * T * n;
  for (int t = 0; t < T; ++t) {
    const int k = t % kChunk;
    if (k == 0) {
      // Every read of the previous chunk ended before the last step's
      // __syncthreads (or, at t = 0, nothing was staged).
      for (int c = tid; c < min(kChunk, T - t); c += threads) {
        int4 v = make_int4(0, 0, 0, 0);
        const int8_t* src = row + (size_t)(t + c) * n;
        unsigned pa = 0u, pb = 0u;
        for (int i = 0; i < n; ++i) {
          const int q = max((int)src[i], -127);
          v.x += max(-q, 0);
          v.y += abs(q);
          if (i < 4) {
            pa |= ((unsigned)q & 0xffu) << (8 * i);
          } else if (i < 8) {
            pb |= ((unsigned)q & 0xffu) << (8 * (i - 4));
          }
        }
        v.z = (int)pa;
        v.w = (int)pb;
        stage[c] = v;
      }
      __syncthreads();
    }
    const int4 v = stage[k];
    int q[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const unsigned w = (i < 4) ? (unsigned)v.z : (unsigned)v.w;
      q[i] = (int)(w << (24 - 8 * (i & 3))) >> 24;
    }
#pragma unroll
    for (int j = 0; j < BPT; ++j) {
      const int b = j * threads + tid;
      int em = v.x;
#pragma unroll
      for (int i = 0; i < 8; ++i) em += q[i] & -((cbl[j] >> i) & 1);
      const int emc = v.y - em;
      const int lo = m_cur[b], hi = m_cur[b + H];
      const int a0 = lo + em, a1 = hi + emc;
      const int b0 = lo + emc, b1 = hi + em;
      const unsigned da = __ballot_sync(kFullMask, a0 > a1);
      const unsigned db = __ballot_sync(kFullMask, b0 > b1);
      *reinterpret_cast<int2*>(m_nxt + 2 * b) =
          make_int2(min(a0, a1), min(b0, b1));
      // Butterflies j * threads + 32 w .. + 31 of warp w: even word
      // (j * threads + 32 w) / 32, odd word H/32 + that.
      if (lane < 2) {
        const int w_even = (j * threads + (tid & ~31)) >> 5;
        dec[(size_t)t * W + w_even + (lane ? (H >> 5) : 0)] = lane ? db : da;
      }
    }
    __syncthreads();
    int* swap = m_cur;
    m_cur = m_nxt;
    m_nxt = swap;
  }
  if (tid < 32) walk<false>(dec, bits, xy, T, W, S, message_bits, lane, 0);
  __syncthreads();
  const int row_len = emit_bytes ? (message_bits + 7) / 8 : message_bits;
  emit(bits, out + (size_t)ch * row_len, message_bits, emit_bytes, tid,
       threads);
}

struct Args {
  const uint8_t* in;
  const int32_t* cb;
  uint8_t* out;
  int B, T, NS, n, S, message_bits, emit_bytes, init_value;
};

template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  // Ask for the largest shared-memory carveout, so that as many blocks as
  // their decisions allow share an SM.
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared));
}

template <int BPL, int NQ, bool SOFT, bool REST>
int launch_warp(const Args& a, cudaStream_t s) {
  const size_t per_channel = channel_stride(a.T, a.NS);
  const int warps = per_channel <= kSmallChannel ? 4 : 1;
  const size_t smem = per_channel * warps;
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = block_1p_warp<BPL, NQ, SOFT, REST>;
  const int e = allow_smem(kernel, smem);
  if (e != 0) return e;
  const dim3 grid((a.B + warps - 1) / warps);
  kernel<<<grid, 32 * warps, smem, s>>>(a.in, a.cb, a.out, a.B, a.T, a.n,
                                        a.S, a.message_bits, a.emit_bytes,
                                        a.init_value);
  return static_cast<int>(cudaGetLastError());
}

// Bytes of shared memory of the wide template at T steps: the two metric
// buffers, the rows, then the larger of the walk's scratch and bits and
// (soft) the forward's two tables and two LLR buffers of a round.  Every T
// that kernels/single_pass.py admits (`smem_bytes`: channel_bytes + 1 KB
// + 2 x 4 x NS within 227 KB) fits: at R <= 4 the soft round's 1312 bytes
// fit the 1 KB beside the walk's 256 + 4 ceil(T / 32) bytes once T > 224,
// and below that T the whole is far under 227 KB.
template <int R>
size_t wide_smem(int T, int NS, bool soft) {
  const size_t walk = 4 * 64 + 4 * (size_t)((T + 31) / 32);
  const size_t tables = (2 * R * kTabStep + 2 * R * 8) * sizeof(int);
  return (size_t)2 * NS * sizeof(int) + (size_t)T * (NS / 8) +
         (soft && tables > walk ? tables : walk);
}

template <int LOGNS, int R>
int launch_round(const Args& a, bool soft, cudaStream_t s) {
  constexpr int NS = 1 << LOGNS;
  const size_t smem = wide_smem<R>(a.T, NS, soft);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = !soft ? block_1p_wide<LOGNS, R, false, false>
                      : a.n > 4 ? block_1p_wide<LOGNS, R, true, true>
                                : block_1p_wide<LOGNS, R, true, false>;
  const int e = allow_smem(kernel, smem);
  if (e != 0) return e;
  kernel<<<a.B, NS >> R, smem, s>>>(a.in, a.cb, a.out, a.T, a.n, a.S,
                                    a.message_bits, a.emit_bytes,
                                    a.init_value);
  return static_cast<int>(cudaGetLastError());
}

// The wide template at each NS, hard and soft n <= 8:
// launch_round<log2 NS, steps a round>, as measured (PERF.md section 6;
// scripts/torch_single_pass.py --lines, in turns): at B = 2048 and each
// NS's longest single-pass T (480, 240, 96, 48; rate-1/5 codes), hard /
// soft ms, NS 512: R 3 0.2212 / 0.4004, R 4 0.2605 / 0.4102, R 2 0.2542
// / 0.4336 (the barrier-a-step template 0.4724 / 0.6692); NS 1024: R 3
// 0.2127 / 0.3052, R 4 0.2188 / 0.3228, R 5 0.2143 / 0.3075; NS 2048:
// R 4 0.1636 / 0.2254, R 3 0.1727 / 0.2375, R 5 0.1830 / 0.2775; NS
// 4096: R 4 0.1787 / 0.3108, R 3 0.2076 / 0.3179, R 5 0.2007 / 0.2889
// (soft before the table loop was unrolled and the inputs prefetched,
// which took it to 0.3796, 0.2949, 0.2097 and 0.2246 at the lines
// below).  At NS 512 R 3 runs two warps a channel where R 4 runs one,
// twice the warps an SM at the same 6 channels (shared memory).
// tests/test_torch_single_pass.py, chip_smoke.py and
// scripts/torch_single_pass.py read this switch.
int launch_wide(const Args& a, bool soft, cudaStream_t s) {
  switch (a.NS) {
    case 512: return launch_round<9, 3>(a, soft, s);
    case 1024: return launch_round<10, 3>(a, soft, s);
    case 2048: return launch_round<11, 4>(a, soft, s);
    case 4096: return launch_round<12, 4>(a, soft, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Soft n > 8 at NS 512-4096: the barrier-a-step template, NS/2 butterflies
// over min(NS/2, 1024) threads.
int launch_wide_steps(const Args& a, cudaStream_t s) {
  if (a.NS != 512 && a.NS != 1024 && a.NS != 2048 && a.NS != 4096) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = min(a.NS / 2, kWideThreads);
  const size_t smem = (size_t)kChunk * sizeof(int4) +
                      (size_t)2 * a.NS * sizeof(int) +
                      channel_bytes(a.T, a.NS);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = a.NS == 4096 ? block_1p_wide_steps<2>
                                   : block_1p_wide_steps<1>;
  const int e = allow_smem(kernel, smem);
  if (e != 0) return e;
  kernel<<<a.B, threads, smem, s>>>(
      reinterpret_cast<const int8_t*>(a.in), a.cb, a.out, a.T, a.NS, a.n,
      a.S, a.message_bits, a.emit_bytes, a.init_value);
  return static_cast<int>(cudaGetLastError());
}

// The warp template at `a.NS` (64, 128, 256) at NQ; REST: soft with n > 8.
template <int NQ, bool SOFT, bool REST = false>
int launch_ns(const Args& a, cudaStream_t s) {
  switch (a.NS) {
    case 64: return launch_warp<1, NQ, SOFT, REST>(a, s);
    case 128: return launch_warp<2, NQ, SOFT, REST>(a, s);
    case 256: return launch_warp<4, NQ, SOFT, REST>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Hard: segments uint8 [B, T], 1 <= n <= 8.  Soft (soft != 0): int8 LLRs
// [B, T, n], any n >= 1.  Output bits [B, message_bits] or (emit_bytes)
// bytes [B, ceil(message_bits / 8)]; message_bits <= T - S.
extern "C" int block_decode_1p(const void* in, int soft, const void* cb,
                               void* out, int B, int T, int NS, int n, int S,
                               int message_bits, int emit_bytes,
                               int init_value, void* stream) {
  const Args a{static_cast<const uint8_t*>(in),
               static_cast<const int32_t*>(cb), static_cast<uint8_t*>(out),
               B, T, NS, n, S, message_bits, emit_bytes, init_value};
  if (B < 1 || T < 0 || n < 1 || (!soft && n > 8) || message_bits < 0 ||
      (message_bits > 0 && message_bits > T - S)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (NS >= 512) {
    return soft && n > 8 ? launch_wide_steps(a, s) : launch_wide(a, soft, s);
  }
  if (!soft) return launch_ns<1, false>(a, s);
  switch (min(n, 8)) {
    case 1: return launch_ns<1, true>(a, s);
    case 2: return launch_ns<2, true>(a, s);
    case 3: return launch_ns<3, true>(a, s);
    case 4: return launch_ns<4, true>(a, s);
    case 5: return launch_ns<5, true>(a, s);
    case 6: return launch_ns<6, true>(a, s);
    case 7: return launch_ns<7, true>(a, s);
    default:
      return n > 8 ? launch_ns<8, true, true>(a, s) : launch_ns<8, true>(a, s);
  }
}
