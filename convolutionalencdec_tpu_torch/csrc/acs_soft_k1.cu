// k=1 butterfly add-compare-select (ACS), forward pass, hard and soft, at
// NS = 64, 128 and 256: one template, two C entries.
//
// `acs_k1_forward` (hard segments) replaces the TPU kernel
// `acs_forward_batch_swar` in convolutionalencdec_tpu/kernels/acs_swar.py
// (its pallas_call at :847, kernel body `_fwd_kernel_swar` ->
// `_fwd_chunk_body_swar` -> `_acs_swar`), and at NS 64-256 the fused
// `acs_forward_batch_fused` (acs_pallas.py:1004, K11).
// `acs_soft_k1_forward` (int8 LLRs) replaces two TPU kernels in acs_swar.py:
// `acs_forward_batch_swar_soft8` (pallas_call at :1381, 4 channels per
// int32 lane in 8-bit fields, LLRs clipped to +-qmax, renormalised every 3
// steps) and `acs_forward_batch_swar_soft` (pallas_call at :1262, 2 channels
// per lane in 16-bit fields, any int8 LLR).  Both compute one function;
// int32 metrics in registers make both field widths, the renorm and the
// guard-bit compare unnecessary, and the caller's `qclip` (qmax on the
// 8-bit route, 127 elsewhere) carries the one difference that shows.  The
// caller's `qlo` is the lower clip: -qclip on the block routes (whose floor
// at -127 it implies), -128 on the JAX package's tail-biting 16-bit route,
// which uses every int8 LLR as it is (kernels/tailbiting.py:99-102).
// They compute what those kernels compute, not how: no channel packing into
// fields, no renormalisation, no padding of T or B.
//
// Semantics (bit for bit those of ops/viterbi.viterbi_forward_butterfly on
// segments and ops/metrics.viterbi_forward_butterfly_soft on conditioned
// LLRs):
//   soft: each LLR is used as q = clamp(q, qlo, qclip), qlo = -qclip or
//   -128; cost-if-1 of coded bit j is relu(q_j), cost-if-0 is relu(-q_j);
//   em[b] sums butterfly b's costs over its n coded bits, Q = sum_j |q_j|,
//   emc = Q - em (the complement edge);
//   hard: em = popc((seg ^ cb[b]) & (2^n - 1)), emc = n - em: the soft
//   costs of the LLRs q_j = 1 - 2 bit_j, whose relu(q_j) and relu(-q_j) are
//   0 and 1 where coded bit j agrees and 1 and 0 where it does not;
//   dst 2b   : a0 = m[b] + em,  a1 = m[b + NS/2] + emc
//   dst 2b+1 : b0 = m[b] + emc, b1 = m[b + NS/2] + em
//   the decision is 1 only when strictly a0 > a1 (ties keep the low source),
//   the new metric is the minimum.  Metrics are int32 and never
//   renormalised: exact while T * n + init_value (hard) or T * n * 128 +
//   init_value (soft) stays below 2^31 (the wrappers check it) and given
//   initial metrics are at least -2^31 + T * n (or T * n * 128): they are
//   the final metrics of a forward, or zeros.
//
// Layouts:
//   seg            uint8 [B, T]      hard: one n-bit segment a step
//   qllrs          int8  [B, T, n]   soft: n = 1..8
//   cb             int32 [NS/2]      coded segment of edge (src b, input 0)
//   init           int32 [B, NS]     optional (nullptr: 0 at state 0,
//                                    init_value elsewhere)
//   decs           int32 [B, T, W]   W = NS/32 decision words per step;
//                                    the decision of state s = 2b + p is
//                                    bit i % 32 of word i / 32,
//                                    i = p NS/2 + b
//   final_metrics  int32 [B, NS]     natural state order
//
// What bounds it on this card: each step of each channel is NS/2
// butterflies (4 adds, 2 compares, 2 minima each) that depend on the step
// before, and NS/8 bytes of decisions written; one segment byte (hard) or
// n LLR bytes (soft) come in per step.  With a warp a channel and enough
// channels in flight the forward is bound by the card's integer issue: an
// SM sub-partition runs a warp's 32-bit integer instruction (add,
// multiply-add, dp4a, compare, min, select) every second cycle, so a step
// costs about two cycles per such instruction per warp
// (scripts/torch_soft_forward.py: at the main-path size, 2048 channels,
// twice the channels take 1.8 times as long; one warp an SM, two thirds
// as long).  What counts is the integer instructions a step takes beyond
// the butterflies' six operations.
//
// What the design does about that (block_1p.cu's warp forward with the
// decisions going to device memory as rows; each piece measured in turns
// with the earlier build, PERF.md §6):
//   - One warp per channel, metrics in registers; lane l owns butterflies
//     32 j + l (j < NS/64).  The steps run in blocks of 32, fully unrolled
//     (a plain loop for the last, shorter block): a loop of one step each
//     took 27% longer.
//   - Staged inputs: a block's inputs are loaded a block ahead, step
//     t0 + l by lane l (hard: one unsigned byte, widened nowhere, so that
//     no instruction waits on the load before the next block; soft: n int8
//     LLRs); that lane converts them once (hard: bit i to the LLR 1 - 2 bit,
//     a byte 0x01 or 0xFF; soft: clamped), packs the n bytes into one or two
//     registers and stores them with the step's LLR sum in the warp's
//     32-entry stage in shared memory.  Every lane reads a step by one
//     broadcast load: no shuffle carries an input (shuffles from the
//     staging lane read within 2%).  A hard segment and soft LLRs then take
//     the same step.
//   - The metric without the relu(-q) sums: since relu(q) - relu(-q) = q,
//     em = sum(relu(-q)) + (the sum of the q_j over the edge's 1 bits) and
//     emc = sum(relu(-q)) + (the sum over its 0 bits).  The kernel drops
//     sum(relu(-q)) (hard: the segment's popcount), the same for every
//     state of a step, so every comparison is unchanged.  For n <= 4 each
//     of a butterfly's four candidates is one __dp4a of the packed bytes
//     against the lane's 0/1 byte masks of the edge's 1 or 0 bits, with
//     the source metric as its accumulator (em and emc first, then four
//     adds, took 6% longer); for n = 5..8, em is two __dp4a and emc the
//     step's LLR sum less em.  The metrics run offset by the running sum
//     of the dropped terms; each staging lane adds up its steps' sums and
//     the warp adds the total back before storing the final metrics, which
//     are an output (tail-biting starts, stream carry-over, initial_metrics
//     chains), so they are the plain forward's exactly.
//   - Two shuffles per butterfly: lanes 0-15 send the metric of their even
//     destination first, lanes 16-31 that of their odd one (whose edge
//     codes are complemented, so which of em and emc a lane adds to which
//     source is fixed per lane and no select precedes a shuffle); a lane
//     picks its two sources from the two shuffles by its parity.  Four
//     shuffles and two selects took 13% longer.
//   - Decisions by ballot: each destination's decisions of a step are one
//     __ballot_sync, which lane 0 stores to the warp's 32-step row buffer
//     in shared memory; after the block lane s reads step t0 + s's words,
//     puts the halves of the two ballots in place and stores the row as
//     one or two vectors.  Keeping the ballots in lane s (a select a
//     destination and step) took 8% longer, and columns (a bit a step in
//     each lane, a 32 x 32 transpose across the warp a block) 11%.
//   - 4 warps a block; 8 measured within 1% at the main-path size.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFullMask = 0xffffffffu;

// BPL: butterflies per lane = NS / 64.  kHard: segments uint8 [B, T], else
// int8 LLRs [B, T, n].  NP: 1 for n <= 4, else 2 (registers of packed bytes
// a step).
template <int BPL, bool kHard, int NP>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
acs_k1_forward_kernel(const uint8_t* __restrict__ in,
                      const int32_t* __restrict__ cb,
                      const int32_t* __restrict__ init,
                      int32_t* __restrict__ decs,
                      int32_t* __restrict__ final_metrics,
                      int B, int T, int n, int qlo, int qclip,
                      int init_value) {
  constexpr int NS = 64 * BPL;
  constexpr int HALF = NS / 2;
  constexpr int W = NS / 32;
  constexpr int NR = kHard ? 1 : 4 * NP;  // raw values a step
  // Each warp's stage of a block's inputs and row buffer of its ballots.
  __shared__ int4 stage_all[kWarpsPerBlock][32];
  __shared__ unsigned rows_all[kWarpsPerBlock][32][2 * BPL];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int ch = blockIdx.x * kWarpsPerBlock + warp;
  if (ch >= B) return;  // uniform across the warp; no block barrier below
  int4* const stage = stage_all[warp];
  unsigned (*const rowbuf)[2 * BPL] = rows_all[warp];

  // f1, the branch metric added to lo in the destination sent first, is
  // em on lanes 0-15 and emc on lanes 16-31 (whose edge codes are
  // complemented), f2 the other: the sums of the LLRs over f1's edge's 1
  // bits and over its 0 bits.
  const bool upper = lane & 16;
  const bool odd = lane & 1;
  unsigned m1[BPL], m2[BPL];  // f1's and f2's bits 0-3, as 0/1 bytes
  unsigned h1[BPL];           // f1's bits 4-7 (n > 4)
  int lo[BPL], hi[BPL];  // metrics of source states 32 j + lane, + NS/2
#pragma unroll
  for (int j = 0; j < BPL; ++j) {
    const int b = 32 * j + lane;
    const unsigned c = upper ? ~(unsigned)cb[b] : (unsigned)cb[b];
    m1[j] = m2[j] = h1[j] = 0u;
#pragma unroll
    for (int i = 0; i < 4 * NP; ++i) {
      if (i < n) {
        const unsigned one = (c >> i) & 1u;
        if (i < 4) {
          m1[j] |= one << (8 * i);
          m2[j] |= (one ^ 1u) << (8 * i);
        } else {
          h1[j] |= one << (8 * (i - 4));
        }
      }
    }
    if (init != nullptr) {
      lo[j] = init[(size_t)ch * NS + b];
      hi[j] = init[(size_t)ch * NS + HALF + b];
    } else {
      lo[j] = (b == 0) ? 0 : init_value;
      hi[j] = init_value;
    }
  }
  // The first shuffle's metrics come to lane r from lane r / 2 (even r)
  // or 16 + r / 2 (odd r), the second's from the other: from pair i, x1
  // is the metric of state 64 i + r + 32 odd, x2 that of the other one.
  const int src1 = (odd ? 16 : 0) + (lane >> 1);
  const int src2 = src1 ^ 16;

  // Raw inputs of step t0 + lane, loaded a block ahead and first used by
  // the next block (a lane past T keeps what it had: its stage entry is
  // never read).  No value is chosen for t >= T: a select would wait for
  // the load where it is issued.
  const uint8_t* const seg_row = in + (size_t)ch * T;
  const int8_t* const q_row =
      reinterpret_cast<const int8_t*>(in) + (size_t)ch * T * n;
  int raw[NR] = {};
  auto fetch = [&](int t) {
    if (t < T) {
      if constexpr (kHard) {
        raw[0] = seg_row[t];
      } else {
#pragma unroll
        for (int i = 0; i < NR; ++i) {
          if (i < n) raw[i] = q_row[(size_t)t * n + i];
        }
      }
    }
  };
  fetch(lane);

  unsigned d1s[BPL], d2s[BPL];  // lane s: step t0 + s's ballots
  int drop = 0;  // the lane's staged steps' sum(relu(-q)), dropped
  // One step s of a block, `in` its staged input {LLRs 0-3, 4-7, sum}.
  auto step = [&](int s, int4 in) {
    int v1[BPL], v2[BPL];
#pragma unroll
    for (int j = 0; j < BPL; ++j) {
      int u1, w1, u2, w2;  // a source's metric plus f1 or f2
      if constexpr (NP == 1) {
        u1 = __dp4a(in.x, (int)m1[j], lo[j]);
        w1 = __dp4a(in.x, (int)m2[j], hi[j]);
        u2 = __dp4a(in.x, (int)m2[j], lo[j]);
        w2 = __dp4a(in.x, (int)m1[j], hi[j]);
      } else {
        const int f1 = __dp4a(in.x, (int)m1[j], __dp4a(in.y, (int)h1[j], 0));
        const int f2 = in.z - f1;
        u1 = lo[j] + f1, w1 = hi[j] + f2;
        u2 = lo[j] + f2, w2 = hi[j] + f1;
      }
      const unsigned d1 = __ballot_sync(kFullMask, u1 > w1);  // ties keep
      const unsigned d2 = __ballot_sync(kFullMask, u2 > w2);  // the low one
      if (lane == 0) {  // the row buffer: step s's ballots
        rowbuf[s][j] = d1;
        rowbuf[s][BPL + j] = d2;
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

  int32_t* dec_row = decs + (size_t)ch * T * W;
  for (int t0 = 0; t0 < T; t0 += 32) {
    const int steps = min(32, T - t0);
    // Step t0 + lane's LLRs, packed, their sum and their relu(-q) sum.
    unsigned x = 0u, y = 0u;
    int sum = 0, neg = 0;
    if constexpr (kHard) {
      // Coded bit i as the LLR 1 - 2 bit, the byte 0x01 or 0xFF.
      const unsigned r = (unsigned)raw[0] & ((1u << n) - 1u);
#pragma unroll
      for (int i = 0; i < 4 * NP; ++i) {
        const unsigned q = 1u + 0xFEu * ((r >> i) & 1u);
        if (i < n) {
          if (i < 4) {
            x |= q << (8 * i);
          } else {
            y |= q << (8 * (i - 4));
          }
        }
      }
      neg = __popc(r);
      sum = n - 2 * neg;
    } else {
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        if (i < n) {
          const int q = min(max(raw[i], qlo), qclip);
          sum += q;
          neg += max(-q, 0);
          if (i < 4) {
            x |= ((unsigned)q & 0xffu) << (8 * i);
          } else {
            y |= ((unsigned)q & 0xffu) << (8 * (i - 4));
          }
        }
      }
    }
    if (lane < steps) drop += neg;
    __syncwarp();  // the last block's reads of the stage are done
    stage[lane] = make_int4((int)x, (int)y, sum, 0);
    __syncwarp();
    fetch(t0 + 32 + lane);
    if (steps == 32) {
#pragma unroll
      for (int s = 0; s < 32; ++s) step(s, stage[s]);
    } else {
#pragma unroll 1
      for (int s = 0; s < steps; ++s) step(s, stage[s]);
    }
    __syncwarp();  // lane 0's stores of the block's ballots are done
#pragma unroll
    for (int j = 0; j < BPL; ++j) {
      d1s[j] = rowbuf[lane][j];
      d2s[j] = rowbuf[lane][BPL + j];
    }
    // Lane s's ballots into step t0 + s's row: word j holds the even
    // destinations (d1 on lanes 0-15, d2 on lanes 16-31), word BPL + j
    // the odd ones.
    uint32_t wd[W];
#pragma unroll
    for (int j = 0; j < BPL; ++j) {
      wd[j] = __byte_perm(d1s[j], d2s[j], 0x7610);
      wd[BPL + j] = __byte_perm(d2s[j], d1s[j], 0x7610);
    }
    if (lane < steps) {
      int32_t* dst = dec_row + (size_t)(t0 + lane) * W;
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

  // The final metrics with the dropped sums added back.
  const int dropped = __reduce_add_sync(kFullMask, drop);
#pragma unroll
  for (int j = 0; j < BPL; ++j) {
    final_metrics[(size_t)ch * NS + 32 * j + lane] = lo[j] + dropped;
    final_metrics[(size_t)ch * NS + HALF + 32 * j + lane] = hi[j] + dropped;
  }
}

struct Args {
  const uint8_t* in;
  const int32_t* cb;
  const int32_t* init;
  int32_t* decs;
  int32_t* final_metrics;
  int B, T, n, qlo, qclip, init_value;
};

template <int BPL, bool kHard, int NP>
void launch(const Args& a, cudaStream_t s) {
  const dim3 block(32 * kWarpsPerBlock);
  const dim3 grid((a.B + kWarpsPerBlock - 1) / kWarpsPerBlock);
  acs_k1_forward_kernel<BPL, kHard, NP><<<grid, block, 0, s>>>(
      a.in, a.cb, a.init, a.decs, a.final_metrics, a.B, a.T, a.n, a.qlo,
      a.qclip, a.init_value);
}

template <int BPL, bool kHard>
bool launch_n(const Args& a, cudaStream_t s) {
  if (a.n < 1 || a.n > 8) return false;
  if (a.n <= 4) {
    launch<BPL, kHard, 1>(a, s);
  } else {
    launch<BPL, kHard, 2>(a, s);
  }
  return true;
}

// One line an NS: launch_n<butterflies a lane, hard>, each launching one
// template for n <= 4 and one for n = 5..8.  tests/test_torch_soft_forward.py,
// chip_smoke.py and scripts/torch_soft_forward.py read this switch.
template <bool kHard>
int launch_forward(int NS, const Args& a, cudaStream_t s) {
  bool ok = false;
  switch (NS) {
    case 64: ok = launch_n<1, kHard>(a, s); break;
    case 128: ok = launch_n<2, kHard>(a, s); break;
    case 256: ok = launch_n<4, kHard>(a, s); break;
    default: break;
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int acs_k1_forward(const void* seg, const void* cb,
                              const void* init, void* decs,
                              void* final_metrics, int B, int T, int NS,
                              int n, int init_value, void* stream) {
  const Args a{static_cast<const uint8_t*>(seg),
               static_cast<const int32_t*>(cb),
               static_cast<const int32_t*>(init),
               static_cast<int32_t*>(decs),
               static_cast<int32_t*>(final_metrics),
               B, T, n, 0, 0, init_value};
  return launch_forward<true>(NS, a, static_cast<cudaStream_t>(stream));
}

extern "C" int acs_soft_k1_forward(const void* qllrs, const void* cb,
                                   const void* init, void* decs,
                                   void* final_metrics, int B, int T, int NS,
                                   int n, int qlo, int qclip,
                                   int init_value, void* stream) {
  const Args a{static_cast<const uint8_t*>(qllrs),
               static_cast<const int32_t*>(cb),
               static_cast<const int32_t*>(init),
               static_cast<int32_t*>(decs),
               static_cast<int32_t*>(final_metrics),
               B, T, n, qlo, qclip, init_value};
  return launch_forward<false>(NS, a, static_cast<cudaStream_t>(stream));
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
