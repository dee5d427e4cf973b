// Sliding-window register-exchange decode of k=1 butterfly codes, with the
// decoder state carried in and out of every call.
//
// Replaces two TPU kernels in convolutionalencdec_tpu/kernels/acs_pallas.py,
// both `_stream_kernel_fused` (:1182): `stream_decode_batch` (pallas_call at
// :1457, hard segments) and `stream_decode_batch_soft` (pallas_call at
// :1524, int8 LLRs).  It computes what they compute, not how: no MXU edge
// metrics, no 3-stage relabelling, no register planes at all, no padding of
// B to 256 or of T to 48.
//
// Semantics (bit for bit those of ops/viterbi.stream_scan on k=1 codes):
//   the ACS of acs_soft_k1.cu, hard or soft (soft: each LLR floored
//   at -127 and not clipped): butterfly b has sources b and b + NS/2 and
//   destinations 2b and 2b+1, the high source wins only when strictly
//   a0 > a1 (b0 > b1);
//   register exchange: a destination's register is its chosen source's
//   register shifted left by one with the destination's input bit
//   (state & 1) shifted in, so bit j is the symbol j steps old;
//   emit: after every step, bit W - 1 of the register of the lowest-numbered
//   state with the minimum new metric, one byte per step;
//   state out: the metrics minus each channel's minimum, the registers
//   masked to their W bits.  Within a call metrics are int32 and not
//   renormalised (the wrapper checks that they cannot overflow).
//
// Layouts:
//   seg    uint8 [B, T]          hard segments, or
//   qllrs  int8  [B, T, n]       soft LLRs
//   cb     int32 [NS/2]          coded segment of edge (src b, input 0)
//   m_in, m_out  int32 [B, NS]   natural state order (may alias)
//   r_in, r_out  uint64 [B, NS]  survivor registers (may alias)
//   sym    uint8 [B, T]          emitted symbol of every step
//
// What bounds it on this card: every step of every channel is NS/2
// butterflies (the ACS, 6 operations) plus an argmin over NS states for the
// emit, and the steps are a sequential recurrence.  Device memory sees only
// T bytes (n T soft) in and T bytes out per channel, so with a warp a
// channel and 15.5 warps an SM at the main path's 2048 channels it is
// bound by the SM's issue, and most of all by its shuffle and shared-memory
// pipe: the parent kernel moved two 64-bit registers a butterfly through
// the butterfly permutation (8 shuffles a step at NS = 64 beside 4 for the
// metrics and 1 for the input).
//
// What the design does about that: no registers move.  A register is the
// input bits (state & 1) of its state's survivor path, so the kernel keeps
// each step's decisions instead and walks back through them:
//   - The ACS is K4's (acs_soft_k1.cu): one warp a channel, lane l owning
//     butterflies 32 j + l; steps in blocks of 32, fully unrolled (a plain
//     loop for the last, shorter block); inputs loaded a block ahead as
//     unsigned bytes, staged and read by broadcast one load ahead of their
//     use (four steps a 16-byte load where a step is one word); a hard
//     segment's bit as the LLR 1 - 2 bit (its costs relu(q), relu(-q) are
//     the Hamming distance's), so hard and soft share one step; candidates
//     by __dp4a without the relu(-q) sums (the same for every state of a
//     step: the decisions, the argmin and the metrics less their minimum do
//     not change); two shuffles and two selects a butterfly (odd lanes'
//     sources kept swapped, K12's way of saving the selects, read slower
//     here, where issue and not one chain bounds the time).
//   - Each step's decisions are two ballots a butterfly group, which lane 0
//     stores to a ring of kRing steps in shared memory; after the block
//     lane s turns step s's ballots into the decision words of
//     acs_soft_k1.cu's layout in place (bit p NS/2 + b for state 2b + p).
//   - The argmin: each lane packs each of its states as (metric - lb) << 8
//     | state, the difference clamped below 2^22, and keeps the least; every
//     8 steps the warp reduces the 8 steps' candidates, one
//     __reduce_min_sync a step, and lane 0 keeps each step's state.  lb is
//     the least metric of the last block's last step less 2^15, at least
//     the most the least metric can fall in 32 steps (8 LLRs of -127 a
//     step; it rises as little), so the least metric's difference, below
//     2^16, is never clamped, and its lowest state wins the tie.
//   - Emit: lane s walks W - 1 steps back from step t0 + s's state through
//     the ring (state x at step t came from (x >> 1) | (d << (S - 1)), d its
//     decision bit at t) after the block; where the walk runs out of this
//     call's steps, the symbol is bit W - 2 - t of the carried register of
//     the state reached (kept in shared memory from the call's start, so
//     that r_out may alias r_in).
//   - At the call's end each lane builds its states' registers by the same
//     walk, W steps deep, its 2 NS/64 walks side by side.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kGroup = 8;   // steps whose argmins are reduced together
constexpr int kRing = 128;  // steps of decisions kept: a block of 32 and
                            // the W - 1 <= 63 before it; a call's last W
constexpr unsigned kFullMask = 0xffffffffu;
using u64 = unsigned long long;

// kHard: hard segments, each coded bit as the LLR 1 - 2 bit; else soft
// LLRs.  NP = 1: n <= 4, a step's input one packed word; NP = 2: n = 5..8.
template <int BPL, bool kHard, int NP>  // butterflies per lane = NS / 64
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
stream_k1_kernel(const uint8_t* __restrict__ seg,
                 const int8_t* __restrict__ qllrs,
                 const int32_t* __restrict__ cb,
                 const int32_t* m_in, const u64* r_in,
                 uint8_t* __restrict__ sym, int32_t* m_out, u64* r_out,
                 int B, int T, int n, int W) {
  constexpr int NS = 64 * BPL;
  constexpr int HALF = NS / 2;
  constexpr int NW = NS / 32;                        // decision words a step
  constexpr int S = (BPL == 1) ? 6 : (BPL == 2) ? 7 : 8;  // log2 NS
  constexpr bool kWide = NP == 2;                    // {x, y, sum} a step
  constexpr int NB = kHard ? 1 : 4 * NP;             // input bytes, at most
  __shared__ __align__(16) int stage_all[kWarpsPerBlock][kWide ? 4 * 32 : 32];
  __shared__ unsigned ring_all[kWarpsPerBlock][kRing][NW];
  __shared__ int keys_all[kWarpsPerBlock][32];
  __shared__ u64 reg_all[kWarpsPerBlock][NS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int ch = blockIdx.x * kWarpsPerBlock + warp;
  if (ch >= B) return;  // uniform across the warp; no block barrier below
  int* const stage = stage_all[warp];
  unsigned (*const ring)[NW] = ring_all[warp];
  int* const keys = keys_all[warp];
  u64* const reg = reg_all[warp];

  // f1, the branch metric added to lo in the destination sent first, is
  // em on lanes 0-15 and emc on lanes 16-31 (whose edge codes are
  // complemented), f2 the other.
  const bool upper = lane & 16;
  const bool odd = lane & 1;
  unsigned m1[BPL], m2[BPL];  // f1's and f2's bits 0-3, as 0/1 bytes
  unsigned h1[BPL];           // f1's bits 4-7 (n > 4)
  int lo[BPL], hi[BPL];  // metrics of source states 32 j + lane, + NS/2
#pragma unroll
  for (int j = 0; j < BPL; ++j) {
    const int b = 32 * j + lane;
    const unsigned code = upper ? ~(unsigned)cb[b] : (unsigned)cb[b];
    m1[j] = m2[j] = h1[j] = 0u;
#pragma unroll
    for (int i = 0; i < 4 * NP; ++i) {
      if (i < n) {
        const unsigned one = (code >> i) & 1u;
        if (i < 4) {
          m1[j] |= one << (8 * i);
          m2[j] |= (one ^ 1u) << (8 * i);
        } else {
          h1[j] |= one << (8 * (i - 4));
        }
      }
    }
    lo[j] = m_in[(size_t)ch * NS + b];
    hi[j] = m_in[(size_t)ch * NS + HALF + b];
    reg[b] = r_in[(size_t)ch * NS + b];
    reg[HALF + b] = r_in[(size_t)ch * NS + HALF + b];
  }
  // The first shuffle's metrics come to lane r from lane r / 2 (even r)
  // or 16 + r / 2 (odd r), the second's from the other: from pair i, x1
  // is the metric of state 64 i + r + 32 odd, x2 that of the other one.
  const int src1 = (odd ? 16 : 0) + (lane >> 1);
  const int src2 = src1 ^ 16;

  // One step of a walk: state x at step t came from this state at t - 1.
  auto back = [&](int x, int t) {
    const int i = ((x & 1) << (S - 1)) | (x >> 1);
    const unsigned d = (ring[t & (kRing - 1)][i >> 5] >> (i & 31)) & 1u;
    return (x >> 1) | (int)(d << (S - 1));
  };
  uint8_t* sym_row = sym + (size_t)ch * T;

  // Raw inputs of step t0 + lane, loaded a block ahead as unsigned bytes
  // (a sign extension at the load would wait for it).
  const uint8_t* row = kHard ? seg + (size_t)ch * T
                             : reinterpret_cast<const uint8_t*>(qllrs) +
                                   (size_t)ch * T * n;
  int raw[NB] = {};
  auto fetch = [&](int t) {
    if (t < T) {
      if constexpr (kHard) {
        raw[0] = row[t];
      } else {
#pragma unroll
        for (int i = 0; i < NB; ++i) {
          if (i < n) raw[i] = row[(size_t)t * n + i];
        }
      }
    }
  };
  fetch(lane);

  // Each step's argmin in one reduction: (metric - lb) << 8 | state, the
  // difference clamped below 2^22, its least the least metric's lowest
  // state.  lb: the least metric of the last block's last step, less
  // kDrop >= 32 steps x 8 LLRs x 127, the most it can fall in a block
  // (edge metrics without the relu(-q) sums are >= the sum of the
  // negative LLRs), so that the least metric's difference is
  // < 2 kDrop < 2^22 and never clamped.
  constexpr int kDrop = 1 << 15;
  constexpr unsigned kClamp = (1u << 22) - 1u;
  int lb;
  {
    int local = INT_MAX;
#pragma unroll
    for (int j = 0; j < BPL; ++j) local = min(local, min(lo[j], hi[j]));
    lb = __reduce_min_sync(kFullMask, local) - kDrop;
  }
  int lkey[kGroup];  // per step: the lane's least packed candidate
  int last = 0;      // the last reduced step's packed key
  // One step s, `in` its staged input ({LLRs 0-3, 4-7, sum}).
  auto step = [&](int s, int t, int4 in) {
    int v1[BPL], v2[BPL];
#pragma unroll
    for (int j = 0; j < BPL; ++j) {
      int u1, w1, u2, w2;  // a source's metric plus f1 or f2
      if constexpr (!kWide) {
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
      if (lane == 0) {  // the ring: step t's ballots
        ring[t & (kRing - 1)][j] = d1;
        ring[t & (kRing - 1)][BPL + j] = d2;
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
    // This lane's candidate, its states in increasing order: the lo slots
    // (32 j + lane), then the hi slots (NS/2 + 32 j + lane).
    auto pack = [&](int m, int state) {
      return (int)((min((unsigned)(m - lb), kClamp) << 8) | (unsigned)state);
    };
    int key = INT_MAX;
#pragma unroll
    for (int j = 0; j < BPL; ++j) {
      key = min(key, pack(lo[j], 32 * j + lane));
      key = min(key, pack(hi[j], HALF + 32 * j + lane));
    }
    lkey[s % kGroup] = key;
  };
  // The argmin of steps g0 .. g0 + count - 1 (count <= kGroup), kept by
  // lane 0 in keys[].
  auto reduce = [&](int g0, int count) {
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      if (k < count) {
        last = __reduce_min_sync(kFullMask, lkey[k]);
        if (lane == 0) keys[g0 + k] = last & 0xff;
      }
    }
  };

  for (int t0 = 0; t0 < T; t0 += 32) {
    const int steps = min(32, T - t0);
    // The LLRs (hard: 1 - 2 bit), packed, and their sum.
    unsigned x = 0u, y = 0u;
    int sum = 0;
#pragma unroll
    for (int i = 0; i < 4 * NP; ++i) {
      if (i < n) {
        int q;
        if constexpr (kHard) {
          q = 1 - 2 * ((raw[0] >> i) & 1);
        } else {
          q = max((int)(int8_t)raw[i], -127);
        }
        sum += q;
        if (i < 4) {
          x |= ((unsigned)q & 0xffu) << (8 * i);
        } else {
          y |= ((unsigned)q & 0xffu) << (8 * (i - 4));
        }
      }
    }
    __syncwarp();  // the last block's reads of the stage, ring and keys
    if constexpr (kWide) {
      reinterpret_cast<int4*>(stage)[lane] = make_int4((int)x, (int)y, sum, 0);
    } else {
      stage[lane] = (int)x;
    }
    __syncwarp();
    fetch(t0 + 32 + lane);
    // The stage is read one load ahead of its use: a shared load after a
    // step's stores to the ring could not be moved before them.
    const int4* const stage4 = reinterpret_cast<const int4*>(stage);
    if (steps == 32) {
      int4 v = stage4[0];
#pragma unroll
      for (int s4 = 0; s4 < 8; ++s4) {
        if constexpr (kWide) {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int s = 4 * s4 + k;
            const int4 next = stage4[min(s + 1, 31)];
            step(s, t0 + s, v);
            v = next;
          }
        } else {
          const int4 next = stage4[min(s4 + 1, 7)];
          step(4 * s4, t0 + 4 * s4, make_int4(v.x, 0, 0, 0));
          step(4 * s4 + 1, t0 + 4 * s4 + 1, make_int4(v.y, 0, 0, 0));
          step(4 * s4 + 2, t0 + 4 * s4 + 2, make_int4(v.z, 0, 0, 0));
          step(4 * s4 + 3, t0 + 4 * s4 + 3, make_int4(v.w, 0, 0, 0));
          v = next;
        }
        if (s4 & 1) reduce(4 * s4 - 4, kGroup);
      }
    } else {
      int4 v = kWide ? stage4[0] : make_int4(stage[0], 0, 0, 0);
#pragma unroll 1
      for (int s = 0; s < steps; ++s) {
        const int4 next = kWide ? stage4[min(s + 1, 31)]
                                : make_int4(stage[min(s + 1, 31)], 0, 0, 0);
        step(0, t0 + s, v);
        reduce(s, 1);
        v = next;
      }
    }
    lb += (last >> 8) - kDrop;  // the block's last least metric - kDrop
    __syncwarp();  // lane 0's stores of the ballots and keys are done
    // Lane s turns step t0 + s's ballots into its decision words: word j
    // holds the even destinations (d1 on lanes 0-15, d2 on lanes 16-31),
    // word BPL + j the odd ones.
    int key = 0;
    if (lane < steps) {
      unsigned* const words = ring[(t0 + lane) & (kRing - 1)];
      unsigned d1s[BPL], d2s[BPL];
#pragma unroll
      for (int j = 0; j < BPL; ++j) d1s[j] = words[j], d2s[j] = words[BPL + j];
#pragma unroll
      for (int j = 0; j < BPL; ++j) {
        words[j] = __byte_perm(d1s[j], d2s[j], 0x7610);
        words[BPL + j] = __byte_perm(d2s[j], d1s[j], 0x7610);
      }
      key = keys[lane];
    }
    __syncwarp();  // every step's words are in place
    if (lane < steps) {
      // Step t's symbol: bit W - 1 of its argmin state's register: the
      // state W - 1 steps back, or the carried register's bit where the
      // walk runs out of this call's steps.
      const int t = t0 + lane;
      int x = key;
      const int count = min(W - 1, t + 1);
#pragma unroll 1
      for (int k = 0; k < count; ++k) x = back(x, t - k);
      sym_row[t] = (uint8_t)((t >= W - 1) ? (unsigned)x & 1u
                                           : (unsigned)(reg[x] >> (W - 2 - t)) & 1u);
    }
  }

  // State out: the metrics less their minimum; each state's register, its
  // last W path bits, walked back from the call's last step (the carried
  // register's bits beyond the call's start).
  int local = INT_MAX;
#pragma unroll
  for (int j = 0; j < BPL; ++j) local = min(local, min(lo[j], hi[j]));
  const int mn = __reduce_min_sync(kFullMask, local);
  const u64 wmask = (W >= 64) ? ~0ull : ((1ull << W) - 1ull);
  u64 out[2 * BPL];  // the lo slots' states, then the hi slots'
  int xs[2 * BPL];
#pragma unroll
  for (int m = 0; m < 2 * BPL; ++m) xs[m] = 32 * m + lane, out[m] = 0ull;
  int k = 0;
#pragma unroll 1
  for (int t = T - 1; k < W && t >= 0; ++k, --t) {  // the walks side by side
#pragma unroll
    for (int m = 0; m < 2 * BPL; ++m) {
      out[m] |= (u64)(xs[m] & 1) << k;
      xs[m] = back(xs[m], t);
    }
  }
#pragma unroll
  for (int m = 0; m < 2 * BPL; ++m) {
    if (k < W) out[m] |= reg[xs[m]] << k;
    out[m] &= wmask;
  }
  __syncwarp();  // every lane's reads of r_in's copy are done (no alias)
#pragma unroll
  for (int j = 0; j < BPL; ++j) {
    const size_t b = (size_t)ch * NS + 32 * j + lane;
    m_out[b] = lo[j] - mn;
    m_out[b + HALF] = hi[j] - mn;
    r_out[b] = out[j];
    r_out[b + HALF] = out[BPL + j];
  }
}

struct Args {
  const uint8_t* seg;
  const int8_t* qllrs;
  const int32_t* cb;
  const int32_t* m_in;
  const u64* r_in;
  uint8_t* sym;
  int32_t* m_out;
  u64* r_out;
  int B, T, n, W;
};

template <int BPL, bool kHard, int NP>
void launch(const Args& a, cudaStream_t s) {
  const dim3 block(32 * kWarpsPerBlock);
  const dim3 grid((a.B + kWarpsPerBlock - 1) / kWarpsPerBlock);
  stream_k1_kernel<BPL, kHard, NP><<<grid, block, 0, s>>>(
      a.seg, a.qllrs, a.cb, a.m_in, a.r_in, a.sym, a.m_out, a.r_out, a.B,
      a.T, a.n, a.W);
}

template <int BPL>
void launch_n(int soft, int n, const Args& a, cudaStream_t s) {
  if (soft) {
    (n <= 4) ? launch<BPL, false, 1>(a, s) : launch<BPL, false, 2>(a, s);
  } else {
    (n <= 4) ? launch<BPL, true, 1>(a, s) : launch<BPL, true, 2>(a, s);
  }
}

}  // namespace

// `input` is uint8 [B, T] segments when soft == 0, int8 [B, T, n] LLRs
// otherwise; 2 <= W <= 64, 1 <= n <= 8.
extern "C" int stream_k1_decode(const void* input, int soft, const void* cb,
                                const void* m_in, const void* r_in, void* sym,
                                void* m_out, void* r_out, int B, int T,
                                int NS, int n, int W, void* stream) {
  if (W < 2 || W > 64 || n < 1 || n > 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{soft ? nullptr : static_cast<const uint8_t*>(input),
               soft ? static_cast<const int8_t*>(input) : nullptr,
               static_cast<const int32_t*>(cb),
               static_cast<const int32_t*>(m_in),
               static_cast<const u64*>(r_in),
               static_cast<uint8_t*>(sym),
               static_cast<int32_t*>(m_out),
               static_cast<u64*>(r_out),
               B, T, n, W};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (NS) {
    case 64: launch_n<1>(soft, n, a, s); break;
    case 128: launch_n<2>(soft, n, a, s); break;
    case 256: launch_n<4>(soft, n, a, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
