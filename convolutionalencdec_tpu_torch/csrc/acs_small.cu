// Small-state k=1 butterfly add-compare-select (ACS), forward pass, hard and
// soft: NS = 2, 4, 8, 16, 32 (K = 2 ... 6).
//
// Replaces the TPU kernels `acs_forward_batch` (convolutionalencdec_tpu/
// kernels/acs_pallas.py, pallas_call at :271, body `_fwd_kernel` at :75) and
// `acs_forward_batch_soft` (pallas_call at :489, body `_fwd_soft_kernel` at
// :387): the unfused butterfly kernels the JAX package runs for NS < 64.
// They compute what those kernels compute, not how: no renormalisation every
// 8 steps (int32 metrics never need it, and decisions depend on metric
// differences only), no time-packed decision bytes, no padding of T or B.
//
// Semantics: bit for bit those of acs_soft_k1.cu's two entries (hard,
// segments; soft, LLRs conditioned as clamp(q, qlo, qclip)), that is
// ops/viterbi.viterbi_forward_butterfly and
// ops/metrics.viterbi_forward_butterfly_soft: ties keep the low source,
// int32 metrics, never renormalised.
//
// Layouts: as acs_soft_k1.cu, with W = 1 decision word per step:
//   in             uint8 [B, T] segments, or int8 [B, T, n] LLRs
//   cb             int32 [NS/2]      coded segment of edge (src b, input 0)
//   init           int32 [B, NS]     optional (nullptr: 0 at state 0,
//                                    init_value elsewhere)
//   decs           int32 [B, T]      the decision of state s = 2b + p is bit
//                                    p*NS/2 + b; bits NS..31 are zero
//   final_metrics  int32 [B, NS]     natural state order
//
// What bounds it on this card: NS/2 butterflies per step and channel, each
// step a recurrence on the one before; NS/8 bytes of decisions per step
// (the kernel writes a 4-byte word).  A warp keeps G = 64/NS channels, so a
// main-path batch of 2048 channels fills about one warp an SM sub-partition
// (512 warps at NS = 16, 528 sub-partitions): nothing hides a step's
// latency, and the chain of dependent instructions a step, with the
// instructions issued between its links, sets the time, not the
// operations (PERF.md §6).
//
// What the design does about that (K4's step, acs_soft_k1.cu, on the small
// layout; each piece measured in turns with the parent's build, PERF.md §6):
//   - G channels a warp, lane (c, b) = lane c NS/2 + b serving butterfly b
//     of channel c, so every lane works.  The steps run in blocks of 32,
//     fully unrolled (a plain loop for the last, shorter block).  A whole
//     channel in one lane (no exchange at all) was slower at every NS.
//   - Staged inputs: lane l loads step t0 + l of each of the warp's
//     channels (a coalesced run a channel), a block ahead where they fit in
//     16 registers a lane (else all of a batch before any is used), as
//     unsigned bytes (a sign extension at the load would wait for it), and
//     stores them as LLR bytes packed four to a word (n = 5..8: two words
//     and the step's LLR sum) in the warp's stage in shared memory; every
//     lane of a channel reads a step there, one load ahead of its use
//     (four steps a 16-byte load where a step is one word).  A hard
//     segment's bit is the LLR 1 - 2 bit: its two costs, relu(q) and
//     relu(-q), are the Hamming distance's 0 and 1, so hard and soft share
//     one step.
//   - Edge metrics without the relu(-q) sums (each step's sum is the same
//     for every state: decisions do not change; each staging lane adds up
//     its steps' sums a channel, and a warp reduction a channel adds them
//     back to the final metrics); for n <= 4 each candidate is one __dp4a
//     of the packed bytes onto its source metric, for n = 5..8 g1 is two
//     and g2 the step's sum less g1.
//   - Two shuffles a butterfly and no select: lanes b < NS/4 send the metric
//     of their even destination first, lanes b >= NS/4 that of their odd
//     one (their codes complemented), and odd lanes keep their two sources
//     swapped (the high one first), their codes flipped to match.  A step's
//     chain is then a __dp4a, a minimum and a shuffle.  The swap reverses
//     an odd lane's comparison; ties keep the low source by comparing
//     c1 - c2 + 1 > 0 there and inverting the predicate.
//   - Decisions by ballot, off the chain: each destination's decisions of a
//     step are one __ballot_sync across the warp's G channels, which lane s
//     keeps for step s (a select a step: lane 0 storing them to a row
//     buffer in shared memory read slower); after the block lane s puts
//     step s's bits in place for each channel and stores the G words.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 2;
constexpr int kAheadInts = 16;  // registers a lane may hold a block ahead
constexpr unsigned kFullMask = 0xffffffffu;

// kHard: hard segments, each coded bit as the LLR 1 - 2 bit (its costs, 0
// if it agrees and 1 if not, are relu(q) and relu(-q)); else soft LLRs.
// NP = 1: n <= 4, a step's input one packed word; NP = 2: n = 5..8.
template <int NS, bool kHard, int NP>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
acs_small_kernel(const uint8_t* __restrict__ in,
                 const int32_t* __restrict__ cb,
                 const int32_t* __restrict__ init,
                 int32_t* __restrict__ decs,
                 int32_t* __restrict__ final_metrics, int B, int T, int n,
                 int qlo, int qclip, int init_value) {
  constexpr bool kWide = NP == 2;                // {x, y, sum} a step
  constexpr int H = NS / 2;                      // lanes (butterflies) a channel
  constexpr int G = 32 / H;                      // channels a warp
  constexpr int NB = kHard ? 1 : 4 * NP;         // input bytes a step, at most
  constexpr bool kAhead = G * NB <= kAheadInts;  // loads a block ahead
  // Else the channels loaded (all issued) before any is staged.
  constexpr int kBatch = (G * NB <= 2 * kAheadInts) ? G : 2 * kAheadInts / NB;
  constexpr int kRow = kWide ? 4 * 32 + 4 : 32 + 4;  // ints: rows 4 banks apart
  constexpr unsigned kHalf = (1u << H) - 1u;          // H <= 16
  // Ballot bits of the lanes b < NS/4 of every channel (all lanes at H = 1).
  constexpr unsigned kLow =
      (H == 1) ? kFullMask
               : ((1u << (H / 2)) - 1u) * (kFullMask / ((1u << H) - 1u));
  __shared__ __align__(16) int stage_all[kWarpsPerBlock][G][kRow];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c = lane / H;  // the lane's channel within the warp
  const int b = lane % H;  // its butterfly
  const int ch0 = (blockIdx.x * kWarpsPerBlock + warp) * G;
  if (ch0 >= B) return;  // uniform across the warp; no block barrier below
  const int ch = ch0 + c;
  const bool live = ch < B;  // lanes of channels past B store nothing
  int* const stage = stage_all[warp][c];  // the lane's channel's

  const int odd = (H > 1) ? (b & 1) : 0;
  const bool upper = (H > 1) && b >= H / 2;
  // g1 is the edge metric added to A (the lane's first source) in the
  // destination sent first, g2 the other: A is the low source b on even
  // lanes and the high one b + NS/2 on odd lanes.
  const unsigned code = (upper != (odd != 0)) ? ~(unsigned)cb[b]
                                              : (unsigned)cb[b];
  const int nmask = (1 << n) - 1;
  unsigned m1 = 0u, m2 = 0u, h1 = 0u;  // g1's and g2's bits 0-3 as 0/1 bytes,
  {                                    // g1's bits 4-7
#pragma unroll
    for (int i = 0; i < 4 * NP; ++i) {
      if (i < n) {
        const unsigned one = (code >> i) & 1u;
        if (i < 4) {
          m1 |= one << (8 * i);
          m2 |= (one ^ 1u) << (8 * i);
        } else {
          h1 |= one << (8 * (i - 4));
        }
      }
    }
  }
  int A, Bm;  // metrics of the lane's two sources, A first
  {
    const int lo_state = b, hi_state = b + H;
    const int a_state = odd ? hi_state : lo_state;
    const int b_state = odd ? lo_state : hi_state;
    if (init != nullptr && live) {
      A = init[(size_t)ch * NS + a_state];
      Bm = init[(size_t)ch * NS + b_state];
    } else {
      A = (a_state == 0) ? 0 : init_value;
      Bm = (b_state == 0) ? 0 : init_value;
    }
  }
  // Next-step sources: the first shuffle brings state b (even b) from lane
  // b / 2 or state b + NS/2 (odd b) from lane NS/4 + b / 2, the second the
  // other one.
  const int src1 = (odd ? H / 2 : 0) + (b >> 1);
  const int src2 = src1 ^ (H / 2);

  // Each block, lane l stages step t0 + l of each of the warp's channels
  // (one coalesced run a channel).  Loads are predicated, not branched
  // round, so that a batch's are all in flight before any is used; they
  // are unsigned bytes, sign-extended only where staged (a conversion at
  // the load would wait for it).
  int raw[kAhead ? G : kBatch][NB];
  auto load = [&](int cc, int t, int (&r)[NB]) {
    const bool ok = ch0 + cc < B && t < T;
    const size_t at = (size_t)(ch0 + cc) * T + t;
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      int v = 0;
      if (ok && (kHard || i < n)) v = in[kHard ? at : at * n + i];
      r[i] = v;
    }
  };
  auto fetch = [&](int t) {
    if constexpr (kAhead) {
#pragma unroll
      for (int cc = 0; cc < G; ++cc) load(cc, t, raw[cc]);
    }
  };
  fetch(lane);

  int drop[G] = {};  // per channel, the lane's staged steps' sum(relu(-q))
  // Channel cc's step t0 + lane, `r` its raw bytes: clamped (hard: 1 - 2
  // bit), packed and summed into the stage (a step past T loads zeros and
  // drops nothing).
  auto convert = [&](int cc, const int (&r)[NB]) {
    unsigned x = 0u, y = 0u;
    int sum = 0;
#pragma unroll
    for (int i = 0; i < 4 * NP; ++i) {
      if (i < n) {
        int q;
        if constexpr (kHard) {
          q = 1 - 2 * ((r[0] >> i) & 1);
        } else {
          q = min(max((int)(int8_t)r[i], qlo), qclip);
          drop[cc] += max(-q, 0);
        }
        sum += q;
        if (i < 4) {
          x |= ((unsigned)q & 0xffu) << (8 * i);
        } else {
          y |= ((unsigned)q & 0xffu) << (8 * (i - 4));
        }
      }
    }
    if constexpr (kHard) drop[cc] += __popc(r[0] & nmask);
    int* const row = stage_all[warp][cc];
    if constexpr (kWide) {
      reinterpret_cast<int4*>(row)[lane] = make_int4((int)x, (int)y, sum, 0);
    } else {
      row[lane] = (int)x;
    }
  };
  uint2 kept = make_uint2(0u, 0u);  // lane s: step s's two ballots
  // One step, `x` its staged input (kWide: {LLRs 0-3, 4-7, sum}).
  auto step = [&](int s, int4 x) {
    int c1, c2, c3, c4;  // A + g1, B + g2, A + g2, B + g1
    if constexpr (!kWide) {
      c1 = __dp4a(x.x, (int)m1, A);
      c2 = __dp4a(x.x, (int)m2, Bm);
      c3 = __dp4a(x.x, (int)m2, A);
      c4 = __dp4a(x.x, (int)m1, Bm);
    } else {
      const int g1 = __dp4a(x.x, (int)m1, __dp4a(x.y, (int)h1, 0));
      const int g2 = x.z - g1;
      c1 = A + g1, c2 = Bm + g2;
      c3 = A + g2, c4 = Bm + g1;
    }
    // Even lanes: the high source wins when strictly c1 > c2; odd lanes
    // (sources swapped): when strictly c2 > c1, i.e. not c1 - c2 + 1 > 0.
    const unsigned d1 = __ballot_sync(kFullMask, ((c1 - c2 + odd) > 0) != (odd != 0));
    const unsigned d2 = __ballot_sync(kFullMask, ((c3 - c4 + odd) > 0) != (odd != 0));
    if (lane == s) kept = make_uint2(d1, d2);
    const int v1 = min(c1, c2), v2 = min(c3, c4);
    if constexpr (H == 1) {
      A = v1;
      Bm = v2;
    } else {
      A = __shfl_sync(kFullMask, v1, src1, H);
      Bm = __shfl_sync(kFullMask, v2, src2, H);
    }
  };

  int32_t* const dec_base = decs + (size_t)ch0 * T;
  for (int t0 = 0; t0 < T; t0 += 32) {
    const int steps = min(32, T - t0);
    __syncwarp();  // the last block's reads of the stage are done
    if constexpr (kAhead) {
#pragma unroll
      for (int cc = 0; cc < G; ++cc) convert(cc, raw[cc]);
    } else {
#pragma unroll
      for (int c0 = 0; c0 < G; c0 += kBatch) {
#pragma unroll
        for (int k = 0; k < kBatch; ++k) load(c0 + k, t0 + lane, raw[k]);
#pragma unroll
        for (int k = 0; k < kBatch; ++k) convert(c0 + k, raw[k]);
      }
    }
    __syncwarp();
    fetch(t0 + 32 + lane);
    // The stage is read one load ahead of its use.
    const int4* const stage4 = reinterpret_cast<const int4*>(stage);
    if (steps == 32) {
      int4 v = stage4[0];
      if constexpr (kWide) {
#pragma unroll
        for (int s = 0; s < 32; ++s) {
          const int4 next = stage4[min(s + 1, 31)];
          step(s, v);
          v = next;
        }
      } else {
#pragma unroll
        for (int s4 = 0; s4 < 8; ++s4) {
          const int4 next = stage4[min(s4 + 1, 7)];
          step(4 * s4, make_int4(v.x, 0, 0, 0));
          step(4 * s4 + 1, make_int4(v.y, 0, 0, 0));
          step(4 * s4 + 2, make_int4(v.z, 0, 0, 0));
          step(4 * s4 + 3, make_int4(v.w, 0, 0, 0));
          v = next;
        }
      }
    } else {
      int4 v = kWide ? stage4[0] : make_int4(stage[0], 0, 0, 0);
#pragma unroll 1
      for (int s = 0; s < steps; ++s) {
        const int4 next = kWide ? stage4[min(s + 1, 31)]
                                : make_int4(stage[min(s + 1, 31)], 0, 0, 0);
        step(s, v);
        v = next;
      }
    }
    if (lane < steps) {
      const uint2 d = kept;
      // Even destinations: d1 on lanes b < NS/4, d2 on the others; odd
      // ones the other way round.
      const unsigned e = (d.x & kLow) | (d.y & ~kLow);
      const unsigned o = (d.y & kLow) | (d.x & ~kLow);
#pragma unroll
      for (int cc = 0; cc < G; ++cc) {
        if (ch0 + cc < B) {
          const unsigned w = ((e >> (cc * H)) & kHalf) |
                             (((o >> (cc * H)) & kHalf) << H);
          dec_base[(size_t)cc * T + t0 + lane] = (int)w;
        }
      }
    }
  }

  // The final metrics, with the dropped sums added back (each channel's
  // sums over the warp's lanes).
  int dropped = 0;
#pragma unroll
  for (int cc = 0; cc < G; ++cc) {
    const int total = __reduce_add_sync(kFullMask, drop[cc]);
    if (cc == c) dropped = total;
  }
  if (live) {
    const int a_state = odd ? b + H : b;
    final_metrics[(size_t)ch * NS + a_state] = A + dropped;
    final_metrics[(size_t)ch * NS + (a_state ^ H)] = Bm + dropped;
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

template <int NS, bool kHard, int NP>
void launch(const Args& a, cudaStream_t s) {
  constexpr int per_block = kWarpsPerBlock * (64 / NS);  // channels
  const dim3 block(32 * kWarpsPerBlock);
  const dim3 grid((a.B + per_block - 1) / per_block);
  acs_small_kernel<NS, kHard, NP><<<grid, block, 0, s>>>(
      a.in, a.cb, a.init, a.decs, a.final_metrics, a.B, a.T, a.n, a.qlo,
      a.qclip, a.init_value);
}

template <bool kHard, int NP>
bool launch_ns(int NS, const Args& a, cudaStream_t s) {
  switch (NS) {
    case 2: launch<2, kHard, NP>(a, s); return true;
    case 4: launch<4, kHard, NP>(a, s); return true;
    case 8: launch<8, kHard, NP>(a, s); return true;
    case 16: launch<16, kHard, NP>(a, s); return true;
    case 32: launch<32, kHard, NP>(a, s); return true;
    default: return false;
  }
}

template <bool kHard>
bool launch_n(int NS, const Args& a, cudaStream_t s) {
  if (a.n < 1 || a.n > 8) return false;
  return (a.n <= 4) ? launch_ns<kHard, 1>(NS, a, s)
                    : launch_ns<kHard, 2>(NS, a, s);
}

}  // namespace

extern "C" int acs_small_forward(const void* seg, const void* cb,
                                 const void* init, void* decs,
                                 void* final_metrics, int B, int T, int NS,
                                 int n, int init_value, void* stream) {
  const Args a{static_cast<const uint8_t*>(seg),
               static_cast<const int32_t*>(cb),
               static_cast<const int32_t*>(init),
               static_cast<int32_t*>(decs),
               static_cast<int32_t*>(final_metrics),
               B, T, n, 0, 0, init_value};
  if (!launch_n<true>(NS, a, static_cast<cudaStream_t>(stream))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int acs_soft_small_forward(const void* qllrs, const void* cb,
                                      const void* init, void* decs,
                                      void* final_metrics, int B, int T,
                                      int NS, int n, int qlo, int qclip,
                                      int init_value, void* stream) {
  const Args a{static_cast<const uint8_t*>(qllrs),
               static_cast<const int32_t*>(cb),
               static_cast<const int32_t*>(init),
               static_cast<int32_t*>(decs),
               static_cast<int32_t*>(final_metrics),
               B, T, n, qlo, qclip, init_value};
  if (!launch_n<false>(NS, a, static_cast<cudaStream_t>(stream))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
