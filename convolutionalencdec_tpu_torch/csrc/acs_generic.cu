// Generic-k block decode: the 2^k-way add-compare-select (ACS) forward pass
// and the traceback, for any rate-k/n code that is not a k = 1
// poly-symmetric butterfly (any k > 1 code, and asymmetric k = 1 codes).
//
// Four entry points:
//   acs_generic_forward     replaces the TPU kernel `acs_forward_batch_generic`
//                           in convolutionalencdec_tpu/kernels/acs_pallas.py
//                           (pallas_call at :2004, kernel body
//                           `_fwd_kernel_generic`, :1841);
//   traceback_generic       replaces `traceback_batch_generic` (pallas_call at
//                           :2039, `_tb_kernel_generic`, :1920) and the
//                           MSb-first symbol expansion of
//                           `viterbi_decode_batch_generic` (:2073-2077);
//   acs_generic_k2_forward  replaces `acs_forward_batch_k2` in
//                           convolutionalencdec_tpu/kernels/acs_k2.py
//                           (pallas_call at :345, `_fwd_kernel_k2`, :236);
//   traceback_generic_k2    replaces `traceback_batch_k2` (pallas_call at
//                           :531, `_tb_kernel_k2`, :478).
// Both forward entries launch one template, instantiated for each of the 25
// (k, NS) shapes the route admits (NS = 2^(k S) <= 1024, k <= 8: the switch
// in `launch_generic_forward`); the k2 entry takes only k = 2, NS = 64.  The
// two traceback entries launch the walk template the same way (the switch
// in `launch_generic_walk`); traceback_generic_k2 takes only its k = 2,
// NS = 64 case.
// They compute what the TPU kernels compute, not how: no MXU edge-metric
// weights, no key-packed argmin scaled by 2^k, no (u, s) row blocks and
// their per-step interleave, no renormalisation, no padding of T or B.
//
// Semantics (bit for bit those of ops/viterbi.viterbi_forward on
// hard_step_metrics, and of traceback_terminated):
//   destination d = s 2^k + u takes, over e = 0 .. 2^k - 1 in rising order,
//   the least of m[s + e G] + popc(r ^ code(e, d)), G = NS / 2^k, r the
//   received segment; the lowest e wins ties (jnp.argmin).  The edge's delay
//   register is d | e << S k and each coded bit is its parity under a
//   generator mask, so code(e, d) = seg_d[d] ^ seg_e[e] (the parity is
//   linear over XOR): NS + 2^k table bytes, not 2^k NS.  Metrics start at 0
//   in state 0 and init_value elsewhere, int32, never renormalised (exact
//   for T n + init_value < 2^31).
//   The traceback walks from state 0 at step t_actual - 1; at step t it
//   emits u = cur & (2^k - 1) as bits t k .. t k + k - 1, MSb first, keeps
//   those below message_bits (<= (t_actual - S) k), and moves to
//   cur = (cur >> k) | e << (S-1)k.  Bytes are filled MSb-first, with the
//   bits past message_bits of the trailing byte left zero.
//
// Layouts:
//   seg     uint8 [B, T]
//   table   uint8 [NS + 2^k]       seg_d, then seg_e
//   planes  int32 [B, T, k, W]     W = ceil(NS / 32); bit b of e chosen for
//                                  state d is bit d % 32 of word d / 32 of
//                                  plane b; bits past NS are 0
//   final_metrics int32 [B, NS]    natural state order
//   out     uint8 [B, ceil(message_bits / 8)] bytes, or [B, message_bits]
//
// What bounds it on this card: the forward does 2^k adds and 2^k - 1
// compare-selects per state and step, (2 2^k - 1) NS int32 operations per
// step and channel against one segment byte read and k NS / 8 bytes of
// decisions written (NS >= 32; below that a step's word is padded to 32
// bits): at k = 2, NS = 64 that is 448 operations per 17 bytes, so it is
// bound by operations (B = 2048 channels, T = 1027 steps: 0.94 G
// operations, 0.056 ms at the card's 16.7 T int32 operations/s, against
// 36.3 MB, 0.011 ms, of bytes).  The steps of one channel are a
// recurrence, so at small NS the kernel is bound by one step's latency,
// times T, unless the step is short.  The traceback reads those bytes once
// (k NS / 8 a step; at k = 2, NS = 256, T = 512: 67.1 MB, 0.020 ms) and
// does a few operations a step, but as a chain of dependent reads, k
// decision bits a step, from state 0 at the last step down to the first.
//
// What the forward's design does about that (`generic_forward_kernel`,
// one warp a block; every choice below was measured in turns with the
// others by scripts/torch_generic_variants.py, PERF.md §6):
//   * k and NS are template arguments, so every loop over sources,
//     destinations and planes unrolls and a lane's source loads issue
//     together.  Only n is a runtime value.  Each instantiation may hold
//     128 registers a lane (16 resident blocks an SM; nvcc otherwise held
//     most at 64).
//   * C = 2^LOGC lanes serve a channel, 32 / C channels a warp (the third
//     template argument, chosen per shape in the dispatch switch).  At
//     B = 2048 a step's latency, not issue, bounds the small shapes, so
//     more lanes a channel won down to one or two destinations a lane; one
//     lane a channel, which needs no exchange, lost 1.4-2.3x.  Lane l of a
//     channel owns the DPL = NS / C destinations l DPL .. l DPL + DPL - 1,
//     contiguous, their metrics in its registers, in NGL groups (DPL / 2^k
//     whole groups, or DPL destinations of one group).
//   * The exchange: the lane stores its destinations to a double-buffered
//     row of shared memory as int4 runs, one __syncwarp a step, and loads
//     each group's 2^k sources s + e G (k <= 3: into registers, NGL
//     consecutive groups' as one int4 / int2 run, consecutive lanes on
//     consecutive words, lanes of one group as a broadcast; k >= 4: eight
//     at a time, unrolled).  A group's sources lie on up to 2^k lanes, and
//     the lanes that read one sender want different registers of it, so a
//     shuffle would need a select per value and lane.  Where a lane owns
//     one destination and k <= 2, it has one register to send, and the
//     2^k sources come by __shfl_sync, with no row and no __syncwarp a step
//     (at k >= 3 the row's broadcast loads were faster).
//   * The branch metric: popc(r ^ seg_d ^ seg_e), one LOP3 and one POPC; for
//     k <= 3 and n <= 3 (HAM = 1) a byte permute instead: a step's 2^k
//     tables D_x, x = r ^ seg_e[e], hold popc(x ^ c) for the eight c as
//     bytes, and prmt(D_x, 0x8880 | seg_d[d]) is the distance,
//     zero-extended (selector nibbles of 8 replicate byte 0's sign bit,
//     which is 0).
//   * The 2^k candidates meet in a tree of strict < compares, lower e on
//     the left, so ties keep the lowest e.
//   * Decisions: each lane packs plane b's bits of its contiguous
//     destinations into fields at their word offsets; the LW lanes sharing
//     a word join them with log2(LW) __shfl_xor_sync ORs (a __ballot_sync
//     when a lane owns one destination; whole words when it owns 32), at
//     the end of the step or, where the fourth template argument says so,
//     during the next one; the lane owning the word stages it in shared
//     memory.  Every R steps the warp writes each channel's R k W
//     contiguous words with coalesced stores.
//   * Segments: each chunk of R steps' bytes are loaded into registers one
//     chunk ahead and staged in shared memory at the chunk's start; a
//     step's byte is read two steps ahead and its tables one step ahead,
//     so that no load waits on another load of the same step.
//   * The step loop is unrolled 1, 2 or 4 times (the fifth template
//     argument): at the small shapes the unrolled steps' independent work
//     (loads, the word join) overlaps the metric chain (TOY_K3: -19% at 2),
//     at the largest the longer body lost (k = 8: +49% at 4).
//
// What the walk's design does about its chain (`generic_walk_kernel`; every
// choice below was measured in turns with the others and with the one
// thread a channel walk it replaced, by scripts/torch_generic_variants.py
// --walk, PERF.md §6):
//   * A channel's T steps are cut into segments of G steps, one a lane, C
//     lanes a channel (a warp; two channels a warp at k = 2, NS = 256;
//     fewer lanes, the rest idle, where a window's words would not fit),
//     so a lane's chain is T / C steps and a warm-up, not T, and B = 2048
//     channels put 8-16 resident warps on every SM, where one thread a
//     channel left 68 of 132 SMs idle (21-463x the bound).  The lanes walk
//     the segments of a window of C G steps at once, windows top down on
//     the grid of multiples of C G.
//   * Exact, as block_1p.cu's `walk`: a lane guesses the state at its
//     segment's top by a warm-up of WU steps from state 0 above it, or
//     from the window's known top state where the warm-up reaches the top,
//     so the top segment's start is exact.  After the first pass each lane
//     whose start differs from the state the segment above ended in walks
//     again from that state, in rounds (a shuffle and a warp vote each),
//     until none differs: on any input the serial walk's result, at most a
//     window's chain more on garbage.  Halving WU at the main-path codes
//     changed their times by under 2% (the saved steps came back as
//     re-walk rounds), doubling it cost 7-12%.
//   * Output: segments are multiples of Q = 8 / gcd(k, 8) steps, so a lane
//     owns whole bytes: it gathers a group's k Q bits MSb first in a
//     register and stores them to the window's bytes in shared memory; the
//     warp then writes the window's part of each row with consecutive
//     lanes on consecutive bytes (bits: a byte a bit), the bits past
//     message_bits masked.
//   * Staging: two windows of each channel in shared memory (NB = 2), the
//     next one landing while the walk takes this one, each segment at its
//     own row of P words (an odd number of 16-byte chunks, so that the
//     lanes' rows start in different banks), by one bulk copy a segment (cp.async.bulk on one mbarrier a buffer)
//     of the 16-byte chunks that hold its words (a chunk that holds a word
//     of the planes lies in their allocation).  No step waits on device
//     memory.  16-byte cp.async copies by the lanes were 9-47% slower at
//     NS >= 256 and as fast below; a third window staged (NB = 3), or shorter
//     segments in more windows, cost more (resident warps, warm-ups) than
//     they gained; four warps a block gained nothing.
//   * k, NS and G are template arguments: a step's k word loads, their bit
//     selects and a block of max(Q, 4) steps unroll (the loops over blocks
//     stay `#pragma unroll 1`: nvcc 12.9 miscompiled block_1p.cu's unrolled
//     warm-up).  Where a step's words are few (W = 2 and k W <= 8, or
//     W = 4 and k = 1) and the planes are 16-byte aligned, a step loads its
//     whole row as vectors whose addresses do not depend on the state and
//     selects the words with the state, so its chain is ALU work only
//     (k = 2, NS = 64: -5%; k = 1, NS = 64: -21%).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "bulk_copy.cuh"

namespace {

constexpr unsigned kFullMask = 0xffffffffu;

constexpr int gcd_c(int a, int b) { return b ? gcd_c(b, a % b) : a; }


// Steps staged per chunk: a power of two in [2, 32] with at most 512
// staged decision words a warp.
constexpr int staged_steps(int words) {
  int r = 32;
  while (r > 2 && r * words > 512) r >>= 1;
  return r;
}

// The constants of one instantiation of the forward.
template <int K, int LOGNS, int LOGC>
struct FwdShape {
  static constexpr int E = 1 << K;           // sources per destination
  static constexpr int NS = 1 << LOGNS;
  static constexpr int G = NS >> K;          // groups; group s: sources
                                             // s + e G, destinations s E + u
  static constexpr int C = 1 << LOGC;        // lanes per channel
  static constexpr int CPW = 32 >> LOGC;     // channels per warp
  static constexpr int DPL = NS >> LOGC;     // destinations per lane
  static constexpr bool kSmallE = K <= 3;    // a group's sources in registers
  // One destination a lane and 2 or 4 sources: they come by __shfl_sync
  // from the lanes that own them, with no shared row.
  static constexpr bool kShfl = DPL == 1 && K <= 2;
  // Fields of lanes that share a word, joined by __shfl_xor_sync.
  static constexpr bool kTree = DPL > 1 && DPL < 32;
  // Groups a lane serves, and its destinations in each.
  static constexpr int NGL = DPL >= E ? DPL / E : 1;
  static constexpr int U = DPL >= E ? E : DPL;
  static constexpr int W = (NS + 31) / 32;
  static constexpr int KW = K * W;
  static constexpr int WPL = DPL >= 32 ? DPL / 32 : 1;  // words a lane packs
  // Lanes whose fields share a word.
  static constexpr int LW = DPL >= 32 ? 1 : (NS < 32 ? NS : 32) / DPL;
  static constexpr int R = staged_steps(CPW * KW);
  // Segment bytes a lane prefetches a chunk.
  static constexpr int NLD = (CPW * R + 31) / 32;
  // Resident one-warp blocks an SM must hold: 16 lets a lane use 128
  // registers (without it nvcc held most instantiations at 64, for 32
  // blocks an SM), and B = 2048 channels at one channel a warp need 15.5
  // an SM.
  static constexpr int kMinBlocks = 16;
  static_assert(LOGC <= 5 && LOGC <= LOGNS, "lanes per channel");
  static_assert(kSmallE || DPL <= E, "a lane's destinations in one group");
};

// N consecutive int32 from shared memory, as the widest aligned vectors.
template <int N>
__device__ __forceinline__ void load_run(const int32_t* p, int* v) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const int4 x = *reinterpret_cast<const int4*>(p + i);
      v[i] = x.x;
      v[i + 1] = x.y;
      v[i + 2] = x.z;
      v[i + 3] = x.w;
    }
  } else if constexpr (N == 2) {
    const int2 x = *reinterpret_cast<const int2*>(p);
    v[0] = x.x;
    v[1] = x.y;
  } else {
    v[0] = p[0];
  }
}

template <int N>
__device__ __forceinline__ void store_run(int32_t* p, const int* v) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      *reinterpret_cast<int4*>(p + i) =
          make_int4(v[i], v[i + 1], v[i + 2], v[i + 3]);
    }
  } else if constexpr (N == 2) {
    *reinterpret_cast<int2*>(p) = make_int2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}

__device__ __forceinline__ int prmt(int a, int b, int sel) {
  int d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

// The least of v[0 .. E-1] and its index, the lowest index on ties: a tree
// of strict < compares with the lower indices on the left.
template <int E>
__device__ __forceinline__ void argmin_tree(int (&v)[E], int& best,
                                            int& idx) {
  int ix[E];
#pragma unroll
  for (int e = 0; e < E; ++e) ix[e] = e;
#pragma unroll
  for (int w = 1; w < E; w <<= 1) {
#pragma unroll
    for (int i = 0; i < E; i += 2 * w) {
      const bool p = v[i + w] < v[i];
      v[i] = p ? v[i + w] : v[i];
      ix[i] = p ? ix[i + w] : ix[i];
    }
  }
  best = v[0];
  idx = ix[0];
}

// HAM = 1: the byte-permute branch metric (n <= 3, k <= 3 only);
// HAM = 0: popc.  DEFER = 1: a step's words are joined and staged during
// the next step.  UNROLL: steps of the step loop unrolled.
template <int K, int LOGNS, int LOGC, int DEFER, int UNROLL, int HAM>
__global__ void __launch_bounds__(32, FwdShape<K, LOGNS, LOGC>::kMinBlocks)
generic_forward_kernel(const uint8_t* __restrict__ seg,
                       const uint8_t* __restrict__ table,
                       int32_t* __restrict__ decs,
                       int32_t* __restrict__ final_metrics, int B, int T,
                       int n, int init_value) {
  using S = FwdShape<K, LOGNS, LOGC>;
  constexpr int E = S::E, NS = S::NS, G = S::G, C = S::C, CPW = S::CPW;
  constexpr int DPL = S::DPL, NGL = S::NGL, U = S::U, W = S::W, KW = S::KW;
  constexpr int R = S::R, LW = S::LW, WPL = S::WPL, NLD = S::NLD;
  constexpr bool kSmallE = S::kSmallE, kShfl = S::kShfl, kTree = S::kTree;
  static_assert(HAM == 0 || kSmallE, "the byte-permute metric needs k <= 3");
  // Metrics of the last step, double-buffered: [parity][channel][NS].
  __shared__ __align__(16) int32_t mrow[kShfl ? 4 : 2 * CPW * NS];
  __shared__ int32_t stage[CPW * R * KW];     // [channel][step][k][W]
  __shared__ int32_t segs[CPW * (R + 1)];     // [channel][step]
  __shared__ int32_t se_row[kSmallE ? 1 : E];  // seg_e, k >= 4
  __shared__ uint2 pop_tab[8];                // D_x, x < 8 (HAM = 1)

  const int lane = threadIdx.x;
  const int c = lane >> LOGC;      // the lane's channel in the warp
  const int l = lane & (C - 1);    // its lane in the channel
  const int ch0 = blockIdx.x * CPW;
  const int ch = ch0 + c;
  const int first = l * DPL;       // its first destination
  const int grp0 = first >> K;     // its first group
  const int lane0 = c << LOGC;     // its channel's first lane

  // Lane constants: seg_d of its destinations (HAM: as prmt selectors),
  // seg_e.
  int sd[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    sd[i] = table[first + i] | (HAM ? 0x8880 : 0);
  }
  int se[kSmallE ? E : 1];
  if constexpr (kSmallE) {
#pragma unroll
    for (int e = 0; e < E; ++e) se[e] = table[NS + e];
  } else {
    for (int e = lane; e < E; e += 32) se_row[e] = table[NS + e];
  }
  if constexpr (HAM) {
    if (lane < 8) {
      unsigned lo = 0, hi = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        lo |= (unsigned)__popc(lane ^ b) << (8 * b);
        hi |= (unsigned)__popc(lane ^ (b + 4)) << (8 * b);
      }
      pop_tab[lane] = make_uint2(lo, hi);
    }
  }

  int m[DPL];  // this lane's destinations' metrics after the last step
#pragma unroll
  for (int i = 0; i < DPL; ++i) m[i] = (first + i == 0) ? 0 : init_value;
  int par = 0;
  if constexpr (!kShfl) store_run<DPL>(mrow + c * NS + first, m);

  // Segments: a chunk's R bytes of each channel, fetched into registers one
  // chunk ahead and staged in shared memory at the chunk's start.
  int pre[NLD];
  auto fetch = [&](int t0) {
#pragma unroll
    for (int j = 0; j < NLD; ++j) {
      const int i = lane + 32 * j;
      const int cc = i / R, s = i % R;
      pre[j] = (i < CPW * R && ch0 + cc < B && t0 + s < T)
                   ? seg[(size_t)(ch0 + cc) * T + t0 + s]
                   : 0;
    }
  };
  fetch(0);
  __syncwarp();

  const int nmask = (1 << n) - 1;
  for (int t0 = 0; t0 < T; t0 += R) {
    const int steps = min(R, T - t0);
#pragma unroll
    for (int j = 0; j < NLD; ++j) {
      const int i = lane + 32 * j;
      if (i < CPW * R) segs[(i / R) * (R + 1) + i % R] = pre[j];
    }
    __syncwarp();
    if (t0 + R < T) fetch(t0 + R);
    // A step's segment is read two steps ahead and (HAM) its tables one
    // step ahead, so that no load of a step waits on another of the same
    // step.
    int r_cur = segs[c * (R + 1)] & nmask;
    int r_nx = segs[c * (R + 1) + 1] & nmask;
    int dlo[HAM ? E : 1], dhi[HAM ? E : 1];
    if constexpr (HAM) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const uint2 t = pop_tab[r_cur ^ se[e]];
        dlo[e] = (int)t.x;
        dhi[e] = (int)t.y;
      }
    }
    // Plane b's fields (1 < DPL < 32), joined across their LW lanes and
    // staged at the end of the step or (DEFER) during the next one, off
    // its chain.
    unsigned fld[kTree ? K : 1] = {};
    auto join = [&](int s) {
#pragma unroll
      for (int b = 0; b < (kTree ? K : 0); ++b) {
        unsigned f = fld[b];
#pragma unroll
        for (int x = 1; x < LW; x <<= 1) f |= __shfl_xor_sync(kFullMask, f, x);
        if (s >= 0 && (l & (LW - 1)) == 0) {
          stage[(c * R + s) * KW + b * W + (first >> 5)] = (int)f;
        }
      }
    };
#pragma unroll (UNROLL)
    for (int s = 0; s < steps; ++s) {
      const int r = r_cur;
      int lo[HAM ? E : 1], hi[HAM ? E : 1];
      if constexpr (HAM) {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          lo[e] = dlo[e];
          hi[e] = dhi[e];
          const uint2 t = pop_tab[r_nx ^ se[e]];
          dlo[e] = (int)t.x;
          dhi[e] = (int)t.y;
        }
      }
      r_cur = r_nx;
      r_nx = segs[c * (R + 1) + min(s + 2, R - 1)] & nmask;
      const int32_t* src = mrow + par * CPW * NS + c * NS;
      if constexpr (DEFER) join(s - 1);
      int idx[DPL];
      if constexpr (kSmallE) {
        // Sources: the 2^k sources of the lane's q-th group in v[q][e].
        int v[NGL][E];
#pragma unroll
        for (int e = 0; e < E; ++e) {
          if constexpr (kShfl) {
            v[0][e] = __shfl_sync(kFullMask, m[0], lane0 + grp0 + e * G);
          } else {
            int run[NGL];
            load_run<NGL>(src + e * G + grp0, run);
#pragma unroll
            for (int q = 0; q < NGL; ++q) v[q][e] = run[q];
          }
        }
#pragma unroll
        for (int q = 0; q < NGL; ++q) {
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int i = q * U + u;
            int cand[E];
#pragma unroll
            for (int e = 0; e < E; ++e) {
              const int bm = HAM ? prmt(lo[e], hi[e], sd[i])
                                 : __popc(r ^ sd[i] ^ se[e]);
              cand[e] = v[q][e] + bm;
            }
            argmin_tree<E>(cand, m[i], idx[i]);
          }
        }
      } else {
        // One group's sources, eight at a time: broadcasts from the row,
        // or shuffles.
        const int mine = m[0];
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          m[i] = INT_MAX;
          idx[i] = 0;
        }
#pragma unroll 2
        for (int e0 = 0; e0 < E; e0 += 8) {
          int sv[8], sev[8];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            sv[j] = kShfl ? __shfl_sync(kFullMask, mine,
                                        lane0 + grp0 + (e0 + j) * G)
                          : src[grp0 + (e0 + j) * G];
            sev[j] = se_row[e0 + j];
          }
#pragma unroll
          for (int i = 0; i < DPL; ++i) {
            const int rd = r ^ sd[i];
            int cand[8], best, at;
#pragma unroll
            for (int j = 0; j < 8; ++j) cand[j] = sv[j] + __popc(rd ^ sev[j]);
            argmin_tree<8>(cand, best, at);
            if (best < m[i]) {
              m[i] = best;
              idx[i] = e0 + at;
            }
          }
        }
      }
      if constexpr (!kShfl) {
        store_run<DPL>(mrow + (par ^ 1) * CPW * NS + c * NS + first, m);
        par ^= 1;
      }

      // Decision words: plane b's bits of the lane's destinations.
      int32_t* st = stage + (c * R + s) * KW;
#pragma unroll
      for (int b = 0; b < K; ++b) {
        if constexpr (DPL >= 32) {
#pragma unroll
          for (int w = 0; w < WPL; ++w) {
            unsigned word = 0;
#pragma unroll
            for (int p = 0; p < 32; ++p) {
              word |= (unsigned)((idx[w * 32 + p] >> b) & 1) << p;
            }
            st[b * W + (first >> 5) + w] = (int)word;
          }
        } else if constexpr (DPL == 1) {
          const unsigned bal = __ballot_sync(kFullMask, (idx[0] >> b) & 1);
          if (l == 0) {
            st[b * W + (first >> 5)] =
                (int)(C == 32 ? bal : (bal >> (c * C)) & ((1u << C) - 1u));
          }
        } else {
          unsigned field = 0;
#pragma unroll
          for (int i = 0; i < DPL; ++i) {
            field |= (unsigned)((idx[i] >> b) & 1) << i;
          }
          fld[b] = field << (first & 31);
        }
      }
      // Every lane's metrics of this step are in the row, and every lane
      // has read this step's sources (with shuffles, the chunk's last
      // __syncwarp orders the staged words).
      if constexpr (!DEFER) join(s);
      if constexpr (!kShfl) __syncwarp();
    }
    if constexpr (DEFER) join(steps - 1);
    __syncwarp();
    // The chunk's words: each channel's steps * k W words are contiguous.
    if (steps == R) {
      constexpr int RUN = R * KW;
#pragma unroll 4
      for (int i = lane; i < CPW * RUN; i += 32) {
        const int cc = i / RUN;
        if (ch0 + cc < B) {
          decs[((size_t)(ch0 + cc) * T + t0) * KW + (i - cc * RUN)] =
              stage[i];
        }
      }
    } else {
      const int run = steps * KW;
#pragma unroll 1
      for (int cc = 0; cc < CPW && ch0 + cc < B; ++cc) {
        int32_t* out = decs + ((size_t)(ch0 + cc) * T + t0) * KW;
        const int32_t* from = stage + cc * R * KW;
        for (int i = lane; i < run; i += 32) out[i] = from[i];
      }
    }
    __syncwarp();
  }
  if (ch < B) store_run<DPL>(final_metrics + (size_t)ch * NS + first, m);
}

template <int K, int LOGNS, int LOGC, int DEFER, int UNROLL>
int launch_forward(const void* seg, const void* table, void* decs,
                   void* final_metrics, int B, int T, int n, int init_value,
                   cudaStream_t s) {
  using S = FwdShape<K, LOGNS, LOGC>;
  const dim3 grid((B + S::CPW - 1) / S::CPW);
  const auto* seg8 = static_cast<const uint8_t*>(seg);
  const auto* table8 = static_cast<const uint8_t*>(table);
  auto* planes = static_cast<int32_t*>(decs);
  auto* fm = static_cast<int32_t*>(final_metrics);
  if constexpr (S::kSmallE) {
    if (n <= 3) {
      generic_forward_kernel<K, LOGNS, LOGC, DEFER, UNROLL, 1><<<grid, 32, 0, s>>>(
          seg8, table8, planes, fm, B, T, n, init_value);
      return static_cast<int>(cudaGetLastError());
    }
  }
  generic_forward_kernel<K, LOGNS, LOGC, DEFER, UNROLL, 0><<<grid, 32, 0, s>>>(
      seg8, table8, planes, fm, B, T, n, init_value);
  return static_cast<int>(cudaGetLastError());
}

// The admitted shapes, NS = 2^(k S) <= 1024 with k <= 8, each one's lanes
// a channel, log2 (the third argument), whether its words are joined a
// step late (the fourth) and its steps unrolled (the fifth), as measured
// fastest (PERF.md §6).
// tests/test_torch_generic.py and chip_smoke.py read this switch.
int launch_generic_forward(const void* seg, const void* table, void* decs,
                           void* final_metrics, int B, int T, int k, int NS,
                           int n, int init_value, cudaStream_t s) {
  const int key = k * 2048 + NS;
#define GENERIC_ARGS seg, table, decs, final_metrics, B, T, n, init_value, s
  switch (key) {
    case 1 * 2048 + 2: return launch_forward<1, 1, 1, 0, 2>(GENERIC_ARGS);
    case 1 * 2048 + 4: return launch_forward<1, 2, 2, 0, 2>(GENERIC_ARGS);
    case 1 * 2048 + 8: return launch_forward<1, 3, 3, 0, 4>(GENERIC_ARGS);
    case 1 * 2048 + 16: return launch_forward<1, 4, 4, 0, 4>(GENERIC_ARGS);
    case 1 * 2048 + 32: return launch_forward<1, 5, 5, 0, 4>(GENERIC_ARGS);
    case 1 * 2048 + 64: return launch_forward<1, 6, 5, 0, 4>(GENERIC_ARGS);
    case 1 * 2048 + 128: return launch_forward<1, 7, 5, 0, 4>(GENERIC_ARGS);
    case 1 * 2048 + 256: return launch_forward<1, 8, 5, 0, 4>(GENERIC_ARGS);
    case 1 * 2048 + 512: return launch_forward<1, 9, 5, 0, 1>(GENERIC_ARGS);
    case 1 * 2048 + 1024: return launch_forward<1, 10, 5, 0, 1>(GENERIC_ARGS);
    case 2 * 2048 + 4: return launch_forward<2, 2, 2, 0, 2>(GENERIC_ARGS);
    case 2 * 2048 + 16: return launch_forward<2, 4, 4, 0, 4>(GENERIC_ARGS);
    case 2 * 2048 + 64: return launch_forward<2, 6, 4, 0, 1>(GENERIC_ARGS);
    case 2 * 2048 + 256: return launch_forward<2, 8, 5, 0, 4>(GENERIC_ARGS);
    case 2 * 2048 + 1024: return launch_forward<2, 10, 5, 0, 2>(GENERIC_ARGS);
    case 3 * 2048 + 8: return launch_forward<3, 3, 3, 0, 4>(GENERIC_ARGS);
    case 3 * 2048 + 64: return launch_forward<3, 6, 4, 1, 4>(GENERIC_ARGS);
    case 3 * 2048 + 512: return launch_forward<3, 9, 5, 1, 2>(GENERIC_ARGS);
    case 4 * 2048 + 16: return launch_forward<4, 4, 4, 0, 4>(GENERIC_ARGS);
    case 4 * 2048 + 256: return launch_forward<4, 8, 5, 0, 1>(GENERIC_ARGS);
    case 5 * 2048 + 32: return launch_forward<5, 5, 5, 0, 4>(GENERIC_ARGS);
    case 5 * 2048 + 1024: return launch_forward<5, 10, 5, 0, 1>(GENERIC_ARGS);
    case 6 * 2048 + 64: return launch_forward<6, 6, 5, 0, 1>(GENERIC_ARGS);
    case 7 * 2048 + 128: return launch_forward<7, 7, 5, 0, 1>(GENERIC_ARGS);
    case 8 * 2048 + 256: return launch_forward<8, 8, 5, 1, 2>(GENERIC_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef GENERIC_ARGS
}

// The walk's constants at one shape: C = 2^LOGC lanes a channel, one
// segment of G = 2^LOGG steps each, so a window of WS = C G steps; CPW =
// 2^LOGCPW channels a warp (C CPW <= 32, the other lanes idle); WU
// warm-up steps.  A segment's words are staged at a pitch of P words, an
// odd number of 16-byte chunks, so that the 32 lanes' segments start in
// different banks.
template <int K_, int LOGNS_, int LOGC, int LOGCPW, int LOGG, int WU_>
struct WalkShape {
  static constexpr int K = K_;
  static constexpr int LG = LOGG;
  static constexpr int NS = 1 << LOGNS_;
  static constexpr int W = (NS + 31) / 32;
  static constexpr int KW = K * W;           // words a step
  static constexpr int C = 1 << LOGC;
  static constexpr int CPW = 1 << LOGCPW;
  static constexpr int G = 1 << LOGG;
  static constexpr int WS = C * G;
  static constexpr int Q = 8 / gcd_c(K, 8);  // steps that fill whole bytes
  static constexpr int QB = Q * K / 8;       // and their bytes
  static constexpr int UB = Q > 4 ? Q : 4;   // steps of an unrolled block
  static constexpr int SEGW = G * KW;        // words a segment
  static constexpr int P = SEGW + (SEGW % 8 == 0 ? 4 : 8);
  static constexpr int STAGE = (WS * K / 8 + 15) & ~15;  // output bytes
  static constexpr int SHIFT = LOGNS_ - K;
  static constexpr unsigned UMASK = (1u << K) - 1u;
  static constexpr int NB = 2;               // windows staged
  // A step's words are few enough to load whole (2 or 4 words a plane).
  static constexpr bool kRow = (W == 2 && KW <= 8) || (W == 4 && KW == 4);
  // Bytes of shared memory a block (one warp) takes.
  static constexpr size_t kSmem =
      ((size_t)NB * CPW * C * P * sizeof(int32_t) + (size_t)CPW * STAGE +
       8 * NB + 15) & ~(size_t)15;
  static_assert(LOGC + LOGCPW <= 5, "lanes a warp");
  static_assert(G % UB == 0 && WU_ % UB == 0, "whole unrolled blocks");
};

// One lane's walk over the staged window [lo, lo + WS) of its channel.
// `base` is the channel's staged window plus its word phase.  ROW (S::kRow
// shapes, phase 0): a step's KW words come as 16- or 8-byte vector loads
// whose addresses do not depend on the state, and the state selects among
// them.
template <class S, bool ROW>
struct Walker {
  const int32_t* base;
  int lo;

  // The words of step t.
  __device__ __forceinline__ const int32_t* row(int t) const {
    const int r = t - lo;
    return base + (r >> S::LG) * S::P + (r & (S::G - 1)) * S::KW;
  }

  // The state at step t - 1 from the state at step t, `w` step t's words.
  static __device__ __forceinline__ unsigned step(const int32_t* w,
                                                  unsigned cur) {
    unsigned e = 0u;
    if constexpr (ROW) {
      static_assert(S::kRow, "a row in vectors");
      unsigned v[S::KW];
      if constexpr (S::KW % 4 == 0) {
#pragma unroll
        for (int i = 0; i < S::KW; i += 4) {
          const int4 x = *reinterpret_cast<const int4*>(w + i);
          v[i] = x.x, v[i + 1] = x.y, v[i + 2] = x.z, v[i + 3] = x.w;
        }
      } else {
#pragma unroll
        for (int i = 0; i < S::KW; i += 2) {
          const int2 x = *reinterpret_cast<const int2*>(w + i);
          v[i] = x.x, v[i + 1] = x.y;
        }
      }
#pragma unroll
      for (int b = 0; b < S::K; ++b) {
        const unsigned* p = v + b * S::W;
        unsigned word = (cur & 32u) ? p[1] : p[0];
        if constexpr (S::W == 4) {
          word = (cur & 64u) ? ((cur & 32u) ? p[3] : p[2]) : word;
        }
        e |= ((word >> (cur & 31u)) & 1u) << b;
      }
    } else {
      const int32_t* x = w + (S::W > 1 ? (int)(cur >> 5) : 0);
#pragma unroll
      for (int b = 0; b < S::K; ++b) {
        e |= (((unsigned)x[b * S::W] >> (cur & 31u)) & 1u) << b;
      }
    }
    return (cur >> S::K) | (e << S::SHIFT);
  }

  // Step t's symbol into its byte group's accumulator (MSb first; j = t
  // mod Q), and the group's bytes to `st` once its lowest step is done.
  template <bool EMIT>
  __device__ __forceinline__ void emit(int t, int j, unsigned cur,
                                       unsigned long long& acc,
                                       uint8_t* st) const {
    if constexpr (EMIT) {
      acc |= (unsigned long long)(cur & S::UMASK) << (S::K * (S::Q - 1 - j));
      if (j == 0) {
        uint8_t* p = st + (((t - lo) * S::K) >> 3);
#pragma unroll
        for (int m = 0; m < S::QB; ++m) {
          p[m] = (uint8_t)(acc >> (8 * (S::QB - 1 - m)));
        }
        acc = 0ull;
      }
    }
  }

  // Walk steps hi - 1 down to lo_t (a multiple of UB) from `cur`, the state
  // at step hi - 1; returns the state at step lo_t - 1.  EMIT: the steps'
  // symbols go to the window's output bytes `st`.
  template <bool EMIT>
  __device__ unsigned walk(int hi, int lo_t, unsigned cur, uint8_t* st) const {
    unsigned long long acc = 0ull;
    int t = hi - 1;
    // The top block's steps above a multiple of UB, one at a time (kept a
    // loop: see block_1p.cu's warm-up).
#pragma unroll 1
    for (; t >= lo_t && ((t + 1) & (S::UB - 1)); --t) {
      emit<EMIT>(t, t & (S::Q - 1), cur, acc, st);
      cur = step(row(t), cur);
    }
#pragma unroll 1
    for (; t >= lo_t; t -= S::UB) {
      const int32_t* w = row(t);  // a block lies in one segment
#pragma unroll
      for (int s = 0; s < S::UB; ++s) {
        emit<EMIT>(t - s, (S::UB - 1 - s) & (S::Q - 1), cur, acc, st);
        cur = step(w - s * S::KW, cur);
      }
    }
    return cur;
  }
};

// The walk: each channel from state 0 at step t_actual - 1 down to step 0,
// in windows of WS steps on the grid of multiples of WS, top window first.
template <int K, int LOGNS, int LOGC, int LOGCPW, int LOGG, int WU,
          bool ROW>
__global__ void __launch_bounds__(32)
generic_walk_kernel(const int32_t* __restrict__ decs,
                    uint8_t* __restrict__ out, int B, int T_stride,
                    int t_actual, int message_bits, int emit_bytes) {
  using S = WalkShape<K, LOGNS, LOGC, LOGCPW, LOGG, WU>;
  constexpr int NB = S::NB;
  constexpr int C = S::C, CPW = S::CPW, G = S::G, WS = S::WS, P = S::P;
  constexpr int KW = S::KW;
  // [NB][CPW][C][P] staged words, [CPW][STAGE] output bytes, NB mbarriers.
  extern __shared__ __align__(16) int32_t wsm[];
  uint8_t* const stage_all =
      reinterpret_cast<uint8_t*>(wsm + NB * CPW * C * P);
  uint64_t* const bars =
      reinterpret_cast<uint64_t*>(stage_all + CPW * S::STAGE);
  if (message_bits <= 0) return;
  const int warp = blockIdx.x;  // one warp a block
  const int lane = threadIdx.x;
  const int c = lane >> LOGC;  // the lane's channel in the warp
  const int l = lane & (C - 1);
  const int cs = c < CPW ? c : 0;
  const int ch = warp * CPW + c;
  const bool live = c < CPW && ch < B;
  const size_t chan_words = (size_t)T_stride * KW;
  // The word phase of the channel's planes: every segment starts at a
  // multiple of 4 words from the channel's first, so at this phase.
  const int ph = live ? (int)((reinterpret_cast<uintptr_t>(
                                   decs + (size_t)ch * chan_words) >> 2) & 3)
                      : 0;
  const int n_win = (t_actual + WS - 1) / WS;

  // Stage window j of the warp's channels into buffer `buf`: each lane's
  // segment as one bulk copy of the 16-byte chunks that hold its words, to
  // its own row of P words; every lane arrives on the buffer's mbarrier
  // (a window past the first arrives with no copies).
  auto fetch = [&](int j, int buf) {
    const int a = j * WS + l * G;
    const int hi = min(j * WS + WS, t_actual);
    if (j >= 0 && live && a < hi) {
      const int32_t* chb = decs + (size_t)ch * chan_words;
      const uintptr_t g0 = reinterpret_cast<uintptr_t>(chb + (size_t)a * KW);
      const uintptr_t g1 =
          reinterpret_cast<uintptr_t>(chb + (size_t)min(a + G, hi) * KW);
      const uintptr_t src = g0 & ~uintptr_t(15);
      bulk_copy(wsm + ((buf * CPW + c) * C + l) * P,
                reinterpret_cast<const void*>(src),
                (unsigned)(((g1 + 15) & ~uintptr_t(15)) - src), bars + buf);
    } else {
      bar_arrive(bars + buf);
    }
  };

  if (lane == 0) {
    for (int b = 0; b < NB; ++b) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 32;\n" ::"r"(
                       smem_addr(bars + b))
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();
  unsigned top = 0u;  // the state at the window's top step
  // Window n_win - 1 - i goes to buffer i % NB, NB - 1 windows ahead.
#pragma unroll 1
  for (int i = 0; i < NB - 1; ++i) fetch(n_win - 1 - i, i);
  for (int i = 0; i < n_win; ++i) {
    const int j = n_win - 1 - i;
    const int buf = i % NB;
    if (j - (NB - 1) >= 0) fetch(j - (NB - 1), (i + NB - 1) % NB);
    bar_wait(bars + buf, (unsigned)(i / NB) & 1u);
    __syncwarp();
    const int lo = j * WS;
    const int hi = min(lo + WS, t_actual);
    const Walker<S, ROW> wk{wsm + (buf * CPW + cs) * C * P + ph, lo};
    uint8_t* const st = stage_all + cs * S::STAGE;
    const int a = lo + l * G;
    const int b = min(a + G, hi);
    const bool mine = live && a < hi;
    const bool top_seg = b == hi;  // its start is the window's top state
    // The guess: a warm-up of WU steps from state 0 above the segment, or
    // from the window's top state where the warm-up reaches the top.
    unsigned start = top;
    if (mine && !top_seg) {
      const int t0 = min(b - 1 + WU, hi - 1);
      start = wk.template walk<false>(t0 + 1, b, t0 == hi - 1 ? top : 0u,
                                      nullptr);
    }
    unsigned end = mine ? wk.template walk<true>(b, a, start, st) : 0u;
    // Top down: a segment whose start differs from the state the segment
    // above ended in walks again from that state, until none differs.
    for (;;) {
      const unsigned above = __shfl_down_sync(kFullMask, end, 1);
      const bool redo = mine && !top_seg && above != start;
      if (!__any_sync(kFullMask, redo)) break;
      if (redo) {
        start = above;
        end = wk.template walk<true>(b, a, start, st);
      }
    }
    top = __shfl_sync(kFullMask, end, cs << LOGC);  // state at step lo - 1
    __syncwarp();
    // The window's bits, each channel's row written by the whole warp.
    const int bit_lo = lo * K;
    const int bit_hi = min(hi * K, message_bits);
    for (int cc = 0; cc < CPW; ++cc) {
      const int chn = warp * CPW + cc;
      if (chn >= B) break;
      const uint8_t* sc = stage_all + cc * S::STAGE;
      if (emit_bytes) {
        uint8_t* orow = out + (size_t)chn * ((message_bits + 7) >> 3);
        const int byte_lo = bit_lo >> 3;
        for (int m = byte_lo + lane; m * 8 < bit_hi; m += 32) {
          unsigned v = sc[m - byte_lo];
          const int rem = bit_hi - m * 8;  // bits of the byte kept
          if (rem < 8) v &= 0xffu << (8 - rem);
          orow[m] = (uint8_t)v;
        }
      } else {
        uint8_t* orow = out + (size_t)chn * message_bits;
        for (int p = bit_lo + lane; p < bit_hi; p += 32) {
          orow[p] = (uint8_t)((sc[(p - bit_lo) >> 3] >> (7 - (p & 7))) & 1u);
        }
      }
    }
    __syncwarp();  // the buffer and the bytes are free for window j - 2
  }
}

template <int K, int LOGNS, int LOGC, int LOGCPW, int LOGG, int WU, bool ROW>
int launch_walk_kernel(const void* decs, void* out, int B, int T_stride,
                       int t_actual, int message_bits, int emit_bytes,
                       cudaStream_t s) {
  using S = WalkShape<K, LOGNS, LOGC, LOGCPW, LOGG, WU>;
  auto* kernel = generic_walk_kernel<K, LOGNS, LOGC, LOGCPW, LOGG, WU, ROW>;
  if constexpr (S::kSmem > 48 * 1024) {
    static const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::kSmem);
    if (attr != cudaSuccess) return static_cast<int>(attr);
  }
  const dim3 grid((B + S::CPW - 1) / S::CPW);
  kernel<<<grid, 32, S::kSmem, s>>>(
      static_cast<const int32_t*>(decs), static_cast<uint8_t*>(out), B,
      T_stride, t_actual, message_bits, emit_bytes);
  return static_cast<int>(cudaGetLastError());
}

// The walk at one shape: with a step's words loaded whole (S::kRow) where
// every channel's planes start 16-byte aligned.
template <int K, int LOGNS, int LOGC, int LOGCPW, int LOGG, int WU>
int launch_walk(const void* decs, void* out, int B, int T_stride,
                int t_actual, int message_bits, int emit_bytes,
                cudaStream_t s) {
  using S = WalkShape<K, LOGNS, LOGC, LOGCPW, LOGG, WU>;
  if constexpr (S::kRow) {
    if ((reinterpret_cast<uintptr_t>(decs) & 15) == 0 &&
        (size_t)T_stride * S::KW % 4 == 0) {
      return launch_walk_kernel<K, LOGNS, LOGC, LOGCPW, LOGG, WU, true>(
          decs, out, B, T_stride, t_actual, message_bits, emit_bytes, s);
    }
  }
  return launch_walk_kernel<K, LOGNS, LOGC, LOGCPW, LOGG, WU, false>(
      decs, out, B, T_stride, t_actual, message_bits, emit_bytes, s);
}

// The admitted shapes, NS = 2^(k S) <= 1024 with k <= 8, each one's walk:
// launch_walk<k, log2 NS, log2 lanes a channel, log2 channels a warp,
// log2 steps a segment, warm-up steps>, as measured
// fastest (PERF.md §6).
// tests/test_torch_generic.py and chip_smoke.py read this switch.
int launch_generic_walk(const void* decs, void* out, int B, int T_stride,
                        int t_actual, int k, int NS, int message_bits,
                        int emit_bytes, cudaStream_t s) {
  const int key = k * 2048 + NS;
#define WALK_ARGS decs, out, B, T_stride, t_actual, message_bits, emit_bytes, s
  switch (key) {
    case 1 * 2048 + 2: return launch_walk<1, 1, 5, 0, 5, 8>(WALK_ARGS);
    case 1 * 2048 + 4: return launch_walk<1, 2, 5, 0, 5, 16>(WALK_ARGS);
    case 1 * 2048 + 8: return launch_walk<1, 3, 5, 0, 5, 16>(WALK_ARGS);
    case 1 * 2048 + 16: return launch_walk<1, 4, 5, 0, 5, 24>(WALK_ARGS);
    case 1 * 2048 + 32: return launch_walk<1, 5, 5, 0, 5, 32>(WALK_ARGS);
    case 1 * 2048 + 64: return launch_walk<1, 6, 5, 0, 4, 32>(WALK_ARGS);
    case 1 * 2048 + 128: return launch_walk<1, 7, 5, 0, 3, 40>(WALK_ARGS);
    case 1 * 2048 + 256: return launch_walk<1, 8, 5, 0, 3, 48>(WALK_ARGS);
    case 1 * 2048 + 512: return launch_walk<1, 9, 5, 0, 3, 48>(WALK_ARGS);
    case 1 * 2048 + 1024: return launch_walk<1, 10, 4, 0, 3, 56>(WALK_ARGS);
    case 2 * 2048 + 4: return launch_walk<2, 2, 5, 0, 4, 8>(WALK_ARGS);
    case 2 * 2048 + 16: return launch_walk<2, 4, 5, 0, 4, 12>(WALK_ARGS);
    case 2 * 2048 + 64: return launch_walk<2, 6, 5, 0, 3, 20>(WALK_ARGS);
    case 2 * 2048 + 256: return launch_walk<2, 8, 4, 1, 2, 24>(WALK_ARGS);
    case 2 * 2048 + 1024: return launch_walk<2, 10, 4, 0, 2, 28>(WALK_ARGS);
    case 3 * 2048 + 8: return launch_walk<3, 3, 5, 0, 3, 8>(WALK_ARGS);
    case 3 * 2048 + 64: return launch_walk<3, 6, 5, 0, 3, 16>(WALK_ARGS);
    case 3 * 2048 + 512: return launch_walk<3, 9, 3, 0, 3, 24>(WALK_ARGS);
    case 4 * 2048 + 16: return launch_walk<4, 4, 5, 0, 3, 8>(WALK_ARGS);
    case 4 * 2048 + 256: return launch_walk<4, 8, 4, 0, 2, 12>(WALK_ARGS);
    case 5 * 2048 + 32: return launch_walk<5, 5, 5, 0, 3, 8>(WALK_ARGS);
    case 5 * 2048 + 1024: return launch_walk<5, 10, 2, 0, 3, 16>(WALK_ARGS);
    case 6 * 2048 + 64: return launch_walk<6, 6, 5, 0, 2, 8>(WALK_ARGS);
    case 7 * 2048 + 128: return launch_walk<7, 7, 4, 0, 3, 8>(WALK_ARGS);
    case 8 * 2048 + 256: return launch_walk<8, 8, 4, 0, 2, 8>(WALK_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef WALK_ARGS
}

// The generic kernels' limits (kernels/generic.py: generic_kernel_supports):
// k <= 8, NS = 2^(k S) <= 1024, n <= 8.
bool generic_shape_ok(int k, int NS, int n) {
  return k >= 1 && k <= 8 && NS >= 2 && NS <= 1024 && (NS & (NS - 1)) == 0 &&
         NS >= (1 << k) && n >= 1 && n <= 8;
}

}  // namespace

// seg, table, planes, final_metrics, B, T, k, NS, n, shift = (S - 1) k,
// init_value, stream.
extern "C" int acs_generic_forward(const void* seg, const void* table,
                                   void* decs, void* final_metrics, int B,
                                   int T, int k, int NS, int n, int shift,
                                   int init_value, void* stream) {
  if (!generic_shape_ok(k, NS, n) || shift < 0 || (1 << (shift + k)) != NS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_generic_forward(seg, table, decs, final_metrics, B, T, k, NS,
                                n, init_value,
                                static_cast<cudaStream_t>(stream));
}

extern "C" int acs_generic_k2_forward(const void* seg, const void* table,
                                      void* decs, void* final_metrics, int B,
                                      int T, int k, int NS, int n, int shift,
                                      int init_value, void* stream) {
  if (k != 2 || NS != 64) return static_cast<int>(cudaErrorInvalidValue);
  return acs_generic_forward(seg, table, decs, final_metrics, B, T, k, NS, n,
                             shift, init_value, stream);
}

// planes, out, B, T_stride, t_actual, k, NS, S, message_bits, emit_bytes,
// stream.
extern "C" int traceback_generic(const void* decs, void* out, int B,
                                 int T_stride, int t_actual, int k, int NS,
                                 int S, int message_bits, int emit_bytes,
                                 void* stream) {
  if (!generic_shape_ok(k, NS, 1) || S < 1 || (1 << (S * k)) != NS ||
      t_actual > T_stride) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_generic_walk(decs, out, B, T_stride, t_actual, k, NS,
                             message_bits, emit_bytes,
                             static_cast<cudaStream_t>(stream));
}

extern "C" int traceback_generic_k2(const void* decs, void* out, int B,
                                    int T_stride, int t_actual, int k, int NS,
                                    int S, int message_bits, int emit_bytes,
                                    void* stream) {
  if (k != 2 || NS != 64) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return traceback_generic(decs, out, B, T_stride, t_actual, k, NS, S,
                           message_bits, emit_bytes, stream);
}
