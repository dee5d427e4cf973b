// The wide forward's round: R trellis steps of a closed group of butterflies
// in registers, one barrier a round, hard and soft (n <= 8).  Shared by the
// two-pass wide forwards of acs_wide.cu (`acs_round_kernel`,
// `acs_soft_round_kernel`, which write a round's decision words to a
// shared-memory copy and then out) and the single-pass wide decode of
// block_1p.cu (`block_1p_wide`, which writes them straight into the
// channel's region of decisions).  The design is acs_wide.cu's header's;
// kernels/_build.py rebuilds the library when this header is newer than it.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;

// Words of one step's soft edge-metric table: 16 entries of the low four
// coded bits (with the step's base), 16 of bits 4..7, then Q.
constexpr int kTabStep = 33;
constexpr int kTabQ = 32;

// int8 LLR as the route uses it: clamp(q, qlo, qclip).
__device__ __forceinline__ int condition(int8_t q, int qlo, int qclip) {
  return min(max((int)q, qlo), qclip);
}

// The edge-metric tables of a round's R steps from its conditioned LLRs
// `sq` (R * n, step-major), by threads c < 8R: thread c builds entries s
// and s + 8 (s = c % 8) of step c / 8 of each table, and Q.  With q_i the
// step's LLRs, base = sum_i relu(-q_i): entry p of the low table is base +
// the q_i of the set bits i < 4 of p, of the high one the q_i of the set
// bits i - 4 >= 0 of p, so that em = lo[p & 15] + hi[p >> 4] =
// sum_i cost(bit i of p, q_i) (ops/metrics.py), and Q = sum_i |q_i|.
// NMAX: a loop of that many LLRs, each past n skipped, which the compiler
// unrolls so that a thread's loads issue together (0: a loop of n).
template <int R, bool HI, int NMAX = 0>
__device__ __forceinline__ void build_tables(int* tab, const int* sq, int c,
                                             int n) {
  if (c >= 8 * R) return;
  const int j = c >> 3, s = c & 7;
  const int* q = sq + j * n;
  int base = 0, Q = 0, lo0 = 0, lo1 = 0, hi0 = 0, hi1 = 0;
  for (int i = 0; i < (NMAX ? NMAX : n); ++i) {
    if (NMAX && i >= n) continue;
    const int qi = q[i];
    base += max(-qi, 0);
    Q += abs(qi);
    if (i < 4) {
      lo0 += ((s >> i) & 1) ? qi : 0;
      lo1 += (((s + 8) >> i) & 1) ? qi : 0;
    } else if (HI) {
      hi0 += ((s >> (i - 4)) & 1) ? qi : 0;
      hi1 += (((s + 8) >> (i - 4)) & 1) ? qi : 0;
    }
  }
  int* t = tab + j * kTabStep;
  t[s] = base + lo0;
  t[s + 8] = base + lo1;
  if (HI) {
    t[16 + s] = hi0;
    t[24 + s] = hi1;
  }
  if (s == 0) t[kTabQ] = Q;
}

template <int LOGNS, int R>
struct Round {
  static constexpr int NS = 1 << LOGNS;
  static constexpr int H = NS / 2;
  static constexpr int W = NS / 32;
  static constexpr int G = NS >> R;      // groups = threads of the block
  static constexpr int M = 1 << R;       // metrics a thread holds
  static constexpr int HALF = M / 2;     // butterflies a thread runs a step
  static constexpr int CBW = (HALF + 3) / 4;  // packed cb registers a step
  static constexpr int Q = M / 4;        // int4 stores of a round
  static constexpr int SH = 5 - R;       // swizzle key: bits SH.. of owner
  static_assert(R >= 2 && R <= 5 && G >= 32 && G <= 1024, "shape");

  // Shared-memory word of state s after a round (its owner o = s >> R
  // stored it as quad (s >> 2) & (Q - 1), swizzled).
  static __device__ __forceinline__ int phys(int s) {
    if constexpr (Q == 1) {
      return s;
    } else {
      const int o = s >> R;
      return (o << R) | ((((s >> 2) & (Q - 1)) ^ ((o >> SH) & (Q - 1))) << 2) |
             (s & 3);
    }
  }
  // phys(c + m*G) == phys(c) + m*G: m*G moves the owner by a multiple of
  // the swizzle key's period.
  static constexpr bool kShiftInvariant =
      Q == 1 || ((G >> R) % (Q << SH)) == 0;

  // Step J of a round: the 2^(R-1) butterflies of the thread's group on
  // metrics m (order idx = k*2^J + u), their decisions into row `dec`
  // (the step's W words).  em_of(i) is the edge metric of butterfly pair
  // i's (src b, input 0) edge, total - em_of(i) its complement's.
  template <int J, class EdgeMetric>
  static __device__ __forceinline__ void step(int (&m)[M], EdgeMetric em_of,
                                              int total, int32_t* dec,
                                              int warp, int lane) {
    constexpr int GROUPS = HALF >> J;      // k values
    constexpr int DJ = NS >> (R - J);      // k stride in butterflies
    int nm[M];
    // Steps 1..3: bit u of group g = 2k + p in field 8 * (g % 4) of
    // pk[g / 4]; step 4 (R = 5): in nib[k][p].  (One form for both, with
    // 16-bit fields at step 4, measured ~4% slower at NS = 16384.)
    constexpr int NPK = (2 * GROUPS + 3) / 4;
    uint32_t pk[NPK];
#pragma unroll
    for (int w = 0; w < NPK; ++w) pk[w] = 0;
    uint32_t nib[GROUPS][2];
#pragma unroll
    for (int g = 0; g < GROUPS; ++g) nib[g][0] = nib[g][1] = 0;
#pragma unroll
    for (int i = 0; i < HALF; ++i) {
      const int em = em_of(i);
      const int lo = m[i], hi = m[i + HALF];
      const int emc = total - em;
      const int a0 = lo + em, a1 = hi + emc;
      const int b0 = lo + emc, b1 = hi + em;
      nm[2 * i] = min(a0, a1);
      nm[2 * i + 1] = min(b0, b1);
      // The decisions: the high source strictly better.
      const bool da = a0 > a1, db = b0 > b1;
      const int k = i >> J, u = i & ((1 << J) - 1);
      if constexpr (J == 0) {
        const unsigned wa = __ballot_sync(kFullMask, da);
        const unsigned wb = __ballot_sync(kFullMask, db);
        if (lane == 0) {
          dec[k * (DJ / 32) + warp] = (int)wa;
          dec[H / 32 + k * (DJ / 32) + warp] = (int)wb;
        }
      } else if constexpr (J <= 3) {
        pk[(2 * k) >> 2] |= da ? (1u << (8 * ((2 * k) & 3) + u)) : 0u;
        pk[(2 * k + 1) >> 2] |= db ? (1u << (8 * ((2 * k + 1) & 3) + u)) : 0u;
      } else {
        nib[k][0] |= (uint32_t)da << u;
        nib[k][1] |= (uint32_t)db << u;
      }
    }
    if constexpr (J >= 1 && J <= 3) {
      // Join 8 >> J lanes' fields into whole bytes; lanes owning a byte
      // store each group's.
#pragma unroll
      for (int w = 0; w < NPK; ++w) {
#pragma unroll
        for (int s = 1; (s << J) < 8; s <<= 1) {
          pk[w] |= __shfl_down_sync(kFullMask, pk[w], s) << (s << J);
        }
      }
      if ((lane & ((8 >> J) - 1)) == 0) {
        const int byte = (lane << J) >> 3;
#pragma unroll
        for (int g = 0; g < 2 * GROUPS; ++g) {
          uint8_t* base = reinterpret_cast<uint8_t*>(
              dec + (g & 1) * (H / 32) + (g >> 1) * (DJ / 32) + (warp << J));
          base[byte] = (uint8_t)(pk[g >> 2] >> (8 * (g & 3)));
        }
      }
    }
    if constexpr (J == 4) {
      // 16 bits a lane and group: each lane stores a half word.
#pragma unroll
      for (int g = 0; g < 2 * GROUPS; ++g) {
        reinterpret_cast<uint16_t*>(
            dec + (g & 1) * (H / 32) + (g >> 1) * (DJ / 32) + (warp << J))
            [lane] = (uint16_t)nib[g >> 1][g & 1];
      }
    }
#pragma unroll
    for (int i = 0; i < M; ++i) m[i] = nm[i];
  }

  // Steps 0..R-1 of a hard round (all of them when steps >= R).
  template <bool GUARD>
  static __device__ __forceinline__ void round(int (&m)[M],
                                               const uint32_t (&cbp)[R][CBW],
                                               const uint8_t* seg, int steps,
                                               int n, int nmask, int32_t* dec,
                                               int warp, int lane) {
    uint32_t r[R];
#pragma unroll
    for (int j = 0; j < R; ++j) r[j] = (!GUARD || j < steps) ? __ldg(seg + j) : 0;
    // The Hamming distance of the step's segment to the pair's coded
    // segment (byte i % 4 of cbp[J][i / 4]).
#define ACS_WIDE_STEP(J)                                                   \
    if constexpr (J < R) {                                                 \
      if (!GUARD || J < steps) {                                           \
        const uint32_t r4 = r[J] * 0x01010101u;                            \
        step<J>(                                                           \
            m,                                                             \
            [&](int i) {                                                   \
              return __popc((r4 ^ cbp[J][i >> 2]) &                        \
                            ((uint32_t)nmask << (8 * (i & 3))));           \
            },                                                             \
            n, dec + (size_t)(J) * W, warp, lane);                         \
      }                                                                    \
    }
    ACS_WIDE_STEP(0)
    ACS_WIDE_STEP(1)
    ACS_WIDE_STEP(2)
    ACS_WIDE_STEP(3)
    ACS_WIDE_STEP(4)
#undef ACS_WIDE_STEP
  }

  // Steps 0..R-1 of a soft round (all of them when steps >= R) from the
  // round's tables `tab` (kTabStep words a step): em = lo[p & 15]
  // (+ hi[p >> 4] for HI, n > 4), p the pair's packed coded byte (n <= 4:
  // its entry's byte offset in the low table).
  template <bool GUARD, bool HI>
  static __device__ __forceinline__ void soft_round(
      int (&m)[M], const uint32_t (&cbp)[R][CBW], const int* tab, int steps,
      int32_t* dec, int warp, int lane) {
#define ACS_SOFT_STEP(J)                                                   \
    if constexpr (J < R) {                                                 \
      if (!GUARD || J < steps) {                                           \
        const int* tj = tab + (J) * kTabStep;                              \
        step<J>(                                                           \
            m,                                                             \
            [&](int i) {                                                   \
              const uint32_t x =                                           \
                  __byte_perm(cbp[J][i >> 2], 0, 0x4440 | (i & 3));        \
              if constexpr (HI) {                                          \
                return tj[x & 15] + tj[16 + (x >> 4)];                     \
              } else {                                                     \
                return *reinterpret_cast<const int*>(                      \
                    reinterpret_cast<const char*>(tj) + x);                \
              }                                                            \
            },                                                             \
            tj[kTabQ], dec + (J) * W, warp, lane);                         \
      }                                                                    \
    }
    ACS_SOFT_STEP(0)
    ACS_SOFT_STEP(1)
    ACS_SOFT_STEP(2)
    ACS_SOFT_STEP(3)
    ACS_SOFT_STEP(4)
#undef ACS_SOFT_STEP
  }

  // The coded segments of thread c's butterflies, byte i % 4 of
  // cbp[j][i / 4] for butterfly pair i = k*2^j + u of step j: the segment
  // (hard, or soft with HI), or its entry's byte offset in the low table
  // (soft, n <= 4).
  template <bool SHIFT>
  static __device__ __forceinline__ void load_cb(uint32_t (&cbp)[R][CBW],
                                                 const int32_t* cb, int c) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
#pragma unroll
      for (int w = 0; w < CBW; ++w) cbp[j][w] = 0;
#pragma unroll
      for (int i = 0; i < HALF; ++i) {
        const int b =
            (c << j) + (i & ((1 << j) - 1)) + (i >> j) * (NS >> (R - j));
        const uint32_t p = (uint32_t)__ldg(cb + b) & 0xffu;
        cbp[j][i >> 2] |= (SHIFT ? p << 2 : p) << (8 * (i & 3));
      }
    }
  }

  // After a round: the thread's destinations c*2^R + u (u = idx) to the
  // metric buffer `wb` as Q int4 stores, swizzled; after the block's
  // barrier `gather` reads its next sources c + m*G back.
  static __device__ __forceinline__ void scatter(const int (&m)[M], int* wb,
                                                 int c) {
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int qs = q ^ ((c >> SH) & (Q - 1));
      reinterpret_cast<int4*>(wb)[c * Q + qs] =
          make_int4(m[4 * q], m[4 * q + 1], m[4 * q + 2], m[4 * q + 3]);
    }
  }
  static __device__ __forceinline__ void gather(int (&m)[M], const int* wb,
                                                int c, int rd_base) {
#pragma unroll
    for (int i = 0; i < M; ++i) {
      m[i] = wb[kShiftInvariant ? rd_base + i * G : phys(c + i * G)];
    }
  }
};

}  // namespace
