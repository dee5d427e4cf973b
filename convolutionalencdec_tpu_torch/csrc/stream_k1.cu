// Sliding-window register-exchange decode of k=1 butterfly codes, with the
// decoder state carried in and out of every call.
//
// Replaces two TPU kernels in convolutionalencdec_tpu/kernels/acs_pallas.py,
// both `_stream_kernel_fused` (:1182): `stream_decode_batch` (pallas_call at
// :1457, hard segments) and `stream_decode_batch_soft` (pallas_call at
// :1524, int8 LLRs).  It computes what they compute, not how: no MXU edge
// metrics, no 3-stage relabelling, no two int32 register planes, no padding
// of B to 256 or of T to 48.
//
// Semantics (bit for bit those of ops/viterbi.stream_scan on k=1 codes):
//   the ACS of acs_k1.cu (hard) or acs_soft_k1.cu (soft, each LLR floored
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
// butterflies (the ACS, 6 operations, and the exchange of two 64-bit
// registers) plus an argmin over NS states for the emit, and the steps are
// a sequential recurrence.  Device memory sees only T bytes (n T soft) in
// and T bytes out per channel, so it is bound by operations and by one
// step's latency times T unless enough channels are in flight.
//
// What the design does about that: the layout of acs_k1.cu, one warp per
// channel.  Lane l owns butterflies 32 j + l (j < NS/64) and keeps both
// sources' metrics and registers in registers; the butterfly permutation
// moves the 64-bit registers by the same __shfl_sync as the metrics.  The
// argmin is off the recurrence's critical path (the next step's ACS does
// not need it), so it is not done behind every step: each step leaves one
// candidate per lane (its least metric and, for the lowest state holding
// it, 2 * state + emitted bit), and every 8 steps the warp reduces the 8
// steps' candidates with 16 independent __reduce_min_sync (the minimum
// metric, then the least key among lanes holding it).  Each lane buffers
// the symbol of step t0 + lane; the warp stores 32 steps' bytes at once.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kGroup = 8;  // steps whose argmins are reduced together
constexpr unsigned kFullMask = 0xffffffffu;
using u64 = unsigned long long;  // a survivor register; __shfl_sync moves it

// N = 0: hard segments (n given at run time); N = 1..8: soft, n = N.
template <int BPL, int N>  // butterflies per lane = NS / 64
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
stream_k1_kernel(const uint8_t* __restrict__ seg,
                 const int8_t* __restrict__ qllrs,
                 const int32_t* __restrict__ cb,
                 const int32_t* m_in, const u64* r_in,
                 uint8_t* __restrict__ sym, int32_t* m_out, u64* r_out,
                 int B, int T, int n, int W) {
  constexpr int NS = 64 * BPL;
  constexpr int HALF = NS / 2;
  constexpr int NQ = N > 0 ? N : 1;
  constexpr int NP = (NQ + 3) / 4;  // registers holding one step's LLRs
  const int lane = threadIdx.x & 31;
  const int ch = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (ch >= B) return;  // uniform across the warp: the ragged B edge

  const int nmask = (1 << n) - 1;
  const int top = W - 1;
  int cbl[BPL];
  int sel[BPL][NQ];  // soft: all ones where coded bit i of the butterfly is 1
  int lo[BPL];       // metric of source state b = 32 j + lane
  int hi[BPL];       // metric of source state b + NS/2
  u64 rlo[BPL], rhi[BPL];  // their registers
#pragma unroll
  for (int j = 0; j < BPL; ++j) {
    const int b = 32 * j + lane;
    cbl[j] = cb[b];
#pragma unroll
    for (int i = 0; i < NQ; ++i) sel[j][i] = -((cbl[j] >> i) & 1);
    lo[j] = m_in[(size_t)ch * NS + b];
    hi[j] = m_in[(size_t)ch * NS + HALF + b];
    rlo[j] = r_in[(size_t)ch * NS + b];
    rhi[j] = r_in[(size_t)ch * NS + HALF + b];
  }

  // Next-step sources, as in acs_k1.cu: state x = 32 m + lane comes from
  // lane 16 (m & 1) + lane / 2, slot m >> 1, its even or odd destination by
  // the parity of lane.
  const int half_lane = lane >> 1;
  const bool odd = lane & 1;

  const uint8_t* seg_row = (N == 0) ? seg + (size_t)ch * T : nullptr;
  const int8_t* q_row = (N > 0) ? qllrs + (size_t)ch * T * NQ : nullptr;
  uint8_t* sym_row = sym + (size_t)ch * T;
  for (int t0 = 0; t0 < T; t0 += 32) {
    const int steps = min(32, T - t0);
    // Step t0 + lane's input: the segment, or the floored LLRs packed four
    // to a register.
    unsigned mine[NP];
#pragma unroll
    for (int p = 0; p < NP; ++p) mine[p] = 0;
    if (lane < steps) {
      if constexpr (N == 0) {
        mine[0] = seg_row[t0 + lane];
      } else {
        const int8_t* src = q_row + (size_t)(t0 + lane) * NQ;
#pragma unroll
        for (int i = 0; i < NQ; ++i) {
          const int q = max((int)src[i], -127);
          mine[i >> 2] |= ((unsigned)q & 0xffu) << (8 * (i & 3));
        }
      }
    }
    unsigned symbuf = 0;  // symbol of step t0 + lane

    for (int g0 = 0; g0 < steps; g0 += kGroup) {
      int lmin[kGroup];  // per step: this lane's least new metric
      int lkey[kGroup];  // 2 * (lowest state holding it) + its oldest bit
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        const int s = g0 + k;
        lmin[k] = INT_MAX;
        lkey[k] = 0;
        if (s >= steps) continue;  // uniform across the warp
        int ne[BPL], no[BPL];
        u64 re[BPL], ro[BPL];
        if constexpr (N == 0) {
          const int r = __shfl_sync(kFullMask, (int)mine[0], s);
#pragma unroll
          for (int j = 0; j < BPL; ++j) {
            const int em = __popc((r ^ cbl[j]) & nmask);
            const int emc = n - em;
            const int a0 = lo[j] + em, a1 = hi[j] + emc;
            const int b0 = lo[j] + emc, b1 = hi[j] + em;
            ne[j] = min(a0, a1);
            no[j] = min(b0, b1);
            re[j] = (a0 > a1 ? rhi[j] : rlo[j]) << 1;
            ro[j] = ((b0 > b1 ? rhi[j] : rlo[j]) << 1) | 1ull;
          }
        } else {
          int q[NQ];
#pragma unroll
          for (int p = 0; p < NP; ++p) {
            const unsigned v = __shfl_sync(kFullMask, mine[p], s);
#pragma unroll
            for (int i = 4 * p; i < NQ && i < 4 * p + 4; ++i) {
              q[i] = (int)(v << (24 - 8 * (i & 3))) >> 24;  // sign-extend
            }
          }
          int base = 0, Q = 0;
#pragma unroll
          for (int i = 0; i < NQ; ++i) {
            base += max(-q[i], 0);
            Q += abs(q[i]);
          }
#pragma unroll
          for (int j = 0; j < BPL; ++j) {
            int em = base;
#pragma unroll
            for (int i = 0; i < NQ; ++i) em += q[i] & sel[j][i];
            const int emc = Q - em;
            const int a0 = lo[j] + em, a1 = hi[j] + emc;
            const int b0 = lo[j] + emc, b1 = hi[j] + em;
            ne[j] = min(a0, a1);
            no[j] = min(b0, b1);
            re[j] = (a0 > a1 ? rhi[j] : rlo[j]) << 1;
            ro[j] = ((b0 > b1 ? rhi[j] : rlo[j]) << 1) | 1ull;
          }
        }
#pragma unroll
        for (int m = 0; m < 2 * BPL; ++m) {
          const int src = 16 * (m & 1) + half_lane;
          const int e = __shfl_sync(kFullMask, ne[m >> 1], src);
          const int o = __shfl_sync(kFullMask, no[m >> 1], src);
          const u64 er = __shfl_sync(kFullMask, re[m >> 1], src);
          const u64 orr = __shfl_sync(kFullMask, ro[m >> 1], src);
          if (m < BPL) {
            lo[m] = odd ? o : e;
            rlo[m] = odd ? orr : er;
          } else {
            hi[m - BPL] = odd ? o : e;
            rhi[m - BPL] = odd ? orr : er;
          }
        }
        // This lane's candidate, its states in increasing order: the lo
        // slots (32 j + lane), then the hi slots (NS/2 + 32 j + lane).
#pragma unroll
        for (int j = 0; j < BPL; ++j) {
          if (lo[j] < lmin[k]) {
            lmin[k] = lo[j];
            lkey[k] = ((32 * j + lane) << 1) | (int)((rlo[j] >> top) & 1u);
          }
        }
#pragma unroll
        for (int j = 0; j < BPL; ++j) {
          if (hi[j] < lmin[k]) {
            lmin[k] = hi[j];
            lkey[k] =
                ((HALF + 32 * j + lane) << 1) | (int)((rhi[j] >> top) & 1u);
          }
        }
      }
      int mn[kGroup];
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        mn[k] = __reduce_min_sync(kFullMask, lmin[k]);
      }
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        const int key = __reduce_min_sync(
            kFullMask, lmin[k] == mn[k] ? lkey[k] : INT_MAX);
        if (lane == g0 + k) symbuf = (unsigned)key & 1u;
      }
    }
    if (lane < steps) sym_row[t0 + lane] = (uint8_t)symbuf;
  }

  int local = INT_MAX;
#pragma unroll
  for (int j = 0; j < BPL; ++j) local = min(local, min(lo[j], hi[j]));
  const int mn = __reduce_min_sync(kFullMask, local);
  const u64 wmask = (W >= 64) ? ~0ull : ((1ull << W) - 1ull);
#pragma unroll
  for (int j = 0; j < BPL; ++j) {
    const size_t b = (size_t)ch * NS + 32 * j + lane;
    m_out[b] = lo[j] - mn;
    m_out[b + HALF] = hi[j] - mn;
    r_out[b] = rlo[j] & wmask;
    r_out[b + HALF] = rhi[j] & wmask;
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

template <int BPL, int N>
void launch(const Args& a, cudaStream_t s) {
  const dim3 block(32 * kWarpsPerBlock);
  const dim3 grid((a.B + kWarpsPerBlock - 1) / kWarpsPerBlock);
  stream_k1_kernel<BPL, N><<<grid, block, 0, s>>>(
      a.seg, a.qllrs, a.cb, a.m_in, a.r_in, a.sym, a.m_out, a.r_out, a.B,
      a.T, a.n, a.W);
}

template <int BPL>
bool launch_n(int soft, int n, const Args& a, cudaStream_t s) {
  if (!soft) {
    launch<BPL, 0>(a, s);
    return true;
  }
  switch (n) {
    case 1: launch<BPL, 1>(a, s); return true;
    case 2: launch<BPL, 2>(a, s); return true;
    case 3: launch<BPL, 3>(a, s); return true;
    case 4: launch<BPL, 4>(a, s); return true;
    case 5: launch<BPL, 5>(a, s); return true;
    case 6: launch<BPL, 6>(a, s); return true;
    case 7: launch<BPL, 7>(a, s); return true;
    case 8: launch<BPL, 8>(a, s); return true;
    default: return false;
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
  bool ok = false;
  switch (NS) {
    case 64: ok = launch_n<1>(soft, n, a, s); break;
    case 128: ok = launch_n<2>(soft, n, a, s); break;
    case 256: ok = launch_n<4>(soft, n, a, s); break;
    default: break;
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
