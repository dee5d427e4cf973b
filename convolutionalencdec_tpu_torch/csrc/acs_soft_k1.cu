// Soft-decision k=1 butterfly add-compare-select (ACS), forward pass.
//
// Replaces two TPU kernels in convolutionalencdec_tpu/kernels/acs_swar.py:
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
//
// Semantics (bit for bit those of ops/metrics.viterbi_forward_butterfly_soft
// on conditioned LLRs):
//   each LLR is used as q = clamp(q, qlo, qclip), qlo = -qclip or -128;
//   cost-if-1 of coded bit j is relu(q_j), cost-if-0 is relu(-q_j);
//   em[b] sums butterfly b's costs over its n coded bits, Q = sum_j |q_j|,
//   emc = Q - em (the complement edge), then as the hard kernel:
//   dst 2b   : a0 = m[b] + em,  a1 = m[b + NS/2] + emc
//   dst 2b+1 : b0 = m[b] + emc, b1 = m[b + NS/2] + em
//   the decision is 1 only when strictly a0 > a1 (ties keep the low source),
//   the new metric is the minimum.  Metrics are int32 and never
//   renormalised: exact while T * n * 128 + init_value < 2^31 (the wrapper
//   checks it).
//
// Layouts:
//   qllrs          int8  [B, T, n]
//   cb             int32 [NS/2]      coded segment of edge (src b, input 0)
//   init           int32 [B, NS]     optional (nullptr: 0 at state 0,
//                                    init_value elsewhere)
//   decs           int32 [B, T, W]   W = NS/32, the layout of acs_k1.cu
//   final_metrics  int32 [B, NS]     natural state order
//
// What bounds it on this card: as the hard kernel, each step of each
// channel is NS/2 butterflies (4 adds, 2 compares, 2 minima each) that
// depend on the step before, and NS/8 bytes of decisions written; n LLR
// bytes come in per step instead of one segment byte.  The recurrence is
// sequential in T, so the kernel is bound by one step's latency times T
// unless enough channels are in flight to hide it.
//
// What the design does about that: the hard kernel's shape (one warp per
// channel, metrics in registers, __ballot_sync decision words, the
// butterfly permutation by __shfl_sync), with two changes:
//   - a step's n LLRs are not one aligned value: every 32 steps, lane l
//     loads step t0 + l's n bytes (the warp reads 32 n contiguous bytes),
//     conditions them once, and keeps them packed in ceil(n/4) registers;
//     each step takes them from lane s by ceil(n/4) shuffles;
//   - em = sum_j relu(-q_j) + sum_{j: bit j of cb[b] is 1} q_j, because
//     relu(q) - relu(-q) = q: the first sum and Q are per step and shared
//     by all butterflies, the second is one masked add per coded bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFullMask = 0xffffffffu;

template <int BPL, int N>  // butterflies per lane = NS / 64; n coded bits
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
acs_soft_k1_forward_kernel(const int8_t* __restrict__ qllrs,
                           const int32_t* __restrict__ cb,
                           const int32_t* __restrict__ init,
                           int32_t* __restrict__ decs,
                           int32_t* __restrict__ final_metrics,
                           int B, int T, int qlo, int qclip,
                           int init_value) {
  constexpr int NS = 64 * BPL;
  constexpr int HALF = NS / 2;
  constexpr int W = NS / 32;
  constexpr int NP = (N + 3) / 4;  // registers holding one step's LLRs
  const int lane = threadIdx.x & 31;
  const int ch = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (ch >= B) return;  // uniform across the warp: the ragged B edge

  int sel[BPL][N];  // all ones where coded bit i of butterfly 32 j + lane is 1
  int lo[BPL];      // metric of source state b = 32 j + lane
  int hi[BPL];      // metric of source state b + NS/2
#pragma unroll
  for (int j = 0; j < BPL; ++j) {
    const int b = 32 * j + lane;
    const int c = cb[b];
#pragma unroll
    for (int i = 0; i < N; ++i) sel[j][i] = -((c >> i) & 1);
    if (init != nullptr) {
      lo[j] = init[(size_t)ch * NS + b];
      hi[j] = init[(size_t)ch * NS + HALF + b];
    } else {
      lo[j] = (b == 0) ? 0 : init_value;
      hi[j] = init_value;
    }
  }

  // Next-step sources, as in acs_k1.cu: state x = 32 m + lane comes from
  // lane 16 (m & 1) + lane / 2, slot m >> 1, its even or odd destination by
  // the parity of lane.
  const int half_lane = lane >> 1;
  const bool odd = lane & 1;

  const int8_t* q_row = qllrs + (size_t)ch * T * N;
  int32_t* dec_row = decs + (size_t)ch * T * W;
  for (int t0 = 0; t0 < T; t0 += 32) {
    const int steps = min(32, T - t0);
    unsigned mine[NP];  // step t0 + lane's conditioned LLRs, byte i = q_i
#pragma unroll
    for (int p = 0; p < NP; ++p) mine[p] = 0;
    if (lane < steps) {
      const int8_t* src = q_row + (size_t)(t0 + lane) * N;
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const int q = min(max((int)src[i], qlo), qclip);
        mine[i >> 2] |= ((unsigned)q & 0xffu) << (8 * (i & 3));
      }
    }
    int buf[W];  // decision words of step t0 + lane
#pragma unroll
    for (int w = 0; w < W; ++w) buf[w] = 0;

    for (int s = 0; s < steps; ++s) {
      int q[N];
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const unsigned v = __shfl_sync(kFullMask, mine[p], s);
#pragma unroll
        for (int i = 4 * p; i < N && i < 4 * p + 4; ++i) {
          q[i] = (int)(v << (24 - 8 * (i & 3))) >> 24;  // sign-extend byte
        }
      }
      int base = 0, Q = 0;
#pragma unroll
      for (int i = 0; i < N; ++i) {
        base += max(-q[i], 0);
        Q += abs(q[i]);
      }
      int ne[BPL], no[BPL];
#pragma unroll
      for (int j = 0; j < BPL; ++j) {
        int em = base;
#pragma unroll
        for (int i = 0; i < N; ++i) em += q[i] & sel[j][i];
        const int emc = Q - em;
        const int a0 = lo[j] + em, a1 = hi[j] + emc;
        const int b0 = lo[j] + emc, b1 = hi[j] + em;
        const unsigned da = __ballot_sync(kFullMask, a0 > a1);
        const unsigned db = __ballot_sync(kFullMask, b0 > b1);
        if (lane == s) {
          buf[j] = (int)da;        // even states: i = b
          buf[BPL + j] = (int)db;  // odd states:  i = NS/2 + b
        }
        ne[j] = min(a0, a1);
        no[j] = min(b0, b1);
      }
#pragma unroll
      for (int m = 0; m < 2 * BPL; ++m) {
        const int src = 16 * (m & 1) + half_lane;
        const int e = __shfl_sync(kFullMask, ne[m >> 1], src);
        const int o = __shfl_sync(kFullMask, no[m >> 1], src);
        if (m < BPL) {
          lo[m] = odd ? o : e;
        } else {
          hi[m - BPL] = odd ? o : e;
        }
      }
    }
    if (lane < steps) {
      int32_t* dst = dec_row + (size_t)(t0 + lane) * W;
#pragma unroll
      for (int w = 0; w < W; ++w) dst[w] = buf[w];
    }
  }

#pragma unroll
  for (int j = 0; j < BPL; ++j) {
    final_metrics[(size_t)ch * NS + 32 * j + lane] = lo[j];
    final_metrics[(size_t)ch * NS + HALF + 32 * j + lane] = hi[j];
  }
}

struct Args {
  const int8_t* qllrs;
  const int32_t* cb;
  const int32_t* init;
  int32_t* decs;
  int32_t* final_metrics;
  int B, T, qlo, qclip, init_value;
};

template <int BPL, int N>
void launch(const Args& a, cudaStream_t s) {
  const dim3 block(32 * kWarpsPerBlock);
  const dim3 grid((a.B + kWarpsPerBlock - 1) / kWarpsPerBlock);
  acs_soft_k1_forward_kernel<BPL, N><<<grid, block, 0, s>>>(
      a.qllrs, a.cb, a.init, a.decs, a.final_metrics, a.B, a.T, a.qlo,
      a.qclip, a.init_value);
}

template <int BPL>
bool launch_n(int n, const Args& a, cudaStream_t s) {
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

extern "C" int acs_soft_k1_forward(const void* qllrs, const void* cb,
                                   const void* init, void* decs,
                                   void* final_metrics, int B, int T, int NS,
                                   int n, int qlo, int qclip,
                                   int init_value, void* stream) {
  const Args a{static_cast<const int8_t*>(qllrs),
               static_cast<const int32_t*>(cb),
               static_cast<const int32_t*>(init),
               static_cast<int32_t*>(decs),
               static_cast<int32_t*>(final_metrics),
               B, T, qlo, qclip, init_value};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool ok = false;
  switch (NS) {
    case 64: ok = launch_n<1>(n, a, s); break;
    case 128: ok = launch_n<2>(n, a, s); break;
    case 256: ok = launch_n<4>(n, a, s); break;
    default: break;
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
