// Small-state k=1 butterfly add-compare-select (ACS), forward pass, hard and
// soft: NS = 2, 4, 8, 16, 32 (K = 2 ... 6).
//
// Replaces the TPU kernels `acs_forward_batch` (convolutionalencdec_tpu/
// kernels/acs_pallas.py, pallas_call at :271, body `_fwd_kernel`) and
// `acs_forward_batch_soft` (pallas_call at :489, body `_fwd_soft_kernel`):
// the unfused butterfly kernels the JAX package runs for NS < 64.  They
// compute what those kernels compute, not how: no renormalisation every 8
// steps (int32 metrics never need it, and decisions depend on metric
// differences only), no time-packed decision bytes, no padding of T or B.
//
// Semantics: bit for bit those of acs_k1.cu (hard, segments) and
// acs_soft_k1.cu (soft, LLRs conditioned as clamp(q, qlo, qclip)), that is
// ops/viterbi.viterbi_forward_butterfly and
// ops/metrics.viterbi_forward_butterfly_soft: ties keep the low source,
// int32 metrics, never renormalised.
//
// Layouts: as acs_k1.cu, with W = 1 decision word per step:
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
// (the kernel writes a 4-byte word).  With NS/2 < 32 butterflies, one
// channel per warp would keep NS/2 of 32 lanes busy (the generic kernel
// runs TOY_K3 at 300x its bound that way, PERF.md), and the card would
// wait on one step's latency per channel.
//
// What the design does about that: G = 64 / NS channels per warp.  Lane l
// serves butterfly b = l % (NS/2) of channel l / (NS/2), so every lane
// works; the next step's source metrics come by __shfl_sync within the
// channel's NS/2 lanes (width = NS/2), and one __ballot_sync per parity
// gives every channel's decision bits at once, which its lane b = 0 packs
// into the channel's word.  Every 32 steps the warp stages the G channels'
// inputs in shared memory (one coalesced run per channel) and, after the
// steps, writes the G channels' 32 decision words from shared memory, one
// contiguous 128-byte run each.  Metrics never leave registers.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 2;
constexpr int kSteps = 32;  // steps staged per chunk
constexpr unsigned kFullMask = 0xffffffffu;

template <int NS, int N>  // N = 0: hard segments, runtime n; N > 0: soft, n = N
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
acs_small_kernel(const uint8_t* __restrict__ in,
                 const int32_t* __restrict__ cb,
                 const int32_t* __restrict__ init,
                 int32_t* __restrict__ decs,
                 int32_t* __restrict__ final_metrics, int B, int T, int n,
                 int qlo, int qclip, int init_value) {
  constexpr bool kSoft = N > 0;
  constexpr int H = NS / 2;                      // lanes (butterflies) per channel
  constexpr int G = 32 / H;                      // channels per warp
  constexpr int NP = kSoft ? (N + 3) / 4 : 1;    // staged ints per step
  constexpr int kStride = kSteps * NP + 1;       // channel c starts in bank c
  constexpr unsigned kHalf = (1u << H) - 1u;     // H <= 16
  __shared__ int stage[kWarpsPerBlock][G][kStride];
  __shared__ int words[kWarpsPerBlock][G][kSteps + 1];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c = lane / H;  // the lane's channel within the warp
  const int b = lane % H;  // its butterfly
  const int ch0 = (blockIdx.x * kWarpsPerBlock + warp) * G;
  if (ch0 >= B) return;  // uniform across the warp: the ragged B edge
  const int ch = ch0 + c;
  const bool live = ch < B;  // lanes of channels past B compute and store nothing

  int lo, hi;  // metrics of source states b and b + NS/2
  if (init != nullptr && live) {
    lo = init[(size_t)ch * NS + b];
    hi = init[(size_t)ch * NS + H + b];
  } else {
    lo = (b == 0) ? 0 : init_value;
    hi = init_value;
  }
  const int cbl = cb[b];
  int sel[kSoft ? N : 1];  // soft: all ones where coded bit i of butterfly b is 1
#pragma unroll
  for (int i = 0; i < (kSoft ? N : 1); ++i) sel[i] = -((cbl >> i) & 1);
  const int nmask = (1 << n) - 1;
  // Next-step sources: state b is butterfly b / 2's destination of parity
  // b & 1, state b + NS/2 butterfly (b + H) / 2's of parity (b + H) & 1.
  const int src_lo = b >> 1, src_hi = (b + H) >> 1;
  const bool odd_lo = b & 1, odd_hi = (b + H) & 1;

  for (int t0 = 0; t0 < T; t0 += kSteps) {
    const int steps = min(kSteps, T - t0);
    __syncwarp();  // the previous chunk's reads of stage and words are done
    // Unrolled, so that the G channels' loads are in flight together.
#pragma unroll
    for (int cc = 0; cc < G; ++cc) {
      const int chc = ch0 + cc;
      if (chc >= B || lane >= steps) continue;
      if constexpr (kSoft) {
        const int8_t* src = reinterpret_cast<const int8_t*>(in) +
                            ((size_t)chc * T + t0 + lane) * (kSoft ? N : 1);
        unsigned packed[NP];
#pragma unroll
        for (int p = 0; p < NP; ++p) packed[p] = 0;
#pragma unroll
        for (int i = 0; i < (kSoft ? N : 1); ++i) {
          const int q = min(max((int)src[i], qlo), qclip);
          packed[i >> 2] |= ((unsigned)q & 0xffu) << (8 * (i & 3));
        }
#pragma unroll
        for (int p = 0; p < NP; ++p) stage[warp][cc][lane * NP + p] = (int)packed[p];
      } else {
        stage[warp][cc][lane] = in[(size_t)chc * T + t0 + lane];
      }
    }
    __syncwarp();

    // The staged inputs of step s + 1 are read during step s, off the
    // chain of dependent metric updates.
    int next[NP];
#pragma unroll
    for (int p = 0; p < NP; ++p) next[p] = stage[warp][c][p];
    for (int s = 0; s < steps; ++s) {
      int cur[NP];
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        cur[p] = next[p];
        next[p] = stage[warp][c][min(s + 1, kSteps - 1) * NP + p];
      }
      int em, emc;
      if constexpr (kSoft) {
        int q[kSoft ? N : 1];
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          const unsigned v = (unsigned)cur[p];
#pragma unroll
          for (int i = 4 * p; i < (kSoft ? N : 1) && i < 4 * p + 4; ++i) {
            q[i] = (int)(v << (24 - 8 * (i & 3))) >> 24;  // sign-extend byte
          }
        }
        int base = 0, Q = 0;
#pragma unroll
        for (int i = 0; i < (kSoft ? N : 1); ++i) {
          base += max(-q[i], 0);
          Q += abs(q[i]);
        }
        em = base;
#pragma unroll
        for (int i = 0; i < (kSoft ? N : 1); ++i) em += q[i] & sel[i];
        emc = Q - em;
      } else {
        em = __popc((cur[0] ^ cbl) & nmask);
        emc = n - em;
      }
      const int a0 = lo + em, a1 = hi + emc;
      const int b0 = lo + emc, b1 = hi + em;
      const unsigned da = __ballot_sync(kFullMask, a0 > a1);
      const unsigned db = __ballot_sync(kFullMask, b0 > b1);
      if (b == 0) {
        // Channel c's lanes are bits c*H .. c*H + H - 1 of each ballot.
        words[warp][c][s] = (int)(((da >> (c * H)) & kHalf) |
                                  (((db >> (c * H)) & kHalf) << H));
      }
      const int ne = min(a0, a1), no = min(b0, b1);
      if constexpr (H == 1) {
        lo = ne;
        hi = no;
      } else {
        const int e_lo = __shfl_sync(kFullMask, ne, src_lo, H);
        const int o_lo = __shfl_sync(kFullMask, no, src_lo, H);
        const int e_hi = __shfl_sync(kFullMask, ne, src_hi, H);
        const int o_hi = __shfl_sync(kFullMask, no, src_hi, H);
        lo = odd_lo ? o_lo : e_lo;
        hi = odd_hi ? o_hi : e_hi;
      }
    }
    __syncwarp();
#pragma unroll 1
    for (int cc = 0; cc < G; ++cc) {
      const int chc = ch0 + cc;
      if (chc < B && lane < steps) {
        decs[(size_t)chc * T + t0 + lane] = words[warp][cc][lane];
      }
    }
  }
  if (live) {
    final_metrics[(size_t)ch * NS + b] = lo;
    final_metrics[(size_t)ch * NS + H + b] = hi;
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

template <int NS, int N>
void launch(const Args& a, cudaStream_t s) {
  constexpr int per_block = kWarpsPerBlock * (64 / NS);  // channels
  const dim3 block(32 * kWarpsPerBlock);
  const dim3 grid((a.B + per_block - 1) / per_block);
  acs_small_kernel<NS, N><<<grid, block, 0, s>>>(
      a.in, a.cb, a.init, a.decs, a.final_metrics, a.B, a.T, a.n, a.qlo,
      a.qclip, a.init_value);
}

// N = 0 (hard) or n (soft, 1..8).
template <int N>
bool launch_ns(int NS, const Args& a, cudaStream_t s) {
  switch (NS) {
    case 2: launch<2, N>(a, s); return true;
    case 4: launch<4, N>(a, s); return true;
    case 8: launch<8, N>(a, s); return true;
    case 16: launch<16, N>(a, s); return true;
    case 32: launch<32, N>(a, s); return true;
    default: return false;
  }
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
  if (n < 1 || n > 8 ||
      !launch_ns<0>(NS, a, static_cast<cudaStream_t>(stream))) {
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool ok = false;
  switch (n) {
    case 1: ok = launch_ns<1>(NS, a, s); break;
    case 2: ok = launch_ns<2>(NS, a, s); break;
    case 3: ok = launch_ns<3>(NS, a, s); break;
    case 4: ok = launch_ns<4>(NS, a, s); break;
    case 5: ok = launch_ns<5>(NS, a, s); break;
    case 6: ok = launch_ns<6>(NS, a, s); break;
    case 7: ok = launch_ns<7>(NS, a, s); break;
    case 8: ok = launch_ns<8>(NS, a, s); break;
    default: break;
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
