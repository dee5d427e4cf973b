// Hard-decision k=1 butterfly add-compare-select (ACS), forward pass.
//
// Replaces the TPU kernel `acs_forward_batch_swar` in
// convolutionalencdec_tpu/kernels/acs_swar.py (its pallas_call at :847,
// kernel body `_fwd_kernel_swar` -> `_fwd_chunk_body_swar` -> `_acs_swar`).
// It computes what that kernel computes, not how: no channel packing into
// 8-bit fields, no renormalisation, no padding of T or B.
//
// Semantics (bit for bit those of ops/viterbi.viterbi_forward_butterfly):
//   butterfly b has sources b and b + NS/2 and destinations 2b and 2b+1;
//   em = popc((seg ^ cb[b]) & (2^n - 1)), its complement n - em;
//   dst 2b   : a0 = m[b] + em,  a1 = m[b + NS/2] + (n - em)
//   dst 2b+1 : b0 = m[b] + (n - em),  b1 = m[b + NS/2] + em
//   the decision is 1 only when strictly a0 > a1 (ties keep the low source),
//   the new metric is the minimum.  int32 metrics, never renormalised, are
//   exact for any T below 2^31 / n.
//
// Layouts:
//   seg            uint8 [B, T]
//   cb             int32 [NS/2]      coded segment of edge (src b, input 0)
//   init           int32 [B, NS]     optional (nullptr: 0 at state 0,
//                                    init_value elsewhere)
//   decs           int32 [B, T, W]   W = NS/32 decision words per step;
//                                    the decision of state s = 2b + p is bit
//                                    i % 32 of word i / 32, i = p*NS/2 + b
//   final_metrics  int32 [B, NS]     natural state order
//
// What bounds it on this card: each step of each channel does NS/2
// butterflies (2 compares, 4 adds) and writes NS/8 bytes of decisions, which
// the traceback then reads back.  At the main-path size (B = 2048 channels,
// T = 2054 steps, NS = 64) that is 2048 * 2054 * 8 B = 33.7 MB of decisions
// written, and 64 ACS per step per channel.  The steps of one channel are a
// sequential recurrence, so the kernel is bound by the latency of one step,
// times T, unless enough channels are in flight to hide it.
//
// What the design does about that: one warp per channel.  Lane l owns the
// NS/64 butterflies b = 32 j + l (j < NS/64) and keeps both source metrics
// in registers.  Each step:
//   - the segment comes by one shuffle from a register that holds 32 steps
//     of the channel's segments (one coalesced load per 32 steps);
//   - two __ballot_sync per butterfly slot give whole decision words (at
//     NS = 64 exactly one 64-bit word per channel per step, the reference C
//     codebase's layout), kept by lane (t % 32) until 32 steps are done and
//     then written by all lanes as one contiguous run of 32 * W words;
//   - the butterfly permutation to the next step's sources is done by
//     __shfl_sync, with no shared memory.
// Metrics never leave registers; device memory sees only segments in and
// decisions out.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFullMask = 0xffffffffu;

template <int BPL>  // butterflies per lane = NS / 64
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
acs_k1_forward_kernel(const uint8_t* __restrict__ seg,
                      const int32_t* __restrict__ cb,
                      const int32_t* __restrict__ init,
                      int32_t* __restrict__ decs,
                      int32_t* __restrict__ final_metrics,
                      int B, int T, int n, int init_value) {
  constexpr int NS = 64 * BPL;
  constexpr int HALF = NS / 2;
  constexpr int W = NS / 32;
  const int lane = threadIdx.x & 31;
  const int ch = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (ch >= B) return;  // uniform across the warp: the ragged B edge

  const int nmask = (1 << n) - 1;
  int cbl[BPL];
  int lo[BPL];  // metric of source state b = 32 j + lane
  int hi[BPL];  // metric of source state b + NS/2
#pragma unroll
  for (int j = 0; j < BPL; ++j) {
    const int b = 32 * j + lane;
    cbl[j] = cb[b];
    if (init != nullptr) {
      lo[j] = init[(size_t)ch * NS + b];
      hi[j] = init[(size_t)ch * NS + HALF + b];
    } else {
      lo[j] = (b == 0) ? 0 : init_value;
      hi[j] = init_value;
    }
  }

  // The source lane of next-step state x = 32 m + lane (m < 2 * BPL) is the
  // lane of butterfly q = x >> 1 = 16 m + (lane >> 1): lane q % 32 =
  // 16 (m & 1) + (lane >> 1), slot q / 32 = m >> 1; the metric is that
  // butterfly's even destination when x is even, its odd one when x is odd.
  const int half_lane = lane >> 1;
  const bool odd = lane & 1;

  const uint8_t* seg_row = seg + (size_t)ch * T;
  int32_t* dec_row = decs + (size_t)ch * T * W;
  for (int t0 = 0; t0 < T; t0 += 32) {
    const int steps = min(32, T - t0);
    const int my_seg = (lane < steps) ? seg_row[t0 + lane] : 0;
    int buf[W];  // decision words of step t0 + lane
#pragma unroll
    for (int w = 0; w < W; ++w) buf[w] = 0;

    for (int s = 0; s < steps; ++s) {
      const int r = __shfl_sync(kFullMask, my_seg, s);
      int ne[BPL], no[BPL];
#pragma unroll
      for (int j = 0; j < BPL; ++j) {
        const int em = __popc((r ^ cbl[j]) & nmask);
        const int emc = n - em;
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

}  // namespace

extern "C" int acs_k1_forward(const void* seg, const void* cb,
                              const void* init, void* decs,
                              void* final_metrics, int B, int T, int NS,
                              int n, int init_value, void* stream) {
  const dim3 block(32 * kWarpsPerBlock);
  const dim3 grid((B + kWarpsPerBlock - 1) / kWarpsPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* seg_p = static_cast<const uint8_t*>(seg);
  const auto* cb_p = static_cast<const int32_t*>(cb);
  const auto* init_p = static_cast<const int32_t*>(init);
  auto* decs_p = static_cast<int32_t*>(decs);
  auto* fm_p = static_cast<int32_t*>(final_metrics);
  switch (NS) {
    case 64:
      acs_k1_forward_kernel<1><<<grid, block, 0, s>>>(
          seg_p, cb_p, init_p, decs_p, fm_p, B, T, n, init_value);
      break;
    case 128:
      acs_k1_forward_kernel<2><<<grid, block, 0, s>>>(
          seg_p, cb_p, init_p, decs_p, fm_p, B, T, n, init_value);
      break;
    case 256:
      acs_k1_forward_kernel<4><<<grid, block, 0, s>>>(
          seg_p, cb_p, init_p, decs_p, fm_p, B, T, n, init_value);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
