// Wide k=1 butterfly add-compare-select (ACS), forward pass, hard and soft:
// NS = 512 ... 16384 (K = 10 ... 15), and soft decodes with n > 8 at every
// NS.
//
// Replaces the TPU kernels `acs_forward_batch_fused` (convolutionalencdec_tpu/
// kernels/acs_pallas.py, pallas_call at :1004, body `_fwd_kernel_fused`) and
// `acs_forward_batch_fused_soft` (pallas_call at :1134) where NS > 256 or
// n > 8 (the port's acs_k1.cu and acs_soft_k1.cu compute their function at
// NS 64-256, n <= 8), and the SWAR kernels `acs_forward_batch_swar`
// (acs_swar.py:847) and `acs_forward_batch_swar_soft` (:1262), which the
// JAX package runs at any NS >= 64 with n <= 4.  It computes what they
// compute, not how: no 3-stage relabelling, no MXU edge metrics, no
// channels packed into fields, no renormalisation.
//
// Semantics: bit for bit those of acs_k1.cu (hard) and acs_soft_k1.cu
// (soft, LLRs conditioned as clamp(q, qlo, qclip)): ties keep the low
// source, int32 metrics, never renormalised (the wrappers check T against
// overflow).
//
// Layouts: as acs_k1.cu:
//   in             uint8 [B, T] segments, or int8 [B, T, n] LLRs
//   cb             int32 [NS/2]      coded segment of edge (src b, input 0)
//   init           int32 [B, NS]     optional (nullptr: 0 at state 0,
//                                    init_value elsewhere)
//   decs           int32 [B, T, W]   W = ceil(NS/32); the decision of state
//                                    s = 2b + p is bit i % 32 of word i / 32,
//                                    i = p*NS/2 + b
//   final_metrics  int32 [B, NS]     natural state order
//
// What bounds it on this card: NS/2 butterflies per step (6 int32
// operations each, and the edge metric), NS/8 bytes of decisions written
// per step: at NS = 16384, 8192 butterflies and 2 KB per step and channel.
// Operations bound it: a warp-per-channel register design (acs_k1.cu) would
// need 256 metrics per lane.
//
// What the design does about that: one block per channel, a step's NS/2
// butterflies spread over min(NS/2, 1024) threads (BPT = 1..8 butterflies
// each), the metrics double-buffered in shared memory (2 x 4 x NS bytes:
// 128 KB at NS = 16384, past the 48 KB default, so the launch raises the
// block's dynamic shared memory limit) and one __syncthreads per step.
// Thread slot j holds butterfly b = j * threads + tid, so each warp's 32
// consecutive butterflies give, by two __ballot_sync, exactly one even and
// one odd decision word, which lanes 0 and 1 store; the two destination
// metrics 2b, 2b + 1 go to shared memory as one 8-byte store (no stride-2
// bank conflict).  Every kChunk steps the block stages the channel's inputs
// in shared memory.  Soft decodes with n <= 8 take n as a template
// argument; any other n runs the runtime-n instantiation (N = 0), at any
// NS: below 64 states one warp serves the channel with lanes NS/2..31
// idle, and the step's one word holds the even and odd halves.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kChunk = 64;  // steps of inputs staged at a time
constexpr unsigned kFullMask = 0xffffffffu;

template <int BPT, int N, bool SOFT>  // N: soft n (0: runtime); hard ignores N
__global__ void __launch_bounds__(kMaxThreads)
acs_wide_kernel(const uint8_t* __restrict__ in,
                const int32_t* __restrict__ cb,
                const int32_t* __restrict__ init,
                int32_t* __restrict__ decs,
                int32_t* __restrict__ final_metrics, int T, int NS, int n,
                int qlo, int qclip, int init_value) {
  extern __shared__ int2 smem2[];  // 8-byte aligned
  int* m_cur = reinterpret_cast<int*>(smem2);
  int* m_nxt = m_cur + NS;
  int8_t* stage = reinterpret_cast<int8_t*>(m_cur + 2 * NS);
  const int H = NS / 2;
  const int W = (NS + 31) / 32;
  const int tid = threadIdx.x;
  const int threads = blockDim.x;
  const int lane = tid & 31;
  const int ch = blockIdx.x;
  const int step_bytes = SOFT ? n : 1;
  const int nmask = (1 << min(n, 8)) - 1;

  for (int s = tid; s < NS; s += threads) {
    m_cur[s] = (init != nullptr) ? init[(size_t)ch * NS + s]
                                 : (s == 0 ? 0 : init_value);
  }
  int cbl[BPT];
#pragma unroll
  for (int j = 0; j < BPT; ++j) {
    const int b = j * threads + tid;
    cbl[j] = (b < H) ? cb[b] : 0;
  }

  const uint8_t* row = in + (size_t)ch * T * step_bytes;
  int32_t* dec_row = decs + (size_t)ch * T * W;
  for (int t = 0; t < T; ++t) {
    const int k = t % kChunk;
    if (k == 0) {
      // Every read of the previous chunk ended before the last step's
      // __syncthreads (or, at t = 0, nothing was staged).
      const int len = min(kChunk, T - t) * step_bytes;
      for (int i = tid; i < len; i += threads) {
        int v = row[(size_t)t * step_bytes + i];
        if (SOFT) v = min(max((int)(int8_t)v, qlo), qclip);
        stage[i] = (int8_t)v;
      }
      __syncthreads();
    }
    // The step's edge-metric terms, the same in every thread.
    int r = 0, base = 0, Q = 0;
    int q[(SOFT && N > 0) ? N : 1];
    if constexpr (SOFT) {
      const int8_t* qs = stage + k * step_bytes;
      if constexpr (N > 0) {
#pragma unroll
        for (int i = 0; i < N; ++i) q[i] = qs[i];
#pragma unroll
        for (int i = 0; i < N; ++i) {
          base += max(-q[i], 0);
          Q += abs(q[i]);
        }
      } else {
        for (int i = 0; i < n; ++i) {
          const int qi = qs[i];
          base += max(-qi, 0);
          Q += abs(qi);
        }
      }
    } else {
      r = (uint8_t)stage[k];
    }
#pragma unroll
    for (int j = 0; j < BPT; ++j) {
      const int b = j * threads + tid;
      const bool act = b < H;  // false only for lanes NS/2..31 when NS < 64
      int em, emc;
      if constexpr (SOFT) {
        em = base;
        if constexpr (N > 0) {
#pragma unroll
          for (int i = 0; i < N; ++i) em += q[i] & -((cbl[j] >> i) & 1);
        } else {
          // The coded-bit table holds n <= 8 bits (ops/trellis.py): a
          // coded bit past the eighth is 0 and costs relu(-q), in `base`.
          const int8_t* qs = stage + k * step_bytes;
          for (int i = 0; i < min(n, 8); ++i) {
            em += (int)qs[i] & -((cbl[j] >> i) & 1);
          }
        }
        emc = Q - em;
      } else {
        em = __popc((r ^ cbl[j]) & nmask);
        emc = n - em;
      }
      const int lo = act ? m_cur[b] : 0;
      const int hi = act ? m_cur[b + H] : 0;
      const int a0 = lo + em, a1 = hi + emc;
      const int b0 = lo + emc, b1 = hi + em;
      const unsigned da = __ballot_sync(kFullMask, act && a0 > a1);
      const unsigned db = __ballot_sync(kFullMask, act && b0 > b1);
      if (act) {
        *reinterpret_cast<int2*>(m_nxt + 2 * b) =
            make_int2(min(a0, a1), min(b0, b1));
      }
      if (H >= 32) {
        // Butterflies j * threads + 32 w .. + 31 of warp w: even word
        // (j * threads + 32 w) / 32, odd word H/32 + that.
        const int w_even = (j * threads + (tid & ~31)) >> 5;
        if (lane < 2) {
          dec_row[(size_t)t * W + w_even + (lane ? (H >> 5) : 0)] =
              (int)(lane ? db : da);
        }
      } else if (tid == 0) {
        const unsigned half = (1u << H) - 1u;
        dec_row[t] = (int)((da & half) | ((db & half) << H));
      }
    }
    __syncthreads();
    int* swap = m_cur;
    m_cur = m_nxt;
    m_nxt = swap;
  }
  for (int s = tid; s < NS; s += threads) {
    final_metrics[(size_t)ch * NS + s] = m_cur[s];
  }
}

struct Args {
  const uint8_t* in;
  const int32_t* cb;
  const int32_t* init;
  int32_t* decs;
  int32_t* final_metrics;
  int B, T, NS, n, qlo, qclip, init_value;
};

template <int BPT, int N, bool SOFT>
int launch(const Args& a, int threads, size_t smem, cudaStream_t s) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        acs_wide_kernel<BPT, N, SOFT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  acs_wide_kernel<BPT, N, SOFT><<<a.B, threads, smem, s>>>(
      a.in, a.cb, a.init, a.decs, a.final_metrics, a.T, a.NS, a.n, a.qlo,
      a.qclip, a.init_value);
  return static_cast<int>(cudaGetLastError());
}

template <int N, bool SOFT>
int launch_bpt(int bpt, const Args& a, int threads, size_t smem,
               cudaStream_t s) {
  switch (bpt) {
    case 1: return launch<1, N, SOFT>(a, threads, smem, s);
    case 2: return launch<2, N, SOFT>(a, threads, smem, s);
    case 4: return launch<4, N, SOFT>(a, threads, smem, s);
    case 8: return launch<8, N, SOFT>(a, threads, smem, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Threads, butterflies per thread and shared memory of a launch at NS; false
// for an NS the kernel does not take (a power of two in [2, 16384]).
bool shape(const Args& a, int step_bytes, int* threads, int* bpt,
           size_t* smem) {
  if (a.NS < 2 || a.NS > 16384 || (a.NS & (a.NS - 1)) != 0) return false;
  const int H = a.NS / 2;
  *threads = H < 32 ? 32 : (H < kMaxThreads ? H : kMaxThreads);
  *bpt = H < 32 ? 1 : H / *threads;
  *smem = (size_t)2 * a.NS * sizeof(int) +
          (((size_t)kChunk * step_bytes + 15) & ~(size_t)15);
  return true;
}

}  // namespace

extern "C" int acs_wide_forward(const void* seg, const void* cb,
                                const void* init, void* decs,
                                void* final_metrics, int B, int T, int NS,
                                int n, int init_value, void* stream) {
  const Args a{static_cast<const uint8_t*>(seg),
               static_cast<const int32_t*>(cb),
               static_cast<const int32_t*>(init),
               static_cast<int32_t*>(decs),
               static_cast<int32_t*>(final_metrics),
               B, T, NS, n, 0, 0, init_value};
  int threads, bpt;
  size_t smem;
  if (n < 1 || n > 8 || !shape(a, 1, &threads, &bpt, &smem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_bpt<0, false>(bpt, a, threads, smem,
                              static_cast<cudaStream_t>(stream));
}

extern "C" int acs_soft_wide_forward(const void* qllrs, const void* cb,
                                     const void* init, void* decs,
                                     void* final_metrics, int B, int T,
                                     int NS, int n, int qlo, int qclip,
                                     int init_value, void* stream) {
  const Args a{static_cast<const uint8_t*>(qllrs),
               static_cast<const int32_t*>(cb),
               static_cast<const int32_t*>(init),
               static_cast<int32_t*>(decs),
               static_cast<int32_t*>(final_metrics),
               B, T, NS, n, qlo, qclip, init_value};
  int threads, bpt;
  size_t smem;
  if (n < 1 || !shape(a, n, &threads, &bpt, &smem) || smem > 232448) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 1: return launch_bpt<1, true>(bpt, a, threads, smem, s);
    case 2: return launch_bpt<2, true>(bpt, a, threads, smem, s);
    case 3: return launch_bpt<3, true>(bpt, a, threads, smem, s);
    case 4: return launch_bpt<4, true>(bpt, a, threads, smem, s);
    case 5: return launch_bpt<5, true>(bpt, a, threads, smem, s);
    case 6: return launch_bpt<6, true>(bpt, a, threads, smem, s);
    case 7: return launch_bpt<7, true>(bpt, a, threads, smem, s);
    case 8: return launch_bpt<8, true>(bpt, a, threads, smem, s);
    default: return launch_bpt<0, true>(bpt, a, threads, smem, s);
  }
}
