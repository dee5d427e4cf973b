// Generic-k block decode: the 2^k-way add-compare-select (ACS) forward pass
// and the traceback, for any rate-k/n code that is not a k = 1
// poly-symmetric butterfly (any k > 1 code, and asymmetric k = 1 codes).
//
// Four entry points, two kernel templates:
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
// The k2 entry points are the generic templates instantiated with k = 2 and
// NS = 64 fixed at compile time.  They compute what those kernels compute,
// not how: no MXU edge-metric weights, no key-packed argmin scaled by 2^k,
// no (u, s) row blocks and their per-step interleave, no binary halving
// stages in a 3-step sublane cycle, no renormalisation, no padding of T or B.
//
// Semantics (bit for bit those of ops/viterbi.viterbi_forward on
// hard_step_metrics, and of traceback_terminated):
//   destination d = s 2^k + u takes, over e = 0 .. 2^k - 1 in rising order,
//   the least of m[(d >> k) | e << (S-1)k] + popc(r ^ code(e, d)), r the
//   received segment; strict < keeps the lowest e on ties (jnp.argmin).  The
//   edge's delay register is d | e << S k and each coded bit is its parity
//   under a generator mask, so code(e, d) = seg_d[d] ^ seg_e[e] (the
//   parity is linear over XOR): NS + 2^k table bytes, not 2^k NS.  Metrics
//   start at 0 in state 0 and init_value elsewhere, int32, never
//   renormalised (exact for T n + init_value < 2^31).
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
// 36.3 MB, 0.011 ms, of bytes).
// The steps of one channel are a recurrence, so the kernel is also bound by
// the latency of one step, times T, unless enough channels are in flight.
// The traceback is a chain of dependent reads, k decision bits per step,
// through the k NS / 8 bytes of each step the forward wrote.
//
// What the design does about that: the forward runs one warp per channel;
// lane l owns destinations d = 32 j + l (lanes past NS idle when NS < 32).
// The sources of a destination lie on other lanes, so the metrics live in
// shared memory, double-buffered (one __syncwarp per step), with the edge
// table beside them; a segment comes by one shuffle from a register holding
// 32 steps' segments; the branch metric is one XOR and one __popc; each
// decision bit-plane word is one __ballot_sync, staged in shared memory and
// written by the warp as one contiguous run of k W words per step.  The
// traceback runs one thread per channel, 32 channels per warp: the warp
// copies chunks of steps of its 32 channels' planes (contiguous runs, so
// coalesced) into shared memory with cp.async, which keeps every copy of a
// chunk in flight at once, the next chunk's copies running while each
// thread walks its own channel through the current one; no step of the
// walk waits on device memory.  The k2 instantiation unrolls the 4-way
// compare and the 2-word planes.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFullMask = 0xffffffffu;
// The traceback's threads per block (one warp) and the most decision words
// it stages per channel per chunk (two chunks are staged at a time).
constexpr int kTbThreads = 32;
constexpr int kTbStageWords = 128;

__host__ __device__ inline int round16(int x) { return (x + 15) & ~15; }

// Shared memory of the forward, per block: the edge table (NS + 2^k bytes,
// rounded up to 16), then per warp two metric buffers of NS int32 and two
// staging rows of k W decision words.
template <int KC, int NSC>  // compile-time k and NS, or 0: runtime
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
acs_generic_forward_kernel(const uint8_t* __restrict__ seg,
                           const uint8_t* __restrict__ table,
                           int32_t* __restrict__ decs,
                           int32_t* __restrict__ final_metrics,
                           int B, int T, int k_rt, int NS_rt, int n,
                           int shift, int init_value) {
  const int k = KC ? KC : k_rt;
  const int NS = NSC ? NSC : NS_rt;
  const int E = 1 << k;
  const int W = (NS + 31) >> 5;
  const int KW = k * W;
  extern __shared__ __align__(16) unsigned char smem[];
  uint8_t* seg_d = smem;
  uint8_t* seg_e = smem + NS;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int32_t* m_cur = reinterpret_cast<int32_t*>(smem + round16(NS + E)) +
                   warp * (2 * NS + 2 * KW);
  int32_t* m_next = m_cur + NS;
  int32_t* stage = m_next + NS;  // [2][KW], by step parity

  for (int i = threadIdx.x; i < NS + E; i += blockDim.x) smem[i] = table[i];
  __syncthreads();
  const int ch = blockIdx.x * kWarpsPerBlock + warp;
  if (ch >= B) return;  // uniform across the warp: the ragged B edge

  for (int d = lane; d < NS; d += 32) m_cur[d] = (d == 0) ? 0 : init_value;
  __syncwarp();

  const int nmask = (1 << n) - 1;
  const uint8_t* seg_row = seg + (size_t)ch * T;
  int32_t* dec_row = decs + (size_t)ch * T * KW;
  for (int t0 = 0; t0 < T; t0 += 32) {
    const int steps = min(32, T - t0);
    const int my_seg = (lane < steps) ? seg_row[t0 + lane] : 0;
    for (int s = 0; s < steps; ++s) {
      const int r = __shfl_sync(kFullMask, my_seg, s) & nmask;
      int32_t* st = stage + (s & 1) * KW;
#pragma unroll
      for (int j = 0; j < W; ++j) {
        const int d = 32 * j + lane;
        int be = 0;
        if (d < NS) {
          const int rd = r ^ seg_d[d];
          const int base = d >> k;
          int best = m_cur[base] + __popc(rd ^ seg_e[0]);
#pragma unroll
          for (int e = 1; e < E; ++e) {
            const int c = m_cur[base | (e << shift)] + __popc(rd ^ seg_e[e]);
            if (c < best) {
              best = c;
              be = e;
            }
          }
          m_next[d] = best;
        }
#pragma unroll
        for (int b = 0; b < k; ++b) {
          const unsigned word = __ballot_sync(kFullMask, (be >> b) & 1);
          if (lane == 0) st[b * W + j] = (int32_t)word;
        }
      }
      // Every lane's metrics and staged words of this step are in place,
      // and every lane has read this step's sources.
      __syncwarp();
      int32_t* out = dec_row + (size_t)(t0 + s) * KW;
      for (int i = lane; i < KW; i += 32) out[i] = st[i];
      int32_t* tmp = m_cur;
      m_cur = m_next;
      m_next = tmp;
    }
  }
  for (int d = lane; d < NS; d += 32) {
    final_metrics[(size_t)ch * NS + d] = m_cur[d];
  }
}

// Shared memory of the traceback: two buffers of 32 channels' staged
// chunks, each of chunk * k W words plus one, so that the lanes' rows start
// in different banks.  Chunk j holds steps [t_lo, t_hi], t_hi =
// t_actual - 1 - j * chunk.
template <int KC, int NSC>
__global__ void __launch_bounds__(kTbThreads)
traceback_generic_kernel(const int32_t* __restrict__ decs,
                         uint8_t* __restrict__ out, int B, int T_stride,
                         int t_actual, int k_rt, int NS_rt, int S,
                         int message_bits, int emit_bytes, int chunk) {
  const int k = KC ? KC : k_rt;
  const int NS = NSC ? NSC : NS_rt;
  const int W = (NS + 31) >> 5;
  const int KW = k * W;
  const int pitch = chunk * KW + 1;
  extern __shared__ int32_t stage[];
  const int lane = threadIdx.x;
  const int ch0 = blockIdx.x * kTbThreads;
  const int nch = min(kTbThreads, B - ch0);
  const bool walks = lane < nch;
  const int shift = (S - 1) * k;
  const unsigned umask = (1u << k) - 1u;
  const int row_len = emit_bytes ? (message_bits + 7) / 8 : message_bits;
  uint8_t* out_row = out + (size_t)(ch0 + lane) * row_len;
  const int n_chunks = (t_actual + chunk - 1) / chunk;
  unsigned cur = 0u;
  unsigned acc = 0u;

  // Start the copies of chunk j into buffer j & 1, as one pipeline stage.
  auto fetch = [&](int j) {
    const int t_hi = t_actual - 1 - j * chunk;
    const int t_lo = max(t_hi - chunk + 1, 0);
    const int words = (t_hi - t_lo + 1) * KW;
    int32_t* buf = stage + (j & 1) * kTbThreads * pitch;
    for (int c = 0; c < nch; ++c) {
      const int32_t* src = decs + ((size_t)(ch0 + c) * T_stride + t_lo) * KW;
      int32_t* dst = buf + c * pitch;
      for (int i = lane; i < words; i += kTbThreads) {
        __pipeline_memcpy_async(dst + i, src + i, sizeof(int32_t));
      }
    }
    __pipeline_commit();
  };

  if (n_chunks > 0) fetch(0);
  for (int j = 0; j < n_chunks; ++j) {
    if (j + 1 < n_chunks) {
      fetch(j + 1);
      __pipeline_wait_prior(1);  // this thread's copies of chunk j landed
    } else {
      __pipeline_wait_prior(0);
    }
    __syncwarp();  // and every lane's
    const int t_hi = t_actual - 1 - j * chunk;
    const int t_lo = max(t_hi - chunk + 1, 0);
    const int32_t* mine = stage + (j & 1) * kTbThreads * pitch + lane * pitch;
    for (int t = t_hi; walks && t >= t_lo; --t) {
      const int32_t* w = mine + (t - t_lo) * KW + (cur >> 5);
      unsigned e = 0u;
#pragma unroll
      for (int b = 0; b < k; ++b) {
        e |= (((unsigned)w[b * W] >> (cur & 31u)) & 1u) << b;
      }
      const unsigned u = cur & umask;
#pragma unroll
      for (int i = k - 1; i >= 0; --i) {
        const int p = t * k + i;  // the symbol's bit k - 1 - i
        if (p < message_bits) {
          const unsigned bit = (u >> (k - 1 - i)) & 1u;
          if (emit_bytes) {
            acc |= bit << (7 - (p & 7));
            if ((p & 7) == 0) {
              out_row[p >> 3] = (uint8_t)acc;
              acc = 0u;
            }
          } else {
            out_row[p] = (uint8_t)bit;
          }
        }
      }
      cur = (cur >> k) | (e << shift);
    }
    __syncwarp();  // every walk is done with buffer j & 1 before chunk j + 2
  }
}

template <int KC, int NSC>
int launch_forward(const void* seg, const void* table, void* decs,
                   void* final_metrics, int B, int T, int k, int NS, int n,
                   int shift, int init_value, cudaStream_t s) {
  const int E = 1 << k;
  const int KW = k * ((NS + 31) / 32);
  const size_t smem = round16(NS + E) + (size_t)kWarpsPerBlock *
                                            (2 * NS + 2 * KW) *
                                            sizeof(int32_t);
  const dim3 block(32 * kWarpsPerBlock);
  const dim3 grid((B + kWarpsPerBlock - 1) / kWarpsPerBlock);
  acs_generic_forward_kernel<KC, NSC><<<grid, block, smem, s>>>(
      static_cast<const uint8_t*>(seg), static_cast<const uint8_t*>(table),
      static_cast<int32_t*>(decs), static_cast<int32_t*>(final_metrics), B,
      T, k, NS, n, shift, init_value);
  return static_cast<int>(cudaGetLastError());
}

template <int KC, int NSC>
int launch_traceback(const void* decs, void* out, int B, int T_stride,
                     int t_actual, int k, int NS, int S, int message_bits,
                     int emit_bytes, cudaStream_t s) {
  const int KW = k * ((NS + 31) / 32);
  const int chunk = max(1, min(64, kTbStageWords / KW));
  const size_t smem =
      2 * (size_t)kTbThreads * (chunk * KW + 1) * sizeof(int32_t);
  const dim3 block(kTbThreads);
  const dim3 grid((B + kTbThreads - 1) / kTbThreads);
  traceback_generic_kernel<KC, NSC><<<grid, block, smem, s>>>(
      static_cast<const int32_t*>(decs), static_cast<uint8_t*>(out), B,
      T_stride, t_actual, k, NS, S, message_bits, emit_bytes, chunk);
  return static_cast<int>(cudaGetLastError());
}

// The runtime kernel's limits (kernels/generic.py: generic_kernel_supports):
// with NS <= 1024 and k <= 8 the forward's shared memory stays under 48 KB.
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
  if (!generic_shape_ok(k, NS, n)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_forward<0, 0>(seg, table, decs, final_metrics, B, T, k, NS,
                              n, shift, init_value,
                              static_cast<cudaStream_t>(stream));
}

extern "C" int acs_generic_k2_forward(const void* seg, const void* table,
                                      void* decs, void* final_metrics, int B,
                                      int T, int k, int NS, int n, int shift,
                                      int init_value, void* stream) {
  if (k != 2 || NS != 64 || !generic_shape_ok(k, NS, n)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_forward<2, 64>(seg, table, decs, final_metrics, B, T, k, NS,
                               n, shift, init_value,
                               static_cast<cudaStream_t>(stream));
}

// planes, out, B, T_stride, t_actual, k, NS, S, message_bits, emit_bytes,
// stream.
extern "C" int traceback_generic(const void* decs, void* out, int B,
                                 int T_stride, int t_actual, int k, int NS,
                                 int S, int message_bits, int emit_bytes,
                                 void* stream) {
  if (!generic_shape_ok(k, NS, 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_traceback<0, 0>(decs, out, B, T_stride, t_actual, k, NS, S,
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
  return launch_traceback<2, 64>(decs, out, B, T_stride, t_actual, k, NS, S,
                                 message_bits, emit_bytes,
                                 static_cast<cudaStream_t>(stream));
}
