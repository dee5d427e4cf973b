// Wide k=1 butterfly add-compare-select (ACS), forward pass: hard decodes at
// NS = 512 ... 16384 (K = 10 ... 15), soft decodes there and with n > 8 at
// every NS.
//
// Replaces the TPU kernels `acs_forward_batch_fused` (convolutionalencdec_tpu/
// kernels/acs_pallas.py, pallas_call at :1004, body `_fwd_kernel_fused`) and
// `acs_forward_batch_fused_soft` (pallas_call at :1134) where NS > 256 or
// n > 8 (the port's acs_soft_k1.cu computes their function at
// NS 64-256, n <= 8), and the SWAR kernels `acs_forward_batch_swar`
// (acs_swar.py:847) and `acs_forward_batch_swar_soft` (:1262), which the
// JAX package runs at any NS >= 64 with n <= 4.  It computes what they
// compute, not how: no 3-stage relabelling, no MXU edge metrics, no
// channels packed into fields, no renormalisation.
//
// Semantics: bit for bit those of acs_soft_k1.cu's hard and soft entries
// (soft, LLRs conditioned as clamp(q, qlo, qclip)): ties keep the low
// source, int32 metrics, never renormalised (the wrappers check T against
// overflow).
//
// Layouts: as acs_soft_k1.cu:
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
// Operations bound it: a warp-per-channel register design (acs_soft_k1.cu) would
// need 256 metrics per lane.
//
// The hard forward (`acs_round_kernel`): R trellis steps a round in
// registers, one barrier a round.  Butterfly b takes sources b and b + H
// (H = NS/2) and writes states 2b, 2b + 1.  With G = NS >> R, group c
// (0 <= c < G) is closed over R steps: it starts from the 2^R sources
// c + m*G and reaches only the 2^R destinations c*2^R + u.  Step j of the
// round runs its butterflies b = c*2^j + u + k*(NS >> (R - j)), u < 2^j,
// k < 2^(R-j-1).  Thread c owns group c for the whole decode: its metrics
// sit in registers in the order idx = k*2^j + u, so every step pairs
// registers i and i + 2^(R-1) and writes registers 2i and 2i + 1, the same
// renaming at every step; the coded segments of its R * 2^(R-1) butterflies
// are loaded once, packed four to a register.  After R steps the thread holds
// states c*2^R .. c*2^R + 2^R - 1, stores them to shared memory as int4
// (XOR-swizzled so that no two lanes of a quarter warp share a bank), and
// after one __syncthreads reads its next sources c + m*G, consecutive lanes
// on consecutive words; the metrics are double-buffered, so one barrier a
// round suffices.  Decision words keep the layout above: lane l of warp w
// holds c = 32w + l, so for fixed (j, k, p) the warp's 32 * 2^j decisions
// are 2^j aligned words starting at word (p*H + k*(NS >> (R-j)) +
// 32w*2^j) / 32, lane l's 2^j decisions (its butterflies u = 0 .. 2^j - 1)
// at bits l*2^j ...  At j = 0 a ballot is a word.  At j = 1..3 each lane
// packs every group's 2^j bits into 8-bit fields of a few registers,
// neighbours' fields join by one __shfl_down_sync a register and stage
// into whole bytes, and each lane owning a byte stores it; at j = 4
// (R = 5) each lane stores its 16 bits.  The stores go to a shared-memory
// copy of the round's R steps of words (contiguous in `decs`, double-
// buffered), which the block writes out after the round's barrier, 8 bytes
// a thread.  A block serves a channel with G threads; the segments are
// read with __ldg, the same address in every lane.  The last round runs
// T mod R steps, each guarded.  R is 4 up to NS = 8192 and 5 at 16384
// (512 threads of 128 registers, 148 KB of shared memory: one block fills
// an SM), as measured (PERF.md section 6); there, at R = 4, the decisions
// took ~45% of the time, the exchange and barrier ~18%, the
// add-compare-selects the rest.
//
// The round (`Round`: its hard and soft steps, the exchange; the soft
// tables) lives in acs_round.cuh, which block_1p.cu's wide template
// shares.
//
// The soft forward at NS = 512 ... 16384, n <= 8 (`acs_soft_round_kernel`):
// the same rounds, groups, exchange and decision words, with R in its own
// dispatch switch: 4 up to NS = 8192 and 5 at 16384, as measured (PERF.md
// section 6; R = 5 spills ~140 bytes there and still wins, R = 3 and 5
// lose below).  Only the edge metric differs.  All butterflies of a step share its
// conditioned LLRs q_i: the edge (src b, input 0) costs em = base +
// sum of q_i over the set bits i of b's coded segment p (base = sum_i
// relu(-q_i)), its complement Q - em (Q = sum_i |q_i|).  So once a round,
// 8R threads build from the round's R * n LLRs a shared-memory table a
// step: 16 entries of base + the low four bits' sum, for n > 4 16 more of
// bits 4..7, and Q.  A butterfly then costs one byte extraction and one
// table load (n <= 4: the packed byte is already the entry's byte offset;
// the 16 entries lie in 16 banks) where the hard one pays a popcount.
// The round's LLRs arrive two rounds ahead: thread c < R * n loads byte c
// of round r + 2 as round r starts and stores it, conditioned, before
// round r's barrier, when the table threads read round r + 1's.  Tables and
// LLRs are double-buffered, so the round keeps its one barrier.
//
// The soft forward for n > 8 (`acs_soft_wide_kernel`, at any NS): one
// block per channel, a step's NS/2 butterflies spread over min(NS/2,
// 1024) threads (BPT = 1..8 butterflies each), the metrics double-buffered
// in shared memory (2 x 4 x NS bytes: 128 KB at NS = 16384, past the 48 KB
// default, so the launch raises the block's dynamic shared memory limit)
// and one __syncthreads per step.  Thread slot j holds butterfly b = j *
// threads + tid, so each warp's 32 consecutive butterflies give, by two
// __ballot_sync, exactly one even and one odd decision word, which lanes 0
// and 1 store; the two destination metrics 2b, 2b + 1 go to shared memory
// as one 8-byte store (no stride-2 bank conflict).  Every kChunk steps the
// block stages the channel's inputs in shared memory.  Below 64 states one
// warp serves the channel with lanes NS/2..31 idle, and the step's one
// word holds the even and odd halves.

#include <cuda_runtime.h>
#include <stdint.h>

#include "acs_round.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kChunk = 64;  // steps of soft inputs staged at a time

// ---------------------------------------------------------------------------
// The hard forward: R steps a round in registers (`Round`, acs_round.cuh).

// words int32 of src to dst, int2 at a time (words even, both 8-aligned),
// by the G threads of the block.
template <int G>
__device__ __forceinline__ void copy_words(const int32_t* src, int32_t* dst,
                                           int words, int c) {
  for (int i = c; i < words / 2; i += G) {
    reinterpret_cast<int2*>(dst)[i] = reinterpret_cast<const int2*>(src)[i];
  }
}

template <int LOGNS, int R>
__global__ void __launch_bounds__((1 << LOGNS) >> R, 1)
acs_round_kernel(const uint8_t* __restrict__ in,
                 const int32_t* __restrict__ cb,
                 const int32_t* __restrict__ init,
                 int32_t* __restrict__ decs,
                 int32_t* __restrict__ final_metrics, int T, int n,
                 int init_value) {
  using Rd = Round<LOGNS, R>;
  constexpr int NS = Rd::NS, G = Rd::G, M = Rd::M;
  // Two buffers of NS metrics, then two of a round's R * W decision words.
  extern __shared__ int4 smem4[];
  int* const buf0 = reinterpret_cast<int*>(smem4);
  int* const buf1 = buf0 + NS;
  int32_t* const stage0 = buf1 + NS;
  int32_t* const stage1 = stage0 + R * Rd::W;
  const int c = threadIdx.x;
  const int lane = c & 31, warp = c >> 5;
  const int ch = blockIdx.x;
  const int nmask = (1 << n) - 1;

  // Coded segments of the group's butterflies, byte i % 4 of cbp[j][i / 4]
  // for butterfly pair i = k*2^j + u of step j.
  uint32_t cbp[R][Rd::CBW];
  Rd::template load_cb<false>(cbp, cb, c);
  int m[M];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const int s = c + i * G;
    m[i] = (init != nullptr) ? __ldg(init + (size_t)ch * NS + s)
                             : (s == 0 ? 0 : init_value);
  }

  const uint8_t* row = in + (size_t)ch * T;
  int32_t* dec_row = decs + (size_t)ch * T * Rd::W;
  const int rd_base = Rd::phys(c);
  int* wb = buf0;
  int32_t* sd = stage0;
  int t = 0;
  for (; t + R <= T; t += R) {
    Rd::template round<false>(m, cbp, row + t, R, n, nmask, sd, warp, lane);
    // Destinations c*2^R + u, u = idx: Q int4 stores, swizzled.
    Rd::scatter(m, wb, c);
    __syncthreads();
    Rd::gather(m, wb, c, rd_base);
    // The round's R steps of words are contiguous in `decs`.  The next
    // round writes the other buffers; these are written again only after
    // the next barrier, which every thread reaches after its reads.
    copy_words<G>(sd, dec_row + (size_t)t * Rd::W, R * Rd::W, c);
    wb = (wb == buf0) ? buf1 : buf0;
    sd = (sd == stage0) ? stage1 : stage0;
  }
  // The last round's T mod R steps.
  const int J = T - t;
  if (J > 0) {
    Rd::template round<true>(m, cbp, row + t, J, n, nmask, sd, warp, lane);
    __syncthreads();
    copy_words<G>(sd, dec_row + (size_t)t * Rd::W, J * Rd::W, c);
  }
  // After J steps register idx = k*2^J + u holds state
  // c*2^J + u + k*(NS >> (R - J)).
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const int s = (c << J) + (i & ((1 << J) - 1)) + (i >> J) * (NS >> (R - J));
    final_metrics[(size_t)ch * NS + s] = m[i];
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

template <int LOGNS, int R>
int launch_round(const Args& a, cudaStream_t s) {
  constexpr int NS = 1 << LOGNS;
  const size_t smem = ((size_t)2 * NS + 2 * R * NS / 32) * sizeof(int);
  auto kernel = acs_round_kernel<LOGNS, R>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<a.B, NS >> R, smem, s>>>(a.in, a.cb, a.init, a.decs,
                                    a.final_metrics, a.T, a.n, a.init_value);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The soft forward at NS >= 512, n <= 8: R steps a round in registers.

template <int LOGNS, int R, bool HI>  // HI: n > 4
__global__ void __launch_bounds__((1 << LOGNS) >> R, 1)
acs_soft_round_kernel(const int8_t* __restrict__ in,
                      const int32_t* __restrict__ cb,
                      const int32_t* __restrict__ init,
                      int32_t* __restrict__ decs,
                      int32_t* __restrict__ final_metrics, int T, int n,
                      int qlo, int qclip, int init_value) {
  using Rd = Round<LOGNS, R>;
  constexpr int NS = Rd::NS, G = Rd::G, M = Rd::M;
  constexpr int W = Rd::W;
  static_assert(G >= 8 * R, "8R table threads, R * 8 LLR loaders");
  // Two buffers each of NS metrics, of a round's R * W decision words, of
  // its R step tables and of its R * 8 conditioned LLRs.
  extern __shared__ int4 smem4[];
  int* const buf0 = reinterpret_cast<int*>(smem4);
  int* const buf1 = buf0 + NS;
  int32_t* const stage0 = buf1 + NS;
  int32_t* const stage1 = stage0 + R * W;
  int* const tab0 = stage1 + R * W;
  int* const tab1 = tab0 + R * kTabStep;
  int* const sq0 = tab1 + R * kTabStep;
  int* const sq1 = sq0 + R * 8;
  const int c = threadIdx.x;
  const int lane = c & 31, warp = c >> 5;
  const int ch = blockIdx.x;

  // Coded segments of the group's butterflies, byte i % 4 of cbp[j][i / 4]
  // for pair i = k*2^j + u of step j: n <= 4, the byte offset of its entry
  // in the low table; n > 4, the segment.
  uint32_t cbp[R][Rd::CBW];
  Rd::template load_cb<!HI>(cbp, cb, c);
  int m[M];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const int s = c + i * G;
    m[i] = (init != nullptr) ? __ldg(init + (size_t)ch * NS + s)
                             : (s == 0 ? 0 : init_value);
  }

  // The LLRs of a round are R * n consecutive bytes: thread c < R * n
  // loads byte c of round r + 2 as round r starts and stores it,
  // conditioned, as round r ends; the threads building round r + 1's
  // tables then read that round's LLRs, stored a round earlier.
  const int8_t* row = in + (size_t)ch * T * n;
  const int tn = T * n, rn = R * n;
  if (c < rn) {
    sq0[c] = c < tn ? condition(row[c], qlo, qclip) : 0;
    sq1[c] = rn + c < tn ? condition(row[rn + c], qlo, qclip) : 0;
  }
  __syncthreads();
  build_tables<R, HI>(tab0, sq0, c, n);
  __syncthreads();

  int32_t* dec_row = decs + (size_t)ch * T * W;
  const int rd_base = Rd::phys(c);
  int* wb = buf0;
  int32_t* sd = stage0;
  const int* tab = tab0;
  int* sq = sq0;
  int t = 0;
  for (; t + R <= T; t += R) {
    const int ahead = (t + 2 * R) * n + c;
    const int8_t q_ahead = (c < rn && ahead < tn) ? row[ahead] : 0;
    Rd::template soft_round<false, HI>(m, cbp, tab, R, sd, warp, lane);
    Rd::scatter(m, wb, c);
    int* const sq_next = (sq == sq0) ? sq1 : sq0;
    if (c < rn) sq[c] = condition(q_ahead, qlo, qclip);
    build_tables<R, HI>(tab == tab0 ? tab1 : tab0, sq_next, c, n);
    __syncthreads();
    Rd::gather(m, wb, c, rd_base);
    copy_words<G>(sd, dec_row + (size_t)t * W, R * W, c);
    wb = (wb == buf0) ? buf1 : buf0;
    sd = (sd == stage0) ? stage1 : stage0;
    tab = (tab == tab0) ? tab1 : tab0;
    sq = sq_next;
  }
  const int J = T - t;
  if (J > 0) {
    Rd::template soft_round<true, HI>(m, cbp, tab, J, sd, warp, lane);
    __syncthreads();
    copy_words<G>(sd, dec_row + (size_t)t * W, J * W, c);
  }
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const int s = (c << J) + (i & ((1 << J) - 1)) + (i >> J) * (NS >> (R - J));
    final_metrics[(size_t)ch * NS + s] = m[i];
  }
}

template <int LOGNS, int R>
int launch_soft_round(const Args& a, cudaStream_t s) {
  constexpr int NS = 1 << LOGNS;
  const size_t smem = ((size_t)2 * NS + 2 * R * (NS / 32) +
                       2 * R * kTabStep + 2 * R * 8) * sizeof(int);
  auto kernel = a.n > 4 ? acs_soft_round_kernel<LOGNS, R, true>
                        : acs_soft_round_kernel<LOGNS, R, false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<a.B, NS >> R, smem, s>>>(
      reinterpret_cast<const int8_t*>(a.in), a.cb, a.init, a.decs,
      a.final_metrics, a.T, a.n, a.qlo, a.qclip, a.init_value);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The soft forward for n > 8 (any NS): a barrier a step.

template <int BPT>
__global__ void __launch_bounds__(kMaxThreads)
acs_soft_wide_kernel(const uint8_t* __restrict__ in,
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
  const int step_bytes = n;

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
        stage[i] = (int8_t)condition((int8_t)row[(size_t)t * step_bytes + i],
                                     qlo, qclip);
      }
      __syncthreads();
    }
    // The step's edge-metric terms, the same in every thread.
    int base = 0, Q = 0;
    const int8_t* qs = stage + k * step_bytes;
    for (int i = 0; i < n; ++i) {
      const int qi = qs[i];
      base += max(-qi, 0);
      Q += abs(qi);
    }
#pragma unroll
    for (int j = 0; j < BPT; ++j) {
      const int b = j * threads + tid;
      const bool act = b < H;  // false only for lanes NS/2..31 when NS < 64
      // The coded-bit table holds n <= 8 bits (ops/trellis.py): a coded
      // bit past the eighth is 0 and costs relu(-q), in `base`.
      int em = base;
      for (int i = 0; i < min(n, 8); ++i) {
        em += (int)qs[i] & -((cbl[j] >> i) & 1);
      }
      const int emc = Q - em;
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

template <int BPT>
int launch_soft(const Args& a, int threads, size_t smem, cudaStream_t s) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        acs_soft_wide_kernel<BPT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  acs_soft_wide_kernel<BPT><<<a.B, threads, smem, s>>>(
      a.in, a.cb, a.init, a.decs, a.final_metrics, a.T, a.NS, a.n, a.qlo,
      a.qclip, a.init_value);
  return static_cast<int>(cudaGetLastError());
}

// The barrier-a-step soft forward at NS (a power of two in [2, 16384]):
// min(NS/2, 1024) threads (32 below 64 states), NS/2 / threads butterflies
// each, the metrics twice and kChunk steps of LLRs in shared memory.
int launch_soft_steps(const Args& a, cudaStream_t s) {
  if (a.NS < 2 || a.NS > 16384 || (a.NS & (a.NS - 1)) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int H = a.NS / 2;
  const int threads = H < 32 ? 32 : (H < kMaxThreads ? H : kMaxThreads);
  const int bpt = H < 32 ? 1 : H / threads;
  const size_t smem = (size_t)2 * a.NS * sizeof(int) +
                      (((size_t)kChunk * a.n + 15) & ~(size_t)15);
  if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
  switch (bpt) {
    case 1: return launch_soft<1>(a, threads, smem, s);
    case 2: return launch_soft<2>(a, threads, smem, s);
    case 4: return launch_soft<4>(a, threads, smem, s);
    case 8: return launch_soft<8>(a, threads, smem, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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
  if (n < 1 || n > 8) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // Steps a round by NS, as measured (PERF.md section 6).
  switch (NS) {
    case 512: return launch_round<9, 4>(a, s);
    case 1024: return launch_round<10, 4>(a, s);
    case 2048: return launch_round<11, 4>(a, s);
    case 4096: return launch_round<12, 4>(a, s);
    case 8192: return launch_round<13, 4>(a, s);
    case 16384: return launch_round<14, 5>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 8) {
    // Steps a round by NS, as measured (PERF.md section 6).
    switch (NS) {
      case 512: return launch_soft_round<9, 4>(a, s);
      case 1024: return launch_soft_round<10, 4>(a, s);
      case 2048: return launch_soft_round<11, 4>(a, s);
      case 4096: return launch_soft_round<12, 4>(a, s);
      case 8192: return launch_soft_round<13, 4>(a, s);
      case 16384: return launch_soft_round<14, 5>(a, s);
      default: break;
    }
  }
  return launch_soft_steps(a, s);
}
