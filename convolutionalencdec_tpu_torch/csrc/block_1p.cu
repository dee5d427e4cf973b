// Single-pass block decode: the forward ACS and the traceback of a batch of
// terminated packets in one launch, the decisions kept in shared memory.
//
// Replaces the TPU kernel `_block_decode_1p` in
// convolutionalencdec_tpu/kernels/acs_pallas.py (its pallas_call at :2174,
// kernel body `_block_kernel_fused_1p` at :2092): forward chunks, then the
// walk back over them, with the packed decisions in a VMEM scratch that
// never goes to HBM.  It computes what that kernel computes, not how: no
// 3-stage relabelling, no MXU edge-metric matrix, no CHUNK_F or B_TILE
// padding, no phase axis in the grid; the decisions live in shared memory
// between the two phases of one block.
//
// Semantics (bit for bit those of acs_k1.cu / acs_soft_k1.cu / acs_wide.cu
// followed by traceback_k1.cu's terminated walk, i.e. of
// ops/viterbi.viterbi_decode and ops/metrics.viterbi_decode_soft):
//   ties keep the low source; state 0 starts at 0, every other state at
//   init_value; int32 metrics are never renormalised; soft LLRs are used as
//   max(q, -127) (the block routes' floor; no clip: the routes that reach
//   this kernel have qclip 127); a coded bit past the eighth is absent
//   from the uint8 coded-bit table and costs relu(-q) (acs_wide.cu's rule
//   for n > 8).  The walk starts in state 0 at step T - 1: the forward runs
//   exactly the T live steps, which is what the TPU kernel's group masks
//   (`_group_masks`, acs_pallas.py:1025-1034) do to its padded steps.
//   Steps t < message_bits emit the state's low bit.
//
// Layouts:
//   in    uint8 [B, T] segments (hard, n <= 8), or int8 [B, T, n] LLRs
//   cb    int32 [NS/2]   coded segment of edge (src b, input 0)
//   out   uint8 [B, message_bits] bits, or [B, ceil(message_bits / 8)]
//         bytes, MSb-first, the trailing byte zero-padded
//   shared memory per channel: T * NS/8 bytes of decision words, the layout
//   of acs_k1.cu (W = NS/32 words per step; the decision of state
//   s = 2b + p is bit i % 32 of word i / 32, i = p*NS/2 + b), then 64
//   words of the walk's scratch and its decoded bits, ceil(T / 32) words
//   (`channel_bytes`).
//
// What bounds it on this card: NS/2 butterflies per step (6 int32
// operations each) in a recurrence that is sequential in T, and then a
// dependent walk of T steps.  Device memory sees only the inputs and the
// decoded output: the two-pass route writes and reads back T * NS/8 bytes
// of decisions per channel (33.7 MB at NASA_K7, B = 2048, T = 2054), this
// kernel none.  What it pays instead is shared memory: a channel holds
// T * NS/8 bytes (16.4 KB at NS = 64, T = 2054), so an SM holds about 13
// channels where the two-pass forward holds 16 or more.
//
// What the design does about that:
//   NS 64-256 (`block_1p_warp`): one warp per channel, acs_k1.cu's forward
//   (metrics in registers, the butterfly permutation by __shfl_sync, the
//   step's decision words by __ballot_sync), each word stored by lane 0 to
//   the channel's shared-memory region.  Inputs come in 32 steps at a time,
//   one per lane; a soft lane also sums the step's relu(-q) and |q| once,
//   so a step costs a few shuffles whatever n is.  Four warps per block
//   while a channel's decisions take at most 4 KB, else one, so that blocks
//   pack the SM's 227 KB as finely as its decisions allow.
//   NS 512-4096 (`block_1p_wide`): one block per channel, acs_wide.cu's
//   forward (NS/2 butterflies over min(NS/2, 1024) threads, metrics
//   double-buffered in shared memory, one __syncthreads per step), each
//   step's per-step sums staged 64 steps at a time, the decision words
//   beside the metrics.
//   Both: after the last step one warp walks the words back from state 0,
//   exactly, its 32 lanes on 32 segments of the packet at once (`walk`: a
//   guessed start per segment, walked again where it differs from the
//   state the segment above ends in); the walk is a chain of dependent
//   shared-memory loads, T of them for one thread, about T/32 + 64 for a
//   lane.  The channel's threads then write the row out, coalesced.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMaxSmem = 232448;       // 227 KB: a block's most
constexpr int kSmallChannel = 4096;    // bytes; up to this, 4 warps a block
constexpr int kWideThreads = 1024;
constexpr int kChunk = 64;             // wide: steps staged at a time

// The walk, by the 32 lanes of one warp, exactly.  Lane l owns the steps
// [l G, (l + 1) G) (G = ceil(T / 32) rounded up to a multiple of 8) and
// guesses the state at its top step: it walks from state 0 at step
// kWarmup steps above (or from step T - 1, where the guess is exact) down
// to its segment, then walks its segment from the guess, writing the bits
// of its steps < message_bits, LSB first, to bits[t / 8] (its own bytes).
// Paths from different states merge within a few constraint lengths, so
// the guesses are right as a rule; lane 0 then checks them from the top
// segment down (a guess must equal the state the walk of the segment
// above reached, the top segment's start is exact) and walks again, from
// the right state, each segment whose guess was wrong.  `xy` is 64 words
// of scratch: the guesses, then the states each segment's walk reached.
constexpr int kWarmup = 64;

__device__ __forceinline__ unsigned walk_step(const uint32_t* dec, int W,
                                              int top, int t, unsigned cur) {
  const unsigned i = (cur >> 1) | ((cur & 1u) << top);
  const unsigned d = (dec[(size_t)t * W + (i >> 5)] >> (i & 31u)) & 1u;
  return (cur >> 1) | (d << top);
}

// Walk steps hi - 1 down to lo from state `cur` at step hi - 1, writing the
// bits of the steps < message_bits; returns the state at step lo - 1.
__device__ unsigned walk_segment(const uint32_t* dec, uint8_t* bits, int W,
                                 int top, int lo, int hi, int message_bits,
                                 unsigned cur) {
  unsigned acc = 0u;
  for (int t = hi - 1; t >= lo; --t) {
    if (t < message_bits) acc |= (cur & 1u) << (t & 7);
    cur = walk_step(dec, W, top, t, cur);
    if ((t & 7) == 0) {
      bits[t >> 3] = (uint8_t)acc;
      acc = 0u;
    }
  }
  return cur;
}

__device__ void walk(const uint32_t* dec, uint8_t* bits, uint32_t* xy, int T,
                     int W, int S, int message_bits, int lane) {
  const int top = S - 1;
  const int G = (((T + 31) >> 5) + 7) & ~7;
  const int lo = min(lane * G, T);
  const int hi = min(lo + G, T);
  unsigned x = 0u;
  // Kept a loop: as nvcc 12.9 unrolls it for sm_90a, the card stops the
  // kernel with an illegal-instruction error whenever it runs.
#pragma unroll 1
  for (int t = min(hi - 1 + kWarmup, T - 1); t >= hi; --t) {
    x = walk_step(dec, W, top, t, x);
  }
  xy[lane] = x;
  xy[32 + lane] = walk_segment(dec, bits, W, top, lo, hi, message_bits, x);
  __syncwarp();
  if (lane == 0) {
    for (int l = 30; l >= 0; --l) {
      const int l_lo = min(l * G, T), l_hi = min(l_lo + G, T);
      const unsigned start = xy[32 + l + 1];
      if (l_hi < T && xy[l] != start) {
        xy[32 + l] = walk_segment(dec, bits, W, top, l_lo, l_hi,
                                  message_bits, start);
      }
    }
  }
  __syncwarp();
}

// The channel's output row from the walk's bits, by `threads` threads.
__device__ void emit(const uint8_t* bits, uint8_t* row, int message_bits,
                     int emit_bytes, int tid, int threads) {
  if (emit_bytes) {
    for (int i = tid; i < (message_bits + 7) >> 3; i += threads) {
      row[i] = (uint8_t)(__brev((unsigned)bits[i]) >> 24);  // MSb first
    }
  } else {
    for (int e = tid; e < message_bits; e += threads) {
      row[e] = (uint8_t)((bits[e >> 3] >> (e & 7)) & 1u);
    }
  }
}

// Bytes of shared memory one channel's decisions, walk bits and walk
// scratch take.
__host__ __device__ inline size_t channel_bytes(int T, int NS) {
  return (size_t)T * (NS / 8) + 4 * (size_t)((T + 31) / 32) + 4 * 64;
}

template <int BPL, int NQ, bool SOFT>  // NS = 64 BPL; NQ = min(n, 8), soft
__global__ void __launch_bounds__(128)
block_1p_warp(const uint8_t* __restrict__ in, const int32_t* __restrict__ cb,
              uint8_t* __restrict__ out, int B, int T, int n, int S,
              int message_bits, int emit_bytes, int init_value) {
  constexpr int NS = 64 * BPL;
  constexpr int W = NS / 32;
  extern __shared__ uint32_t smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int ch = blockIdx.x * (blockDim.x >> 5) + warp;
  if (ch >= B) return;  // uniform across the warp; no block barrier below
  uint32_t* dec = smem + warp * channel_bytes(T, NS) / 4;
  uint32_t* xy = dec + (size_t)T * W;
  uint8_t* bits = reinterpret_cast<uint8_t*>(xy + 64);

  const int nmask = (1 << min(n, 8)) - 1;
  int cbl[BPL];
  int sel[BPL][SOFT ? NQ : 1];  // all ones where coded bit i of the edge is 1
  int lo[BPL], hi[BPL];         // metrics of sources b and b + NS/2
#pragma unroll
  for (int j = 0; j < BPL; ++j) {
    const int b = 32 * j + lane;
    cbl[j] = cb[b];
    if constexpr (SOFT) {
#pragma unroll
      for (int i = 0; i < NQ; ++i) sel[j][i] = -((cbl[j] >> i) & 1);
    }
    lo[j] = (b == 0) ? 0 : init_value;
    hi[j] = init_value;
  }
  // Next-step sources, as in acs_k1.cu: state x = 32 m + lane comes from
  // lane 16 (m & 1) + lane / 2, slot m >> 1, its even or odd destination by
  // the parity of lane.
  const int half_lane = lane >> 1;
  const bool odd = lane & 1;

  const uint8_t* row = in + (size_t)ch * T * (SOFT ? n : 1);
  for (int t0 = 0; t0 < T; t0 += 32) {
    const int steps = min(32, T - t0);
    // Step t0 + lane's input: the segment, or the first NQ LLRs packed
    // four to a register with the step's sums of relu(-q) and |q|.
    unsigned my_a = 0u, my_b = 0u;
    int my_base = 0, my_q = 0;
    if (lane < steps) {
      if constexpr (SOFT) {
        const int8_t* src =
            reinterpret_cast<const int8_t*>(row) + (size_t)(t0 + lane) * n;
#pragma unroll
        for (int i = 0; i < NQ; ++i) {
          const int q = max((int)src[i], -127);
          my_base += max(-q, 0);
          my_q += abs(q);
          if (i < 4) {
            my_a |= ((unsigned)q & 0xffu) << (8 * i);
          } else {
            my_b |= ((unsigned)q & 0xffu) << (8 * (i - 4));
          }
        }
        for (int i = NQ; i < n; ++i) {  // coded bits past the eighth
          const int q = max((int)src[i], -127);
          my_base += max(-q, 0);
          my_q += abs(q);
        }
      } else {
        my_a = row[t0 + lane];
      }
    }
    for (int s = 0; s < steps; ++s) {
      const unsigned a = __shfl_sync(kFullMask, my_a, s);
      int q[SOFT ? NQ : 1];
      int base = 0, Q = 0;
      if constexpr (SOFT) {
        const unsigned bq = (NQ > 4) ? __shfl_sync(kFullMask, my_b, s) : 0u;
        base = __shfl_sync(kFullMask, my_base, s);
        Q = __shfl_sync(kFullMask, my_q, s);
#pragma unroll
        for (int i = 0; i < NQ; ++i) {
          const unsigned v = (i < 4) ? a : bq;
          q[i] = (int)(v << (24 - 8 * (i & 3))) >> 24;  // sign-extend
        }
      }
      const int t = t0 + s;
      int ne[BPL], no[BPL];
#pragma unroll
      for (int j = 0; j < BPL; ++j) {
        int em, emc;
        if constexpr (SOFT) {
          em = base;
#pragma unroll
          for (int i = 0; i < NQ; ++i) em += q[i] & sel[j][i];
          emc = Q - em;
        } else {
          em = __popc(((int)a ^ cbl[j]) & nmask);
          emc = n - em;
        }
        const int a0 = lo[j] + em, a1 = hi[j] + emc;
        const int b0 = lo[j] + emc, b1 = hi[j] + em;
        const unsigned da = __ballot_sync(kFullMask, a0 > a1);
        const unsigned db = __ballot_sync(kFullMask, b0 > b1);
        if (lane == 0) {
          dec[(size_t)t * W + j] = da;        // even states: i = b
          dec[(size_t)t * W + BPL + j] = db;  // odd states:  i = NS/2 + b
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
  }
  __syncwarp();
  walk(dec, bits, xy, T, W, S, message_bits, lane);
  const int row_len = emit_bytes ? (message_bits + 7) / 8 : message_bits;
  emit(bits, out + (size_t)ch * row_len, message_bits, emit_bytes, lane, 32);
}

template <int BPT, int NQ, bool SOFT>  // NQ = min(n, 8), soft
__global__ void __launch_bounds__(kWideThreads)
block_1p_wide(const uint8_t* __restrict__ in, const int32_t* __restrict__ cb,
              uint8_t* __restrict__ out, int T, int NS, int n, int S,
              int message_bits, int emit_bytes, int init_value) {
  extern __shared__ int4 smem4[];  // 16-byte aligned
  int4* stage = smem4;             // kChunk steps: {seg or base, Q, q0-3, q4-7}
  int* m_cur = reinterpret_cast<int*>(smem4 + kChunk);
  int* m_nxt = m_cur + NS;
  uint32_t* dec = reinterpret_cast<uint32_t*>(m_nxt + NS);
  uint32_t* xy = dec + (size_t)T * (NS / 32);
  uint8_t* bits = reinterpret_cast<uint8_t*>(xy + 64);
  const int H = NS / 2;
  const int W = NS / 32;
  const int tid = threadIdx.x;
  const int threads = blockDim.x;
  const int lane = tid & 31;
  const int ch = blockIdx.x;
  const int nmask = (1 << min(n, 8)) - 1;

  for (int s = tid; s < NS; s += threads) m_cur[s] = (s == 0) ? 0 : init_value;
  int cbl[BPT];
#pragma unroll
  for (int j = 0; j < BPT; ++j) cbl[j] = cb[j * threads + tid];

  const uint8_t* row = in + (size_t)ch * T * (SOFT ? n : 1);
  for (int t = 0; t < T; ++t) {
    const int k = t % kChunk;
    if (k == 0) {
      // Every read of the previous chunk ended before the last step's
      // __syncthreads (or, at t = 0, nothing was staged).
      for (int c = tid; c < min(kChunk, T - t); c += threads) {
        int4 v = make_int4(0, 0, 0, 0);
        if constexpr (SOFT) {
          const int8_t* src =
              reinterpret_cast<const int8_t*>(row) + (size_t)(t + c) * n;
          unsigned pa = 0u, pb = 0u;
          for (int i = 0; i < n; ++i) {
            const int q = max((int)src[i], -127);
            v.x += max(-q, 0);
            v.y += abs(q);
            if (i < 4) {
              pa |= ((unsigned)q & 0xffu) << (8 * i);
            } else if (i < 8) {
              pb |= ((unsigned)q & 0xffu) << (8 * (i - 4));
            }
          }
          v.z = (int)pa;
          v.w = (int)pb;
        } else {
          v.x = row[t + c];
        }
        stage[c] = v;
      }
      __syncthreads();
    }
    const int4 v = stage[k];
    int q[SOFT ? NQ : 1];
    if constexpr (SOFT) {
#pragma unroll
      for (int i = 0; i < NQ; ++i) {
        const unsigned w = (i < 4) ? (unsigned)v.z : (unsigned)v.w;
        q[i] = (int)(w << (24 - 8 * (i & 3))) >> 24;
      }
    }
#pragma unroll
    for (int j = 0; j < BPT; ++j) {
      const int b = j * threads + tid;
      int em, emc;
      if constexpr (SOFT) {
        em = v.x;
#pragma unroll
        for (int i = 0; i < NQ; ++i) em += q[i] & -((cbl[j] >> i) & 1);
        emc = v.y - em;
      } else {
        em = __popc((v.x ^ cbl[j]) & nmask);
        emc = n - em;
      }
      const int lo = m_cur[b], hi = m_cur[b + H];
      const int a0 = lo + em, a1 = hi + emc;
      const int b0 = lo + emc, b1 = hi + em;
      const unsigned da = __ballot_sync(kFullMask, a0 > a1);
      const unsigned db = __ballot_sync(kFullMask, b0 > b1);
      *reinterpret_cast<int2*>(m_nxt + 2 * b) =
          make_int2(min(a0, a1), min(b0, b1));
      // Butterflies j * threads + 32 w .. + 31 of warp w: even word
      // (j * threads + 32 w) / 32, odd word H/32 + that.
      if (lane < 2) {
        const int w_even = (j * threads + (tid & ~31)) >> 5;
        dec[(size_t)t * W + w_even + (lane ? (H >> 5) : 0)] = lane ? db : da;
      }
    }
    __syncthreads();
    int* swap = m_cur;
    m_cur = m_nxt;
    m_nxt = swap;
  }
  if (tid < 32) walk(dec, bits, xy, T, W, S, message_bits, lane);
  __syncthreads();
  const int row_len = emit_bytes ? (message_bits + 7) / 8 : message_bits;
  emit(bits, out + (size_t)ch * row_len, message_bits, emit_bytes, tid,
       threads);
}

struct Args {
  const uint8_t* in;
  const int32_t* cb;
  uint8_t* out;
  int B, T, NS, n, S, message_bits, emit_bytes, init_value;
};

template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  // Ask for the largest shared-memory carveout, so that as many blocks as
  // their decisions allow share an SM.
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared));
}

template <int BPL, int NQ, bool SOFT>
int launch_warp(const Args& a, cudaStream_t s) {
  const size_t per_channel = channel_bytes(a.T, a.NS);
  const int warps = per_channel <= kSmallChannel ? 4 : 1;
  const size_t smem = per_channel * warps;
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const int e = allow_smem(block_1p_warp<BPL, NQ, SOFT>, smem);
  if (e != 0) return e;
  const dim3 grid((a.B + warps - 1) / warps);
  block_1p_warp<BPL, NQ, SOFT><<<grid, 32 * warps, smem, s>>>(
      a.in, a.cb, a.out, a.B, a.T, a.n, a.S, a.message_bits, a.emit_bytes,
      a.init_value);
  return static_cast<int>(cudaGetLastError());
}

template <int BPT, int NQ, bool SOFT>
int launch_wide(const Args& a, cudaStream_t s) {
  const int threads = min(a.NS / 2, kWideThreads);
  const size_t smem = (size_t)kChunk * sizeof(int4) +
                      (size_t)2 * a.NS * sizeof(int) +
                      channel_bytes(a.T, a.NS);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const int e = allow_smem(block_1p_wide<BPT, NQ, SOFT>, smem);
  if (e != 0) return e;
  block_1p_wide<BPT, NQ, SOFT><<<a.B, threads, smem, s>>>(
      a.in, a.cb, a.out, a.T, a.NS, a.n, a.S, a.message_bits, a.emit_bytes,
      a.init_value);
  return static_cast<int>(cudaGetLastError());
}

// The instantiation of `a.NS` (64 ... 4096, a power of two) at NQ.
template <int NQ, bool SOFT>
int launch_ns(const Args& a, cudaStream_t s) {
  switch (a.NS) {
    case 64: return launch_warp<1, NQ, SOFT>(a, s);
    case 128: return launch_warp<2, NQ, SOFT>(a, s);
    case 256: return launch_warp<4, NQ, SOFT>(a, s);
    case 512: case 1024: case 2048: return launch_wide<1, NQ, SOFT>(a, s);
    case 4096: return launch_wide<2, NQ, SOFT>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Hard: segments uint8 [B, T], 1 <= n <= 8.  Soft (soft != 0): int8 LLRs
// [B, T, n], any n >= 1.  Output bits [B, message_bits] or (emit_bytes)
// bytes [B, ceil(message_bits / 8)]; message_bits <= T - S.
extern "C" int block_decode_1p(const void* in, int soft, const void* cb,
                               void* out, int B, int T, int NS, int n, int S,
                               int message_bits, int emit_bytes,
                               int init_value, void* stream) {
  const Args a{static_cast<const uint8_t*>(in),
               static_cast<const int32_t*>(cb), static_cast<uint8_t*>(out),
               B, T, NS, n, S, message_bits, emit_bytes, init_value};
  if (B < 1 || T < 0 || n < 1 || (!soft && n > 8) || message_bits < 0 ||
      (message_bits > 0 && message_bits > T - S)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!soft) return launch_ns<1, false>(a, s);
  switch (min(n, 8)) {
    case 1: return launch_ns<1, true>(a, s);
    case 2: return launch_ns<2, true>(a, s);
    case 3: return launch_ns<3, true>(a, s);
    case 4: return launch_ns<4, true>(a, s);
    case 5: return launch_ns<5, true>(a, s);
    case 6: return launch_ns<6, true>(a, s);
    case 7: return launch_ns<7, true>(a, s);
    default: return launch_ns<8, true>(a, s);
  }
}
