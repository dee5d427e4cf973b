// Max-log-MAP (min-sum BCJR) a-posteriori LLRs of k=1 butterfly codes.
//
// Replaces the TPU kernels of convolutionalencdec_tpu/kernels/
// maxlogmap_pallas.py: the forward `_map_fwd_kernel` (pallas_call at :328,
// alpha checkpoints every CHUNK_M steps) and the backward `_map_bwd_kernel`
// (pallas_call at :347, replay of each chunk, beta recursion, per-step LLR),
// as ONE launch: a warp runs the forward of its channel and then its
// backward, so the checkpoints it wrote are its own to read back.
//
// Semantics (bit for bit those of ops/maxlogmap.maxlogmap_llrs, the scan,
// on LLRs floored at -127 by the wrapper's contract):
//   each LLR is used as q = clamp(q, -127, 127);
//   em[b] = cost of edge (src b, u 0) = sum_j relu(+-q_j) as in
//   acs_soft_k1.cu, emc = Q - em with Q = sum_j |q_j|;
//   alpha_0 = 0 at `start`, BIG elsewhere; alpha_{t+1} the butterfly min
//   (the forward of acs_soft_k1.cu without decisions);
//   beta_T = 0 at `start` and BIG elsewhere when `terminated`, else 0;
//   beta_t(b)        = min(em + beta_{t+1}(2b),  emc + beta_{t+1}(2b+1))
//   beta_t(b + NS/2) = min(emc + beta_{t+1}(2b), em + beta_{t+1}(2b+1));
//   L_t = min over odd d of (alpha_{t+1}(d) + beta_{t+1}(d))
//       - min over even d of the same,
// which equals the scan's min over u=1 edges minus min over u=0 edges of
// alpha_t(s) + bm_t(u, s) + beta_{t+1}(next(u, s)): the destination d of
// an edge carries its input bit in its parity, and alpha_{t+1}(d) is the
// min over d's two incoming edges.  BIG = 2^28 as in the scan and no
// renormalisation: with T * n * 128 < 2^28 (the wrapper's envelope) every
// alpha and beta is below 2^29 and every sum below 2^30, so the kernel
// does the scan's integer arithmetic and equals it on every entry.  (The
// TPU kernel expresses termination as 2^20 input penalties instead and
// differs from the scan on the S termination steps, in value only.)
//
// Layouts:
//   qllrs  int8  [B, T, n]
//   cb     int32 [NS/2]          coded segment of edge (src b, input 0)
//   ckpt   int32 [B, nC, NS]     scratch: alpha_{32 c}, natural order
//   llrs   int32 [B, T]
//
// What bounds it on this card: three passes of the butterfly recurrence
// over T (forward, replay, beta), each step NS/2 butterflies of ~6 int32
// operations that depend on the step before, plus the per-step emit (2
// adds and a min per state, two warp reductions).  Bytes are small: n LLR
// bytes read twice and 4 bytes written per step, NS * 4 bytes of
// checkpoint per 32 steps.  Like the forward ACS it is bound by
// instruction issue per SM.
//
// What the design does about it:
//   - one warp per channel, the layout of acs_soft_k1.cu: lane l holds
//     the metrics of states 32 m + l (natural order, m < 2 NS/64), the
//     butterfly's sources b and b + NS/2 in registers, its destinations
//     brought back to natural order by __shfl_sync;
//   - the forward stores alpha every kChunk = 32 steps (global memory,
//     mostly L2); the backward replays a chunk from its checkpoint into
//     shared memory (kChunk x NS x 4 bytes per warp) and then walks beta
//     back through it, so no [T, NS] tensor ever reaches device memory;
//   - beta lives in natural order too; each step brings beta_{t+1}(2b)
//     and beta_{t+1}(2b+1) to butterfly b's lane with 4 shuffles per
//     butterfly slot (the inverse of the forward's permutation);
//   - the emit: each lane takes the min over its states of alpha + beta
//     (a lane's states share the parity of its lane id), and two
//     __reduce_min_sync (sm_80+ warp reductions) give the odd and even
//     minima; lane s of the chunk keeps step t0 + s's LLR and the warp
//     stores the chunk's 32 LLRs in one coalesced write.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kChunk = 32;   // steps per checkpoint (one per lane on emit)
constexpr int kBig = 1 << 28;

template <int BPL, int N>  // butterflies per lane = NS / 64; n coded bits
__global__ void __launch_bounds__(32 * (4 / BPL))
maxlogmap_k1_kernel(const int8_t* __restrict__ qllrs,
                    const int32_t* __restrict__ cb,
                    int32_t* __restrict__ ckpt, int32_t* __restrict__ llrs,
                    int B, int T, int start, int terminated) {
  constexpr int kWarps = 4 / BPL;  // 32 KB of replay buffer per block
  constexpr int NS = 64 * BPL;
  constexpr int HALF = NS / 2;
  constexpr int NP = (N + 3) / 4;  // registers holding one step's LLRs
  __shared__ int32_t replay[kWarps][kChunk][NS];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int ch = blockIdx.x * kWarps + warp;
  if (ch >= B) return;  // uniform across the warp: the ragged B edge
  int32_t (*alpha_buf)[NS] = replay[warp];

  int sel[BPL][N];  // all ones where coded bit i of butterfly 32 j + lane is 1
#pragma unroll
  for (int j = 0; j < BPL; ++j) {
    const int c = cb[32 * j + lane];
#pragma unroll
    for (int i = 0; i < N; ++i) sel[j][i] = -((c >> i) & 1);
  }
  const int half_lane = lane >> 1;
  const bool odd = lane & 1;
  const int8_t* q_row = qllrs + (size_t)ch * T * N;
  const int nC = (T + kChunk - 1) / kChunk;
  int32_t* ck_row = ckpt + (size_t)ch * nC * NS;

  // Step t0 + lane's conditioned LLRs, byte i = q_i.
  auto load_chunk = [&](int t0, int steps, unsigned (&mine)[NP]) {
#pragma unroll
    for (int p = 0; p < NP; ++p) mine[p] = 0;
    if (lane < steps) {
      const int8_t* src = q_row + (size_t)(t0 + lane) * N;
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const int q = max((int)src[i], -127);
        mine[i >> 2] |= ((unsigned)q & 0xffu) << (8 * (i & 3));
      }
    }
  };
  // Step s's edge metrics of this lane's butterflies.
  auto edge_metrics = [&](const unsigned (&mine)[NP], int s, int (&em)[BPL],
                          int (&emc)[BPL]) {
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
#pragma unroll
    for (int j = 0; j < BPL; ++j) {
      int e = base;
#pragma unroll
      for (int i = 0; i < N; ++i) e += q[i] & sel[j][i];
      em[j] = e;
      emc[j] = Q - e;
    }
  };
  // One forward butterfly step, natural order in and out.
  auto acs = [&](const int (&em)[BPL], const int (&emc)[BPL], int (&lo)[BPL],
                 int (&hi)[BPL]) {
    int ne[BPL], no[BPL];
#pragma unroll
    for (int j = 0; j < BPL; ++j) {
      ne[j] = min(lo[j] + em[j], hi[j] + emc[j]);
      no[j] = min(lo[j] + emc[j], hi[j] + em[j]);
    }
    // State x = 32 m + lane comes from lane 16 (m & 1) + lane / 2, slot
    // m >> 1, its even or odd destination by the parity of lane.
#pragma unroll
    for (int m = 0; m < 2 * BPL; ++m) {
      const int src = 16 * (m & 1) + half_lane;
      const int e = __shfl_sync(kFullMask, ne[m >> 1], src);
      const int o = __shfl_sync(kFullMask, no[m >> 1], src);
      if (m < BPL) {
        lo[m % BPL] = odd ? o : e;
      } else {
        hi[m % BPL] = odd ? o : e;
      }
    }
  };
  auto anchor = [&](int (&lo)[BPL], int (&hi)[BPL], int other) {
#pragma unroll
    for (int j = 0; j < BPL; ++j) {
      lo[j] = (32 * j + lane == start) ? 0 : other;
      hi[j] = (HALF + 32 * j + lane == start) ? 0 : other;
    }
  };

  // Forward: alpha checkpoints at every chunk start.
  int lo[BPL], hi[BPL];
  anchor(lo, hi, kBig);
  for (int c = 0; c < nC; ++c) {
    const int t0 = c * kChunk;
    const int steps = min(kChunk, T - t0);
#pragma unroll
    for (int j = 0; j < BPL; ++j) {
      ck_row[c * NS + 32 * j + lane] = lo[j];
      ck_row[c * NS + HALF + 32 * j + lane] = hi[j];
    }
    unsigned mine[NP];
    load_chunk(t0, steps, mine);
    for (int s = 0; s < steps; ++s) {
      int em[BPL], emc[BPL];
      edge_metrics(mine, s, em, emc);
      acs(em, emc, lo, hi);
    }
  }

  // Backward, chunk by chunk from the end.
  int blo[BPL], bhi[BPL];
  anchor(blo, bhi, terminated ? kBig : 0);
  const int src_e = (2 * lane) & 31;
  const bool upper = lane >= 16;
  for (int c = nC - 1; c >= 0; --c) {
    const int t0 = c * kChunk;
    const int steps = min(kChunk, T - t0);
    unsigned mine[NP];
    load_chunk(t0, steps, mine);
#pragma unroll
    for (int j = 0; j < BPL; ++j) {
      lo[j] = ck_row[c * NS + 32 * j + lane];
      hi[j] = ck_row[c * NS + HALF + 32 * j + lane];
    }
    // Replay: alpha_{t0 + s + 1} into the buffer's row s.
    for (int s = 0; s < steps; ++s) {
      int em[BPL], emc[BPL];
      edge_metrics(mine, s, em, emc);
      acs(em, emc, lo, hi);
#pragma unroll
      for (int j = 0; j < BPL; ++j) {
        alpha_buf[s][32 * j + lane] = lo[j];
        alpha_buf[s][HALF + 32 * j + lane] = hi[j];
      }
    }
    __syncwarp();
    int held = 0;  // LLR of step t0 + lane
    for (int s = steps - 1; s >= 0; --s) {
      // Emit from alpha_{t+1} and beta_{t+1}, natural order.
      int v = INT_MAX;
#pragma unroll
      for (int j = 0; j < BPL; ++j) {
        v = min(v, alpha_buf[s][32 * j + lane] + blo[j]);
        v = min(v, alpha_buf[s][HALF + 32 * j + lane] + bhi[j]);
      }
      const int m1 = __reduce_min_sync(kFullMask, odd ? v : INT_MAX);
      const int m0 = __reduce_min_sync(kFullMask, odd ? INT_MAX : v);
      if (lane == s) held = m1 - m0;
      // beta_t from beta_{t+1}: butterfly b = 32 j + lane needs states 2b
      // (slot 2j + lane / 16, lane 2 lane mod 32) and 2b + 1 (lane + 1).
      int em[BPL], emc[BPL];
      edge_metrics(mine, s, em, emc);
      int be[BPL], bo[BPL];
#pragma unroll
      for (int j = 0; j < BPL; ++j) {
        // Slot m < BPL is blo[m], else bhi[m - BPL] (= bhi[m % BPL]).
        const int x0 = (2 * j < BPL) ? blo[(2 * j) % BPL]
                                     : bhi[(2 * j) % BPL];
        const int x1 = (2 * j + 1 < BPL) ? blo[(2 * j + 1) % BPL]
                                         : bhi[(2 * j + 1) % BPL];
        const int x0e = __shfl_sync(kFullMask, x0, src_e);
        const int x0o = __shfl_sync(kFullMask, x0, src_e + 1);
        const int x1e = __shfl_sync(kFullMask, x1, src_e);
        const int x1o = __shfl_sync(kFullMask, x1, src_e + 1);
        be[j] = upper ? x1e : x0e;
        bo[j] = upper ? x1o : x0o;
      }
#pragma unroll
      for (int j = 0; j < BPL; ++j) {
        blo[j] = min(em[j] + be[j], emc[j] + bo[j]);
        bhi[j] = min(emc[j] + be[j], em[j] + bo[j]);
      }
    }
    if (lane < steps) llrs[(size_t)ch * T + t0 + lane] = held;
    __syncwarp();  // the buffer is rewritten by the next chunk's replay
  }
}

struct Args {
  const int8_t* qllrs;
  const int32_t* cb;
  int32_t* ckpt;
  int32_t* llrs;
  int B, T, start, terminated;
};

template <int BPL, int N>
void launch(const Args& a, cudaStream_t s) {
  constexpr int kWarps = 4 / BPL;
  const dim3 block(32 * kWarps);
  const dim3 grid((a.B + kWarps - 1) / kWarps);
  maxlogmap_k1_kernel<BPL, N><<<grid, block, 0, s>>>(
      a.qllrs, a.cb, a.ckpt, a.llrs, a.B, a.T, a.start, a.terminated);
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

extern "C" int maxlogmap_k1(const void* qllrs, const void* cb, void* ckpt,
                            void* llrs, int B, int T, int NS, int n,
                            int start, int terminated, void* stream) {
  const Args a{static_cast<const int8_t*>(qllrs),
               static_cast<const int32_t*>(cb), static_cast<int32_t*>(ckpt),
               static_cast<int32_t*>(llrs), B, T, start, terminated};
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
