// Max-log-MAP of a recursive systematic convolutional (RSC) constituent
// with a-priori input: the inner loop of the turbo decoder.
//
// Replaces the TPU kernels of convolutionalencdec_tpu/kernels/
// turbo_pallas.py: the forward `_turbo_fwd_kernel` (pallas_call at :283,
// alpha checkpoints), the backward `_turbo_bwd_kernel` (pallas_call at
// :300, replay, beta, per-step LLR) and the `_beta_tail` recurrence the JAX
// code runs beside them, as ONE launch: a group of lanes runs the forward
// of its code block and then its backward, reading back only the
// checkpoints it wrote.
//
// Semantics (bit for bit those of ops/turbo.rsc_maxlogmap, the scan):
//   lu_t = l_sys_t + l_apriori_t, lp_t = l_par_t for the L message steps;
//   the S tail steps take l_sys_tail, l_par_tail (no a-priori);
//   bm_t(u, s) = u lu_t + par[u, s] lp_t;
//   alpha_0 = 0 at state 0, BIG = 2^28 elsewhere;
//   alpha_{t+1}(d) = min over d's two edges (e) of
//                    alpha_t(prev[e, d]) + bm_t(pu[e, d], prev[e, d]);
//   beta_{L+S} = 0 at state 0, BIG elsewhere, walked back through the tail
//   steps with u free: beta_t(s) = min_u bm_t(u, s) + beta_{t+1}(nxt[u, s]);
//   lapp_t = min over (s, u = 1) of alpha_t(s) + bm_t(1, s)
//            + beta_{t+1}(nxt[1, s]) - the same min over u = 0.
//
// Renormalisation, and why the result is still the scan's.  The scan
// never renormalises; this kernel subtracts the block's least alpha every
// 8 forward steps (at the same steps in the forward and the replay, so the
// replay reproduces the forward's values) and the least beta every 8
// backward steps.  A constant taken from every alpha (or beta) of a step
// cancels in lapp_t, a difference of two minima over that step's edges.
// Margin: under the exchange's contract (|l_apriori| <= LA_CLAMP = 2^17,
// channel LLRs of a few quantizer steps) every |bm| < mb = 2^18.  The
// 2-regular trellis mixes fully in S steps, so once every state is
// reachable (t >= S) the finite alphas span <= 2 S mb; between renorms the
// least drifts by <= 8 mb, so alpha, beta lie in [-8 mb, 14 mb] and an
// emit sum alpha + bm + beta in [-17 mb, 29 mb], far inside int32.  The
// BIG-excluded alphas of the first S steps are >= BIG - 3 mb > 29 mb and
// never reach a minimum the scan's would not; beta_L is finite in every
// state (each state has its zero-feedback termination path).  So the
// kernel's minima are the scan's less per-step constants, and its lapp
// equals the scan's wherever the scan's own int32 sums do not overflow
// ((L + S) mb + BIG < 2^31, which holds up to L = 6144 at mb = 2^18).
//
// Layouts:
//   l_sys, l_par, l_apriori  int32 [B, L]
//   l_sys_tail, l_par_tail   int32 [B, S]
//   tab   int32 [10, NS]: prev0, prev1, pu0, pu1, zp0, zp1 (the parity of
//         each incoming edge), nxt0, nxt1, par0, par1 (of each outgoing)
//   ckpt  int32 [B, nC, NS] scratch: alpha_{32 c} (renormalised)
//   lapp  int32 [B, L]
//
// What bounds it on this card: three passes of an 8-state recurrence over
// L (forward, replay, beta) with a few int32 operations per state and step
// that depend on the step before; per step the emit's two 8-way minima.
// Each block reads 12 bytes and writes 4 per step: bytes are no limit.
// With one lane per state only B * NS threads exist (16,384 at the
// serving point, ~4 warps per SM), so the kernel is bound by one step's
// dependent latency (shuffle, add, min) times the steps, not by issue.
//
// What the design does about it: one lane per state, the NS lanes of a
// block adjacent (32 / NS blocks per warp); the ACS partners come by
// __shfl_sync from lanes prev[e, d] (forward) or nxt[u, s] (backward) of
// the same group, the edge labels from a per-lane table row; the renorm's
// group minimum by __shfl_xor_sync within the group.  The emit stays off
// beta's dependent chain: each step's alpha + bm + beta values go to
// shared memory, and after the chunk lane s reduces step s of every block
// of the warp (8-way minima from shared memory, no shuffles).  The forward
// keeps alpha every 32 steps in global memory (L2 at these sizes); the
// backward replays each 32-step chunk into shared memory (alpha, lu and lp
// of each step: 12 KB per warp) and walks beta back through it.  Global
// loads of lu, lp are issued one 8-step group ahead of the recurrence.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kWarpsPerBlock = 2;
constexpr int kChunk = 32;   // steps per checkpoint
constexpr int kGroup = 8;    // steps per load group and renorm period
constexpr int kBig = 1 << 28;
constexpr int kRow = 33;     // shared-memory row: 32 lanes + 1 pad word

template <int G>  // lanes per code block = NS
__device__ __forceinline__ int group_min(int v) {
#pragma unroll
  for (int off = 1; off < G; off <<= 1) {
    v = min(v, __shfl_xor_sync(kFullMask, v, off));
  }
  return v;
}

template <int NS>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
turbo_rsc_map_kernel(const int32_t* __restrict__ l_sys,
                     const int32_t* __restrict__ l_par,
                     const int32_t* __restrict__ l_apriori,
                     const int32_t* __restrict__ l_sys_tail,
                     const int32_t* __restrict__ l_par_tail,
                     const int32_t* __restrict__ tab,
                     int32_t* __restrict__ ckpt, int32_t* __restrict__ lapp,
                     int B, int L, int S) {
  constexpr int kBlocksPerWarp = 32 / NS;
  // Rows padded to 33 words: the emit reads a column per lane.
  __shared__ int32_t replay[kWarpsPerBlock][3][kChunk][kRow];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int first = (blockIdx.x * kWarpsPerBlock + warp) * kBlocksPerWarp;
  if (first >= B) return;  // uniform across the warp
  const int st = lane % NS;        // this lane's state
  const int gb = lane - st;        // the group's first lane
  const int blk = first + lane / NS;
  const bool valid = blk < B;      // lanes of a missing block run idle
  int32_t (*alpha_buf)[kRow] = replay[warp][0];
  int32_t (*lu_buf)[kRow] = replay[warp][1];   // then v0 of the emit
  int32_t (*lp_buf)[kRow] = replay[warp][2];   // then v1

  const int p0 = gb + tab[0 * NS + st], p1 = gb + tab[1 * NS + st];
  const int mu0 = -tab[2 * NS + st], mu1 = -tab[3 * NS + st];
  const int mz0 = -tab[4 * NS + st], mz1 = -tab[5 * NS + st];
  const int n0 = gb + tab[6 * NS + st], n1 = gb + tab[7 * NS + st];
  const int my0 = -tab[8 * NS + st], my1 = -tab[9 * NS + st];

  const size_t row = (size_t)(valid ? blk : 0) * L;
  const int nC = (L + kChunk - 1) / kChunk;
  int32_t* ck = ckpt + ((size_t)(valid ? blk : 0) * nC) * NS + st;

  // lu, lp of steps t8 .. t8 + 7 below t_end.
  // lu, lp of steps t8 .. t8 + 7 (zeros past L).  Chunks are whole
  // groups of 8, so L is the only edge.
  auto load8 = [&](int t8, int (&lu)[kGroup], int (&lp)[kGroup]) {
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      const int t = t8 + j;
      lu[j] = (valid && t < L) ? l_sys[row + t] + l_apriori[row + t] : 0;
      lp[j] = (valid && t < L) ? l_par[row + t] : 0;
    }
  };
  auto forward_step = [&](int x, int lu, int lp) {
    const int bm0 = (lu & mu0) + (lp & mz0);  // off the dependent chain
    const int bm1 = (lu & mu1) + (lp & mz1);
    const int a0 = __shfl_sync(kFullMask, x, p0);
    const int a1 = __shfl_sync(kFullMask, x, p1);
    return min(a0 + bm0, a1 + bm1);
  };
  // One backward step: c_u = bm(u, st) + beta_{t+1}(nxt[u, st]).
  auto backward_costs = [&](int x, int lu, int lp, int& c0, int& c1) {
    const int bm0 = lp & my0;
    const int bm1 = lu + (lp & my1);
    c0 = __shfl_sync(kFullMask, x, n0) + bm0;
    c1 = __shfl_sync(kFullMask, x, n1) + bm1;
  };

  // Forward: alpha_{32 c} kept for every chunk c; each group's loads are
  // issued one group ahead.
  int a = (st == 0) ? 0 : kBig;
  int lu[kGroup], lp[kGroup];
  load8(0, lu, lp);
  for (int t8 = 0; t8 < L; t8 += kGroup) {
    int nlu[kGroup], nlp[kGroup];
    load8(t8 + kGroup, nlu, nlp);
    if (valid && t8 % kChunk == 0) ck[t8 / kChunk * NS] = a;
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      if (t8 + j < L) a = forward_step(a, lu[j], lp[j]);
    }
    a -= group_min<NS>(a);
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      lu[j] = nlu[j];
      lp[j] = nlp[j];
    }
  }

  // beta_L: the S tail steps from the state-0 anchor.
  int b = (st == 0) ? 0 : kBig;
  for (int t = S - 1; t >= 0; --t) {
    const int tu = valid ? l_sys_tail[(size_t)blk * S + t] : 0;
    const int tp = valid ? l_par_tail[(size_t)blk * S + t] : 0;
    int c0, c1;
    backward_costs(b, tu, tp, c0, c1);
    b = min(c0, c1);
  }

  // Backward, chunk by chunk from the end.  The replay keeps alpha_t, lu
  // and lp of the chunk's steps in shared memory, and its loads run one
  // group ahead, into the next chunk's first group (and checkpoint) while
  // beta walks this one.
  load8((nC - 1) * kChunk, lu, lp);
  int a_next = valid ? ck[(nC - 1) * NS] : 0;
  for (int c = nC - 1; c >= 0; --c) {
    const int t0 = c * kChunk;
    const int t_end = min(t0 + kChunk, L);
    a = a_next;
    for (int t8 = t0; t8 < t_end; t8 += kGroup) {
      int nlu[kGroup], nlp[kGroup];
      if (t8 + kGroup < t_end) {
        load8(t8 + kGroup, nlu, nlp);
      } else {
        load8(c > 0 ? t0 - kChunk : L, nlu, nlp);
        if (c > 0) a_next = valid ? ck[(c - 1) * NS] : 0;
      }
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        if (t8 + j < t_end) {
          const int s = t8 + j - t0;
          alpha_buf[s][lane] = a;
          lu_buf[s][lane] = lu[j];
          lp_buf[s][lane] = lp[j];
          a = forward_step(a, lu[j], lp[j]);
        }
      }
      a -= group_min<NS>(a);
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        lu[j] = nlu[j];
        lp[j] = nlp[j];
      }
    }
    __syncwarp();
    for (int s8 = (t_end - 1 - t0) / kGroup * kGroup; s8 >= 0;
         s8 -= kGroup) {
#pragma unroll
      for (int j = kGroup - 1; j >= 0; --j) {
        const int s = s8 + j;
        if (t0 + s < t_end) {
          int c0, c1;
          backward_costs(b, lu_buf[s][lane], lp_buf[s][lane], c0, c1);
          const int at = alpha_buf[s][lane];
          lu_buf[s][lane] = at + c0;   // the emit's values, reduced below
          lp_buf[s][lane] = at + c1;
          b = min(c0, c1);
        }
      }
      b -= group_min<NS>(b);
    }
    __syncwarp();
    // The emit, off beta's dependent chain: lane s takes step t0 + s of
    // each of the warp's blocks, the min over its NS states of v1 less
    // that of v0, and the warp writes each block's 32 LLRs in one store.
    if (t0 + lane < t_end) {
#pragma unroll
      for (int g = 0; g < kBlocksPerWarp; ++g) {
        int m0 = lu_buf[lane][g * NS], m1 = lp_buf[lane][g * NS];
#pragma unroll
        for (int x = 1; x < NS; ++x) {
          m0 = min(m0, lu_buf[lane][g * NS + x]);
          m1 = min(m1, lp_buf[lane][g * NS + x]);
        }
        if (first + g < B) {
          lapp[(size_t)(first + g) * L + t0 + lane] = m1 - m0;
        }
      }
    }
    __syncwarp();  // the buffers are rewritten by the next chunk's replay
  }
}

template <int NS>
void launch(const int32_t* l_sys, const int32_t* l_par,
            const int32_t* l_apriori, const int32_t* l_sys_tail,
            const int32_t* l_par_tail, const int32_t* tab, int32_t* ckpt,
            int32_t* lapp, int B, int L, int S, cudaStream_t s) {
  constexpr int kBlocksPerCta = kWarpsPerBlock * (32 / NS);
  const dim3 block(32 * kWarpsPerBlock);
  const dim3 grid((B + kBlocksPerCta - 1) / kBlocksPerCta);
  turbo_rsc_map_kernel<NS><<<grid, block, 0, s>>>(
      l_sys, l_par, l_apriori, l_sys_tail, l_par_tail, tab, ckpt, lapp, B,
      L, S);
}

}  // namespace

extern "C" int turbo_rsc_map(const void* l_sys, const void* l_par,
                             const void* l_apriori, const void* l_sys_tail,
                             const void* l_par_tail, const void* tab,
                             void* ckpt, void* lapp, int B, int L, int NS,
                             int S, void* stream) {
  const auto* ls = static_cast<const int32_t*>(l_sys);
  const auto* lp = static_cast<const int32_t*>(l_par);
  const auto* la = static_cast<const int32_t*>(l_apriori);
  const auto* lst = static_cast<const int32_t*>(l_sys_tail);
  const auto* lpt = static_cast<const int32_t*>(l_par_tail);
  const auto* tb = static_cast<const int32_t*>(tab);
  auto* ck = static_cast<int32_t*>(ckpt);
  auto* out = static_cast<int32_t*>(lapp);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (NS) {
    case 2: launch<2>(ls, lp, la, lst, lpt, tb, ck, out, B, L, S, s); break;
    case 4: launch<4>(ls, lp, la, lst, lpt, tb, ck, out, B, L, S, s); break;
    case 8: launch<8>(ls, lp, la, lst, lpt, tb, ck, out, B, L, S, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
