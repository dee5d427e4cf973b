// Max-log-MAP of a recursive systematic convolutional (RSC) constituent
// with a-priori input: the inner loop of the turbo decoder.
//
// Replaces the TPU kernels of convolutionalencdec_tpu/kernels/
// turbo_pallas.py: the forward `_turbo_fwd_kernel` (pallas_call at :283,
// alpha checkpoints), the backward `_turbo_bwd_kernel` (pallas_call at
// :300, replay, beta, per-step LLR) and the `_beta_tail` recurrence the JAX
// code runs beside them, as ONE launch.  Its layout (NS x 128 tiles, the
// XOR relabelling of sublanes) is TPU machinery and is not carried over.
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
// What bounds it on this card (NVIDIA H100 80GB HBM3, 700 W).  Per block
// and step the work is two recursions of NS states (an add and a compare
// per edge) and the emit's two NS-way minima, about 20 int32 operations a
// state: 0.02 ms for B = 2048, L = 1024, NS = 8 at 16.7 T operations/s.
// Inputs are 12 bytes and the output 4 bytes a step.  But each recursion
// is a chain of L dependent steps: with one lane a state a step is two
// shuffles from the lanes of the edges' sources, an add and a min, 36
// cycles (scripts/torch_turbo_variants.py --chain), and the chains must
// share the SM's integer pipes (16 lanes a cycle a scheduler) and its
// shuffle and shared-memory pipe (one warp instruction, or one 128-byte
// wavefront, a cycle).  The parent kernel walked three chains of L steps
// one after the other (forward with checkpoints, replay, beta) with its
// global loads one 8-step group ahead and its renormalisation shuffles on
// the chain: 0.2730 ms, about 175 cycles a step.
//
// What this design does about that (each choice measured in turns with
// the others by scripts/torch_turbo_variants.py; PERF.md §6):
//   * Alpha and beta from both ends at once.  A block of four warps serves
//     G = 32 / NS code blocks (lane g NS + s holds state s of block g):
//     warp 0 walks alpha, warp 1 beta, in rounds of 32 steps (a chunk).
//     With nC = ceil(L / 32) chunks and m = ceil(nC / 2), round k
//     (0 <= k < 2m) has alpha on chunk k and beta on chunk 2m - 1 - k (a
//     chunk >= nC is idle: beta's first round or alpha's last when nC is
//     odd).  Beta first walks the S tail steps.  Rounds k < m are phase 1:
//     a walk stores its NS metrics at the start of each chunk (a
//     checkpoint, to a global scratch [B', nC, NS], B' = B rounded up to
//     whole blocks of G), and in round m - 1 hands each step's metrics
//     ("x before the step": alpha_t, or beta_{t+1}) over to the other
//     walk's shared memory: they meet at the chunk edge 32 m.  Rounds
//     k >= m are phase 2: each walk goes on into the other half and emits
//     its LLRs, reading the other recursion's metric of its own state for
//     each step.  The chain is L + S steps, not 3L.
//   * The other half's metrics are replayed, not stored.  Storing every
//     step's metrics (64 MB at the serving shape, written and read once)
//     left the rounds waiting on device memory; a replay in the walking
//     warp put two chains and the emit in one in-order warp.  Here warp 2
//     (for alpha) and warp 3 (for beta) are helpers: in round k of phase 2
//     a helper replays the other recursion over the chunk its walk takes
//     in round k + 1, from that chunk's checkpoint, into the walk's shared
//     slots (a producer writes its step j to slot 31 - j, the consumer,
//     walking the other way, reads slot j at its step j).  A walk and its
//     helper meet at one named barrier a round; the four warps at one
//     between the phases.
//   * No global load on a chain.  Each walk stages the inputs (l_sys,
//     l_apriori, l_par) of its G code blocks into shared memory with
//     cp.async two rounds ahead (three buffers: its round, its helper's,
//     the one in flight); each 4-step group's inputs are read from shared
//     memory one group ahead.  Checkpoints are loaded a round ahead.
//   * Off the chain.  The emit adds the other recursion's metric to the
//     step's two edge sums (alpha by destination: w_u takes the edges into
//     a state with input u; beta by source) and stores them to shared
//     memory; after the round lane j reduces step j of each code block
//     (NS-way minima from 16-byte loads, every load before the first
//     store) and the warp writes 32 LLRs of each code block with one
//     store.  The renormalisation's group minimum is taken every R = 16
//     steps, spread over the next log2(NS) steps (one shuffle round a
//     step) and subtracted R / 2 steps after it was taken: no step waits
//     on it.  The warp's role is a broadcast value, so nvcc proves the
//     shuffles converged.
//
// Renormalisation, and why the result is still the scan's.  The scan never
// renormalises.  A walk, every R steps (j % R == R - 1 within a round),
// takes each code block's least metric Y over its NS states and R / 2
// steps later subtracts Y from every state of that block; a replay starts
// from a checkpoint and does not renormalise.  Each checkpoint, slot, edge
// sum and emitted value of a step is therefore the scan's less a constant
// of that block, recursion and step (the same for every state), and
// lapp_t, the difference of two minima over the edges of step t, each the
// sum of one alpha_t and one beta_{t+1}, cancels both constants.  Margin:
// under the exchange's contract (|l_apriori| <= LA_CLAMP = 2^17, channel
// LLRs of a few quantizer steps) every |bm| < mb = 2^18.  The least metric
// M_t moves by at most mb a step; the 2-regular trellis reaches every
// state from any other in S steps, so for t >= S the finite metrics of a
// step span at most 2 S mb.  A walk's metric of step t is held relative
// to the least metric at the step t' where the last subtracted minimum
// was taken, R / 2 <= t - t' < 3R / 2, so it lies in [-(3R/2) mb,
// (3R/2 + 2S) mb]: at R = 16, S = 3, [-24 mb, 30 mb].  A replay drifts at
// most 32 mb from its checkpoint: [-56 mb, 62 mb].  An emit sum (a walk's
// metric, a branch metric and a replayed one) lies in [-81 mb, 93 mb]
// (|..| < 2^25), far inside int32.  A held (idle) step subtracts only its
// own minimum.  The BIG-excluded alphas of the first S steps (walked or
// replayed from alpha_0) stay within S mb of BIG, never reach a minimum
// the scan's would not, and below BIG + 93 mb < 2^31 in a sum; beta_L is
// finite in every state (each state has its zero-feedback termination
// path).  So the kernel's minima are the scan's less per-step constants,
// and its lapp equals the scan's wherever the scan's own int32 sums do not
// overflow ((L + S) mb + BIG < 2^31, which holds up to L = 6144 at
// mb = 2^18).  tests/test_torch_turbo.py holds a numpy model of this
// schedule to the scan and asserts these bounds.
//
// Layouts:
//   l_sys, l_par, l_apriori  int32 [B, L]
//   l_sys_tail, l_par_tail   int32 [B, S]
//   tab   int32 [10, NS]: prev0, prev1, pu0, pu1, zp0, zp1 (the parity of
//         each incoming edge), nxt0, nxt1, par0, par1 (of each outgoing)
//   ckpt  int32 scratch of turbo_rsc_map_scratch_words(B, L, NS) words:
//         [B', nC, NS], each chunk's checkpoint by state
//   lapp  int32 [B, L]

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "bulk_copy.cuh"

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kChunk = 32;          // steps a round
constexpr int kBig = 1 << 28;
constexpr int kRawBlock = 3 * kChunk + 4;   // a code block's staged inputs
constexpr int kEmitRow = 2 * 32 + 4;        // (w0, w1) of 32 lanes + pad
// The renormalisation period: a power of two in [8, 32].
constexpr int kRenorm = 16;
// Rounds of staged inputs: the walk's, the replay's (the next round's) and
// the one in flight.
constexpr int kRawBufs = 3;

__host__ __device__ constexpr int log2_of(int n) {
  return n <= 1 ? 0 : 1 + log2_of(n / 2);
}

// Shared memory of one walk (warp 0 or 1), in int32 words: its staged
// inputs, the other recursion's metrics of two rounds, its emit rows.
template <int NS>
struct Layout {
  static constexpr int G = 32 / NS;                 // code blocks a warp
  static constexpr int S = log2_of(NS);
  // The other recursion's metrics of one code block, a chunk: 32 slots of
  // NS words, padded so that the lanes of a step hit distinct banks.
  static constexpr int kOthBlock = NS >= 4 ? 33 * NS : 32 * NS + 4;
  static constexpr int kRaw = 0;             // [kRawBufs][G][kRawBlock]
  static constexpr int kOth = kRaw + kRawBufs * G * kRawBlock;  // [2][G][..]
  static constexpr int kEmit = kOth + 2 * G * kOthBlock;  // [32][kEmitRow]
  static constexpr int kWords = kEmit + kChunk * kEmitRow;
  static_assert(kRawBlock % 4 == 0 && kOthBlock % 4 == 0 &&
                kOth % 4 == 0 && kEmit % 4 == 0 && kWords % 4 == 0,
                "16-byte alignment of the staged rows");
};

struct Args {
  const int32_t* l_sys;
  const int32_t* l_par;
  const int32_t* l_apriori;
  const int32_t* l_sys_tail;
  const int32_t* l_par_tail;
  const int32_t* tab;
  int32_t* scratch;
  int32_t* lapp;
  int B, L;
};

// A copy of 16 (or 4) bytes into shared memory, zero-filled when !ok.
__device__ __forceinline__ void copy16(int32_t* dst, const int32_t* src,
                                       bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void copy4(int32_t* dst, const int32_t* src,
                                      bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void copy_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
// The two warps of a block meet here once, between the phases.
__device__ __forceinline__ void pair_barrier() {
  asm volatile("bar.sync 1, 64;\n" ::: "memory");
}

// A lane's edges: the source lanes and the masks of their branch metrics,
// (lu & mu) + (lp & mz).
struct Edges {
  int q0, q1, mu0, mz0, mu1, mz1;
};

template <int NS, int DIR>
__device__ __forceinline__ Edges lane_edges(const int32_t* tab, int s,
                                            int gb) {
  Edges e;
  if (DIR > 0) {  // alpha: the edges into s, from prev[e, s]
    e.q0 = gb + tab[0 * NS + s];
    e.q1 = gb + tab[1 * NS + s];
    e.mu0 = -tab[2 * NS + s];
    e.mu1 = -tab[3 * NS + s];
    e.mz0 = -tab[4 * NS + s];
    e.mz1 = -tab[5 * NS + s];
  } else {        // beta: the edges out of s, to nxt[u, s], u = 0, 1
    e.q0 = gb + tab[6 * NS + s];
    e.q1 = gb + tab[7 * NS + s];
    e.mu0 = 0;
    e.mu1 = -1;
    e.mz0 = -tab[8 * NS + s];
    e.mz1 = -tab[9 * NS + s];
  }
  return e;
}

// Stage a round's inputs: l_sys, l_apriori, l_par of steps 32 c .. 32 c +
// 31 of each of the warp's code blocks, zeros past L or past B.
template <int NS, bool ALIGNED>
__device__ __forceinline__ void stage_inputs(const Args& a, int32_t* raw,
                                             int first, int c, int lane) {
  constexpr int G = 32 / NS;
  constexpr int PER = ALIGNED ? 4 : 1;      // words a copy
  constexpr int ROW = kChunk / PER;         // copies a row
  constexpr int COPIES = G * 3 * ROW;       // a multiple of 32
  const int t0 = c * kChunk;
#pragma unroll
  for (int i = 0; i < COPIES / 32; ++i) {
    const int q = lane + 32 * i;
    const int g = q / (3 * ROW), arr = (q / ROW) % 3, p = PER * (q % ROW);
    const int blk = first + g, t = t0 + p;
    const bool ok = blk < a.B && t < a.L;
    const int32_t* base =
        arr == 0 ? a.l_sys : (arr == 1 ? a.l_apriori : a.l_par);
    int32_t* dst = raw + g * kRawBlock + arr * kChunk + p;
    const int32_t* src = base + (ok ? (size_t)blk * a.L + t : 0);
    if (ALIGNED) copy16(dst, src, ok);
    else copy4(dst, src, ok);
  }
}

// The renormalisation's state: `red` the group minimum being reduced,
// `sh` its shuffle in flight, `pend` the last finished minimum.
struct Renorm {
  int red = 0, sh = 0, pend = 0;
};

// One round: 32 steps of one recursion over chunk c (steps t0 .. t0 + 31,
// walked up for DIR > 0, down for DIR < 0).  Each 4-step group's inputs
// are loaded from shared memory one group ahead.
//   PHASE2   emit, reading the other recursion's slot j at step j
//   CHECKED  the chunk runs past L: hold x there
//   SPLIT    alpha: every state's two incoming edges carry u = 0 and 1
//   STORE    store each step's metric to out[(31 - j) NS]
//   RENORM   renormalise (the helpers' replays need not)
template <int NS, int DIR, bool PHASE2, bool CHECKED, bool SPLIT, bool STORE,
          bool RENORM = true>
__device__ __forceinline__ void round_steps(
    int& x, Renorm& rn, const Edges& ed, const int (&kill)[4],
    const int32_t* raw, const int32_t* oth, int32_t* out, int32_t* emit,
    int t0, int L) {
  constexpr int LOGNS = log2_of(NS);
  constexpr int R = kRenorm;
  static_assert(LOGNS < R / 2 && kChunk % R == 0, "renormalisation steps");
  auto group = [&](int j4, int4 (&v)[3]) {
    const int p4 = DIR > 0 ? 4 * j4 : kChunk - 4 - 4 * j4;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      v[i] = *reinterpret_cast<const int4*>(raw + i * kChunk + p4);
    }
  };
  int4 cur[3], nxt[3];
  group(0, cur);
#pragma unroll
  for (int j4 = 0; j4 < kChunk / 4; ++j4) {
    if (j4 + 1 < kChunk / 4) group(j4 + 1, nxt);
    const int lsv[4] = {cur[0].x, cur[0].y, cur[0].z, cur[0].w};
    const int lav[4] = {cur[1].x, cur[1].y, cur[1].z, cur[1].w};
    const int lqv[4] = {cur[2].x, cur[2].y, cur[2].z, cur[2].w};
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int e = DIR > 0 ? kk : 3 - kk;
      const int j = 4 * j4 + kk;
      const int lu = lsv[e] + lav[e], lp = lqv[e];
      if (STORE) out[(kChunk - 1 - j) * NS] = x;
      int o = 0;
      if (PHASE2) o = oth[j * NS];
      const int bm0 = (lu & ed.mu0) + (lp & ed.mz0);
      const int bm1 = (lu & ed.mu1) + (lp & ed.mz1);
      const int c0 = __shfl_sync(kFullMask, x, ed.q0) + bm0;
      const int c1 = __shfl_sync(kFullMask, x, ed.q1) + bm1;
      const int xn = min(c0, c1);
      if (PHASE2) {
        const int v0 = c0 + o, v1 = c1 + o;
        int w0 = v0, w1 = v1;
        if (DIR > 0) {
          if (SPLIT) {  // kill[0]: edge 0 carries u = 1
            w0 = kill[0] ? v1 : v0;
            w1 = kill[0] ? v0 : v1;
          } else {      // kill[2u + e]: INT_MIN where edge e carries u
            w0 = min(max(v0, kill[0]), max(v1, kill[1]));
            w1 = min(max(v0, kill[2]), max(v1, kill[3]));
          }
        }
        *reinterpret_cast<int2*>(emit + j * kEmitRow) = make_int2(w0, w1);
      }
      if (CHECKED) {
        const int t = t0 + (DIR > 0 ? j : kChunk - 1 - j);
        x = t < L ? xn : x;
      } else {
        x = xn;
      }
      if (!RENORM) continue;
      // The group minimum of step R - 1 (mod R), one shuffle round a step
      // at steps R - 1, 0, .., LOGNS - 2, done at LOGNS - 1 and subtracted
      // at R / 2 - 1.
      const int ph = j % R;
#pragma unroll
      for (int r = 1; r <= LOGNS; ++r) {
        if (ph == r - 1) {
          rn.red = min(rn.red, rn.sh);
          if (r < LOGNS) rn.sh = __shfl_xor_sync(kFullMask, rn.red, 1 << r);
          else rn.pend = rn.red;
        }
      }
      if (ph == R / 2 - 1) x -= rn.pend;
      if (ph == R - 1) {
        rn.red = x;
        if (LOGNS > 0) rn.sh = __shfl_xor_sync(kFullMask, rn.red, 1);
      }
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) cur[i] = nxt[i];
  }
}

// Phase 2's emit: lane j reduces step j of each code block (the NS-way
// minima of w0 and w1), and the warp stores 32 LLRs of each block at once.
// Every row is loaded before the first store, so the loads' latencies
// overlap.
template <int NS, int DIR>
__device__ __forceinline__ void reduce_emit(const Args& a,
                                            const int32_t* emit_rows,
                                            int first, int t0, int lane) {
  constexpr int G = 32 / NS;
  const int t = t0 + (DIR > 0 ? lane : kChunk - 1 - lane);
  const int32_t* row = emit_rows + lane * kEmitRow;
  int llr[G];
#pragma unroll
  for (int gg = 0; gg < G; ++gg) {
    int m0 = INT_MAX, m1 = INT_MAX;
#pragma unroll
    for (int q = 0; q < NS / 2; ++q) {
      const int4 v = *reinterpret_cast<const int4*>(row + 2 * NS * gg + 4 * q);
      m0 = min(m0, min(v.x, v.z));
      m1 = min(m1, min(v.y, v.w));
    }
    llr[gg] = m1 - m0;
  }
  if (t < a.L) {
#pragma unroll
    for (int gg = 0; gg < G; ++gg) {
      if (first + gg < a.B) a.lapp[(size_t)(first + gg) * a.L + t] = llr[gg];
    }
  }
}

// The schedule both roles of a direction share.
struct Schedule {
  int L, nC, m;
  __device__ Schedule(int L_) : L(L_), nC((L_ + kChunk - 1) / kChunk),
                                m((nC + 1) / 2) {}
  // The chunk the walk of direction DIR takes in round k, and whether it
  // is one (a chunk >= nC is idle).
  template <int DIR>
  __device__ int chunk(int k) const { return DIR > 0 ? k : 2 * m - 1 - k; }
  template <int DIR>
  __device__ bool live(int k) const {
    return k < 2 * m && chunk<DIR>(k) < nC;
  }
};

// Named barriers: 1 for the block between the phases; 2 + (DIR < 0) for a
// walk and its helper in each round of phase 2.
template <int DIR>
__device__ __forceinline__ void round_barrier() {
  if (DIR > 0) asm volatile("bar.sync 2, 64;\n" ::: "memory");
  else asm volatile("bar.sync 3, 64;\n" ::: "memory");
}
__device__ __forceinline__ void phase_barrier() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

// A walk (warp 0: alpha, DIR > 0; warp 1: beta, DIR < 0).  Phase 1 stores
// its metric at the start of each chunk (a checkpoint, to the scratch) and
// hands its last chunk's metrics over to the other walk; phase 2 emits.
template <int NS, int DIR, bool ALIGNED, bool SPLIT>
__device__ __forceinline__ void walk(const Args& a, int32_t* mine,
                                     int32_t* other_walk, int first,
                                     int lane) {
  using Lay = Layout<NS>;
  constexpr int G = Lay::G, S = Lay::S;
  const int s = lane % NS, g = lane / NS, gb = lane - s;
  const int blk = first + g;
  const Schedule sc(a.L);
  const int L = sc.L, nC = sc.nC, m = sc.m;
  const Edges ed = lane_edges<NS, DIR>(a.tab, s, gb);
  // Alpha's emit by destination: w_u takes the edges into s with input u.
  const int pu0 = a.tab[2 * NS + s], pu1 = a.tab[3 * NS + s];
  int kill[4] = {0, 0, 0, 0};
  if (SPLIT) {
    kill[0] = pu0;
  } else {
    kill[0] = pu0 == 0 ? INT_MIN : INT_MAX;
    kill[1] = pu1 == 0 ? INT_MIN : INT_MAX;
    kill[2] = pu0 == 1 ? INT_MIN : INT_MAX;
    kill[3] = pu1 == 1 ? INT_MIN : INT_MAX;
  }
  constexpr int kRawBuf = G * kRawBlock, kOthBuf = G * Lay::kOthBlock;
  const int32_t* raw = mine + Lay::kRaw + g * kRawBlock;
  const int32_t* oth = mine + Lay::kOth + g * Lay::kOthBlock + s;
  int32_t* emit = mine + Lay::kEmit + 2 * lane;
  // Phase 1's last round writes into the other walk's buffer of round m.
  int32_t* hand = other_walk + Lay::kOth + (m & 1) * kOthBuf +
                  g * Lay::kOthBlock + s;
  int32_t* ckpt = a.scratch + (size_t)blk * nC * NS + s;

  int x = s == 0 ? 0 : kBig;
  Renorm rn;
  if (DIR < 0) {  // beta_L: the S tail steps from the state-0 anchor
    const bool ok = blk < a.B;
    int tu[S], tp[S];
#pragma unroll
    for (int t = 0; t < S; ++t) {
      tu[t] = ok ? a.l_sys_tail[(size_t)blk * S + t] : 0;
      tp[t] = ok ? a.l_par_tail[(size_t)blk * S + t] : 0;
    }
#pragma unroll
    for (int t = S - 1; t >= 0; --t) {
      const int c0 = __shfl_sync(kFullMask, x, ed.q0) + (tp[t] & ed.mz0);
      const int c1 =
          __shfl_sync(kFullMask, x, ed.q1) + tu[t] + (tp[t] & ed.mz1);
      x = min(c0, c1);
    }
  }

  auto stage = [&](int k) {  // round k's inputs, one group of copies
    if (sc.live<DIR>(k)) {
      stage_inputs<NS, ALIGNED>(
          a, mine + Lay::kRaw + (k % kRawBufs) * kRawBuf, first,
          sc.chunk<DIR>(k), lane);
    }
    copy_commit();
  };

  stage(0);
  stage(1);
  for (int k = 0; k < 2 * m; ++k) {
    if (k == m) {  // phase 1's stores, visible to the other warps
      __threadfence();
      phase_barrier();
    }
    stage(k + 2);
    copy_wait_prior();  // rounds k and k + 1 (the helper's) landed
    __syncwarp();
    if (k >= m) round_barrier<DIR>();
    if (!sc.live<DIR>(k)) continue;
    const int c = sc.chunk<DIR>(k);
    const int t0 = c * kChunk;
    const bool checked = t0 + kChunk > L;
    const int32_t* rb = raw + (k % kRawBufs) * kRawBuf;
    if (k < m - 1) {
      ckpt[c * NS] = x;
      if (checked) {
        round_steps<NS, DIR, false, true, SPLIT, false>(
            x, rn, ed, kill, rb, nullptr, nullptr, nullptr, t0, L);
      } else {
        round_steps<NS, DIR, false, false, SPLIT, false>(
            x, rn, ed, kill, rb, nullptr, nullptr, nullptr, t0, L);
      }
    } else if (k == m - 1) {  // the hand-over
      if (checked) {
        round_steps<NS, DIR, false, true, SPLIT, true>(
            x, rn, ed, kill, rb, nullptr, hand, nullptr, t0, L);
      } else {
        round_steps<NS, DIR, false, false, SPLIT, true>(
            x, rn, ed, kill, rb, nullptr, hand, nullptr, t0, L);
      }
    } else {
      const int32_t* ob = oth + (k & 1) * kOthBuf;
      if (checked) {
        round_steps<NS, DIR, true, true, SPLIT, false>(
            x, rn, ed, kill, rb, ob, nullptr, emit, t0, L);
      } else {
        round_steps<NS, DIR, true, false, SPLIT, false>(
            x, rn, ed, kill, rb, ob, nullptr, emit, t0, L);
      }
      __syncwarp();
      reduce_emit<NS, DIR>(a, mine + Lay::kEmit, first, t0, lane);
    }
    __syncwarp();  // the buffers of round k are rewritten later
  }
}

// A walk's helper (warp 2 for alpha, warp 3 for beta): in each round k of
// phase 2 it replays the other recursion (direction -DIR) over the chunk
// the walk takes in round k + 1, from that recursion's checkpoint, into the
// walk's slots of round k + 1, from the walk's staged inputs.
template <int NS, int DIR>
__device__ __forceinline__ void helper(const Args& a, int32_t* walk_smem,
                                       int first, int lane) {
  using Lay = Layout<NS>;
  constexpr int G = Lay::G;
  constexpr int kRawBuf = G * kRawBlock, kOthBuf = G * Lay::kOthBlock;
  const int s = lane % NS, g = lane / NS, gb = lane - s;
  const int blk = first + g;
  const Schedule sc(a.L);
  const int L = sc.L, nC = sc.nC, m = sc.m;
  const Edges ed = lane_edges<NS, -DIR>(a.tab, s, gb);
  const int kill[4] = {0, 0, 0, 0};
  const int32_t* raw = walk_smem + Lay::kRaw + g * kRawBlock;
  int32_t* oth = walk_smem + Lay::kOth + g * Lay::kOthBlock + s;
  const int32_t* ckpt = a.scratch + (size_t)blk * nC * NS + s;
  auto checkpoint = [&](int k) {  // of the chunk replayed in round k
    return sc.live<DIR>(k + 1) ? ckpt[sc.chunk<DIR>(k + 1) * NS] : 0;
  };
  Renorm rn;
  phase_barrier();
  int next = checkpoint(m);
  for (int k = m; k < 2 * m; ++k) {
    int x = next;
    next = checkpoint(k + 1);
    round_barrier<DIR>();
    if (!sc.live<DIR>(k + 1)) continue;
    const int c = sc.chunk<DIR>(k + 1);
    const int t0 = c * kChunk;
    const int32_t* rb = raw + ((k + 1) % kRawBufs) * kRawBuf;
    int32_t* out = oth + ((k + 1) & 1) * kOthBuf;
    if (t0 + kChunk > L) {
      round_steps<NS, -DIR, false, true, false, true, false>(
          x, rn, ed, kill, rb, nullptr, out, nullptr, t0, L);
    } else {
      round_steps<NS, -DIR, false, false, false, true, false>(
          x, rn, ed, kill, rb, nullptr, out, nullptr, t0, L);
    }
  }
}

template <int NS, bool ALIGNED>
__global__ void __launch_bounds__(128)
turbo_rsc_map_kernel(Args a) {
  extern __shared__ int4 smem4[];
  int32_t* smem = reinterpret_cast<int32_t*>(smem4);
  // The warp's role as a value nvcc sees is the same across the warp (a
  // broadcast), and the code's SPLIT from uniform loads: the shuffles then
  // compile without the WARPSYNC.COLLECTIVE sequence that nvcc emits where
  // it cannot prove the warp converged.
  const int lane = threadIdx.x & 31;
  const int warp = __shfl_sync(kFullMask, threadIdx.x >> 5, 0);
  const int first = blockIdx.x * (32 / NS);
  int32_t* alpha = smem;
  int32_t* beta = smem + Layout<NS>::kWords;
  bool split = true;
#pragma unroll
  for (int st = 0; st < NS; ++st) {
    split = split && a.tab[2 * NS + st] != a.tab[3 * NS + st];
  }
  if (warp == 0) {
    if (split) {
      walk<NS, 1, ALIGNED, true>(a, alpha, beta, first, lane);
    } else {
      walk<NS, 1, ALIGNED, false>(a, alpha, beta, first, lane);
    }
  } else if (warp == 1) {
    walk<NS, -1, ALIGNED, false>(a, beta, alpha, first, lane);
  } else if (warp == 2) {
    helper<NS, 1>(a, alpha, first, lane);
  } else {
    helper<NS, -1>(a, beta, first, lane);
  }
}

template <int NS, bool ALIGNED>
int launch(const Args& a, cudaStream_t stream) {
  constexpr int kBytes = 2 * Layout<NS>::kWords * 4;
  if (kBytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        turbo_rsc_map_kernel<NS, ALIGNED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int grid = (a.B + 32 / NS - 1) / (32 / NS);
  turbo_rsc_map_kernel<NS, ALIGNED><<<grid, 128, kBytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int NS>
int launch_ns(const Args& a, cudaStream_t stream) {
  // 16-byte copies need L % 4 == 0 and 16-byte aligned rows.
  const bool aligned =
      a.L % 4 == 0 && ((reinterpret_cast<uintptr_t>(a.l_sys) |
                        reinterpret_cast<uintptr_t>(a.l_par) |
                        reinterpret_cast<uintptr_t>(a.l_apriori)) &
                       15) == 0;
  return aligned ? launch<NS, true>(a, stream) : launch<NS, false>(a, stream);
}

}  // namespace

// Words of the scratch `ckpt` that turbo_rsc_map needs for B blocks of L
// steps and NS states.
extern "C" long long turbo_rsc_map_scratch_words(int B, int L, int NS) {
  const long long G = 32 / NS, nC = (L + kChunk - 1) / kChunk;
  return (B + G - 1) / G * G * nC * NS;
}

extern "C" int turbo_rsc_map(const void* l_sys, const void* l_par,
                             const void* l_apriori, const void* l_sys_tail,
                             const void* l_par_tail, const void* tab,
                             void* ckpt, void* lapp, int B, int L, int NS,
                             int S, void* stream) {
  if ((1 << S) != NS || B < 1 || L < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.l_sys = static_cast<const int32_t*>(l_sys);
  a.l_par = static_cast<const int32_t*>(l_par);
  a.l_apriori = static_cast<const int32_t*>(l_apriori);
  a.l_sys_tail = static_cast<const int32_t*>(l_sys_tail);
  a.l_par_tail = static_cast<const int32_t*>(l_par_tail);
  a.tab = static_cast<const int32_t*>(tab);
  a.scratch = static_cast<int32_t*>(ckpt);
  a.lapp = static_cast<int32_t*>(lapp);
  a.B = B;
  a.L = L;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (NS) {
    case 2: return launch_ns<2>(a, s);
    case 4: return launch_ns<4>(a, s);
    case 8: return launch_ns<8>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
