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
// renormalisation.  (The TPU kernel expresses termination as 2^20 input
// penalties instead and differs from the scan on the S termination steps,
// in value only.)
//
// The dropped sums.  Since relu(q) - relu(-q) = q, an edge's cost is
// N_t + (the sum of the q_j over the edge's 1 bits), N_t = sum_j relu(-q_j)
// the same for every edge of step t.  The kernel drops N_t from every edge
// metric of both recursions.  Its alpha'_{t+1}(d) is then alpha_{t+1}(d)
// - (N_0 + ... + N_t), and its beta'_{t+1}(d) is beta_{t+1}(d) - (N_{t+1} +
// ... + N_{T-1}): a min of candidates that all carry the same offset is
// the min less that offset, BIG-valued states included.  So alpha'_{t+1} +
// beta'_{t+1} = alpha_{t+1} + beta_{t+1} - (N_0 + ... + N_{T-1}) at every
// state d: one constant for all states and all t, which cancels in L_t's
// difference of two minima.  No output needs the sums added back (K4,
// acs_soft_k1.cu, must: its final metrics are an output).  The values stay
// inside int32 with room: the wrapper's envelope T n 128 < 2^28 bounds
// every true alpha and beta by BIG + T n 127 < 2^29 and every offset by T n
// 127 < 2^28, so every alpha', beta' lies in (-2^28, 2^29) and every sum of
// two in (-2^29, 2^30).  Every candidate is computed exactly: the kernel
// equals the scan on every entry, the termination steps' ~2^28 values
// included.
//
// Layouts:
//   qllrs  int8  [B, T, n]
//   cb     int32 [NS/2]          coded segment of edge (src b, input 0)
//   ckpt   int32 [B, nC, NS]     scratch: alpha'_{32 c}, natural order
//   llrs   int32 [B, T]
//
// What bounds it on this card: three passes of the butterfly recurrence
// over T (forward, replay, beta), each step NS/2 butterflies of 6 int32
// operations that depend on the step before, plus the emit (an add and a
// min per state and step).  Bytes are small: n LLR bytes read twice and 4
// bytes written per step, NS * 4 bytes of checkpoint per 32 steps.  With a
// warp a channel and 2048 channels (15.5 warps an SM) the card's issue
// bounds it, and among its instructions those of the shared-memory and
// shuffle pipe (shuffles, shared loads and stores, warp reductions) first:
// taking four of the sixteen such instructions a step out (the stage read
// four steps at a time, the LLR kept in a register) cut it by 18% at the
// main-path size, where taking two integer selects out moved it 0.4%
// (scripts/torch_maxlogmap_variants.py, PERF.md §6).
//
// What the design does about that (K4's step, acs_soft_k1.cu, in all three
// passes; each piece measured in turns with the parent's build):
//   - One warp per channel, metrics in registers; lane l owns butterflies
//     32 j + l (j < NS/64) and the states 32 m + l (m < NS/32) in natural
//     order.  The steps run in blocks of 32, fully unrolled, one block a
//     checkpoint.  The backward's last, shorter chunk runs at NS = 64, n
//     <= 4 the same unrolled code with beta's steps past T skipped, else a
//     loop of its steps (unrolled and guarded, its second copy of the
//     block's code read 21% slower at NS = 128).
//   - Staged inputs: a block's LLRs are loaded a block ahead, step t0 + l
//     by lane l, which floors them once and packs the n bytes into one or
//     two words; the warp's stage holds them (and their sum for n > 4) as
//     rows of 32 words, which every lane reads four steps at a time by a
//     16-byte broadcast load.  The backward stages each chunk once for its
//     replay and its beta walk.
//   - Candidates without the relu(-q) sums (above): for n <= 4 each of a
//     butterfly's four candidates is one __dp4a of the packed bytes
//     against the lane's 0/1 byte masks of the edge's 1 or 0 bits, with the
//     source metric as its accumulator; for n = 5..8 em is two __dp4a and
//     emc the step's LLR sum less em.
//   - Two shuffles per butterfly in all three passes.  The forward is K4's
//     exchange (lanes 0-15 send their even destination first, lanes 16-31,
//     whose edge codes are complemented, their odd one).  Beta gathers
//     first: butterfly b = 32 j + l takes beta(2b) and beta(2b + 1) from
//     lanes 2l, 2l + 1 (l < 16) or 2l - 31, 2l - 32 (l >= 16), the even
//     lanes sending slot 2j in the first shuffle and the odd ones slot
//     2j + 1, the other in the second, and computes beta(b), beta(b + NS/2)
//     in natural order (the parent's took four shuffles a butterfly).
//   - NS = 64: no select at all.  Odd lanes keep their two metrics swapped
//     (state 32 + l first) in both recursions, with their edge masks
//     swapped to match: the forward's shuffles land in place, and beta's
//     sources go out as they are.  For n <= 4 the replay keeps alpha' of
//     the chunk's 32 steps in registers (64 a lane, at the 128 registers
//     that let 16 warps share an SM), so the emit reads no memory: 9%
//     faster at the main-path size than alpha' in shared memory read at
//     bit-reversed states with beta in that order.  Else the replay
//     writes the warp's 32 rows in shared memory, each lane its own words
//     (32 m + l): no bank conflicts, no barrier.
//   - The emit: a lane's states share the parity of its lane id, so a lane
//     takes one min of alpha' + beta' over its states, and two warp
//     reductions (__reduce_min_sync) of it, over the even lanes and over
//     the odd ones, give the minima; lane s keeps step s's LLR by a select
//     and the warp stores the chunk's 32 LLRs at once.  (The sums kept in
//     the rows and taken by lane s after the chunk read 5-33% slower; the
//     LLR stored by lane 0 to shared memory a step, 10% slower.)
//   - The forward does not step through the last chunk: the backward
//     replays it from its checkpoint.  The backward loads the next chunk's
//     checkpoint and LLRs a chunk ahead.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kChunk = 32;  // steps per checkpoint and per unrolled block
constexpr int kBig = 1 << 28;

// The constants of one instantiation: NS = 64 BPL states, n <= 4 (NP = 1)
// or 5..8; kWarps warps a block; SWAP (NS = 64): odd lanes' metrics
// swapped; REGS (NS = 64, n <= 4): alpha' replayed into registers; a
// warp's shared memory: its stage (32 steps' packed LLRs 0-3, 4-7 and
// sums) and, unless REGS, its 32 replayed rows of NS words.
template <int BPL, int NP>
struct MapShape {
  static constexpr int NS = 64 * BPL;
  static constexpr int HALF = NS / 2;
  static constexpr int kWarps = 4 / BPL;
  static constexpr bool SWAP = BPL == 1;
  static constexpr bool REGS = BPL == 1 && NP == 1;
  static constexpr int kWarpWords = 96 + (REGS ? 0 : 32 * NS);
  static constexpr int kSmem = kWarps * kWarpWords * 4;
  static_assert(kSmem <= 48 * 1024, "a block's shared memory");
};

// The 0/1 byte masks of a lane's butterfly with edge code c: f1's 1 bits
// 0-3 (m1) and 4-7 (h1), f2's 1 bits 0-3 (m2).  f1 is the edge's own
// metric, or its complement's where `flip` (lanes 16-31, and the other way
// round on odd lanes at NS = 64).
__device__ __forceinline__ void edge_masks(unsigned c, int n, bool flip,
                                           unsigned& m1, unsigned& m2,
                                           unsigned& h1) {
  if (flip) c = ~c;
  m1 = m2 = h1 = 0u;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (i < n) {
      const unsigned one = (c >> i) & 1u;
      if (i < 4) {
        m1 |= one << (8 * i);
        m2 |= (one ^ 1u) << (8 * i);
      } else {
        h1 |= one << (8 * (i - 4));
      }
    }
  }
}

// A butterfly's two outputs from sources a and b: v1 = min(a + f1, b +
// f2), v2 = min(a + f2, b + f1), f1 and f2 by the masks; x, y the step's
// packed LLRs 0-3 and 4-7, sum their sum.
template <int NP>
__device__ __forceinline__ void butterfly(int x, int y, int sum, unsigned m1,
                                          unsigned m2, unsigned h1, int a,
                                          int b, int& v1, int& v2) {
  if constexpr (NP == 1) {
    v1 = min(__dp4a(x, (int)m1, a), __dp4a(x, (int)m2, b));
    v2 = min(__dp4a(x, (int)m2, a), __dp4a(x, (int)m1, b));
  } else {
    const int f1 = __dp4a(x, (int)m1, __dp4a(y, (int)h1, 0));
    const int f2 = sum - f1;
    v1 = min(a + f1, b + f2);
    v2 = min(a + f2, b + f1);
  }
}

// At most 128 registers a thread: 16 warps an SM, the main path's 15.5.
template <int BPL, int NP>
__global__ void __launch_bounds__(32 * MapShape<BPL, NP>::kWarps,
                                  16 / MapShape<BPL, NP>::kWarps)
maxlogmap_k1_kernel(const int8_t* __restrict__ qllrs,
                    const int32_t* __restrict__ cb,
                    int32_t* __restrict__ ckpt, int32_t* __restrict__ llrs,
                    int B, int T, int n, int start, int terminated) {
  using Sh = MapShape<BPL, NP>;
  constexpr int NS = Sh::NS, HALF = Sh::HALF;
  constexpr bool SWAP = Sh::SWAP, REGS = Sh::REGS;
  extern __shared__ int4 map_smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int ch = blockIdx.x * Sh::kWarps + warp;
  if (ch >= B) return;  // uniform across the warp; no block barrier below
  int32_t* const sx = reinterpret_cast<int32_t*>(map_smem) +
                      warp * Sh::kWarpWords;
  int32_t* const sy = sx + 32;
  int32_t* const ss = sy + 32;
  int32_t* const rows = ss + 32;  // unless REGS: [32][NS]

  // Lane l's metrics: lo[j] of state 32 j + l + sw, hi[j] of state HALF +
  // 32 j + l - sw (sw = 32 on odd lanes at NS = 64, else 0), in both
  // recursions; the masks of butterfly 32 j + l, for the swapped sources
  // where sw.
  const bool odd = lane & 1;
  const int sw = (SWAP && odd) ? 32 : 0;
  unsigned m1[BPL], m2[BPL], h1[BPL];
#pragma unroll
  for (int j = 0; j < BPL; ++j) {
    edge_masks((unsigned)cb[32 * j + lane], n, (lane >= 16) != (sw != 0),
               m1[j], m2[j], h1[j]);
  }
  // The forward's exchange: state 32 m + l comes from lane src1 (even l)
  // or src2 (odd l) as the first or the second shuffle's.  Beta's: the
  // sources of butterfly b = 32 j + l come from lanes e1 and e2.
  const int src1 = (odd ? 16 : 0) + (lane >> 1);
  const int src2 = src1 ^ 16;
  const int e1 = lane < 16 ? 2 * lane : 2 * lane - 31;
  const int e2 = lane < 16 ? 2 * lane + 1 : 2 * lane - 32;

  // Raw LLRs of step t + lane, loaded a block ahead (a lane past T keeps
  // what it had: its stage entry is read only where no step depends on it).
  const int8_t* q_row = qllrs + (size_t)ch * T * n;
  int raw[4 * NP] = {};
  auto fetch = [&](int t) {
    if (t < T) {
#pragma unroll
      for (int i = 0; i < 4 * NP; ++i) {
        if (i < n) raw[i] = q_row[(size_t)t * n + i];
      }
    }
  };
  // The fetched step into the stage: floored at -127, packed, summed.
  auto stage_raw = [&]() {
    unsigned x = 0u, y = 0u;
    int sum = 0;
#pragma unroll
    for (int i = 0; i < 4 * NP; ++i) {
      if (i < n) {
        const int q = max(raw[i], -127);
        sum += q;
        if (i < 4) {
          x |= ((unsigned)q & 0xffu) << (8 * i);
        } else {
          y |= ((unsigned)q & 0xffu) << (8 * (i - 4));
        }
      }
    }
    __syncwarp();  // the last chunk's reads of the stage are done
    sx[lane] = (int)x;
    if constexpr (NP == 2) {
      sy[lane] = (int)y;
      ss[lane] = sum;
    }
    __syncwarp();
  };
  // fn(s, x, y, sum) for the 32 steps of a block, rising or (Down)
  // falling, the stage read four steps at a time.
  using Up = std::false_type;
  using Down = std::true_type;
  auto block = [&](auto&& fn, auto down) {
    constexpr bool DOWN = decltype(down)::value;
#pragma unroll
    for (int k0 = 0; k0 < kChunk; k0 += 4) {
      const int k = DOWN ? kChunk - 4 - k0 : k0;
      const int4 X = *reinterpret_cast<const int4*>(sx + k);
      int4 Y = {}, Z = {};
      if constexpr (NP == 2) {
        Y = *reinterpret_cast<const int4*>(sy + k);
        Z = *reinterpret_cast<const int4*>(ss + k);
      }
      const int xs[4] = {X.x, X.y, X.z, X.w};
      const int ys[4] = {Y.x, Y.y, Y.z, Y.w};
      const int zs[4] = {Z.x, Z.y, Z.z, Z.w};
#pragma unroll
      for (int i0 = 0; i0 < 4; ++i0) {
        const int i = DOWN ? 3 - i0 : i0;
        fn(k + i, xs[i], ys[i], zs[i]);
      }
    }
  };
  // The metric of slot m (state 32 m + l, or its swap) of lo / hi.
  auto slot = [](int (&lo)[BPL], int (&hi)[BPL], int m) -> int& {
    return m < BPL ? lo[m] : hi[m - BPL];
  };

  // The forward step (K4's exchange; no select where SWAP).
  int lo[BPL], hi[BPL];
  auto fstep = [&](int x, int y, int sum) {
    int v1[BPL], v2[BPL];
#pragma unroll
    for (int j = 0; j < BPL; ++j) {
      butterfly<NP>(x, y, sum, m1[j], m2[j], h1[j], lo[j], hi[j], v1[j],
                    v2[j]);
    }
#pragma unroll
    for (int i = 0; i < BPL; ++i) {
      const int x1 = __shfl_sync(kFullMask, v1[i], src1);
      const int x2 = __shfl_sync(kFullMask, v2[i], src2);
      slot(lo, hi, 2 * i) = (SWAP || !odd) ? x1 : x2;  // state 64 i + l
      slot(lo, hi, 2 * i + 1) = (SWAP || !odd) ? x2 : x1;
    }
  };

  // Forward: alpha' checkpoints at every chunk start; the last chunk is not
  // stepped through.
  const int nC = (T + kChunk - 1) / kChunk;
  int32_t* const ck_row = ckpt + (size_t)ch * nC * NS;
  int32_t* const ck_lo = ck_row + lane + sw;
  int32_t* const ck_hi = ck_row + HALF + lane - sw;
#pragma unroll
  for (int j = 0; j < BPL; ++j) {
    lo[j] = (32 * j + lane + sw == start) ? 0 : kBig;
    hi[j] = (HALF + 32 * j + lane - sw == start) ? 0 : kBig;
  }
  fetch(lane);
#pragma unroll 1
  for (int c = 0; c < nC; ++c) {
#pragma unroll
    for (int j = 0; j < BPL; ++j) {
      ck_lo[c * NS + 32 * j] = lo[j];
      ck_hi[c * NS + 32 * j] = hi[j];
    }
    if (c == nC - 1) break;
    stage_raw();
    fetch((c + 1) * kChunk + lane);
    block([&](int, int x, int y, int sum) { fstep(x, y, sum); }, Up{});
  }

  // Backward, chunk by chunk from the end.
  int blo[BPL], bhi[BPL];
#pragma unroll
  for (int j = 0; j < BPL; ++j) {
    blo[j] = (terminated && 32 * j + lane + sw != start) ? kBig : 0;
    bhi[j] = (terminated && HALF + 32 * j + lane - sw != start) ? kBig : 0;
  }
  // The replayed alpha' of the chunk's steps: in registers (REGS), else in
  // the warp's rows (lane l's words 32 m + l).
  int a_lo[REGS ? kChunk : 1], a_hi[REGS ? kChunk : 1];
  auto replay = [&](int s, int x, int y, int sum) {
    fstep(x, y, sum);
    if constexpr (REGS) {
      a_lo[s] = lo[0];
      a_hi[s] = hi[0];
    } else {
#pragma unroll
      for (int m = 0; m < 2 * BPL; ++m) {
        rows[s * NS + 32 * m + lane] = slot(lo, hi, m);
      }
    }
  };
  // Beta's step: gather beta(2b), beta(2b + 1), then the butterfly in
  // natural order.
  auto bstep = [&](int x, int y, int sum) {
    int x1[BPL], x2[BPL];
#pragma unroll
    for (int j = 0; j < BPL; ++j) {
      const int p = slot(blo, bhi, 2 * j), q = slot(blo, bhi, 2 * j + 1);
      x1[j] = __shfl_sync(kFullMask, (SWAP || !odd) ? p : q, e1);
      x2[j] = __shfl_sync(kFullMask, (SWAP || !odd) ? q : p, e2);
    }
#pragma unroll
    for (int j = 0; j < BPL; ++j) {
      butterfly<NP>(x, y, sum, m1[j], m2[j], h1[j], x1[j], x2[j], blo[j],
                    bhi[j]);
    }
  };
  // The emit of step s: alpha'_{t+1} + beta'_{t+1} over the lane's states
  // (all of its parity), the minima over the even and the odd lanes.
  const int not_even = odd ? INT_MAX : INT_MIN;
  const int not_odd = odd ? INT_MIN : INT_MAX;
  int llr = 0;  // step t0 + lane's LLR
  auto emit = [&](int s) {
    int v;
    if constexpr (REGS) {
      v = min(a_lo[s] + blo[0], a_hi[s] + bhi[0]);
    } else {
      v = INT_MAX;
#pragma unroll
      for (int m = 0; m < 2 * BPL; ++m) {
        v = min(v, rows[s * NS + 32 * m + lane] + slot(blo, bhi, m));
      }
    }
    const int m0 = __reduce_min_sync(kFullMask, max(v, not_even));
    const int m1 = __reduce_min_sync(kFullMask, max(v, not_odd));
    llr = (lane == s) ? m1 - m0 : llr;
  };
  int clo[BPL], chi[BPL];  // the checkpoint of the chunk to come
#pragma unroll
  for (int j = 0; j < BPL; ++j) {
    clo[j] = ck_lo[(nC - 1) * NS + 32 * j];
    chi[j] = ck_hi[(nC - 1) * NS + 32 * j];
  }
  fetch((nC - 1) * kChunk + lane);
  int32_t* const out_row = llrs + (size_t)ch * T;
#pragma unroll 1
  for (int c = nC - 1; c >= 0; --c) {
    const int t0 = c * kChunk;
    const int steps = min(kChunk, T - t0);
    stage_raw();
#pragma unroll
    for (int j = 0; j < BPL; ++j) {
      lo[j] = clo[j];
      hi[j] = chi[j];
    }
    if (c > 0) {
      fetch(t0 - kChunk + lane);
#pragma unroll
      for (int j = 0; j < BPL; ++j) {
        clo[j] = ck_lo[(c - 1) * NS + 32 * j];
        chi[j] = ck_hi[(c - 1) * NS + 32 * j];
      }
    }
    // Replay alpha'_{t0 + s + 1}; then beta back through the chunk's
    // steps.  The last, shorter chunk: with REGS all 32 steps replayed (past
    // T from stale inputs, never read) and beta's past T skipped, else a
    // loop of its steps.
    auto beta = [&](int s, int x, int y, int sum) {
      emit(s);
      bstep(x, y, sum);
    };
    if constexpr (REGS) {
      block(replay, Up{});
      if (steps == kChunk) {
        block(beta, Down{});
      } else {
        block([&](int s, int x, int y, int sum) {
          if (s < steps) beta(s, x, y, sum);
        }, Down{});
      }
    } else if (steps == kChunk) {
      block(replay, Up{});
      block(beta, Down{});
    } else {
#pragma unroll 1
      for (int s = 0; s < steps; ++s) {
        replay(s, sx[s], NP == 2 ? sy[s] : 0, NP == 2 ? ss[s] : 0);
      }
#pragma unroll 1
      for (int s = steps - 1; s >= 0; --s) {
        beta(s, sx[s], NP == 2 ? sy[s] : 0, NP == 2 ? ss[s] : 0);
      }
    }
    if (lane < steps) out_row[t0 + lane] = llr;
  }
}

struct Args {
  const int8_t* qllrs;
  const int32_t* cb;
  int32_t* ckpt;
  int32_t* llrs;
  int B, T, n, start, terminated;
};

template <int BPL, int NP>
void launch(const Args& a, cudaStream_t s) {
  using Sh = MapShape<BPL, NP>;
  const dim3 block(32 * Sh::kWarps);
  const dim3 grid((a.B + Sh::kWarps - 1) / Sh::kWarps);
  maxlogmap_k1_kernel<BPL, NP><<<grid, block, Sh::kSmem, s>>>(
      a.qllrs, a.cb, a.ckpt, a.llrs, a.B, a.T, a.n, a.start, a.terminated);
}

template <int BPL>
bool launch_n(const Args& a, cudaStream_t s) {
  if (a.n < 1 || a.n > 8) return false;
  if (a.n <= 4) {
    launch<BPL, 1>(a, s);
  } else {
    launch<BPL, 2>(a, s);
  }
  return true;
}

}  // namespace

extern "C" int maxlogmap_k1(const void* qllrs, const void* cb, void* ckpt,
                            void* llrs, int B, int T, int NS, int n,
                            int start, int terminated, void* stream) {
  const Args a{static_cast<const int8_t*>(qllrs),
               static_cast<const int32_t*>(cb), static_cast<int32_t*>(ckpt),
               static_cast<int32_t*>(llrs), B, T, n, start, terminated};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool ok = false;
  switch (NS) {
    case 64: ok = launch_n<1>(a, s); break;
    case 128: ok = launch_n<2>(a, s); break;
    case 256: ok = launch_n<4>(a, s); break;
    default: break;
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
