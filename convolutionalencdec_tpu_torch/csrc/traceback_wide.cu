// The wide walks (NS = 512 ... 16384) over packed decision words: the
// terminated, ragged, masked and list (multi) tracebacks.
//
// Four entry points, each launching the segment walk of this file
// (`wide_walk_kernel`) at every wide NS:
//   traceback_wide         replaces the TPU kernel `traceback_batch_swar`
//                          (convolutionalencdec_tpu/kernels/acs_swar.py,
//                          pallas_call at :877) at NS >= 512;
//   traceback_wide_ragged  replaces `traceback_batch_swar_ragged`
//                          (acs_swar.py, pallas_call at :975) at NS >= 512;
//   traceback_wide_masked  replaces `traceback_batch_swar_masked`
//                          (acs_swar.py, pallas_call at :920) and
//                          `traceback_batch_fused_masked` (acs_pallas.py,
//                          pallas_call at :1069, body `_tb_kernel_fused`)
//                          at NS >= 512;
//   traceback_wide_multi   replaces `traceback_batch_swar_masked_multi`
//                          (acs_swar.py, pallas_call at :655) at NS >= 512:
//                          the tail-biting list decode's candidate walks.
// traceback_k1.cu holds every walk below 512 states.
//
// Semantics, bit for bit those of traceback_k1.cu's walks of the same
// names:
//   terminated: walk backward from state 0 at step t_actual - 1 (rows are
//     T_stride steps long); at step t read decision d of the current
//     state, emit bit (cur & 1) when t < message_bits, and move to
//     cur = (cur >> 1) | (d << (S - 1));
//   ragged: channel b's length t_b clamped to [0, T]; it walks from state
//     0 at step t_b - 1 and emits the steps t < min(max(t_b - S, 0), L);
//     the rest of its row (bits or bytes) is written 0;
//   masked: walk from state starts[b] at step T - 1; a step at or beyond
//     `live` counts as decision 0; emit the bits of steps < out_steps;
//   multi: NW walks a channel, walk (b, w) as masked from starts[b, w];
//     the walk stops at step out_start and emits the window [out_start,
//     out_start + out_steps) as row (b, w), bit q of the row step
//     out_start + q;
//   all: bits (a byte each), or bytes MSb-first with the bits past the
//     row's length in the trailing byte zero.
//
// Layouts: decs int32 [B, T_stride, W] (W = NS / 32; the decision of state
// s = 2b + p is bit i % 32 of word i / 32, i = p NS/2 + b, so the state's
// bit is at i = (s >> 1) | ((s & 1) << (S - 1))); lengths int32 [B]
// (ragged); starts int32 [B] (masked) or [B, NW] (multi); out uint8
// [B, ceil(L / 8)] bytes or [B, L] bits (multi [B, NW, ...]).
//
// What bounds it on this card: a step needs one bit of a row of NS / 8
// bytes (64 B to 2 KB), so the least a walk can read is one 32-byte sector
// a step: 2048 x 2062 x 32 B = 135 MB for the terminated walk at (l)
// (NS = 16384), 0.04 ms at 3.35 TB/s; the ragged walk at (l) reads half of
// that (its lengths are uniform in [S + 1, T]), the list walk 256 walks of
// 2048 steps.  Which word a step needs depends on the state the step
// before left, so one walk is a chain of dependent loads, each a DRAM
// round trip (a row is never read twice and the decisions are far larger
// than L2: 8.65 GB at (l)).  A walk of one thread a channel waits one
// round trip a step, T of them, with B loads in flight on the whole card:
// 2048 for the terminated and ragged walks, 256 for the list walk at (l).
// With many walks (B = 2048) scattered sector reads bound the segment walk
// (PERF.md §6: time followed the sectors read); with few (the list walk's
// 256) the chains' latency does.
//
// What the design does about that (each choice measured in turns with the
// others and with the one-thread walk by scripts/torch_wide_variants.py
// --walk on an H100; PERF.md §6):
//   * Segments a lane, one to eight warps a walk: a window of P kSegs G
//     steps is cut into segments of G steps, one a lane (lanes kSegs ... 31
//     of each warp idle), so a lane's chain is a warm-up and G steps, not
//     T.  A block walks one (channel, walk) pair; P, the warps a walk, is
//     the most (up to kWarps) that keep the launch's warps within kFill:
//     B = 2048 channels take one warp each (some 40,000 chains on the card
//     at once), the 256 list walks at (l) eight (G = 16: chains of ~24
//     loads), 2.3x faster than one warp a walk and 17% faster than four.
//     More warps add warm-up sectors: two warps a walk at B = 2048 made
//     the terminated walk 11% slower.  G is a multiple of 8 (a lane owns
//     whole output bytes), one for the launch, chosen from its top step so
//     that a walk of the launch's length is one window (T = 2062, P = 1:
//     G = 104), capped by kGCap: longer walks take windows top down, on
//     the grid of multiples of P kSegs G above the walk's lowest step.
//     16 to 24 segments a warp read within 2% of each other, 28 and 32
//     2-4% slower.
//   * Exact on any input (as acs_generic.cu's walk and block_1p.cu's): a
//     lane guesses the state at its segment's top by a warm-up of kWarm
//     steps from state 0 above it, or from the window's known top state
//     where the warm-up reaches it, so the window's top segment starts
//     exact.  Then, in rounds (the segments' ends through shared memory
//     and a block vote each), every segment whose start differs from the
//     state the segment above ended in is walked again from that state,
//     until none differs: the serial walk's result, at most a window's
//     chain more on garbage (or on a catastrophic code, whose survivors
//     never merge).
//   * A walk again stops where it meets its earlier walk: at each byte's
//     lowest step the lane keeps the state beside the byte in shared
//     memory; from a step where the two walks' states agree they are one,
//     so the bytes below and the segment's end stand and the segment below
//     is not walked again.  That made guesses cheap: at (l) it took 12%
//     off at a warm-up of 24, and warm-ups of 0-8 then read within 1% of
//     each other.
//   * One sector a step, no staging: a step loads the one word its state
//     needs straight from device memory, read-only and not allocated in
//     L1 (the row is never read again).  Staging whole rows in shared
//     memory would move NS / 256 times the bytes (64x at (l)).  Masked
//     steps at or beyond `live` load nothing.  Offsets are 64-bit: B T W
//     is 2.16 G words at (l).  A look-ahead that loaded both candidate
//     words of the next step a step early lost 35-81% at NS >= 2048.
//   * The ragged walk: each channel walks from its own top on the
//     launch's window grid, so a short channel leaves its top lanes idle
//     and warms up fewer segments; a G for each channel from its own
//     length read 4-10% slower (more warm-up sectors).  A channel that
//     emits nothing (t_b <= S) reads nothing.
//   * The list walk: a walk's byte grid is relative to out_start (its
//     lowest step), which need not be a multiple of 8.  The NW walks of a
//     channel are separate blocks, each reading its own sectors: a block
//     a channel walking its NW walks in turn was 4x slower at (l).
//   * One walk and one set of constants (kGCap, kWarm, kSegs, kWarps,
//     kFill) at every wide NS and mode.  Shared memory is sized at launch
//     for the block's warps: a one-warp block takes under 1.1 KB.
//   * Output: each lane gathers its steps' bits MSb first into bytes in
//     shared memory; the block writes each window's part of the row with
//     consecutive threads on consecutive bytes (bits: a byte a bit).
//   * The step loop stays `#pragma unroll 1` (nvcc 12.9 miscompiled
//     block_1p.cu's unrolled warm-up); the sectors, not instruction issue,
//     are the limit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// The walk's constants at every NS and mode: segments of at most kGCap
// steps (a multiple of 8), kSegs segments a warp (a lane each; lanes
// kSegs ... 31 idle), kWarm warm-up steps; a walk takes the most warps,
// up to kWarps, that keep its launch's warps within kFill.
// tests/test_torch_wide.py, chip_smoke.py and scripts/torch_wide_variants.py
// read these lines.
constexpr int kGCap = 128;
constexpr int kWarm = 8;
constexpr int kSegs = 20;
constexpr int kWarps = 8;
constexpr int kFill = 2048;
static_assert(kGCap % 8 == 0 && kWarm >= 0, "whole output bytes");
static_assert(kSegs >= 1 && kSegs <= 32, "a lane a segment");
static_assert(kWarps >= 1 && (kWarps & (kWarps - 1)) == 0, "warps a walk");

// A block's shared memory at `segs` segments a window: each segment's end
// state, then the state beside each of a window's output bytes, then the
// bytes.
__host__ __device__ constexpr int stage_bytes(int segs) {
  return segs * (4 + kGCap / 8 * 3);
}
static_assert(stage_bytes(kWarps * kSegs) <= 48 * 1024, "no opt-in needed");

enum class Walk { kTerminated, kRagged, kMasked, kMulti };

// One word of the decisions: read-only, not allocated in L1.
__device__ __forceinline__ unsigned load_word(const int32_t* p) {
  unsigned v;
  asm volatile("ld.global.nc.L1::no_allocate.b32 %0, [%1];"
               : "=r"(v)
               : "l"(p));
  return v;
}

// One lane's walk: its state, one word a step.
template <int LOGNS, Walk M>
struct Chain {
  static constexpr int S = LOGNS;  // the state's bits
  static constexpr int W = (1 << LOGNS) / 32;
  static constexpr bool kMasks = M == Walk::kMasked || M == Walk::kMulti;
  unsigned cur;  // the state at the step being taken

  // Take step t: the state at step t - 1 from the state at step t.  A
  // masked step at or beyond `live` reads nothing and shifts in 0.
  __device__ __forceinline__ void step(const int32_t* chan, int t,
                                       int live) {
    unsigned d = 0u;
    if (!kMasks || t < live) {
      const unsigned i = (cur >> 1) | ((cur & 1u) << (S - 1));  // its bit
      d = (load_word(chan + (size_t)t * W + (i >> 5)) >> (i & 31u)) & 1u;
    }
    cur = (cur >> 1) | (d << (S - 1));
  }

  // Walk steps hi - 1 down to lo from `cur`, the state at step hi - 1;
  // leaves the state at step lo - 1 in `cur`.  Each step t < emit_hi puts
  // its bit into the window's output bytes `st` (window base wlo, a
  // multiple of 8 steps above the walk's lowest step, so byte m of the
  // window holds steps wlo + 8 m ... wlo + 8 m + 7, MSb first; a byte is
  // stored at its lowest step, so a walk that stops above it stores
  // nothing of it) and, at the byte's lowest step, the state there into
  // `ck`, beside the byte.  `again`: a segment walked before from another
  // start, which stops where it meets its earlier walk's state at such a
  // step (from there on both walks are one: the bytes below are written,
  // and `end`, the state the earlier walk left, is the state at step
  // lo - 1).  Returns the state at step emit_hi - 1 (the segment's
  // start), or `cur` where the walk starts below it.
  __device__ unsigned walk(const int32_t* chan, int live, int hi, int lo,
                           int emit_hi, uint8_t* st, uint16_t* ck, int wlo,
                           bool again, unsigned end) {
    unsigned got = cur, acc = 0u;
#pragma unroll 1
    for (int t = hi - 1; t >= lo; --t) {
      if (t == emit_hi - 1) got = cur;
      if (t < emit_hi) {
        const int r = t - wlo;
        acc |= (cur & 1u) << (7 - (r & 7));
        if ((r & 7) == 0) {
          const int m = r >> 3;
          st[m] = (uint8_t)acc;
          acc = 0u;
          if (again && ck[m] == cur) {
            cur = end;
            break;
          }
          ck[m] = (uint16_t)cur;
        }
      }
      step(chan, t, live);
    }
    return got;
  }
};

struct WalkArgs {
  const int32_t* decs;
  const int32_t* aux;  // lengths (ragged), starts (masked, multi), or null
  uint8_t* out;
  int B, T_stride, t_top, live, base, out_bits, emit_bytes, nw;
};

// Block g walks (channel g / nw, walk g % nw) and writes row g: from state
// `top` (0, or aux[g]) at step hi - 1 (t_top, or the ragged channel's
// length) down to step base (out_start, else 0), in windows of P kSegs G
// steps (P = blockDim.x / 32) on the grid of their multiples above base,
// top window first; bits of steps base ... base + msg - 1 out, the rest of
// the row (ragged: past the channel's message) 0.  Shared memory:
// stage_bytes(P kSegs).
template <int LOGNS, Walk M>
__global__ void __launch_bounds__(32 * kWarps)
wide_walk_kernel(const WalkArgs a, const int G) {
  static_assert(LOGNS >= 9 && LOGNS <= 14, "the wide state counts");
  constexpr int W = (1 << LOGNS) / 32;
  extern __shared__ unsigned smem[];
  const int g = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int segs = (blockDim.x >> 5) * kSegs;  // segments a window
  const int seg = (tid >> 5) * kSegs + lane;   // this lane's
  unsigned* ends = smem;  // each segment's end state
  uint16_t* ck = reinterpret_cast<uint16_t*>(ends + segs);
  uint8_t* st = reinterpret_cast<uint8_t*>(ck + segs * (kGCap / 8));
  const int32_t* chan =
      a.decs + (size_t)(g / a.nw) * a.T_stride * W;
  int hi = a.t_top, msg = a.out_bits;
  unsigned top = 0u;
  if (M == Walk::kRagged) {
    hi = min(max(a.aux[g], 0), a.T_stride);
    msg = min(max(hi - LOGNS, 0), a.out_bits);
  } else if (M == Walk::kMasked || M == Walk::kMulti) {
    top = (unsigned)a.aux[g];
  }
  const int row_len = a.emit_bytes ? (a.out_bits + 7) >> 3 : a.out_bits;
  uint8_t* orow = a.out + (size_t)g * row_len;
  for (int m = (a.emit_bytes ? (msg + 7) >> 3 : msg) + tid; m < row_len;
       m += blockDim.x) {
    orow[m] = 0;  // past the walk's bits (ragged only)
  }
  if (msg <= 0) return;  // nothing to emit: nothing to read
  const int WS = segs * G;
  const int n_win = (hi - a.base + WS - 1) / WS;
  Chain<LOGNS, M> ch;
  for (int j = n_win - 1; j >= 0; --j) {
    const int wlo = a.base + j * WS;
    const int whi = min(wlo + WS, hi);
    const int s_lo = wlo + seg * G;
    const int s_hi = min(s_lo + G, whi);
    const bool mine = lane < kSegs && s_lo < whi;
    const bool top_seg = s_hi == whi;
    // The guess: a warm-up of kWarm steps from state 0 above the segment,
    // or from the window's top state where it reaches the top.
    const int t0 = min(s_hi - 1 + kWarm, whi - 1);
    ch.cur = (t0 == whi - 1) ? top : 0u;
    unsigned start = top;
    if (mine) {
      start = ch.walk(chan, a.live, t0 + 1, s_lo, s_hi, st, ck, wlo, false,
                      0u);
    }
    unsigned end = ch.cur;
    // Top down: a segment whose start differs from the state the segment
    // above ended in walks again from that state, until none differs.
    for (;;) {
      if (mine) ends[seg] = end;
      __syncthreads();
      const unsigned above = (mine && !top_seg) ? ends[seg + 1] : start;
      const bool redo = above != start;
      if (!__syncthreads_or(redo)) break;
      if (redo) {
        ch.cur = start = above;
        ch.walk(chan, a.live, s_hi, s_lo, s_hi, st, ck, wlo, true, end);
        end = ch.cur;
      }
    }
    top = ends[0];  // the state at step wlo - 1
    // The window's bits, the row written by the whole block.
    const int r_lo = wlo - a.base;
    const int r_hi = min(whi - a.base, msg);
    if (a.emit_bytes) {
      const int byte_lo = r_lo >> 3;
      for (int m = byte_lo + tid; m * 8 < r_hi; m += blockDim.x) {
        unsigned v = st[m - byte_lo];
        const int rem = r_hi - m * 8;  // bits of the byte kept
        if (rem < 8) v &= 0xffu << (8 - rem);
        orow[m] = (uint8_t)v;
      }
    } else {
      for (int q = r_lo + tid; q < r_hi; q += blockDim.x) {
        orow[q] = (uint8_t)((st[(q - r_lo) >> 3] >> (7 - (q & 7))) & 1u);
      }
    }
    __syncthreads();  // the bytes and ends are free for the next window
  }
}

// P warps a walk: the most, up to kWarps, with the launch's warps within
// kFill.  Segments of G steps: a multiple of 8, as few windows of
// P kSegs G steps over the launch's t_top - base steps as kGCap allows
// (one G for every walk: a short ragged channel leaves its top lanes idle).
template <int LOGNS, Walk M>
int launch_walk(const WalkArgs& a, cudaStream_t s) {
  const long long walks = (long long)a.B * a.nw;
  int warps = 1;
  while (warps < kWarps && walks * warps * 2 <= kFill) warps *= 2;
  const int segs = warps * kSegs;
  const int per_lane = (a.t_top - a.base + segs - 1) / segs;
  const int g = (per_lane + 7) & ~7;
  const int G = g < 8 ? 8 : g > kGCap ? kGCap : g;
  wide_walk_kernel<LOGNS, M>
      <<<(unsigned)walks, 32 * warps, stage_bytes(segs), s>>>(a, G);
  return static_cast<int>(cudaGetLastError());
}

// The walk at each wide NS: launch_walk<log2 NS, M>.
// tests/test_torch_wide.py and chip_smoke.py read this switch.
template <Walk M>
int launch_wide_walk(const WalkArgs& a, int NS, cudaStream_t s) {
  if (a.B == 0 || a.out_bits <= 0) return static_cast<int>(cudaSuccess);
  switch (NS) {
    case 512: return launch_walk<9, M>(a, s);
    case 1024: return launch_walk<10, M>(a, s);
    case 2048: return launch_walk<11, M>(a, s);
    case 4096: return launch_walk<12, M>(a, s);
    case 8192: return launch_walk<13, M>(a, s);
    case 16384: return launch_walk<14, M>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// From state 0 at step t_actual - 1 over rows of T_stride steps; row
// width message_bits bits, or ceil(message_bits / 8) bytes.  S is
// log2 NS, which the walk takes from its instantiation.
extern "C" int traceback_wide(const void* decs, void* out, int B,
                              int T_stride, int t_actual, int NS, int S,
                              int message_bits, int emit_bytes,
                              void* stream) {
  const WalkArgs a{static_cast<const int32_t*>(decs), nullptr,
                   static_cast<uint8_t*>(out), B, T_stride, t_actual,
                   t_actual, 0, message_bits, emit_bytes, 1};
  return launch_wide_walk<Walk::kTerminated>(
      a, NS, static_cast<cudaStream_t>(stream));
}

// Row width message_bits_max (<= T - S) bits, or ceil(message_bits_max / 8)
// bytes; channel b keeps its first min(max(t_b - S, 0), message_bits_max).
extern "C" int traceback_wide_ragged(const void* decs, const void* lengths,
                                     void* out, int B, int T, int NS, int S,
                                     int message_bits_max, int emit_bytes,
                                     void* stream) {
  const WalkArgs a{static_cast<const int32_t*>(decs),
                   static_cast<const int32_t*>(lengths),
                   static_cast<uint8_t*>(out), B, T, T, T, 0,
                   message_bits_max, emit_bytes, 1};
  return launch_wide_walk<Walk::kRagged>(
      a, NS, static_cast<cudaStream_t>(stream));
}

// From starts[b] at step T - 1, decision 0 at steps >= live; row width
// out_steps bits, or ceil(out_steps / 8) bytes.
extern "C" int traceback_wide_masked(const void* decs, const void* starts,
                                     void* out, int B, int T, int NS, int S,
                                     int live, int out_steps, int emit_bytes,
                                     void* stream) {
  const WalkArgs a{static_cast<const int32_t*>(decs),
                   static_cast<const int32_t*>(starts),
                   static_cast<uint8_t*>(out), B, T, T, live, 0, out_steps,
                   emit_bytes, 1};
  return launch_wide_walk<Walk::kMasked>(
      a, NS, static_cast<cudaStream_t>(stream));
}

// NW walks a channel, walk (b, w) from starts[b, w] at step T - 1,
// decision 0 at steps >= live; row (b, w) holds the window [out_start,
// out_start + out_steps): out_steps bits, or ceil(out_steps / 8) bytes.
extern "C" int traceback_wide_multi(const void* decs, const void* starts,
                                    void* out, int B, int T, int NS, int S,
                                    int NW, int live, int out_start,
                                    int out_steps, int emit_bytes,
                                    void* stream) {
  const WalkArgs a{static_cast<const int32_t*>(decs),
                   static_cast<const int32_t*>(starts),
                   static_cast<uint8_t*>(out), B, T, T, live, out_start,
                   out_steps, emit_bytes, NW};
  return launch_wide_walk<Walk::kMulti>(
      a, NS, static_cast<cudaStream_t>(stream));
}
