// The wide walks (NS = 512 ... 16384) of terminated and masked packets over
// packed decision words.
//
// Two entry points, each launching the segment walk of this file
// (`wide_walk_kernel`) at every wide NS:
//   traceback_wide         replaces the TPU kernel `traceback_batch_swar`
//                          (convolutionalencdec_tpu/kernels/acs_swar.py,
//                          pallas_call at :877) at NS >= 512;
//   traceback_wide_masked  replaces `traceback_batch_swar_masked`
//                          (acs_swar.py, pallas_call at :920) and
//                          `traceback_batch_fused_masked` (acs_pallas.py,
//                          pallas_call at :1069, body `_tb_kernel_fused`)
//                          at NS >= 512.
// traceback_k1.cu keeps the other two wide walks (`traceback_wide_ragged`,
// `traceback_wide_multi`) and every walk below 512 states.
//
// Semantics, bit for bit those of traceback_k1.cu's terminated and masked
// walks:
//   terminated: walk backward from state 0 at step t_actual - 1 (rows are
//     T_stride steps long); at step t read decision d of the current
//     state, emit bit (cur & 1) when t < message_bits, and move to
//     cur = (cur >> 1) | (d << (S - 1));
//   masked: walk from state starts[b] at step T - 1; a step at or beyond
//     `live` counts as decision 0; emit the bits of steps < out_steps;
//   both: bits (a byte each), or bytes MSb-first with the bits past the
//     row's length in the trailing byte zero.
//
// Layouts: decs int32 [B, T_stride, W] (W = NS / 32; the decision of state
// s = 2b + p is bit i % 32 of word i / 32, i = p NS/2 + b, so the state's
// bit is at i = (s >> 1) | ((s & 1) << (S - 1))); starts int32 [B]
// (masked); out uint8 [B, ceil(L / 8)] bytes or [B, L] bits.
//
// What bounds it on this card: a step needs one bit of a row of NS / 8
// bytes (64 B to 2 KB), so the least a walk can read is one 32-byte sector
// a step: 2048 x 2062 x 32 B = 135 MB at (l) (NS = 16384), 0.04 ms at
// 3.35 TB/s.  Which word a step needs depends on the state the step
// before left, so one walk is a chain of dependent loads, each a DRAM round
// trip (a row is never read twice and the decisions are far larger than
// L2: 8.65 GB at (l)).  traceback_k1.cu's wide walk, one thread a channel,
// waits one round trip a step, T of them (575 ns a step at (l)), with 2048
// loads in flight on the whole card and 68 of 132 SMs idle.
//
// What the design does about that (each choice measured in turns with the
// others and with that one-thread walk by scripts/torch_wide_variants.py
// --walk on an H100, at B = 2048, T = 2062; PERF.md §6):
//   * Segments a lane, a warp a channel: a window of kSegs G steps is cut
//     into kSegs segments of G steps, one a lane, so a lane's chain is a
//     warm-up and G steps, not T, and B = 2048 channels put some 40,000
//     chains on the card at once.  G is a multiple of 8 (a lane owns whole
//     output bytes), chosen at launch from the packet's steps so that a
//     packet of (l)'s length is one window (T = 2062, kSegs = 20: G = 104),
//     capped by kGCap: longer packets walk windows top down, on the grid of
//     multiples of kSegs G.  16 to 24 segments a window read within 2% of
//     each other, 28 and 32 2-4% slower; two segments a lane (twice the
//     chains, half of G) lost 44% with the warm-ups of then.
//   * Exact on any input (as acs_generic.cu's walk and block_1p.cu's): a
//     lane guesses the state at its segment's top by a warm-up of kWarm
//     steps from state 0 above it, or from the window's known top state
//     where the warm-up reaches it, so the window's top segment starts
//     exact.  Then, in rounds (a shuffle and a warp vote each), every
//     segment whose start differs from the state the segment above ended
//     in is walked again from that state, until none differs: the serial
//     walk's result, at most a window's chain more on garbage (or on a
//     catastrophic code, whose survivors never merge).
//   * A walk again stops where it meets its earlier walk: at each byte's
//     lowest step the lane keeps the state beside the byte in shared
//     memory; from a step where the two walks' states agree they are one,
//     so the bytes below and the segment's end stand and the segment below
//     is not walked again.  That made guesses cheap: at (l) it took 12%
//     off at a warm-up of 24, and warm-ups of 0-8 then read within 1% of
//     each other (16 +1%, 24 +5%, 32 +11%); without it 24 read best (48
//     +6%, 96 +46%, 144 +81%).
//   * One sector a step, no staging: a step loads the one word its state
//     needs straight from device memory, read-only and not allocated in
//     L1 (the row is never read again).  Staging whole rows in shared
//     memory would move NS / 256 times the bytes (64x at (l)).  Masked
//     steps at or beyond `live` load nothing.  Offsets are 64-bit: B T W
//     is 2.16 G words at (l).  A look-ahead that loaded both candidate
//     words of the next step a step early (two loads in flight a chain)
//     lost 35-81% at NS >= 2048: scattered sectors, not the chains'
//     latency, bound the walk.
//   * One walk and one set of constants (kGCap, kWarm, kSegs) at every
//     wide NS: they were chosen at NS = 2048 and 16384, where the same
//     values read best.  acs_generic.cu's staged windows, which copy whole
//     rows in bulk, read faster where a row is 64 bytes (NS = 512) but
//     serve no main path there (PERF.md §6).
//   * Output: each lane gathers its steps' bits MSb first into bytes in
//     shared memory; the warp writes each window's part of the row with
//     consecutive lanes on consecutive bytes (bits: a byte a bit).
//   * The step loop stays `#pragma unroll 1` (nvcc 12.9 miscompiled
//     block_1p.cu's unrolled warm-up); the sectors, not instruction issue,
//     are the limit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;

// The walk's constants at every NS: segments of at most kGCap steps (a
// multiple of 8), kSegs segments a window (a lane each; lanes kSegs ... 31
// idle), kWarm warm-up steps.  tests/test_torch_wide.py, chip_smoke.py and
// scripts/torch_wide_variants.py read these three lines.
constexpr int kGCap = 128;
constexpr int kWarm = 8;
constexpr int kSegs = 20;
constexpr int kStage = kSegs * kGCap / 8;  // a window's output bytes
static_assert(kGCap % 8 == 0 && kWarm >= 0, "whole output bytes");
static_assert(kSegs >= 1 && kSegs <= 32, "a lane a segment");

enum class Walk { kTerminated, kMasked };

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
  unsigned cur;  // the state at the step being taken

  // Take step t: the state at step t - 1 from the state at step t.  A
  // masked step at or beyond `live` reads nothing and shifts in 0.
  __device__ __forceinline__ void step(const int32_t* chan, int t,
                                       int live) {
    unsigned d = 0u;
    if (M != Walk::kMasked || t < live) {
      const unsigned i = (cur >> 1) | ((cur & 1u) << (S - 1));  // its bit
      d = (load_word(chan + (size_t)t * W + (i >> 5)) >> (i & 31u)) & 1u;
    }
    cur = (cur >> 1) | (d << (S - 1));
  }

  // Walk steps hi - 1 down to lo from `cur`, the state at step hi - 1;
  // leaves the state at step lo - 1 in `cur`.  Each step t < emit_hi puts
  // its bit into the window's output bytes `st` (window base wlo; a
  // group's byte is stored at its lowest step, so a walk that stops above
  // a multiple of 8 stores nothing of that group) and, at the group's
  // lowest step, the state there into `ck`, beside the byte.  `again`: a
  // segment walked before from another start, which stops where it meets
  // its earlier walk's state at such a step (from there on both walks are
  // one: the bytes below are written, and `end`, the state the earlier
  // walk left, is the state at step lo - 1).  Returns the state at step
  // emit_hi - 1 (the segment's start), or `cur` where the walk starts
  // below it.
  __device__ unsigned walk(const int32_t* chan, int live, int hi, int lo,
                           int emit_hi, uint8_t* st, uint16_t* ck, int wlo,
                           bool again, unsigned end) {
    unsigned got = cur, acc = 0u;
#pragma unroll 1
    for (int t = hi - 1; t >= lo; --t) {
      if (t == emit_hi - 1) got = cur;
      if (t < emit_hi) {
        acc |= (cur & 1u) << (7 - (t & 7));
        if ((t & 7) == 0) {
          const int m = (t - wlo) >> 3;
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

// Each channel (a warp) from state `top` (0, or starts[b]) at step
// t_top - 1 down to step 0, in windows of kSegs G steps on the grid of
// their multiples, top window first; bits of steps < out_bits out.
template <int LOGNS, Walk M>
__global__ void __launch_bounds__(32)
wide_walk_kernel(const int32_t* __restrict__ decs,
                 const int32_t* __restrict__ starts,
                 uint8_t* __restrict__ out, int T_stride, int t_top,
                 int live, int out_bits, int emit_bytes, int G) {
  static_assert(LOGNS >= 9 && LOGNS <= 14, "the wide state counts");
  constexpr int W = (1 << LOGNS) / 32;
  __shared__ uint8_t st[kStage];
  __shared__ uint16_t ck[kStage];  // the state at each byte's lowest step
  const int b_ch = blockIdx.x;
  const int lane = threadIdx.x;
  const int32_t* chan = decs + (size_t)b_ch * T_stride * W;
  const int WS = kSegs * G;
  const int n_win = (t_top + WS - 1) / WS;
  unsigned top = (M == Walk::kMasked) ? (unsigned)starts[b_ch] : 0u;
  Chain<LOGNS, M> ch;
  for (int j = n_win - 1; j >= 0; --j) {
    const int wlo = j * WS;
    const int whi = min(wlo + WS, t_top);
    const int a = wlo + lane * G;
    const int b = min(a + G, whi);
    const bool mine = a < whi;  // false on lanes kSegs ... 31
    const bool top_seg = b == whi;
    // The guess: a warm-up of kWarm steps from state 0 above the segment,
    // or from the window's top state where it reaches the top.
    const int t0 = min(b - 1 + kWarm, whi - 1);
    ch.cur = (t0 == whi - 1) ? top : 0u;
    unsigned start = top;
    if (mine) {
      start = ch.walk(chan, live, t0 + 1, a, b, st, ck, wlo, false, 0u);
    }
    unsigned end = ch.cur;
    // Top down: a segment whose start differs from the state the segment
    // above ended in walks again from that state, until none differs.
    for (;;) {
      const unsigned above = __shfl_down_sync(kFullMask, end, 1);
      const bool redo = mine && !top_seg && above != start;
      if (!__any_sync(kFullMask, redo)) break;
      if (redo) {
        ch.cur = start = above;
        ch.walk(chan, live, b, a, b, st, ck, wlo, true, end);
        end = ch.cur;
      }
    }
    top = __shfl_sync(kFullMask, end, 0);  // the state at step wlo - 1
    __syncwarp();
    // The window's bits, the row written by the whole warp.
    const int bit_hi = min(whi, out_bits);
    if (emit_bytes) {
      uint8_t* orow = out + (size_t)b_ch * ((out_bits + 7) >> 3);
      const int byte_lo = wlo >> 3;
      for (int m = byte_lo + lane; m * 8 < bit_hi; m += 32) {
        unsigned v = st[m - byte_lo];
        const int rem = bit_hi - m * 8;  // bits of the byte kept
        if (rem < 8) v &= 0xffu << (8 - rem);
        orow[m] = (uint8_t)v;
      }
    } else {
      uint8_t* orow = out + (size_t)b_ch * out_bits;
      for (int q = wlo + lane; q < bit_hi; q += 32) {
        orow[q] = (uint8_t)((st[(q - wlo) >> 3] >> (7 - (q & 7))) & 1u);
      }
    }
    __syncwarp();  // the bytes are free for the next window
  }
}

struct WalkArgs {
  const int32_t* decs;
  const int32_t* starts;
  uint8_t* out;
  int B, T_stride, t_top, live, out_bits, emit_bytes;
};

// Segments of G steps: a multiple of 8, as few windows as kGCap allows.
template <int LOGNS, Walk M>
int launch_walk(const WalkArgs& a, cudaStream_t s) {
  const int per_lane = (a.t_top + kSegs - 1) / kSegs;
  const int g = (per_lane + 7) & ~7;
  const int G = g < 8 ? 8 : g > kGCap ? kGCap : g;
  wide_walk_kernel<LOGNS, M><<<a.B, 32, 0, s>>>(
      a.decs, a.starts, a.out, a.T_stride, a.t_top, a.live, a.out_bits,
      a.emit_bytes, G);
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
                   t_actual, message_bits, emit_bytes};
  return launch_wide_walk<Walk::kTerminated>(
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
                   static_cast<uint8_t*>(out), B, T, T, live, out_steps,
                   emit_bytes};
  return launch_wide_walk<Walk::kMasked>(
      a, NS, static_cast<cudaStream_t>(stream));
}
