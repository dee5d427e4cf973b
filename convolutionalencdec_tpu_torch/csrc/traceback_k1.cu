// Block tracebacks over packed decision words at NS <= 256 (W =
// ceil(NS / 32) <= 8 decision words a step): the terminated, ragged,
// masked and list (multi) walks.
//
// Four entry points:
//   traceback_k1         replaces the TPU kernel `traceback_batch_swar` in
//                        convolutionalencdec_tpu/kernels/acs_swar.py (its
//                        pallas_call at :877, kernel body `_tb_kernel_swar`
//                        -> `_tb_chunk_body_swar`, as called with
//                        msb_first=True for bytes);
//   traceback_k1_ragged  replaces `traceback_batch_swar_ragged` (pallas_call
//                        at :975, the same body with per-channel group
//                        masks) and the per-channel byte mask of its
//                        epilogue `_bytes_epilogue_ragged` (:1113);
//   traceback_k1_masked  replaces `traceback_batch_swar_masked` (pallas_call
//                        at :920, the same body with a one-hot walk start,
//                        `with_hinit`, and a byte mask per 8-step group) and,
//                        at NS 64-256, `traceback_batch_fused_masked`
//                        (acs_pallas.py, pallas_call at :1069);
//   traceback_k1_multi   replaces `traceback_batch_swar_masked_multi`
//                        (pallas_call at :655, body `_tb_kernel_swar_multi`:
//                        NW one-hot walk starts per channel over one
//                        decision matrix, the tail-biting list decode's
//                        candidates).
// They compute what those kernels compute, not how: no one-hot select
// network, no group masks, no padded steps; the walk starts at the real
// last step of each channel.  At NS <= 32 (one word per step) traceback_k1
// also replaces `traceback_batch` (acs_pallas.py, pallas_call at :308, body
// `_tb_kernel`), the JAX package's traceback for NS < 64.  The four walks
// for NS >= 512 are the segment walks of traceback_wide.cu.
//
// One kernel, `narrow_walk_kernel`: every walk at every NS <= 256, a staged
// segment walk, a lane a segment (below).

// Semantics (bit for bit those of ops/viterbi.traceback_terminated plus the
// byte epilogue): walk backward from terminal state 0 at step t_actual - 1;
// at step t read decision d of the current state, emit bit (cur & 1) when
// t < message_bits (<= t_actual - S: the last S steps emit nothing), and move
// to cur = (cur >> 1) | (d << (S - 1)).  Bytes are filled MSb-first, with
// the bits past message_bits of the trailing byte left zero.
//
// Ragged: channel b's length t_b is clamped to [0, T]; its walk starts at
// state 0 at step t_b - 1 and it emits t < min(t_b - S, message_bits).  The
// TPU kernel instead masks the decisions at steps >= t_b to 0 and walks
// from step T - 1: decision 0 keeps state 0 in place (every state is a
// shift register), so both walks reach step t_b - 1 in state 0 and agree
// (ops/viterbi.viterbi_decode_ragged).  The kernel writes the whole row:
// the bytes (or bits) past the channel's message are zeros.
//
// Masked: channel b walks from state starts[b] at step T - 1; a step at or
// beyond `live` counts as decision 0 (which shifts any state to 0 within S
// steps, so it cannot be skipped); it emits the bits of steps < out_steps.
// Every caller of the TPU kernel builds its group mask as a prefix of live
// groups (ops/streaming.py:460, parallel/sharding.py:389-392,
// kernels/tailbiting.py:60), so one step count is the same function.
//
// Multi: NW walks per channel, walk w of channel b from state starts[b, w]
// at step T - 1, decisions masked as in Masked; each emits only the window
// of steps [out_start, out_start + out_steps) (the message, not the
// warm-up) and stops at step out_start, below which nothing is emitted.
//
// Layouts:
//   decs  int32 [B, T_stride, W]  as written by the forward kernels
//                                 (W = ceil(NS/32); the decision of state
//                                 s = 2b + p is bit i % 32 of word i / 32,
//                                 i = p*NS/2 + b, so state s's bit is at
//                                 i = (s >> 1) | ((s & 1) << (S - 1)))
//   lengths int32 [B]             ragged only
//   starts  int32 [B]             masked only, states in [0, NS)
//           int32 [B, NW]         multi
//   out   uint8 [B, ceil(message_bits / 8)] bytes, or [B, message_bits] bits
//         (multi: [B, NW, ...], message_bits = out_steps)
//
// What bounds it on this card: the walk is a chain of dependent reads, one
// decision bit per step, through NS/8 bytes of decisions per step per
// channel (2048 * 2054 * 8 B = 33.7 MB at the main-path size, 0.0102 ms at
// 3.35 TB/s: the same bytes the forward kernel wrote).  At NS <= 256 a
// step's row is 8-32 bytes, within one 32-byte sector, so reading whole
// rows moves no byte the walk does not need.  The walk this file first
// held, a thread a channel walking 128 bytes of rows at a time in
// registers, left most of the card's 132 SMs idle (2048 channels are 64
// warps) and held T W / 32 dependent DRAM round trips and T serial steps
// in each thread's chain: 19x the bound at the main-path size (PERF.md
// §6).  At NS <= 32 a step is one word: NS/8 bytes of decision bits (the
// bound's), 4 bytes as stored, 16.8 MB at the main-path size of the K = 5
// code (2048 channels of 2052 steps), 0.0050 ms at 3.35 TB/s for any walk
// that reads them; the thread-a-channel walk took 0.1692 ms there for the
// terminated walk and 0.1852 ms for the ragged one (PERF.md §6).
//
// What the narrow walk does about that (`narrow_walk_kernel`, one warp a
// block; the generic walk of acs_generic.cu applied to the butterfly
// words; the choices below were measured in turns with each other and
// with the thread-a-channel walk by scripts/torch_narrow_walk.py, PERF.md
// §6):
//   * Segments a lane: a channel's steps are cut into segments of G steps,
//     one a lane, C lanes a channel and 32 / C channels a warp, C the
//     fewest (a power of two, at most 32) whose segments hold the launch's
//     top step in one window, so a short walk (the tail-biting decode's
//     192 steps) packs channels into a warp rather than idling lanes.  The
//     lanes walk the segments of a window of C G steps at once, windows
//     top down on the grid of multiples of C G.  A lane's chain is a
//     warm-up and G steps a window, not T.
//   * Exact on any input: a lane guesses the state at its segment's top by
//     a warm-up of WU steps from state 0 above it, or from the window's
//     known top state where the warm-up reaches the window's top, so the
//     top segment's start is exact.  Then, in rounds of one shuffle and
//     one warp vote, each segment whose start differs from the state the
//     segment above ended in is walked again from that state, until none
//     differs: the serial walk's result on any input (noisy, garbage, a
//     catastrophic code), at most a window's chain more.  A walk again
//     stops where it meets its earlier walk: at each byte's lowest step a
//     lane keeps the state (a byte: NS <= 256) beside the output byte;
//     where a walk again meets it, the bytes below and the segment's end
//     stand.
//   * Staging: two windows of each channel in shared memory, the next one
//     landing while the walk takes this one, each segment at its own row
//     of P words (an odd number of 16-byte chunks, so that the lanes' rows
//     start in different banks), by one bulk copy a segment
//     (cp.async.bulk on one mbarrier a buffer) of the 16-byte chunks that
//     hold its words.  A base that is not 16-byte aligned (a slice of a
//     batch at W = 2 and odd T starts on 8 bytes) stages the chunk that
//     holds its first word and reads at its word phase.  No step waits on
//     device memory.  Where the base is aligned to a step's row (8 bytes
//     at W = 2, 16 at W = 4 and 8; every channel's rows then are too), a
//     step loads its whole row as vectors whose addresses do not depend on
//     the state and selects the word with the state, so its chain is ALU
//     work only; else a step loads the one word its state needs (1-7%
//     slower).  Loading two 8-byte rows at once at W = 2 read 2% faster
//     alone and 0.3% of a whole decode, inside its noise: not kept.
//   * Ragged: each channel walks from its own top, t_b - 1, on the
//     launch's window grid, whose C comes from T (the lengths stay on the
//     card: no host sync), so a short channel leaves its top windows idle
//     and the warp runs the windows of its longest channel; a channel that
//     emits nothing (t_b <= S) reads nothing, and the warp writes zeros
//     past each channel's bits.  The same G and warm-ups as the
//     terminated walk.
//   * The list walk (multi) is the masked walk of B NW rows on the
//     decisions from step out_start up: row b NW + w walks channel b's
//     decisions from starts[b, w], over T - out_start steps, the live ones
//     below live - out_start, and its windows, segments and output bytes
//     count from out_start (as traceback_wide.cu's: out_start need not be a
//     multiple of 8).  The lanes are (walk, segment) pairs, C a walk and
//     32 / C walks a warp, C from the window's steps; the lanes of the
//     first of a channel's walks in the warp stage its windows, C rows for
//     each channel of the warp's rows (the launch sizes shared memory for
//     the most channels a warp's rows span), and its other walks read them
//     there.  Where a window holds whole rows of bits, a lane turns a
//     staged byte into 8 output bytes by one 8-byte store.  Its own
//     dispatch switch (`launch_multi_walk`): G 64 at NS 64-256, so that
//     the tail-biting DCI walk (56 steps of 8 walks at NS 64) is one lane
//     a walk from a known start, 32 walks (4 channels) a warp, no guess.
//     At that size (scripts/torch_narrow_walk.py, in turns, PERF.md §6):
//     a thread a walk 0.099 ms; the segment walk at G 16 with 32 staged
//     rows a warp and a byte store a bit 0.0295, G 8 / 32 / 64 0.0383 /
//     0.0325 / 0.0440; one staged window 0.0274; 2-8 warps a block
//     0.0285-0.0289; staging the warp's channels only 0.0277, with the
//     8-byte stores 0.0218; G 32 0.0184, G 64 0.0121 (one window or two, one
//     warp a block or two: within 2%); at NS 128 / 256 G 64 0.0152 /
//     0.0230 (G 8, 16, 32: 0.0373 / 0.0474, 0.0238 / 0.0302, 0.0196 /
//     0.0271).  NS 2-32 take the terminated walk's G (no list walk there
//     is timed: the tail-biting kernel entries take NS >= 64).
//   * Masked steps load nothing: the steps at or beyond `live` shift the
//     start right one bit a step, so the walk starts at step live - 1 from
//     starts[b] >> (T - live) (0 from S masked steps on), and the bits of
//     the masked steps, (starts[b] >> (T - 1 - t)) & 1, are written
//     without a walk (the byte that holds step live - 1 gets them from the
//     top segment's first byte).
//   * Output: segments are multiples of 8 steps, so a lane owns whole
//     bytes: it gathers its steps' bits MSb first in a register and stores
//     each byte to the window's bytes in shared memory; the warp then
//     writes each channel's part of the window with consecutive lanes on
//     consecutive bytes (bits: a byte a bit), the bits past the row's
//     length masked.
//   * One word a step (NS = 2 ... 32, every walk): state s's bit is bit
//     (s >> 1) | ((s & 1) << (S - 1)) of the step's word; every base is
//     4-byte aligned, so a step's row is its word, loaded whole.  The rest
//     is the walk above, the top-down check included, which keeps it exact
//     at NS = 2 and 4 (S = 1, 2), where survivors merge within a few steps
//     and a guess is most often right, on any input.  The ragged and
//     masked walks there take the terminated walk's lines: at the
//     main-path size of the K = 5 code (lengths uniform in [S + 1, T];
//     random starts, every step's bit out) G 32 / WU 16 read 0.0129 ms
//     ragged and 0.0166 masked, G 16 0.0168 / 0.0198, G 64 0.0134 /
//     0.0181, G 32 / WU 8 0.0128 / 0.0164 (within 1%), the
//     thread-a-channel walk 0.1648 / 0.1401.
//   * G and WU are template arguments, one dispatch line an
//     NS (`launch_narrow_walk`): G 64 / WU 16 at NS 2, G 32 / WU 16 at NS
//     4 ... 32, G 16 / WU 32 at NS 64, G 8 / WU 16 at 128, G 16 / WU 16
//     at 256.  At the main-path size of the K = 5 code G 32 read 0.0146
//     ms, G 16 0.0180, G 8 0.0259, G 64 0.0160; at NS 2 G 64 0.0232 and
//     G 32 0.0279; warm-ups of 8, 16 and 32 steps within 6%.  The
//     copies, not the steps, take most of a warp's time (at the
//     main-path size of NASA_K7 56% of its cycles wait for a window, a
//     step takes ~48 cycles), so warm-ups of 0-32 steps read
//     within 2% at NS 64; G 16 / WU 16 at NS 256 read 22% below G 8 /
//     WU 48; a third staged window lost 27% (fewer warps an SM fit); a G
//     chosen from the walk's length (a channel in one window at the
//     main-path size, fewer lanes a channel at 192 and 288 steps) read
//     within 3% at the main-path size and lost 19% at 288 steps.  A
//     step and a block of 8 steps unroll, the loops over blocks stay
//     `#pragma unroll 1` (nvcc 12.9 miscompiled block_1p.cu's unrolled
//     warm-up).  A plain compare, no DPX.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_copy.cuh"

namespace {


// ---- The narrow segment walk: every walk at NS = 2 ... 256 ----

constexpr unsigned kFullMask = 0xffffffffu;

// The constants of one instantiation: NS = 2^LOGNS states, W words a step
// (one at NS <= 32), segments of G = 2^LOGG steps (GB output bytes), staged
// at a pitch of P words (an odd number of 16-byte chunks); NB windows
// staged; a warp's window holds 32 segments (C lanes a channel, 32 / C
// channels).
template <int LOGNS, int LOGG>
struct NarrowShape {
  static constexpr int S = LOGNS;
  static constexpr int NS = 1 << LOGNS;
  static constexpr int W = NS > 32 ? NS / 32 : 1;
  static constexpr int G = 1 << LOGG;
  static constexpr int GB = G / 8;
  static constexpr int SEGW = G * W;
  static constexpr int P = SEGW + 4;
  static constexpr int NB = 2;
  static constexpr int STAGE = 32 * GB;  // a warp's window of output bytes
  // [NB][32][P] words, [STAGE] output bytes, [STAGE] states beside them,
  // NB mbarriers.
  static constexpr size_t kSmem =
      ((size_t)NB * 32 * P * sizeof(int32_t) + 2 * STAGE + 8 * NB + 15) &
      ~(size_t)15;
  // A step's row: its W words, loaded whole where the base is aligned to it
  // (a word at W = 1).
  static constexpr int ROW_ALIGN = W >= 4 ? 16 : 4 * W;
  static_assert(LOGNS >= 1 && LOGNS <= 8, "the narrow walk's NS");
  static_assert(G % 8 == 0, "whole output bytes a lane");
  static_assert(SEGW % 8 == 0, "a pitch of an odd number of chunks");
};

struct NarrowArgs {
  const int32_t* decs;
  const int32_t* starts;   // masked: [B]; multi: [B / nw]; else null (0)
  const int32_t* lengths;  // ragged: [B]; else null
  uint8_t* out;
  // B: the rows (multi: walks, nw a channel); T_stride: a channel's steps;
  // t_top: the walk's top step + 1 (t_actual, or live; ragged: T, each
  // channel's own from its length); T: the step below which the start
  // state stands (T, or t_actual); msg: the row's bits.  Multi: steps
  // count from `base`, the row's first step (out_start); `rows` the rows
  // of a staged window (set by the launch).
  int B, T_stride, t_top, T, msg, emit_bytes, nw, base, rows;
};

// The bit of masked step t (>= live) of a walk from state s0 at step T - 1:
// each masked step shifts the state right by one.
template <int S>
__device__ __forceinline__ unsigned masked_bit(unsigned s0, int T, int t) {
  const int k = T - 1 - t;
  return (k >= 0 && k < S) ? (s0 >> k) & 1u : 0u;
}

// The walks of `narrow_walk_kernel`: terminated or masked (a row a
// channel), ragged (each channel from its own top), multi (nw rows a
// channel, from step `base` up).
enum Mode { kPlain, kRagged, kMulti };


// How a step reads its words from the staged window: the one word its
// state needs (kWord), or its whole row as 8- or 16-byte vector loads whose
// addresses do not depend on the state, the state selecting among them
// (kRow).
enum Load { kWord, kRow };

// One lane's walk over the staged window [lo, lo + C G) of its channel.
// `base`: the channel's staged window plus its word phase.
template <int LOGNS, int LOGG, int LD>
struct NarrowWalker {
  using Sh = NarrowShape<LOGNS, LOGG>;
  static constexpr int W = Sh::W;
  static_assert(W > 1 || LD == kRow, "a one-word step loads its row");
  const int32_t* base;
  int lo;

  // The words of step t.
  __device__ __forceinline__ const int32_t* row(int t) const {
    const int r = t - lo;
    return base + (r >> LOGG) * Sh::P + (r & (Sh::G - 1)) * W;
  }

  // The state at step t - 1 from the state at step t and step t's words
  // `x`.  State s's decision is bit i % 32 of word i / 32, i = (s >> 1) |
  // ((s & 1) << (S - 1)): at W >= 2 bit (s >> 1) & 31, at W = 1 bit i of
  // the step's one word.
  static __device__ __forceinline__ unsigned step_row(const unsigned* x,
                                                      unsigned cur) {
    unsigned word;
    if constexpr (W == 1) {
      const unsigned i = (cur >> 1) | ((cur & 1u) << (Sh::S - 1));
      return (cur >> 1) | (((x[0] >> i) & 1u) << (Sh::S - 1));
    } else if constexpr (W == 2) {
      word = (cur & 1u) ? x[1] : x[0];
    } else if constexpr (W == 4) {
      const unsigned even = (cur & 64u) ? x[1] : x[0];
      const unsigned odd = (cur & 64u) ? x[3] : x[2];
      word = (cur & 1u) ? odd : even;
    } else {
      const unsigned e0 = (cur & 64u) ? x[1] : x[0];
      const unsigned e1 = (cur & 64u) ? x[3] : x[2];
      const unsigned o0 = (cur & 64u) ? x[5] : x[4];
      const unsigned o1 = (cur & 64u) ? x[7] : x[6];
      const unsigned even = (cur & 128u) ? e1 : e0;
      const unsigned odd = (cur & 128u) ? o1 : o0;
      word = (cur & 1u) ? odd : even;
    }
    return (cur >> 1) | (((word >> ((cur >> 1) & 31u)) & 1u) << (Sh::S - 1));
  }

  // Step t's row `w` into registers.
  static __device__ __forceinline__ void load_row(const int32_t* w,
                                                  unsigned* x) {
    if constexpr (W == 1) {
      x[0] = (unsigned)w[0];
    } else if constexpr (W == 2) {
      const int2 v = *reinterpret_cast<const int2*>(w);
      x[0] = v.x, x[1] = v.y;
    } else {
#pragma unroll
      for (int i = 0; i < W; i += 4) {
        const int4 v = *reinterpret_cast<const int4*>(w + i);
        x[i] = v.x, x[i + 1] = v.y, x[i + 2] = v.z, x[i + 3] = v.w;
      }
    }
  }

  // The state at step t - 1 from the state at step t, `w` step t's words.
  static __device__ __forceinline__ unsigned step(const int32_t* w,
                                                  unsigned cur) {
    if constexpr (LD == kWord) {
      const unsigned word =
          (unsigned)w[((cur >> 1) | ((cur & 1u) << (Sh::S - 1))) >> 5];
      return (cur >> 1) |
             (((word >> ((cur >> 1) & 31u)) & 1u) << (Sh::S - 1));
    } else {
      unsigned x[W];
      load_row(w, x);
      return step_row(x, cur);
    }
  }

  // The rows of the block of steps t ... t - 7 (t + 1 a multiple of 8; `w`
  // step t's words) into registers, x[s] step t - s's (kWord: none).
  static __device__ __forceinline__ void load_block(const int32_t* w,
                                                    unsigned (&x)[8][W]) {
    if constexpr (LD == kRow) {
#pragma unroll
      for (int s = 0; s < 8; ++s) load_row(w - s * W, x[s]);
    }
  }

  // Step s of a block (step t - s).
  static __device__ __forceinline__ unsigned block_step(
      const int32_t* w, const unsigned (&x)[8][W], int s, unsigned cur) {
    if constexpr (LD == kWord) {
      return step(w - s * W, cur);
    } else {
      return step_row(x[s], cur);
    }
  }

  // Walk steps hi - 1 down to lo_t (a multiple of 8) from `cur`, the state
  // at step hi - 1, emitting nothing; returns the state at step lo_t - 1.
  __device__ unsigned warm(int hi, int lo_t, unsigned cur) const {
    int t = hi - 1;
    // The steps above a multiple of 8, one at a time (kept a loop: see
    // block_1p.cu's warm-up).
#pragma unroll 1
    for (; t >= lo_t && ((t + 1) & 7); --t) cur = step(row(t), cur);
#pragma unroll 1
    for (; t >= lo_t; t -= 8) {
      const int32_t* w = row(t);  // a block lies in one segment
      unsigned x[8][W];
      load_block(w, x);
#pragma unroll
      for (int s = 0; s < 8; ++s) cur = block_step(w, x, s, cur);
    }
    return cur;
  }

  // Walk steps hi - 1 down to lo_t (a multiple of 8) from `cur`, the state
  // at step hi - 1: each step's bit MSb first into byte (t - lo) / 8 of
  // the window's bytes `st`, the state at each byte's lowest step into
  // `ck` beside it; `acc` holds the bits of hi's byte above hi.  Returns
  // the state at step lo_t - 1.  AGAIN: a walk again, which stops where the
  // state at a byte's lowest step equals the earlier walk's there, and
  // returns the earlier walk's end `end`.
  template <bool AGAIN>
  __device__ unsigned walk(int hi, int lo_t, unsigned cur, unsigned acc,
                           uint8_t* st, uint8_t* ck, unsigned end) const {
    int t = hi - 1;
#pragma unroll 1
    for (; t >= lo_t && ((t + 1) & 7); --t) {
      acc |= (cur & 1u) << (7 - (t & 7));
      if ((t & 7) == 0) {
        const int m = (t - lo) >> 3;
        st[m] = (uint8_t)acc;
        acc = 0u;
        if (AGAIN && ck[m] == cur) return end;
        ck[m] = (uint8_t)cur;
      }
      cur = step(row(t), cur);
    }
#pragma unroll 1
    for (; t >= lo_t; t -= 8) {
      const int32_t* w = row(t);  // steps t ... t - 7: one byte, one segment
      unsigned x[8][W];
      load_block(w, x);
      unsigned byte = 0u;
#pragma unroll
      for (int s = 0; s < 7; ++s) {
        byte |= (cur & 1u) << s;
        cur = block_step(w, x, s, cur);
      }
      byte |= (cur & 1u) << 7;
      const int m = (t - 7 - lo) >> 3;
      st[m] = (uint8_t)byte;
      if (AGAIN && ck[m] == cur) return end;
      ck[m] = (uint8_t)cur;
      cur = block_step(w, x, 7, cur);
    }
    return cur;
  }
};

// The walk: channel b from state starts[b] >> (T - t_top) (0 without
// starts) at step t_top - 1 down to step 0, in windows of C G steps on the
// grid of their multiples, top window first; C = 2^logc lanes a channel,
// 32 / C channels a warp, one warp a block.  The bits of steps >= t_top
// (masked steps) are the start's, shifted.  Ragged: channel b's t_top is
// t_b = clamp(lengths[b], 0, T) and its row's bits msg_b = min(max(t_b -
// S, 0), msg) (0 bits: it walks nothing); the warp runs the windows of its
// longest channel, a window wholly above a channel's top is nothing to
// that channel, and the bytes (bits) of a row past msg_b are written 0.
// Multi: row r is walk r % nw of channel r / nw, from starts[r], on the
// channel's decisions from step `base` on (steps, windows and the byte grid
// count from there); the lanes of the first of a channel's walks in the
// warp stage its windows and its other walks there read them.
template <int LOGNS, int LOGG, int WU, int LD, int MODE>
__global__ void __launch_bounds__(32)
narrow_walk_kernel(const NarrowArgs a, const int logc) {
  constexpr bool RAGGED = MODE == kRagged, MULTI = MODE == kMulti;
  using Sh = NarrowShape<LOGNS, LOGG>;
  constexpr int S = Sh::S, W = Sh::W, G = Sh::G, GB = Sh::GB, P = Sh::P;
  constexpr int NB = Sh::NB;
  static_assert(WU % 8 == 0, "whole blocks of warm-up");
  extern __shared__ __align__(16) int32_t wsm[];
  // The rows of a staged window: a lane's segment each, or (multi) C for
  // each channel of the warp's rows.
  const int R = MULTI ? a.rows : 32;
  const int wid = blockIdx.x;  // the warp's index in the grid
  uint8_t* const st_all = reinterpret_cast<uint8_t*>(wsm + NB * R * P);
  uint8_t* const ck_all = st_all + Sh::STAGE;
  uint64_t* const bars = reinterpret_cast<uint64_t*>(ck_all + Sh::STAGE);
  if (a.msg <= 0) return;  // rows of no bits
  const int lane = threadIdx.x;
  const int C = 1 << logc, CPW = 32 >> logc;
  const int c = lane >> logc;  // the lane's row in the warp
  const int l = lane & (C - 1);
  const int ch = wid * CPW + c;  // its row
  const bool live = ch < a.B;
  // Multi: the row's channel, and the warp's first row of that channel,
  // whose lanes stage the windows; the first staged row of the lane's
  // channel (multi: C a channel of the warp's, in order) and the lane's.
  const int chan = MULTI ? ch / a.nw : ch;
  const int c0 = MULTI ? max(chan * a.nw, wid * CPW) - wid * CPW : c;
  const int slot = MULTI ? (chan - wid * CPW / a.nw) << logc : c << logc;
  const int srow = MULTI ? slot + l : lane;
  int t_top = a.t_top, msg = a.msg;  // the lane's channel's
  if constexpr (RAGGED) {
    const int len = live ? min(max(a.lengths[ch], 0), a.T_stride) : 0;
    msg = min(max(len - S, 0), a.msg);
    t_top = msg > 0 ? len : 0;
    // The row past the channel's bits: zeros, each channel's by the warp.
    for (int cc = 0; cc < CPW; ++cc) {
      const int chn = wid * CPW + cc;
      if (chn >= a.B) break;
      const int m_c = __shfl_sync(kFullMask, msg, cc << logc);
      const int row_len = a.emit_bytes ? (a.msg + 7) >> 3 : a.msg;
      uint8_t* orow = a.out + (size_t)chn * row_len;
      for (int m = (a.emit_bytes ? (m_c + 7) >> 3 : m_c) + lane; m < row_len;
           m += 32) {
        orow[m] = 0;
      }
    }
  }
  const int top8 = (t_top + 7) & ~7;

  // The masked steps' bits: the row's bytes (bits) from step top8 on.
  if (a.starts != nullptr && top8 < a.msg) {
    for (int cc = 0; cc < CPW; ++cc) {
      const int chn = wid * CPW + cc;
      if (chn >= a.B) break;
      const unsigned s0 = (unsigned)a.starts[chn] & (Sh::NS - 1);
      if (a.emit_bytes) {
        uint8_t* orow = a.out + (size_t)chn * ((a.msg + 7) >> 3);
        for (int m = (top8 >> 3) + lane; m * 8 < a.msg; m += 32) {
          unsigned v = 0u;
          for (int q = 0; q < 8 && m * 8 + q < a.msg; ++q) {
            v |= masked_bit<S>(s0, a.T, m * 8 + q) << (7 - q);
          }
          orow[m] = (uint8_t)v;
        }
      } else {
        uint8_t* orow = a.out + (size_t)chn * a.msg;
        for (int p = top8 + lane; p < a.msg; p += 32) {
          orow[p] = (uint8_t)masked_bit<S>(s0, a.T, p);
        }
      }
    }
  }
  // The warp's longest walk (ragged; else every channel's).
  const int t_max = RAGGED ? __reduce_max_sync(kFullMask, t_top) : t_top;
  if (t_max <= 0) return;

  // The lane's channel: its start, the state at step t_top - 1 and the
  // bits of the steps [t_top, top8) of the byte that holds step t_top - 1.
  const unsigned s0 =
      (a.starts != nullptr && live) ? (unsigned)a.starts[ch] & (Sh::NS - 1)
                                    : 0u;
  const int drop = a.T - t_top;  // masked steps above the walk
  unsigned top = drop >= S ? 0u : s0 >> drop;
  unsigned head = 0u;
  for (int t = t_top; t < top8; ++t) {
    head |= masked_bit<S>(s0, a.T, t) << (7 - (t & 7));
  }
  const size_t chan_words = (size_t)a.T_stride * W;
  const int32_t* const chb =
      a.decs + (size_t)(live ? chan : 0) * chan_words +
      (MULTI ? (size_t)a.base * W : 0);
  // The word phase of the channel's rows: every segment starts a multiple
  // of 4 words (G W) from the channel's first word, so at this phase.
  const int ph = (int)((reinterpret_cast<uintptr_t>(chb) >> 2) & 3);
  const int WS = C * G;
  const int n_win = (t_max + WS - 1) / WS;

  // Stage window j into buffer `buf`: the lane's segment as one bulk copy
  // of the 16-byte chunks that hold its words, to its own row of P words;
  // every lane arrives on the buffer's mbarrier.
  auto fetch = [&](int j, int buf) {
    const int sa = j * WS + l * G;
    const int hi = min(j * WS + WS, t_top);
    if (j >= 0 && live && sa < hi && c0 == c) {
      const uintptr_t g0 = reinterpret_cast<uintptr_t>(chb + (size_t)sa * W);
      const uintptr_t g1 =
          reinterpret_cast<uintptr_t>(chb + (size_t)min(sa + G, hi) * W);
      const uintptr_t src = g0 & ~uintptr_t(15);
      // The buffer's earlier reads (generic proxy) before the copy's
      // writes (async proxy).
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      bulk_copy(wsm + (buf * R + srow) * P,
                reinterpret_cast<const void*>(src),
                (unsigned)(((g1 + 15) & ~uintptr_t(15)) - src), bars + buf);
    } else {
      bar_arrive(bars + buf);
    }
  };

  if (lane == 0) {
    for (int b = 0; b < NB; ++b) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 32;\n" ::"r"(
                       smem_addr(bars + b))
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();
  // Window n_win - 1 - i goes to buffer i % NB, NB - 1 windows ahead.
#pragma unroll 1
  for (int i = 0; i < NB - 1; ++i) fetch(n_win - 1 - i, i);
#pragma unroll 1
  for (int i = 0; i < n_win; ++i) {
    const int j = n_win - 1 - i;
    const int buf = i % NB;
    if (j >= NB - 1) fetch(j - (NB - 1), (i + NB - 1) % NB);
    bar_wait(bars + buf, (unsigned)(i / NB) & 1u);
    __syncwarp();
    const int lo = j * WS;
    const int hi = min(lo + WS, t_top);
    const NarrowWalker<LOGNS, LOGG, LD> wk{
        wsm + (buf * R + slot) * P + ph, lo};
    uint8_t* const st = st_all + (c << logc) * GB;
    uint8_t* const ck = ck_all + (c << logc) * GB;
    const int sa = lo + l * G;
    const int sb = min(sa + G, hi);
    const bool mine = live && sa < hi;
    const bool top_seg = sb == hi;  // its start is the window's top state
    // The guess: a warm-up of WU steps from state 0 above the segment, or
    // from the window's top state where the warm-up reaches the top.
    unsigned start = top;
    if (mine && !top_seg) {
      const int t0 = min(sb - 1 + WU, hi - 1);
      start = wk.warm(t0 + 1, sb, t0 == hi - 1 ? top : 0u);
    }
    unsigned end = mine ? wk.template walk<false>(
                              sb, sa, start, sb == t_top ? head : 0u, st, ck,
                              0u)
                        : 0u;
    // Top down: a segment whose start differs from the state the segment
    // above ended in walks again from that state, until none differs.
    for (;;) {
      const unsigned above = __shfl_down_sync(kFullMask, end, 1);
      const bool redo = mine && !top_seg && above != start;
      if (!__any_sync(kFullMask, redo)) break;
      if (redo) {
        start = above;
        end = wk.template walk<true>(sb, sa, start, 0u, st, ck, end);
      }
    }
    top = __shfl_sync(kFullMask, end, c << logc);  // the state at lo - 1
    __syncwarp();
    // The window's bits, each channel's part written by the whole warp; the
    // top window's byte that holds step t_top - 1 carries the masked bits.
    const int bit_hi = min(hi == t_top ? top8 : hi, msg);
    if (MULTI && !a.emit_bytes && lo == 0 && bit_hi == a.msg &&
        (a.msg & 7) == 0 && (reinterpret_cast<uintptr_t>(a.out) & 7) == 0) {
      // The window holds the warp's whole rows of bits (as bytes), one run
      // of memory: a lane a staged byte, its 8 bits MSb first as 8 bytes of
      // 0 or 1, one 8-byte store.
      const int bpr = a.msg >> 3;  // staged bytes a row
      const int n = min(CPW, a.B - wid * CPW) * bpr;
      uint2* const o =
          reinterpret_cast<uint2*>(a.out) + (size_t)wid * CPW * bpr;
      for (int k = lane; k < n; k += 32) {
        const int r = k / bpr;
        const unsigned v = st_all[(r << logc) * GB + (k - r * bpr)];
        // Bit i of a nibble, reversed, to byte i: the four shifted copies
        // of the nibble never overlap.
        o[k] = make_uint2(
            ((__brev(v) >> 24) & 15u) * 0x00204081u & 0x01010101u,
            (__brev(v) >> 28) * 0x00204081u & 0x01010101u);
      }
    } else {
      for (int cc = 0; cc < CPW; ++cc) {
        const int chn = wid * CPW + cc;
        if (chn >= a.B) break;
        const int bh =
            RAGGED ? __shfl_sync(kFullMask, bit_hi, cc << logc) : bit_hi;
        if (bh <= lo) {  // the channel's bits end below the window
          if (RAGGED) continue;
          break;
        }
        const uint8_t* sc = st_all + (cc << logc) * GB;
        if (a.emit_bytes) {
          uint8_t* orow = a.out + (size_t)chn * ((a.msg + 7) >> 3);
          const int byte_lo = lo >> 3;
          for (int m = byte_lo + lane; m * 8 < bh; m += 32) {
            unsigned v = sc[m - byte_lo];
            const int rem = bh - m * 8;  // bits of the byte kept
            if (rem < 8) v &= 0xffu << (8 - rem);
            orow[m] = (uint8_t)v;
          }
        } else {
          uint8_t* orow = a.out + (size_t)chn * a.msg;
          for (int p = lo + lane; p < bh; p += 32) {
            orow[p] = (uint8_t)((sc[(p - lo) >> 3] >> (7 - (p & 7))) & 1u);
          }
        }
      }
    }
    __syncwarp();  // the buffer and the bytes are free for window j - NB
  }
}

template <int LOGNS, int LOGG, int WU, int LD, int MODE>
int launch_narrow_kernel(const NarrowArgs& a, cudaStream_t s) {
  using Sh = NarrowShape<LOGNS, LOGG>;
  auto* kernel = narrow_walk_kernel<LOGNS, LOGG, WU, LD, MODE>;
  if constexpr (Sh::kSmem > 48 * 1024) {  // at most
    static const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Sh::kSmem);
    if (attr != cudaSuccess) return static_cast<int>(attr);
  }
  // C: the fewest lanes (a power of two, at most 32) whose segments hold
  // the walk in one window.
  const int segs = (a.t_top + Sh::G - 1) >> LOGG;
  int logc = 0;
  while (logc < 5 && (1 << logc) < segs) ++logc;
  const int cpw = 32 >> logc;
  NarrowArgs b = a;
  size_t smem = Sh::kSmem;
  if constexpr (MODE == kMulti) {
    // The channels a warp's cpw rows span, nw rows a channel, at most.
    const int K = min(cpw, (cpw + a.nw - 2) / a.nw + 1);
    b.rows = K << logc;
    // Those rows only: each row's P words are whole 16-byte chunks.
    smem -= (size_t)Sh::NB * (32 - b.rows) * Sh::P * sizeof(int32_t);
  }
  kernel<<<(a.B + cpw - 1) / cpw, 32, smem, s>>>(b, logc);
  return static_cast<int>(cudaGetLastError());
}

// The walk at one NS: with row loads where the decisions' base is aligned
// to a step's row (8 bytes at W = 2, 16 at W = 4 and 8; every channel's
// rows, and a list walk's rows from any step, then are too; at W = 1 every
// base, a word), else a word a step; the ragged and list walks as
// instantiations of their own, so that the others compile as they would
// without them.
template <int LOGNS, int LOGG, int WU, int LD, bool MULTI>
int launch_narrow_mode(const NarrowArgs& a, cudaStream_t s) {
  if constexpr (MULTI) {
    return launch_narrow_kernel<LOGNS, LOGG, WU, LD, kMulti>(a, s);
  } else {
    if (a.lengths != nullptr) {
      return launch_narrow_kernel<LOGNS, LOGG, WU, LD, kRagged>(a, s);
    }
    return launch_narrow_kernel<LOGNS, LOGG, WU, LD, kPlain>(a, s);
  }
}

template <int LOGNS, int LOGG, int WU, bool MULTI = false>
int launch_narrow(const NarrowArgs& a, cudaStream_t s) {
  if (a.B == 0) return static_cast<int>(cudaSuccess);
  const uintptr_t base = reinterpret_cast<uintptr_t>(a.decs);
  if (base % NarrowShape<LOGNS, LOGG>::ROW_ALIGN == 0) {
    return launch_narrow_mode<LOGNS, LOGG, WU, kRow, MULTI>(a, s);
  }
  if constexpr (LOGNS >= 6) {
    return launch_narrow_mode<LOGNS, LOGG, WU, kWord, MULTI>(a, s);
  }
  return static_cast<int>(cudaErrorMisalignedAddress);  // int32 words
}

template <int LOGNS, int LOGG, int WU>
int launch_multi(const NarrowArgs& a, cudaStream_t s) {
  return launch_narrow<LOGNS, LOGG, WU, true>(a, s);
}

// The narrow walk at each NS: launch_narrow<log2 NS, log2 steps a segment,
// warm-up steps>, as measured fastest (PERF.md §6).
// tests/test_torch_narrow_walk.py, chip_smoke.py and
// scripts/torch_narrow_walk.py read this switch.
int launch_narrow_walk(const NarrowArgs& a, int NS, cudaStream_t s) {
  switch (NS) {
    case 2: return launch_narrow<1, 6, 16>(a, s);
    case 4: return launch_narrow<2, 5, 16>(a, s);
    case 8: return launch_narrow<3, 5, 16>(a, s);
    case 16: return launch_narrow<4, 5, 16>(a, s);
    case 32: return launch_narrow<5, 5, 16>(a, s);
    case 64: return launch_narrow<6, 4, 32>(a, s);
    case 128: return launch_narrow<7, 3, 16>(a, s);
    case 256: return launch_narrow<8, 4, 16>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The list walk at each NS: launch_multi<log2 NS, log2 steps a segment,
// warm-up steps>, as measured fastest (PERF.md §6).
// tests/test_torch_narrow_walk.py, chip_smoke.py and
// scripts/torch_narrow_walk.py read this switch.
int launch_multi_walk(const NarrowArgs& a, int NS, cudaStream_t s) {
  switch (NS) {
    case 2: return launch_multi<1, 6, 16>(a, s);
    case 4: return launch_multi<2, 5, 16>(a, s);
    case 8: return launch_multi<3, 5, 16>(a, s);
    case 16: return launch_multi<4, 5, 16>(a, s);
    case 32: return launch_multi<5, 5, 16>(a, s);
    case 64: return launch_multi<6, 6, 16>(a, s);
    case 128: return launch_multi<7, 6, 16>(a, s);
    case 256: return launch_multi<8, 6, 16>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The entry points of one walk mode.
int terminated(const void* decs, void* out, int B, int T_stride,
               int t_actual, int NS, int message_bits, int emit_bytes,
               void* stream) {
  const NarrowArgs a{static_cast<const int32_t*>(decs), nullptr, nullptr,
                     static_cast<uint8_t*>(out), B, T_stride, t_actual,
                     t_actual, message_bits, emit_bytes, 1, 0};
  return launch_narrow_walk(a, NS, static_cast<cudaStream_t>(stream));
}

// The ragged walk: each channel from its own top; the launch's t_top and
// T are the rows' T, so its lanes a channel come from T.
int ragged(const void* decs, const void* lengths, void* out, int B, int T,
           int NS, int message_bits_max, int emit_bytes, void* stream) {
  const NarrowArgs a{static_cast<const int32_t*>(decs), nullptr,
                     static_cast<const int32_t*>(lengths),
                     static_cast<uint8_t*>(out), B, T, T, T,
                     message_bits_max, emit_bytes, 1, 0};
  return launch_narrow_walk(a, NS, static_cast<cudaStream_t>(stream));
}

// The masked walk: from starts[b] at step T - 1, the walk proper from
// step live - 1.
int masked(const void* decs, const void* starts, void* out, int B, int T,
           int NS, int live, int out_steps, int emit_bytes, void* stream) {
  const NarrowArgs a{static_cast<const int32_t*>(decs),
                     static_cast<const int32_t*>(starts), nullptr,
                     static_cast<uint8_t*>(out), B, T, live, T, out_steps,
                     emit_bytes, 1, 0};
  return launch_narrow_walk(a, NS, static_cast<cudaStream_t>(stream));
}

// The list walk: the masked walk of B NW rows on the decisions from step
// out_start up (T - out_start steps, the live ones below live), row b NW + w
// from starts[b, w] on channel b's decisions.
int multi(const void* decs, const void* starts, void* out, int B, int T,
          int NS, int NW, int live, int out_start, int out_steps,
          int emit_bytes, void* stream) {
  const int steps = T - out_start;
  const NarrowArgs a{static_cast<const int32_t*>(decs),
                     static_cast<const int32_t*>(starts), nullptr,
                     static_cast<uint8_t*>(out), B * NW, T,
                     min(max(live - out_start, 0), steps), steps, out_steps,
                     emit_bytes, NW, out_start};
  return launch_multi_walk(a, NS, static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" int traceback_k1(const void* decs, void* out, int B, int T_stride,
                            int t_actual, int NS, int S, int message_bits,
                            int emit_bytes, void* stream) {
  (void)S;  // the walk's NS says it
  return terminated(decs, out, B, T_stride, t_actual, NS, message_bits,
                    emit_bytes, stream);
}

// Row width message_bits_max (<= T - S) bits, or ceil(message_bits_max / 8)
// bytes; channel b keeps its first min(max(t_b - S, 0), message_bits_max).
extern "C" int traceback_k1_ragged(const void* decs, const void* lengths,
                                   void* out, int B, int T, int NS, int S,
                                   int message_bits_max, int emit_bytes,
                                   void* stream) {
  (void)S;  // the walk's NS says it
  return ragged(decs, lengths, out, B, T, NS, message_bits_max, emit_bytes,
                stream);
}

// Walk from starts[b] at step T - 1, decision 0 at steps >= live; row width
// out_steps bits, or ceil(out_steps / 8) bytes.
extern "C" int traceback_k1_masked(const void* decs, const void* starts,
                                   void* out, int B, int T, int NS, int S,
                                   int live, int out_steps, int emit_bytes,
                                   void* stream) {
  (void)S;  // the walk's NS says it
  return masked(decs, starts, out, B, T, NS, live, out_steps, emit_bytes,
                stream);
}

// NW walks per channel, walk (b, w) from starts[b, w] at step T - 1,
// decision 0 at steps >= live; row (b, w) holds the window [out_start,
// out_start + out_steps): out_steps bits, or ceil(out_steps / 8) bytes.
extern "C" int traceback_k1_multi(const void* decs, const void* starts,
                                  void* out, int B, int T, int NS, int S,
                                  int NW, int live, int out_start,
                                  int out_steps, int emit_bytes,
                                  void* stream) {
  (void)S;  // the walk's NS says it
  return multi(decs, starts, out, B, T, NS, NW, live, out_start, out_steps,
               emit_bytes, stream);
}
