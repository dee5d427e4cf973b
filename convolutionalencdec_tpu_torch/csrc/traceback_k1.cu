// Block traceback of terminated packets over packed decision words, at
// NS <= 256 (W = ceil(NS / 32) <= 8 decision words a step).
//
// Four entry points, one kernel template:
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
//                        `with_hinit`, and a byte mask per 8-step group);
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
// for NS >= 512 (`traceback_wide`, `_ragged`, `_masked`, `_multi`) are the
// segment walks of traceback_wide.cu.
//
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
//                                 i = p*NS/2 + b)
//   lengths int32 [B]             ragged only
//   starts  int32 [B]             masked only, states in [0, NS)
//           int32 [B, NW]         multi
//   out   uint8 [B, ceil(message_bits / 8)] bytes, or [B, message_bits] bits
//         (multi: [B, NW, ...], message_bits = out_steps)
//
// What bounds it on this card: the walk is a chain of dependent reads, one
// decision bit per step, through NS/8 bytes of decisions per step per
// channel (2048 * 2054 * 8 B = 33.7 MB at the main-path size, the same
// bytes the forward kernel wrote).  Read one word at a time, each step
// would wait a full memory latency.
//
// What the design does about that: one thread per channel.  Which word a
// step needs depends on the state, but which steps come next does not, so
// the thread loads the next 32 / W steps' words (128 contiguous bytes) into
// registers with independent loads, then walks them in registers; the word
// is picked by a select chain, never by a dynamic register index.  Multi
// runs one thread per (channel, walk) with the NW walks of a channel in
// adjacent lanes: their loads of the channel's 128-byte word runs are the
// same addresses, served by one transaction per warp, so the decisions are
// read from memory once for all walks (the TPU kernel's "decisions DMA'd
// once"), and each walk's start and window are its own.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 32;

enum class Walk { kTerminated, kRagged, kMasked, kMulti };

template <int W, Walk MODE>  // W: decision words per step, ceil(NS/32)
__global__ void __launch_bounds__(kThreads)
traceback_k1_kernel(const int32_t* __restrict__ decs,
                    const int32_t* __restrict__ lengths,
                    const int32_t* __restrict__ starts,
                    uint8_t* __restrict__ out,
                    int B, int T_stride, int t_actual, int S,
                    int message_bits, int emit_bytes, int live, int nw,
                    int out_start) {
  // One thread per channel, or (Multi) per (channel, walk): walk index g,
  // channel g / nw, output row g.
  const int g = blockIdx.x * kThreads + threadIdx.x;
  if (g >= B * nw) return;
  const int ch = (MODE == Walk::kMulti) ? g / nw : g;
  // Multi: the walk stops at out_start and emits step t as bit t - t_lo.
  const int t_lo = (MODE == Walk::kMulti) ? out_start : 0;

  const int32_t* row = decs + (size_t)ch * T_stride * W;
  const int row_len = emit_bytes ? (message_bits + 7) / 8 : message_bits;
  uint8_t* out_row = out + (size_t)g * row_len;
  int t_start = t_actual;
  int msg = message_bits;
  if (MODE == Walk::kRagged) {
    t_start = min(max(lengths[ch], 0), T_stride);
    msg = min(max(t_start - S, 0), message_bits);
    // The walk writes every byte (bit) below msg; zero the rest of the row.
    for (int i = emit_bytes ? (msg + 7) / 8 : msg; i < row_len; ++i) {
      out_row[i] = 0;
    }
  }
  const int top = S - 1;
  unsigned cur = (MODE == Walk::kMasked || MODE == Walk::kMulti)
                     ? (unsigned)starts[g] : 0u;
  unsigned acc = 0;
  // Step t with decision word `word` of the current state's index i.
  auto step = [&](int t, unsigned i, unsigned word) {
    unsigned d = (word >> (i & 31u)) & 1u;
    if ((MODE == Walk::kMasked || MODE == Walk::kMulti) && t >= live) d = 0u;
    const int e = t - t_lo;  // the step's place in the row
    if (e < msg) {
      const unsigned bit = cur & 1u;
      if (emit_bytes) {
        acc |= bit << (7 - (e & 7));
        if ((e & 7) == 0) {
          out_row[e >> 3] = (uint8_t)acc;
          acc = 0;
        }
      } else {
        out_row[e] = (uint8_t)bit;
      }
    }
    cur = (cur >> 1) | (d << top);
  };

  constexpr int C = 32 / W;  // steps per register chunk
  for (int t_hi = t_start - 1; t_hi >= t_lo; t_hi -= C) {
    int32_t r[C][W];
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int t = t_hi - k;
#pragma unroll
      for (int w = 0; w < W; ++w) r[k][w] = (t >= t_lo) ? row[(size_t)t * W + w] : 0;
    }
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int t = t_hi - k;
      if (t < t_lo) break;
      const unsigned i = (cur >> 1) | ((cur & 1u) << top);
      const unsigned wi = i >> 5;
      unsigned word = (unsigned)r[k][0];
#pragma unroll
      for (int w = 1; w < W; ++w) word = (wi == (unsigned)w) ? (unsigned)r[k][w] : word;
      step(t, i, word);
    }
  }
}

// The register-chunk walk of NS's words.
template <Walk MODE>
int launch(const int32_t* d, const int32_t* lengths, const int32_t* starts,
           uint8_t* o, int B, int T_stride, int t_actual, int NS, int S,
           int message_bits, int emit_bytes, int live, int nw, int out_start,
           cudaStream_t s) {
  const dim3 block(kThreads);
  const dim3 grid((B * nw + kThreads - 1) / kThreads);
#define TB_LAUNCH(W)                                                    \
  traceback_k1_kernel<W, MODE><<<grid, block, 0, s>>>(                  \
      d, lengths, starts, o, B, T_stride, t_actual, S, message_bits,    \
      emit_bytes, live, nw, out_start)
  switch (NS) {
    case 2: case 4: case 8: case 16: case 32: TB_LAUNCH(1); break;
    case 64: TB_LAUNCH(2); break;
    case 128: TB_LAUNCH(4); break;
    case 256: TB_LAUNCH(8); break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TB_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

// The entry points of one walk mode.
int terminated(const void* decs, void* out, int B, int T_stride,
               int t_actual, int NS, int S, int message_bits, int emit_bytes,
               void* stream) {
  return launch<Walk::kTerminated>(
      static_cast<const int32_t*>(decs), nullptr, nullptr,
      static_cast<uint8_t*>(out), B, T_stride, t_actual, NS, S, message_bits,
      emit_bytes, 0, 1, 0, static_cast<cudaStream_t>(stream));
}

int ragged(const void* decs, const void* lengths, void* out, int B, int T,
           int NS, int S, int message_bits_max, int emit_bytes,
           void* stream) {
  return launch<Walk::kRagged>(
      static_cast<const int32_t*>(decs), static_cast<const int32_t*>(lengths),
      nullptr, static_cast<uint8_t*>(out), B, T, T, NS, S, message_bits_max,
      emit_bytes, 0, 1, 0, static_cast<cudaStream_t>(stream));
}

int masked(const void* decs, const void* starts, void* out, int B, int T,
           int NS, int S, int live, int out_steps, int emit_bytes,
           void* stream) {
  return launch<Walk::kMasked>(
      static_cast<const int32_t*>(decs), nullptr,
      static_cast<const int32_t*>(starts), static_cast<uint8_t*>(out), B, T,
      T, NS, S, out_steps, emit_bytes, live, 1, 0,
      static_cast<cudaStream_t>(stream));
}

int multi(const void* decs, const void* starts, void* out, int B, int T,
          int NS, int S, int NW, int live, int out_start, int out_steps,
          int emit_bytes, void* stream) {
  return launch<Walk::kMulti>(
      static_cast<const int32_t*>(decs), nullptr,
      static_cast<const int32_t*>(starts), static_cast<uint8_t*>(out), B, T,
      T, NS, S, out_steps, emit_bytes, live, NW, out_start,
      static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" int traceback_k1(const void* decs, void* out, int B, int T_stride,
                            int t_actual, int NS, int S, int message_bits,
                            int emit_bytes, void* stream) {
  return terminated(decs, out, B, T_stride, t_actual, NS, S, message_bits,
                    emit_bytes, stream);
}

// Row width message_bits_max (<= T - S) bits, or ceil(message_bits_max / 8)
// bytes; channel b keeps its first min(max(t_b - S, 0), message_bits_max).
extern "C" int traceback_k1_ragged(const void* decs, const void* lengths,
                                   void* out, int B, int T, int NS, int S,
                                   int message_bits_max, int emit_bytes,
                                   void* stream) {
  return ragged(decs, lengths, out, B, T, NS, S, message_bits_max,
                emit_bytes, stream);
}

// Walk from starts[b] at step T - 1, decision 0 at steps >= live; row width
// out_steps bits, or ceil(out_steps / 8) bytes.
extern "C" int traceback_k1_masked(const void* decs, const void* starts,
                                   void* out, int B, int T, int NS, int S,
                                   int live, int out_steps, int emit_bytes,
                                   void* stream) {
  return masked(decs, starts, out, B, T, NS, S, live, out_steps, emit_bytes,
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
  return multi(decs, starts, out, B, T, NS, S, NW, live, out_start,
               out_steps, emit_bytes, stream);
}
