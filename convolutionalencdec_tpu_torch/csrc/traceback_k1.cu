// Block traceback of terminated packets over packed decision words.
//
// Replaces the TPU kernel `traceback_batch_swar` in
// convolutionalencdec_tpu/kernels/acs_swar.py (its pallas_call at :877,
// kernel body `_tb_kernel_swar` -> `_tb_chunk_body_swar`, as called with
// msb_first=True for bytes).  It computes what that kernel computes, not
// how: no one-hot select network, no group masks, no padded steps; the walk
// starts at the real last step.
//
// Semantics (bit for bit those of ops/viterbi.traceback_terminated plus the
// byte epilogue): walk backward from terminal state 0 at step t_actual - 1;
// at step t read decision d of the current state, emit bit (cur & 1) when
// t < message_bits (<= t_actual - S: the last S steps emit nothing), and move
// to cur = (cur >> 1) | (d << (S - 1)).  Bytes are filled MSb-first, with
// the bits past message_bits of the trailing byte left zero.
//
// Layouts:
//   decs  int32 [B, T_stride, W]  as written by acs_k1_forward (W = NS/32;
//                                 the decision of state s = 2b + p is bit
//                                 i % 32 of word i / 32, i = p*NS/2 + b)
//   out   uint8 [B, ceil(message_bits / 8)] bytes, or [B, message_bits] bits
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
// is picked by a select chain, never by a dynamic register index.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 32;

template <int W>  // decision words per step = NS / 32
__global__ void __launch_bounds__(kThreads)
traceback_k1_kernel(const int32_t* __restrict__ decs,
                    uint8_t* __restrict__ out,
                    int B, int T_stride, int t_actual, int S,
                    int message_bits, int emit_bytes) {
  constexpr int C = 32 / W;  // steps per register chunk
  const int ch = blockIdx.x * kThreads + threadIdx.x;
  if (ch >= B) return;

  const int32_t* row = decs + (size_t)ch * T_stride * W;
  const int row_len = emit_bytes ? (message_bits + 7) / 8 : message_bits;
  uint8_t* out_row = out + (size_t)ch * row_len;
  const int top = S - 1;
  unsigned cur = 0;
  unsigned acc = 0;

  for (int t_hi = t_actual - 1; t_hi >= 0; t_hi -= C) {
    int32_t r[C][W];
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int t = t_hi - k;
#pragma unroll
      for (int w = 0; w < W; ++w) r[k][w] = (t >= 0) ? row[(size_t)t * W + w] : 0;
    }
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int t = t_hi - k;
      if (t < 0) break;
      const unsigned i = (cur >> 1) | ((cur & 1u) << top);
      const unsigned wi = i >> 5;
      unsigned word = (unsigned)r[k][0];
#pragma unroll
      for (int w = 1; w < W; ++w) word = (wi == (unsigned)w) ? (unsigned)r[k][w] : word;
      const unsigned d = (word >> (i & 31u)) & 1u;
      if (t < message_bits) {
        const unsigned bit = cur & 1u;
        if (emit_bytes) {
          acc |= bit << (7 - (t & 7));
          if ((t & 7) == 0) {
            out_row[t >> 3] = (uint8_t)acc;
            acc = 0;
          }
        } else {
          out_row[t] = (uint8_t)bit;
        }
      }
      cur = (cur >> 1) | (d << top);
    }
  }
}

}  // namespace

extern "C" int traceback_k1(const void* decs, void* out, int B, int T_stride,
                            int t_actual, int NS, int S, int message_bits,
                            int emit_bytes, void* stream) {
  const dim3 block(kThreads);
  const dim3 grid((B + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* d = static_cast<const int32_t*>(decs);
  auto* o = static_cast<uint8_t*>(out);
  switch (NS) {
    case 64:
      traceback_k1_kernel<2><<<grid, block, 0, s>>>(
          d, o, B, T_stride, t_actual, S, message_bits, emit_bytes);
      break;
    case 128:
      traceback_k1_kernel<4><<<grid, block, 0, s>>>(
          d, o, B, T_stride, t_actual, S, message_bits, emit_bytes);
      break;
    case 256:
      traceback_k1_kernel<8><<<grid, block, 0, s>>>(
          d, o, B, T_stride, t_actual, S, message_bits, emit_bytes);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
