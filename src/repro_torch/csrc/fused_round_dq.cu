// One compressed circulant reduce-scatter round, fused: dequantize the
// received int8 payload, (+)-fold it into the float32 head, keep, and
// requantize the next round's send rows.
//
// Replaces the Pallas TPU kernel repro/kernels/fused_round.py:
// fused_round_dq (pallas_call at line 297).  Over live (lo, cols) f32,
// received codes (nb, cols) int8 and scales (nb, ng) f32, ng = cols / g,
// for every row r and column c of group k = c / g:
//
//     v = r < nb ? live[r][c] (+) codes[r][c] * scales[r][k] : live[r][c]
//     keep[r][c] = v                                    if r <  next_lo
//     send row r - next_lo = quantize(v over group k)    if r >= next_lo
//
// nb may fall on either side of next_lo; the final round (next_lo == lo)
// writes no send.  The arithmetic and its bitwise parity with torch:
// csrc/reduce_ops.cuh (the fold) and csrc/quant_ops.cuh (dequantize,
// requantize).
//
// Bound: bytes.  live and the received payload are read once, keep and
// the send payload written once: 4*lo*cols + (nb + lo - next_lo) *
// (cols + 4*ng) + 4*next_lo*cols bytes, a few operations per element.
// Design: one block per column group (the quantization group is the unit
// that needs a reduction, its amax), looping over the lo <= p rows; each
// thread owns 16 bytes of a row (4 floats, one vector load) and keeps the
// folded values in registers while the block reduces a send row's amax,
// so nothing is read twice.  The TPU kernel's column tiles exist to fit
// VMEM; here the group is the tile.
//
// Plain C interface for ctypes; launches on the given stream, allocates
// nothing, does not synchronise, returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "quant_ops.cuh"
#include "reduce_ops.cuh"

using namespace repro;

namespace {

constexpr int kVec = 4;
constexpr int64_t kMaxGrid = 0x7fffffff;

template <int OP, bool V>
__global__ void __launch_bounds__(1024)
    fused_round_dq_kernel(const float* __restrict__ live,
                          const int8_t* __restrict__ codes,
                          const float* __restrict__ scales,
                          float* __restrict__ keep,
                          int8_t* __restrict__ send_codes,
                          float* __restrict__ send_scales, int64_t lo,
                          int64_t nb, int64_t next_lo, int64_t cols, int g,
                          int64_t ng) {
  __shared__ float sm[33];
  for (int64_t grp = blockIdx.x; grp < ng; grp += gridDim.x) {
    const int64_t c0 = grp * g;
    for (int64_t r = 0; r < lo; ++r) {
      const int64_t base = r * cols + c0;
      float v[kVec];
      // 1. load the live row, fold the dequantized received row into it
      if (V) {
        const int j = lane_col<kVec, V>(0);
        if (j < g) {
          const Pack<float, kVec> p =
              *reinterpret_cast<const Pack<float, kVec>*>(live + base + j);
#pragma unroll
          for (int i = 0; i < kVec; ++i) v[i] = p.v[i];
          if (r < nb) {
            const float s = scales[r * ng + grp];
            const Pack<int8_t, kVec> q =
                *reinterpret_cast<const Pack<int8_t, kVec>*>(codes + base + j);
#pragma unroll
            for (int i = 0; i < kVec; ++i)
              v[i] = fold_f<OP>(v[i], dequant(q.v[i], s));
          }
        }
      } else {
        const float s = r < nb ? scales[r * ng + grp] : 0.0f;
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          const int j = lane_col<kVec, V>(i);
          if (j < g) {
            v[i] = live[base + j];
            if (r < nb) v[i] = fold_f<OP>(v[i], dequant(codes[base + j], s));
          }
        }
      }
      if (r < next_lo) {
        // 2a. a kept row: store it
        if (V) {
          const int j = lane_col<kVec, V>(0);
          if (j < g) {
            Pack<float, kVec> p;
#pragma unroll
            for (int i = 0; i < kVec; ++i) p.v[i] = v[i];
            *reinterpret_cast<Pack<float, kVec>*>(keep + base + j) = p;
          }
        } else {
#pragma unroll
          for (int i = 0; i < kVec; ++i) {
            const int j = lane_col<kVec, V>(i);
            if (j < g) keep[base + j] = v[i];
          }
        }
        continue;
      }
      // 2b. a send row (uniform over the block): requantize the group
      float m = 0.0f;
#pragma unroll
      for (int i = 0; i < kVec; ++i)
        if (lane_col<kVec, V>(i) < g) m = fmaxf(m, fabsf(v[i]));
      const float scale = quant_scale(block_max(m, sm));
      const int64_t srow = r - next_lo;
      if (threadIdx.x == 0) send_scales[srow * ng + grp] = scale;
      int8_t* out = send_codes + srow * cols + c0;
      if (V) {
        const int j = lane_col<kVec, V>(0);
        if (j < g) {
          Pack<int8_t, kVec> q;
#pragma unroll
          for (int i = 0; i < kVec; ++i) q.v[i] = quant_code(v[i], scale);
          *reinterpret_cast<Pack<int8_t, kVec>*>(out + j) = q;
        }
      } else {
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          const int j = lane_col<kVec, V>(i);
          if (j < g) out[j] = quant_code(v[i], scale);
        }
      }
    }
  }
}

template <int OP>
void launch(const float* live, const int8_t* codes, const float* scales,
            float* keep, int8_t* send_codes, float* send_scales, int64_t lo,
            int64_t nb, int64_t next_lo, int64_t cols, int g, int threads,
            cudaStream_t st) {
  const int64_t ng = cols / g;
  const dim3 grid(static_cast<unsigned int>(ng < kMaxGrid ? ng : kMaxGrid));
  // Vector path: every group start a multiple of 4 elements, f32 buffers
  // 16-byte and int8 buffers 4-byte aligned.
  const bool vec = g % kVec == 0 && aligned(live, 16) && aligned(keep, 16) &&
                   aligned(codes, kVec) && aligned(send_codes, kVec);
  if (vec) {
    fused_round_dq_kernel<OP, true><<<grid, threads, 0, st>>>(
        live, codes, scales, keep, send_codes, send_scales, lo, nb, next_lo,
        cols, g, ng);
  } else {
    fused_round_dq_kernel<OP, false><<<grid, threads, 0, st>>>(
        live, codes, scales, keep, send_codes, send_scales, lo, nb, next_lo,
        cols, g, ng);
  }
}

}  // namespace

// live (lo, cols) f32, codes (nb, cols) int8, scales (nb, cols / g) f32,
// keep (next_lo, cols) f32, send_codes (lo - next_lo, cols) int8 and
// send_scales (lo - next_lo, cols / g) f32, both NULL when next_lo == lo;
// all contiguous; cols % g == 0.
extern "C" int repro_fused_round_dq(const void* live, const void* codes,
                                    const void* scales, void* keep,
                                    void* send_codes, void* send_scales,
                                    int64_t lo, int64_t nb, int64_t next_lo,
                                    int64_t cols, int64_t g, int op,
                                    void* stream) {
  const bool final_round = next_lo == lo;
  if (nb < 1 || nb > lo || next_lo < 1 || next_lo > lo || cols < 0 ||
      g < 1 || (cols > 0 && (g > cols || cols % g != 0)) ||
      (send_codes == nullptr) != final_round ||
      (send_scales == nullptr) != final_round)
    return static_cast<int>(cudaErrorInvalidValue);
  if (cols == 0) return static_cast<int>(cudaSuccess);
  const int threads = group_threads(g, kVec);
  if (threads > 1024) return static_cast<int>(cudaErrorInvalidValue);
  const float* l = static_cast<const float*>(live);
  const int8_t* c = static_cast<const int8_t*>(codes);
  const float* s = static_cast<const float*>(scales);
  float* k = static_cast<float*>(keep);
  int8_t* sc = static_cast<int8_t*>(send_codes);
  float* ss = static_cast<float*>(send_scales);
  const int gi = static_cast<int>(g);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (op) {
    case kAdd: launch<kAdd>(l, c, s, k, sc, ss, lo, nb, next_lo, cols, gi,
                            threads, st); break;
    case kMax: launch<kMax>(l, c, s, k, sc, ss, lo, nb, next_lo, cols, gi,
                            threads, st); break;
    case kMin: launch<kMin>(l, c, s, k, sc, ss, lo, nb, next_lo, cols, gi,
                            threads, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
