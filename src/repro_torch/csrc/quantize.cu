// int8 symmetric group quantization, and its fused dequantize-and-add.
//
// quantize replaces the Pallas TPU kernel
// repro/kernels/quantize.py:quantize (pallas_call at line 104);
// dequant_add replaces repro/kernels/quantize.py:dequant_add (line 159).
// The arithmetic and its bitwise parity with torch: csrc/quant_ops.cuh.
//
//   quantize:    x (rows, cols) f32/bf16 -> codes (rows, cols) int8 and
//                scales (rows, ng) f32, ng = ceil(cols / g).
//   dequant_add: out = (acc.f32 + codes * scale).astype(acc.dtype) over
//                (rows, cols), acc f32/bf16.
//
// Bound: bytes.  quantize reads x once and writes the codes and scales
// once (itemsize + 1 bytes per element, 4 per group) for a handful of
// operations per element; dequant_add reads acc, codes and scales once
// and writes the result once.  Design: one block per (row, group) tile,
// each thread owning 16 bytes of x (4 f32 or 8 bf16) and loading them in
// one vector load where the row width and pointers allow it.  quantize
// keeps the values in registers while the block reduces the group's amax
// (warp shuffles, then one value per warp through shared memory), so x
// is read exactly once.  The ragged last group of a row is bounded per
// column, not padded: no copy of x is made, unlike the TPU kernel whose
// wrapper pads to whole (row_tile, group) tiles.
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

constexpr int64_t kMaxGrid = 0x7fffffff;

template <typename T, int VEC, bool V>
__global__ void __launch_bounds__(1024)
    quantize_kernel(const T* __restrict__ x, int8_t* __restrict__ codes,
                    float* __restrict__ scales, int64_t rows, int64_t cols,
                    int64_t g, int64_t ng) {
  __shared__ float sm[33];
  const int64_t tiles = rows * ng;
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int64_t row = tile / ng, c0 = (tile - row * ng) * g;
    const int glen = static_cast<int>(cols - c0 < g ? cols - c0 : g);
    const int64_t base = row * cols + c0;
    float v[VEC];
    float m = 0.0f;
    if (V) {
      const int j = lane_col<VEC, V>(0);
      if (j < glen) {
        const Pack<T, VEC> p =
            *reinterpret_cast<const Pack<T, VEC>*>(x + base + j);
#pragma unroll
        for (int i = 0; i < VEC; ++i) v[i] = to_f(p.v[i]);
      }
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        if (j < glen) m = fmaxf(m, fabsf(v[i]));
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const int j = lane_col<VEC, V>(i);
        if (j < glen) {
          v[i] = to_f(x[base + j]);
          m = fmaxf(m, fabsf(v[i]));
        }
      }
    }
    const float scale = quant_scale(block_max(m, sm));
    if (threadIdx.x == 0) scales[tile] = scale;
    if (V) {
      const int j = lane_col<VEC, V>(0);
      if (j < glen) {
        Pack<int8_t, VEC> q;
#pragma unroll
        for (int i = 0; i < VEC; ++i) q.v[i] = quant_code(v[i], scale);
        *reinterpret_cast<Pack<int8_t, VEC>*>(codes + base + j) = q;
      }
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const int j = lane_col<VEC, V>(i);
        if (j < glen) codes[base + j] = quant_code(v[i], scale);
      }
    }
  }
}

template <typename T, int VEC, bool V>
__global__ void __launch_bounds__(1024)
    dequant_add_kernel(const T* __restrict__ acc,
                       const int8_t* __restrict__ codes,
                       const float* __restrict__ scales, T* __restrict__ out,
                       int64_t rows, int64_t cols, int64_t g, int64_t ng) {
  const int64_t tiles = rows * ng;
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int64_t row = tile / ng, c0 = (tile - row * ng) * g;
    const int glen = static_cast<int>(cols - c0 < g ? cols - c0 : g);
    const int64_t base = row * cols + c0;
    const float s = scales[tile];
    if (V) {
      const int j = lane_col<VEC, V>(0);
      if (j < glen) {
        Pack<T, VEC> a = *reinterpret_cast<const Pack<T, VEC>*>(acc + base + j);
        const Pack<int8_t, VEC> q =
            *reinterpret_cast<const Pack<int8_t, VEC>*>(codes + base + j);
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          a.v[i] = from_f<T>(__fadd_rn(to_f(a.v[i]), dequant(q.v[i], s)));
        *reinterpret_cast<Pack<T, VEC>*>(out + base + j) = a;
      }
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const int j = lane_col<VEC, V>(i);
        if (j < glen)
          out[base + j] = from_f<T>(
              __fadd_rn(to_f(acc[base + j]), dequant(codes[base + j], s)));
      }
    }
  }
}

// The vector path needs every group start on a 16-byte boundary of x and
// a VEC-byte boundary of the codes: cols and g multiples of VEC, and the
// base pointers aligned.
template <typename T>
bool vector_ok(int64_t cols, int64_t g, const void* x, const void* codes,
               const void* other) {
  constexpr int kVec = 16 / sizeof(T);
  return cols % kVec == 0 && g % kVec == 0 && aligned(x, 16) &&
         aligned(other, 16) && aligned(codes, kVec);
}

dim3 tile_grid(int64_t tiles) {
  return dim3(static_cast<unsigned int>(tiles < kMaxGrid ? tiles : kMaxGrid));
}

template <typename T>
int launch_quantize(const void* x, void* codes, void* scales, int64_t rows,
                    int64_t cols, int64_t g, cudaStream_t st) {
  constexpr int kVec = 16 / sizeof(T);
  const int64_t ng = (cols + g - 1) / g;
  const int threads = group_threads(g, kVec);
  if (threads > 1024) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid = tile_grid(rows * ng);
  const T* px = static_cast<const T*>(x);
  int8_t* pc = static_cast<int8_t*>(codes);
  float* ps = static_cast<float*>(scales);
  if (vector_ok<T>(cols, g, x, codes, nullptr)) {
    quantize_kernel<T, kVec, true><<<grid, threads, 0, st>>>(
        px, pc, ps, rows, cols, g, ng);
  } else {
    quantize_kernel<T, kVec, false><<<grid, threads, 0, st>>>(
        px, pc, ps, rows, cols, g, ng);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dequant_add(const void* acc, const void* codes, const void* scales,
                       void* out, int64_t rows, int64_t cols, int64_t g,
                       cudaStream_t st) {
  constexpr int kVec = 16 / sizeof(T);
  const int64_t ng = (cols + g - 1) / g;
  const int threads = group_threads(g, kVec);
  if (threads > 1024) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid = tile_grid(rows * ng);
  const T* pa = static_cast<const T*>(acc);
  const int8_t* pc = static_cast<const int8_t*>(codes);
  const float* ps = static_cast<const float*>(scales);
  T* po = static_cast<T*>(out);
  if (vector_ok<T>(cols, g, acc, codes, out)) {
    dequant_add_kernel<T, kVec, true><<<grid, threads, 0, st>>>(
        pa, pc, ps, po, rows, cols, g, ng);
  } else {
    dequant_add_kernel<T, kVec, false><<<grid, threads, 0, st>>>(
        pa, pc, ps, po, rows, cols, g, ng);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (rows, cols) contiguous f32 (dtype 0) or bf16 (dtype 1); codes (rows,
// cols) int8; scales (rows, ceil(cols / g)) f32; 1 <= g <= cols.
extern "C" int repro_quantize(const void* x, void* codes, void* scales,
                              int64_t rows, int64_t cols, int64_t g,
                              int dtype, void* stream) {
  if (rows < 0 || cols < 0 || g < 1 || (cols > 0 && g > cols))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0 || cols == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch_quantize<float>(x, codes, scales, rows, cols, g, st);
    case kBF16:
      return launch_quantize<__nv_bfloat16>(x, codes, scales, rows, cols, g,
                                            st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// acc and out (rows, cols) contiguous, f32 (dtype 0) or bf16 (dtype 1);
// codes (rows, cols) int8; scales (rows, ceil(cols / g)) f32.
extern "C" int repro_dequant_add(const void* acc, const void* codes,
                                 const void* scales, void* out, int64_t rows,
                                 int64_t cols, int64_t g, int dtype,
                                 void* stream) {
  if (rows < 0 || cols < 0 || g < 1 || (cols > 0 && g > cols))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0 || cols == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch_dequant_add<float>(acc, codes, scales, out, rows, cols, g,
                                       st);
    case kBF16:
      return launch_dequant_add<__nv_bfloat16>(acc, codes, scales, out, rows,
                                               cols, g, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
