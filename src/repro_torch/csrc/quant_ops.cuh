// int8 symmetric group quantization on the card, shared by quantize.cu
// and fused_round_dq.cu, so both quantize bitwise alike.
//
// Per (row, group) of g columns, as repro/kernels/ref.py:quantize_ref:
//
//     scale = amax * _INV127 + _EPS
//     code  = clip(round(x / scale), -127, 127)        (round half to even)
//     deq   = float(code) * scale
//
// Bitwise parity with the plain PyTorch version (separate torch kernels,
// so every operation rounds once):
//   * nvcc contracts a*b + c into one FMA by default (-fmad=true); the
//     products and sums here are __fmul_rn / __fadd_rn, which it never
//     contracts, and the quotient is __fdiv_rn (IEEE, not the fast
//     reciprocal);
//   * rintf rounds half to even, as torch.round does (roundf would not);
//   * no flush to zero: x / scale with scale near 1e-30 gives denormals,
//     and torch keeps them;
//   * amax is a max, exact in any order, so the block reduction's order
//     cannot change it.
// NaN and inf lie outside the wire's contract (the int8 cast of NaN is
// implementation-defined in both frameworks).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

// The reference's Python floats 1.0 / 127.0 and 1e-30 as the float32
// values JAX's weak typing makes of them (numpy: np.float32(1 / 127) is
// 0x3c010204, np.float32(1e-30) is 0x0da24260).
constexpr float kInv127 = 0x1.020408p-7f;
constexpr float kEps = 0x1.4484cp-100f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float quant_scale(float amax) {
  return __fadd_rn(__fmul_rn(amax, kInv127), kEps);
}

__device__ __forceinline__ int8_t quant_code(float x, float scale) {
  const float q = rintf(__fdiv_rn(x, scale));
  return static_cast<int8_t>(fminf(fmaxf(q, -127.0f), 127.0f));
}

__device__ __forceinline__ float dequant(int8_t code, float scale) {
  return __fmul_rn(static_cast<float>(code), scale);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Max of `v` over the block (blockDim.x a multiple of 32, at most 1024),
// returned to every thread.  `sm` holds 33 floats; the two barriers make
// it safe to call again at once (every thread reads sm[32] before any
// can pass the next call's first barrier).
__device__ __forceinline__ float block_max(float v, float* sm) {
  v = warp_max(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) sm[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float w = lane < static_cast<int>(blockDim.x >> 5) ? sm[lane] : 0.0f;
    w = warp_max(w);
    if (lane == 0) sm[32] = w;
  }
  __syncthreads();
  return sm[32];
}

// Which columns of a group thread t owns, VEC of them: with V (vector
// path) the VEC consecutive columns [VEC*t, VEC*t + VEC), so one 16-byte
// load each; otherwise the strided columns t + i*blockDim.x.
template <int VEC, bool V>
__device__ __forceinline__ int lane_col(int i) {
  return V ? static_cast<int>(threadIdx.x) * VEC + i
           : static_cast<int>(threadIdx.x) + i * static_cast<int>(blockDim.x);
}

// Threads of a block that covers one group of g columns, VEC per thread:
// a whole number of warps.
inline int group_threads(int64_t g, int vec) {
  const int64_t t = (g + vec - 1) / vec;
  return static_cast<int>((t + 31) / 32 * 32);
}

}  // namespace repro
