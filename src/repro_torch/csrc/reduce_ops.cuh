// The (+) of the circulant collectives on the card, shared by every
// kernel that folds two operands (fused_round.cu, block_reduce.cu,
// fused_round_dq.cu), so their semantics cannot drift apart.
//
// Bitwise parity with the plain PyTorch version (torch.add / maximum /
// minimum on the card) and with the reference:
//   * bf16 add is __float2bfloat16_rn(float(a) + float(b));
//   * max/min follow torch's CUDA kernels: the first NaN operand is
//     returned as it is (bits unchanged), otherwise fmaxf/fminf in float,
//     exact when rounded back to bf16 -- fmaxf alone would drop NaN;
//   * int32 add wraps (computed in uint32).
// One operation per element, so no FMA contraction can arise.
//
// Also here: the 16-byte vector type and the host helpers the launchers
// share.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

enum Op : int { kAdd = 0, kMax = 1, kMin = 2 };
enum DType : int { kF32 = 0, kBF16 = 1, kI32 = 2 };

template <int OP>
__device__ __forceinline__ float fold_f(float a, float b) {
  if (OP == kAdd) return __fadd_rn(a, b);
  if (a != a) return a;
  if (b != b) return b;
  return OP == kMax ? fmaxf(a, b) : fminf(a, b);
}

template <int OP>
__device__ __forceinline__ float fold(float a, float b) {
  return fold_f<OP>(a, b);
}

template <int OP>
__device__ __forceinline__ __nv_bfloat16 fold(__nv_bfloat16 a,
                                              __nv_bfloat16 b) {
  const float fa = __bfloat162float(a), fb = __bfloat162float(b);
  if (OP == kAdd) return __float2bfloat16_rn(fa + fb);
  if (fa != fa) return a;  // the NaN operand itself, payload and all
  if (fb != fb) return b;
  return __float2bfloat16_rn(OP == kMax ? fmaxf(fa, fb) : fminf(fa, fb));
}

template <int OP>
__device__ __forceinline__ int32_t fold(int32_t a, int32_t b) {
  if (OP == kAdd)
    return static_cast<int32_t>(static_cast<uint32_t>(a) +
                                static_cast<uint32_t>(b));
  if (OP == kMax) return a > b ? a : b;
  return a < b ? a : b;
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// Number of SMs of the current device (cached per device).
inline int sm_count() {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (!cached[dev]) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    cached[dev] = n > 0 ? n : 132;
  }
  return cached[dev];
}

// True for a null pointer or one aligned to `bytes`.
inline bool aligned(const void* p, uintptr_t bytes) {
  return p == nullptr || (reinterpret_cast<uintptr_t>(p) % bytes) == 0;
}

}  // namespace repro
