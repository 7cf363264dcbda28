// Elementwise a (+) b: the (+) of Algorithm 1 as one pass.
//
// Replaces the Pallas TPU kernel repro/kernels/block_reduce.py:block_reduce
// (pallas_call at line 59), which streams (row_tile, col_tile) tiles of
// both operands through VMEM.  Here the operands are flat: out[e] =
// a[e] (+) b[e] for every element e of n.
//
// Bound: bytes.  Each operand element is read once and each result
// element written once, 3 * n * itemsize bytes for one (+) per element.
// The design spends everything on the memory pipe: one grid-stride loop
// over 16-byte vectors (float4 / 8 bf16 / 4 int32) when all three
// pointers are 16-byte aligned, a scalar tail for the last n % VEC
// elements, and a few resident blocks per SM to keep loads in flight.
// The TPU kernel's tiles, and the padding to whole tiles its wrapper
// needs, have no counterpart: the bounds are checked per element.
//
// The (+) and its bitwise parity with torch: csrc/reduce_ops.cuh (shared
// with fused_round.cu).
//
// Plain C interface for ctypes; launches on the given stream, allocates
// nothing, does not synchronise, returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "reduce_ops.cuh"

using namespace repro;

namespace {

template <typename T, int OP, int VEC>
__global__ void __launch_bounds__(256)
    block_reduce_kernel(const T* __restrict__ a, const T* __restrict__ b,
                        T* __restrict__ out, int64_t n) {
  using P = Pack<T, VEC>;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const int64_t nvec = n / VEC;
  for (int64_t i = tid; i < nvec; i += stride) {
    P x = reinterpret_cast<const P*>(a)[i];
    const P y = reinterpret_cast<const P*>(b)[i];
#pragma unroll
    for (int k = 0; k < VEC; ++k) x.v[k] = fold<OP>(x.v[k], y.v[k]);
    reinterpret_cast<P*>(out)[i] = x;
  }
  const int64_t e = nvec * VEC + tid;  // scalar tail
  if (VEC > 1 && e < n) out[e] = fold<OP>(a[e], b[e]);
}

template <typename T, int OP>
void launch(const void* a, const void* b, void* out, int64_t n,
            cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kThreads = 256;
  const bool vec = aligned(a, 16) && aligned(b, 16) && aligned(out, 16);
  const int64_t work = vec ? n / kVec + 1 : n;
  const int64_t cap = static_cast<int64_t>(sm_count()) * 8;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  const dim3 grid(static_cast<unsigned int>(blocks));
  const T* pa = static_cast<const T*>(a);
  const T* pb = static_cast<const T*>(b);
  T* po = static_cast<T*>(out);
  if (vec) {
    block_reduce_kernel<T, OP, kVec><<<grid, kThreads, 0, stream>>>(
        pa, pb, po, n);
  } else {
    block_reduce_kernel<T, OP, 1><<<grid, kThreads, 0, stream>>>(
        pa, pb, po, n);
  }
}

template <typename T>
int dispatch_op(int op, const void* a, const void* b, void* out, int64_t n,
                cudaStream_t stream) {
  switch (op) {
    case kAdd: launch<T, kAdd>(a, b, out, n, stream); break;
    case kMax: launch<T, kMax>(a, b, out, n, stream); break;
    case kMin: launch<T, kMin>(a, b, out, n, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a, b, out: n contiguous elements of one dtype.
extern "C" int repro_block_reduce(const void* a, const void* b, void* out,
                                  int64_t n, int dtype, int op,
                                  void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return dispatch_op<float>(op, a, b, out, n, st);
    case kBF16: return dispatch_op<__nv_bfloat16>(op, a, b, out, n, st);
    case kI32: return dispatch_op<int32_t>(op, a, b, out, n, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
