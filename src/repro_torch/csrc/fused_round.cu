// One circulant reduce-scatter round, fused: fold + keep/send split.
//
// Replaces the Pallas TPU kernel repro/kernels/fused_round.py:fused_round
// (pallas_call at line 168).  Over 2-D (blocks, block_numel) buffers with
// `live` (lo, cols) and `recv` (nb, cols), for every global row g:
//
//     v = g < nb ? live[g] (+) recv[g] : live[g]
//     keep[g]           = v    if g <  next_lo
//     send[g - next_lo] = v    if g >= next_lo
//
// Both row boundaries are multiples of `cols`, so over the flattened
// element index e the kernel is one pass with two thresholds:
// fold below nb*cols, keep below next_lo*cols, send above.
//
// Bound: bytes.  Each input element is read once and each output element
// written once: (lo + nb + lo) * cols * itemsize bytes, one (+) per
// folded element and no reuse, so no tile ever sits in shared memory.
// The design therefore spends nothing on staging and everything on the
// memory pipe: a grid-stride loop over 16-byte vectors (float4 / 8 bf16 /
// 4 int32) where both thresholds and all pointers allow it, with a scalar
// tail, and a few resident blocks per SM to keep enough loads in flight.
// The TPU kernel's column-tile grid is not carried over: it exists to
// fit VMEM, which has no counterpart to fill here.
//
// The (+) and its bitwise parity with torch: csrc/reduce_ops.cuh.
//
// Plain C interface for ctypes; launches on the given stream, allocates
// nothing, does not synchronise, returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "reduce_ops.cuh"

using namespace repro;

namespace {

// Elements [e, e + VEC) lie on one side of each threshold (the host
// only picks VEC > 1 when both thresholds are multiples of VEC).
template <typename T, int OP, int VEC>
__device__ __forceinline__ void round_at(const T* __restrict__ live,
                                         const T* __restrict__ recv,
                                         T* __restrict__ keep,
                                         T* __restrict__ send, int64_t e,
                                         int64_t n_fold, int64_t n_keep) {
  using P = Pack<T, VEC>;
  P a = *reinterpret_cast<const P*>(live + e);
  if (e < n_fold) {
    const P b = *reinterpret_cast<const P*>(recv + e);
#pragma unroll
    for (int i = 0; i < VEC; ++i) a.v[i] = fold<OP>(a.v[i], b.v[i]);
  }
  if (e < n_keep) {
    *reinterpret_cast<P*>(keep + e) = a;
  } else {
    *reinterpret_cast<P*>(send + (e - n_keep)) = a;
  }
}

template <typename T, int OP, int VEC>
__global__ void __launch_bounds__(256)
    fused_round_kernel(const T* __restrict__ live, const T* __restrict__ recv,
                       T* __restrict__ keep, T* __restrict__ send, int64_t n,
                       int64_t n_fold, int64_t n_keep) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const int64_t nvec = n / VEC;
  for (int64_t i = tid; i < nvec; i += stride)
    round_at<T, OP, VEC>(live, recv, keep, send, i * VEC, n_fold, n_keep);
  // Scalar tail: the last n % VEC elements.
  const int64_t e = nvec * VEC + tid;
  if (VEC > 1 && e < n)
    round_at<T, OP, 1>(live, recv, keep, send, e, n_fold, n_keep);
}

template <typename T, int OP>
void launch(const void* live, const void* recv, void* keep, void* send,
            int64_t n, int64_t n_fold, int64_t n_keep, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kThreads = 256;
  const bool vec = n_fold % kVec == 0 && n_keep % kVec == 0 &&
                   aligned(live, 16) && aligned(recv, 16) &&
                   aligned(keep, 16) && aligned(send, 16);
  const int64_t work = vec ? n / kVec + 1 : n;
  const int64_t cap = static_cast<int64_t>(sm_count()) * 8;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  const dim3 grid(static_cast<unsigned int>(blocks));
  const T* l = static_cast<const T*>(live);
  const T* r = static_cast<const T*>(recv);
  T* k = static_cast<T*>(keep);
  T* s = static_cast<T*>(send);
  if (vec) {
    fused_round_kernel<T, OP, kVec><<<grid, kThreads, 0, stream>>>(
        l, r, k, s, n, n_fold, n_keep);
  } else {
    fused_round_kernel<T, OP, 1><<<grid, kThreads, 0, stream>>>(
        l, r, k, s, n, n_fold, n_keep);
  }
}

template <typename T>
int dispatch_op(int op, const void* live, const void* recv, void* keep,
                void* send, int64_t n, int64_t n_fold, int64_t n_keep,
                cudaStream_t stream) {
  switch (op) {
    case kAdd: launch<T, kAdd>(live, recv, keep, send, n, n_fold, n_keep,
                               stream); break;
    case kMax: launch<T, kMax>(live, recv, keep, send, n, n_fold, n_keep,
                               stream); break;
    case kMin: launch<T, kMin>(live, recv, keep, send, n, n_fold, n_keep,
                               stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// live (lo, cols), recv (nb, cols), keep (next_lo, cols),
// send (lo - next_lo, cols) or NULL when next_lo == lo; all contiguous.
extern "C" int repro_fused_round(const void* live, const void* recv,
                                 void* keep, void* send, int64_t lo,
                                 int64_t nb, int64_t next_lo, int64_t cols,
                                 int dtype, int op, void* stream) {
  if (nb < 1 || nb > lo || next_lo < 1 || next_lo > lo || cols < 0 ||
      (send == nullptr) != (next_lo == lo))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n = lo * cols;
  if (n == 0) return static_cast<int>(cudaSuccess);
  const int64_t n_fold = nb * cols, n_keep = next_lo * cols;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return dispatch_op<float>(op, live, recv, keep, send, n, n_fold, n_keep,
                                st);
    case kBF16:
      return dispatch_op<__nv_bfloat16>(op, live, recv, keep, send, n, n_fold,
                                        n_keep, st);
    case kI32:
      return dispatch_op<int32_t>(op, live, recv, keep, send, n, n_fold,
                                  n_keep, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
