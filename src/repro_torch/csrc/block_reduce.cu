// Elementwise a (+) b: the (+) of Algorithm 1 as one pass.
//
// Replaces the Pallas TPU kernel repro/kernels/block_reduce.py:block_reduce
// (pallas_call at line 59), which streams (row_tile, col_tile) tiles of
// both operands through VMEM.  Here the operands are flat: out[e] =
// a[e] (+) b[e] for every element e of n.  The TPU kernel's tiles, and the
// padding to whole tiles its wrapper needs, have no counterpart: the
// bounds are checked here.
//
// Bound: bytes.  Each operand element is read once and each result
// element written once, 3 * n * itemsize bytes for one (+) per element.
// Every thread loads U 8-byte vectors of each operand before its first
// fold; a block covers U * 256 contiguous vectors and the grid covers n
// once (no grid stride, so a warp's loads are never far apart).  Loads
// and stores stream past the caches (ld.global.cs / st.global.cs):
// nothing is reused.  U is 2 for a pass (3 * n * itemsize bytes) below
// kLargePass, 1 from there on.
//
// These parameters were chosen on the H100 against torch.add / maximum /
// minimum, and against a second design that folds in shared memory fed
// by 1-D cp.async.bulk copies (5-8 % slower than torch.add beyond L2);
// PERF.md has the numbers.  16-byte vectors, U = 4 and other block sizes
// did no better; the streaming hints gain 2-4 % at 50-100 MB a pass.
//
// The vector path needs 8-byte alignment; otherwise (views at odd
// offsets) one element is folded at a time.  The last n % VEC elements
// are folded one at a time.
//
// The (+) and its bitwise parity with torch: csrc/reduce_ops.cuh (shared
// with fused_round.cu and fused_round_dq.cu; the load and store helpers
// below are this file's own, so those compile as before).
//
// Plain C interface for ctypes; launches on the given stream, allocates
// nothing, does not synchronise, returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "reduce_ops.cuh"

using namespace repro;

namespace {

constexpr int kVecBytes = 8;
constexpr int kThreads = 256;
constexpr int64_t kLargePass = int64_t{64} << 20;
constexpr int kScalarUnroll = 4;  // the path for operands off alignment

// ---- streaming loads and stores -------------------------------------------

template <int BYTES>
struct Raw;
template <>
struct Raw<8> {
  using type = uint2;
};
template <>
struct Raw<4> {
  using type = unsigned int;
};
template <>
struct Raw<2> {
  using type = unsigned short;
};

// One Pack loaded with ld.global.cs (evict first: read once).
template <typename P>
__device__ __forceinline__ P load(const P* p) {
  using R = typename Raw<sizeof(P)>::type;
  const R r = __ldcs(reinterpret_cast<const R*>(p));
  P v;
  memcpy(&v, &r, sizeof(P));
  return v;
}

template <typename P>
__device__ __forceinline__ void store(P* p, const P& v) {
  using R = typename Raw<sizeof(P)>::type;
  R r;
  memcpy(&r, &v, sizeof(P));
  __stcs(reinterpret_cast<R*>(p), r);
}

template <typename T, int OP, int VEC>
__device__ __forceinline__ void fold_pack(Pack<T, VEC>& x,
                                          const Pack<T, VEC>& y) {
#pragma unroll
  for (int k = 0; k < VEC; ++k) x.v[k] = fold<OP>(x.v[k], y.v[k]);
}

template <typename T, int OP, int VEC, int U>
__global__ void __launch_bounds__(kThreads)
    block_reduce_kernel(const T* __restrict__ a, const T* __restrict__ b,
                        T* __restrict__ out, int64_t n) {
  using P = Pack<T, VEC>;
  const P* pa = reinterpret_cast<const P*>(a);
  const P* pb = reinterpret_cast<const P*>(b);
  P* po = reinterpret_cast<P*>(out);
  const int64_t nvec = n / VEC;
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * kThreads * U +
                     threadIdx.x;
  P x[U], y[U];
  if (i0 + (U - 1) * kThreads < nvec) {  // all U vectors in range
#pragma unroll
    for (int u = 0; u < U; ++u) x[u] = load(pa + i0 + u * kThreads);
#pragma unroll
    for (int u = 0; u < U; ++u) y[u] = load(pb + i0 + u * kThreads);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      fold_pack<T, OP, VEC>(x[u], y[u]);
      store(po + i0 + u * kThreads, x[u]);
    }
  } else {  // the last block: some vectors past the end
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (i0 + u * kThreads < nvec) {
        x[u] = load(pa + i0 + u * kThreads);
        y[u] = load(pb + i0 + u * kThreads);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (i0 + u * kThreads < nvec) {
        fold_pack<T, OP, VEC>(x[u], y[u]);
        store(po + i0 + u * kThreads, x[u]);
      }
    }
  }
  if (VEC > 1 && blockIdx.x == 0) {  // the last n % VEC elements
    const int64_t e = nvec * VEC + threadIdx.x;
    if (e < n) out[e] = fold<OP>(a[e], b[e]);
  }
}

template <typename T, int OP, int VEC, int U>
void launch_kernel(const T* a, const T* b, T* out, int64_t n,
                   cudaStream_t stream) {
  constexpr int64_t kPerBlock = int64_t{kThreads} * U;
  int64_t blocks = (n / VEC + kPerBlock - 1) / kPerBlock;
  if (blocks < 1) blocks = 1;  // n < VEC: block 0 folds the tail
  block_reduce_kernel<T, OP, VEC, U>
      <<<dim3(static_cast<unsigned int>(blocks)), kThreads, 0, stream>>>(
          a, b, out, n);
}

template <typename T, int OP>
int run(const void* a, const void* b, void* out, int64_t n,
        cudaStream_t stream) {
  constexpr int kVec = kVecBytes / sizeof(T);
  const T* pa = static_cast<const T*>(a);
  const T* pb = static_cast<const T*>(b);
  T* po = static_cast<T*>(out);
  if (!(aligned(a, kVecBytes) && aligned(b, kVecBytes) &&
        aligned(out, kVecBytes)))
    launch_kernel<T, OP, 1, kScalarUnroll>(pa, pb, po, n, stream);
  else if (3 * n * static_cast<int64_t>(sizeof(T)) < kLargePass)
    launch_kernel<T, OP, kVec, 2>(pa, pb, po, n, stream);
  else
    launch_kernel<T, OP, kVec, 1>(pa, pb, po, n, stream);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_op(int op, const void* a, const void* b, void* out, int64_t n,
                cudaStream_t stream) {
  switch (op) {
    case kAdd: return run<T, kAdd>(a, b, out, n, stream);
    case kMax: return run<T, kMax>(a, b, out, n, stream);
    case kMin: return run<T, kMin>(a, b, out, n, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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
