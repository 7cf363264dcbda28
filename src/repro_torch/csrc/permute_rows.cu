// Static row permutation in one pass: out[i] = x[perm[i]].
//
// Replaces the Pallas TPU kernel repro/kernels/fused_round.py:permute_rows
// (pallas_call at line 346), which the fused alltoall (repro/core/plan.py:
// _a2a_fused) uses to lay its final slot into source-rank order.  Over a
// 2-D (rows, cols) buffer, rows = the alltoall's p (a few to a few
// hundred), cols up to ~10.7 M (one expert-parallel dispatch block).
//
// Bound: bytes.  Every input byte is read once and every output byte
// written once, 2 * rows * cols * itemsize bytes, with no arithmetic, so
// nothing is staged in shared memory: a block row of the grid (blockIdx.y)
// is one destination row, and its blocks stream that row with a
// grid-stride loop of the widest loads the layout allows.  The kernel only
// moves bytes, so one instantiation per load width serves every dtype:
// 16-byte vectors when the row pitch in bytes and both base pointers are
// multiples of 16, else the widest of 8, 4, 2, 1 bytes that divides them
// all (a source row and its destination row start at different offsets,
// so a misaligned pitch cannot be peeled into an aligned body per row).
// The permutation rides in the kernel's parameters (a fixed table of
// kMaxRows entries, one constant-bank load per block) instead of a device
// array, so a launch needs no host-to-device copy: the TPU kernel's static
// unrolled row copies, as data.
//
// Plain C interface for ctypes; launches on the given stream, allocates
// nothing, does not synchronise, returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "reduce_ops.cuh"

using namespace repro;

namespace {

constexpr int kMaxRows = 256;

struct PermTable {
  int32_t src[kMaxRows];
};

template <typename V>
__global__ void __launch_bounds__(256)
    permute_rows_kernel(const V* __restrict__ x, V* __restrict__ out,
                        int64_t nvec, PermTable perm) {
  const int row = blockIdx.y;
  const V* __restrict__ s = x + static_cast<int64_t>(perm.src[row]) * nvec;
  V* __restrict__ d = out + static_cast<int64_t>(row) * nvec;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < nvec; i += stride)
    d[i] = s[i];
}

template <typename V>
void launch(const void* x, void* out, int64_t rows, int64_t row_bytes,
            const PermTable& perm, cudaStream_t stream) {
  constexpr int kThreads = 256;
  const int64_t nvec = row_bytes / static_cast<int64_t>(sizeof(V));
  // Enough blocks over all rows to keep ~8 resident per SM.
  int64_t cap = static_cast<int64_t>(sm_count()) * 8 / rows;
  if (cap < 1) cap = 1;
  int64_t bx = (nvec + kThreads - 1) / kThreads;
  if (bx > cap) bx = cap;
  if (bx < 1) bx = 1;
  const dim3 grid(static_cast<unsigned int>(bx),
                  static_cast<unsigned int>(rows));
  permute_rows_kernel<V><<<grid, kThreads, 0, stream>>>(
      static_cast<const V*>(x), static_cast<V*>(out), nvec, perm);
}

}  // namespace

// x, out: (rows, row_bytes) contiguous, distinct; perm: host array of rows
// int32 source rows, a permutation of 0..rows-1.
extern "C" int repro_permute_rows(const void* x, void* out, int64_t rows,
                                  int64_t row_bytes, const int32_t* perm,
                                  void* stream) {
  if (rows < 1 || rows > kMaxRows || row_bytes < 0 || perm == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  PermTable table;
  for (int64_t i = 0; i < rows; ++i) {
    if (perm[i] < 0 || perm[i] >= rows)
      return static_cast<int>(cudaErrorInvalidValue);
    table.src[i] = perm[i];
  }
  for (int64_t i = rows; i < kMaxRows; ++i) table.src[i] = 0;
  if (row_bytes == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto fits = [&](int64_t w) {
    return row_bytes % w == 0 && aligned(x, w) && aligned(out, w);
  };
  if (fits(16)) {
    launch<uint4>(x, out, rows, row_bytes, table, st);
  } else if (fits(8)) {
    launch<uint2>(x, out, rows, row_bytes, table, st);
  } else if (fits(4)) {
    launch<uint32_t>(x, out, rows, row_bytes, table, st);
  } else if (fits(2)) {
    launch<uint16_t>(x, out, rows, row_bytes, table, st);
  } else {
    launch<uint8_t>(x, out, rows, row_bytes, table, st);
  }
  return static_cast<int>(cudaGetLastError());
}
