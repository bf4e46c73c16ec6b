// Shared helpers of the hand-written kernels: element type conversion and
// the dtype codes the Python wrappers pass through the C interface.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hg {

// dtype codes of the C interface (hydragnn_tpu_torch/ops/*.py _DTYPE_CODES)
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even
}

// value rounded to T and widened back: the rounding points of the TPU
// kernels (operand-dtype intermediates) reproduced in f32 arithmetic
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

// CSR row pointer of ascending ids in [0, N): rowptr[r] = the first edge e
// with ids[e] >= r, for r in [0, N]. One thread per boundary e in [0, E]
// writes the rows that start there. Ids that are not ascending leave rows
// unwritten; the kernels clamp every range into [0, E], so such input gives
// wrong sums (the caller's contract) but never an access out of bounds.
__global__ void rowptr_kernel(const int64_t* __restrict__ ids, int E, int N,
                              int* __restrict__ rowptr) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e > E) return;
  int64_t prev = e == 0 ? -1 : ids[e - 1];
  int64_t cur = e == E ? N : ids[e];
  prev = prev < -1 ? -1 : prev;
  cur = cur > N ? N : cur;
  for (int64_t r = prev + 1; r <= cur; ++r) rowptr[r] = e;
}

inline void launch_rowptr(const int64_t* ids, int E, int N, int* rowptr,
                          cudaStream_t stream) {
  rowptr_kernel<<<(E + 1 + 255) / 256, 256, 0, stream>>>(ids, E, N, rowptr);
}

// [beg, end) of row r, clamped into [0, E]
__device__ __forceinline__ void row_range(const int* __restrict__ rowptr, int r, int E,
                                          int& beg, int& end) {
  beg = min(max(rowptr[r], 0), E);
  end = min(max(rowptr[r + 1], beg), E);
}

}  // namespace hg
