// Sorted-segment sum of edge messages:  out[i] = sum_{e : ids[e] == i} msg[e]
//
// Replaces the TPU kernel hydragnn_tpu/ops/pallas_segment.py
// (sorted_segment_sum -> _forward -> pl.pallas_call). The TPU version turns
// the scatter into one-hot matrix products on the MXU over a K-window grid;
// neither device is needed here. Receivers are sorted, so each output row
// owns the contiguous edge range [rowptr[i], rowptr[i+1]) (rowptr is built
// from the ids by a first small kernel, common.cuh rowptr_kernel).
//
// What bounds it on an H100: bytes. The function reads every message once
// and writes every output row once (~E*C elements in, N*C out, ~2 flops per
// 4 bytes of bf16), far below the 295 flop/byte ridge. The design moves
// each message byte exactly once and keeps loads in flight:
//   - a block is TY rows x 2*TX columns; a warp covers 32 consecutive
//     columns of one row, so each edge's load is one coalesced segment, and
//     each thread owns two columns (c, c + TX);
//   - narrow rows (the coordinate mean's C = 3) shrink the column threads to
//     what C needs and stack more rows per block instead of padding C;
//   - an ordinary row (degree <= kLongRow) is walked by its own thread in
//     edge order, in eight interleaved f32 partial sums (independent loads in
//     flight) combined in a fixed order;
//   - a long row (in practice the dummy padding node, which receives every
//     padding edge) would serialize one thread for hundreds of edges, so the
//     whole block walks it: thread row ty takes edges ty, ty + TY, ... and
//     the TY partials are added in ty order through shared memory;
//   - deterministic, no atomics, exact for every row whatever its degree
//     (the TPU kernel leaves rows over max_degree unspecified; this one does
//     not); row blocks run last-first, so the block holding the long dummy
//     row starts at once.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kLongRow = 64;  // rows with more edges are walked by the whole block

constexpr int kUnroll = 8;   // independent loads in flight per thread

template <typename T>
__device__ __forceinline__ void walk(const T* __restrict__ msg, int beg, int end, int step,
                                     int C, int c0, int c1, bool has0, bool has1,
                                     float& s0, float& s1) {
  // edges beg, beg + step, ... < end into kUnroll interleaved partial sums,
  // combined in a fixed pairwise order
  float a0[kUnroll], a1[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) a0[u] = a1[u] = 0.f;
  int e = beg;
  for (; e + (kUnroll - 1) * step < end; e += kUnroll * step) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const T* m = msg + (int64_t)(e + u * step) * C;
      if (has0) a0[u] += hg::to_f(m[c0]);
      if (has1) a1[u] += hg::to_f(m[c1]);
    }
  }
#pragma unroll
  for (int u = 0; u < kUnroll - 1; ++u) {  // tail: constant indices keep a0/a1 in registers
    if (e + u * step < end) {
      const T* m = msg + (int64_t)(e + u * step) * C;
      if (has0) a0[u] += hg::to_f(m[c0]);
      if (has1) a1[u] += hg::to_f(m[c1]);
    }
  }
#pragma unroll
  for (int w = kUnroll / 2; w > 0; w /= 2) {
#pragma unroll
    for (int u = 0; u < w; ++u) {
      a0[u] += a0[u + w];
      a1[u] += a1[u + w];
    }
  }
  s0 = a0[0];
  s1 = a1[0];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
sorted_segment_sum_kernel(const T* __restrict__ msg, const int* __restrict__ rowptr,
                          T* __restrict__ out, int E, int num_segments, int C) {
  __shared__ float part[kThreads][2];
  const int TX = blockDim.x, TY = blockDim.y;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int row0 = (gridDim.x - 1 - blockIdx.x) * TY;  // last rows first
  const int c0 = blockIdx.y * 2 * TX + tx;
  const int c1 = c0 + TX;
  const bool has0 = c0 < C;
  const bool has1 = c1 < C;

  // ordinary rows: one thread per (row, column pair); long rows are flagged
  // (with their edge range) for the block-wide walk below
  __shared__ int long_beg[kThreads], long_end[kThreads];
  const int r = row0 + ty;
  bool is_long = false;
  if (r < num_segments) {
    int beg, end;
    hg::row_range(rowptr, r, E, beg, end);
    is_long = end - beg > kLongRow;
    if (tx == 0) {
      long_beg[ty] = beg;
      long_end[ty] = is_long ? end : beg;
    }
    if (!is_long && has0) {
      float s0, s1;
      walk(msg, beg, end, 1, C, c0, c1, true, has1, s0, s1);
      T* o = out + (int64_t)r * C;
      o[c0] = hg::from_f<T>(s0);
      if (has1) o[c1] = hg::from_f<T>(s1);
    }
  } else if (tx == 0) {
    long_beg[ty] = long_end[ty] = 0;
  }
  if (__syncthreads_count(is_long) == 0) return;  // most blocks: no long row

  // long rows of this block: every thread row strides the row's edges
  for (int lr = 0; lr < TY; ++lr) {
    const int beg = long_beg[lr];
    const int end = long_end[lr];
    if (end == beg) continue;  // not long (or past the end): uniform across the block
    float s0, s1;
    walk(msg, beg + ty, end, TY, C, c0, c1, has0, has1, s0, s1);
    part[ty * TX + tx][0] = s0;
    part[ty * TX + tx][1] = s1;
    __syncthreads();
    if (ty == 0 && has0) {
      float t0 = 0.f, t1 = 0.f;
      for (int k = 0; k < TY; ++k) {  // fixed order: deterministic
        t0 += part[k * TX + tx][0];
        t1 += part[k * TX + tx][1];
      }
      T* o = out + (int64_t)(row0 + lr) * C;
      o[c0] = hg::from_f<T>(t0);
      if (has1) o[c1] = hg::from_f<T>(t1);
    }
    __syncthreads();
  }
}

template <typename T>
void launch(const void* msg, const int* rowptr, void* out, int E, int num_segments,
            int C, cudaStream_t stream) {
  // column threads: just enough for C (two columns each), at most a warp
  int tx = 1;
  while (tx < 32 && 2 * tx < C) tx *= 2;
  const int ty = kThreads / tx;
  const dim3 block(tx, ty);
  const dim3 grid((num_segments + ty - 1) / ty, (C + 2 * tx - 1) / (2 * tx));
  sorted_segment_sum_kernel<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(msg), rowptr, static_cast<T*>(out), E, num_segments, C);
}

}  // namespace

// msg [E, C] and out [num_segments, C] row-major in `dtype` (hg::DType);
// ids [E] int64 ascending; rowptr [num_segments + 1] int32 scratch, filled
// here. Returns cudaGetLastError() after the launches.
extern "C" int hg_sorted_segment_sum(const void* msg, const int64_t* ids, int* rowptr,
                                     void* out, int E, int num_segments, int C,
                                     int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != hg::kFloat32 && dtype != hg::kBFloat16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_segments > 0 && C > 0) {
    hg::launch_rowptr(ids, E, num_segments, rowptr, s);
    if (dtype == hg::kFloat32) {
      launch<float>(msg, rowptr, out, E, num_segments, C, s);
    } else {
      launch<__nv_bfloat16>(msg, rowptr, out, E, num_segments, C, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
