// Numerics statistics (N1): the raw moments of the numerics step, every
// probed activation and every gradient group in two launches, each input
// read once.
//
// A segment is one tensor (bf16 or f32, contiguous) and, for a probed
// activation, its row mask (one byte a row of `width` elements; padding
// rows count for nothing). The segments are cut into tiles of kTile
// elements; one block reduces one tile to its partial
// (max |x|, sum of squares, element count, non-finite count, bf16
// underflow count) -- the column order of obs/numerics.py STAT_FIELDS --
// and writes it to `partials`. The combine kernel then folds each output
// segment's run of tiles (a gradient group is the run of its leaves) in a
// fixed order, so two calls give the same bits, and a one-thread kernel
// sets the step's ok flag: the loss and the gradients' total sum of
// squares finite (step_ok).
//
// max |x| propagates NaN (an inf shows as inf); the underflow count is the
// nonzero |x| below the smallest normal of a bf16 segment.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = kThreads * 16;  // elements a block reduces
constexpr int kMaxSegs = 48;          // segments a launch takes by value
constexpr int kWidth = 5;             // STAT_FIELDS
constexpr float kBf16Tiny = 1.1754944e-38f;

struct Table {
  const void* ptr[kMaxSegs];
  const uint8_t* mask[kMaxSegs];  // nullptr: every element counts
  int64_t numel[kMaxSegs];
  int64_t width[kMaxSegs];        // elements a mask row covers
  int tile0[kMaxSegs + 1];        // first tile of each segment in this launch
  int bf16[kMaxSegs];
  int count;
};

// max keeping NaN: once either side is NaN the result is
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || a > b) ? a : b;
}

__device__ __forceinline__ void add(float acc[kWidth], float v, bool bf16) {
  const float a = fabsf(v);
  acc[0] = max_nan(acc[0], a);
  acc[1] += v * v;
  acc[2] += 1.0f;
  acc[3] += isfinite(v) ? 0.0f : 1.0f;
  acc[4] += (bf16 && a != 0.0f && a < kBf16Tiny) ? 1.0f : 0.0f;
}

// V elements (16 bytes) of T at x[e]: one vector load where aligned
template <typename T, int V>
__device__ __forceinline__ void load(const T* __restrict__ x, int64_t e, bool vec, float v[V]) {
  if (vec) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(x + e));
    const T* t = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = hg::to_f(t[j]);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = hg::to_f(x[e + j]);
  }
}

// the elements [beg, end) of one segment: V a thread at a time, each
// element's mask row followed by a column counter (no division a element)
template <typename T>
__device__ __forceinline__ void accumulate(const T* __restrict__ x,
                                           const uint8_t* __restrict__ mask, int64_t width,
                                           int64_t beg, int64_t end, bool bf16, float acc[kWidth]) {
  constexpr int V = 16 / sizeof(T);
  const bool aligned = (reinterpret_cast<uintptr_t>(x) % 16) == 0;
  for (int64_t e = beg + static_cast<int64_t>(threadIdx.x) * V; e < end;
       e += static_cast<int64_t>(kThreads) * V) {
    const int n = end - e < V ? static_cast<int>(end - e) : V;
    float v[V];
    if (n == V) {
      load<T, V>(x, e, aligned, v);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) v[j] = j < n ? hg::to_f(x[e + j]) : 0.0f;
    }
    if (mask == nullptr) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        if (j < n) add(acc, v[j], bf16);
      }
    } else {
      int64_t row = e / width, col = e - row * width;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        if (j < n && mask[row]) add(acc, v[j], bf16);
        if (++col == width) {
          col = 0;
          ++row;
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads) tiles_kernel(Table t, float* __restrict__ partials) {
  const int tile = blockIdx.x;
  int s = 0;
  while (s + 1 < t.count && t.tile0[s + 1] <= tile) ++s;
  const int64_t beg = static_cast<int64_t>(tile - t.tile0[s]) * kTile;
  const int64_t end = min(beg + kTile, t.numel[s]);
  float acc[kWidth] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (t.bf16[s]) {
    accumulate(static_cast<const __nv_bfloat16*>(t.ptr[s]), t.mask[s], t.width[s], beg, end,
               true, acc);
  } else {
    accumulate(static_cast<const float*>(t.ptr[s]), t.mask[s], t.width[s], beg, end, false,
               acc);
  }
  // the block's partial: each warp by shuffles, then the warps' in order
  __shared__ float warp_acc[kThreads / 32][kWidth];
  for (int off = 16; off > 0; off >>= 1) {
    acc[0] = max_nan(acc[0], __shfl_down_sync(0xffffffffu, acc[0], off));
    for (int k = 1; k < kWidth; ++k) acc[k] += __shfl_down_sync(0xffffffffu, acc[k], off);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    for (int k = 0; k < kWidth; ++k) warp_acc[warp][k] = acc[k];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float out[kWidth] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    for (int w = 0; w < kThreads / 32; ++w) {
      out[0] = max_nan(out[0], warp_acc[w][0]);
      for (int k = 1; k < kWidth; ++k) out[k] += warp_acc[w][k];
    }
    for (int k = 0; k < kWidth; ++k) partials[static_cast<int64_t>(tile) * kWidth + k] = out[k];
  }
}

// one block a segment: its tiles' partials strided over the threads, then
// a tree in shared memory (a fixed order: the same bits every call)
__global__ void __launch_bounds__(kThreads) combine_kernel(const float* __restrict__ partials,
                                                           const int* __restrict__ seg_tile0,
                                                           float* __restrict__ out) {
  const int s = blockIdx.x;
  float m = 0.0f;
  double sums[kWidth - 1] = {0.0, 0.0, 0.0, 0.0};
  for (int i = seg_tile0[s] + threadIdx.x; i < seg_tile0[s + 1]; i += kThreads) {
    const float* p = partials + static_cast<int64_t>(i) * kWidth;
    m = max_nan(m, p[0]);
    for (int k = 1; k < kWidth; ++k) sums[k - 1] += p[k];
  }
  __shared__ float max_s[kThreads];
  __shared__ double sum_s[kWidth - 1][kThreads];
  max_s[threadIdx.x] = m;
  for (int k = 0; k < kWidth - 1; ++k) sum_s[k][threadIdx.x] = sums[k];
  __syncthreads();
  for (int half = kThreads / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) {
      max_s[threadIdx.x] = max_nan(max_s[threadIdx.x], max_s[threadIdx.x + half]);
      for (int k = 0; k < kWidth - 1; ++k) sum_s[k][threadIdx.x] += sum_s[k][threadIdx.x + half];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    out[static_cast<int64_t>(s) * kWidth] = max_s[0];
    for (int k = 1; k < kWidth; ++k) {
      out[static_cast<int64_t>(s) * kWidth + k] = static_cast<float>(sum_s[k - 1][0]);
    }
  }
}

// step_ok: the loss and the global gradient norm finite, the norm's square
// summed in f32 over the groups in order
__global__ void ok_kernel(const float* __restrict__ out, int nseg, int grad0,
                          const float* __restrict__ tot, uint8_t* __restrict__ ok) {
  float total = 0.0f;
  for (int s = grad0; s < nseg; ++s) total += out[static_cast<int64_t>(s) * kWidth + 1];
  *ok = (isfinite(*tot) && isfinite(total)) ? 1 : 0;
}

}  // namespace

// rows: nseg x 6 int64 on the host (data pointer, mask pointer or 0,
// elements, elements a mask row covers, 1 for bf16, first tile); the tiles
// of a segment follow its first one, the segments' tiles in row order.
extern "C" int hg_numerics_tiles(const int64_t* rows, int nseg, float* partials, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int a = 0; a < nseg; a += kMaxSegs) {
    const int n = nseg - a < kMaxSegs ? nseg - a : kMaxSegs;
    Table t;
    const int64_t first = rows[static_cast<int64_t>(a) * 6 + 5];
    int64_t tiles = 0;
    for (int i = 0; i < n; ++i) {
      const int64_t* r = rows + static_cast<int64_t>(a + i) * 6;
      t.ptr[i] = reinterpret_cast<const void*>(r[0]);
      t.mask[i] = reinterpret_cast<const uint8_t*>(r[1]);
      t.numel[i] = r[2];
      t.width[i] = r[3] > 0 ? r[3] : 1;
      t.bf16[i] = static_cast<int>(r[4]);
      t.tile0[i] = static_cast<int>(r[5] - first);
      tiles = r[5] - first + (r[2] + kTile - 1) / kTile;
    }
    t.tile0[n] = static_cast<int>(tiles);
    t.count = n;
    if (tiles > 0) {
      tiles_kernel<<<static_cast<unsigned>(tiles), kThreads, 0, st>>>(t, partials + first * kWidth);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// seg_tile0: nseg + 1 ints on the device (each output segment's first
// tile, the last the end); out: nseg x 5 f32; ok (may be null): one byte,
// from the loss `tot` (one f32) and the segments from grad0 on.
extern "C" int hg_numerics_combine(const float* partials, const int* seg_tile0, int nseg,
                                   int grad0, float* out, const float* tot, uint8_t* ok,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nseg > 0) combine_kernel<<<nseg, kThreads, 0, st>>>(partials, seg_tile0, out);
  if (ok != nullptr) ok_kernel<<<1, 1, 0, st>>>(out, nseg, grad0, tot, ok);
  return static_cast<int>(cudaGetLastError());
}
