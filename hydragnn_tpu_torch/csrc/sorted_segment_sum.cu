// Sorted-segment sum of edge messages:  out[i] = sum_{e : ids[e] == i} msg[e]
//
// Replaces the TPU kernel hydragnn_tpu/ops/pallas_segment.py
// (sorted_segment_sum -> _forward -> pl.pallas_call). The TPU version turns
// the scatter into one-hot matrix products on the MXU over a K-window grid;
// neither device is needed here. Receivers are sorted, so each output row
// owns a contiguous edge range.
//
// What bounds it on an H100: bytes. The function reads every message once
// and writes every output row once (~E*C elements in, N*C out, ~2 flops per
// 4 bytes of bf16), far below the 295 flop/byte ridge. At narrow widths
// (the EGNN coordinate mean's C = 3) there are too few bytes to matter and
// what is left is launch and latency, so the design is one launch whose
// grid covers the card, with no row-pointer scratch and few dependent
// memory round trips per block:
//   - narrow rows (C * sizeof(T) <= 16 bytes, so C = 1-4 in f32): a block
//     owns 256 edges (141 blocks for the EGNN batch's 36,096) and the rows
//     that start among them. One round of loads brings its ids and messages,
//     the id before them and the 32 ids after them into shared memory; row
//     starts are where ids[e] != ids[e - 1]; a group of 8 lanes sums each row
//     from shared memory with a fixed butterfly of shuffles and zeroes the
//     empty rows before it. The row that runs on past the block's edges (in
//     practice the dummy padding row) is summed by the whole block where it
//     starts, its end read from the 32 ids after the block or the last id
//     (a warp search where neither holds it);
//   - wide rows (C = 256, 866): a block is up to four groups of TY rows x
//     2*TX columns, one group at a time. It finds its first and last edge
//     with a warp-cooperative 32-ary search over the sorted ids (one warp
//     per end, one load per lane and round: two rounds where the edge lies
//     within 512 of where the mean degree puts it, ~4 more where not) and
//     derives its rows' boundaries from the ids it reads itself into shared
//     memory. A warp covers 32 consecutive columns of one row, so each
//     edge's load is one coalesced segment, and each thread owns two columns
//     (c, c + TX); an ordinary row is walked by its own thread in edge
//     order, in eight interleaved f32 partial sums combined in a fixed
//     order; a long row (over kLongRow edges) is walked by the whole block,
//     the threads' partials added in a fixed order through shared memory;
//     row blocks run last-first, so the block holding the long dummy row
//     starts at once;
//   - deterministic, no atomics, exact for every row whatever its degree
//     (the TPU kernel leaves rows over max_degree unspecified; this one does
//     not).
#include <climits>

#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;      // wide rows
constexpr int kNarrowThreads = 128;
constexpr int kGroup = 8;          // lanes per narrow row
constexpr int kNarrowEdges = 256;  // edges per narrow block (the default plan; 128 and 512 too)
constexpr int kLook = 32;          // ids a narrow block reads past its edges
constexpr int kMaxRows = 128;      // rows per block, at most (wide: TY = 256 / TX, TX >= 2)
constexpr int kMaxRowsCap = 512;   // the largest a plan may ask (the second wide instance)
constexpr int kLongRow = 64;       // rows with more edges are walked by the whole block
constexpr int kUnroll = 8;         // independent loads in flight per thread (wide)
constexpr int kLongUnroll = 8;     // message rows in flight per thread (a narrow tail row)
constexpr int kWideIters = 4;      // row groups of TY rows per wide block (the default plan)
constexpr int kScanUnroll = 8;     // row boundaries per thread in flight together

// the first edge e in [0, E] with ids[e] >= key, by the 32 lanes of one warp.
// The answer lies in [lo, hi]; each round the lanes test 32 evenly spaced
// pivots (a position at or past hi counts as >= key) and keep the step
// between the last pivot below key and the first at or above it. The first
// round tries the 1,024 edges around `guess` (where the row would start if
// every row had the mean degree), checking in the same round that the
// answer lies there: two rounds where it does, the full range where not.
__device__ int warp_lower_bound(const int64_t* __restrict__ ids, int E, int64_t key, int guess,
                                int lane) {
  constexpr int kBracket = 32 * 32;
  int lo = max(0, min(guess - kBracket / 2, E - kBracket)), hi = min(E, lo + kBracket);
  bool first = true;
  while (hi > lo) {
    const int step = (hi - lo + 31) / 32;
    const int pivot = lo + (lane + 1) * step - 1;
    const bool ge = pivot >= hi || ids[pivot] >= key;
    const int j = __ffs(__ballot_sync(kFull, ge)) - 1;  // ge ascends with the lane
    if (first) {
      first = false;
      bool inside = true;
      if (lane == 0 && lo > 0) inside = ids[lo - 1] < key;
      if (lane == 31 && hi < E) inside = ids[hi] >= key;
      if (!__all_sync(kFull, inside)) {
        lo = 0;
        hi = E;
        continue;
      }
    }
    if (j < 0) return hi;  // every id in [lo, hi) is below key
    hi = min(lo + (j + 1) * step - 1, hi);
    lo += j * step;
  }
  return lo;
}

// rowptr[i] = the first edge of row r0 + i within the block's edges
// [ebeg, eend), for i in [0, R <= CAP]; rows are clamped into [ebeg, eend]
template <int CAP>
struct BlockRows {
  int ebeg, eend;
  int rowptr[CAP + 1];

  __device__ void find(const int64_t* __restrict__ ids, int E, int N, int r0, int R) {
    const int tid = threadIdx.x + threadIdx.y * blockDim.x;
    const int warp = tid / 32, lane = tid % 32;
    if (warp < 2) {
      const int key = warp == 0 ? r0 : r0 + R;
      const int e = warp_lower_bound(ids, E, key, (int)((int64_t)key * E / N), lane);
      if (lane == 0) (warp == 0 ? ebeg : eend) = e;
    }
    __syncthreads();
    const int nthreads = blockDim.x * blockDim.y;
    const int b = ebeg, en = max(eend, b);
    // the rows that start at each boundary e in [b, en] (as common.cuh
    // rowptr_kernel), kScanUnroll boundaries per thread with their loads
    // in flight together
    for (int e0 = b + tid; e0 <= en; e0 += kScanUnroll * nthreads) {
      int64_t prev[kScanUnroll], cur[kScanUnroll];
#pragma unroll
      for (int u = 0; u < kScanUnroll; ++u) {
        const int e = e0 + u * nthreads;
        prev[u] = e > en ? r0 + R : e == b ? r0 - 1 : ids[e - 1];
        cur[u] = e >= en ? r0 + R : ids[e];
      }
#pragma unroll
      for (int u = 0; u < kScanUnroll; ++u) {
        const int e = e0 + u * nthreads;
        const int64_t lo = prev[u] < r0 - 1 ? r0 - 1 : prev[u];
        const int64_t hi = cur[u] > r0 + R ? r0 + R : cur[u];
        for (int64_t r = lo + 1; r <= hi; ++r) rowptr[r - r0] = e;
      }
    }
    __syncthreads();
  }

  // [beg, end) of local row i, clamped into the block's edges
  __device__ void range(int i, int& beg, int& end) const {
    beg = min(max(rowptr[i], ebeg), eend);
    end = min(max(rowptr[i + 1], beg), eend);
  }
};

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

// edges beg, beg + step, ... < end of a narrow row (C <= NC) into U
// interleaved partial sums, combined in a fixed pairwise order
template <typename T, int NC, int U = kLongUnroll>
__device__ __forceinline__ void walk_narrow(const T* __restrict__ msg, int beg, int end,
                                            int step, int C, float (&acc)[NC]) {
  float p[U][NC];
#pragma unroll
  for (int u = 0; u < U; ++u) {
#pragma unroll
    for (int c = 0; c < NC; ++c) p[u][c] = 0.f;
  }
  for (int e = beg; e < end; e += U * step) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int ee = e + u * step;
      if (ee < end) {
        const T* m = msg + (int64_t)ee * C;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          if (c < C) p[u][c] += hg::to_f(m[c]);
        }
      }
    }
  }
#pragma unroll
  for (int w = U / 2; w > 0; w /= 2) {
#pragma unroll
    for (int u = 0; u < w; ++u) {
#pragma unroll
      for (int c = 0; c < NC; ++c) p[u][c] += p[u + w][c];
    }
  }
#pragma unroll
  for (int c = 0; c < NC; ++c) acc[c] = p[0][c];
}

// narrow rows (NC = 16 / sizeof(T) columns at most): a block owns EB edges
// and the rows that start among them
template <typename T, int EB>
__global__ void __launch_bounds__(kNarrowThreads)
sorted_segment_sum_narrow(const T* __restrict__ msg, const int64_t* __restrict__ ids,
                          T* __restrict__ out, int E, int num_segments, int C) {
  constexpr int NC = 16 / sizeof(T);
  constexpr int kWarpsN = kNarrowThreads / 32;
  __shared__ int64_t sid[EB + 1];  // sid[t + 1] = ids[e0 + t]; sid[0] = ids[e0 - 1], or -1
  __shared__ float smsg[EB][NC];
  __shared__ int64_t slook[kLook];  // ids[e1 + t], or LLONG_MAX past the last edge
  __shared__ int64_t id_last;
  __shared__ int starts[EB + 1];
  __shared__ int wcount[kWarpsN];
  __shared__ int tail_end;
  __shared__ float part[kWarpsN][NC];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int e0 = blockIdx.x * EB, e1 = min(E, e0 + EB), n = max(e1 - e0, 0);
  const int64_t N = num_segments;

  // one round of loads: the block's ids and messages, the id before them,
  // the kLook ids after them and the last id
  for (int t = tid; t < n; t += kNarrowThreads) {
    const int64_t e = e0 + t;
    sid[t + 1] = ids[e];
    const T* m = msg + e * C;
#pragma unroll
    for (int c = 0; c < NC; ++c) smsg[t][c] = c < C ? hg::to_f(m[c]) : 0.f;
  }
  if (tid == 0) sid[0] = e0 > 0 ? ids[e0 - 1] : -1;
  if (tid < kLook) slook[tid] = e1 + tid < E ? ids[e1 + tid] : LLONG_MAX;
  if (tid == kLook) id_last = E > 0 ? ids[E - 1] : -1;
  __syncthreads();

  // the row starts among the block's edges, in edge order
  int S = 0;
  for (int t0 = 0; t0 < EB; t0 += kNarrowThreads) {
    const int t = t0 + tid;
    const bool st = t < n && sid[t + 1] != sid[t];
    const unsigned b = __ballot_sync(kFull, st);
    if (lane == 0) wcount[warp] = __popc(b);
    __syncthreads();
    int off = S;
    for (int w = 0; w < kWarpsN; ++w) {
      if (w < warp) off += wcount[w];
      S += wcount[w];
    }
    if (st) starts[off + __popc(b & ((1u << lane) - 1))] = t;
    __syncthreads();
  }
  // the block's last row runs on past its edges: the tail, summed below if
  // it starts here (else the block where it starts sums it)
  const int64_t id_t = n > 0 ? sid[n] : -1;
  const bool tail = n > 0 && slook[0] == id_t;
  if (tid == 0) starts[S] = n;
  if (tail && S > 0 && warp == 0) {
    const unsigned b = __ballot_sync(kFull, slook[lane] != id_t);
    int end;
    if (b != 0) {
      end = e1 + __ffs(b) - 1;
    } else if (id_last == id_t) {
      end = E;
    } else {
      end = warp_lower_bound(ids, E, id_t + 1, e1 + kLook, lane);
    }
    if (lane == 0) tail_end = end;
  }
  __syncthreads();

  // one group of kGroup lanes per row: the empty rows before it, then its
  // sum from shared memory (a fixed butterfly over the group)
  const int grp = tid / kGroup, gl = tid % kGroup;
  const unsigned gmask = 0xffu << (lane & ~(kGroup - 1));
  for (int j = grp; j < S; j += kNarrowThreads / kGroup) {
    const int st = starts[j], en = starts[j + 1];
    const int64_t row = sid[st + 1];
    for (int64_t r = max(sid[st] + 1, (int64_t)0) + gl; r < min(row, N); r += kGroup) {
      for (int c = 0; c < C; ++c) out[r * C + c] = hg::from_f<T>(0.f);
    }
    if (j == S - 1 && tail) continue;  // uniform within the group
    float acc[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[c] = 0.f;
    for (int t = st + gl; t < en; t += kGroup) {
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[c] += smsg[t][c];
    }
#pragma unroll
    for (int w = kGroup / 2; w > 0; w /= 2) {
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[c] += __shfl_xor_sync(gmask, acc[c], w, kGroup);
    }
    if (row >= 0 && row < N) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        if (c == gl && c < C) out[row * C + c] = hg::from_f<T>(acc[c]);
      }
    }
  }
  // the last block: the empty rows after the last edge
  if (e1 == E) {
    for (int64_t r = max(id_t + 1, (int64_t)0) + tid; r < N; r += kNarrowThreads) {
      for (int c = 0; c < C; ++c) out[r * C + c] = hg::from_f<T>(0.f);
    }
  }
  if (!(tail && S > 0)) return;  // uniform across the block

  // the tail row, by the whole block: its edges here (shared memory) and
  // past the block (device memory, every load in flight at once), then a
  // fixed reduction (warp butterfly, then the warps in order)
  float s[NC], g[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) s[c] = 0.f;
  for (int t = starts[S - 1] + tid; t < n; t += kNarrowThreads) {
#pragma unroll
    for (int c = 0; c < NC; ++c) s[c] += smsg[t][c];
  }
  walk_narrow<T, NC>(msg, e1 + tid, tail_end, kNarrowThreads, C, g);
#pragma unroll
  for (int c = 0; c < NC; ++c) s[c] += g[c];
#pragma unroll
  for (int w = 16; w > 0; w /= 2) {
#pragma unroll
    for (int c = 0; c < NC; ++c) s[c] += __shfl_xor_sync(kFull, s[c], w);
  }
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < NC; ++c) part[warp][c] = s[c];
  }
  __syncthreads();
  if (tid < C && id_t >= 0 && id_t < N) {
    float t = 0.f;
    for (int w = 0; w < kWarpsN; ++w) t += part[w][tid];
    out[id_t * C + tid] = hg::from_f<T>(t);
  }
}

// wide rows: a block of up to wide_iters * TY <= CAP rows (one edge search)
// x 2 * TX columns, TY rows at a time
template <typename T, int CAP>
__global__ void __launch_bounds__(kThreads)
sorted_segment_sum_wide(const T* __restrict__ msg, const int64_t* __restrict__ ids,
                        T* __restrict__ out, int E, int num_segments, int C,
                        int rows_per_block) {
  __shared__ BlockRows<CAP> rows;
  __shared__ float part[kThreads][2];
  const int TX = blockDim.x, TY = blockDim.y;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int row0 = (gridDim.x - 1 - blockIdx.x) * rows_per_block;  // last rows first
  const int R = min(rows_per_block, num_segments - row0);
  const int c0 = blockIdx.y * 2 * TX + tx;
  const int c1 = c0 + TX;
  const bool has0 = c0 < C;
  const bool has1 = c1 < C;
  rows.find(ids, E, num_segments, row0, R);

  // ordinary rows: one thread per (row, column pair); long rows are left
  // for the block-wide walk below
  bool is_long = false;
  for (int i = ty; i < R; i += TY) {
    int beg, end;
    rows.range(i, beg, end);
    if (end - beg > kLongRow) {
      is_long = true;
    } else if (has0) {
      float s0, s1;
      walk(msg, beg, end, 1, C, c0, c1, true, has1, s0, s1);
      T* o = out + (int64_t)(row0 + i) * C;
      o[c0] = hg::from_f<T>(s0);
      if (has1) o[c1] = hg::from_f<T>(s1);
    }
  }
  if (__syncthreads_count(is_long) == 0) return;  // most blocks: no long row

  // long rows of this block: every thread row strides the row's edges
  for (int lr = 0; lr < R; ++lr) {
    int beg, end;
    rows.range(lr, beg, end);
    if (end - beg <= kLongRow) continue;  // uniform across the block
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

template <typename T, int EB>
void launch_narrow(const T* m, const int64_t* ids, T* o, int E, int num_segments, int C,
                   cudaStream_t stream) {
  const int blocks = max(1, (E + EB - 1) / EB);
  sorted_segment_sum_narrow<T, EB><<<blocks, kNarrowThreads, 0, stream>>>(m, ids, o, E,
                                                                          num_segments, C);
}

// the launch plan (tune/plans.py): narrow_edges in {128, 256, 512}, wide
// rows per block min(max_rows, TY * wide_iters) <= kMaxRowsCap; the default
// plan (256, 128, 4) is the launch of the constants above
template <typename T>
cudaError_t launch(const void* msg, const int64_t* ids, void* out, int E, int num_segments,
                   int C, int narrow_edges, int max_rows, int wide_iters,
                   cudaStream_t stream) {
  const T* m = static_cast<const T*>(msg);
  T* o = static_cast<T*>(out);
  if (C * static_cast<int>(sizeof(T)) <= 16) {
    switch (narrow_edges) {
      case 128: launch_narrow<T, 128>(m, ids, o, E, num_segments, C, stream); break;
      case kNarrowEdges: launch_narrow<T, kNarrowEdges>(m, ids, o, E, num_segments, C, stream); break;
      case 512: launch_narrow<T, 512>(m, ids, o, E, num_segments, C, stream); break;
      default: return cudaErrorInvalidValue;
    }
    return cudaSuccess;
  }
  // column threads: just enough for C (two columns each), at most a warp
  int tx = 2;
  while (tx < 32 && 2 * tx < C) tx *= 2;
  const int ty = kThreads / tx;
  const int rows = min(max_rows, ty * wide_iters);
  if (rows < 1 || rows > kMaxRowsCap) return cudaErrorInvalidValue;
  const dim3 block(tx, ty);
  const dim3 grid((num_segments + rows - 1) / rows, (C + 2 * tx - 1) / (2 * tx));
  if (rows <= kMaxRows) {
    sorted_segment_sum_wide<T, kMaxRows><<<grid, block, 0, stream>>>(m, ids, o, E, num_segments,
                                                                     C, rows);
  } else {
    sorted_segment_sum_wide<T, kMaxRowsCap><<<grid, block, 0, stream>>>(m, ids, o, E,
                                                                        num_segments, C, rows);
  }
  return cudaSuccess;
}

}  // namespace

// msg [E, C] and out [num_segments, C] row-major in `dtype` (hg::DType);
// ids [E] int64 ascending; narrow_edges, max_rows, wide_iters: the launch
// plan. One kernel launch. Returns cudaGetLastError() after it.
extern "C" int hg_sorted_segment_sum(const void* msg, const int64_t* ids, void* out, int E,
                                     int num_segments, int C, int dtype, int narrow_edges,
                                     int max_rows, int wide_iters, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != hg::kFloat32 && dtype != hg::kBFloat16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_segments > 0 && C > 0) {
    const cudaError_t err =
        dtype == hg::kFloat32
            ? launch<float>(msg, ids, out, E, num_segments, C, narrow_edges, max_rows,
                            wide_iters, s)
            : launch<__nv_bfloat16>(msg, ids, out, E, num_segments, C, narrow_edges, max_rows,
                                    wide_iters, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
