// Multi-moment aggregation of edge messages (PNA's four aggregators in one
// pass). Per receiver row i and column c, over the edges e with ids[e] == i,
// of the message  m = (node_recv[i] + edge_in[e]) * gate[e]  (node_recv and
// gate optional):
//
//   sum[i,c] = sum m     cnt[i] = #edges     min[i,c] = min m
//   max[i,c] = max m     ssq[i,c] = sum m*m
//
// all in f32, with min = max = 0 for a row without edges.
//
// Replaces the TPU kernel hydragnn_tpu/ops/pallas_multi_agg.py
// (fused_multi_agg -> _forward -> pl.pallas_call). Same arithmetic and
// rounding points as its reference (reference_multi_agg): the message is
// formed in the operand dtype -- node_recv + edge_in rounded to it, the gate
// product rounded again -- and then widened to f32, so min and max agree
// bitwise with the plain version and sum/sumsq differ only by summation
// order. The TPU kernel's design is not carried over: it gathers node_recv
// and scatters the moments with one-hot MXU products over a K-window grid,
// and reduces min/max through a masked [chunk, Nb, Cb] select. Receivers are
// sorted, so row i owns the contiguous edge range [rowptr[i], rowptr[i+1])
// (rowptr built by a first small kernel, common.cuh rowptr_kernel): no
// one-hot, no scatter, and node_recv[i] is the same row for every edge of
// row i, so it is loaded once per row and the gather disappears.
//
// What bounds it on an H100: bytes. The function reads edge_in (and gate)
// once and node_recv once, and writes four f32 [N, C] moments: about six
// flops per element read, far below the ridge. The design moves each byte
// once and keeps loads in flight:
//   - a block is TY rows x 2*TX columns; a warp covers 32 consecutive
//     columns of one row, so each edge's load is one coalesced segment, and
//     each thread owns two columns (c, c + TX) and keeps their four moments
//     in registers while it walks the row's edges;
//   - an ordinary row (degree <= kLongRow) is walked by its own thread in
//     edge order, four edges' loads in flight per step;
//   - a long row (degree > kLongRow; in practice the dummy padding node,
//     which receives every padding edge, thousands of them in a batch padded
//     to a large ladder level) would serialize one thread, or one block,
//     for its whole length. So long rows take two passes: a first kernel
//     cuts the edge axis into chunks of kChunk edges and gives each chunk a
//     block, which reduces the part of every long row inside its chunk
//     (thread row ty taking edges ty, ty + TY, ...; the TY partials combined
//     in ty order) into a slot of scratch; the main kernel then combines a
//     long row's slots in chunk order. Hundreds of blocks share the dummy
//     row instead of one;
//   - deterministic, no atomics, exact for every row whatever its degree
//     (the TPU kernel leaves rows over max_degree unspecified).
#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kLongRow = 64;  // rows with more edges take the chunked two-pass route
constexpr int kUnroll = 4;    // edges' loads in flight per thread
constexpr int kChunk = 512;   // edges per chunk of the long-row pass
// long rows one chunk can overlap: each has more than kLongRow edges
constexpr int kMaxSlots = kChunk / kLongRow + 2;

inline int num_chunks(int E) { return (E + kChunk - 1) / kChunk; }

struct Moments {
  float s, q, lo, hi;
  __device__ __forceinline__ void init() {
    s = 0.f;
    q = 0.f;
    lo = CUDART_INF_F;
    hi = -CUDART_INF_F;
  }
  __device__ __forceinline__ void add(float m) {
    s += m;
    q += m * m;
    lo = fminf(lo, m);
    hi = fmaxf(hi, m);
  }
  __device__ __forceinline__ void merge(const Moments& o) {
    s += o.s;
    q += o.q;
    lo = fminf(lo, o.lo);
    hi = fmaxf(hi, o.hi);
  }
};

// the message of edge e at column c, rounded like the reference: the add
// and the gate product each in the operand dtype T
template <typename T>
__device__ __forceinline__ float message(bool has_recv, float nr, const T* __restrict__ ein,
                                         const T* __restrict__ gate, int64_t off) {
  float v = hg::to_f(ein[off]);
  if (has_recv) v = hg::round_to<T>(nr + v);
  if (gate != nullptr) v = hg::round_to<T>(v * hg::to_f(gate[off]));
  return v;
}

// edges beg, beg + step, ... < end of one row into the moments of columns
// c0 (and c1 when has1)
template <typename T>
__device__ __forceinline__ void walk(const T* __restrict__ ein, const T* __restrict__ gate,
                                     int beg, int end, int step, int C, int c0, int c1,
                                     bool has1, bool has_recv, float nr0, float nr1,
                                     Moments& m0, Moments& m1) {
  int e = beg;
  for (; e + (kUnroll - 1) * step < end; e += kUnroll * step) {
    float v0[kUnroll], v1[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t row = (int64_t)(e + u * step) * C;
      v0[u] = message(has_recv, nr0, ein, gate, row + c0);
      v1[u] = has1 ? message(has_recv, nr1, ein, gate, row + c1) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {  // in edge order
      m0.add(v0[u]);
      if (has1) m1.add(v1[u]);
    }
  }
  for (; e < end; e += step) {
    const int64_t row = (int64_t)e * C;
    m0.add(message(has_recv, nr0, ein, gate, row + c0));
    if (has1) m1.add(message(has_recv, nr1, ein, gate, row + c1));
  }
}

__device__ __forceinline__ void store(const Moments& m, bool empty, int64_t off,
                                      float* __restrict__ s, float* __restrict__ mn,
                                      float* __restrict__ mx, float* __restrict__ ssq) {
  s[off] = m.s;
  ssq[off] = m.q;
  mn[off] = empty ? 0.f : m.lo;
  mx[off] = empty ? 0.f : m.hi;
}

// Long rows, first pass: the edge axis in chunks of kChunk edges, one block
// per (chunk, column block). A chunk's block walks every long row that
// overlaps it (thread row ty taking edges ty, ty + TY, ...), combines the TY
// partial moments in ty order, and writes them to slot k of the chunk with
// the row's id; short rows are left to the main kernel.
template <typename T>
__global__ void __launch_bounds__(kThreads)
long_partials_kernel(const T* __restrict__ nrecv, const T* __restrict__ ein,
                     const T* __restrict__ gate, const int64_t* __restrict__ ids,
                     const int* __restrict__ rowptr, Moments* __restrict__ part_out,
                     int* __restrict__ slot_row, int* __restrict__ n_slots, int E, int N,
                     int C) {
  __shared__ Moments part[kThreads][2];
  const int TX = blockDim.x, TY = blockDim.y;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int chunk = blockIdx.x;
  const int c0 = blockIdx.y * 2 * TX + tx;
  const int c1 = c0 + TX;
  const bool has0 = c0 < C;
  const bool has1 = c1 < C;
  const bool has_recv = nrecv != nullptr;
  const int e0 = chunk * kChunk;
  const int e1 = min(E, e0 + kChunk);

  // every thread reads the same rows: the control flow is uniform
  int k = 0;
  for (int64_t r0 = ids[e0], r = r0 < 0 ? 0 : (r0 >= N ? N - 1 : r0); r < N; ++r) {
    int beg, end;
    hg::row_range(rowptr, static_cast<int>(r), E, beg, end);
    if (beg >= e1 || k == kMaxSlots) break;
    if (end - beg <= kLongRow) continue;
    const float nr0 = has_recv && has0 ? hg::to_f(nrecv[r * C + c0]) : 0.f;
    const float nr1 = has_recv && has1 ? hg::to_f(nrecv[r * C + c1]) : 0.f;
    Moments m0, m1;
    m0.init();
    m1.init();
    if (has0) {
      walk(ein, gate, max(beg, e0) + ty, min(end, e1), TY, C, c0, c1, has1, has_recv, nr0,
           nr1, m0, m1);
    }
    part[ty * TX + tx][0] = m0;
    part[ty * TX + tx][1] = m1;
    __syncthreads();
    const int64_t slot = (int64_t)chunk * kMaxSlots + k;
    if (ty == 0 && has0) {
      Moments t0 = part[tx][0], t1 = part[tx][1];
      for (int j = 1; j < TY; ++j) {  // fixed order: deterministic
        t0.merge(part[j * TX + tx][0]);
        t1.merge(part[j * TX + tx][1]);
      }
      part_out[slot * C + c0] = t0;
      if (has1) part_out[slot * C + c1] = t1;
    }
    if (tx == 0 && ty == 0 && blockIdx.y == 0) slot_row[slot] = static_cast<int>(r);
    __syncthreads();
    ++k;
  }
  if (tx == 0 && ty == 0 && blockIdx.y == 0) n_slots[chunk] = k;
}

// Every row: a short one walked by its own thread in edge order, a long one
// combined from its chunks' partial moments in chunk order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
multi_agg_kernel(const T* __restrict__ nrecv, const T* __restrict__ ein,
                 const T* __restrict__ gate, const int* __restrict__ rowptr,
                 const Moments* __restrict__ part_in, const int* __restrict__ slot_row,
                 const int* __restrict__ n_slots, float* __restrict__ s,
                 float* __restrict__ cnt, float* __restrict__ mn, float* __restrict__ mx,
                 float* __restrict__ ssq, int E, int N, int C) {
  const int TX = blockDim.x, TY = blockDim.y;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int r = blockIdx.x * TY + ty;
  const int c0 = blockIdx.y * 2 * TX + tx;
  const int c1 = c0 + TX;
  const bool has0 = c0 < C;
  const bool has1 = c1 < C;
  const bool has_recv = nrecv != nullptr;
  if (r >= N) return;
  int beg, end;
  hg::row_range(rowptr, r, E, beg, end);
  if (tx == 0 && blockIdx.y == 0) cnt[r] = static_cast<float>(end - beg);
  if (!has0) return;
  Moments m0, m1;
  m0.init();
  m1.init();
  if (end - beg <= kLongRow) {
    const float nr0 = has_recv ? hg::to_f(nrecv[(int64_t)r * C + c0]) : 0.f;
    const float nr1 = has_recv && has1 ? hg::to_f(nrecv[(int64_t)r * C + c1]) : 0.f;
    walk(ein, gate, beg, end, 1, C, c0, c1, has1, has_recv, nr0, nr1, m0, m1);
  } else {
    for (int chunk = beg / kChunk; chunk <= (end - 1) / kChunk; ++chunk) {
      for (int k = 0; k < n_slots[chunk]; ++k) {
        const int64_t slot = (int64_t)chunk * kMaxSlots + k;
        if (slot_row[slot] != r) continue;
        m0.merge(part_in[slot * C + c0]);
        if (has1) m1.merge(part_in[slot * C + c1]);
      }
    }
  }
  store(m0, end == beg, (int64_t)r * C + c0, s, mn, mx, ssq);
  if (has1) store(m1, end == beg, (int64_t)r * C + c1, s, mn, mx, ssq);
}

template <typename T>
void launch(const void* nrecv, const void* ein, const void* gate, const int64_t* ids,
            const int* rowptr, Moments* part, int* slot_row, int* n_slots, float* s,
            float* cnt, float* mn, float* mx, float* ssq, int E, int N, int C,
            cudaStream_t stream) {
  // column threads: just enough for C (two columns each), at most a warp
  int tx = 1;
  while (tx < 32 && 2 * tx < C) tx *= 2;
  const int ty = kThreads / tx;
  const dim3 block(tx, ty);
  const int col_blocks = (C + 2 * tx - 1) / (2 * tx);
  const T* nr = static_cast<const T*>(nrecv);
  const T* ei = static_cast<const T*>(ein);
  const T* g = static_cast<const T*>(gate);
  if (E > 0) {
    long_partials_kernel<T><<<dim3(num_chunks(E), col_blocks), block, 0, stream>>>(
        nr, ei, g, ids, rowptr, part, slot_row, n_slots, E, N, C);
  }
  multi_agg_kernel<T><<<dim3((N + ty - 1) / ty, col_blocks), block, 0, stream>>>(
      nr, ei, g, rowptr, part, slot_row, n_slots, s, cnt, mn, mx, ssq, E, N, C);
}

}  // namespace

// edge_in (and gate) [E, C], node_recv [N, C], row-major in `dtype`
// (hg::DType); node_recv and gate may be null. ids [E] int64 ascending;
// rowptr [N + 1] int32 scratch, filled here; part, slot_row and n_slots the
// long-row scratch of hg_multi_agg_scratch_floats / _ints elements. Outputs
// f32: s, mn, mx, ssq [N, C] and cnt [N]. Returns cudaGetLastError() after
// the launches.
extern "C" int hg_multi_agg(const void* node_recv, const void* edge_in, const void* gate,
                            const int64_t* ids, int* rowptr, float* part, int* slots,
                            float* s, float* cnt, float* mn, float* mx, float* ssq, int E,
                            int N, int C, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != hg::kFloat32 && dtype != hg::kBFloat16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (N > 0 && C > 0) {
    hg::launch_rowptr(ids, E, N, rowptr, st);
    Moments* p = reinterpret_cast<Moments*>(part);
    int* slot_row = slots;
    int* n_slots = slots + (int64_t)num_chunks(E) * kMaxSlots;
    if (dtype == hg::kFloat32) {
      launch<float>(node_recv, edge_in, gate, ids, rowptr, p, slot_row, n_slots, s, cnt, mn,
                    mx, ssq, E, N, C, st);
    } else {
      launch<__nv_bfloat16>(node_recv, edge_in, gate, ids, rowptr, p, slot_row, n_slots, s,
                            cnt, mn, mx, ssq, E, N, C, st);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// sizes of the long-row scratch for E edges and C columns: partial moments
// (floats) and slot rows + slot counts (ints)
extern "C" int64_t hg_multi_agg_scratch_floats(int E, int C) {
  return (int64_t)num_chunks(E) * kMaxSlots * C * 4;
}
extern "C" int64_t hg_multi_agg_scratch_ints(int E) {
  return (int64_t)num_chunks(E) * (kMaxSlots + 1);
}
