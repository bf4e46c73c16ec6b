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
// sorted, so row i owns a contiguous edge range and node_recv[i] is the same
// row for every edge of row i: it is loaded once per row.
//
// What bounds it on an H100: bytes. The function reads edge_in (and gate)
// once and node_recv once, and writes four f32 [N, C] moments: about six
// flops per element read, far below the ridge. At the serving shape (18k
// edges x 256 columns) the bytes take a few microseconds, so what is left is
// latency: launches and dependent memory round trips. The design is one
// launch with as few round trips per block as the data allow:
//   - vector loads: a thread owns VEC = 4 adjacent columns (one 16-byte load
//     in f32, 8-byte in bf16; bf16 adds node_recv to both halves of a word
//     in one instruction) and a group of TX threads one row (a warp covers
//     128 columns with one fully used load per edge). Widths that are not
//     multiples of 4, or unaligned operands, take the same kernel with
//     VEC = 1. Each thread keeps 8 edges' loads in flight (4 with a gate);
//   - row blocks own kThreads / TX rows and find their edge ranges
//     themselves: two warps search the block's first and last edge
//     (32-ary, bracketed around where the mean degree puts them), then the
//     threads scan the boundaries between (or, past kScanMax edges, search
//     each boundary) -- no row-pointer kernel;
//   - a split row (one that covers a whole kChunk-edge chunk of the edge
//     axis: in practice the dummy padding row, up to ~17k edges in a batch
//     padded to its ladder's top) is not walked by its row block. The grid's
//     first blocks each own one chunk; a chunk block reduces the part of
//     each split row inside its chunk (at most two: the rows at its ends),
//     its thread groups striding the edges and combined in a fixed order,
//     into a slot of scratch. A per-row arrival counter counts the row's
//     chunks and its row block; whichever arrives last combines the slots
//     in chunk order, writes the row and resets the counter to 0 for the
//     next call. A chunk block finds whether its end rows are split from
//     the ids at its ends and those of the chunks beside it (a row covers a
//     whole chunk iff it covers the next or previous chunk, or this one);
//   - deterministic, no atomics on the values, exact for every row whatever
//     its degree (the TPU kernel leaves rows over max_degree unspecified).
#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kChunk = kThreads;    // edges per chunk of a split row (the default plan; 512 too)
constexpr int kMaxRows = kThreads;  // rows of a row block (kThreads / TX, TX >= 1)
constexpr int kScanMax = 4 * kThreads;  // boundaries a row block scans (four a thread)
constexpr int kArrive = 1 << 30;    // a split row's counter reaches this when all arrived

struct __align__(16) Moments {
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

// VEC adjacent elements, loaded as one access (16 bytes when VEC * size
// is) into 32-bit words; bf16 values sit in the words' halves
template <typename T, int VEC>
struct Vec {
  static constexpr int BYTES = sizeof(T) * VEC;
  unsigned w[(BYTES + 3) / 4];
  __device__ __forceinline__ void load(const T* p) {
    if constexpr (BYTES == 16) {
      const uint4 t = *reinterpret_cast<const uint4*>(p);
      w[0] = t.x, w[1] = t.y, w[2] = t.z, w[3] = t.w;
    } else if constexpr (BYTES == 8) {
      const uint2 t = *reinterpret_cast<const uint2*>(p);
      w[0] = t.x, w[1] = t.y;
    } else if constexpr (BYTES == 4) {
      w[0] = *reinterpret_cast<const unsigned*>(p);
    } else {
      w[0] = *reinterpret_cast<const unsigned short*>(p);
    }
  }
  __device__ __forceinline__ float operator[](int k) const {
    if constexpr (sizeof(T) == 4) return __uint_as_float(w[k]);
    return __uint_as_float(((w[k / 2] >> (16 * (k % 2))) & 0xffffu) << 16);
  }
};

struct Args {
  const void* nrecv;
  const void* ein;
  const void* gate;
  const int64_t* ids;
  float* s;
  float* cnt;
  float* mn;
  float* mx;
  float* ssq;
  int* counters;  // [N * cb] split-row arrivals, 0 between calls
  int2* info;     // [N] a split row's edge range, written by its row block
  Moments* part;  // [n_chunks * 2 * C] a chunk's partial moments of its end rows
  int E, N, C, n_chunks, cb;
};

// the first e in [lo, hi] with e == hi or ids[e] >= key (ids ascending), by
// the 32 lanes of one warp: each round tests 32 evenly spaced pivots
__device__ __forceinline__ int warp_search(const int64_t* __restrict__ ids, int lo, int hi, int64_t key,
                           int lane) {
  while (hi > lo) {
    const int step = (hi - lo + 31) / 32;
    const int pivot = lo + (lane + 1) * step - 1;
    const bool ge = pivot >= hi || ids[pivot] >= key;
    const int j = __ffs(__ballot_sync(kFull, ge)) - 1;  // ge ascends with the lane
    if (j < 0) return hi;
    hi = min(lo + (j + 1) * step - 1, hi);
    lo += j * step;
  }
  return lo;
}

// the first edge e in [0, E] with ids[e] >= key: the first round tries the
// 1,024 edges around `guess` and checks in the same round that the answer
// lies there (two rounds where it does, the full range where not)
__device__ __forceinline__ int warp_lower_bound(const int64_t* __restrict__ ids, int E, int64_t key, int guess,
                                int lane) {
  constexpr int kBracket = 32 * 32;
  int lo = max(0, min(guess - kBracket / 2, E - kBracket)), hi = min(E, lo + kBracket);
  bool first = true;
  while (hi > lo) {
    const int step = (hi - lo + 31) / 32;
    const int pivot = lo + (lane + 1) * step - 1;
    const bool ge = pivot >= hi || ids[pivot] >= key;
    const int j = __ffs(__ballot_sync(kFull, ge)) - 1;
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
    if (j < 0) return hi;
    hi = min(lo + (j + 1) * step - 1, hi);
    lo += j * step;
  }
  return lo;
}

// rowptr[i] = the first edge of row r0 + i, for i in [0, R], found by the
// block (every thread calls find)
struct BlockRows {
  int ebeg, eend;
  int rowptr[kMaxRows + 1];

  __device__ __forceinline__ void find(const int64_t* __restrict__ ids, int E, int N, int r0, int R, int tid) {
    const int warp = tid / 32, lane = tid % 32;
    if (warp < 2) {
      const int key = warp == 0 ? r0 : r0 + R;
      const int e = warp_lower_bound(ids, E, key, (int)((float)key * ((float)E / N)), lane);
      if (lane == 0) (warp == 0 ? ebeg : eend) = e;
    }
    __syncthreads();
    const int b = ebeg, en = max(eend, b);
    if (en - b < kScanMax) {
      // the rows that start at each boundary e in [b, en], four boundaries
      // per thread with their loads in flight together
      int64_t prev[4], cur[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = b + tid + u * kThreads;
        prev[u] = e > en ? r0 + R : e == b ? r0 - 1 : ids[e - 1];
        cur[u] = e >= en ? r0 + R : ids[e];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = b + tid + u * kThreads;
        const int64_t lo = prev[u] < r0 - 1 ? r0 - 1 : prev[u];
        const int64_t hi = cur[u] > r0 + R ? r0 + R : cur[u];
        for (int64_t r = lo + 1; r <= hi; ++r) rowptr[r - r0] = e;
      }
    } else {
      // a long row among them: search each inner boundary in [b, en]
      if (tid == 0) {
        rowptr[0] = b;
        rowptr[R] = en;
      }
      for (int i = warp + 1; i < R; i += kThreads / 32) {
        const int e = warp_search(ids, b, en, r0 + i, lane);
        if (lane == 0) rowptr[i] = e;
      }
    }
    __syncthreads();
  }

  __device__ __forceinline__ void range(int i, int& beg, int& end) const {
    beg = min(max(rowptr[i], ebeg), eend);
    end = min(max(rowptr[i + 1], beg), eend);
  }
};

// does the row [beg, end) cover a whole chunk (and so take the chunk route)?
template <int CHUNK>
__device__ __forceinline__ bool is_split(int beg, int end, int E) {
  const int s0 = (beg + CHUNK - 1) / CHUNK * CHUNK;
  return end > beg && s0 < E && min(E, s0 + CHUNK) <= end;
}

// a node_recv row's VEC columns, as loaded and widened (0 without one)
template <typename T, int VEC>
__device__ __forceinline__ void load_row(const T* __restrict__ p, bool ok, Vec<T, VEC>& v,
                                         float (&f)[VEC]) {
#pragma unroll
  for (int k = 0; k < (VEC * static_cast<int>(sizeof(T)) + 3) / 4; ++k) v.w[k] = 0u;
  if (ok) v.load(p);
#pragma unroll
  for (int k = 0; k < VEC; ++k) f[k] = v[k];
}

// a + b of two bf16 pairs, each rounded once to bf16: the same as the f32
// sum rounded to bf16 (two bf16 values whose f32 sum is inexact differ by
// more than 2^15, and then both round to the larger)
__device__ __forceinline__ unsigned add_bf16x2(unsigned a, unsigned b) {
  __nv_bfloat162 r = __hadd2(*reinterpret_cast<__nv_bfloat162*>(&a),
                             *reinterpret_cast<__nv_bfloat162*>(&b));
  return *reinterpret_cast<unsigned*>(&r);
}

// edges beg, beg + step, ... < end into m, in edge order, U edges' loads in
// flight; the message rounded like the reference: the add and the gate
// product each in the operand dtype T
template <typename T, int VEC, bool GATE>
__device__ __forceinline__ void walk(const T* __restrict__ ein, const T* __restrict__ gate,
                                     int64_t C, int c, bool recv, const Vec<T, VEC>& nrv,
                                     const float (&nr)[VEC], int beg, int end, int step,
                                     Moments (&m)[VEC]) {
  // bf16 pairs without a gate: the add, min and max on both halves of a
  // word at once (min and max in bf16 are exact), the sums in f32
  constexpr bool PAIRS = sizeof(T) == 2 && VEC % 2 == 0 && !GATE;
  constexpr int NP = PAIRS ? VEC / 2 : 1;
  __nv_bfloat162 lo2[NP], hi2[NP];
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    lo2[j] = __floats2bfloat162_rn(CUDART_INF_F, CUDART_INF_F);
    hi2[j] = __floats2bfloat162_rn(-CUDART_INF_F, -CUDART_INF_F);
  }
  constexpr int U = GATE ? 4 : 8;
  for (int e = beg; e < end; e += U * step) {
    Vec<T, VEC> v[U], g[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t ee = e + u * step;
      if (ee < end) {
        v[u].load(ein + ee * C + c);
        if constexpr (GATE) g[u].load(gate + ee * C + c);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (e + u * step < end) {
        if constexpr (PAIRS) {
#pragma unroll
          for (int j = 0; j < NP; ++j) {
            unsigned x = recv ? add_bf16x2(nrv.w[j], v[u].w[j]) : v[u].w[j];
            const __nv_bfloat162 x2 = *reinterpret_cast<__nv_bfloat162*>(&x);
            lo2[j] = __hmin2(lo2[j], x2);
            hi2[j] = __hmax2(hi2[j], x2);
            const float a = __uint_as_float(x << 16), b = __uint_as_float(x & 0xffff0000u);
            m[2 * j].s += a;
            m[2 * j].q += a * a;
            m[2 * j + 1].s += b;
            m[2 * j + 1].q += b * b;
          }
        } else {
#pragma unroll
          for (int k = 0; k < VEC; ++k) {
            float x = v[u][k];
            if (recv) x = hg::round_to<T>(nr[k] + x);
            if constexpr (GATE) x = hg::round_to<T>(x * g[u][k]);
            m[k].add(x);
          }
        }
      }
    }
  }
  if constexpr (PAIRS) {
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      const float2 lo = __bfloat1622float2(lo2[j]), hi = __bfloat1622float2(hi2[j]);
      m[2 * j].lo = fminf(m[2 * j].lo, lo.x);
      m[2 * j + 1].lo = fminf(m[2 * j + 1].lo, lo.y);
      m[2 * j].hi = fmaxf(m[2 * j].hi, hi.x);
      m[2 * j + 1].hi = fmaxf(m[2 * j + 1].hi, hi.y);
    }
  }
}

template <int VEC>
__device__ __forceinline__ void store_row(const Args a, int r, int c, const Moments (&m)[VEC],
                                          bool empty) {
  const int64_t off = (int64_t)r * a.C + c;
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    a.s[off + k] = m[k].s;
    a.ssq[off + k] = m[k].q;
    a.mn[off + k] = empty ? 0.f : m[k].lo;
    a.mx[off + k] = empty ? 0.f : m[k].hi;
  }
}

// the last arrival of split row r: its chunks' partial moments in chunk
// order, then the row; the counter back to 0 for the next call. By the TX
// threads of one group.
template <int VEC, int CHUNK>
__device__ __forceinline__ void combine(const Args a, int r, int beg, int end, int c, bool has, int tx) {
  if (has) {
    Moments t[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) t[k].init();
    // kBatch chunks' partials in flight at a time, merged in chunk order
    constexpr int kBatch = 4;
    const int jb = beg / CHUNK, je = (end - 1) / CHUNK;
    for (int j0 = jb; j0 <= je; j0 += kBatch) {
      float4 v[kBatch][VEC];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int j = j0 + b;
        const int side = j * CHUNK >= beg ? 0 : 1;  // the row is the chunk's first or last
        const float4* p = reinterpret_cast<const float4*>(a.part) +
                          ((int64_t)j * 2 + side) * a.C + c;
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          // written by other blocks: past L1
          v[b][k] = j <= je ? __ldcg(p + k) : make_float4(0.f, 0.f, CUDART_INF_F, -CUDART_INF_F);
        }
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          Moments o;
          o.s = v[b][k].x;
          o.q = v[b][k].y;
          o.lo = v[b][k].z;
          o.hi = v[b][k].w;
          t[k].merge(o);
        }
      }
    }
    store_row<VEC>(a, r, c, t, false);
  }
  if (tx == 0) {
    if (blockIdx.y == 0) a.cnt[r] = static_cast<float>(end - beg);
    a.counters[(int64_t)r * a.cb + blockIdx.y] = 0;
  }
}

template <int VEC, int CHUNK>
union Shared {
  struct {
    int64_t sid[CHUNK];
    int64_t prev_first, next_last;
    Moments red[kThreads][VEC];
    int last;
  } chunk;
  struct {
    BlockRows rows;
    int last[kMaxRows];
  } row;
};

template <typename T, int VEC, bool GATE, int CHUNK>
__global__ void __launch_bounds__(kThreads, 2) multi_agg_kernel(const Args a) {
  __shared__ Shared<VEC, CHUNK> sh;
  const int TX = blockDim.x, G = blockDim.y;
  const int tx = threadIdx.x, g = threadIdx.y;
  const int tid = tx + g * TX;
  const int c = (blockIdx.y * TX + tx) * VEC;
  const bool has = c < a.C;
  const bool recv = a.nrecv != nullptr;
  const T* nrecv = static_cast<const T*>(a.nrecv);
  const T* ein = static_cast<const T*>(a.ein);
  const T* gate = static_cast<const T*>(a.gate);
  const int E = a.E, N = a.N;

  if (blockIdx.x >= a.n_chunks) {
    // a row block: kThreads / TX rows, one per thread group
    const int r0 = (blockIdx.x - a.n_chunks) * G;
    const int R = min(G, N - r0);
    sh.row.rows.find(a.ids, E, N, r0, R, tid);
    const int r = r0 + g;
    int beg = 0, end = 0;
    bool split = false;
    if (g < R) {
      sh.row.rows.range(g, beg, end);
      split = is_split<CHUNK>(beg, end, E);
      if (!split) {
        if (tx == 0 && blockIdx.y == 0) a.cnt[r] = static_cast<float>(end - beg);
        if (has) {
          Vec<T, VEC> nrv;
          float nr[VEC];
          load_row<T, VEC>(nrecv + (int64_t)r * a.C + c, recv, nrv, nr);
          Moments m[VEC];
#pragma unroll
          for (int k = 0; k < VEC; ++k) m[k].init();
          walk<T, VEC, GATE>(ein, gate, a.C, c, recv, nrv, nr, beg, end, 1, m);
          store_row<VEC>(a, r, c, m, end == beg);
        }
      }
    }
    if (__syncthreads_or(split)) {  // most blocks: no split row
      if (split && tx == 0) {
        a.info[r] = make_int2(beg, end);
        __threadfence();
        const int parts = (end - 1) / CHUNK - beg / CHUNK + 1;
        const int old = atomicAdd(&a.counters[(int64_t)r * a.cb + blockIdx.y], kArrive - parts);
        sh.row.last[g] = old + kArrive - parts == kArrive;
      }
      __syncthreads();
      if (split && sh.row.last[g]) {
        __threadfence();
        combine<VEC, CHUNK>(a, r, beg, end, c, has, tx);
      }
    }
    return;
  }

  // a chunk block: the parts of the split rows at its ends inside its edges
  const int j = blockIdx.x;
  const int e0 = j * CHUNK, e1 = min(E, e0 + CHUNK), n = e1 - e0;
  for (int t = tid; t < n; t += kThreads) sh.chunk.sid[t] = a.ids[e0 + t];
  if (tid == 0) sh.chunk.prev_first = j > 0 ? a.ids[e0 - CHUNK] : -1;
  if (tid == 1) sh.chunk.next_last = e1 < E ? a.ids[min(E, e1 + CHUNK) - 1] : -1;
  __syncthreads();
  const int64_t ra = sh.chunk.sid[0], rb = sh.chunk.sid[n - 1];
  const bool full = ra == rb;
  int n_ra = 0, n_rb = 0;
  for (int t0 = 0; t0 < CHUNK; t0 += kThreads) {  // uniform across the block
    const int t = t0 + tid;
    n_ra += __syncthreads_count(t < n && sh.chunk.sid[t] == ra);
    n_rb += __syncthreads_count(t < n && sh.chunk.sid[t] == rb);
  }
  for (int side = 0; side < 2; ++side) {  // uniform across the block
    const int64_t r = side == 0 ? ra : rb;
    const bool split = side == 0 ? full || sh.chunk.prev_first == ra
                                 : !full && sh.chunk.next_last == rb;
    if (!split || r < 0 || r >= N) continue;
    const int lo = side == 0 ? e0 : e1 - n_rb;
    const int hi = side == 0 ? e0 + n_ra : e1;
    Moments m[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) m[k].init();
    if (has) {
      Vec<T, VEC> nrv;
      float nr[VEC];
      load_row<T, VEC>(nrecv + r * a.C + c, recv, nrv, nr);
      walk<T, VEC, GATE>(ein, gate, a.C, c, recv, nrv, nr, lo + g, hi, G, m);
    }
#pragma unroll
    for (int k = 0; k < VEC; ++k) sh.chunk.red[tid][k] = m[k];
    __syncthreads();
    if (g == 0 && has) {  // the groups' partials in a fixed order
      Moments t[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) t[k] = sh.chunk.red[tx][k];
      for (int q = 1; q < G; ++q) {
#pragma unroll
        for (int k = 0; k < VEC; ++k) t[k].merge(sh.chunk.red[q * TX + tx][k]);
      }
      Moments* p = a.part + ((int64_t)j * 2 + side) * a.C + c;
#pragma unroll
      for (int k = 0; k < VEC; ++k) p[k] = t[k];
      __threadfence();
    }
    __syncthreads();
    if (tid == 0) {
      const int old = atomicAdd(&a.counters[r * a.cb + blockIdx.y], 1);
      sh.chunk.last = old + 1 == kArrive;
    }
    __syncthreads();
    if (sh.chunk.last && g == 0) {
      __threadfence();
      const int2 be = __ldcg(&a.info[r]);
      combine<VEC, CHUNK>(a, static_cast<int>(r), be.x, be.y, c, has, tx);
    }
    __syncthreads();  // red and last are reused by the next side
  }
}

template <typename T, int VEC, bool GATE>
void launch(const Args a, int chunk, int col_threads, cudaStream_t stream) {
  // column threads: just enough for C (VEC columns each), at most
  // col_threads (a warp in the default plan)
  int tx = 1;
  while (tx < col_threads && tx * VEC < a.C) tx *= 2;
  const int g = kThreads / tx;
  const dim3 grid(a.n_chunks + (a.N + g - 1) / g, (a.C + tx * VEC - 1) / (tx * VEC));
  Args b = a;
  b.cb = grid.y;  // a row's counters: one a column block
  if (chunk == kChunk) {
    multi_agg_kernel<T, VEC, GATE, kChunk><<<grid, dim3(tx, g), 0, stream>>>(b);
  } else {
    multi_agg_kernel<T, VEC, GATE, 2 * kChunk><<<grid, dim3(tx, g), 0, stream>>>(b);
  }
}

template <typename T>
void launch_for(const Args a, int chunk, int col_threads, cudaStream_t stream) {
  // four columns a thread: 16-byte loads in f32, 8-byte in bf16 (eight bf16
  // columns a thread halve the threads and double each one's arithmetic:
  // slower at the serving sizes)
  constexpr int V = 4;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(a.ein) |
                         reinterpret_cast<uintptr_t>(a.nrecv) |
                         reinterpret_cast<uintptr_t>(a.gate);
  const bool vec = a.C % V == 0 && addr % (V * sizeof(T)) == 0;
  if (a.gate != nullptr) {
    vec ? launch<T, V, true>(a, chunk, col_threads, stream)
        : launch<T, 1, true>(a, chunk, col_threads, stream);
  } else {
    vec ? launch<T, V, false>(a, chunk, col_threads, stream)
        : launch<T, 1, false>(a, chunk, col_threads, stream);
  }
}

inline int64_t round4(int64_t n) { return (n + 3) / 4 * 4; }

}  // namespace

// edge_in (and gate) [E, C], node_recv [N, C], row-major in `dtype`
// (hg::DType); node_recv and gate may be null. ids [E] int64 ascending.
// counters: N * ceil(C / min(col_threads, C rounded up to a power of two))
// int32, all 0 (the kernel leaves them 0; a row uses one a column block);
// scratch: int32 words, round4(2 N) for the split rows' edge ranges, then
// ceil(E / chunk) * 2 * C * 4 floats of partial moments. Outputs f32: s, mn,
// mx, ssq [N, C] and cnt [N]. The launch plan: chunk (edges per chunk of a
// split row, 256 or 512) and col_threads (column threads of a row, at most;
// 1-32, a power of two). One kernel launch; returns cudaGetLastError()
// after it.
extern "C" int hg_multi_agg(const void* node_recv, const void* edge_in, const void* gate,
                            const int64_t* ids, int* counters, int* scratch, float* s,
                            float* cnt, float* mn, float* mx, float* ssq, int E, int N, int C,
                            int dtype, int chunk, int col_threads, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((dtype != hg::kFloat32 && dtype != hg::kBFloat16) ||
      (chunk != kChunk && chunk != 2 * kChunk) || col_threads < 1 || col_threads > 32 ||
      (col_threads & (col_threads - 1)) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (N > 0 && C > 0) {
    Args a{node_recv, edge_in, gate, ids, s, cnt, mn, mx, ssq, counters,
           reinterpret_cast<int2*>(scratch),
           reinterpret_cast<Moments*>(scratch + round4(2 * (int64_t)N)),
           E, N, C, (E + chunk - 1) / chunk, 0};
    if (dtype == hg::kFloat32) {
      launch_for<float>(a, chunk, col_threads, st);
    } else {
      launch_for<__nv_bfloat16>(a, chunk, col_threads, st);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
