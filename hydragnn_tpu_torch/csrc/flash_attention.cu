// Flash attention over the flat node array, two entries on one inner loop:
//
// hg_flash_attention (K4, GPS global attention): segment-masked
//
//   out[i, h] = sum_j softmax_j(q[i, h] . k[j, h] / sqrt(d)) v[j, h]
//
// over the keys j of the same graph as query i, both real (node_mask);
// padding rows, and rows with no valid key, give 0. q, k, v and out are
// [N, H, d]; node_graph ascends (graphs contiguous along the node axis,
// padding nodes in the final dummy graph).
//
// hg_flash_block_summary (K4b, one block of ring attention): the
// online-softmax partial of every query of q [n_q, H, d] against ONE key
// block k, v [n_k, H, d] with key_mask [n_k]: the normalized o [n_q, H, d]
// in the operand dtype and the f32 statistics m (the row max of the scaled
// scores, natural-log units) and l (sum of exp(s - m)) [n_q, H]. Queries are
// not masked; a row with no valid key gives (m, l, o) = (-1e30, 0, 0), the
// references' finite masking constant. The wrapper un-normalizes
// (acc = o * l) as the TPU wrapper does.
//
// Replace the TPU kernel hydragnn_tpu/ops/pallas_flash_attention.py
// (flash_self_attention and flash_block_summary -> _forward ->
// pl.pallas_call). Same arithmetic and rounding points: scores in f32 from
// the operand values, the online softmax (running max m, denominator l,
// accumulator acc) in f32, and for bf16 operands the probabilities p
// rounded to bf16 before p . v, whose products accumulate in f32 (the TPU
// kernel's p.astype(v.dtype) dot); the denominator sums the unrounded p.
// The TPU kernel's grid and its host searchsorted key windows are not
// carried over:
//   - one block per (q tile of 32 queries, head); four threads per query,
//     each owning d/4 of the head dimension (partial dot products reduced
//     by two shuffles within the group of four);
//   - K4: the block's key window runs from the first node of the graph of
//     its first real query to the last node of the graph of its last real
//     query, read from a graph row pointer that a first small kernel builds
//     from node_graph (common.cuh rowptr_kernel): exact for any graph size,
//     with no static bound. K4b (template flag SUMMARY): the window is the
//     whole key block, every query belongs to the one "graph" 0 and a key's
//     graph is 0 where key_mask holds, -1 where it does not, so the same
//     compare masks it. Key/value tiles of 64 rows stream through shared
//     memory (widened to f32), and a query skips every 8-key chunk with no
//     key of its graph, so cross-graph pairs and masked chunks cost a
//     compare;
//   - scores are formed in log2 units (q pre-scaled by log2(e)/sqrt(d)) and
//     exponentiated with exp2f; K4b converts m back to natural-log units.
//
// What bounds it on an H100: operations. 4*d flops per (query, key) pair
// and head against 4*N*H*d elements moved. K4 at the serving shape (graphs
// of 20-225 nodes) does ~40 flops per byte; K4b over one spanning graph of
// 8k nodes (n_q = n_k, H = 8, d = 32) does 4*n_k*d / (4 * 4 * d) ~ 2k flops
// per f32 byte. This first version runs the products on the f32 FMA units
// (no tensor cores) for both operand types, which keeps one code path exact
// for both, so it cannot beat 67 TFLOP/s, and every key costs each of the
// four threads of a query its own exp2, compare and update. A tensor-core
// version would tile q . k^T and p . v as mma.sync (or wgmma, 64-row warp
// group tiles with TMA-fed K/V stages) products: bf16 operands at up to
// 989 TFLOP/s, f32 operands as three TF32 products (hi*hi, hi*lo, lo*hi)
// to keep f32 accuracy, with the softmax done once per score in registers
// of the accumulator layout instead of once per thread of a query.
#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr int QT = 32;              // queries per block
constexpr int TPQ = 4;              // threads per query
constexpr int kThreads = QT * TPQ;  // 128
constexpr int BK_DEFAULT = 64;      // keys per shared-memory tile (32 for d = 128)
constexpr int CH = 8;               // keys per online-softmax update
constexpr float kLn2 = 0.69314718055994531f;

// the operands of one launch; K4 reads node_graph/graph_ptr/G, K4b m_out/l_out
struct Args {
  const void* q;
  const void* k;
  const void* v;
  int ldq, ldk, ldv;                // row strides in elements
  const int64_t* node_graph;        // K4: [N] ascending graph ids
  const uint8_t* mask;              // K4: node_mask [N]; K4b: key_mask [n_k]
  const int* graph_ptr;             // K4: [G + 1] graph row pointer
  void* out;                        // [n_q, H, d] contiguous
  float* m_out;                     // K4b: [n_q, H]
  float* l_out;                     // K4b: [n_q, H]
  int NQ, NK, H, G;
  float scale_log2;
};

// graph of key (or K4 query) n, or -1 for a node that is never a valid key
template <bool SUMMARY>
__device__ __forceinline__ int gid_of(const Args& a, int n) {
  if constexpr (SUMMARY) {
    return a.mask[n] ? 0 : -1;
  } else {
    return a.mask[n] ? static_cast<int>(a.node_graph[n]) : -1;
  }
}

template <typename T, int DPT, bool SUMMARY>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(const Args a) {
  constexpr int D = DPT * TPQ;
  constexpr int BK = D > 64 ? 32 : BK_DEFAULT;  // K and V tiles within 48 KB
  __shared__ float ks[BK][D];
  __shared__ float vs[BK][D];
  __shared__ int gk[BK];
  __shared__ int g_lo, g_hi;

  const T* __restrict__ q = static_cast<const T*>(a.q);
  const T* __restrict__ k = static_cast<const T*>(a.k);
  const T* __restrict__ v = static_cast<const T*>(a.v);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int part = tid % TPQ;  // which d/4 slice of the head this thread owns
  const int h = blockIdx.y;
  const int row = blockIdx.x * QT + tid / TPQ;
  // the four threads of one query shuffle among themselves only
  const unsigned group = 0xFu << (lane & ~(TPQ - 1));

  // the query's graph; -1 attends to nothing. Every query of a block
  // summary attends (graph 0), padding queries included.
  int gid_q = -1;
  if (row < a.NQ) gid_q = SUMMARY ? 0 : gid_of<false>(a, row);
  float qr[DPT], acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    qr[i] = row < a.NQ
                ? hg::to_f(q[(int64_t)row * a.ldq + h * D + part * DPT + i]) * a.scale_log2
                : 0.f;
    acc[i] = 0.f;
  }
  float m = -CUDART_INF_F, l = 0.f;

  int kbeg = 0, kend = a.NK;
  if constexpr (!SUMMARY) {
    // the block's key window: the graphs of its first and last real queries
    if (tid == 0) {
      g_lo = a.G;
      g_hi = -1;
    }
    __syncthreads();
    if (gid_q >= 0 && part == 0) {
      atomicMin(&g_lo, gid_q);
      atomicMax(&g_hi, gid_q);
    }
    __syncthreads();
    const int lo = g_lo, hi = g_hi;
    kend = 0;
    if (hi >= 0) {
      kbeg = min(max(a.graph_ptr[min(lo, a.G)], 0), a.NK);
      kend = min(max(a.graph_ptr[min(hi + 1, a.G)], kbeg), a.NK);
    }
  }

  for (int k0 = kbeg; k0 < kend; k0 += BK) {
    const int nk = min(BK, kend - k0);
    __syncthreads();  // the previous tile is no longer read
    for (int idx = tid; idx < BK * D; idx += kThreads) {
      const int j = idx / D, c = idx % D;
      const bool ok = j < nk;
      ks[j][c] = ok ? hg::to_f(k[(int64_t)(k0 + j) * a.ldk + h * D + c]) : 0.f;
      vs[j][c] = ok ? hg::to_f(v[(int64_t)(k0 + j) * a.ldv + h * D + c]) : 0.f;
    }
    for (int j = tid; j < BK; j += kThreads) {
      gk[j] = j < nk ? gid_of<SUMMARY>(a, k0 + j) : -1;
    }
    __syncthreads();
    if (gid_q < 0) continue;  // uniform within each group of four

    for (int j0 = 0; j0 < nk; j0 += CH) {
      bool any = false;
#pragma unroll
      for (int u = 0; u < CH; ++u) any |= gk[j0 + u] == gid_q;  // gk is -1 past nk
      if (!any) continue;
      float sc[CH];
      float cmax = -CUDART_INF_F;
#pragma unroll
      for (int u = 0; u < CH; ++u) {
        const float* kr = &ks[j0 + u][part * DPT];
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < DPT; ++i) dot = fmaf(qr[i], kr[i], dot);
        dot += __shfl_xor_sync(group, dot, 1, TPQ);
        dot += __shfl_xor_sync(group, dot, 2, TPQ);
        sc[u] = gk[j0 + u] == gid_q ? dot : -CUDART_INF_F;
        cmax = fmaxf(cmax, sc[u]);
      }
      const float m_new = fmaxf(m, cmax);
      const float corr = exp2f(m - m_new);  // 0 on the first update (m = -inf)
      l *= corr;
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[i] *= corr;
#pragma unroll
      for (int u = 0; u < CH; ++u) {
        const float p = exp2f(sc[u] - m_new);  // 0 for a masked key
        l += p;
        const float pr = hg::round_to<T>(p);  // the p . v operand in T
        const float* vr = &vs[j0 + u][part * DPT];
#pragma unroll
        for (int i = 0; i < DPT; ++i) acc[i] = fmaf(pr, vr[i], acc[i]);
      }
      m = m_new;
    }
  }

  if (row < a.NQ) {
    const float inv = 1.f / fmaxf(l, 1e-30f);  // no valid key: acc = 0 -> 0
    T* o = static_cast<T*>(a.out) + ((int64_t)row * a.H + h) * D + part * DPT;
#pragma unroll
    for (int i = 0; i < DPT; ++i) o[i] = hg::from_f<T>(acc[i] * inv);
    if constexpr (SUMMARY) {
      if (part == 0) {
        const int64_t s = (int64_t)row * a.H + h;
        a.m_out[s] = m == -CUDART_INF_F ? -1.0e30f : m * kLn2;
        a.l_out[s] = l;
      }
    }
  }
}

template <typename T, bool SUMMARY>
cudaError_t launch_for(int d, const Args& a, cudaStream_t s) {
  const dim3 grid((a.NQ + QT - 1) / QT, a.H);
#define HG_CASE(DPT)                                                      \
  case DPT * TPQ:                                                         \
    flash_attention_kernel<T, DPT, SUMMARY><<<grid, kThreads, 0, s>>>(a); \
    return cudaSuccess;
  switch (d) {
    HG_CASE(1)
    HG_CASE(2)
    HG_CASE(4)
    HG_CASE(8)
    HG_CASE(16)
    HG_CASE(32)
    default:
      return cudaErrorInvalidValue;
  }
#undef HG_CASE
}

template <bool SUMMARY>
cudaError_t launch_dtype(int dtype, int d, const Args& a, cudaStream_t s) {
  return dtype == hg::kFloat32 ? launch_for<float, SUMMARY>(d, a, s)
                               : launch_for<__nv_bfloat16, SUMMARY>(d, a, s);
}

}  // namespace

// q, k, v [N, H, d] in `dtype` (hg::DType) with row strides ldq, ldk, ldv
// (elements; the head and dimension axes contiguous), out [N, H, d]
// contiguous; d in {4, 8, 16, 32, 64, 128}. node_graph [N] int64 ascending
// in [0, G); node_mask [N] bool; graph_ptr [G + 1] int32 scratch, filled
// here. scale_log2 = log2(e) / sqrt(d). Returns cudaGetLastError() after the
// launches.
extern "C" int hg_flash_attention(const void* q, const void* k, const void* v, int ldq,
                                  int ldk, int ldv, const int64_t* node_graph,
                                  const uint8_t* node_mask, int* graph_ptr, void* out,
                                  int N, int H, int d, int G, float scale_log2, int dtype,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((dtype != hg::kFloat32 && dtype != hg::kBFloat16) || G < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (N > 0 && H > 0) {
    hg::launch_rowptr(node_graph, N, G, graph_ptr, s);
    const Args a{q, k, v, ldq, ldk, ldv, node_graph, node_mask, graph_ptr, out,
                 nullptr, nullptr, N, N, H, G, scale_log2};
    const cudaError_t err = launch_dtype<false>(dtype, d, a, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// q [NQ, H, d] and k, v [NK, H, d] in `dtype` with row strides ldq, ldk,
// ldv (elements; the head and dimension axes contiguous); key_mask [NK]
// bool; out [NQ, H, d] contiguous in `dtype`; m_out, l_out [NQ, H] f32
// contiguous; d in {4, 8, 16, 32, 64, 128}; scale_log2 = log2(e) / sqrt(d).
// Returns cudaGetLastError() after the launch.
extern "C" int hg_flash_block_summary(const void* q, const void* k, const void* v, int ldq,
                                      int ldk, int ldv, const uint8_t* key_mask, void* out,
                                      float* m_out, float* l_out, int NQ, int NK, int H,
                                      int d, float scale_log2, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((dtype != hg::kFloat32 && dtype != hg::kBFloat16) || NK < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (NQ > 0 && H > 0) {
    const Args a{q, k, v, ldq, ldk, ldv, nullptr, key_mask, nullptr, out,
                 m_out, l_out, NQ, NK, H, 1, scale_log2};
    const cudaError_t err = launch_dtype<true>(dtype, d, a, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
