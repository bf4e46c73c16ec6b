// Segment-masked flash self-attention over the flat node array (GPS global
// attention):
//
//   out[i, h] = sum_j softmax_j(q[i, h] . k[j, h] / sqrt(d)) v[j, h]
//
// over the keys j of the same graph as query i, both real (node_mask);
// padding rows, and rows with no valid key, give 0. q, k, v and out are
// [N, H, d]; node_graph ascends (graphs contiguous along the node axis,
// padding nodes in the final dummy graph).
//
// Replaces the TPU kernel hydragnn_tpu/ops/pallas_flash_attention.py
// (flash_self_attention -> _forward -> pl.pallas_call). Same arithmetic and
// rounding points: scores in f32 from the operand values, the online
// softmax (running max m, denominator l, accumulator acc) in f32, and for
// bf16 operands the probabilities p rounded to bf16 before p . v, whose
// products accumulate in f32 (the TPU kernel's p.astype(v.dtype) dot); the
// denominator sums the unrounded p. The TPU kernel's grid and its host
// searchsorted key windows are not carried over:
//   - one block per (q tile of 32 queries, head); four threads per query,
//     each owning d/4 of the head dimension (partial dot products reduced
//     by two shuffles within the group of four);
//   - the block's key window runs from the first node of the graph of its
//     first real query to the last node of the graph of its last real
//     query, read from a graph row pointer that a first small kernel builds
//     from node_graph (common.cuh rowptr_kernel): exact for any graph size,
//     with no static bound. Key/value tiles of 64 rows stream through
//     shared memory (widened to f32), and a query skips every 8-key chunk
//     with no key of its graph, so cross-graph pairs cost a compare;
//   - scores are formed in log2 units (q pre-scaled by log2(e)/sqrt(d)) and
//     exponentiated with exp2f.
//
// What bounds it on an H100: operations. 4*d flops per same-graph pair and
// head against 4*N*H*d elements moved; at the serving shape (graphs of
// 20-225 nodes) that is ~40 flops per byte. This first version runs the
// products on the f32 FMA units (no tensor cores) for both operand types,
// which keeps one code path exact for both; mma.sync bf16 tiles are the
// next step for its speed.
#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr int QT = 32;              // queries per block
constexpr int TPQ = 4;              // threads per query
constexpr int kThreads = QT * TPQ;  // 128
constexpr int BK_DEFAULT = 64;      // keys per shared-memory tile (32 for d = 128)
constexpr int CH = 8;               // keys per online-softmax update

// graph of node n, or -1 for a padding node (never a valid key)
__device__ __forceinline__ int gid_of(const int64_t* __restrict__ node_graph,
                                      const uint8_t* __restrict__ node_mask, int n) {
  return node_mask[n] ? static_cast<int>(node_graph[n]) : -1;
}

template <typename T, int DPT>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, int ldq, int ldk, int ldv,
                       const int64_t* __restrict__ node_graph,
                       const uint8_t* __restrict__ node_mask,
                       const int* __restrict__ graph_ptr, T* __restrict__ out, int N,
                       int H, int G, float scale_log2) {
  constexpr int D = DPT * TPQ;
  constexpr int BK = D > 64 ? 32 : BK_DEFAULT;  // K and V tiles within 48 KB
  __shared__ float ks[BK][D];
  __shared__ float vs[BK][D];
  __shared__ int gk[BK];
  __shared__ int g_lo, g_hi;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int part = tid % TPQ;  // which d/4 slice of the head this thread owns
  const int h = blockIdx.y;
  const int row = blockIdx.x * QT + tid / TPQ;
  // the four threads of one query shuffle among themselves only
  const unsigned group = 0xFu << (lane & ~(TPQ - 1));

  const int gid_q = row < N ? gid_of(node_graph, node_mask, row) : -1;
  float qr[DPT], acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    qr[i] = row < N ? hg::to_f(q[(int64_t)row * ldq + h * D + part * DPT + i]) * scale_log2
                    : 0.f;
    acc[i] = 0.f;
  }
  float m = -CUDART_INF_F, l = 0.f;

  // the block's key window: the graphs of its first and last real queries
  if (tid == 0) {
    g_lo = G;
    g_hi = -1;
  }
  __syncthreads();
  if (gid_q >= 0 && part == 0) {
    atomicMin(&g_lo, gid_q);
    atomicMax(&g_hi, gid_q);
  }
  __syncthreads();
  const int lo = g_lo, hi = g_hi;
  int kbeg = 0, kend = 0;
  if (hi >= 0) {
    kbeg = min(max(graph_ptr[min(lo, G)], 0), N);
    kend = min(max(graph_ptr[min(hi + 1, G)], kbeg), N);
  }

  for (int k0 = kbeg; k0 < kend; k0 += BK) {
    const int nk = min(BK, kend - k0);
    __syncthreads();  // the previous tile is no longer read
    for (int idx = tid; idx < BK * D; idx += kThreads) {
      const int j = idx / D, c = idx % D;
      const bool ok = j < nk;
      ks[j][c] = ok ? hg::to_f(k[(int64_t)(k0 + j) * ldk + h * D + c]) : 0.f;
      vs[j][c] = ok ? hg::to_f(v[(int64_t)(k0 + j) * ldv + h * D + c]) : 0.f;
    }
    for (int j = tid; j < BK; j += kThreads) {
      gk[j] = j < nk ? gid_of(node_graph, node_mask, k0 + j) : -1;
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

  if (row < N) {
    const float inv = 1.f / fmaxf(l, 1e-30f);  // no valid key: acc = 0 -> 0
    T* o = out + ((int64_t)row * H + h) * D + part * DPT;
#pragma unroll
    for (int i = 0; i < DPT; ++i) o[i] = hg::from_f<T>(acc[i] * inv);
  }
}

template <typename T, int DPT>
void launch(const void* q, const void* k, const void* v, int ldq, int ldk, int ldv,
            const int64_t* node_graph, const uint8_t* node_mask, const int* graph_ptr,
            void* out, int N, int H, int G, float scale_log2, cudaStream_t stream) {
  const dim3 grid((N + QT - 1) / QT, H);
  flash_attention_kernel<T, DPT><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), ldq,
      ldk, ldv, node_graph, node_mask, graph_ptr, static_cast<T*>(out), N, H, G,
      scale_log2);
}

template <typename T>
cudaError_t launch_for(int d, const void* q, const void* k, const void* v, int ldq,
                       int ldk, int ldv, const int64_t* node_graph,
                       const uint8_t* node_mask, const int* graph_ptr, void* out, int N,
                       int H, int G, float scale_log2, cudaStream_t s) {
#define HG_CASE(DPT)                                                                   \
  case DPT * TPQ:                                                                      \
    launch<T, DPT>(q, k, v, ldq, ldk, ldv, node_graph, node_mask, graph_ptr, out, N, H, \
                   G, scale_log2, s);                                                  \
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
    const cudaError_t err =
        dtype == hg::kFloat32
            ? launch_for<float>(d, q, k, v, ldq, ldk, ldv, node_graph, node_mask,
                                graph_ptr, out, N, H, G, scale_log2, s)
            : launch_for<__nv_bfloat16>(d, q, k, v, ldq, ldk, ldv, node_graph, node_mask,
                                        graph_ptr, out, N, H, G, scale_log2, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
