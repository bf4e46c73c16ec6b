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
//
// Design: a tensor-core flash kernel on mma.sync.
//   - A block owns 64 queries of one head, as 4 warps of 16 query rows. K/V
//     stream through shared memory in tiles of 64 keys (32 or 16 where a
//     row is wider than 128 bytes) on a two-stage cp.async ring: the next
//     tile's copy runs while the tensor cores work on this one. Rows are
//     padded (4 f32 or 8 bf16 elements) so that every fragment load, and
//     ldmatrix, is free of bank conflicts. The copy width (16, 8 or 4 bytes)
//     follows from the alignment of the pointers and row strides, with
//     element copies for 2-byte-aligned bf16 views; rows past the end of
//     the key range are zero-filled.
//   - q . k^T and p . v on the tensor cores. bf16: mma m16n8k16 (bf16 in,
//     f32 accumulation); the S accumulator repacks into the A operand of
//     p . v in registers, V's B operand comes from ldmatrix.trans. f32: three
//     TF32 products on mma m16n8k8, each operand split as hi = rna(x),
//     lo = rna(x - hi) (cvt.rna.tf32.f32's rounding, in integer ops) and
//     summed as lo*hi + hi*lo + hi*hi, which keeps f32 accuracy (one TF32
//     product would not). Each 8-key step of p . v starts from a zero
//     accumulator and is added to acc in f32: the MMA truncates the addends
//     it aligns to the largest, which would bias small products against a
//     large running acc. For p . v the keys of each
//     8-key step are taken in the order (0, 2, 4, 6, 1, 3, 5, 7), so that
//     the S accumulator's C fragment is already the A fragment of m16n8k8
//     (no shuffle), with V's B fragment read in the same order. d below the
//     MMA depth (8 for TF32, 16 for bf16) is zero-padded.
//   - The online softmax runs in the accumulator's registers: scores in
//     log2 units (the f32 score times log2(e)/sqrt(d)), one exp2 per score,
//     the row max and (at the end) the row sum over the quad of a row by
//     shuffles, one rescale of m, l, acc per row and key tile.
//   - Masking at tile granularity first: a warp skips a key tile with no key
//     of its queries' graphs (K4b: an all-masked tile), and takes the
//     per-score compare only where a tile mixes graphs or masked keys. K4:
//     the block's key window runs from the first node of the graph of its
//     first real query to the last node of the graph of its last real
//     query, read from a graph row pointer that a first small kernel builds
//     from node_graph (common.cuh rowptr_kernel); tiles outside it are never
//     loaded. K4b (template flag SUMMARY): the window is the whole key block,
//     every query belongs to the one "graph" 0, and a key's graph is 0 where
//     key_mask holds, -1 where it does not.
//
// What bounds it on an H100: operations. 4*d flops per (query, key) pair and
// head against 4*N*H*d elements moved; K4b over one spanning graph of 8k
// nodes (n_q = n_k, H = 8, d = 32) does ~2k flops per f32 byte. In bf16 the
// bound is the tensor cores' 989 TFLOP/s; in f32 it is three TF32 products
// at 495 TFLOP/s (0.417 ms for K4b at that shape). mma.sync reaches about
// two thirds of the dense peak on Hopper (wgmma, on 64-row warpgroup tiles,
// reaches it), and the TF32 split, the exp2 and the rescale run beside the
// tensor cores on the ALU and SFU pipes; PERF.md has the measured distance
// from the bound.
#include <math_constants.h>

#include <climits>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int QB = 16 * kWarps;  // queries per block: 16 rows per warp
constexpr float kLn2 = 0.69314718055994531f;
constexpr unsigned kFull = 0xffffffffu;

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
  int cw;                           // K/V copy width in bytes: 16, 8, 4, or 0 (elements)
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

// per operand type: the MMA depth and the shared-memory row padding
template <typename T> struct Traits;
template <> struct Traits<float> {
  static constexpr int kDepth = 8;  // m16n8k8 TF32
  static constexpr int kPad = 4;
};
template <> struct Traits<__nv_bfloat16> {
  static constexpr int kDepth = 16;  // m16n8k16 bf16
  static constexpr int kPad = 8;
};

// the tile shapes of one instance; BKO > 0 overrides the keys per tile (a
// launch plan's block_k, tune/plans.py)
template <typename T, int D, int BKO = 0>
struct Shape {
  static constexpr int DP = D > Traits<T>::kDepth ? D : Traits<T>::kDepth;  // padded d
  static constexpr int LD = DP + Traits<T>::kPad;  // shared-memory row stride
  static constexpr int ROW_BYTES = DP * static_cast<int>(sizeof(T));
  static constexpr int BK_DEFAULT = ROW_BYTES <= 128 ? 64 : ROW_BYTES <= 256 ? 32 : 16;
  static constexpr int BK = BKO > 0 ? BKO : BK_DEFAULT;
  static constexpr int NT = BK / 8;              // 8-key n tiles of S
  static constexpr int KS = DP / Traits<T>::kDepth;  // k steps of q . k^T
  static constexpr int ND = DP / 8;              // 8-wide d tiles of the output
  // resident blocks per SM the registers must allow: the most that leaves
  // every instance without spills (f32 needs more registers for the TF32
  // hi/lo parts)
  static constexpr int MIN_BLOCKS = ROW_BYTES > 128 || sizeof(T) == 4 ? 2 : 3;
};

// cvt.rna.tf32.f32 (round to nearest, ties away from zero, the low 13
// mantissa bits cleared), bit for bit, in two integer instructions
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo to within 2^-22 |x|, both TF32
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a * b with a zero accumulator
__device__ __forceinline__ void mma_tf32_zero(float (&d)[4], const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%10,%10,%10,%10};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

// d (+)= lo*hi + hi*lo + hi*hi, the small terms first; FRESH starts from 0
template <bool FRESH>
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], float b0, float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split_tf32(b0, bh0, bl0);
  split_tf32(b1, bh1, bl1);
  if constexpr (FRESH) {
    mma_tf32_zero(d, al, bh0, bh1);
  } else {
    mma_tf32(d, al, bh0, bh1);
  }
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8x8 bf16 matrices, transposed: the B fragments of two d tiles
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

template <int N>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, bool valid) {
  // src-size 0 fills the N bytes with zeros
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;" ::"r"(dst), "l"(src), "n"(N),
               "r"(valid ? N : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;"); }

__device__ __forceinline__ void cp_async_wait_one() { asm volatile("cp.async.wait_group 1;"); }

// rows k0 .. k0 + BK - 1 of head h of src (row stride ld) into dst [BK][LD];
// rows at or past nk are zero-filled
template <typename T, int D, int BKO, int N>
__device__ __forceinline__ void copy_chunks(T* dst, const T* src, int ld, int k0, int nk,
                                            int h, int tid) {
  using S = Shape<T, D, BKO>;
  constexpr int per_row = D * static_cast<int>(sizeof(T)) / N;
  for (int idx = tid; idx < S::BK * per_row; idx += kThreads) {
    const int j = idx / per_row, ch = idx % per_row;
    const bool valid = j < nk;
    const char* g = reinterpret_cast<const char*>(
        src + (valid ? (int64_t)(k0 + j) * ld + h * D : 0)) + (valid ? ch * N : 0);
    cp_async<N>(smem_addr(dst + j * S::LD) + ch * N, g, valid);
  }
}

template <typename T, int D, int BKO>
__device__ __forceinline__ void copy_tile(T* dst, const T* src, int ld, int k0, int nk, int h,
                                          int cw, int tid) {
  using S = Shape<T, D, BKO>;
  constexpr int row_bytes = D * static_cast<int>(sizeof(T));
  if (cw == 16 && row_bytes % 16 == 0) {
    copy_chunks<T, D, BKO, 16>(dst, src, ld, k0, nk, h, tid);
  } else if (cw >= 8 && row_bytes % 8 == 0) {
    copy_chunks<T, D, BKO, 8>(dst, src, ld, k0, nk, h, tid);
  } else if (cw >= 4) {
    copy_chunks<T, D, BKO, 4>(dst, src, ld, k0, nk, h, tid);
  } else {  // 2-byte-aligned bf16 views: element copies
    for (int idx = tid; idx < S::BK * D; idx += kThreads) {
      const int j = idx / D, c = idx % D;
      dst[j * S::LD + c] = j < nk ? src[(int64_t)(k0 + j) * ld + h * D + c] : T(0.f);
    }
  }
}

template <typename T, int D, bool SUMMARY, int BKO = 0>
__global__ void __launch_bounds__(kThreads, (Shape<T, D, BKO>::MIN_BLOCKS))
    flash_attention_kernel(const Args a) {
  using S = Shape<T, D, BKO>;
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int BK = S::BK, LD = S::LD, NT = S::NT, ND = S::ND, DP = S::DP;
  // q's fragments in registers up to d = 64, re-read through L1 per tile at
  // d = 128, where registers are short
  constexpr bool kQRegs = DP <= 64;

  __shared__ __align__(16) T ks[2][BK * LD];
  __shared__ __align__(16) T vs[2][BK * LD];
  __shared__ int gks[2][BK];
  __shared__ int g_lo, g_hi;

  const T* __restrict__ q = static_cast<const T*>(a.q);
  const T* __restrict__ k = static_cast<const T*>(a.k);
  const T* __restrict__ v = static_cast<const T*>(a.v);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, c = lane & 3;  // the fragment row and column of this lane
  const int h = blockIdx.y;
  const int row_a = blockIdx.x * QB + warp * 16 + g, row_b = row_a + 8;

  // zero both stages once: the pad columns (d .. LD) are never copied
  for (int i = tid; i < 2 * BK * LD; i += kThreads) {
    (&ks[0][0])[i] = T(0.f);
    (&vs[0][0])[i] = T(0.f);
  }

  // each row's graph: -2 never matches a key. Every query of a block
  // summary attends (graph 0); rows past NQ are computed but not stored.
  int gq_a = -2, gq_b = -2;
  if constexpr (SUMMARY) {
    gq_a = gq_b = 0;
  } else {
    if (row_a < a.NQ && a.mask[row_a]) gq_a = static_cast<int>(a.node_graph[row_a]);
    if (row_b < a.NQ && a.mask[row_b]) gq_b = static_cast<int>(a.node_graph[row_b]);
  }
  // the warp's graph range (for tile skips) and whether its rows share one graph
  int lo = INT_MAX, hi = -1;
  if (gq_a >= 0) lo = min(lo, gq_a), hi = max(hi, gq_a);
  if (gq_b >= 0) lo = min(lo, gq_b), hi = max(hi, gq_b);
  const int glo = __reduce_min_sync(kFull, lo);
  const int ghi = __reduce_max_sync(kFull, hi);
  const bool one_graph = __all_sync(kFull, gq_a == glo && gq_b == glo);

  // q's A fragments (scaled in f32 after the product, as the reference)
  constexpr int KS = S::KS;
  float qf[kF32 && kQRegs ? KS : 1][4];
  uint32_t qb[!kF32 && kQRegs ? KS : 1][4];
  auto qval = [&](int row, int col) -> float {
    return row < a.NQ && col < D ? hg::to_f(q[(int64_t)row * a.ldq + h * D + col]) : 0.f;
  };
  // bf16: the A fragment of k step s
  auto q_bf16 = [&](int s, uint32_t (&f)[4]) {
    const int c0 = s * 16 + 2 * c;
    f[0] = pack_bf16(qval(row_a, c0), qval(row_a, c0 + 1));
    f[1] = pack_bf16(qval(row_b, c0), qval(row_b, c0 + 1));
    f[2] = pack_bf16(qval(row_a, c0 + 8), qval(row_a, c0 + 9));
    f[3] = pack_bf16(qval(row_b, c0 + 8), qval(row_b, c0 + 9));
  };
#pragma unroll
  for (int s = 0; s < (kQRegs ? KS : 0); ++s) {
    if constexpr (kF32) {
      const int c0 = s * 8 + c;
      qf[s][0] = qval(row_a, c0);
      qf[s][1] = qval(row_b, c0);
      qf[s][2] = qval(row_a, c0 + 4);
      qf[s][3] = qval(row_b, c0 + 4);
    } else {
      q_bf16(s, qb[s]);
    }
  }

  int kbeg = 0, kend = a.NK;
  if constexpr (!SUMMARY) {
    // the block's key window: the graphs of its first and last real queries
    if (tid == 0) {
      g_lo = a.G;
      g_hi = -1;
    }
    __syncthreads();
    if (c == 0) {
      if (gq_a >= 0) atomicMin(&g_lo, gq_a), atomicMax(&g_hi, gq_a);
      if (gq_b >= 0) atomicMin(&g_lo, gq_b), atomicMax(&g_hi, gq_b);
    }
    __syncthreads();
    const int blo = g_lo, bhi = g_hi;
    kend = 0;
    if (bhi >= 0) {
      kbeg = min(max(a.graph_ptr[min(blo, a.G)], 0), a.NK);
      kend = min(max(a.graph_ptr[min(bhi + 1, a.G)], kbeg), a.NK);
    }
  }
  __syncthreads();  // the zeroed stages before the first copy

  auto load = [&](int t) {
    const int st = t & 1, k0 = kbeg + t * BK, nk = min(BK, kend - k0);
    copy_tile<T, D, BKO>(ks[st], k, a.ldk, k0, nk, h, a.cw, tid);
    copy_tile<T, D, BKO>(vs[st], v, a.ldv, k0, nk, h, a.cw, tid);
    for (int j = tid; j < BK; j += kThreads) gks[st][j] = j < nk ? gid_of<SUMMARY>(a, k0 + j) : -1;
  };

  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};  // rows a, b; l per lane

  const int ntiles = (kend - kbeg + BK - 1) / BK;
  if (ntiles > 0) load(0);
  cp_async_commit();
  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) load(t + 1);
    cp_async_commit();
    cp_async_wait_one();  // tile t has landed
    __syncthreads();
    const int st = t & 1;
    const T* kt = ks[st];
    const T* vt = vs[st];
    const int* gk = gks[st];

    // tile-level masking: skip a tile with no key of this warp's graphs;
    // the per-score compare only where the tile is not all one graph
    bool any = false, all = one_graph;
    for (int j = lane; j < BK; j += 32) {
      const int gj = gk[j];
      any |= gj >= 0 && gj >= glo && gj <= ghi;
      all &= gj == glo;
    }
    if (__any_sync(kFull, any)) {
      const bool mask_scores = !__all_sync(kFull, all);

      // S = q . k^T for this warp's 16 rows and the tile's BK keys
      float sc[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        if constexpr (kF32) {
          uint32_t ah[4], al[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if constexpr (kQRegs) {
              split_tf32(qf[s][i], ah[i], al[i]);
            } else {
              split_tf32(qval(i & 1 ? row_b : row_a, s * 8 + c + (i & 2) * 2), ah[i], al[i]);
            }
          }
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const T* kr = kt + (j * 8 + g) * LD + s * 8 + c;
            mma_3xtf32<false>(sc[j], ah, al, kr[0], kr[4]);
          }
        } else {
          uint32_t qs[4];
          if constexpr (kQRegs) {
#pragma unroll
            for (int i = 0; i < 4; ++i) qs[i] = qb[s][i];
          } else {
            q_bf16(s, qs);
          }
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const T* kr = kt + (j * 8 + g) * LD + s * 16 + 2 * c;
            mma_bf16(sc[j], qs, ld_u32(kr), ld_u32(kr + 8));
          }
        }
      }

      // online softmax in the accumulator's registers (log2 units)
      float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[j][e] * a.scale_log2;
          if (mask_scores && gk[j * 8 + 2 * c + (e & 1)] != (e < 2 ? gq_a : gq_b)) {
            x = -CUDART_INF_F;
          }
          sc[j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
      float mu[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        mu[r] = m_new == -CUDART_INF_F ? 0.f : m_new;  // a row with no valid key yet
        const float corr = exp2f(m[r] - mu[r]);  // 0 on the first update (m = -inf)
        m[r] = m_new;
        l[r] *= corr;
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          o[n][2 * r] *= corr;
          o[n][2 * r + 1] *= corr;
        }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(sc[j][e] - mu[e >> 1]);  // 0 for a masked key
          l[e >> 1] += p;
          sc[j][e] = p;
        }
      }

      // acc += p . v
      if constexpr (kF32) {
        // keys of 8-key step j in the order (0, 2, 4, 6, 1, 3, 5, 7): lane c's
        // C fragment (keys 2c, 2c + 1 of rows a, b) is its A fragment. Each
        // 8-key step's product starts from 0 and is added to acc in f32:
        // the MMA aligns its addends to the largest and truncates the rest,
        // so feeding it the running acc would bias every small product.
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          uint32_t ah[4], al[4];
          split_tf32(sc[j][0], ah[0], al[0]);
          split_tf32(sc[j][2], ah[1], al[1]);
          split_tf32(sc[j][1], ah[2], al[2]);
          split_tf32(sc[j][3], ah[3], al[3]);
          const T* vr = vt + (j * 8 + 2 * c) * LD + g;
#pragma unroll
          for (int n = 0; n < ND; ++n) {
            float t[4];
            mma_3xtf32<true>(t, ah, al, vr[n * 8], vr[LD + n * 8]);
#pragma unroll
            for (int e = 0; e < 4; ++e) o[n][e] += t[e];
          }
        }
      } else {
        // p rounded to bf16 (the reference's p.astype(v.dtype)); the C
        // fragments of n tiles 2kk, 2kk + 1 are the A fragment of k step kk
#pragma unroll
        for (int kk = 0; kk < NT / 2; ++kk) {
          const uint32_t pa[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                                  pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                                  pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                                  pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
          // lanes 0-7, 8-15: keys 0-7, 8-15 of d tile n; 16-31: of d tile n + 1
          const T* vr = vt + (kk * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
#pragma unroll
          for (int n = 0; n < ND; n += 2) {
            uint32_t b[4];
            ldmatrix_x4_trans(b, vr + n * 8);
            mma_bf16(o[n], pa, b[0], b[1]);
            mma_bf16(o[n + 1], pa, b[2], b[3]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with stage st before it is refilled
  }

  // the row sums over the quad; normalize and store
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFull, l[r], 1);
    l[r] += __shfl_xor_sync(kFull, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r == 0 ? row_a : row_b;
    if (row >= a.NQ) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);  // no valid key: acc = 0 -> 0
    T* out = static_cast<T*>(a.out) + ((int64_t)row * a.H + h) * D;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const int col = n * 8 + 2 * c;
      if (col < D) out[col] = hg::from_f<T>(o[n][2 * r] * inv);
      if (col + 1 < D) out[col + 1] = hg::from_f<T>(o[n][2 * r + 1] * inv);
    }
    if constexpr (SUMMARY) {
      if (c == 0) {
        const int64_t s = (int64_t)row * a.H + h;
        a.m_out[s] = m[r] == -CUDART_INF_F ? -1.0e30f : m[r] * kLn2;
        a.l_out[s] = l[r];
      }
    }
  }
}

// the widest copy (16, 8 or 4 bytes) that every K and V row start allows; 0
// for element copies
int copy_width(const Args& a, int d, int size) {
  for (int w = 16; w >= 4; w /= 2) {
    if ((d * size) % w == 0 && reinterpret_cast<uintptr_t>(a.k) % w == 0 &&
        reinterpret_cast<uintptr_t>(a.v) % w == 0 && (a.ldk * size) % w == 0 &&
        (a.ldv * size) % w == 0) {
      return w;
    }
  }
  return 0;
}

// block_k: the launch plan's keys per tile, 0 or the instance's own
// (Shape::BK_DEFAULT); d = 32 also has an instance of half its own
template <typename T, bool SUMMARY>
cudaError_t launch_for(int d, int block_k, Args a, cudaStream_t s) {
  const dim3 grid((a.NQ + QB - 1) / QB, a.H);
  a.cw = copy_width(a, d, static_cast<int>(sizeof(T)));
  constexpr int kHalf32 = Shape<T, 32>::BK_DEFAULT / 2;
  if (d == 32 && block_k == kHalf32) {
    flash_attention_kernel<T, 32, SUMMARY, kHalf32><<<grid, kThreads, 0, s>>>(a);
    return cudaSuccess;
  }
#define HG_CASE(D)                                                        \
  case D:                                                                 \
    if (block_k != 0 && block_k != Shape<T, D>::BK_DEFAULT) {             \
      return cudaErrorInvalidValue;                                       \
    }                                                                     \
    flash_attention_kernel<T, D, SUMMARY><<<grid, kThreads, 0, s>>>(a);   \
    return cudaSuccess;
  switch (d) {
    HG_CASE(4)
    HG_CASE(8)
    HG_CASE(16)
    HG_CASE(32)
    HG_CASE(64)
    HG_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef HG_CASE
}

template <bool SUMMARY>
cudaError_t launch_dtype(int dtype, int d, int block_k, const Args& a, cudaStream_t s) {
  return dtype == hg::kFloat32 ? launch_for<float, SUMMARY>(d, block_k, a, s)
                               : launch_for<__nv_bfloat16, SUMMARY>(d, block_k, a, s);
}

}  // namespace

// q, k, v [N, H, d] in `dtype` (hg::DType) with row strides ldq, ldk, ldv
// (elements; the head and dimension axes contiguous), out [N, H, d]
// contiguous; d in {4, 8, 16, 32, 64, 128}. node_graph [N] int64 ascending
// in [0, G); node_mask [N] bool; graph_ptr [G + 1] int32 scratch, filled
// here. scale_log2 = log2(e) / sqrt(d); block_k: the launch plan's keys per
// tile (launch_for). Returns cudaGetLastError() after the launches.
extern "C" int hg_flash_attention(const void* q, const void* k, const void* v, int ldq,
                                  int ldk, int ldv, const int64_t* node_graph,
                                  const uint8_t* node_mask, int* graph_ptr, void* out,
                                  int N, int H, int d, int G, float scale_log2, int dtype,
                                  int block_k, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((dtype != hg::kFloat32 && dtype != hg::kBFloat16) || G < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (N > 0 && H > 0) {
    hg::launch_rowptr(node_graph, N, G, graph_ptr, s);
    const Args a{q, k, v, ldq, ldk, ldv, node_graph, node_mask, graph_ptr, out,
                 nullptr, nullptr, N, N, H, G, scale_log2, 0};
    const cudaError_t err = launch_dtype<false>(dtype, d, block_k, a, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// q [NQ, H, d] and k, v [NK, H, d] in `dtype` with row strides ldq, ldk,
// ldv (elements; the head and dimension axes contiguous); key_mask [NK]
// bool; out [NQ, H, d] contiguous in `dtype`; m_out, l_out [NQ, H] f32
// contiguous; d in {4, 8, 16, 32, 64, 128}; scale_log2 = log2(e) / sqrt(d);
// block_k as hg_flash_attention's. Returns cudaGetLastError() after the
// launch.
extern "C" int hg_flash_block_summary(const void* q, const void* k, const void* v, int ldq,
                                      int ldk, int ldv, const uint8_t* key_mask, void* out,
                                      float* m_out, float* l_out, int NQ, int NK, int H,
                                      int d, float scale_log2, int dtype, int block_k,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((dtype != hg::kFloat32 && dtype != hg::kBFloat16) || NK < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (NQ > 0 && H > 0) {
    const Args a{q, k, v, ldq, ldk, ldv, nullptr, key_mask, nullptr, out,
                 m_out, l_out, NQ, NK, H, 1, scale_log2, 0};
    const cudaError_t err = launch_dtype<true>(dtype, d, block_k, a, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
