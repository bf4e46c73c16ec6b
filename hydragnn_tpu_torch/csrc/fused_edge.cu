// Fused gather -> edge dense -> sorted-segment sum:
//
//   out[i] = sum_{e : ids[e] == i} relu(relu(node_recv[ids[e]] + edge_in[e]) @ W + b)
//
// Replaces the TPU kernel hydragnn_tpu/ops/pallas_fused_edge.py
// (fused_edge_message_sum -> _forward -> pl.pallas_call). Same arithmetic
// and rounding points: pre = node_recv[ids] + edge_in rounded to the operand
// dtype, the product accumulates in f32, b is added in f32, the message is
// rounded to the operand dtype, and each row sums its messages in f32. The
// per-edge messages [E, Co] never reach device memory. The TPU kernel's
// one-hot gather/scatter matmuls and K-window grid are not carried over:
// receivers are sorted, so a block that owns receiver rows [r0, r1) owns the
// contiguous edge range [rowptr[r0], rowptr[r1]) and gathers its rows
// directly.
//
// What bounds it on an H100: operations. 2*E*Ci*Co flops against roughly
// (E + N)*Ci + Ci*Co + N*Co elements moved -- ~1,700 flops per byte at the
// serving shape, far above the ridge -- so the product runs on the tensor
// cores (warp-level wmma; wgmma and TMA are later work):
//   - bf16 operands: bf16 x bf16 products accumulated in f32, exact as the
//     TPU kernel's preferred_element_type=f32 dot;
//   - f32 operands: three TF32 products (3xTF32: a = a_hi + a_lo with both
//     parts TF32, a*b ~ a_lo*b_hi + a_hi*b_lo + a_hi*b_hi), about as
//     accurate as an f32 FMA loop. Plain TF32 would keep only 10 mantissa
//     bits and is not used. Its bound is three products at the TF32 rate.
// With the product that fast, the operands are the limit: every k slice
// needs a gather of node_recv rows, edge_in rows and a slice of W. So they
// stream through a three-stage cp.async pipeline into shared memory (two
// slices in flight while one is used), and the add + relu + rounding runs
// there, not on the load path. The design:
//   - a block owns a few receiver rows and a 128-column output tile; it walks
//     its edges in chunks of 128, and each chunk in 32-deep k slices. Eight
//     warps each hold a 32 x 64 part of the 128 x 128 product as 2 x 4 f32
//     accumulator fragments;
//   - the fragments are staged in shared memory (over the pipeline buffers);
//     one thread per output column then adds bias, applies relu, rounds the
//     message to the operand dtype and adds it into its row's f32
//     accumulator, in edge order -- deterministic, no atomics;
//   - rows without edges stay exactly 0 (bias and relu never leak into an
//     empty row); the dummy padding row is summed exactly like any other;
//   - row blocks are scheduled last-first, so the dummy padding row, which
//     receives every padding edge, starts first instead of trailing alone;
//   - cp.async moves element pairs, so it needs even Ci and Co (the rows then
//     start on a pair boundary); other widths take the same kernel with
//     plain loads instead of the asynchronous copies.
#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int EC = 128;        // edges per chunk (rows of the product tile)
constexpr int CT = 128;        // output columns per block
constexpr int KT = 32;         // depth of one k slice
constexpr int STAGES = 3;      // k slices in the pipeline
constexpr int MAX_ROWS = 32;   // receiver rows a block may own
constexpr int THREADS = 256;   // 8 warps: 4 (edges) x 2 (columns)

// Per operand dtype: the wmma shape's depth, the fragments, and row paddings
// that keep every fragment pointer 32-byte aligned (a wmma requirement).
template <typename T> struct Mma;
template <> struct Mma<__nv_bfloat16> {
  static constexpr int WK = 16;
  static constexpr int LD = KT + 8;    // 80-byte rows of the raw and A slices
  static constexpr int LDW = CT + 8;   // 272-byte rows of the W slice
  using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
  using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
  using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
};
template <> struct Mma<float> {
  static constexpr int WK = 8;
  static constexpr int LD = KT + 4;    // 144-byte rows
  static constexpr int LDW = CT + 4;   // 528-byte rows
  using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 8, wmma::precision::tf32, wmma::row_major>;
  using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 8, wmma::precision::tf32, wmma::row_major>;
  using Acc = wmma::fragment<wmma::accumulator, 16, 16, 8, float>;
};

template <typename T>
struct Smem {
  struct Stage {       // one k slice as it arrives from device memory
    T nr[EC][Mma<T>::LD];   // node_recv rows gathered by receiver id
    T ei[EC][Mma<T>::LD];   // edge_in rows
    T w[KT][Mma<T>::LDW];   // W rows k0 .. k0+KT-1, columns of this tile
  };
  union {  // the pipeline during the product, the staged product after it
    Stage stage[STAGES];
    float prod[EC][CT];
  };
  T a[EC][Mma<T>::LD];      // relu(round(nr + ei)): the product's left operand
  float acc[MAX_ROWS][CT];
  float bias[CT];
  int ids[EC];
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// asynchronous copy of BYTES bytes, zero-filled past `valid` bytes
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, int valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_addr(dst)),
               "l"(src), "n"(BYTES), "r"(valid));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// split a TF32 fragment's f32 values into hi (kept in place) and lo parts
template <typename Frag>
__device__ __forceinline__ void split_tf32(Frag& hi, Frag& lo) {
#pragma unroll
  for (int t = 0; t < hi.num_elements; ++t) {
    const float v = hi.x[t];
    const float h = wmma::__float_to_tf32(v);
    lo.x[t] = wmma::__float_to_tf32(v - h);
    hi.x[t] = h;
  }
}

template <typename T, bool PAIRS>
__global__ void __launch_bounds__(THREADS)
fused_edge_kernel(const T* __restrict__ nrecv, const T* __restrict__ ein,
                  const T* __restrict__ W, const T* __restrict__ bias,
                  const int64_t* __restrict__ ids, const int* __restrict__ rowptr,
                  T* __restrict__ out, int E, int N, int Ci, int Co,
                  int rows_per_block) {
  using M = Mma<T>;
  extern __shared__ unsigned char smem_raw[];
  // 128-byte aligned view of dynamic shared memory (launch adds the slack)
  Smem<T>& sm = *reinterpret_cast<Smem<T>*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~static_cast<uintptr_t>(127));

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 2;  // product rows wm*32 .. wm*32+31
  const int wn = warp % 2;  // product columns wn*64 .. wn*64+63
  const int row_block = gridDim.x - 1 - blockIdx.x;  // last rows first
  const int r0 = row_block * rows_per_block;
  const int r1 = min(r0 + rows_per_block, N);
  const int nrows = r1 - r0;
  const int c0 = blockIdx.y * CT;
  const int e_beg = min(max(rowptr[r0], 0), E);
  const int e_end = min(max(rowptr[r1], e_beg), E);
  const int n_slices = (Ci + KT - 1) / KT;

  for (int i = tid; i < nrows * CT; i += THREADS) sm.acc[i / CT][i % CT] = 0.f;
  if (tid < CT) sm.bias[tid] = c0 + tid < Co ? hg::to_f(bias[c0 + tid]) : 0.f;

  // issue the copies of slice s (if it exists) into its stage, one group
  auto issue = [&](int s, int cs, int n_e) {
    if (s < n_slices) {
      typename Smem<T>::Stage& st = sm.stage[s % STAGES];
      const int k0 = s * KT;
      if constexpr (PAIRS) {
        constexpr int B = 2 * sizeof(T);
        // node_recv / edge_in: EC rows x KT/2 pairs each
#pragma unroll
        for (int q = 0; q < EC * (KT / 2) / THREADS; ++q) {
          const int i = tid + q * THREADS;
          const int el = i / (KT / 2);
          const int k = k0 + 2 * (i % (KT / 2));
          const int r = sm.ids[el];
          const bool ok = k < Ci;
          cp_async<B>(&st.nr[el][k - k0], ok && r >= 0 ? nrecv + (int64_t)r * Ci + k : nrecv,
                      ok && r >= 0 ? B : 0);
          cp_async<B>(&st.ei[el][k - k0], ok && el < n_e ? ein + (int64_t)(cs + el) * Ci + k : ein,
                      ok && el < n_e ? B : 0);
        }
        // W: KT rows x CT/2 pairs
#pragma unroll
        for (int q = 0; q < KT * (CT / 2) / THREADS; ++q) {
          const int i = tid + q * THREADS;
          const int kk = i / (CT / 2);
          const int col = c0 + 2 * (i % (CT / 2));
          const bool ok = k0 + kk < Ci && col < Co;
          cp_async<B>(&st.w[kk][col - c0], ok ? W + (int64_t)(k0 + kk) * Co + col : W, ok ? B : 0);
        }
      } else {
        const T zero = hg::from_f<T>(0.f);
        for (int i = tid; i < EC * KT; i += THREADS) {
          const int el = i / KT;
          const int k = k0 + i % KT;
          const int r = sm.ids[el];
          st.nr[el][k - k0] = (k < Ci && r >= 0) ? nrecv[(int64_t)r * Ci + k] : zero;
          st.ei[el][k - k0] = (k < Ci && el < n_e) ? ein[(int64_t)(cs + el) * Ci + k] : zero;
        }
        for (int i = tid; i < KT * CT; i += THREADS) {
          const int kk = i / CT;
          const int col = c0 + i % CT;
          st.w[kk][col - c0] = (k0 + kk < Ci && col < Co) ? W[(int64_t)(k0 + kk) * Co + col] : zero;
        }
      }
    }
    cp_async_commit();  // possibly empty: keeps one group per slice
  };

  for (int cs = e_beg; cs < e_end; cs += EC) {
    const int n_e = min(EC, e_end - cs);
    if (tid < EC) {
      const int64_t id = tid < n_e ? ids[cs + tid] : -1;
      sm.ids[tid] = (id >= 0 && id < N) ? static_cast<int>(id) : -1;
    }
    __syncthreads();

    typename M::Acc acc[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) issue(s, cs, n_e);
    for (int s = 0; s < n_slices; ++s) {
      cp_async_wait<STAGES - 2>();  // slice s has landed (for this thread)
      __syncthreads();              // ... for every thread; slice s-1 is done
      issue(s + STAGES - 1, cs, n_e);  // into the stage slice s-1 used
      const typename Smem<T>::Stage& st = sm.stage[s % STAGES];
#pragma unroll
      for (int q = 0; q < EC * KT / THREADS; ++q) {
        const int i = tid + q * THREADS;
        const int el = i / KT;
        const int kk = i % KT;
        const float pre = hg::round_to<T>(hg::to_f(st.nr[el][kk]) + hg::to_f(st.ei[el][kk]));
        sm.a[el][kk] = hg::from_f<T>(fmaxf(pre, 0.f));
      }
      __syncthreads();
#pragma unroll
      for (int k0 = 0; k0 < KT; k0 += M::WK) {
        typename M::FragA a[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(a[i], &sm.a[wm * 32 + i * 16][k0], M::LD);
        if constexpr (sizeof(T) == 4) {
          typename M::FragA a_lo[2];
#pragma unroll
          for (int i = 0; i < 2; ++i) split_tf32(a[i], a_lo[i]);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            typename M::FragB b, b_lo;
            wmma::load_matrix_sync(b, &st.w[k0][wn * 64 + j * 16], M::LDW);
            split_tf32(b, b_lo);
#pragma unroll
            for (int i = 0; i < 2; ++i) {  // small terms first
              wmma::mma_sync(acc[i][j], a_lo[i], b, acc[i][j]);
              wmma::mma_sync(acc[i][j], a[i], b_lo, acc[i][j]);
              wmma::mma_sync(acc[i][j], a[i], b, acc[i][j]);
            }
          }
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            typename M::FragB b;
            wmma::load_matrix_sync(b, &st.w[k0][wn * 64 + j * 16], M::LDW);
#pragma unroll
            for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], a[i], b, acc[i][j]);
          }
        }
      }
    }
    cp_async_wait<0>();  // no copy may land over the staged product
    __syncthreads();

    // stage the product over the pipeline buffers, then one thread per
    // column adds bias, applies relu, rounds the message to T and sums the
    // chunk's edges into their rows in order
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::store_matrix_sync(&sm.prod[wm * 32 + i * 16][wn * 64 + j * 16], acc[i][j],
                                CT, wmma::mem_row_major);
    __syncthreads();
    if (tid < CT) {
      const float b = sm.bias[tid];
      for (int el = 0; el < n_e; ++el) {
        const int row = sm.ids[el] - r0;
        if (row >= 0 && row < nrows)
          sm.acc[row][tid] += hg::round_to<T>(fmaxf(sm.prod[el][tid] + b, 0.f));
      }
    }
    __syncthreads();
  }
  __syncthreads();  // blocks with no edges: acc zeroing before the store

  for (int i = tid; i < nrows * CT; i += THREADS) {
    const int row = i / CT;
    const int col = c0 + i % CT;
    if (col < Co) out[(int64_t)(r0 + row) * Co + col] = hg::from_f<T>(sm.acc[row][i % CT]);
  }
}

template <typename T, bool PAIRS>
cudaError_t launch(const void* nrecv, const void* ein, const void* W, const void* b,
                   const int64_t* ids, const int* rowptr, void* out, int E, int N,
                   int Ci, int Co, int rows_per_block, cudaStream_t stream) {
  constexpr int kSmem = static_cast<int>(sizeof(Smem<T>)) + 128;  // + alignment slack
  // more than the 48 KB a block gets by default: raised once per variant
  static const cudaError_t attr = cudaFuncSetAttribute(
      fused_edge_kernel<T, PAIRS>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((N + rows_per_block - 1) / rows_per_block, (Co + CT - 1) / CT);
  fused_edge_kernel<T, PAIRS><<<grid, THREADS, kSmem, stream>>>(
      static_cast<const T*>(nrecv), static_cast<const T*>(ein),
      static_cast<const T*>(W), static_cast<const T*>(b), ids, rowptr,
      static_cast<T*>(out), E, N, Ci, Co, rows_per_block);
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_for(const void* nrecv, const void* ein, const void* W, const void* b,
                       const int64_t* ids, const int* rowptr, void* out, int E, int N,
                       int Ci, int Co, int rows_per_block, cudaStream_t stream) {
  // element pairs are aligned in every row only when both widths are even
  if (Ci % 2 == 0 && Co % 2 == 0) {
    return launch<T, true>(nrecv, ein, W, b, ids, rowptr, out, E, N, Ci, Co,
                           rows_per_block, stream);
  }
  return launch<T, false>(nrecv, ein, W, b, ids, rowptr, out, E, N, Ci, Co,
                          rows_per_block, stream);
}

}  // namespace

// node_recv [N, Ci], edge_in [E, Ci], W [Ci, Co], b [Co], out [N, Co], all
// row-major in `dtype` (hg::DType); ids [E] int64 ascending; rowptr
// [N + 1] int32 scratch, filled here. Returns cudaGetLastError() after the
// launches.
extern "C" int hg_fused_edge_message_sum(const void* node_recv, const void* edge_in,
                                         const void* W, const void* b,
                                         const int64_t* ids, int* rowptr,
                                         void* out, int E, int N, int Ci, int Co,
                                         int rows_per_block, int dtype,
                                         void* stream) {
  if (rows_per_block < 1 || rows_per_block > MAX_ROWS ||
      (dtype != hg::kFloat32 && dtype != hg::kBFloat16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N > 0 && Co > 0) {
    hg::launch_rowptr(ids, E, N, rowptr, s);
    const cudaError_t err =
        dtype == hg::kFloat32
            ? launch_for<float>(node_recv, edge_in, W, b, ids, rowptr, out, E, N, Ci,
                                Co, rows_per_block, s)
            : launch_for<__nv_bfloat16>(node_recv, edge_in, W, b, ids, rowptr, out, E,
                                        N, Ci, Co, rows_per_block, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
