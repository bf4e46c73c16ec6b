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
// serving shape, far above the ridge -- so the product runs on Hopper's
// warpgroup tensor-core instruction (wgmma, left operand from registers,
// right operand from shared memory):
//   - bf16 operands: m64n128k16 bf16 products accumulated in f32, exact as
//     the TPU kernel's preferred_element_type=f32 dot;
//   - f32 operands: three TF32 products (3xTF32: x = hi + lo, hi = x rounded
//     to TF32, lo = x - hi, which the tensor core truncates to TF32;
//     a*b ~ a_lo*b_hi + a_hi*b_lo + a_hi*b_hi), about as accurate as an f32
//     FMA loop. Each k slice's products start from zero and are added to the
//     running sum in f32: the tensor core aligns its addends to the largest
//     and truncates the rest, so a long-running accumulator would lose the
//     small terms' bits toward zero at every step. One TF32 product alone
//     keeps 10 mantissa bits and is not used.
// The design:
//   - two small kernels come first: one builds the row pointer, one lays W
//     out as the product reads it: transposed to [Co, Ci] (K-major, rows
//     padded to 16 bytes) and, in f32, split once into the TF32 hi part and
//     the lo remainder (about 9 MB, a few microseconds), so no warp splits
//     W;
//   - a block owns a few receiver rows (about 512 edges) and a 128-column
//     output tile, and walks its edges in tiles of 128: two warpgroups of
//     64 edges each, each holding its 64 x 128 product in registers. The
//     operands of each 64-byte k slice stream through a four-stage cp.async
//     ring in shared memory (three slices in flight while one is
//     multiplied, one barrier per slice): the W slice in the tensor core's
//     own layout (8-row x 16-byte core matrices), and for each edge the
//     16-byte-aligned 80-byte window around its node_recv row slice
//     (gathered by receiver id) and its edge_in row slice, so every copy is
//     a full 16 bytes whatever the row width (866 f32 or bf16 values make
//     rows 8- or 4-byte aligned); the row's offset in its window is kept
//     beside it;
//   - the left operand relu(round(nr + ei)) is formed in registers from
//     those windows, and split there in f32 (two integer instructions and a
//     subtraction), so no separate pass through shared memory; the slice's
//     products are issued asynchronously and waited for once per slice;
//   - the grid runs the column tiles of one row block next to each other,
//     so the repeated gathers of node_recv and edge_in hit in L2, and row
//     blocks last-first, so the dummy padding row (which receives every
//     padding edge) starts first instead of trailing alone;
//   - epilogue per edge tile: bias, relu and the rounding to the operand
//     dtype on the accumulators, the messages staged in shared memory (over
//     the drained ring), then each thread sums the runs of same-row edges of
//     one column in half of the tile, in edge order, into the block's f32
//     row accumulator (a run across the halves joins in a second phase).
//     Deterministic, no atomics; rows without edges stay exactly 0;
//   - widths: ragged k slices and column tiles are zero-filled; rows that
//     are not 4-byte aligned (bf16 of an odd width) or operands that are not
//     16-byte aligned are loaded element by element into the same layout.
#include "common.cuh"

namespace {

constexpr int EM = 128;        // edges per tile: two warpgroups of 64
constexpr int CT = 128;        // output columns per block
constexpr int MAX_ROWS = 32;   // receiver rows a block may own
constexpr int THREADS = 256;   // two warpgroups
constexpr int PLD = CT + 4;    // floats per row of the staged messages

// Per operand dtype: the W tiles a stage holds (f32: hi and lo parts), the
// bytes of a row in one k slice and the k slices in the ring (f32: 64 and
// 4, bf16: 128 and 3, the most that the registers and shared memory hold)
template <typename T> struct Kind;
template <> struct Kind<float> {
  static constexpr int NW = 2, SLICE = 64, STAGES = 4;
};
template <> struct Kind<__nv_bfloat16> {
  static constexpr int NW = 1, SLICE = 128, STAGES = 3;
};

// the shared-memory layout that follows from them
template <typename T>
struct Layout : Kind<T> {
  using Kind<T>::NW;
  using Kind<T>::SLICE;
  using Kind<T>::STAGES;
  static constexpr int STEPS = SLICE / 32;   // tensor-core k steps per slice (32 bytes each)
  static constexpr int WIN = SLICE + 16;     // bytes of an operand row's window
  static constexpr int NCH = WIN / 16;       // 16-byte copies per window
  static constexpr int A_BYTES = EM * WIN;   // one gathered operand of a stage
  static constexpr int B_BYTES = CT * SLICE; // one W tile of a stage
  static constexpr int SB = 2 * A_BYTES + NW * B_BYTES;  // one stage
  static constexpr int SMEM = STAGES * SB + MAX_ROWS * CT * 4 + CT * 4 + 3 * EM * 4 +
                              2 * EM * 16 + 16 + 128;
  static_assert(EM * PLD * 4 <= STAGES * SB, "staged messages fit in the ring");
  static_assert(SMEM <= 232448, "fits the shared memory of an SM");
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// asynchronous 16-byte copy, zero-filled past `valid` bytes
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src, int valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// shared-memory matrix descriptor of a K-major tile without swizzle: core
// matrices of 8 rows x 16 bytes, 128 bytes apart along K (leading) and
// 8 * SLICE bytes apart along N (stride)
template <int SLICE>
__device__ __forceinline__ uint64_t b_desc(unsigned addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>((8 * SLICE) >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving uses of an accumulator across the
// asynchronous products
__device__ __forceinline__ void fence_regs(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= a * B over one k step: 64 edges x 128 columns, a from registers
// (the m16 fragment layout per warp), B from shared memory
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const unsigned (&a)[4], uint64_t desc,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_bf16(float (&d)[64], const unsigned (&a)[4], uint64_t desc,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

// TF32 hi part of x: the mantissa rounded to 10 bits, half away from zero
// (cvt.rna.tf32.f32, in two integer instructions)
__device__ __forceinline__ unsigned tf32_hi(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// relu(round(nr + ei)) of one 32-bit word: one f32 value, or a pair of
// bf16 values
__device__ __forceinline__ float pre_act(unsigned nr, unsigned ei, float) {
  return fmaxf(__uint_as_float(nr) + __uint_as_float(ei), 0.f);
}
__device__ __forceinline__ unsigned pre_act(unsigned nr, unsigned ei, __nv_bfloat16) {
  __nv_bfloat162 a = *reinterpret_cast<__nv_bfloat162*>(&nr);
  __nv_bfloat162 b = *reinterpret_cast<__nv_bfloat162*>(&ei);
  const float2 fa = __bfloat1622float2(a), fb = __bfloat1622float2(b);
  // relu before the rounding: the same as after it (rounding is monotone)
  __nv_bfloat162 r = __floats2bfloat162_rn(fmaxf(fa.x + fb.x, 0.f), fmaxf(fa.y + fb.y, 0.f));
  return *reinterpret_cast<unsigned*>(&r);
}

// W [Ci, Co] -> wt_hi (and, in f32, wt_lo) [Co, ci_pad], zero past Ci: the
// TF32 hi part and the f32 remainder in f32, W itself in bf16. 32 x 32 tiles
// through shared memory, so both sides are coalesced.
template <typename T>
__global__ void __launch_bounds__(256)
prep_w_kernel(const T* __restrict__ W, T* __restrict__ wt_hi, T* __restrict__ wt_lo, int Ci,
              int Co, int ci_pad) {
  __shared__ float tile[32][33];
  const int k0 = blockIdx.x * 32, n0 = blockIdx.y * 32;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  for (int i = ty; i < 32; i += 8) {
    const int k = k0 + i, n = n0 + tx;
    tile[i][tx] = k < Ci && n < Co ? hg::to_f(W[(int64_t)k * Co + n]) : 0.f;
  }
  __syncthreads();
  for (int i = ty; i < 32; i += 8) {
    const int n = n0 + i, k = k0 + tx;
    if (n >= Co || k >= ci_pad) continue;
    const float w = tile[tx][i];
    const int64_t off = (int64_t)n * ci_pad + k;
    if constexpr (Kind<T>::NW == 2) {
      const float hi = __uint_as_float(tf32_hi(w));
      wt_hi[off] = hi;
      wt_lo[off] = w - hi;
    } else {
      wt_hi[off] = hg::from_f<T>(w);
    }
  }
}

// ELEM: operand rows loaded element by element (rows not 4-byte aligned, or
// operands not 16-byte aligned) instead of as 16-byte windows
template <typename T, bool ELEM>
__global__ void __launch_bounds__(THREADS, 1)
fused_edge_kernel(const T* __restrict__ nrecv, const T* __restrict__ ein,
                  const T* __restrict__ wt_hi, const T* __restrict__ wt_lo,
                  const T* __restrict__ bias, const int64_t* __restrict__ ids,
                  const int* __restrict__ rowptr, T* __restrict__ out, int E, int N, int Ci,
                  int Co, int ci_pad, int rows_per_block, int col_tiles) {
  using L = Layout<T>;
  constexpr int NW = L::NW, SLICE = L::SLICE, STAGES = L::STAGES, STEPS = L::STEPS;
  constexpr int WIN = L::WIN, NCH = L::NCH, A_BYTES = L::A_BYTES, B_BYTES = L::B_BYTES;
  constexpr int SB = L::SB;
  constexpr bool F32 = NW == 2;
  constexpr int KT = SLICE / sizeof(T);  // elements of a k slice
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~static_cast<uintptr_t>(127));
  float (*acc_rows)[CT] = reinterpret_cast<float (*)[CT]>(smem + STAGES * SB);
  float* sbias = reinterpret_cast<float*>(smem + STAGES * SB + MAX_ROWS * CT * 4);
  // the tile's gathered rows (its distinct node_recv rows, then its
  // edge_in rows): each row's 16-byte-aligned window start for slice 0, the
  // bytes from there to the row's end, and its place in a stage (| 1: the
  // row starts aligned, its last copy is not needed; | 2: no row)
  const char** asrc = reinterpret_cast<const char**>(sbias + CT);
  int* arem = reinterpret_cast<int*>(asrc + 2 * EM);
  int* adst = arem + 2 * EM;
  int* sid = adst + 2 * EM;
  int* slot = sid + EM;     // each edge's receiver among the tile's distinct ones
  int* urow = slot + EM;    // the tile's distinct receivers, in order
  int* n_dist = urow + EM;
  float (*msg)[PLD] = reinterpret_cast<float (*)[PLD]>(smem);  // over the drained ring
  const unsigned ring = smem_addr(smem);

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int wg = warp / 4;  // product rows wg*64 .. wg*64+63
  const int g = lane / 4, t4 = lane % 4;
  const int row_a = wg * 64 + (warp % 4) * 16 + g;  // this thread's fragment rows: row_a, +8
  const int n_row_blocks = gridDim.x / col_tiles;
  const int row_block = n_row_blocks - 1 - blockIdx.x / col_tiles;  // last rows first
  const int c0 = (blockIdx.x % col_tiles) * CT;  // column tiles of a row block side by side
  const int r0 = row_block * rows_per_block;
  const int r1 = min(r0 + rows_per_block, N);
  const int nrows = r1 - r0;
  const int e_beg = min(max(rowptr[r0], 0), E);
  const int e_end = min(max(rowptr[r1], e_beg), E);
  const int n_slices = (Ci + KT - 1) / KT;
  const int64_t row_bytes = (int64_t)Ci * sizeof(T);

  for (int i = tid; i < nrows * CT; i += THREADS) acc_rows[i / CT][i % CT] = 0.f;
  if (tid < CT) sbias[tid] = c0 + tid < Co ? hg::to_f(bias[c0 + tid]) : 0.f;

  // this thread's W copies: chunk wkc of rows wn0 + q * WSTEP of the tile
  constexpr int WCH = SLICE / 16;         // 16-byte copies per W row and slice
  constexpr int WSTEP = THREADS / WCH;    // rows between a thread's copies
  constexpr int WQ = CT / WSTEP;          // copies per part and thread
  const int wkc = tid % WCH, wn0 = tid / WCH;
  const T* w_hi_row = wt_hi + (int64_t)(c0 + wn0) * ci_pad + wkc * (16 / sizeof(T));
  const T* w_lo_row = wt_lo + (int64_t)(c0 + wn0) * ci_pad + wkc * (16 / sizeof(T));
  const unsigned w_dst = 2 * A_BYTES + (wn0 / 8) * 8 * SLICE + wkc * 128 + (wn0 % 8) * 16;

  // the copies of slice s (if it exists) into its stage, one group
  auto issue = [&](int s, int cs, int n_e) {
    if (s < n_slices) {
      const unsigned st = ring + (s % STAGES) * SB;
      const int64_t kb = (int64_t)s * SLICE;  // byte offset of the slice in a row
      if constexpr (!ELEM) {
        // the rows' windows: aligned 16-byte copies, zero past the row's end
        const int na = *n_dist + n_e;
        for (int i = tid; i < na * NCH; i += THREADS) {
          const int el = i / NCH, ch = i - el * NCH;
          const int dst = adst[el];
          if ((dst & 2) || (ch == NCH - 1 && (dst & 1))) continue;
          const int left = arem[el] - static_cast<int>(kb) - ch * 16;
          const int valid = left <= 0 ? 0 : left >= 16 ? 16 : left;
          cp_async16(st + (dst & ~15) + ch * 16, asrc[el] + (valid ? kb + ch * 16 : 0), valid);
        }
      } else {
        for (int i = tid; i < 2 * EM * KT; i += THREADS) {
          const int op = i / (EM * KT);
          const int el = (i / KT) % EM;
          const int k = s * KT + i % KT;
          T v = hg::from_f<T>(0.f);
          if (op == 0) {
            if (k < Ci && el < *n_dist && urow[el] >= 0) v = nrecv[(int64_t)urow[el] * Ci + k];
          } else if (k < Ci && el < n_e) {
            v = ein[(int64_t)(cs + el) * Ci + k];
          }
          *reinterpret_cast<T*>(smem + (s % STAGES) * SB + op * A_BYTES + el * WIN +
                                (i % KT) * sizeof(T)) = v;
        }
      }
      // W^T rows c0 .. c0+127 in core-matrix order: row n, 16-byte chunk
      // kc at (n / 8) * 8 * SLICE + kc * 128 + (n % 8) * 16. A thread copies
      // chunk wkc of rows wn0, wn0 + WSTEP, ... of each part.
      const bool k_ok = s * KT + wkc * (16 / static_cast<int>(sizeof(T))) < ci_pad;
#pragma unroll
      for (int q = 0; q < NW * WQ; ++q) {
        const int part = q / WQ, qq = q % WQ;
        const bool ok = k_ok && c0 + wn0 + qq * WSTEP < Co;
        const T* w = (part == 0 ? w_hi_row : w_lo_row) + qq * WSTEP * (int64_t)ci_pad + s * KT;
        cp_async16(w_dst + st + part * B_BYTES + qq * (WSTEP / 8) * 8 * SLICE,
                   ok ? w : wt_hi, ok ? 16 : 0);
      }
    }
    cp_async_commit();  // possibly empty: keeps one group per slice
  };

  for (int cs = e_beg; cs < e_end; cs += EM) {
    const int n_e = min(EM, e_end - cs);
    if (tid < EM) {
      // each edge's receiver, and its index among the tile's distinct
      // receivers (ids ascend: a new one starts where the id changes)
      const int64_t id = tid < n_e ? ids[cs + tid] : -1;
      const int r = (id >= 0 && id < N) ? static_cast<int>(id) : -1;
      const bool start = tid < n_e && (tid == 0 || ids[cs + tid - 1] != id);
      const unsigned ballot = __ballot_sync(0xffffffffu, start);
      sid[tid] = r;
      slot[tid] = __popc(ballot & (0xffffffffu >> (31 - lane)));  // starts up to here
      if (lane == 0) urow[EM - 1 - warp] = __popc(ballot);  // per-warp counts, parked
    }
    __syncthreads();
    if (tid < EM) {
      int before = 0;
      for (int w = 0; w < warp; ++w) before += urow[EM - 1 - w];
      const int k = tid < n_e ? before + slot[tid] - 1 : 0;
      if (tid == EM - 1) {
        int total = 0;
        for (int w = 0; w < EM / 32; ++w) total += urow[EM - 1 - w];
        *n_dist = total;
      }
      slot[tid] = k;
    }
    __syncthreads();
    if (tid < n_e && (tid == 0 || slot[tid - 1] != slot[tid])) {
      urow[slot[tid]] = sid[tid];  // every parked count is read by now
    }
    __syncthreads();
    if (tid < *n_dist + n_e) {
      const bool recv = tid < *n_dist;
      const int r = recv ? urow[tid] : cs + tid - *n_dist;
      const char* row = reinterpret_cast<const char*>(recv ? nrecv : ein) + max(r, 0) * row_bytes;
      const int off = ELEM ? 0 : static_cast<int>(reinterpret_cast<uintptr_t>(row) & 15);
      asrc[tid] = row - off;
      arem[tid] = static_cast<int>(row_bytes) + off;
      adst[tid] = (recv ? tid : EM + tid - *n_dist) * WIN | (off == 0) | (r < 0 ? 2 : 0);
    }
    __syncthreads();
    // this thread's fragment rows in the windows of a stage
    const int nd = *n_dist;
    const int rb = static_cast<int>(row_bytes);
    const int a_nr0 = slot[row_a] * WIN + arem[slot[row_a]] - rb;
    const int a_nr1 = slot[row_a + 8] * WIN + arem[slot[row_a + 8]] - rb;
    const int a_ei0 = A_BYTES + row_a * WIN + (row_a < n_e ? arem[nd + row_a] - rb : 0);
    const int a_ei1 = A_BYTES + (row_a + 8) * WIN + (row_a + 8 < n_e ? arem[nd + row_a + 8] - rb : 0);

    float acc[64];
#pragma unroll
    for (int v = 0; v < 64; ++v) acc[v] = 0.f;

#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) issue(s, cs, n_e);
    for (int s = 0; s < n_slices; ++s) {
      cp_async_wait<STAGES - 2>();  // slice s has landed (for this thread)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
      __syncthreads();              // ... for every thread; slice s-1 is done
      const unsigned char* st = smem + (s % STAGES) * SB;
      const unsigned bst = ring + (s % STAGES) * SB + 2 * A_BYTES;
      // the left operand of both k steps: words 8 * step + t4 (+ 4) of rows
      // row_a and row_a + 8, the m16 fragment layout
      unsigned a_hi[STEPS][4], a_lo[STEPS][4];
#pragma unroll
      for (int step = 0; step < STEPS; ++step) {
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int w = 4 * (8 * step + t4 + (v / 2) * 4);  // byte of the word
          const unsigned nr = *reinterpret_cast<const unsigned*>(st + (v % 2 ? a_nr1 : a_nr0) + w);
          const unsigned ei = *reinterpret_cast<const unsigned*>(st + (v % 2 ? a_ei1 : a_ei0) + w);
          if constexpr (F32) {
            const float x = pre_act(nr, ei, 0.f);
            a_hi[step][v] = tf32_hi(x);
            a_lo[step][v] = __float_as_uint(x - __uint_as_float(a_hi[step][v]));
          } else {
            a_hi[step][v] = pre_act(nr, ei, __nv_bfloat16());
          }
        }
      }
      if constexpr (F32) {
        // the slice's products from zero, small terms first, then added to
        // the running sum in f32
        float d[64];
        fence_regs(d);
        wgmma_fence();
#pragma unroll
        for (int step = 0; step < STEPS; ++step) {
          const uint64_t hi = b_desc<SLICE>(bst + step * 256);
          const uint64_t lo = b_desc<SLICE>(bst + B_BYTES + step * 256);
          wgmma_tf32(d, a_lo[step], hi, step);
          wgmma_tf32(d, a_hi[step], lo, 1);
          wgmma_tf32(d, a_hi[step], hi, 1);
        }
        wgmma_commit();
        issue(s + STAGES - 1, cs, n_e);  // into the stage slice s-1 used, while they run
        wgmma_wait0();
        fence_regs(d);
#pragma unroll
        for (int v = 0; v < 64; ++v) acc[v] += d[v];
      } else {
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int step = 0; step < STEPS; ++step) {
          wgmma_bf16(acc, a_hi[step], b_desc<SLICE>(bst + step * 256), 1);
        }
        wgmma_commit();
        issue(s + STAGES - 1, cs, n_e);  // into the stage slice s-1 used, while they run
        wgmma_wait0();
        fence_regs(acc);
      }
    }
    cp_async_wait<0>();  // no copy may land over the staged messages
    __syncthreads();

    // the tile's messages: bias, relu and the operand-dtype rounding, staged
    // as f32 over the ring. Accumulator 4j + (0, 1) is row row_a, columns
    // 8j + 2 t4 (+ 1); 4j + (2, 3) the same columns of row row_a + 8.
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = j * 8 + 2 * t4;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float2 m;
        m.x = hg::round_to<T>(fmaxf(acc[4 * j + 2 * h] + sbias[col], 0.f));
        m.y = hg::round_to<T>(fmaxf(acc[4 * j + 2 * h + 1] + sbias[col + 1], 0.f));
        *reinterpret_cast<float2*>(&msg[row_a + 8 * h][col]) = m;
      }
    }
    __syncthreads();

    // each thread: one column over half the tile's edges, summing runs of
    // same-row edges in edge order into the row accumulator. A run that
    // continues from the first half is held and added after the first
    // half's threads are done.
    {
      const int col = tid % CT, half = tid / CT;
      const int lo = half * (EM / 2), hi = min(n_e, lo + EM / 2);
      const bool joins = half == 1 && lo < n_e && sid[lo] == sid[lo - 1];
      float carry = 0.f, run = 0.f;
      int carry_row = -1;
      bool first = true;
      for (int e = lo; e < hi; ++e) {
        run += msg[e][col];
        if (e + 1 == hi || sid[e + 1] != sid[e]) {
          const int row = sid[e] - r0;
          if (first && joins) {
            carry = run;
            carry_row = row;
          } else if (row >= 0 && row < nrows) {
            acc_rows[row][col] += run;
          }
          first = false;
          run = 0.f;
        }
      }
      __syncthreads();
      if (carry_row >= 0 && carry_row < nrows) acc_rows[carry_row][col] += carry;
    }
    __syncthreads();  // the staged messages are overwritten by the next tile
  }
  __syncthreads();  // blocks with no edges: acc zeroing before the store

  for (int i = tid; i < nrows * CT; i += THREADS) {
    const int row = i / CT;
    const int col = c0 + i % CT;
    if (col < Co) out[(int64_t)(r0 + row) * Co + col] = hg::from_f<T>(acc_rows[row][i % CT]);
  }
}

template <typename T, bool ELEM>
cudaError_t launch(const void* nrecv, const void* ein, const T* wt_hi, const T* wt_lo,
                   const void* b, const int64_t* ids, const int* rowptr, void* out, int E,
                   int N, int Ci, int Co, int ci_pad, int rows_per_block, cudaStream_t stream) {
  constexpr int kSmem = Layout<T>::SMEM;
  // more than the 48 KB a block gets by default: raised once per variant
  static const cudaError_t attr = cudaFuncSetAttribute(
      fused_edge_kernel<T, ELEM>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return attr;
  const int col_tiles = (Co + CT - 1) / CT;
  const int row_blocks = (N + rows_per_block - 1) / rows_per_block;
  fused_edge_kernel<T, ELEM><<<row_blocks * col_tiles, THREADS, kSmem, stream>>>(
      static_cast<const T*>(nrecv), static_cast<const T*>(ein), wt_hi, wt_lo,
      static_cast<const T*>(b), ids, rowptr, static_cast<T*>(out), E, N, Ci, Co, ci_pad,
      rows_per_block, col_tiles);
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_for(const void* nrecv, const void* ein, const void* W, const void* b,
                       const int64_t* ids, const int* rowptr, void* scratch, void* out,
                       int E, int N, int Ci, int Co, int rows_per_block, cudaStream_t stream) {
  constexpr int EPW = 16 / sizeof(T);
  const int ci_pad = (Ci + EPW - 1) / EPW * EPW;
  T* wt_hi = static_cast<T*>(scratch);
  T* wt_lo = wt_hi + (int64_t)Co * ci_pad;
  prep_w_kernel<T><<<dim3((ci_pad + 31) / 32, (Co + 31) / 32), 256, 0, stream>>>(
      static_cast<const T*>(W), wt_hi, wt_lo, Ci, Co, ci_pad);
  // 16-byte windows need word-aligned rows in 16-byte-aligned operands
  const uintptr_t addr = reinterpret_cast<uintptr_t>(nrecv) | reinterpret_cast<uintptr_t>(ein);
  if ((Ci * sizeof(T)) % 4 == 0 && addr % 16 == 0) {
    return launch<T, false>(nrecv, ein, wt_hi, wt_lo, b, ids, rowptr, out, E, N, Ci, Co,
                            ci_pad, rows_per_block, stream);
  }
  return launch<T, true>(nrecv, ein, wt_hi, wt_lo, b, ids, rowptr, out, E, N, Ci, Co, ci_pad,
                         rows_per_block, stream);
}

}  // namespace

// node_recv [N, Ci], edge_in [E, Ci], W [Ci, Co], b [Co], out [N, Co], all
// row-major in `dtype` (hg::DType); ids [E] int64 ascending. scratch: the
// row pointer [N + 1] int32, then (from the next 16-byte boundary) W laid
// out for the product: [Co, ci_pad] in the operand dtype, twice in f32 (hi
// and lo), ci_pad = Ci rounded up to 16 bytes. Three launches (row pointer,
// W layout, the product); returns cudaGetLastError() after them.
extern "C" int hg_fused_edge_message_sum(const void* node_recv, const void* edge_in,
                                         const void* W, const void* b,
                                         const int64_t* ids, void* scratch,
                                         void* out, int E, int N, int Ci, int Co,
                                         int rows_per_block, int dtype,
                                         void* stream) {
  if (rows_per_block < 1 || rows_per_block > MAX_ROWS ||
      (dtype != hg::kFloat32 && dtype != hg::kBFloat16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N > 0 && Co > 0) {
    int* rowptr = static_cast<int*>(scratch);
    void* wt = static_cast<char*>(scratch) + ((int64_t)N + 1 + 3) / 4 * 16;
    hg::launch_rowptr(ids, E, N, rowptr, s);
    const cudaError_t err =
        dtype == hg::kFloat32
            ? launch_for<float>(node_recv, edge_in, W, b, ids, rowptr, wt, out, E, N, Ci, Co,
                                rows_per_block, s)
            : launch_for<__nv_bfloat16>(node_recv, edge_in, W, b, ids, rowptr, wt, out, E, N,
                                        Ci, Co, rows_per_block, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
