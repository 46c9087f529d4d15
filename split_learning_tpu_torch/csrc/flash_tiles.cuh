// Tile machinery shared by the flash-attention forward (flash_attention.cu)
// and backward (flash_attention_bwd.cu) kernels for Hopper (sm_90a).
//
// Both kernels are the same loop: a block keeps one tile resident in shared
// memory (16 rows a warp), streams the other side's tiles through a
// two-stage ring, forms a score tile with one tensor-core product, turns it
// into P (or dS) in the accumulator registers, and feeds that straight to a
// second tensor-core product. This header holds the three pieces of that
// loop.
//
// 1. Tile loads. A tile is rows [t0, t0 + rows) of one head's [T, d] view
//    of a [B, T, H, D] tensor (row stride in elements, unit stride along d)
//    and lands in shared memory in the INPUT dtype as [rows][kD + 16 bytes]:
//    the 16-byte row pad shifts consecutive rows by four banks, so the eight
//    row reads of one ldmatrix matrix, and the float32 fragment reads below,
//    hit 32 different banks. The copy is cp.async.cg.shared.global in
//    16-byte pieces, committed in groups, so a tile's copy is in flight while
//    the one before it multiplies; rows past T and columns past d are
//    zero-filled by the copy's source-size operand. A view whose base or
//    strides are not 16-byte aligned (d not a multiple of 8 in bf16, of 4 in
//    float32) takes a scalar load path inside the same kernel.
//
// 2. Warp-level products, Mma<T>. A warp owns 16 rows of the output.
//    - bf16: mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32, operands
//      fetched with ldmatrix.x4 (A, and B where B[k][n] = X[n][k]: Q K^T,
//      dO V^T, K Q^T, V dO^T) or ldmatrix.x4.trans (B where B[k][n] =
//      X[k][n]: P V, P^T dO, dS^T Q, dS K), float32 accumulators.
//    - float32: the error-compensated 3xTF32 split on
//      mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32. Each operand is
//      split in registers at fragment load, hi = cvt.rna.tf32.f32(a),
//      lo = cvt.rna.tf32.f32(a - hi), and a*b is taken as lo*hi + hi*lo +
//      hi*hi, the small terms first, into float32 accumulators. The dropped
//      lo*lo term is 2^-22 of the product, at float32's own rounding.
//    A warp issues the instructions of one depth step across several column
//    tiles (and, in the backward, across S and dP) before it returns to an
//    accumulator, because it waits some 30 cycles for an mma.sync result and
//    the register file leaves an SM only eight warps to hide that.
//    Why mma.sync and not wgmma for every product: the first product's
//    accumulator fragment of mma.sync IS the A fragment of the second (for
//    bf16 after rounding pairs to bf16x2; for TF32 after renaming k, see
//    acc_to_a), so P, P^T, dS and dS^T never touch shared memory, and the
//    transposed second products (P^T dO, dS^T Q) come from computing S^T and
//    dP^T directly with the roles of the two tiles swapped: no transposed
//    copy anywhere. wgmma takes A from registers only in its own 64-row
//    layout and B only from a swizzled shared-memory tile described per
//    instruction; it has no TF32 path that keeps float32's accuracy at three
//    products with a register-side split, and one accumulator layout for
//    both dtypes keeps the softmax and the masks one piece of code. The cost
//    is the ceiling: mma.sync reaches roughly 60% of the wgmma rate.
//
// 3. The online-softmax step on accumulator fragments: scores scaled by
//    scale * log2(e) so the exponential is ex2.approx, row max and row sum over
//    the four lanes of a quad by shuffles, masks built only on diagonal and
//    ragged tiles, NEG_BIG before the max and 0 after the exp.
//
// Fragment layouts (lane = 4 g + t; PTX ISA, "Matrix Fragments for
// mma.m16n8k16" and "mma.m16n8k8"):
//   accumulator, both shapes: c0 (g, 2t) c1 (g, 2t+1) c2 (g+8, 2t)
//                             c3 (g+8, 2t+1)
//   bf16 A 16x16: a0 (g, 2t..2t+1) a1 (g+8, 2t..) a2 (g, 2t+8..)
//                 a3 (g+8, 2t+8..);  B 16x8: b0 (k 2t..2t+1, n g)
//                 b1 (k 2t+8.., n g)
//   tf32 A 16x8:  a0 (g, t) a1 (g+8, t) a2 (g, t+4) a3 (g+8, t+4);
//        B 8x8:   b0 (k t, n g) b1 (k t+4, n g)

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace slt_flash {

constexpr float kNegBig = -1e30f;               // ops/common.py NEG_BIG
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowsPerWarp = 16;    // a warp owns 16 rows of the resident tile
constexpr int kRowsPerBlock = 64;   // rows of the resident tile: four warps,
constexpr int kThreads = 128;       // unless a kernel says otherwise


struct Strides {   // (batch, time, head) strides in elements
  int64_t b, t, h;
};

inline Strides strides_at(const int64_t* st, int i) {
  return Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
}

// true when 16-byte copies from this view are aligned: its base and all
// three strides are multiples of 16 bytes
inline bool view_aligned(const void* p, const Strides& s, size_t elem) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (s.b * elem) % 16 == 0 &&
         (s.t * elem) % 16 == 0 && (s.h * elem) % 16 == 0;
}

// padded row of a shared-memory tile, in elements
template <typename T, int kD>
__host__ __device__ constexpr int row_stride() {
  return kD + 16 / static_cast<int>(sizeof(T));
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// 2^x by the special-function unit (ex2.approx: two ulps, 2^-inf = 0)
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ bool attends(int row, int col, int t_len,
                                        int causal, int strict) {
  bool ok = row < t_len && col < t_len;
  if (causal) ok = ok && (strict ? row > col : row >= col);
  return ok;
}

// ------------------------------------------------------------ tile loads --

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; only the first src_bytes are read, the rest of
// the 16 are written as zero
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(__cvta_generic_to_global(src)), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_4(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(__cvta_generic_to_global(src)), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Rows [t0, t0 + kRows) of one head's [T, d] view (row stride s_t, column
// stride 1) into dst[kRows][row_stride], columns [0, kD); rows >= T and
// columns >= d are zero, so they add nothing to a product. Asynchronous
// when the view is aligned (the caller commits and waits), else scalar.
// A thread copies one 16-byte column piece of every (kThreads / pieces per
// row)-th row, so its column, its byte count and its addresses' strides are
// fixed before the loop, which unrolls.
template <typename T, int kD, int kRows, int kThreads>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src,
                                          int64_t s_t, int t0, int t_len,
                                          int d, bool aligned) {
  constexpr int kChunk = 16 / static_cast<int>(sizeof(T));
  constexpr int kPerRow = kD / kChunk;
  constexpr int kStride = row_stride<T, kD>();
  static_assert(kThreads % kPerRow == 0 &&
                    (kRows * kPerRow) % kThreads == 0,
                "a tile is a whole number of passes of the block");
  constexpr int kRowStep = kThreads / kPerRow;
  if (aligned) {
    const int c = (threadIdx.x % kPerRow) * kChunk;
    const int r0 = threadIdx.x / kPerRow;
    const int bytes =
        c < d ? min(kChunk, d - c) * static_cast<int>(sizeof(T)) : 0;
    const T* from = src + static_cast<int64_t>(t0 + r0) * s_t + c;
    T* to = dst + r0 * kStride + c;
#pragma unroll
    for (int i = 0; i < kRows / kRowStep; ++i) {
      const bool in = bytes > 0 && t0 + r0 + i * kRowStep < t_len;
      cp_async_16(to + i * kRowStep * kStride,
                  in ? from + static_cast<int64_t>(i * kRowStep) * s_t : src,
                  in ? bytes : 0);
    }
  } else {
    for (int e = threadIdx.x; e < kRows * kD; e += kThreads) {
      const int r = e / kD;
      const int c = e - r * kD;
      const int t = t0 + r;
      T v = static_cast<T>(0.f);
      if (t < t_len && c < d) v = src[static_cast<int64_t>(t) * s_t + c];
      dst[r * kStride + c] = v;
    }
  }
}

// Rows [t0, t0 + kRows) of a contiguous [B, T, H] float32 array for head
// (b, h) into dst[kRows]; 0 past the end (those rows are masked).
template <int kRows, int kThreads>
__device__ __forceinline__ void load_rows(float* dst,
                                          const float* __restrict__ src,
                                          int b, int h, int n_heads, int t0,
                                          int t_len) {
  for (int r = threadIdx.x; r < kRows; r += kThreads) {
    const int row = t0 + r;
    const bool in = row < t_len;
    const int64_t at =
        (static_cast<int64_t>(b) * t_len + (in ? row : 0)) * n_heads + h;
    cp_async_4(dst + r, src + at, in ? 4 : 0);
  }
}

// ---------------------------------------------------- warp-level products --

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

template <typename T>
struct Mma;

// bf16 operands, float32 accumulators: m16n8k16
template <>
struct Mma<__nv_bfloat16> {
  using T = __nv_bfloat16;
  static constexpr int kK = 16;   // depth of one step
  struct FragA { uint32_t r[4]; };
  struct FragB { uint32_t r[2]; };

  // A: rows [r0, r0 + 16), depth [k0, k0 + 16) of a row-major tile
  static __device__ __forceinline__ void load_a(FragA& a, const T* tile,
                                                int stride, int r0, int k0,
                                                int lane) {
    ldmatrix_x4(a.r, tile + (r0 + (lane & 15)) * stride + k0 +
                         ((lane >> 4) << 3));
  }
  // B for columns [n0, n0 + 8) and [n0 + 8, n0 + 16), B[k][n] = X[n][k]
  static __device__ __forceinline__ void load_b_nt(FragB& b0, FragB& b1,
                                                   const T* tile, int stride,
                                                   int n0, int k0, int lane) {
    uint32_t r[4];
    ldmatrix_x4(r, tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * stride +
                       k0 + (((lane >> 3) & 1) << 3));
    b0.r[0] = r[0]; b0.r[1] = r[1]; b1.r[0] = r[2]; b1.r[1] = r[3];
  }
  // B for columns [n0, n0 + 8) and [n0 + 8, n0 + 16), B[k][n] = X[k][n]
  static __device__ __forceinline__ void load_b_t(FragB& b0, FragB& b1,
                                                  const T* tile, int stride,
                                                  int k0, int n0, int lane) {
    uint32_t r[4];
    ldmatrix_x4_trans(r, tile + (k0 + (lane & 15)) * stride + n0 +
                             ((lane >> 4) << 3));
    b0.r[0] = r[0]; b0.r[1] = r[1]; b1.r[0] = r[2]; b1.r[1] = r[3];
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
  // The A fragment of one depth step of a second product from the first
  // product's accumulators (two 8-column tiles), rounded to bf16.
  static __device__ __forceinline__ void acc_to_a(FragA& a,
                                                  const float (*c)[4]) {
    a.r[0] = pack(c[0][0], c[0][1]);
    a.r[1] = pack(c[0][2], c[0][3]);
    a.r[2] = pack(c[1][0], c[1][1]);
    a.r[3] = pack(c[1][2], c[1][3]);
  }
  static __device__ __forceinline__ void mma(float (&c)[4], const FragA& a,
                                             const FragB& b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a.r[0]), "r"(a.r[1]), "r"(a.r[2]), "r"(a.r[3]), "r"(b.r[0]),
          "r"(b.r[1]));
  }
  static constexpr int kPhases = 1;
  static __device__ __forceinline__ void mma_phase(float (&c)[4],
                                                   const FragA& a,
                                                   const FragB& b, int) {
    mma(c, a, b);
  }
};

// float32 operands as 3xTF32, float32 accumulators: m16n8k8
template <>
struct Mma<float> {
  using T = float;
  static constexpr int kK = 8;
  struct FragA { uint32_t hi[4], lo[4]; };
  struct FragB { uint32_t hi[2], lo[2]; };

  static __device__ __forceinline__ uint32_t tf32(float x) {
    uint32_t u;
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(u) : "f"(x));
    return u;
  }
  static __device__ __forceinline__ void split(float x, uint32_t& hi,
                                               uint32_t& lo) {
    hi = tf32(x);
    lo = tf32(x - __uint_as_float(hi));
  }
  static __device__ __forceinline__ void load_a(FragA& a, const T* tile,
                                                int stride, int r0, int k0,
                                                int lane) {
    const T* p = tile + (r0 + (lane >> 2)) * stride + k0 + (lane & 3);
    split(p[0], a.hi[0], a.lo[0]);
    split(p[8 * stride], a.hi[1], a.lo[1]);
    split(p[4], a.hi[2], a.lo[2]);
    split(p[8 * stride + 4], a.hi[3], a.lo[3]);
  }
  static __device__ __forceinline__ void load_b_nt(FragB& b0, FragB& b1,
                                                   const T* tile, int stride,
                                                   int n0, int k0, int lane) {
    const T* p = tile + (n0 + (lane >> 2)) * stride + k0 + (lane & 3);
    split(p[0], b0.hi[0], b0.lo[0]);
    split(p[4], b0.hi[1], b0.lo[1]);
    split(p[8 * stride], b1.hi[0], b1.lo[0]);
    split(p[8 * stride + 4], b1.hi[1], b1.lo[1]);
  }
  // The depth index is renamed to match acc_to_a: lane t holds k = 2t in
  // b0 and k = 2t + 1 in b1 of the step's eight.
  static __device__ __forceinline__ void load_b_t(FragB& b0, FragB& b1,
                                                  const T* tile, int stride,
                                                  int k0, int n0, int lane) {
    const T* p = tile + (k0 + 2 * (lane & 3)) * stride + n0 + (lane >> 2);
    split(p[0], b0.hi[0], b0.lo[0]);
    split(p[stride], b0.hi[1], b0.lo[1]);
    split(p[8], b1.hi[0], b1.lo[0]);
    split(p[stride + 8], b1.hi[1], b1.lo[1]);
  }
  // An accumulator tile holds columns 2t and 2t + 1 where the A fragment
  // wants depth t and t + 4. A sum over the depth does not care how the
  // depth is numbered, so the step's eight are renamed (t -> 2t, t + 4 ->
  // 2t + 1) here and in load_b_t, and no value changes lanes.
  static __device__ __forceinline__ void acc_to_a(FragA& a,
                                                  const float (*c)[4]) {
    split(c[0][0], a.hi[0], a.lo[0]);
    split(c[0][2], a.hi[1], a.lo[1]);
    split(c[0][1], a.hi[2], a.lo[2]);
    split(c[0][3], a.hi[3], a.lo[3]);
  }
  static __device__ __forceinline__ void mma1(float (&c)[4],
                                              const uint32_t (&a)[4],
                                              const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  // one of the three products of a step, the small terms first
  static constexpr int kPhases = 3;
  static __device__ __forceinline__ void mma_phase(float (&c)[4],
                                                   const FragA& a,
                                                   const FragB& b, int ph) {
    if (ph == 0) mma1(c, a.lo, b.hi);
    else if (ph == 1) mma1(c, a.hi, b.lo);
    else mma1(c, a.hi, b.hi);
  }
};

template <int kNT>
__device__ __forceinline__ void zero_acc(float (&acc)[kNT][4]) {
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}

// One run of depth steps [k_lo, k_hi) of kProd (1 or 2) products at once:
// acc[p] += A_p B_p for p < kProd (see warp_mma_nt). The instructions of a
// step are issued phase by phase across kGroup column tiles of every
// product, so that two instructions on one accumulator are kProd * kGroup
// apart: mma.sync's result comes back after some 30 cycles, and a warp with
// fewer independent accumulators in flight than that waits on itself.
template <typename T, int kNT, int kProd, int kGroup>
__device__ __forceinline__ void warp_mma_nt_run(
    float (*(&acc)[kProd])[4], const T* (&a_tile)[kProd], int a_r0,
    const T* (&b_tile)[kProd], int stride, int lane, int k_lo, int k_hi) {
  using M = Mma<T>;
  static_assert(kNT % kGroup == 0 && kGroup % 2 == 0, "column tiles");
#pragma unroll
  for (int k0 = k_lo; k0 < k_hi; k0 += M::kK) {
    typename M::FragA a[kProd];
#pragma unroll
    for (int p = 0; p < kProd; ++p)
      M::load_a(a[p], a_tile[p], stride, a_r0, k0, lane);
#pragma unroll
    for (int j0 = 0; j0 < kNT; j0 += kGroup) {
      typename M::FragB b[kProd][kGroup];
#pragma unroll
      for (int p = 0; p < kProd; ++p)
#pragma unroll
        for (int j = 0; j < kGroup; j += 2)
          M::load_b_nt(b[p][j], b[p][j + 1], b_tile[p], stride, 8 * (j0 + j),
                       k0, lane);
#pragma unroll
      for (int ph = 0; ph < M::kPhases; ++ph)
#pragma unroll
        for (int p = 0; p < kProd; ++p)
#pragma unroll
          for (int j = 0; j < kGroup; ++j)
            M::mma_phase(acc[p][j0 + j], a[p], b[p][j], ph);
    }
  }
}

// acc[p] (16 x 8 kNT) = A_p B_p for p < kProd, with A_p rows [a_r0, a_r0 +
// 16) of a_tile[p] and B_p[k][n] = b_tile[p][n][k], over the depth [0,
// kDepth).
// For float32 inputs the depth is cut into runs of 64, each chained on the
// tensor core from zero and added by a round-to-nearest add on the CUDA
// cores: the tensor core adds into its accumulator with truncation, and
// over D = 256 (96 chained instructions) the scores drifted by 1e-5 after
// scaling, which the exponential passes on to every gradient.
template <typename T, int kNT, int kDepth, int kProd, int kGroup>
__device__ __forceinline__ void warp_mma_nt(
    float (*(&acc)[kProd])[4], const T* (&a_tile)[kProd], int a_r0,
    const T* (&b_tile)[kProd], int stride, int lane) {
  constexpr int kRun = (sizeof(T) == 4 && kDepth > 64) ? 64 : kDepth;
#pragma unroll
  for (int p = 0; p < kProd; ++p)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[p][j][e] = 0.f;
  warp_mma_nt_run<T, kNT, kProd, kGroup>(acc, a_tile, a_r0, b_tile, stride,
                                         lane, 0, kRun);
#pragma unroll
  for (int k0 = kRun; k0 < kDepth; k0 += kRun) {
    float part[kProd][kNT][4];
    float (*parts[kProd])[4];
#pragma unroll
    for (int p = 0; p < kProd; ++p) {
      zero_acc(part[p]);
      parts[p] = part[p];
    }
    warp_mma_nt_run<T, kNT, kProd, kGroup>(parts, a_tile, a_r0, b_tile,
                                           stride, lane, k0, k0 + kRun);
#pragma unroll
    for (int p = 0; p < kProd; ++p)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[p][j][e] += part[p][j][e];
  }
}

// One product, and two side by side (the backward's S and dP, whose
// accumulators live together anyway).
template <typename T, int kNT, int kDepth, int kGroupMax>
__device__ __forceinline__ void warp_mma_nt1(float (&acc)[kNT][4],
                                             const T* a_tile, int a_r0,
                                             const T* b_tile, int stride,
                                             int lane) {
  float (*accs[1])[4] = {acc};
  const T* as[1] = {a_tile};
  const T* bs[1] = {b_tile};
  warp_mma_nt<T, kNT, kDepth, 1, (kNT < kGroupMax ? kNT : kGroupMax)>(
      accs, as, a_r0, bs, stride, lane);
}
template <typename T, int kNT, int kDepth, int kGroupMax>
__device__ __forceinline__ void warp_mma_nt2(float (&acc0)[kNT][4],
                                             float (&acc1)[kNT][4],
                                             const T* a0_tile,
                                             const T* a1_tile, int a_r0,
                                             const T* b0_tile,
                                             const T* b1_tile, int stride,
                                             int lane) {
  float (*accs[2])[4] = {acc0, acc1};
  const T* as[2] = {a0_tile, a1_tile};
  const T* bs[2] = {b0_tile, b1_tile};
  warp_mma_nt<T, kNT, kDepth, 2, (kNT < kGroupMax ? kNT : kGroupMax)>(
      accs, as, a_r0, bs, stride, lane);
}

// acc (16 x 8 kNT) = acc * mul + P B, with P the accumulators p (16 x 8 kKT)
// of a first product, handed over in the operand type, B[k][n] =
// b_tile[k][b_n0 + n] for k in [0, 8 kKT), and mul this lane's two rows'
// factors (taken as 1 unless kScale).
// The tensor core adds into its accumulator with truncation, and a chain of
// T/8 such additions drifts by about one float32 ulp of the sum each
// (measured: dV 7e-5 off at T 2048 against 2e-5 allowed). So for float32
// inputs the product is chained from zero over a few depth steps at a time
// (kAtOnceMax: only their A fragments are live) and added to acc by a
// round-to-nearest add on the CUDA cores; the forward's rescaling rides on
// the first such add as an fmaf. kGroup column tiles are chained at once,
// phase by phase, for the reason given at warp_mma_nt_run. For bf16 inputs
// the chain runs on acc itself, all kNT column tiles side by side.
template <typename T, int kNT, int kKT, bool kScale, int kAtOnceMax,
          int kGroupMax>
__device__ __forceinline__ void warp_mma_acc_t(float (&acc)[kNT][4],
                                               const float (&p)[kKT][4],
                                               const float (&mul)[2],
                                               const T* b_tile, int b_n0,
                                               int stride, int lane) {
  using M = Mma<T>;
  constexpr int kPer = M::kK / 8;   // accumulator tiles per depth step
  constexpr int kSteps = kKT / kPer;
  static_assert(kNT % 2 == 0 && kKT % kPer == 0, "tile counts");
  if constexpr (sizeof(T) == 4) {
    constexpr int kGroup = kNT < kGroupMax ? kNT : kGroupMax;
    constexpr int kAtOnce = kSteps < kAtOnceMax ? kSteps : kAtOnceMax;
    static_assert(kSteps % kAtOnce == 0 && kNT % kGroup == 0 &&
                      kGroup % 2 == 0,
                  "depth steps and column tiles");
#pragma unroll
    for (int j0 = 0; j0 < kSteps; j0 += kAtOnce) {
      typename M::FragA a[kAtOnce];
#pragma unroll
      for (int j = 0; j < kAtOnce; ++j) M::acc_to_a(a[j], &p[(j0 + j) * kPer]);
#pragma unroll
      for (int n0 = 0; n0 < kNT; n0 += kGroup) {
        float fresh[kGroup][4];
        zero_acc(fresh);
#pragma unroll
        for (int j = 0; j < kAtOnce; ++j) {
          typename M::FragB b[kGroup];
#pragma unroll
          for (int n = 0; n < kGroup; n += 2)
            M::load_b_t(b[n], b[n + 1], b_tile, stride, (j0 + j) * M::kK,
                        b_n0 + 8 * (n0 + n), lane);
#pragma unroll
          for (int ph = 0; ph < M::kPhases; ++ph)
#pragma unroll
            for (int n = 0; n < kGroup; ++n)
              M::mma_phase(fresh[n], a[j], b[n], ph);
        }
#pragma unroll
        for (int n = 0; n < kGroup; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[n0 + n][e] = (kScale && j0 == 0)
                                 ? __fmaf_rn(acc[n0 + n][e], mul[e >> 1],
                                             fresh[n][e])
                                 : acc[n0 + n][e] + fresh[n][e];
      }
    }
  } else {
    if (kScale) {
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] *= mul[e >> 1];
    }
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      typename M::FragA a;
      M::acc_to_a(a, &p[j * kPer]);
#pragma unroll
      for (int n = 0; n < kNT; n += 2) {
        typename M::FragB b0, b1;
        M::load_b_t(b0, b1, b_tile, stride, j * M::kK, b_n0 + 8 * n, lane);
        M::mma(acc[n], a, b0);
        M::mma(acc[n + 1], a, b1);
      }
    }
  }
}

// ------------------------------------------------------- online softmax --

// One key tile of the online softmax on a warp's score accumulators s
// (16 rows x 8 kNT columns; this lane's rows are row0 and row0 + 8, its
// columns col0 + 8 j and + 1). In: raw dot products; out: P, not yet
// normalised. m is the running row max in log2 units, l this lane's share
// of the running row sum (summed over the quad at the end), corr the factor
// by which the caller rescales its output accumulator. c2 = scale * log2(e).
template <int kNT>
__device__ __forceinline__ void softmax_step(float (&s)[kNT][4],
                                             float (&m)[2], float (&l)[2],
                                             float (&corr)[2], float c2,
                                             bool masked, int row0, int col0,
                                             int t_len, int causal,
                                             int strict) {
  float mx[2] = {kNegBig, kNegBig};
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float v = s[j][e] * c2;
      if (masked && !attends(row0 + 8 * (e >> 1), col0 + 8 * j + (e & 1),
                             t_len, causal, strict))
        v = kNegBig;
      s[j][e] = v;
      mx[e >> 1] = fmaxf(mx[e >> 1], v);
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    corr[r] = exp2_fast(m[r] - m_new);
    m[r] = m_new;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float v = s[j][e];
      // rebase, then re-mask: exp2(NEG_BIG - NEG_BIG) would be 1
      float p = exp2_fast(v - m[e >> 1]);
      if (masked && v <= kNegBig) p = 0.f;
      s[j][e] = p;
      sum[e >> 1] += p;
    }
  l[0] = l[0] * corr[0] + sum[0];
  l[1] = l[1] * corr[1] + sum[1];
}

// P and dS of the backward from a warp's score and dP accumulators, for
// entries whose row statistics lie along the fragment's ROWS (the dQ
// kernel: rows are queries). In: s raw dot products, dp = dO V^T; out: s = P
// = exp2(s c2 - lse2) (0 where masked), dp = dS = P (dp - delta).
// lse2 = lse * log2(e) and delta are this lane's two rows' values.
template <int kNT>
__device__ __forceinline__ void probs_rows(float (&s)[kNT][4],
                                           float (&dp)[kNT][4],
                                           const float (&lse2)[2],
                                           const float (&delta)[2], float c2,
                                           bool masked, int row0, int col0,
                                           int t_len, int causal,
                                           int strict) {
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      float p = exp2_fast(s[j][e] * c2 - lse2[r]);
      if (masked && !attends(row0 + 8 * r, col0 + 8 * j + (e & 1), t_len,
                             causal, strict))
        p = 0.f;
      s[j][e] = p;
      dp[j][e] = p * (dp[j][e] - delta[r]);
    }
}

// The same for the transposed tile of the dK/dV kernel: fragment rows are
// keys, fragment columns are queries, so the statistics are read per
// column from shared memory (lse_s, delta_s: this tile's query rows).
template <int kNT>
__device__ __forceinline__ void probs_cols(float (&s)[kNT][4],
                                           float (&dp)[kNT][4],
                                           const float* lse_s,
                                           const float* delta_s, float c2,
                                           bool masked, int key0, int q0,
                                           int lane, int t_len, int causal,
                                           int strict) {
  const int c_lane = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    const float2 ls = *reinterpret_cast<const float2*>(lse_s + 8 * j + c_lane);
    const float2 dl =
        *reinterpret_cast<const float2*>(delta_s + 8 * j + c_lane);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = e & 1;
      float p = exp2_fast(s[j][e] * c2 - (c ? ls.y : ls.x) * kLog2e);
      if (masked && !attends(q0 + 8 * j + c_lane + c, key0 + 8 * (e >> 1),
                             t_len, causal, strict))
        p = 0.f;
      s[j][e] = p;
      dp[j][e] = p * (dp[j][e] - (c ? dl.y : dl.x));
    }
  }
}

// --------------------------------------------------------------- stores --

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// A warp's accumulator tile (16 rows x 8 kNT columns, times mul) into a
// contiguous [B, T, H, d] output: this lane's rows are row0 and row0 + 8 of
// head (b, h), output columns c0 + 8 j + 2t and + 1. Pairs go out as one
// store where d is even (the pair is then aligned).
template <typename T, int kNT>
__device__ __forceinline__ void store_acc(T* __restrict__ out,
                                          const float (&acc)[kNT][4],
                                          const float (&mul)[2], int b, int h,
                                          int n_heads, int t_len, int d,
                                          int row0, int c0, int lane) {
  const bool pairs = (d & 1) == 0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= t_len) continue;
    T* orow =
        out + ((static_cast<int64_t>(b) * t_len + row) * n_heads + h) * d;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int c = c0 + 8 * j + 2 * (lane & 3);
      const float x = acc[j][2 * r] * mul[r], y = acc[j][2 * r + 1] * mul[r];
      if (pairs) {
        if (c < d) store2(orow + c, x, y);
      } else {
        if (c < d) store1(orow + c, x);
        if (c + 1 < d) store1(orow + c + 1, y);
      }
    }
  }
}

}  // namespace slt_flash
