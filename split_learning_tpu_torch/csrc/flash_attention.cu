// Flash-attention forward (online softmax, O and the row log-sum-exp) for
// Hopper (sm_90a).
//
// Replaces the Pallas kernel of split_learning_tpu/ops/flash_attention.py:
//   _fwd_kernel (:391, pallas_call at :657), reached through
//   flash_attention (:759) and flash_attention_with_lse (:780).
//
// What bounds it on this card: operations. Per (batch, head) the work is
// 4*T*T*D FLOPs (half of it under the causal mask) against 4*T*D values
// moved, so at the serving path's prefill (B 8, T 1024, H 2, D 128) it does
// about 500 operations per byte, above the H100's ridge in float32 and in
// bf16. This first version computes in float32 on the CUDA cores (67
// TFLOP/s peak); wgmma with bf16 operands, TMA loads and warp
// specialisation are later work.
//
// Design, against the TPU version:
// - The TPU kernel runs a sequential (bh, q block, k block) grid and carries
//   m, l and the accumulator in VMEM scratch from one k step to the next.
//   Blocks on this card run in parallel and in no order, so one thread
//   block owns one (64-row query tile, b*h) pair and loops over the key
//   tiles itself, with m, l and the accumulator in registers.
// - Q (once) and each K and V tile are staged in shared memory as float32
//   (bf16 is converted on load), rows padded by one float so that the
//   column walks hit 32 different banks. K and V of a tile share one buffer:
//   V is loaded after the scores are done with K. At D = 128 a block takes
//   81 KB, so two blocks fit on an SM.
// - 256 threads as a 16 x 16 grid: thread (ty, tx) owns query rows
//   ty + 16i (i < 4), score columns tx + 16j (j < 4) and output columns
//   tx + 16j (j < D/16). The 16 threads of a row group are 16 lanes of one
//   warp, so row max and row sum are four shuffles.
// - Causal: the key loop stops at the query tile's diagonal tile (the TPU
//   kernel's pl.when(kb_i <= qb_i) skip), and the elementwise mask is built
//   only on the diagonal tile and the ragged last tile. Tiles are issued
//   heaviest first so that the causal tail does not idle the card.
// - Q, K and V are read through their [B, T, H, D] strides, so the
//   [B, T, H, D] -> [B*H, T, D] transposes of the JAX wrapper cost no copy.
// - Products are written as __fmaf_rn: the library builds with
//   --fmad=false (the SGD kernel's rounding), which would otherwise split
//   every multiply-add in two.
//
// Math, as _scores / _fwd_kernel: s = (q . k) * D^-0.5 in float32; masked
// entries are NEG_BIG before the max and 0 after the exp (ragged tail
// col >= T; causal row >= col; strict row > col); m, l, acc carried in
// float32; o = acc / l in the input dtype; lse = m + log l in float32. A row
// with no unmasked key (l == 0) gives o = 0 and lse = NEG_BIG.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;                // query rows per block = keys per tile
constexpr int kThreads = 256;            // 16 x 16
constexpr int kPer = kTile / 16;         // rows (and score columns) per thread
constexpr int kPStride = kTile + 1;      // padded row of the P tile
constexpr float kNegBig = -1e30f;        // ops/common.py NEG_BIG
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Reductions over the 16 lanes of a row group (they differ in bits 0-3).
__device__ __forceinline__ float group_max(float v) {
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}
__device__ __forceinline__ float group_sum(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Rows [t0, t0 + 64) of one head's [T, D] view (row stride s_t, column
// stride 1) into dst[64][kD + 1] as float32; rows >= T and columns >= d are
// zero, so they add nothing to a dot product.
template <typename T, int kD>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int64_t s_t, int t0, int t_len,
                                          int d) {
  for (int e = threadIdx.x; e < kTile * kD; e += kThreads) {
    const int r = e / kD;
    const int c = e - r * kD;
    const int t = t0 + r;
    float v = 0.f;
    if (t < t_len && c < d) v = to_f32(src[static_cast<int64_t>(t) * s_t + c]);
    dst[r * (kD + 1) + c] = v;
  }
}

template <typename T, int kD>
__global__ void __launch_bounds__(kThreads, kD <= 128 ? 2 : 1)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int n_heads, int t_len, int d,
                 float scale, int64_t q_sb, int64_t q_st, int64_t q_sh,
                 int64_t k_sb, int64_t k_st, int64_t k_sh, int64_t v_sb,
                 int64_t v_st, int64_t v_sh, int causal, int strict) {
  constexpr int kStride = kD + 1;
  constexpr int kDPer = kD / 16;         // output columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;                     // [64][kStride]
  float* kv_s = q_s + kTile * kStride;   // [64][kStride]: K, then V
  float* p_s = kv_s + kTile * kStride;   // [64][kPStride]

  const int bh = blockIdx.x;
  const int b = bh / n_heads;
  const int h = bh - b * n_heads;
  const int qt = gridDim.y - 1 - blockIdx.y;  // heaviest causal tiles first
  const int q0 = qt * kTile;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;
  load_tile<T, kD>(q_s, qb, q_st, q0, t_len, d);

  float m[kPer], l[kPer], acc[kPer][kDPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    m[i] = kNegBig;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kDPer; ++j) acc[i][j] = 0.f;
  }

  const int n_kt_all = (t_len + kTile - 1) / kTile;
  const int n_kt = causal ? min(n_kt_all, qt + 1) : n_kt_all;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the last tile's P.V reads of kv_s are done
    load_tile<T, kD>(kv_s, kb, k_st, k0, t_len, d);
    __syncthreads();

    float s[kPer][kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < d; ++c) {
      float qv[kPer], kv[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) qv[i] = q_s[(ty + 16 * i) * kStride + c];
#pragma unroll
      for (int j = 0; j < kPer; ++j) kv[j] = kv_s[(tx + 16 * j) * kStride + c];
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int j = 0; j < kPer; ++j) s[i][j] = __fmaf_rn(qv[i], kv[j], s[i][j]);
    }

    // scale, mask (diagonal and ragged tiles only), online softmax
    const bool masked_tile = (k0 + kTile > t_len) || (causal && kt == qt);
    unsigned ok_bits = 0xffffu;  // bit i * kPer + j: entry (i, j) is live
    if (masked_tile) {
      ok_bits = 0;
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const int row = q0 + ty + 16 * i;
          const int col = k0 + tx + 16 * j;
          bool ok = col < t_len;
          if (causal) ok = ok && (strict ? row > col : row >= col);
          if (ok) ok_bits |= 1u << (i * kPer + j);
        }
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      float mx = kNegBig;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const bool ok = (ok_bits >> (i * kPer + j)) & 1u;
        s[i][j] = ok ? s[i][j] * scale : kNegBig;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(mx));
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const bool ok = (ok_bits >> (i * kPer + j)) & 1u;
        // rebase, then re-mask: exp(NEG_BIG - NEG_BIG) would be 1
        const float p = ok ? expf(s[i][j] - m_new) : 0.f;
        p_s[(ty + 16 * i) * kPStride + tx + 16 * j] = p;
        rs += p;
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + group_sum(rs);
#pragma unroll
      for (int j = 0; j < kDPer; ++j) acc[i][j] *= corr;
      m[i] = m_new;
    }
    __syncthreads();  // P is written; every read of K is done
    load_tile<T, kD>(kv_s, vb, v_st, k0, t_len, d);
    __syncthreads();

    const int n_c = min(kTile, t_len - k0);
#pragma unroll 4
    for (int c = 0; c < n_c; ++c) {
      float pv[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) pv[i] = p_s[(ty + 16 * i) * kPStride + c];
#pragma unroll
      for (int j = 0; j < kDPer; ++j) {
        const float vv = kv_s[c * kStride + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < kPer; ++i) acc[i][j] = __fmaf_rn(pv[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= t_len) continue;
    const bool live = l[i] > 0.f;
    const float l_safe = live ? l[i] : 1.f;
    const int64_t at = (static_cast<int64_t>(b) * t_len + row) * n_heads + h;
    T* orow = o + at * d;
#pragma unroll
    for (int j = 0; j < kDPer; ++j) {
      const int c = tx + 16 * j;
      if (c < d) store(orow + c, acc[i][j] / l_safe);
    }
    if (tx == 0) lse[at] = live ? m[i] + logf(l_safe) : kNegBig;
  }
}

template <int kD>
constexpr size_t smem_bytes() {
  return (2 * kTile * (kD + 1) + kTile * kPStride) * sizeof(float);
}

template <typename T, int kD>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int b, int t, int h, int d, float scale, const int64_t* st,
           int causal, int strict, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, kD>;
  constexpr size_t smem = smem_bytes<kD>();
  // above 48 KB the launch is refused unless the kernel opts in
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(b * h, (t + kTile - 1) / kTile);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, h, t, d,
      scale, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8], causal, strict);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, float* lse,
             int b, int t, int h, int d, float scale, const int64_t* st,
             int causal, int strict, cudaStream_t stream) {
  if (d <= 32)
    return launch<T, 32>(q, k, v, o, lse, b, t, h, d, scale, st, causal, strict,
                         stream);
  if (d <= 64)
    return launch<T, 64>(q, k, v, o, lse, b, t, h, d, scale, st, causal, strict,
                         stream);
  if (d <= 128)
    return launch<T, 128>(q, k, v, o, lse, b, t, h, d, scale, st, causal, strict,
                          stream);
  return launch<T, 256>(q, k, v, o, lse, b, t, h, d, scale, st, causal, strict,
                        stream);
}

}  // namespace

extern "C" {

// q, k, v: [b, t, h, d] views (float32 if is_bf16 == 0, else bfloat16) with
// unit stride along d; strides[9] holds their (batch, time, head) strides in
// elements, q's then k's then v's. o: contiguous [b, t, h, d] in the input
// dtype; lse: contiguous [b, t, h] float32; scale is D^-0.5 rounded to
// float32, as JAX multiplies it. 1 <= d <= 256, t >= 1,
// b * h >= 1. Returns cudaGetLastError() after the launch.
int slt_flash_fwd(const void* q, const void* k, const void* v, void* o,
                  float* lse, int b, int t, int h, int d, float scale,
                  const int64_t* strides, int causal, int strict, int is_bf16,
                  cudaStream_t stream) {
  if (b < 1 || t < 1 || h < 1 || d < 1 || d > 256 ||
      (t + kTile - 1) / kTile > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (is_bf16)
    return dispatch<__nv_bfloat16>(q, k, v, o, lse, b, t, h, d, scale,
                                   strides, causal, strict, stream);
  return dispatch<float>(q, k, v, o, lse, b, t, h, d, scale, strides, causal,
                         strict, stream);
}

}  // extern "C"
