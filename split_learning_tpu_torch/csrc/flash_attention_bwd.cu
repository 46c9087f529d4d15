// Flash-attention backward (dQ, dK, dV from Q, K, V, O, the row log-sum-exp,
// dO and the LSE cotangent) for Hopper (sm_90a).
//
// Replaces the Pallas kernels of split_learning_tpu/ops/flash_attention.py
// reached from _make_flash.vjp_bwd (:693): the one-pass _onepass_bwd_kernel
// (:443, pallas_call at :604 via _onepass_call) and the two-kernel split
// _dq_kernel (:503) + _dkv_kernel (:542) (pallas_call at :725, :737). Both
// forms give the same gradients; the choice between them exists for VMEM
// residency on the TPU and is not carried over.
//
// What bounds it on this card: operations. Per (batch, head) the useful work
// is 10*T*T*D FLOPs (five T x T x D products: S, dP, dV, dK, dQ; half of it
// under the causal mask) against about 9*T*D values moved. At the training
// path's shape (B 64, T 1024, H 2, D 128, causal) that is about 1,100
// operations per byte, above the H100's ridge in float32 and in bf16. This
// first version computes in float32 on the CUDA cores (67 TFLOP/s peak);
// wgmma with bf16 operands, TMA loads and an atomic-dQ single pass are later
// work.
//
// Design, against the TPU version: three launches per call, no atomics, so
// every gradient is bit-reproducible from run to run.
// - Delta pass: delta[b, t, h] = sum_d dO * O - g_lse in float32, one warp
//   per row (vjp_bwd's delta, :700-708: the LSE cotangent folds in with a
//   minus sign because d lse / d s = P).
// - dK/dV: one block per (64-key tile, b*h), the TPU's (bh, k block) grid
//   with its q loop inside the block (the one-pass kernel's fori_loop), from
//   the causal start (q tile = k tile) to the end. K and V stay in shared
//   memory; each q tile brings Q, dO, its LSE and delta rows. Per tile:
//   S^T = K Q^T, P^T = exp(S^T * scale - lse) masked to 0, dP^T = V dO^T,
//   dV += P^T dO, dS^T = P^T (dP^T - delta), dK += dS^T Q. At the end
//   dK * scale and dV are written in the input dtype.
// - dQ: one block per (64-query tile, b*h), looping over key tiles up to the
//   diagonal as the forward does: dP = dO V^T, S = Q K^T, dS as above,
//   dQ += dS K; then dQ * scale.
//   This is the split form's 14*T*T*D of work against the one-pass form's 10;
//   in exchange dQ needs no cross-block sum.
// - Thread layout, 256 threads as 16 x 16 as in the forward. In dK/dV thread
//   (ty, tx) owns key rows ty + 16i and query columns tx + 16j of the score
//   tile (so S^T, P^T and dS^T stay in its registers), and output columns
//   tx + 16j of dK and dV. The two reductions over queries (P^T dO, dS^T Q)
//   go through the P^T / dS^T tile in shared memory, read along its rows.
//   In dQ the roles of queries and keys swap.
// - Shared memory: tiles staged as float32 (bf16 is converted on load), rows
//   padded by one float so that column walks hit 32 banks. At D = 128 the
//   dK/dV block holds K, V, Q, dO and the 64 x 64 P tile, 146 KB; at
//   D = 256 Q and dO share one buffer (Q is loaded again for dS^T Q), 210 KB;
//   dQ holds Q, dO and one buffer that takes V and then K, 114 KB at
//   D = 128, 210 KB at D = 256. All of them opt in above 48 KB.
// - Q, K, V, O and dO are read through their [B, T, H, D] strides (dO from
//   autograd may be a non-contiguous view); outputs are contiguous.
// - Masks, as _scores: ragged tail (row or col >= T), causal row >= col,
//   strict row > col. Masked entries are zero after the exp, never
//   exp(s - NEG_BIG); a row with lse = NEG_BIG has no unmasked entry, so it
//   gets dQ = 0 and adds nothing to dK, dV.
// - Products are written as __fmaf_rn: the library builds with --fmad=false.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;          // rows per tile, queries and keys alike
constexpr int kThreads = 256;      // 16 x 16
constexpr int kPer = kTile / 16;   // score rows (and columns) per thread
constexpr int kPStride = kTile + 1;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

struct Strides {   // (batch, time, head) strides in elements
  int64_t b, t, h;
};

// Rows [t0, t0 + 64) of one head's [T, D] view (row stride s_t, column
// stride 1) into dst[64][kD + 1] as float32; rows >= T and columns >= d are
// zero, so they add nothing to a product.
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

// LSE and delta of rows [t0, t0 + 64) of head (b, h); 0 past the end (those
// rows are masked).
__device__ __forceinline__ void load_rows(float* lse_s, float* delta_s,
                                          const float* __restrict__ lse,
                                          const float* __restrict__ delta,
                                          int b, int h, int n_heads, int t0,
                                          int t_len) {
  if (threadIdx.x < kTile) {
    const int row = t0 + threadIdx.x;
    const int64_t at = (static_cast<int64_t>(b) * t_len + row) * n_heads + h;
    lse_s[threadIdx.x] = row < t_len ? lse[at] : 0.f;
    delta_s[threadIdx.x] = row < t_len ? delta[at] : 0.f;
  }
}

__device__ __forceinline__ bool live(int row, int col, int t_len, int causal,
                                     int strict) {
  bool ok = row < t_len && col < t_len;
  if (causal) ok = ok && (strict ? row > col : row >= col);
  return ok;
}

// ---------------------------------------------------------------- delta --

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       const float* __restrict__ g_lse,
                       float* __restrict__ delta, int64_t n_rows, int t_len,
                       int n_heads, int d, Strides so, Strides sd) {
  const int64_t row =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;   // the whole warp leaves together
  const int h = static_cast<int>(row % n_heads);
  const int64_t bt = row / n_heads;
  const int t = static_cast<int>(bt % t_len);
  const int64_t b = bt / t_len;
  const T* orow = o + b * so.b + t * so.t + h * so.h;
  const T* drow = dout + b * sd.b + t * sd.t + h * sd.h;
  float acc = 0.f;
  for (int c = lane; c < d; c += 32)
    acc = __fmaf_rn(to_f32(drow[c]), to_f32(orow[c]), acc);
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(kFull, acc, off);
  if (lane == 0) delta[row] = g_lse ? acc - g_lse[row] : acc;
}

// ----------------------------------------------------------------- dK/dV --

// above D = 128, Q and dO share one buffer in the dK/dV kernel
__host__ __device__ constexpr bool reload_q(int d_max) { return d_max > 128; }

template <int kD>
constexpr size_t dkv_smem_bytes() {
  return ((reload_q(kD) ? 3 : 4) * kTile * (kD + 1) + kTile * kPStride +
          2 * kTile) * sizeof(float);
}

template <typename T, int kD>
__global__ void __launch_bounds__(kThreads, kD <= 64 ? 2 : 1)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int n_heads, int t_len, int d,
                     float scale, Strides sq, Strides sk, Strides sv,
                     Strides sd, int causal, int strict) {
  constexpr int kStride = kD + 1;
  constexpr int kDPer = kD / 16;          // output columns per thread
  constexpr bool kReload = reload_q(kD);
  extern __shared__ float smem[];
  float* k_s = smem;                                 // [64][kStride]
  float* v_s = k_s + kTile * kStride;                // [64][kStride]
  float* q_s = v_s + kTile * kStride;                // [64][kStride]
  float* do_s = kReload ? q_s : q_s + kTile * kStride;
  float* p_s = do_s + kTile * kStride;               // [64 keys][kPStride]
  float* lse_s = p_s + kTile * kPStride;             // [64]
  float* delta_s = lse_s + kTile;                    // [64]

  const int bh = blockIdx.x;
  const int b = bh / n_heads;
  const int h = bh - b * n_heads;
  const int kt = blockIdx.y;          // causal: key tile 0 has the most work
  const int k0 = kt * kTile;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  const T* dob = dout + b * sd.b + h * sd.h;
  load_tile<T, kD>(k_s, kb, sk.t, k0, t_len, d);
  load_tile<T, kD>(v_s, vb, sv.t, k0, t_len, d);

  float dk_acc[kPer][kDPer], dv_acc[kPer][kDPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int j = 0; j < kDPer; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  const int n_qt = (t_len + kTile - 1) / kTile;
  for (int qt = causal ? kt : 0; qt < n_qt; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();   // the last tile's reads of q_s, do_s and p_s are done
    load_tile<T, kD>(q_s, qb, sq.t, q0, t_len, d);
    if (!kReload) load_tile<T, kD>(do_s, dob, sd.t, q0, t_len, d);
    load_rows(lse_s, delta_s, lse, delta, b, h, n_heads, q0, t_len);
    __syncthreads();

    // P^T: keys ty + 16i against queries tx + 16j, masked to 0 after the exp
    float p[kPer][kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j) p[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < d; ++c) {
      float kv[kPer], qv[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) kv[i] = k_s[(ty + 16 * i) * kStride + c];
#pragma unroll
      for (int j = 0; j < kPer; ++j) qv[j] = q_s[(tx + 16 * j) * kStride + c];
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int j = 0; j < kPer; ++j) p[i][j] = __fmaf_rn(kv[i], qv[j], p[i][j]);
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int key = k0 + ty + 16 * i;
        const int row = q0 + tx + 16 * j;
        p[i][j] = live(row, key, t_len, causal, strict)
                      ? expf(p[i][j] * scale - lse_s[tx + 16 * j])
                      : 0.f;
      }

    if (kReload) {
      __syncthreads();   // every read of Q is done: dO takes its buffer
      load_tile<T, kD>(do_s, dob, sd.t, q0, t_len, d);
      __syncthreads();
    }
    // dP^T = V dO^T, same layout as P^T
    float dp[kPer][kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j) dp[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < d; ++c) {
      float vv[kPer], dov[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) vv[i] = v_s[(ty + 16 * i) * kStride + c];
#pragma unroll
      for (int j = 0; j < kPer; ++j) dov[j] = do_s[(tx + 16 * j) * kStride + c];
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int j = 0; j < kPer; ++j)
          dp[i][j] = __fmaf_rn(vv[i], dov[j], dp[i][j]);
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j)
        p_s[(ty + 16 * i) * kPStride + tx + 16 * j] = p[i][j];
    __syncthreads();

    // dV += P^T dO over the tile's live queries
    const int n_q = min(kTile, t_len - q0);
#pragma unroll 4
    for (int r = 0; r < n_q; ++r) {
      float pv[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) pv[i] = p_s[(ty + 16 * i) * kPStride + r];
#pragma unroll
      for (int j = 0; j < kDPer; ++j) {
        const float x = do_s[r * kStride + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < kPer; ++i) dv_acc[i][j] = __fmaf_rn(pv[i], x, dv_acc[i][j]);
      }
    }
    __syncthreads();   // every read of P^T and of dO is done

    // dS^T = P^T (dP^T - delta); dK += dS^T Q
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j)
        p_s[(ty + 16 * i) * kPStride + tx + 16 * j] =
            p[i][j] * (dp[i][j] - delta_s[tx + 16 * j]);
    if (kReload) load_tile<T, kD>(q_s, qb, sq.t, q0, t_len, d);
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < n_q; ++r) {
      float sv_[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) sv_[i] = p_s[(ty + 16 * i) * kPStride + r];
#pragma unroll
      for (int j = 0; j < kDPer; ++j) {
        const float x = q_s[r * kStride + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < kPer; ++i) dk_acc[i][j] = __fmaf_rn(sv_[i], x, dk_acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= t_len) continue;
    const int64_t at = (static_cast<int64_t>(b) * t_len + key) * n_heads + h;
#pragma unroll
    for (int j = 0; j < kDPer; ++j) {
      const int c = tx + 16 * j;
      if (c < d) {
        store(dk + at * d + c, dk_acc[i][j] * scale);
        store(dv + at * d + c, dv_acc[i][j]);
      }
    }
  }
}

// -------------------------------------------------------------------- dQ --

template <int kD>
constexpr size_t dq_smem_bytes() {
  return (3 * kTile * (kD + 1) + kTile * kPStride + 2 * kTile) * sizeof(float);
}

template <typename T, int kD>
__global__ void __launch_bounds__(kThreads, kD <= 64 ? 2 : 1)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int n_heads, int t_len, int d, float scale, Strides sq,
                    Strides sk, Strides sv, Strides sd, int causal,
                    int strict) {
  constexpr int kStride = kD + 1;
  constexpr int kDPer = kD / 16;
  extern __shared__ float smem[];
  float* q_s = smem;                       // [64][kStride]
  float* do_s = q_s + kTile * kStride;     // [64][kStride]
  float* kv_s = do_s + kTile * kStride;    // [64][kStride]: V, then K
  float* ds_s = kv_s + kTile * kStride;    // [64 queries][kPStride]
  float* lse_s = ds_s + kTile * kPStride;  // [64]
  float* delta_s = lse_s + kTile;          // [64]

  const int bh = blockIdx.x;
  const int b = bh / n_heads;
  const int h = bh - b * n_heads;
  const int qt = gridDim.y - 1 - blockIdx.y;  // heaviest causal tiles first
  const int q0 = qt * kTile;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  const T* dob = dout + b * sd.b + h * sd.h;
  load_tile<T, kD>(q_s, qb, sq.t, q0, t_len, d);
  load_tile<T, kD>(do_s, dob, sd.t, q0, t_len, d);
  load_rows(lse_s, delta_s, lse, delta, b, h, n_heads, q0, t_len);

  float dq_acc[kPer][kDPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int j = 0; j < kDPer; ++j) dq_acc[i][j] = 0.f;

  const int n_kt_all = (t_len + kTile - 1) / kTile;
  const int n_kt = causal ? min(n_kt_all, qt + 1) : n_kt_all;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();   // the last tile's reads of kv_s (K) and ds_s are done
    load_tile<T, kD>(kv_s, vb, sv.t, k0, t_len, d);
    __syncthreads();

    // dP = dO V^T: queries ty + 16i against keys tx + 16j
    float dp[kPer][kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j) dp[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < d; ++c) {
      float dov[kPer], vv[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) dov[i] = do_s[(ty + 16 * i) * kStride + c];
#pragma unroll
      for (int j = 0; j < kPer; ++j) vv[j] = kv_s[(tx + 16 * j) * kStride + c];
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int j = 0; j < kPer; ++j)
          dp[i][j] = __fmaf_rn(dov[i], vv[j], dp[i][j]);
    }
    __syncthreads();   // every read of V is done: K takes its buffer
    load_tile<T, kD>(kv_s, kb, sk.t, k0, t_len, d);
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
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int row = q0 + ty + 16 * i;
        const int key = k0 + tx + 16 * j;
        const float p = live(row, key, t_len, causal, strict)
                            ? expf(s[i][j] * scale - lse_s[ty + 16 * i])
                            : 0.f;
        ds_s[(ty + 16 * i) * kPStride + tx + 16 * j] =
            p * (dp[i][j] - delta_s[ty + 16 * i]);
      }
    __syncthreads();

    // dQ += dS K over the tile's live keys
    const int n_c = min(kTile, t_len - k0);
#pragma unroll 4
    for (int c = 0; c < n_c; ++c) {
      float dsv[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) dsv[i] = ds_s[(ty + 16 * i) * kPStride + c];
#pragma unroll
      for (int j = 0; j < kDPer; ++j) {
        const float x = kv_s[c * kStride + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < kPer; ++i) dq_acc[i][j] = __fmaf_rn(dsv[i], x, dq_acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= t_len) continue;
    const int64_t at = (static_cast<int64_t>(b) * t_len + row) * n_heads + h;
#pragma unroll
    for (int j = 0; j < kDPer; ++j) {
      const int c = tx + 16 * j;
      if (c < d) store(dq + at * d + c, dq_acc[i][j] * scale);
    }
  }
}

// --------------------------------------------------------------- launches --

Strides strides_at(const int64_t* st, int i) {
  return Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
}

bool bad_shape(int b, int t, int h, int d) {
  return b < 1 || t < 1 || h < 1 || d < 1 || d > 256 ||
         (t + kTile - 1) / kTile > 65535;
}

template <typename T, int kD>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dk, void* dv,
               int b, int t, int h, int d, float scale, const int64_t* st,
               int causal, int strict, cudaStream_t stream) {
  auto kernel = flash_bwd_dkv_kernel<T, kD>;
  constexpr size_t smem = dkv_smem_bytes<kD>();
  // above 48 KB the launch is refused unless the kernel opts in
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(b * h, (t + kTile - 1) / kTile);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), h, t, d, scale,
      strides_at(st, 0), strides_at(st, 1), strides_at(st, 2),
      strides_at(st, 3), causal, strict);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kD>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, int b, int t,
              int h, int d, float scale, const int64_t* st, int causal,
              int strict, cudaStream_t stream) {
  auto kernel = flash_bwd_dq_kernel<T, kD>;
  constexpr size_t smem = dq_smem_bytes<kD>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(b * h, (t + kTile - 1) / kTile);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), h, t, d, scale, strides_at(st, 0),
      strides_at(st, 1), strides_at(st, 2), strides_at(st, 3), causal,
      strict);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_dkv(const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, const float* delta,
                 void* dk, void* dv, int b, int t, int h, int d, float scale,
                 const int64_t* st, int causal, int strict,
                 cudaStream_t stream) {
  if (d <= 32)
    return launch_dkv<T, 32>(q, k, v, dout, lse, delta, dk, dv, b, t, h, d,
                             scale, st, causal, strict, stream);
  if (d <= 64)
    return launch_dkv<T, 64>(q, k, v, dout, lse, delta, dk, dv, b, t, h, d,
                             scale, st, causal, strict, stream);
  if (d <= 128)
    return launch_dkv<T, 128>(q, k, v, dout, lse, delta, dk, dv, b, t, h, d,
                              scale, st, causal, strict, stream);
  return launch_dkv<T, 256>(q, k, v, dout, lse, delta, dk, dv, b, t, h, d,
                            scale, st, causal, strict, stream);
}

template <typename T>
int dispatch_dq(const void* q, const void* k, const void* v, const void* dout,
                const float* lse, const float* delta, void* dq, int b, int t,
                int h, int d, float scale, const int64_t* st, int causal,
                int strict, cudaStream_t stream) {
  if (d <= 32)
    return launch_dq<T, 32>(q, k, v, dout, lse, delta, dq, b, t, h, d, scale,
                            st, causal, strict, stream);
  if (d <= 64)
    return launch_dq<T, 64>(q, k, v, dout, lse, delta, dq, b, t, h, d, scale,
                            st, causal, strict, stream);
  if (d <= 128)
    return launch_dq<T, 128>(q, k, v, dout, lse, delta, dq, b, t, h, d, scale,
                             st, causal, strict, stream);
  return launch_dq<T, 256>(q, k, v, dout, lse, delta, dq, b, t, h, d, scale,
                           st, causal, strict, stream);
}

}  // namespace

extern "C" {

// o, dout: [b, t, h, d] views (float32 if is_bf16 == 0, else bfloat16) with
// unit stride along d; strides[6] holds their (batch, time, head) strides in
// elements, o's then dout's. g_lse: contiguous [b, t, h] float32, or null
// when the LSE has no cotangent. delta: contiguous [b, t, h] float32, written.
int slt_flash_bwd_delta(const void* o, const void* dout, const float* g_lse,
                        float* delta, int b, int t, int h, int d,
                        const int64_t* strides, int is_bf16,
                        cudaStream_t stream) {
  if (bad_shape(b, t, h, d)) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t rows = static_cast<int64_t>(b) * t * h;
  const int64_t blocks = (rows * 32 + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const Strides so = strides_at(strides, 0), sd = strides_at(strides, 1);
  const unsigned grid = static_cast<unsigned>(blocks);
  if (is_bf16)
    flash_bwd_delta_kernel<__nv_bfloat16><<<grid, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(o),
        static_cast<const __nv_bfloat16*>(dout), g_lse, delta, rows, t, h, d,
        so, sd);
  else
    flash_bwd_delta_kernel<float><<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(o), static_cast<const float*>(dout), g_lse,
        delta, rows, t, h, d, so, sd);
  return static_cast<int>(cudaGetLastError());
}

// q, k, v, dout: [b, t, h, d] views in one dtype with unit stride along d;
// strides[12] holds their (batch, time, head) strides, q's, k's, v's, then
// dout's. lse, delta: contiguous [b, t, h] float32 (the forward's LSE and
// slt_flash_bwd_delta's output). dk, dv (and dq below): contiguous
// [b, t, h, d] in the input dtype. scale is D^-0.5 rounded to float32.
// 1 <= d <= 256. Returns cudaGetLastError() after the launch.
int slt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dk, void* dv, int b, int t, int h, int d,
                      float scale, const int64_t* strides, int causal,
                      int strict, int is_bf16, cudaStream_t stream) {
  if (bad_shape(b, t, h, d)) return static_cast<int>(cudaErrorInvalidValue);
  if (is_bf16)
    return dispatch_dkv<__nv_bfloat16>(q, k, v, dout, lse, delta, dk, dv, b,
                                       t, h, d, scale, strides, causal,
                                       strict, stream);
  return dispatch_dkv<float>(q, k, v, dout, lse, delta, dk, dv, b, t, h, d,
                             scale, strides, causal, strict, stream);
}

int slt_flash_bwd_dq(const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* delta,
                     void* dq, int b, int t, int h, int d, float scale,
                     const int64_t* strides, int causal, int strict,
                     int is_bf16, cudaStream_t stream) {
  if (bad_shape(b, t, h, d)) return static_cast<int>(cudaErrorInvalidValue);
  if (is_bf16)
    return dispatch_dq<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, b, t, h,
                                      d, scale, strides, causal, strict,
                                      stream);
  return dispatch_dq<float>(q, k, v, dout, lse, delta, dq, b, t, h, d, scale,
                            strides, causal, strict, stream);
}

}  // extern "C"
