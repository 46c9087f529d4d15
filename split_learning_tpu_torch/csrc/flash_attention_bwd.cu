// Flash-attention backward (dQ, dK, dV from Q, K, V, O, the row log-sum-exp,
// dO and the LSE cotangent) for Hopper (sm_90a), on the tensor cores.
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
// operations per byte, above the H100's ridge. The roof is the tensor
// cores': 989 TFLOP/s with bf16 operands; for float32 inputs 495 TFLOP/s of
// TF32 over the three products of the error-compensated split, 165 TFLOP/s.
// What the kernels reach is about a fifth of that roof: with some 250
// registers a thread an SM holds eight warps, two per scheduler, and the time
// goes to the latency of dependent mma.sync and shared-memory loads, not to
// their rate (PERF.md has the numbers).
//
// Design (the tile machinery is csrc/flash_tiles.cuh): three launches per
// call and no atomics, so every gradient is bit-reproducible from run to
// run; the trainers' twins lean on that. The split form does 14 units of
// T*T*D (S and dP are formed in both passes) where a single pass with an
// atomic dQ does 10; with every product on the tensor cores those four
// extra units cost less than the lost determinism would.
// - Delta pass: delta[b, t, h] = sum_d dO * O - g_lse in float32, one warp
//   per row (vjp_bwd's delta, :700-708: the LSE cotangent folds in with a
//   minus sign because d lse / d s = P). Float32 on the CUDA cores; it moves
//   bytes and is not a product.
// - dK/dV: one block per (key tile, b*h), the TPU's (bh, k block) grid with
//   its q loop inside the block, from the causal start to the end; key tile
//   0, the heaviest, is issued first. A block is four warps and 64 keys
//   (eight warps and 128 keys for float32 at D = 128, the training path:
//   every warp splits the streamed tile's operands for itself, so the tile
//   it streams should be long, and eight warps share one tile's shared
//   memory and copies). K and V stay in shared memory in the input dtype,
//   each warp owning 16 keys. Q and dO tiles with their LSE and delta rows
//   stream through a two-stage cp.async ring (32 queries a tile; 64 for bf16
//   at D <= 64; 16 for float32 at D = 256). Per tile, all on mma.sync: S^T =
//   K Q^T and dP^T = V dO^T in one depth loop (A and B from shared memory, B
//   as stored; side by side so that eight accumulator chains are in flight);
//   P^T = exp2(S^T c - lse) and dS^T = P^T (dP^T - delta) in the accumulator
//   registers; dV += P^T dO and dK += dS^T Q with A from those registers in
//   the operand type (rounded to bf16 for bf16 inputs, as :480, :487, :567,
//   :574) and B by ldmatrix.trans. At the end dK * scale and dV are written
//   in the input dtype. At D = 256 a block accumulates 128 of the output
//   columns (gridDim.z = 2), which keeps dK and dV at 128 registers a
//   thread.
// - dQ: one block per (query tile of 64 rows, or 128 for float32 at D = 128,
//   and b*h), heaviest tile first, Q and dO resident, K and V tiles streaming
//   (64 keys; 32 for bf16 at D = 256 and for float32; 16 for float32 at D =
//   256): S = Q K^T and dP = dO V^T in one depth loop, dS as above, dQ +=
//   dS K (:490, :528); then dQ * scale.
// - Shared memory per block (tiles in the input dtype, 16-byte row pads) and
//   blocks per SM. bf16 D=128: dK/dV 68 KB, dQ 102 KB, two blocks each (about
//   245 registers a thread allow no third). float32 D=128: 198 KB, one block
//   of eight warps, 255 registers in dK/dV (two 16 x 128 accumulators; 60
//   bytes spilled), about 240 in dQ. D=256: bf16 132 KB, float32 195 KB, one
//   block. D<=64: at most 68 KB.
// - Q, K, V, O and dO are read through their [B, T, H, D] strides (dO from
//   autograd may be a non-contiguous view); outputs are contiguous.
// - Masks, as _scores: ragged tail (row or col >= T), causal row >= col,
//   strict row > col, built only on ragged tiles and tiles the diagonal
//   crosses. Masked entries are zero after the exp, never exp(s - NEG_BIG);
//   a row with lse = NEG_BIG has no unmasked entry, so it gets dQ = 0 and
//   adds nothing to dK, dV.

#include "flash_tiles.cuh"

namespace {

using namespace slt_flash;

constexpr int kDeltaThreads = 256;
// How many accumulator chains a warp keeps in flight (see warp_mma_nt_run in
// flash_tiles.cuh), tuned at D = 128 on the H100: column tiles of S and of dP
// side by side (so twice as many chains), column tiles of an output side by
// side, and, for float32, depth steps of an output's product chained from
// zero before the round-to-nearest add.
constexpr int kScoreGroup = 4;
constexpr int kOutGroup = 8;
constexpr int kOutAtOnce = 4;

// ---------------------------------------------------------------- delta --

template <typename T>
__global__ void __launch_bounds__(kDeltaThreads)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       const float* __restrict__ g_lse,
                       float* __restrict__ delta, int64_t n_rows, int t_len,
                       int n_heads, int d, Strides so, Strides sd) {
  const int64_t row =
      (static_cast<int64_t>(blockIdx.x) * kDeltaThreads + threadIdx.x) >> 5;
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

// warps of a dK/dV or dQ block, each owning 16 rows of the resident tile;
// eight for float32 at D = 128 (see the header)
template <typename T, int kD>
__host__ __device__ constexpr int bwd_warps() {
  return (sizeof(T) == 4 && kD == 128) ? 8 : 4;
}

// queries per streamed tile of the dK/dV kernel
template <typename T, int kD>
__host__ __device__ constexpr int dkv_queries() {
  return sizeof(T) == 4 ? (kD > 128 ? 16 : 32) : (kD <= 64 ? 64 : 32);
}
// output columns one dK/dV block accumulates
__host__ __device__ constexpr int dkv_cols(int d_max) {
  return d_max < 128 ? d_max : 128;
}

// keys per streamed tile of the dQ kernel
template <typename T, int kD>
__host__ __device__ constexpr int dq_keys() {
  return sizeof(T) == 4 ? (kD > 128 ? 16 : 32) : (kD <= 128 ? 64 : 32);
}

// a resident pair of tiles (16 rows a warp), a two-stage ring of pairs of
// kStream-row tiles, and the ring's LSE and delta rows
template <typename T, int kD, int kStream>
constexpr size_t bwd_smem_bytes() {
  return static_cast<size_t>(2 * kRowsPerWarp * bwd_warps<T, kD>() +
                             4 * kStream) *
             row_stride<T, kD>() * sizeof(T) +
         4 * kStream * sizeof(float);
}

template <typename T, int kD>
__global__ void __launch_bounds__(32 * bwd_warps<T, kD>())
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int n_heads, int t_len, int d,
                     float scale, Strides sq, Strides sk, Strides sv,
                     Strides sd, int causal, int strict, int aligned) {
  constexpr int kBlock = 32 * bwd_warps<T, kD>();          // threads
  constexpr int kBK = kRowsPerWarp * bwd_warps<T, kD>();   // keys per block
  constexpr int kBQ = dkv_queries<T, kD>();   // queries per streamed tile
  constexpr int kStride = row_stride<T, kD>();
  constexpr int kSNT = kBQ / 8;               // 8-column tiles of S^T
  constexpr int kONT = dkv_cols(kD) / 8;      // 8-column tiles of dK, dV
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* k_s = reinterpret_cast<T*>(smem_raw);    // [rows][kStride]
  T* v_s = k_s + kBK * kStride;               // [rows][kStride]
  T* q_s = v_s + kBK * kStride;               // [2][kBQ][kStride]
  T* do_s = q_s + 2 * kBQ * kStride;          // [2][kBQ][kStride]
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * kBQ * kStride);
  float* delta_s = lse_s + 2 * kBQ;           // both [2][kBQ]

  const int bh = blockIdx.x;
  const int b = bh / n_heads;
  const int h = bh - b * n_heads;
  const int k0 = blockIdx.y * kBK;   // causal: key tile 0 has the most work
  const int c0 = blockIdx.z * dkv_cols(kD);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float c2 = scale * kLog2e;

  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  const T* dob = dout + b * sd.b + h * sd.h;

  const int n_qt = (t_len + kBQ - 1) / kBQ;
  const int qt_first = causal ? k0 / kBQ : 0;

  auto load_stream = [&](int qt, int stage) {
    const int q0 = qt * kBQ;
    load_tile<T, kD, kBQ, kBlock>(q_s + stage * kBQ * kStride, qb, sq.t, q0,
                                  t_len, d, aligned);
    load_tile<T, kD, kBQ, kBlock>(do_s + stage * kBQ * kStride, dob, sd.t, q0,
                                  t_len, d, aligned);
    load_rows<kBQ, kBlock>(lse_s + stage * kBQ, lse, b, h, n_heads, q0,
                           t_len);
    load_rows<kBQ, kBlock>(delta_s + stage * kBQ, delta, b, h, n_heads, q0,
                           t_len);
  };

  load_tile<T, kD, kBK, kBlock>(k_s, kb, sk.t, k0, t_len, d, aligned);
  load_tile<T, kD, kBK, kBlock>(v_s, vb, sv.t, k0, t_len, d, aligned);
  load_stream(qt_first, 0);
  cp_async_commit();

  const float by_one[2] = {1.f, 1.f};
  float dk_acc[kONT][4], dv_acc[kONT][4];
  zero_acc(dk_acc);
  zero_acc(dv_acc);
  const int key0 = k0 + 16 * warp + (lane >> 2);

  for (int qt = qt_first; qt < n_qt; ++qt) {
    const int q0 = qt * kBQ;
    const int stage = (qt - qt_first) & 1;
    cp_async_wait_all();
    __syncthreads();   // tile qt has landed; tile qt-1 is read by no one
    if (qt + 1 < n_qt) {
      load_stream(qt + 1, stage ^ 1);
      cp_async_commit();
    }
    // a warp whose 16 keys all lie after the tile's last query has nothing
    // live in it
    if (causal && q0 + kBQ - 1 < k0 + 16 * warp) continue;
    const T* q_t = q_s + stage * kBQ * kStride;
    const T* do_t = do_s + stage * kBQ * kStride;

    // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys against the tile's
    // queries
    float st[kSNT][4], dpt[kSNT][4];
    warp_mma_nt2<T, kSNT, kD, kScoreGroup>(st, dpt, k_s, v_s, 16 * warp, q_t,
                                             do_t, kStride, lane);
    const bool masked = (q0 + kBQ > t_len) || (k0 + kBK > t_len) ||
                        (causal && q0 < k0 + kBK);
    probs_cols<kSNT>(st, dpt, lse_s + stage * kBQ, delta_s + stage * kBQ, c2,
                     masked, key0, q0, lane, t_len, causal, strict);
    // dV += P^T dO, dK += dS^T Q
    warp_mma_acc_t<T, kONT, kSNT, false, kOutAtOnce, kOutGroup>(
        dv_acc, st, by_one, do_t, c0, kStride, lane);
    warp_mma_acc_t<T, kONT, kSNT, false, kOutAtOnce, kOutGroup>(
        dk_acc, dpt, by_one, q_t, c0, kStride, lane);
  }

  const float by_scale[2] = {scale, scale};
  store_acc<T, kONT>(dk, dk_acc, by_scale, b, h, n_heads, t_len, d, key0, c0,
                     lane);
  store_acc<T, kONT>(dv, dv_acc, by_one, b, h, n_heads, t_len, d, key0, c0,
                     lane);
}

// -------------------------------------------------------------------- dQ --

template <typename T, int kD>
__global__ void __launch_bounds__(32 * bwd_warps<T, kD>())
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int n_heads, int t_len, int d, float scale, Strides sq,
                    Strides sk, Strides sv, Strides sd, int causal,
                    int strict, int aligned) {
  constexpr int kBlock = 32 * bwd_warps<T, kD>();          // threads
  constexpr int kBM = kRowsPerWarp * bwd_warps<T, kD>();   // queries a block
  constexpr int kBN = dq_keys<T, kD>();   // keys per streamed tile
  constexpr int kStride = row_stride<T, kD>();
  constexpr int kSNT = kBN / 8;           // 8-column tiles of S
  constexpr int kONT = kD / 8;            // 8-column tiles of dQ
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);   // [rows][kStride]
  T* do_s = q_s + kBM * kStride;             // [rows][kStride]
  T* k_s = do_s + kBM * kStride;             // [2][kBN][kStride]
  T* v_s = k_s + 2 * kBN * kStride;          // [2][kBN][kStride]

  const int bh = blockIdx.x;
  const int b = bh / n_heads;
  const int h = bh - b * n_heads;
  const int qt = gridDim.y - 1 - blockIdx.y;   // heaviest causal tiles first
  const int q0 = qt * kBM;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float c2 = scale * kLog2e;

  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  const T* dob = dout + b * sd.b + h * sd.h;

  load_tile<T, kD, kBM, kBlock>(q_s, qb, sq.t, q0, t_len, d, aligned);
  load_tile<T, kD, kBM, kBlock>(do_s, dob, sd.t, q0, t_len, d, aligned);
  load_tile<T, kD, kBN, kBlock>(k_s, kb, sk.t, 0, t_len, d, aligned);
  load_tile<T, kD, kBN, kBlock>(v_s, vb, sv.t, 0, t_len, d, aligned);
  cp_async_commit();

  // this lane's two rows' statistics; 0 past the end (those rows are masked)
  const int row0 = q0 + 16 * warp + (lane >> 2);
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const int64_t at = (static_cast<int64_t>(b) * t_len + row) * n_heads + h;
    lse2[r] = row < t_len ? lse[at] * kLog2e : 0.f;
    dl[r] = row < t_len ? delta[at] : 0.f;
  }

  const float by_one[2] = {1.f, 1.f};
  float dq_acc[kONT][4];
  zero_acc(dq_acc);

  const int n_kt_all = (t_len + kBN - 1) / kBN;
  const int n_kt =
      causal ? min(n_kt_all, (q0 + kBM + kBN - 1) / kBN) : n_kt_all;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBN;
    const int stage = kt & 1;
    cp_async_wait_all();
    __syncthreads();   // tile kt has landed; tile kt-1 is read by no one
    if (kt + 1 < n_kt) {
      const int next = (stage ^ 1) * kBN * kStride;
      load_tile<T, kD, kBN, kBlock>(k_s + next, kb, sk.t, k0 + kBN, t_len, d,
                                    aligned);
      load_tile<T, kD, kBN, kBlock>(v_s + next, vb, sv.t, k0 + kBN, t_len, d,
                                    aligned);
      cp_async_commit();
    }
    // a warp whose 16 queries all lie before the tile's first key has
    // nothing live in it
    if (causal && k0 > q0 + 16 * warp + 15) continue;
    const T* k_t = k_s + stage * kBN * kStride;
    const T* v_t = v_s + stage * kBN * kStride;

    // S = Q K^T and dP = dO V^T: this warp's 16 queries against the tile's
    // keys
    float s[kSNT][4], dp[kSNT][4];
    warp_mma_nt2<T, kSNT, kD, kScoreGroup>(s, dp, q_s, do_s, 16 * warp, k_t,
                                             v_t, kStride, lane);
    const bool masked = (k0 + kBN > t_len) || (q0 + kBM > t_len) ||
                        (causal && k0 + kBN > q0);
    probs_rows<kSNT>(s, dp, lse2, dl, c2, masked, row0, k0 + 2 * (lane & 3),
                     t_len, causal, strict);
    // dQ += dS K
    warp_mma_acc_t<T, kONT, kSNT, false, kOutAtOnce, kOutGroup>(
        dq_acc, dp, by_one, k_t, 0, kStride, lane);
  }

  const float by_scale[2] = {scale, scale};
  store_acc<T, kONT>(dq, dq_acc, by_scale, b, h, n_heads, t_len, d, row0, 0,
                     lane);
}

// --------------------------------------------------------------- launches --

bool bad_shape(int b, int t, int h, int d) {
  return b < 1 || t < 1 || h < 1 || d < 1 || d > 256 ||
         (t + kRowsPerBlock - 1) / kRowsPerBlock > 65535;
}

struct Views {
  Strides sq, sk, sv, sd;
  int aligned;
};

template <typename T>
Views views_of(const void* q, const void* k, const void* v, const void* dout,
               const int64_t* st) {
  Views w{strides_at(st, 0), strides_at(st, 1), strides_at(st, 2),
          strides_at(st, 3), 0};
  w.aligned = view_aligned(q, w.sq, sizeof(T)) &&
              view_aligned(k, w.sk, sizeof(T)) &&
              view_aligned(v, w.sv, sizeof(T)) &&
              view_aligned(dout, w.sd, sizeof(T));
  return w;
}

template <typename T, int kD>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dk, void* dv,
               int b, int t, int h, int d, float scale, const int64_t* st,
               int causal, int strict, cudaStream_t stream) {
  auto kernel = flash_bwd_dkv_kernel<T, kD>;
  constexpr size_t smem = bwd_smem_bytes<T, kD, dkv_queries<T, kD>()>();
  // above 48 KB the launch is refused unless the kernel opts in
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const Views w = views_of<T>(q, k, v, dout, st);
  constexpr int kRows = kRowsPerWarp * bwd_warps<T, kD>();
  const dim3 grid(b * h, (t + kRows - 1) / kRows, kD / dkv_cols(kD));
  kernel<<<grid, 32 * bwd_warps<T, kD>(), smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), h, t, d, scale, w.sq, w.sk,
      w.sv, w.sd, causal, strict, w.aligned);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kD>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, int b, int t,
              int h, int d, float scale, const int64_t* st, int causal,
              int strict, cudaStream_t stream) {
  auto kernel = flash_bwd_dq_kernel<T, kD>;
  constexpr size_t smem = bwd_smem_bytes<T, kD, dq_keys<T, kD>()>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const Views w = views_of<T>(q, k, v, dout, st);
  constexpr int kRows = kRowsPerWarp * bwd_warps<T, kD>();
  const dim3 grid(b * h, (t + kRows - 1) / kRows);
  kernel<<<grid, 32 * bwd_warps<T, kD>(), smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), h, t, d, scale, w.sq, w.sk, w.sv, w.sd, causal,
      strict, w.aligned);
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
  const int64_t blocks = (rows * 32 + kDeltaThreads - 1) / kDeltaThreads;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const Strides so = strides_at(strides, 0), sd = strides_at(strides, 1);
  const unsigned grid = static_cast<unsigned>(blocks);
  if (is_bf16)
    flash_bwd_delta_kernel<__nv_bfloat16><<<grid, kDeltaThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(o),
        static_cast<const __nv_bfloat16*>(dout), g_lse, delta, rows, t, h, d,
        so, sd);
  else
    flash_bwd_delta_kernel<float><<<grid, kDeltaThreads, 0, stream>>>(
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
