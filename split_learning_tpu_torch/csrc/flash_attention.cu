// Flash-attention forward (online softmax, O and the row log-sum-exp) for
// Hopper (sm_90a), on the tensor cores.
//
// Replaces the Pallas kernel of split_learning_tpu/ops/flash_attention.py:
//   _fwd_kernel (:391, pallas_call at :657), reached through
//   flash_attention (:759) and flash_attention_with_lse (:780).
//
// What bounds it on this card: operations. Per (batch, head) the work is
// 4*T*T*D FLOPs (half of it under the causal mask) against 4*T*D values
// moved, so at the serving path's prefill (B 8, T 1024, H 2, D 128) it does
// about 500 operations per byte, above the H100's ridge in bf16 (295) and
// in float32. The roof is the tensor cores': 989 TFLOP/s with bf16
// operands; for float32 inputs 495 TFLOP/s of TF32 over the three products
// of the error-compensated split, 165 TFLOP/s. What the kernel reaches is
// about a fifth of that roof: with eight warps an SM the time goes to the
// latency of dependent mma.sync and shared-memory loads, not to their rate
// (PERF.md has the numbers).
//
// Design (the tile machinery is csrc/flash_tiles.cuh):
// - One block of 128 threads per PAIR of 64-row query tiles and b*h: tile
//   n-1-i, then tile i. Under the causal mask tile j walks j+1 key tiles, so
//   every block walks n+1 of them and no block is left with the long rows
//   while the card drains (an odd middle tile is walked alone). The TPU
//   kernel's sequential (bh, q block, k block) grid with VMEM scratch
//   becomes a loop inside the block; m, l and the output accumulator stay in
//   registers.
// - Each of the four warps owns 16 query rows. Q is loaded once per tile. K
//   and V tiles (64 keys; 32 for float32 at D >= 128) stream through
//   separate buffers, two stages each: after the barrier that publishes tile
//   i, the cp.async copy of tile i+1 is issued and runs while tile i
//   multiplies. One barrier per tile.
// - S = Q K^T: mma.sync with A (Q) and B (K, as stored) from shared memory
//   by ldmatrix (bf16) or split float32 loads (3xTF32). S stays in the
//   accumulator registers, the online softmax runs on them (ex2.approx, quad
//   shuffles), and P goes to O += P V as the A operand from those same
//   registers, rounded to bf16 for bf16 inputs as the TPU kernel does
//   (:424); V is read by ldmatrix.trans. O and the LSE are written once.
// - Shared memory per block, tiles in the input dtype with 16-byte row
//   pads: bf16 D=128 85 KB (2 blocks an SM), D=256 165 KB (1); float32
//   D=128 99 KB (2 blocks), D=256 195 KB (1); D<=64 at most 85 KB. 165
//   (bf16) and 224 (float32) registers a thread at D=128, so an SM holds
//   eight warps, two per scheduler.
// - Q, K and V are read through their [B, T, H, D] strides, so the
//   [B, T, H, D] -> [B*H, T, D] transposes of the JAX wrapper cost no copy.
//
// Math, as _scores / _fwd_kernel: s = (q . k) * D^-0.5 in float32; masked
// entries are NEG_BIG before the max and 0 after the exp (ragged tail
// col >= T; causal row >= col; strict row > col); m, l, acc carried in
// float32; o = acc / l in the input dtype; lse = m + log l in float32. A row
// with no unmasked key (l == 0) gives o = 0 and lse = NEG_BIG.

#include "flash_tiles.cuh"

namespace {

using namespace slt_flash;

// How many accumulator chains a warp keeps in flight (see warp_mma_nt_run in
// flash_tiles.cuh), tuned at D = 128 on the H100: column tiles of S side by
// side, column tiles of O side by side, and, for float32, depth steps of P V
// chained from zero before the round-to-nearest add.
constexpr int kScoreGroup = 4;
constexpr int kOutGroup = 8;
constexpr int kOutAtOnce = 4;

// keys per streamed tile
template <typename T, int kD>
__host__ __device__ constexpr int fwd_keys() {
  return (sizeof(T) == 4 && kD >= 128) ? 32 : 64;
}

template <typename T, int kD>
constexpr size_t fwd_smem_bytes() {
  return static_cast<size_t>(kRowsPerBlock + 4 * fwd_keys<T, kD>()) *
         row_stride<T, kD>() * sizeof(T);
}

template <typename T, int kD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int n_heads, int t_len, int d,
                 float scale, Strides sq, Strides sk, Strides sv, int causal,
                 int strict, int aligned) {
  constexpr int kBM = kRowsPerBlock;
  constexpr int kBN = fwd_keys<T, kD>();
  constexpr int kStride = row_stride<T, kD>();
  constexpr int kSNT = kBN / 8;   // 8-column tiles of S
  constexpr int kONT = kD / 8;    // 8-column tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);   // [64][kStride]
  T* k_s = q_s + kBM * kStride;              // [2][kBN][kStride]
  T* v_s = k_s + 2 * kBN * kStride;          // [2][kBN][kStride]

  const int bh = blockIdx.x;
  const int b = bh / n_heads;
  const int h = bh - b * n_heads;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_qt = (t_len + kBM - 1) / kBM;
  const int n_kt_all = (t_len + kBN - 1) / kBN;
  const float c2 = scale * kLog2e;

  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;

  const int heavy = n_qt - 1 - blockIdx.y;
  for (int half = 0; half < 2; ++half) {
    const int qt = half == 0 ? heavy : static_cast<int>(blockIdx.y);
    if (half == 1 && qt >= heavy) break;   // the odd middle tile: once
    const int q0 = qt * kBM;
    const int n_kt =
        causal ? min(n_kt_all, (q0 + kBM + kBN - 1) / kBN) : n_kt_all;

    __syncthreads();   // the first tile's reads of shared memory are done
    load_tile<T, kD, kBM, kThreads>(q_s, qb, sq.t, q0, t_len, d, aligned);
    load_tile<T, kD, kBN, kThreads>(k_s, kb, sk.t, 0, t_len, d, aligned);
    load_tile<T, kD, kBN, kThreads>(v_s, vb, sv.t, 0, t_len, d, aligned);
    cp_async_commit();

    float m[2] = {kNegBig, kNegBig}, l[2] = {0.f, 0.f};
    float acc[kONT][4];
    zero_acc(acc);
    const int row0 = q0 + 16 * warp + (lane >> 2);

    for (int kt = 0; kt < n_kt; ++kt) {
      const int k0 = kt * kBN;
      const int stage = kt & 1;
      cp_async_wait_all();
      __syncthreads();   // tile kt has landed; tile kt-1 is read by no one
      if (kt + 1 < n_kt) {
        const int next = (stage ^ 1) * kBN * kStride;
        load_tile<T, kD, kBN, kThreads>(k_s + next, kb, sk.t, k0 + kBN, t_len,
                                        d, aligned);
        load_tile<T, kD, kBN, kThreads>(v_s + next, vb, sv.t, k0 + kBN, t_len,
                                        d, aligned);
        cp_async_commit();
      }
      // a warp whose 16 rows all lie before the tile's first key has
      // nothing live in it: m, l and acc stay as they are
      if (causal && k0 > q0 + 16 * warp + 15) continue;
      float s[kSNT][4];
      warp_mma_nt1<T, kSNT, kD, kScoreGroup>(
          s, q_s, 16 * warp, k_s + stage * kBN * kStride, kStride, lane);
      // masks only on the ragged last tile and on tiles the diagonal crosses
      const bool masked = (k0 + kBN > t_len) || (causal && k0 + kBN > q0);
      float corr[2];
      softmax_step<kSNT>(s, m, l, corr, c2, masked, row0,
                         k0 + 2 * (lane & 3), t_len, causal, strict);
      warp_mma_acc_t<T, kONT, kSNT, true, kOutAtOnce, kOutGroup>(
          acc, s, corr, v_s + stage * kBN * kStride, 0, kStride, lane);
    }

    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(kFull, l[r], 1);
      l[r] += __shfl_xor_sync(kFull, l[r], 2);
      const bool live = l[r] > 0.f;
      inv[r] = live ? 1.f / l[r] : 0.f;
      const int row = row0 + 8 * r;
      if ((lane & 3) == 0 && row < t_len)
        lse[(static_cast<int64_t>(b) * t_len + row) * n_heads + h] =
            live ? (m[r] + log2f(l[r])) * kLn2 : kNegBig;
    }
    store_acc<T, kONT>(o, acc, inv, b, h, n_heads, t_len, d, row0, 0, lane);
  }
}

template <typename T, int kD>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int b, int t, int h, int d, float scale, const int64_t* st,
           int causal, int strict, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, kD>;
  constexpr size_t smem = fwd_smem_bytes<T, kD>();
  // above 48 KB the launch is refused unless the kernel opts in
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const Strides sq = strides_at(st, 0), sk = strides_at(st, 1),
                sv = strides_at(st, 2);
  const int aligned = view_aligned(q, sq, sizeof(T)) &&
                      view_aligned(k, sk, sizeof(T)) &&
                      view_aligned(v, sv, sizeof(T));
  const int n_qt = (t + kRowsPerBlock - 1) / kRowsPerBlock;
  const dim3 grid(b * h, (n_qt + 1) / 2);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, h, t, d, scale, sq,
      sk, sv, causal, strict, aligned);
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
    return launch<T, 128>(q, k, v, o, lse, b, t, h, d, scale, st, causal,
                          strict, stream);
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
      (t + kRowsPerBlock - 1) / kRowsPerBlock > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (is_bf16)
    return dispatch<__nv_bfloat16>(q, k, v, o, lse, b, t, h, d, scale,
                                   strides, causal, strict, stream);
  return dispatch<float>(q, k, v, o, lse, b, t, h, d, scale, strides, causal,
                         strict, stream);
}

}  // extern "C"
