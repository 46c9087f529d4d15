// Fused softmax cross-entropy (mean over rows, integer labels), forward and
// backward, for Hopper (sm_90a).
//
// Replaces the Pallas kernels of split_learning_tpu/ops/cross_entropy.py:
//   forward  _fwd_kernel / _fwd_grid_kernel  (pallas_call at :154, :171)
//   backward _bwd_kernel / _bwd_grid_kernel  (pallas_call at :206, :218)
//
// What bounds it on this card: bytes. The forward reads the [N, C] logits
// once and writes N floats; the backward reads the logits again and writes
// the [N, C] gradient. At the main path's shape (N = 64, C = 10) that is a
// few kilobytes, so both kernels are bound by launch latency, not by the
// 3.35 TB/s of device memory.
//
// Design, against the TPU version:
// - The TPU kernels pad C to 128 lanes and B to 8 sublanes, and split into
//   a single-block and a 1024-row gridded form to fit VMEM. Here one warp
//   owns one row and loops over C with a stride of 32, so any N and any C
//   work with no padding and no second form.
// - The TPU forward saves the [Bp, Cp] softmax for the backward. Here the
//   forward saves only the row log-sum-exp ([N] floats) and the backward
//   recomputes p = exp(x - lse) from the logits: on this card a second read
//   of the logits costs less than writing and re-reading a float32 copy of
//   the softmax, which for bf16 logits is twice their size.
// - Blocks run in parallel and in no order, so the mean over rows is not
//   carried across blocks: each block writes a partial sum of its rows'
//   losses, and a second one-warp kernel sums the partials in a fixed order
//   and divides by N. The loss is therefore deterministic, with no atomics
//   (JAX's gridded path likewise sums its partials after the kernel).
// - The backward reads the loss cotangent g from device memory, so a
//   training step never waits on the host.
//
// Math (float32 throughout, logits float32 or bfloat16):
//   m = max_j x_j,  s = sum_j exp(x_j - m),  lse = m + log s
//   row loss = log s - (x_y - m);  loss = sum(row loss) / N
//   grad_ij = (exp(x_ij - lse_i) - [j == y_i]) * g / N,  in the logits dtype
// A label outside [0, C) makes its row loss NaN; no memory outside the row
// is read for it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;  // rows in flight per block (one per warp)
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ce_fwd_kernel(const T* __restrict__ logits, const int64_t* __restrict__ labels,
              float* __restrict__ lse, float* __restrict__ partials, int n,
              int c) {
  __shared__ float warp_loss[kWarpsPerBlock];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float acc = 0.f;  // this warp's sum of row losses, valid in lane 0
  for (int row = blockIdx.x * kWarpsPerBlock + warp; row < n;
       row += gridDim.x * kWarpsPerBlock) {
    const T* x = logits + static_cast<size_t>(row) * c;
    float m = -INFINITY;
    for (int j = lane; j < c; j += 32) m = fmaxf(m, to_f32(x[j]));
    m = warp_max(m);
    float s = 0.f;
    for (int j = lane; j < c; j += 32) s += expf(to_f32(x[j]) - m);
    s = warp_sum(s);
    if (lane == 0) {
      const float log_s = logf(s);
      lse[row] = m + log_s;
      const int64_t y = labels[row];
      acc += (y >= 0 && y < c) ? log_s - (to_f32(x[y]) - m) : NAN;
    }
  }
  if (lane == 0) warp_loss[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
    for (int w = 0; w < kWarpsPerBlock; ++w) t += warp_loss[w];
    partials[blockIdx.x] = t;
  }
}

// One warp: sum the per-block partials in a fixed order, divide by N.
__global__ void ce_mean_kernel(const float* __restrict__ partials, int blocks,
                               int n, float* __restrict__ loss) {
  float t = 0.f;
  for (int i = threadIdx.x; i < blocks; i += 32) t += partials[i];
  t = warp_sum(t);
  if (threadIdx.x == 0) *loss = t / static_cast<float>(n);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ce_bwd_kernel(const T* __restrict__ logits, const int64_t* __restrict__ labels,
              const float* __restrict__ lse, const float* __restrict__ g,
              T* __restrict__ grad, int n, int c) {
  const float scale = *g / static_cast<float>(n);
  const size_t total = static_cast<size_t>(n) * c;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int row = static_cast<int>(i / c);
    const int col = static_cast<int>(i - static_cast<size_t>(row) * c);
    const float p = expf(to_f32(logits[i]) - lse[row]);
    const float onehot = (labels[row] == col) ? 1.f : 0.f;
    store(grad + i, (p - onehot) * scale);
  }
}

int blocks_for(size_t work, int per_block, int cap) {
  size_t b = (work + per_block - 1) / per_block;
  if (b < 1) b = 1;
  return static_cast<int>(b < static_cast<size_t>(cap) ? b : cap);
}

}  // namespace

extern "C" {

// Rows handled per block of the forward; the caller sizes `partials` with
// slt_ce_fwd_blocks(n) floats.
int slt_ce_fwd_blocks(int n) { return blocks_for(n, kWarpsPerBlock, 1024); }

// logits [n, c] (float32 if is_bf16 == 0, else bfloat16), labels [n] int64.
// Writes lse [n], partials [slt_ce_fwd_blocks(n)] and the scalar loss.
// Returns cudaGetLastError() after the two launches.
int slt_ce_fwd(const void* logits, const int64_t* labels, float* lse,
               float* partials, float* loss, int n, int c, int is_bf16,
               cudaStream_t stream) {
  const int blocks = slt_ce_fwd_blocks(n);
  if (is_bf16) {
    ce_fwd_kernel<__nv_bfloat16><<<blocks, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(logits), labels, lse, partials, n,
        c);
  } else {
    ce_fwd_kernel<float><<<blocks, kThreads, 0, stream>>>(
        static_cast<const float*>(logits), labels, lse, partials, n, c);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ce_mean_kernel<<<1, 32, 0, stream>>>(partials, blocks, n, loss);
  return static_cast<int>(cudaGetLastError());
}

// grad [n, c] in the logits dtype; g is a float32 scalar on the device.
int slt_ce_bwd(const void* logits, const int64_t* labels, const float* lse,
               const float* g, void* grad, int n, int c, int is_bf16,
               cudaStream_t stream) {
  const int blocks =
      blocks_for(static_cast<size_t>(n) * c, kThreads, 132 * 16);
  if (is_bf16) {
    ce_bwd_kernel<__nv_bfloat16><<<blocks, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(logits), labels, lse, g,
        static_cast<__nv_bfloat16*>(grad), n, c);
  } else {
    ce_bwd_kernel<float><<<blocks, kThreads, 0, stream>>>(
        static_cast<const float*>(logits), labels, lse, g,
        static_cast<float*>(grad), n, c);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
