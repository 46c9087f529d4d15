// Symmetric int8 quantize / dequantize of the cut-layer payload, for Hopper
// (sm_90a).
//
// Replaces the Pallas kernels of split_learning_tpu/ops/quantize.py:
//   quantize   _quant_fused_kernel (pallas_call at :88), and the gridded pair
//              _amax_kernel (:107) + _quant_scaled_kernel (:117)
//   dequantize _dequant_kernel (:143, :152)
//
// Math (float32; the input float32 or bfloat16):
//   amax  = max |x|                           (NaN if any x is NaN)
//   scale = max(amax / 127, 1e-12)            (float32)
//   q     = clip(rint(x / scale), -127, 127)  int8, rint = half to even
//   x'    = float(q) * scale
//
// What bounds it on this card: bytes. The quantize reads the input twice
// (the amax pass, then the quantize pass) and writes one byte per element;
// the dequantize reads a byte and writes four. At the CNN cut (1,384,448
// values) that is 12.5 MB and 6.9 MB, a few microseconds at 3.35 TB/s, so
// both are launch-bound there; at the LM cut (16.8M values) they are not.
//
// Design, against the TPU version:
// - The TPU keeps the payload as a zero-padded [rows, 128] tile array and
//   picks a one-block form or a 512-row grid to fit VMEM. Here the kernels
//   walk the flat array with a grid stride; the caller gives the output
//   length n_out >= n, and elements n .. n_out - 1 are written as 0, so the
//   same launch gives the JAX [rows, 128] layout or the wire's unpadded one.
// - Blocks run in no order, so the amax is two kernels in one launch call:
//   one partial max per block, then a one-block reduce of the partials. It
//   writes {amax, scale} to device memory, and the quantize pass reads the
//   scale there, so nothing waits on the host between the passes. The max
//   propagates NaN, so a non-finite input shows in amax itself (the wire
//   codec refuses such a tensor).
// - The scale is computed in double and narrowed, (float)((double)amax /
//   127.0): the wire codec ships that double, and its float32 narrowing
//   equals the float32 quotient the TPU computes (a double-rounded division
//   is correctly rounded in float32).
// - The division is IEEE (no reciprocal, no fast math) and rint rounds half
//   to even, as jnp.round, np.round and the host C++ codec do; roundf would
//   round halves away from zero.
// - float32 inputs load as float4 and store char4 where the pointers allow;
//   bfloat16 inputs load one element at a time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 1024;  // partials of the amax pass
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// max that propagates NaN from either side (fmaxf drops it)
__device__ __forceinline__ float nan_max(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return fmaxf(a, b);
}

__device__ __forceinline__ float block_max(float v) {
  __shared__ float warp_part[kThreads / 32];
  for (int o = 16; o > 0; o >>= 1)
    v = nan_max(v, __shfl_xor_sync(kFull, v, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_part[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kThreads / 32 ? warp_part[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1)
      v = nan_max(v, __shfl_xor_sync(kFull, v, o));
  }
  return v;  // valid in thread 0
}

int amax_blocks(int64_t n) {
  const int64_t want = (n + kThreads * 4 - 1) / (kThreads * 4);
  return static_cast<int>(want < 1 ? 1 : (want > kMaxBlocks ? kMaxBlocks
                                                             : want));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
amax_partial_kernel(const T* __restrict__ x, int64_t n,
                    float* __restrict__ partials) {
  float m = 0.f;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (sizeof(T) == 4 && (reinterpret_cast<uintptr_t>(x) & 15u) == 0) {
    const int64_t n4 = n / 4;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    for (int64_t i = tid; i < n4; i += stride) {
      const float4 v = x4[i];
      m = nan_max(m, nan_max(nan_max(fabsf(v.x), fabsf(v.y)),
                             nan_max(fabsf(v.z), fabsf(v.w))));
    }
    for (int64_t i = n4 * 4 + tid; i < n; i += stride)
      m = nan_max(m, fabsf(to_f32(x[i])));
  } else {
    for (int64_t i = tid; i < n; i += stride)
      m = nan_max(m, fabsf(to_f32(x[i])));
  }
  m = block_max(m);
  if (threadIdx.x == 0) partials[blockIdx.x] = m;
}

// one block: stats[0] = amax, stats[1] = float32 scale
__global__ void __launch_bounds__(kThreads)
amax_final_kernel(const float* __restrict__ partials, int blocks,
                  float* __restrict__ stats) {
  float m = 0.f;
  for (int i = threadIdx.x; i < blocks; i += kThreads)
    m = nan_max(m, partials[i]);
  m = block_max(m);
  if (threadIdx.x == 0) {
    stats[0] = m;
    // fmax(NaN, eps) would drop the NaN: keep it, the scale is poisoned too
    const double s = static_cast<double>(m) / 127.0;
    stats[1] = (m != m) ? m : static_cast<float>(s > 1e-12 ? s : 1e-12);
  }
}

__device__ __forceinline__ int8_t quant1(float v, float s) {
  float r = rintf(__fdiv_rn(v, s));
  r = fminf(fmaxf(r, -127.f), 127.f);
  return static_cast<int8_t>(static_cast<int>(r));
}

// q[i] = quant(x[i]) for i < n, 0 for n <= i < n_out; four elements a thread
template <typename T>
__global__ void __launch_bounds__(kThreads)
quantize_kernel(const T* __restrict__ x, int64_t n, int64_t n_out,
                const float* __restrict__ stats, int8_t* __restrict__ q) {
  const float s = stats[1];
  const bool vec_in =
      sizeof(T) == 4 && (reinterpret_cast<uintptr_t>(x) & 15u) == 0;
  const bool vec_out = (reinterpret_cast<uintptr_t>(q) & 3u) == 0;
  const int64_t groups = (n_out + 3) / 4;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       g < groups; g += stride) {
    const int64_t i = g * 4;
    int8_t r[4];
    if (vec_in && i + 3 < n) {
      const float4 v = reinterpret_cast<const float4*>(x)[g];
      r[0] = quant1(v.x, s);
      r[1] = quant1(v.y, s);
      r[2] = quant1(v.z, s);
      r[3] = quant1(v.w, s);
    } else {
      for (int j = 0; j < 4; ++j)
        r[j] = i + j < n ? quant1(to_f32(x[i + j]), s) : int8_t(0);
    }
    if (vec_out && i + 3 < n_out) {
      reinterpret_cast<char4*>(q)[g] = make_char4(r[0], r[1], r[2], r[3]);
    } else {
      for (int j = 0; j < 4 && i + j < n_out; ++j) q[i + j] = r[j];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
dequantize_kernel(const int8_t* __restrict__ q, int64_t n, float s,
                  float* __restrict__ out) {
  const bool vec = ((reinterpret_cast<uintptr_t>(q) & 3u) |
                    (reinterpret_cast<uintptr_t>(out) & 15u)) == 0;
  const int64_t groups = (n + 3) / 4;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       g < groups; g += stride) {
    const int64_t i = g * 4;
    if (vec && i + 3 < n) {
      const char4 v = reinterpret_cast<const char4*>(q)[g];
      reinterpret_cast<float4*>(out)[g] = make_float4(
          static_cast<float>(v.x) * s, static_cast<float>(v.y) * s,
          static_cast<float>(v.z) * s, static_cast<float>(v.w) * s);
    } else {
      for (int j = 0; j < 4 && i + j < n; ++j)
        out[i + j] = static_cast<float>(q[i + j]) * s;
    }
  }
}

int grid_for(int64_t groups) {
  const int64_t want = (groups + kThreads - 1) / kThreads;
  const int64_t cap = 132 * 16;
  return static_cast<int>(want < 1 ? 1 : (want > cap ? cap : want));
}

}  // namespace

extern "C" {

// Floats the caller allocates for `partials` of slt_q8_amax.
int slt_q8_amax_blocks(int64_t n) { return amax_blocks(n); }

// x [n] (float32 if is_bf16 == 0, else bfloat16). Writes stats[0] = amax
// and stats[1] = the float32 scale. Two launches (partials, then the
// reduce); returns cudaGetLastError() after them.
int slt_q8_amax(const void* x, int64_t n, int is_bf16, float* partials,
                float* stats, cudaStream_t stream) {
  const int blocks = amax_blocks(n);
  if (is_bf16) {
    amax_partial_kernel<__nv_bfloat16><<<blocks, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), n, partials);
  } else {
    amax_partial_kernel<float><<<blocks, kThreads, 0, stream>>>(
        static_cast<const float*>(x), n, partials);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  amax_final_kernel<<<1, kThreads, 0, stream>>>(partials, blocks, stats);
  return static_cast<int>(cudaGetLastError());
}

// q [n_out] int8 from x [n] and the scale at stats[1]; q[n:] = 0.
int slt_q8_quantize(const void* x, int64_t n, int64_t n_out, int is_bf16,
                    const float* stats, int8_t* q, cudaStream_t stream) {
  if (n_out < n) return static_cast<int>(cudaErrorInvalidValue);
  if (n_out == 0) return 0;
  const int blocks = grid_for((n_out + 3) / 4);
  if (is_bf16) {
    quantize_kernel<__nv_bfloat16><<<blocks, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), n, n_out, stats, q);
  } else {
    quantize_kernel<float><<<blocks, kThreads, 0, stream>>>(
        static_cast<const float*>(x), n, n_out, stats, q);
  }
  return static_cast<int>(cudaGetLastError());
}

// out [n] float32 = float(q) * scale.
int slt_q8_dequantize(const int8_t* q, int64_t n, float scale, float* out,
                      cudaStream_t stream) {
  if (n == 0) return 0;
  dequantize_kernel<<<grid_for((n + 3) / 4), kThreads, 0, stream>>>(
      q, n, scale, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
