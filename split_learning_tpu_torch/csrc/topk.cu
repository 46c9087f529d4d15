// Magnitudes for top-k selection, with the error-feedback fold, for Hopper
// (sm_90a).
//
// Replaces the Pallas kernel of split_learning_tpu/ops/topk.py:
//   _mag_kernel via magnitudes (pallas_call at :47, :58)
// and fuses in front of it the error-feedback fold of the wire codec
// (split_learning_tpu/transport/codec.py:372-374 and :233-236):
//   x_eff = x + float32(decay) * res      (res absent: x_eff = x)
//   m     = |x_eff|
// Two roundings (--fmad=false), as numpy's `np.float32(decay) * prev`
// followed by `a + residual`. It also raises a flag when any element of x
// is NaN or infinite: the wire codec refuses such a tensor
// (codec.py:101-109), and the flag saves it a pass of its own.
//
// What bounds it on this card: bytes. It reads x (and the residual) once
// and writes x_eff and m once: 16 bytes per float32 element with the fold,
// 8 without (22 MB and 11 MB at the CNN cut, under 7 us at 3.35 TB/s), so
// at the CNN cut it is launch-bound.
//
// Design, against the TPU version: the TPU pads the payload to [rows, 128]
// tiles so the padding's |0| can never win a slot; here the kernel walks
// the flat array with a grid stride and writes exactly n values, so there
// is no padding to guard. x_eff is the codec's new residual before the
// survivors are subtracted, so writing it here saves the host path's copy.
// float32 inputs load as float4 where the pointers allow; bfloat16 inputs
// load one element at a time. The selection that follows (threshold, ties
// toward the lower index) runs on PyTorch ops over m, as JAX leaves it to
// lax.top_k outside Pallas.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float fold(float x, const float* res, int64_t i,
                                      float decay) {
  return res != nullptr ? x + decay * res[i] : x;
}

// x [n]; res [n] or null; x_eff [n] or null (not written); m [n]; *bad is
// set to 1 (never cleared) when an element of x is not finite
template <typename T>
__global__ void __launch_bounds__(kThreads)
magnitude_kernel(const T* __restrict__ x, const float* __restrict__ res,
                 float decay, int64_t n, float* __restrict__ x_eff,
                 float* __restrict__ m, int* __restrict__ bad) {
  const bool vec =
      sizeof(T) == 4 &&
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(res) |
        reinterpret_cast<uintptr_t>(x_eff) | reinterpret_cast<uintptr_t>(m)) &
       15u) == 0;
  const int64_t groups = (n + 3) / 4;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  bool finite = true;
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       g < groups; g += stride) {
    const int64_t i = g * 4;
    if (vec && i + 3 < n) {
      float4 v = reinterpret_cast<const float4*>(x)[g];
      finite = finite && isfinite(v.x) && isfinite(v.y) && isfinite(v.z) &&
               isfinite(v.w);
      if (res != nullptr) {
        const float4 r = reinterpret_cast<const float4*>(res)[g];
        v.x = v.x + decay * r.x;
        v.y = v.y + decay * r.y;
        v.z = v.z + decay * r.z;
        v.w = v.w + decay * r.w;
      }
      if (x_eff != nullptr) reinterpret_cast<float4*>(x_eff)[g] = v;
      reinterpret_cast<float4*>(m)[g] =
          make_float4(fabsf(v.x), fabsf(v.y), fabsf(v.z), fabsf(v.w));
    } else {
      for (int j = 0; j < 4 && i + j < n; ++j) {
        const float xv = to_f32(x[i + j]);
        finite = finite && isfinite(xv);
        const float v = fold(xv, res, i + j, decay);
        if (x_eff != nullptr) x_eff[i + j] = v;
        m[i + j] = fabsf(v);
      }
    }
  }
  if (!finite) *bad = 1;  // every writer stores the same value
}

}  // namespace

extern "C" {

// See magnitude_kernel; the caller zeroes *bad. Returns cudaGetLastError()
// after the launch.
int slt_topk_magnitudes(const void* x, const float* res, float decay,
                        int64_t n, int is_bf16, float* x_eff, float* m,
                        int* bad, cudaStream_t stream) {
  if (n == 0) return 0;
  const int64_t want = ((n + 3) / 4 + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want > 132 * 16 ? 132 * 16 : want);
  if (is_bf16) {
    magnitude_kernel<__nv_bfloat16><<<blocks, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), res, decay, n, x_eff, m, bad);
  } else {
    magnitude_kernel<float><<<blocks, kThreads, 0, stream>>>(
        static_cast<const float*>(x), res, decay, n, x_eff, m, bad);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
