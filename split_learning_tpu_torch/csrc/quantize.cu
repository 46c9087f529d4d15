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
// What bounds it on this card: bytes. The quantize needs the amax before
// its first element, so it reads the input twice (once for the amax, once
// to quantize) and writes one byte per element; the least the function
// must move is 5 bytes an element (4 in, 1 out). At the CNN cut (1,384,448
// values) the second read comes back from the 50 MB L2; at the LM cut
// (16.8M values, 67 MB) it does not. The dequantize reads a byte and
// writes four.
//
// Design, against the TPU version:
// - The TPU keeps the payload as a zero-padded [rows, 128] tile array and
//   picks a one-block form or a 512-row grid to fit VMEM. Here the kernels
//   walk the flat array with a grid stride; the caller gives the output
//   length n_out >= n, and elements n .. n_out - 1 are written as 0, so the
//   same launch gives the JAX [rows, 128] layout or the wire's unpadded one.
// - amax and quantize are one cooperative launch (cudaLaunchCooperativeKernel)
//   of at most as many blocks as the card holds at once (occupancy x SMs):
//   each block reduces a partial max, the grid synchronises, every block
//   reads all partials and forms the same {amax, scale}, then quantizes its
//   slice. A grid that cannot be co-resident is refused by the launch (an
//   error, never a deadlock). Nothing waits on the host between the passes.
// - The launch writes {amax, scale} into the first 16 bytes of the output
//   buffer, ahead of q, so the wire codec copies the header and the payload
//   to the host in one copy. The max propagates NaN, so a non-finite input
//   shows in amax itself (the wire codec refuses such a tensor).
// - The scale is computed in double and narrowed, (float)((double)amax /
//   127.0): the wire codec ships that double, and its float32 narrowing
//   equals the float32 quotient the TPU computes (a double-rounded division
//   is correctly rounded in float32).
// - The division is IEEE (no reciprocal, no fast math) and rint rounds half
//   to even, as jnp.round, np.round and the host C++ codec do; roundf would
//   round halves away from zero.
// - A warp works on groups of 512 consecutive elements, 16 a lane, and
//   every access of the warp covers one contiguous span: the quantize loads
//   16 bytes a lane (four float32 or eight bfloat16) and stores their int8
//   side by side; the dequantize loads 16 int8 a lane in one 16-byte load
//   and, after four shuffle rounds, stores float4s side by side. (Sixteen
//   consecutive elements a lane made each instruction stride 64 bytes and
//   ran the dequantize at half the old 4-byte kernel's speed at the LM cut.)
//   Unaligned pointers and the ragged tail take scalar accesses.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 16;      // elements a thread handles per group
constexpr int kHeader = 16;   // {amax, scale, 0, 0} ahead of q
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// max that propagates NaN from either side (fmaxf drops it)
__device__ __forceinline__ float nan_max(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return fmaxf(a, b);
}

// the block's max, valid in every thread
__device__ __forceinline__ float block_max(float v) {
  __shared__ float warp_part[kThreads / 32];
  __shared__ float result;
  for (int o = 16; o > 0; o >>= 1)
    v = nan_max(v, __shfl_xor_sync(kFull, v, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // an earlier call's readers are done
  if (lane == 0) warp_part[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kThreads / 32 ? warp_part[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1)
      v = nan_max(v, __shfl_xor_sync(kFull, v, o));
    if (lane == 0) result = v;
  }
  __syncthreads();
  return result;
}

// float32 scale of an amax; a NaN amax gives a NaN scale (fmax would drop it)
__device__ __forceinline__ float scale_of(float amax) {
  const double s = static_cast<double>(amax) / 127.0;
  return (amax != amax) ? amax : static_cast<float>(s > 1e-12 ? s : 1e-12);
}

__device__ __forceinline__ int8_t quant1(float v, float s) {
  float r = rintf(__fdiv_rn(v, s));
  r = fminf(fmaxf(r, -127.f), 127.f);
  return static_cast<int8_t>(static_cast<int>(r));
}

// A warp's group is 512 consecutive elements. Lane l holds its 16 in 16-byte
// slices that sit side by side across the warp, so each load or store
// instruction of the warp covers one contiguous span: slice c of lane l is
// elements base + c * 32 * V + l * V .. + V, V = 16 / sizeof(T) (4 float32,
// 8 bfloat16); v[c * V + e] is its element e.
constexpr int kGroup = 32 * kVec;

template <typename T>
__device__ __forceinline__ int64_t slot_of(int64_t base, int lane, int j) {
  constexpr int V = 16 / sizeof(T);
  return base + (j / V) * 32 * V + lane * V + j % V;
}

template <typename T>
__device__ __forceinline__ void load_group(const T* __restrict__ x,
                                           int64_t base, int64_t n, bool vec,
                                           int lane, float v[kVec]) {
  constexpr int V = 16 / sizeof(T);
  if (vec && base + kGroup <= n) {
#pragma unroll
    for (int c = 0; c < kVec / V; ++c) {
      const uint4 a =
          *reinterpret_cast<const uint4*>(x + base + c * 32 * V + lane * V);
      const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        if constexpr (sizeof(T) == 4) {
          v[c * V + h] = __uint_as_float(w[h]);
        } else {  // little-endian: low half first
          v[c * V + 2 * h] = __uint_as_float(w[h] << 16);
          v[c * V + 2 * h + 1] = __uint_as_float(w[h] & 0xffff0000u);
        }
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const int64_t i = slot_of<T>(base, lane, j);
      v[j] = i < n ? to_f32(x[i]) : 0.f;
    }
  }
}

// out = {amax, scale, 0, 0} (float32 words) then q [n_out]: q[i] =
// quant(x[i]) for i < n, 0 for n <= i < n_out. partials [gridDim.x].
// Launched cooperatively; each warp walks whole groups with a grid stride.
template <typename T>
__global__ void __launch_bounds__(kThreads)
amax_quantize_kernel(const T* __restrict__ x, int64_t n, int64_t n_out,
                     float* __restrict__ partials, uint8_t* __restrict__ out) {
  constexpr int V = 16 / sizeof(T);
  cg::grid_group grid = cg::this_grid();
  const bool vec_in = aligned16(x);
  const int lane = threadIdx.x & 31;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * (kThreads / 32);
  const int64_t warp =
      static_cast<int64_t>(blockIdx.x) * (kThreads / 32) + (threadIdx.x >> 5);
  float v[kVec];

  float m = 0.f;
  for (int64_t g = warp; g * kGroup < n; g += warps) {
    load_group(x, g * kGroup, n, vec_in, lane, v);
#pragma unroll
    for (int j = 0; j < kVec; ++j) m = nan_max(m, fabsf(v[j]));
  }
  m = block_max(m);
  if (threadIdx.x == 0) partials[blockIdx.x] = m;
  grid.sync();

  // every block forms the same amax from all partials (max is exact, so
  // the order does not matter)
  float a = 0.f;
  for (int b = threadIdx.x; b < static_cast<int>(gridDim.x); b += kThreads)
    a = nan_max(a, __ldcg(partials + b));
  a = block_max(a);
  const float s = scale_of(a);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    float* head = reinterpret_cast<float*>(out);
    head[0] = a;
    head[1] = s;
    head[2] = 0.f;
    head[3] = 0.f;
  }

  int8_t* q = reinterpret_cast<int8_t*>(out + kHeader);
  const bool vec_out = aligned16(q);
  for (int64_t g = warp; g * kGroup < n_out; g += warps) {
    const int64_t base = g * kGroup;
    load_group(x, base, n, vec_in, lane, v);
    int8_t r[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j)
      r[j] = slot_of<T>(base, lane, j) < n ? quant1(v[j], s) : int8_t(0);
    if (vec_out && base + kGroup <= n_out) {
#pragma unroll
      for (int c = 0; c < kVec / V; ++c) {
        uint32_t w[V / 4];
#pragma unroll
        for (int h = 0; h < V / 4; ++h) {
          const int8_t* b = r + c * V + 4 * h;
          w[h] = 0u;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            w[h] |= static_cast<uint32_t>(static_cast<uint8_t>(b[e]))
                    << (8 * e);
        }
        int8_t* dst = q + base + c * 32 * V + lane * V;
        if constexpr (V == 4) {
          *reinterpret_cast<uint32_t*>(dst) = w[0];
        } else {
          *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const int64_t i = slot_of<T>(base, lane, j);
        if (i < n_out) q[i] = r[j];
      }
    }
  }
}

// out [n] float32 = float(q) * s. A warp's group is 512 elements: each lane
// loads 16 int8 in one 16-byte load, and four shuffle rounds hand every
// lane the 4 bytes of the float4 it stores, so the warp's loads and its
// float4 stores each cover one contiguous span.
__global__ void __launch_bounds__(kThreads)
dequantize_kernel(const int8_t* __restrict__ q, int64_t n, float s,
                  float* __restrict__ out) {
  const bool vec = aligned16(q) && aligned16(out);
  const int lane = threadIdx.x & 31;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * (kThreads / 32);
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * (kThreads / 32) +
                   (threadIdx.x >> 5);
       g * kGroup < n; g += warps) {
    const int64_t base = g * kGroup;
    if (vec && base + kGroup <= n) {
      const uint4 raw = *reinterpret_cast<const uint4*>(q + base + 16 * lane);
      const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // elements base + 128 j + 4 lane .. + 3 are word (lane & 3) of
        // lane 8 j + lane / 4
        const int src = 8 * j + (lane >> 2);
        uint32_t mine = 0;
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const uint32_t got = __shfl_sync(kFull, w[h], src);
          if ((lane & 3) == h) mine = got;
        }
        float f[4];
#pragma unroll
        for (int h = 0; h < 4; ++h)
          f[h] = static_cast<float>(
                     static_cast<int8_t>((mine >> (8 * h)) & 0xffu)) * s;
        *reinterpret_cast<float4*>(out + base + 128 * j + 4 * lane) =
            make_float4(f[0], f[1], f[2], f[3]);
      }
    } else {
      for (int j = 0; j < kVec; ++j) {
        const int64_t i = base + 32 * j + lane;
        if (i < n) out[i] = static_cast<float>(q[i]) * s;
      }
    }
  }
}

// blocks for `n` elements, one warp group each, at most `cap`
int blocks_for(int64_t n, int64_t cap) {
  const int64_t groups = (n + kGroup - 1) / kGroup;
  const int64_t want = (groups + kThreads / 32 - 1) / (kThreads / 32);
  return static_cast<int>(want < 1 ? 1 : (want > cap ? cap : want));
}

template <typename T>
int coresident_blocks() {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, amax_quantize_kernel<T>, kThreads, 0);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return per_sm * sms;
}

template <typename T>
int launch_amax_quantize(const void* x, int64_t n, int64_t n_out,
                         float* partials, int grid, uint8_t* out,
                         cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  void* args[] = {&xt, &n, &n_out, &partials, &out};
  cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(amax_quantize_kernel<T>), dim3(grid),
      dim3(kThreads), args, 0, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The most blocks of the amax/quantize kernel that the current device holds
// at once (occupancy x SMs); the launch's grid must not exceed it. A
// negative value is a cudaError_t.
int slt_q8_coresident_blocks(int is_bf16) {
  return is_bf16 ? coresident_blocks<__nv_bfloat16>()
                 : coresident_blocks<float>();
}

// The grid of slt_q8_amax_quantize for n_out outputs, under `cap` blocks
// (slt_q8_coresident_blocks); the caller allocates that many partials.
int slt_q8_amax_quantize_grid(int64_t n, int64_t n_out, int cap) {
  return blocks_for(n > n_out ? n : n_out, cap);
}

// x [n] (float32 if is_bf16 == 0, else bfloat16) -> out [16 + n_out]:
// float32 {amax, scale, 0, 0}, then q [n_out] (zeros past n). One
// cooperative launch; returns its cudaError_t.
int slt_q8_amax_quantize(const void* x, int64_t n, int64_t n_out,
                         int is_bf16, float* partials, int grid, uint8_t* out,
                         cudaStream_t stream) {
  if (n_out < n || grid < 1) return static_cast<int>(cudaErrorInvalidValue);
  return is_bf16 ? launch_amax_quantize<__nv_bfloat16>(
                       x, n, n_out, partials, grid, out, stream)
                 : launch_amax_quantize<float>(x, n, n_out, partials, grid,
                                               out, stream);
}

// out [n] float32 = float(q) * scale.
int slt_q8_dequantize(const int8_t* q, int64_t n, float scale, float* out,
                      cudaStream_t stream) {
  if (n == 0) return 0;
  dequantize_kernel<<<blocks_for(n, 132 * 16), kThreads, 0, stream>>>(
      q, n, scale, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
