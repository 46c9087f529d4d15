// Multi-tensor fused SGD / momentum-SGD update, in place, for Hopper (sm_90a).
//
// Replaces split_learning_tpu/ops/sgd.py: fused_sgd_step -> _update_leaf ->
// _sgd_kernel / _sgd_mom_kernel (pallas_call at :109, :122).
//
// Semantics (optax.sgd, zero-initialised trace):
//   no momentum:  p <- p - lr * g
//   momentum mu:  m <- mu * m + g;  p <- p - lr * m
// Leaves are float32 or bfloat16, mixed in one launch. As the JAX kernel
// does (it casts a bf16 leaf and its gradient to float32 and the result
// back), a bf16 leaf is read and widened, updated in float32 against a
// float32 trace, and stored rounded to nearest even (__float2bfloat16_rn).
//
// What bounds it on this card: bytes. Each parameter is read and written
// once, its gradient read once (and its trace read and written once with
// momentum): 12 or 20 bytes per float32 parameter, 6 or 14 per bf16 one.
// The split CNN's 110,986 parameters take 0.4 us at 3.35 TB/s, so one
// launch is the whole cost; the LM's 3,025,408 at momentum 0.9 take 18.1 us
// in float32, and 17.1 us in bf16, where only the 524,288-element pos
// table is bf16.
//
// Design, against the TPU version:
// - The TPU makes one pallas_call per leaf (six per step for the CNN), each
//   on a [rows, 128] padded copy, and returns new arrays. Here one launch
//   updates every leaf in place: the leaves' pointers and sizes travel by
//   value as the kernel's parameter (a __grid_constant__ table), and each
//   block finds its (leaf, chunk) by a binary search of the prefix sum of
//   blocks per leaf. No padding, no copies, no table in device memory.
// - A leaf's dtype rides in the top bit of its element count (kBf16Flag),
//   so the table keeps its size and still holds kMaxLeaves leaves. Every
//   block belongs to one leaf, so the dtype branch is uniform per block.
// - The table is a template on its capacity: 8, 64 or kMaxLeaves leaves,
//   the smallest that holds the call's leaves, so that the launch carries
//   no more parameter bytes than it needs. kMaxLeaves fills the 32,764
//   bytes of kernel parameters that CUDA 12.1 and later allow; the CNN's 6
//   leaves, the LM's 54 and a few hundred all take one launch.
// - A block is kThreads threads of four elements each (one 16-byte access
//   of a float32 leaf, one 8-byte access of a bf16 leaf): 512 elements,
//   so the CNN's six leaves spread over 220 blocks on the 132 SMs. Each
//   thread issues its loads (p, g and m) before any store. Where a leaf's
//   pointers are not aligned to their vector width (16 bytes for float32
//   and for the trace, 8 bytes for bf16) the block takes one element a
//   thread, four times, loads first as well; a chunk's ragged end (fewer
//   than 4 elements) goes one element at a time.
// - Rounding: the build passes --fmad=false, so lr * g is rounded before the
//   subtraction and mu * m before the addition, exactly as the plain PyTorch
//   version (p.sub_(lr * g); m.mul_(mu).add_(g)) rounds them. The kernel is
//   therefore bit-identical to the plain version. With FMA contraction it
//   would differ from it by up to one ulp per step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = kThreads * 4;  // elements a block: four a thread
constexpr int kMaxLeaves = 896;
constexpr uint64_t kBf16Flag = 1ull << 63;  // in LeafTable::meta

template <int kCap>
struct LeafTable {
  void* p[kCap];
  const void* g[kCap];
  float* m[kCap];                // null without momentum
  uint64_t meta[kCap];           // element count | kBf16Flag for bf16
  int block_start[kCap + 1];     // prefix sum of blocks per leaf
  int n_leaves;
};

static_assert(sizeof(LeafTable<kMaxLeaves>) + 2 * sizeof(float) <= 32764,
              "the leaf table must fit the kernel parameter space");

// one element type's loads and stores, widened to float
template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr uintptr_t kVecMask = 15;
  static __device__ __forceinline__ float load(const void* b, int64_t j) {
    return static_cast<const float*>(b)[j];
  }
  static __device__ __forceinline__ void store(void* b, int64_t j, float v) {
    static_cast<float*>(b)[j] = v;
  }
  static __device__ __forceinline__ float4 load4(const void* b, int64_t i) {
    return *reinterpret_cast<const float4*>(static_cast<const float*>(b) + i);
  }
  static __device__ __forceinline__ void store4(void* b, int64_t i, float4 v) {
    *reinterpret_cast<float4*>(static_cast<float*>(b) + i) = v;
  }
};

template <>
struct Elem<__nv_bfloat16> {
  static constexpr uintptr_t kVecMask = 7;
  static __device__ __forceinline__ float load(const void* b, int64_t j) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(b)[j]);
  }
  static __device__ __forceinline__ void store(void* b, int64_t j, float v) {
    static_cast<__nv_bfloat16*>(b)[j] = __float2bfloat16_rn(v);
  }
  static __device__ __forceinline__ float4 load4(const void* b, int64_t i) {
    const uint2 raw = *reinterpret_cast<const uint2*>(
        static_cast<const __nv_bfloat16*>(b) + i);
    const float2 lo = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 hi = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    return make_float4(lo.x, lo.y, hi.x, hi.y);
  }
  static __device__ __forceinline__ void store4(void* b, int64_t i, float4 v) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
    uint2 raw;
    raw.x = *reinterpret_cast<const unsigned int*>(&lo);
    raw.y = *reinterpret_cast<const unsigned int*>(&hi);
    *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(b) + i) = raw;
  }
};

__device__ __forceinline__ float upd(float p, float d, float lr) {
  return p - lr * d;
}

// elements [begin, end) of one leaf of element type T
template <typename T>
__device__ __forceinline__ void update_chunk(void* __restrict__ p,
                                             const void* __restrict__ g,
                                             float* __restrict__ m,
                                             int64_t begin, int64_t end,
                                             float lr, float mu) {
  using E = Elem<T>;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(g)) &
       E::kVecMask) == 0 && (reinterpret_cast<uintptr_t>(m) & 15u) == 0;
  if (aligned) {
    // begin is a multiple of kChunk, so begin + 4 * thread stays aligned
    const int64_t i = begin + threadIdx.x * 4;
    if (i + 3 < end) {
      float4 pv = E::load4(p, i);
      float4 dv = E::load4(g, i);
      if (m != nullptr) {
        const float4 mv = *reinterpret_cast<const float4*>(m + i);
        dv.x = mu * mv.x + dv.x;
        dv.y = mu * mv.y + dv.y;
        dv.z = mu * mv.z + dv.z;
        dv.w = mu * mv.w + dv.w;
        *reinterpret_cast<float4*>(m + i) = dv;
      }
      pv.x = upd(pv.x, dv.x, lr);
      pv.y = upd(pv.y, dv.y, lr);
      pv.z = upd(pv.z, dv.z, lr);
      pv.w = upd(pv.w, dv.w, lr);
      E::store4(p, i, pv);
    } else {
      for (int64_t j = i; j < end; ++j) {
        float d = E::load(g, j);
        if (m != nullptr) {
          d = mu * m[j] + d;
          m[j] = d;
        }
        E::store(p, j, upd(E::load(p, j), d, lr));
      }
    }
  } else {
    float pv[4], dv[4], mv[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int64_t j = begin + threadIdx.x + k * kThreads;
      if (j < end) {
        pv[k] = E::load(p, j);
        dv[k] = E::load(g, j);
        if (m != nullptr) mv[k] = m[j];
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int64_t j = begin + threadIdx.x + k * kThreads;
      if (j < end) {
        if (m != nullptr) {
          dv[k] = mu * mv[k] + dv[k];
          m[j] = dv[k];
        }
        E::store(p, j, upd(pv[k], dv[k], lr));
      }
    }
  }
}

template <int kCap>
__global__ void __launch_bounds__(kThreads)
sgd_kernel(const __grid_constant__ LeafTable<kCap> t, float lr, float mu) {
  // the last leaf whose first block is at or before this one
  const int b = blockIdx.x;
  int lo = 0, hi = t.n_leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.block_start[mid] <= b) lo = mid; else hi = mid - 1;
  }
  const int64_t begin = static_cast<int64_t>(b - t.block_start[lo]) * kChunk;
  const uint64_t meta = t.meta[lo];
  const int64_t n = static_cast<int64_t>(meta & ~kBf16Flag);
  const int64_t end = begin + kChunk < n ? begin + kChunk : n;
  if (meta & kBf16Flag)
    update_chunk<__nv_bfloat16>(t.p[lo], t.g[lo], t.m[lo], begin, end, lr, mu);
  else
    update_chunk<float>(t.p[lo], t.g[lo], t.m[lo], begin, end, lr, mu);
}

template <int kCap>
int launch(int n_leaves, void* const* p, void* const* g, void* const* m,
           const int64_t* numel, const uint8_t* bf16, float lr, float mu,
           cudaStream_t stream) {
  LeafTable<kCap> t;
  t.n_leaves = n_leaves;
  int blocks = 0;
  for (int k = 0; k < n_leaves; ++k) {
    t.p[k] = p[k];
    t.g[k] = g[k];
    t.m[k] = (m != nullptr && mu != 0.f) ? static_cast<float*>(m[k]) : nullptr;
    t.meta[k] = static_cast<uint64_t>(numel[k]) | (bf16[k] ? kBf16Flag : 0);
    t.block_start[k] = blocks;
    blocks += static_cast<int>((numel[k] + kChunk - 1) / kChunk);
  }
  t.block_start[n_leaves] = blocks;
  if (blocks == 0) return 0;
  sgd_kernel<kCap><<<blocks, kThreads, 0, stream>>>(t, lr, mu);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int slt_sgd_max_leaves() { return kMaxLeaves; }

// p, g, m: host arrays of n_leaves device pointers (m may be null, or hold
// nulls, when mu == 0; the trace is float32 for every leaf); numel: host
// array of element counts; bf16: host array of flags, 1 where the leaf and
// its gradient are bfloat16, 0 where they are float32. Launches one kernel
// over all leaves and returns cudaGetLastError(). The arrays are read
// before this returns, so the caller may refill them at once.
int slt_sgd_step(int n_leaves, void* const* p, void* const* g, void* const* m,
                 const int64_t* numel, const uint8_t* bf16, float lr, float mu,
                 cudaStream_t stream) {
  if (n_leaves < 1 || n_leaves > kMaxLeaves)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int k = 0; k < n_leaves; ++k)
    if (numel[k] < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n_leaves <= 8)
    return launch<8>(n_leaves, p, g, m, numel, bf16, lr, mu, stream);
  if (n_leaves <= 64)
    return launch<64>(n_leaves, p, g, m, numel, bf16, lr, mu, stream);
  return launch<kMaxLeaves>(n_leaves, p, g, m, numel, bf16, lr, mu, stream);
}

}  // extern "C"
