// Multi-tensor fused SGD / momentum-SGD update, in place, for Hopper (sm_90a).
//
// Replaces split_learning_tpu/ops/sgd.py: fused_sgd_step -> _update_leaf ->
// _sgd_kernel / _sgd_mom_kernel (pallas_call at :109, :122).
//
// Semantics (optax.sgd, zero-initialised trace):
//   no momentum:  p <- p - lr * g
//   momentum mu:  m <- mu * m + g;  p <- p - lr * m
//
// What bounds it on this card: bytes. Each parameter is read and written
// once, its gradient read once (and its trace read and written once with
// momentum): 12 or 20 bytes per float32 parameter, about 1.3 MB or 2.2 MB
// for the split CNN's 110,986 parameters, which the card moves in well under
// a microsecond. The kernel is bound by launch latency at that size.
//
// Design, against the TPU version:
// - The TPU makes one pallas_call per leaf (six per step for the CNN), each
//   on a [rows, 128] padded copy, and returns new arrays. Here one launch
//   updates every leaf in place: the leaves' pointers and sizes travel by
//   value in a descriptor table, and each block finds its (leaf, chunk) from
//   a prefix sum of blocks per leaf. No padding, no copies.
// - Loads and stores are float4 where a leaf's pointers are 16-byte aligned
//   (PyTorch's allocator aligns every tensor it allocates), with a scalar
//   tail for sizes that are not a multiple of 4.
// - Rounding: the build passes --fmad=false, so lr * g is rounded before the
//   subtraction and mu * m before the addition, exactly as the plain PyTorch
//   version (p.sub_(lr * g); m.mul_(mu).add_(g)) rounds them. The kernel is
//   therefore bit-identical to the plain version. With FMA contraction it
//   would differ from it by up to one ulp per step.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLeaves = 24;   // leaves per launch; the caller batches more
constexpr int kThreads = 256;
constexpr int kChunk = 2048;     // elements per block (2 float4 per thread)

struct LeafTable {
  float* p[kMaxLeaves];
  const float* g[kMaxLeaves];
  float* m[kMaxLeaves];          // null without momentum
  int64_t numel[kMaxLeaves];
  int block_start[kMaxLeaves + 1];  // prefix sum of blocks per leaf
  int n_leaves;
};

__device__ __forceinline__ float upd_plain(float p, float g, float lr) {
  return p - lr * g;
}

__global__ void __launch_bounds__(kThreads)
sgd_kernel(const LeafTable t, float lr, float mu) {
  int leaf = 0;
  while (leaf + 1 < t.n_leaves && blockIdx.x >= t.block_start[leaf + 1]) ++leaf;
  const int64_t begin =
      static_cast<int64_t>(blockIdx.x - t.block_start[leaf]) * kChunk;
  const int64_t n = t.numel[leaf];
  const int64_t end = begin + kChunk < n ? begin + kChunk : n;
  float* __restrict__ p = t.p[leaf];
  const float* __restrict__ g = t.g[leaf];
  float* __restrict__ m = t.m[leaf];

  const bool aligned =
      ((reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(g) |
        reinterpret_cast<uintptr_t>(m)) & 15u) == 0;
  int64_t i = begin + threadIdx.x * 4;
  if (aligned) {
    // begin is a multiple of kChunk, so begin + 4k stays 16-byte aligned
    for (; i + 3 < end; i += kThreads * 4) {
      float4 pv = *reinterpret_cast<float4*>(p + i);
      const float4 gv = *reinterpret_cast<const float4*>(g + i);
      if (m != nullptr) {
        float4 mv = *reinterpret_cast<float4*>(m + i);
        mv.x = mu * mv.x + gv.x;
        mv.y = mu * mv.y + gv.y;
        mv.z = mu * mv.z + gv.z;
        mv.w = mu * mv.w + gv.w;
        *reinterpret_cast<float4*>(m + i) = mv;
        pv.x = upd_plain(pv.x, mv.x, lr);
        pv.y = upd_plain(pv.y, mv.y, lr);
        pv.z = upd_plain(pv.z, mv.z, lr);
        pv.w = upd_plain(pv.w, mv.w, lr);
      } else {
        pv.x = upd_plain(pv.x, gv.x, lr);
        pv.y = upd_plain(pv.y, gv.y, lr);
        pv.z = upd_plain(pv.z, gv.z, lr);
        pv.w = upd_plain(pv.w, gv.w, lr);
      }
      *reinterpret_cast<float4*>(p + i) = pv;
    }
    // the ragged tail (< 4 elements) of the leaf's last chunk
    if (i < end) {
      for (int64_t j = i; j < end; ++j) {
        float d = g[j];
        if (m != nullptr) {
          d = mu * m[j] + d;
          m[j] = d;
        }
        p[j] = upd_plain(p[j], d, lr);
      }
    }
  } else {
    for (int64_t j = begin + threadIdx.x; j < end; j += kThreads) {
      float d = g[j];
      if (m != nullptr) {
        d = mu * m[j] + d;
        m[j] = d;
      }
      p[j] = upd_plain(p[j], d, lr);
    }
  }
}

}  // namespace

extern "C" {

int slt_sgd_max_leaves() { return kMaxLeaves; }

// p, g, m: host arrays of n_leaves device pointers (m may be null, or hold
// nulls, when mu == 0); numel: host array of element counts. Launches one
// kernel over all leaves and returns cudaGetLastError().
int slt_sgd_step(int n_leaves, void* const* p, void* const* g, void* const* m,
                 const int64_t* numel, float lr, float mu,
                 cudaStream_t stream) {
  if (n_leaves < 1 || n_leaves > kMaxLeaves)
    return static_cast<int>(cudaErrorInvalidValue);
  LeafTable t;
  t.n_leaves = n_leaves;
  int blocks = 0;
  for (int k = 0; k < n_leaves; ++k) {
    t.p[k] = static_cast<float*>(p[k]);
    t.g[k] = static_cast<const float*>(g[k]);
    t.m[k] = (m != nullptr && mu != 0.f) ? static_cast<float*>(m[k]) : nullptr;
    t.numel[k] = numel[k];
    t.block_start[k] = blocks;
    blocks += static_cast<int>((numel[k] + kChunk - 1) / kChunk);
  }
  t.block_start[n_leaves] = blocks;
  if (blocks == 0) return 0;
  sgd_kernel<<<blocks, kThreads, 0, stream>>>(t, lr, mu);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
