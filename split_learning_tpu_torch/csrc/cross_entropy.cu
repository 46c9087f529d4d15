// Fused softmax cross-entropy (mean over rows, integer labels), forward and
// backward, for Hopper (sm_90a).
//
// Replaces the Pallas kernels of split_learning_tpu/ops/cross_entropy.py:
//   forward  _fwd_kernel / _fwd_grid_kernel  (pallas_call at :154, :171)
//   backward _bwd_kernel / _bwd_grid_kernel  (pallas_call at :206, :218)
//
// What bounds it on this card: bytes. The forward reads the [N, C] logits,
// the labels, and writes N floats of row log-sum-exp; the backward reads
// them again and writes the [N, C] gradient. At the LM's [65536, 256]
// float32 logits that is 67.9 MB (0.0203 ms at 3.35 TB/s) and 135 MB
// (0.0403 ms); at the CNN's [64, 10] a few kilobytes, where one launch is
// the whole cost.
//
// Forward: one launch, each logit read once.
// - A row belongs to a group of kLanes lanes of one warp (1 to 32, a power
//   of two picked from C so that each lane issues about one batch of loads
//   of the row): at C = 10 four lanes share a row and a warp holds eight
//   rows; at C = 256 sixteen lanes hold one row each.
// - Loads are 16 bytes (4 float32 or 8 bf16) where the row starts on a
//   16-byte boundary for every row (an aligned base and C a multiple of the
//   width), else one element; a lane issues a batch of them (16 elements)
//   before it computes.
// - Each lane keeps a running (m, s) = (max, sum of exp(x - m)) over its
//   elements and rescales s when m grows, so there is no second pass over
//   the row. The group then takes the row max by a shuffle butterfly, and
//   each lane rescales its s to it once before a second butterfly sums
//   them. Exponents shift by safe(m), 0 while m = -inf, so a lane that has
//   seen only -inf (s = 0) never computes exp(-inf - -inf) = NaN; a NaN or
//   +inf logit still makes its row NaN (see safe()).
// - The instructions per element, not the bytes, set the forward's pace at
//   first: bf16 logits, half the bytes, ran as long as float32. So the max
//   is fmaxf, the exponent exp2f(d log2 e) (exp_), and a row's lanes
//   exchange two floats a level with one rescale in all, where a merge of
//   (m, s) pairs at each level would cost two exponentials a level.
// - One block per 256 / kLanes rows (up to kFwdMaxBlocks, then each block
//   loops). On the H100 a grid of only the resident blocks, each looping
//   over rows so that the end-of-block reduction is paid once, ran the
//   float32 LM shape no faster (bf16 7% faster), and it needs an
//   occupancy query; PERF.md has the numbers.
// - Each block writes its partial sum of row losses into a per-stream
//   scratch; the last block to arrive (an arrival counter that it resets to
//   0) sums the partials in a fixed tree over block index and writes
//   loss = sum / N. A grid of one block writes the loss itself. Every sum
//   runs in an order fixed by N, C, the dtype and the alignment, with no
//   float atomics, so a loss is the same bits run to run.
//
// Backward: one launch, organised by rows as the forward. A group loads its
// row's lse and label once, g / N once a thread, then streams the row with
// the forward's 16-byte loads and stores, a batch of loads in flight before
// the first store; one block per row group. Element offsets are row * C + j in 64-bit, with no division:
// vocab 50,257 x 65,536 rows is past 2^31 elements.
//
// Against the TPU version: the TPU forward saves the [Bp, Cp] float32
// softmax for its backward (ops/cross_entropy.py:154-190). Here the forward
// saves only the row LSE (N floats) and the backward recomputes
// p = exp(x - lse) from the logits: the logits must be read by the backward
// anyway, and writing then re-reading a float32 softmax would move 2 x 4
// bytes an element more (four times the logits' bytes in bf16). The TPU
// kernels also pad C to 128 lanes and tile rows for VMEM; here any N and C
// run unpadded.
//
// Scratch: kScratchWords 32-bit words, word 0 the arrival counter (zero
// between launches), then one float partial per block. The wrapper keeps
// one scratch per device and stream; two forwards on one scratch must not
// run at once, so launch each stream's forwards on that stream only.
//
// Math (float32 throughout, logits float32 or bfloat16):
//   m = max_j x_j,  s = sum_j exp(x_j - m),  lse = m + log s
//   row loss = log s - (x_y - m);  loss = sum(row loss) / N
//   grad_ij = (exp(x_ij - lse_i) - [j == y_i]) * (g / N),  in the logits dtype
// A label outside [0, C) makes its row loss NaN; no memory outside the row
// is read for it. The build's --fmad=false keeps each product and sum one
// rounding, as the plain PyTorch version rounds them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kFwdMaxBlocks = 4096;  // forward grid cap: the partial slots
constexpr int kScratchWords = 1 + kFwdMaxBlocks;
constexpr unsigned kFull = 0xffffffffu;

// 16-byte loads and stores (4 float32 or 8 bf16), or one element. A lane
// issues kBatch loads (16 elements) of a row before it computes on them.
template <typename T, bool kVec>
struct Io;

template <>
struct Io<float, true> {
  static constexpr int W = 4, kBatch = 4;
  static __device__ void load(const float* p, float (&v)[W]) {
    const float4 r = *reinterpret_cast<const float4*>(p);
    v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
  }
  static __device__ void store(float* p, const float (&v)[W]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Io<__nv_bfloat16, true> {
  static constexpr int W = 8, kBatch = 2;
  static __device__ void load(const __nv_bfloat16* p, float (&v)[W]) {
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      v[2 * k] = f.x;
      v[2 * k + 1] = f.y;
    }
  }
  static __device__ void store(__nv_bfloat16* p, const float (&v)[W]) {
    uint4 r;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    *reinterpret_cast<uint4*>(p) = r;
  }
};

template <>
struct Io<float, false> {
  static constexpr int W = 1, kBatch = 4;
  static __device__ void load(const float* p, float (&v)[W]) { v[0] = *p; }
  static __device__ void store(float* p, const float (&v)[W]) { *p = v[0]; }
};

template <>
struct Io<__nv_bfloat16, false> {
  static constexpr int W = 1, kBatch = 4;
  static __device__ void load(const __nv_bfloat16* p, float (&v)[W]) {
    v[0] = __bfloat162float(*p);
  }
  static __device__ void store(__nv_bfloat16* p, const float (&v)[W]) {
    *p = __float2bfloat16(v[0]);
  }
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

constexpr float kLog2e = 1.4426950408889634f;

// exp(d) as 2^(d log2 e): one multiply and exp2f (the hardware's ex2 with
// its range fix-ups), a third of expf's instructions. Its relative error,
// a few ulps for the d near 0 that carry the sums, grows as |d| x 6e-8,
// where exp(d) no longer counts. exp(-inf) = 0 and exp(NaN) = NaN.
__device__ __forceinline__ float exp_(float d) { return exp2f(d * kLog2e); }

// The shift that the exponents use for a running max m: m itself, or 0
// while m = -inf (nothing but -inf so far), so that no exponent is
// exp(-inf - -inf) = NaN. A NaN logit is dropped by fmaxf but reaches the
// sum as exp(NaN) = NaN; a +inf one makes the shift +inf and its own
// exponent exp(inf - inf) = NaN: either way the row is NaN.
__device__ __forceinline__ float safe(float m) {
  return m == -INFINITY ? 0.f : m;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Sum of v over the block in a fixed order: each warp's butterfly, then the
// warps in index order. The result is valid in thread 0.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float part[kThreads / 32];
  v = warp_sum(v);
  __syncthreads();  // an earlier call's readers are done
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < kThreads / 32; ++w) t += part[w];
  return t;
}

// Every block calls this once, after its global stores; true in the last
// block to arrive, which then sees them all. Resets the counter to 0.
__device__ __forceinline__ bool arrive_last(uint32_t* counter) {
  __shared__ bool is_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const uint32_t ticket = atomicAdd(counter, 1u);
    is_last = ticket == gridDim.x - 1;
    if (is_last) atomicExch(counter, 0u);
  }
  __syncthreads();
  if (is_last) __threadfence();
  return is_last;
}

template <typename T, bool kVec, int kLanes>
__global__ void __launch_bounds__(kThreads)
ce_fwd_kernel(const T* __restrict__ logits, const int64_t* __restrict__ labels,
              float* __restrict__ lse, float* __restrict__ loss,
              uint32_t* __restrict__ scratch, int n, int c) {
  using IO = Io<T, kVec>;
  constexpr int W = IO::W, kBatch = IO::kBatch;
  constexpr int kRows = kThreads / kLanes;  // rows a block holds at once
  const int lane = threadIdx.x % kLanes;
  const int units = c / W;                  // loads per row
  float acc = 0.f;  // sum of this thread's row losses (group leaders only)
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * kRows; base < n;
       base += static_cast<int64_t>(gridDim.x) * kRows) {
    const int64_t row = base + threadIdx.x / kLanes;
    const bool live = row < n;
    const T* x = logits + (live ? row : 0) * c;
    const int64_t y = (live && lane == 0) ? labels[row] : -1;
    float m = -INFINITY, s = 0.f;
    for (int u0 = lane; live && u0 < units; u0 += kLanes * kBatch) {
      float v[kBatch][W];
#pragma unroll
      for (int b = 0; b < kBatch; ++b)
        if (u0 + b * kLanes < units) IO::load(x + (u0 + b * kLanes) * W, v[b]);
      float mn = m;
#pragma unroll
      for (int b = 0; b < kBatch; ++b)
        if (u0 + b * kLanes < units)
#pragma unroll
          for (int k = 0; k < W; ++k) mn = fmaxf(mn, v[b][k]);
      const float shift = safe(mn);
      float sb = 0.f;
#pragma unroll
      for (int b = 0; b < kBatch; ++b)
        if (u0 + b * kLanes < units)
#pragma unroll
          for (int k = 0; k < W; ++k) sb += exp_(v[b][k] - shift);
      s = s * exp_(m - shift) + sb;
      m = mn;
    }
    // the row: its max over the group, then each lane's sum rescaled to it
    float mr = m;
#pragma unroll
    for (int o = kLanes / 2; o > 0; o >>= 1)
      mr = fmaxf(mr, __shfl_xor_sync(kFull, mr, o));
    float sr = s * exp_(m - safe(mr));
#pragma unroll
    for (int o = kLanes / 2; o > 0; o >>= 1)
      sr += __shfl_xor_sync(kFull, sr, o);
    if (live && lane == 0) {
      const float log_s = logf(sr);
      lse[row] = mr + log_s;
      acc += (y >= 0 && y < c) ? log_s - (to_f32(x[y]) - mr) : NAN;
    }
  }
  const float block_loss = block_sum(acc);
  if (gridDim.x == 1) {  // the partial is the sum: no scratch round trip
    if (threadIdx.x == 0) *loss = block_loss / static_cast<float>(n);
    return;
  }
  float* partials = reinterpret_cast<float*>(scratch + 1);
  if (threadIdx.x == 0) partials[blockIdx.x] = block_loss;
  if (arrive_last(scratch)) {
    float t = 0.f;
    for (int i = threadIdx.x; i < static_cast<int>(gridDim.x); i += kThreads)
      t += __ldcg(&partials[i]);
    t = block_sum(t);
    if (threadIdx.x == 0) *loss = t / static_cast<float>(n);
  }
}

template <typename T, bool kVec, int kLanes>
__global__ void __launch_bounds__(kThreads)
ce_bwd_kernel(const T* __restrict__ logits, const int64_t* __restrict__ labels,
              const float* __restrict__ lse, const float* __restrict__ g,
              T* __restrict__ grad, int n, int c) {
  using IO = Io<T, kVec>;
  constexpr int W = IO::W, kBatch = IO::kBatch;
  constexpr int kRows = kThreads / kLanes;
  const int lane = threadIdx.x % kLanes;
  const int units = c / W;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kRows + threadIdx.x / kLanes;
  if (row >= n) return;
  const float scale = *g / static_cast<float>(n);
  const T* x = logits + row * c;
  T* d = grad + row * c;
  const float l = lse[row];
  const int64_t y = labels[row];
  for (int u0 = lane; u0 < units; u0 += kLanes * kBatch) {
    float v[kBatch][W];
#pragma unroll
    for (int b = 0; b < kBatch; ++b)
      if (u0 + b * kLanes < units) IO::load(x + (u0 + b * kLanes) * W, v[b]);
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int j0 = (u0 + b * kLanes) * W;
      if (u0 + b * kLanes < units) {
#pragma unroll
        for (int k = 0; k < W; ++k)
          v[b][k] = (exp_(v[b][k] - l) - (j0 + k == y ? 1.f : 0.f)) * scale;
        IO::store(d + j0, v[b]);
      }
    }
  }
}

// Lanes a row: the power of two (at most 32) that gives each lane about
// one batch of loads of the row.
int lanes_for(int units, int batch) {
  const int want = (units + batch - 1) / batch;
  int lanes = 1;
  while (lanes < want && lanes < 32) lanes <<= 1;
  return lanes;
}

int blocks_for(int64_t rows, int per_block, int cap) {
  const int64_t b = (rows + per_block - 1) / per_block;
  return static_cast<int>(b < 1 ? 1 : (b < cap ? b : cap));
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// Calls launch(std::integral_constant<int, lanes>) for lanes_for(...).
template <typename Launch>
int by_lanes(int units, int batch, Launch launch) {
  switch (lanes_for(units, batch)) {
    case 1: return launch(std::integral_constant<int, 1>{});
    case 2: return launch(std::integral_constant<int, 2>{});
    case 4: return launch(std::integral_constant<int, 4>{});
    case 8: return launch(std::integral_constant<int, 8>{});
    case 16: return launch(std::integral_constant<int, 16>{});
    default: return launch(std::integral_constant<int, 32>{});
  }
}

template <typename T, bool kVec>
int fwd(const void* logits, const int64_t* labels, float* lse,
        uint32_t* scratch, float* loss, int n, int c, cudaStream_t stream) {
  return by_lanes(c / Io<T, kVec>::W, Io<T, kVec>::kBatch, [&](auto lanes) {
    constexpr int kLanes = decltype(lanes)::value;
    ce_fwd_kernel<T, kVec, kLanes>
        <<<blocks_for(n, kThreads / kLanes, kFwdMaxBlocks), kThreads, 0,
           stream>>>(static_cast<const T*>(logits), labels, lse, loss,
                     scratch, n, c);
    return static_cast<int>(cudaGetLastError());
  });
}

template <typename T, bool kVec>
int bwd(const void* logits, const int64_t* labels, const float* lse,
        const float* g, void* grad, int n, int c, cudaStream_t stream) {
  return by_lanes(c / Io<T, kVec>::W, Io<T, kVec>::kBatch, [&](auto lanes) {
    constexpr int kLanes = decltype(lanes)::value;
    // one block per row group: n < 2^31 rows need fewer than 2^28
    ce_bwd_kernel<T, kVec, kLanes>
        <<<(n + kThreads / kLanes - 1) / (kThreads / kLanes), kThreads, 0,
           stream>>>(static_cast<const T*>(logits), labels, lse, g,
                     static_cast<T*>(grad), n, c);
    return static_cast<int>(cudaGetLastError());
  });
}

// 16-byte loads when every row starts on a 16-byte boundary
template <typename T>
bool vec_rows(int c, const void* a, const void* b) {
  return aligned16(a) && aligned16(b) && (c * sizeof(T)) % 16 == 0;
}

}  // namespace

extern "C" {

// 32-bit words of the forward's scratch; the caller zeroes it once and
// every launch leaves it zeroed.
int slt_ce_scratch_words() { return kScratchWords; }

// logits [n, c] (float32 if is_bf16 == 0, else bfloat16), labels [n] int64.
// Writes lse [n] and the scalar loss in one launch; scratch as above.
// Returns cudaGetLastError() after the launch.
int slt_ce_fwd(const void* logits, const int64_t* labels, float* lse,
               uint32_t* scratch, float* loss, int n, int c, int is_bf16,
               cudaStream_t stream) {
  if (n < 1 || c < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (is_bf16) {
    return vec_rows<__nv_bfloat16>(c, logits, logits)
               ? fwd<__nv_bfloat16, true>(logits, labels, lse, scratch, loss,
                                          n, c, stream)
               : fwd<__nv_bfloat16, false>(logits, labels, lse, scratch, loss,
                                           n, c, stream);
  }
  return vec_rows<float>(c, logits, logits)
             ? fwd<float, true>(logits, labels, lse, scratch, loss, n, c,
                                stream)
             : fwd<float, false>(logits, labels, lse, scratch, loss, n, c,
                                 stream);
}

// grad [n, c] in the logits dtype; g is a float32 scalar on the device.
int slt_ce_bwd(const void* logits, const int64_t* labels, const float* lse,
               const float* g, void* grad, int n, int c, int is_bf16,
               cudaStream_t stream) {
  if (n < 1 || c < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (is_bf16) {
    return vec_rows<__nv_bfloat16>(c, logits, grad)
               ? bwd<__nv_bfloat16, true>(logits, labels, lse, g, grad, n, c,
                                          stream)
               : bwd<__nv_bfloat16, false>(logits, labels, lse, g, grad, n, c,
                                           stream);
  }
  return vec_rows<float>(c, logits, grad)
             ? bwd<float, true>(logits, labels, lse, g, grad, n, c, stream)
             : bwd<float, false>(logits, labels, lse, g, grad, n, c, stream);
}

}  // extern "C"
