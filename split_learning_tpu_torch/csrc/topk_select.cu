// The wire codec's whole topk8 encode on the card, for Hopper (sm_90a):
// error-feedback fold, top-k selection by magnitude, int8 quantization of
// the survivors, the new residual and the position map, in five launches.
//
// Replaces, on the wire codec's device path, what ran around the Pallas
// magnitude kernel of split_learning_tpu/ops/topk.py (_mag_kernel via
// magnitudes, pallas_call at :47, :58; csrc/topk.cu keeps that kernel for
// magnitudes()): lax.top_k and the codec's host selection
// (split_learning_tpu/transport/codec.py:193-276). It computes what the
// host codec computes, byte for byte:
//   x_eff = x + float32(decay) * res           (res absent: x_eff = x)
//   k survivors: every |x_eff| above the k-th largest, then the ties in
//                ascending index order until k; kept in ascending index order
//   scale = (float)max((double)amax / 127, 1e-12),  amax = max |x_eff|
//           (the largest magnitude always survives, so the survivors' amax
//           is the global one and is known after the first pass)
//   q     = clip(rint(x_eff / scale), -127, 127) at the survivors (IEEE div)
//   res'  = x_eff, minus float(q) * scale at the survivors (two roundings;
//           the library builds with --fmad=false)
//   positions: the np.packbits bitmap (MSB first, zero-padded) when
//           n < 32 k, else the ascending int32 indices
//   flag  = 1 when x holds a NaN or an infinity (the codec refuses it)
//
// Output: one byte buffer the host copies in one piece,
//   [0, 4) flag int32 | [4, 8) amax float32 | [8, 16) zero | q int8 [k] |
//   zero pad to a multiple of 4 | bitmap [ceil(n / 8)] or idx int32 [k]
// and, when wanted, the new residual [n] float32.
//
// What bounds it on this card: bytes. The least it must move is x and the
// residual read once and the new residual written once, 12 bytes an
// element (plus the payload, about 0.2 bytes an element at density 0.1);
// 4.2 without a residual. This design moves about 28 bytes an element: the
// five passes re-read x_eff, which comes back from the 50 MB L2 at the CNN
// cut (1,384,448 values, 5.5 MB) and from device memory at the LM cut.
//
// Design:
// - Keys. |x_eff| is at least +0, so its float bits with the sign cleared
//   sort as the magnitude does (NaN above inf). Selection is on those
//   32-bit keys, never on floats.
// - Radix select of the k-th largest key, digits of 11, 11 and 10 bits. Each
//   pass builds a per-block shared-memory histogram of the digit over the
//   keys that match the prefix chosen so far and adds it into a global one
//   with integer atomics (deterministic). The last block to arrive (an
//   arrival counter, which that block resets) reads and zeroes the
//   histogram, picks the digit's bucket by a suffix scan of the 2048 bins,
//   and carries `remain` (k minus the keys above the bucket) and `count_gt`.
//   After the third pass: the threshold key thr, count_gt = #keys > thr and
//   need = k - count_gt. The number of launches is fixed; nothing depends
//   on the data but the values.
// - Pass 1 also folds the residual (writing x_eff into the new residual,
//   which later passes read), takes the amax as an atomicMax of the keys
//   and raises the non-finite flag. Without a residual output, later passes
//   recompute the fold from x (and the old residual).
// - Compaction, reduce then scan: each block owns a contiguous chunk of
//   whole 2048-element tiles; pass 4 counts its keys > thr and == thr and
//   the last block turns the counts into exclusive prefixes. Pass 5 walks
//   the chunk tile by tile with a block scan of the pair of counts: element
//   i survives if key > thr, or key == thr and it is among the first `need`
//   ties; its slot is gt_before + min(ties_before, need). A thread owns 8
//   consecutive elements, so it writes one whole bitmap byte.
// - All scratch state (histograms, counters, the amax and the flag) is
//   zeroed by the block that consumed it, so the next call on the stream
//   starts clean. Every write is bounds-checked against n and k, so NaN
//   keys or any other input cannot write out of bounds.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;                  // consecutive elements a thread
constexpr int kTile = kThreads * kItems;   // elements a block step
constexpr int kBins = 2048;                // 11-bit digits
constexpr int kMaxBlocks = 528;            // 4 a SM on 132 SMs
constexpr int kHeader = 16;
constexpr unsigned kFull = 0xffffffffu;

// scratch, uint32 words; zero between calls
constexpr int kHist = 0;                       // 3 x kBins, one per digit
constexpr int kArrive = 3 * kBins;             // arrival counter
constexpr int kAmaxKey = kArrive + 1;          // atomicMax of the keys
constexpr int kFlag = kArrive + 2;             // x not finite
constexpr int kPrefix = kArrive + 3;           // the digits chosen so far
constexpr int kRemain = kArrive + 4;           // k - keys above the prefix
constexpr int kCountGt = kArrive + 5;          // keys above the prefix
constexpr int kEqTotal = kArrive + 6;          // keys equal to thr
constexpr int kGtBase = kArrive + 8;           // [kMaxBlocks]
constexpr int kEqBase = kGtBase + kMaxBlocks;  // [kMaxBlocks]
constexpr int kScratchWords = kEqBase + kMaxBlocks;

__device__ __forceinline__ int digit_shift(int pass) {
  return pass == 0 ? 21 : (pass == 1 ? 10 : 0);
}

__device__ __forceinline__ uint32_t key_of(float v) {
  return __float_as_uint(v) & 0x7fffffffu;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Ties (keys equal to thr) survive by their rank among the ties in index
// order: the codec keeps the first `need`. How many of the ties of rank
// below r survive.
__device__ __forceinline__ uint32_t ties_before(uint32_t r, uint32_t need,
                                                uint32_t eq_total) {
  (void)eq_total;
  return min(r, need);
}

// x[i0 .. i0 + 8) as float32 (0 past n)
template <typename T>
__device__ __forceinline__ void load8(const T* __restrict__ x, int64_t i0,
                                      int64_t n, float v[kItems]) {
  if (i0 + kItems <= n && aligned16(x)) {
    if constexpr (sizeof(T) == 4) {
      const float4 a = reinterpret_cast<const float4*>(x + i0)[0];
      const float4 b = reinterpret_cast<const float4*>(x + i0)[1];
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
      v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    } else {
      const uint4 a = reinterpret_cast<const uint4*>(x + i0)[0];
      const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int h = 0; h < 4; ++h) {  // little-endian: low half first
        v[2 * h] = __uint_as_float(w[h] << 16);
        v[2 * h + 1] = __uint_as_float(w[h] & 0xffff0000u);
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < kItems; ++j)
      v[j] = i0 + j < n ? to_f32(x[i0 + j]) : 0.f;
  }
}

__device__ __forceinline__ void store8(float* p, int64_t i0, int64_t n,
                                       const float v[kItems]) {
  if (i0 + kItems <= n && aligned16(p)) {
    reinterpret_cast<float4*>(p + i0)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p + i0)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
    for (int j = 0; j < kItems && i0 + j < n; ++j) p[i0 + j] = v[j];
  }
}

// where x_eff comes from: the new residual once pass 1 wrote it, else the
// fold recomputed from x and the old residual
template <typename T>
struct Source {
  const T* x;
  const float* res;   // old residual [n] or null
  float decay;
  const float* eff;   // x_eff [n] (the new residual) or null
  int64_t n;
};

template <typename T>
__device__ __forceinline__ void fold8(const Source<T>& s, int64_t i0,
                                      float v[kItems]) {
  load8(s.x, i0, s.n, v);
  if (s.res != nullptr) {
    float r[kItems];
    load8(s.res, i0, s.n, r);
#pragma unroll
    for (int j = 0; j < kItems; ++j) v[j] = v[j] + s.decay * r[j];
  }
}

template <typename T>
__device__ __forceinline__ void x_eff8(const Source<T>& s, int64_t i0,
                                       float v[kItems]) {
  if (s.eff != nullptr) {
    load8(s.eff, i0, s.n, v);
  } else {
    fold8(s, i0, v);
  }
}

// exclusive prefix sum over the block; `total` is the block's sum
__device__ __forceinline__ uint32_t block_exclusive_scan(uint32_t v,
                                                         uint32_t& total) {
  __shared__ uint32_t warp_sum[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t u = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += u;
  }
  __syncthreads();  // an earlier call's readers are done
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  uint32_t base = 0, tot = 0;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) {
    const uint32_t s = warp_sum[w];
    base += w < warp ? s : 0u;
    tot += s;
  }
  total = tot;
  return base + incl - v;
}

// Every block calls this once, after its global atomics and stores; true in
// the last block to arrive, which then sees them all. Resets the counter.
__device__ __forceinline__ bool arrive_last(uint32_t* scratch) {
  __shared__ bool is_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const uint32_t ticket = atomicAdd(&scratch[kArrive], 1u);
    is_last = ticket == gridDim.x - 1;
    if (is_last) atomicExch(&scratch[kArrive], 0u);
  }
  __syncthreads();
  if (is_last) __threadfence();
  return is_last;
}

__device__ __forceinline__ void zero_hist(uint32_t* hist) {
  for (int b = threadIdx.x; b < kBins; b += kThreads) hist[b] = 0;
  __syncthreads();
}

__device__ __forceinline__ void flush_hist(const uint32_t* hist,
                                           uint32_t* global) {
  __syncthreads();
  for (int b = threadIdx.x; b < kBins; b += kThreads)
    if (hist[b] != 0) atomicAdd(&global[b], hist[b]);
}

// Last block of pass `pass`: read and zero that pass's global histogram,
// find the bucket that holds the remain-th largest key among those that
// match the prefix, and carry the state.
__device__ void select_digit(uint32_t* scratch, int pass, uint32_t k) {
  uint32_t* hist = scratch + kHist + pass * kBins;
  uint32_t h[kBins / kThreads];
  uint32_t sum = 0;
#pragma unroll
  for (int j = 0; j < kBins / kThreads; ++j) {
    h[j] = atomicExch(&hist[threadIdx.x * (kBins / kThreads) + j], 0u);
    sum += h[j];
  }
  const uint32_t remain = pass == 0 ? k : __ldcg(&scratch[kRemain]);
  const uint32_t prefix = pass == 0 ? 0u : __ldcg(&scratch[kPrefix]);
  const uint32_t count_gt = pass == 0 ? 0u : __ldcg(&scratch[kCountGt]);
  uint32_t total;
  const uint32_t before = block_exclusive_scan(sum, total);
  __syncthreads();  // every thread has read the state
  // keys in the bins of higher threads
  uint32_t above = total - before - sum;
  const int bits = pass == 2 ? 10 : 11;
  for (int j = kBins / kThreads - 1; j >= 0; --j) {
    if (above < remain && remain <= above + h[j]) {
      const uint32_t digit = threadIdx.x * (kBins / kThreads) + j;
      scratch[kPrefix] = (prefix << bits) | digit;
      scratch[kRemain] = remain - above;
      scratch[kCountGt] = count_gt + above;
    }
    above += h[j];
  }
}

// Pass 1: fold, digit-0 histogram, amax, flag; the last block writes the
// header and picks digit 0.
template <typename T>
__global__ void __launch_bounds__(kThreads)
fold_hist_kernel(Source<T> src, float* eff_out, int64_t chunk, uint32_t k,
                 int64_t pos_off, uint32_t* __restrict__ scratch,
                 uint8_t* __restrict__ out) {
  __shared__ uint32_t hist[kBins];
  zero_hist(hist);
  const int64_t n = src.n;
  const int64_t lo = static_cast<int64_t>(blockIdx.x) * chunk;
  const int64_t hi = lo + chunk < n ? lo + chunk : n;
  uint32_t kmax = 0;
  bool finite = true;
  for (int64_t t = lo; t < hi; t += kTile) {
    const int64_t i0 = t + threadIdx.x * kItems;
    float v[kItems];
    load8(src.x, i0, n, v);
#pragma unroll
    for (int j = 0; j < kItems; ++j) finite = finite && isfinite(v[j]);
    if (src.res != nullptr) {
      float r[kItems];
      load8(src.res, i0, n, r);
#pragma unroll
      for (int j = 0; j < kItems; ++j) v[j] = v[j] + src.decay * r[j];
    }
    if (eff_out != nullptr) store8(eff_out, i0, n, v);
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      if (i0 + j < n) {
        const uint32_t key = key_of(v[j]);
        kmax = max(kmax, key);
        atomicAdd(&hist[key >> 21], 1u);
      }
    }
  }
  kmax = __reduce_max_sync(kFull, kmax);
  if ((threadIdx.x & 31) == 0 && kmax != 0)
    atomicMax(&scratch[kAmaxKey], kmax);
  if (__syncthreads_or(!finite) && threadIdx.x == 0)
    atomicOr(&scratch[kFlag], 1u);
  flush_hist(hist, scratch + kHist);
  if (!arrive_last(scratch)) return;
  if (threadIdx.x == 0) {
    uint32_t* head = reinterpret_cast<uint32_t*>(out);
    head[0] = atomicExch(&scratch[kFlag], 0u);
    head[1] = atomicExch(&scratch[kAmaxKey], 0u);
    head[2] = 0u;
    head[3] = 0u;
    for (int64_t p = kHeader + k; p < pos_off; ++p) out[p] = 0;
  }
  select_digit(scratch, 0, k);
}

// Passes 2 and 3 (pass 1 and 2): the histogram of digit `pass` over the
// keys whose higher digits equal the prefix; the last block picks the digit.
template <typename T, int pass>
__device__ __forceinline__ void hist_pass(const Source<T>& src, int64_t chunk,
                                          uint32_t* __restrict__ scratch) {
  __shared__ uint32_t hist[kBins];
  zero_hist(hist);
  const uint32_t prefix = __ldcg(&scratch[kPrefix]);
  const int shift = digit_shift(pass), match = digit_shift(pass - 1);
  const uint32_t mask = pass == 2 ? 1023u : 2047u;
  const int64_t n = src.n;
  const int64_t lo = static_cast<int64_t>(blockIdx.x) * chunk;
  const int64_t hi = lo + chunk < n ? lo + chunk : n;
  for (int64_t t = lo; t < hi; t += kTile) {
    const int64_t i0 = t + threadIdx.x * kItems;
    float v[kItems];
    x_eff8(src, i0, v);
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const uint32_t key = key_of(v[j]);
      if (i0 + j < n && (key >> match) == prefix)
        atomicAdd(&hist[(key >> shift) & mask], 1u);
    }
  }
  flush_hist(hist, scratch + kHist + pass * kBins);
  if (arrive_last(scratch)) select_digit(scratch, pass, 0u);
}

// one kernel name per pass, so a profiler tells the launches apart
template <typename T>
__global__ void __launch_bounds__(kThreads)
hist_mid_kernel(Source<T> src, int64_t chunk, uint32_t* __restrict__ scratch) {
  hist_pass<T, 1>(src, chunk, scratch);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
hist_low_kernel(Source<T> src, int64_t chunk, uint32_t* __restrict__ scratch) {
  hist_pass<T, 2>(src, chunk, scratch);
}

// exclusive prefix sums, in place, of the per-block counts at `counts`
// [blocks]; returns the sum (valid in every thread)
__device__ uint32_t scan_counts(uint32_t* counts, int blocks) {
  const int per = (blocks + kThreads - 1) / kThreads;
  const int b0 = threadIdx.x * per;
  uint32_t sum = 0;
  for (int j = 0; j < per && b0 + j < blocks; ++j)
    sum += __ldcg(&counts[b0 + j]);
  uint32_t total;
  uint32_t run = block_exclusive_scan(sum, total);
  for (int j = 0; j < per && b0 + j < blocks; ++j) {
    const uint32_t c = __ldcg(&counts[b0 + j]);
    counts[b0 + j] = run;
    run += c;
  }
  return total;
}

// Pass 4: each block's counts of keys > thr and == thr; the last block
// turns them into exclusive prefixes.
template <typename T>
__global__ void __launch_bounds__(kThreads)
count_kernel(Source<T> src, int64_t chunk, uint32_t* __restrict__ scratch) {
  const uint32_t thr = __ldcg(&scratch[kPrefix]);
  const int64_t n = src.n;
  const int64_t lo = static_cast<int64_t>(blockIdx.x) * chunk;
  const int64_t hi = lo + chunk < n ? lo + chunk : n;
  uint32_t gt = 0, eq = 0;
  for (int64_t t = lo; t < hi; t += kTile) {
    const int64_t i0 = t + threadIdx.x * kItems;
    float v[kItems];
    x_eff8(src, i0, v);
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const uint32_t key = key_of(v[j]);
      gt += (i0 + j < n && key > thr) ? 1u : 0u;
      eq += (i0 + j < n && key == thr) ? 1u : 0u;
    }
  }
  uint32_t gt_sum, eq_sum;
  block_exclusive_scan(gt, gt_sum);
  block_exclusive_scan(eq, eq_sum);
  if (threadIdx.x == 0) {
    scratch[kGtBase + blockIdx.x] = gt_sum;
    scratch[kEqBase + blockIdx.x] = eq_sum;
  }
  if (!arrive_last(scratch)) return;
  scan_counts(scratch + kGtBase, gridDim.x);
  const uint32_t eq_total = scan_counts(scratch + kEqBase, gridDim.x);
  if (threadIdx.x == 0) scratch[kEqTotal] = eq_total;
}

// Pass 5: q, the positions and the residual of the survivors.
template <typename T, bool kBitmap>
__global__ void __launch_bounds__(kThreads)
write_kernel(Source<T> src, float* eff_out, int64_t chunk, uint32_t k,
             int64_t pos_off, const uint32_t* __restrict__ scratch,
             uint8_t* __restrict__ out) {
  const uint32_t thr = __ldcg(&scratch[kPrefix]);
  const uint32_t need = __ldcg(&scratch[kRemain]);
  const uint32_t eq_total = __ldcg(&scratch[kEqTotal]);
  uint32_t gt_base = __ldcg(&scratch[kGtBase + blockIdx.x]);
  uint32_t eq_base = __ldcg(&scratch[kEqBase + blockIdx.x]);
  const float amax = __uint_as_float(reinterpret_cast<const uint32_t*>(out)[1]);
  const double sd = static_cast<double>(amax) / 127.0;
  const float s = static_cast<float>(sd > 1e-12 ? sd : 1e-12);
  int8_t* q = reinterpret_cast<int8_t*>(out + kHeader);
  uint8_t* bitmap = out + pos_off;
  int32_t* idx = reinterpret_cast<int32_t*>(out + pos_off);
  const int64_t n = src.n;
  const int64_t lo = static_cast<int64_t>(blockIdx.x) * chunk;
  const int64_t hi = lo + chunk < n ? lo + chunk : n;
  for (int64_t t = lo; t < hi; t += kTile) {
    const int64_t i0 = t + threadIdx.x * kItems;
    float v[kItems];
    x_eff8(src, i0, v);
    uint32_t gt_mask = 0, eq_mask = 0;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const uint32_t key = key_of(v[j]);
      if (i0 + j < n) {
        gt_mask |= (key > thr ? 1u : 0u) << j;
        eq_mask |= (key == thr ? 1u : 0u) << j;
      }
    }
    // gt in the low half, eq in the high half: a tile holds 2048 elements
    uint32_t tile;
    const uint32_t pre = block_exclusive_scan(
        __popc(gt_mask) | (__popc(eq_mask) << 16), tile);
    uint32_t gt_before = gt_base + (pre & 0xffffu);
    uint32_t eq_before = eq_base + (pre >> 16);
    uint32_t byte = 0;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const uint32_t taken = ties_before(eq_before, need, eq_total);
      bool keep = false;
      if ((gt_mask >> j) & 1u) {
        keep = true;
        ++gt_before;
      } else if ((eq_mask >> j) & 1u) {
        keep = ties_before(eq_before + 1, need, eq_total) > taken;
        ++eq_before;
      }
      if (!keep) continue;
      // survivors before this one: the gt ones and the ties taken
      const uint32_t slot = gt_before - ((gt_mask >> j) & 1u) + taken;
      byte |= 0x80u >> j;
      if (slot < k) {
        const int8_t qv = static_cast<int8_t>(static_cast<int>(
            fminf(fmaxf(rintf(__fdiv_rn(v[j], s)), -127.f), 127.f)));
        q[slot] = qv;
        if (!kBitmap) idx[slot] = static_cast<int32_t>(i0 + j);
        if (eff_out != nullptr)
          eff_out[i0 + j] = v[j] - static_cast<float>(qv) * s;
      }
    }
    if (kBitmap && i0 < n) bitmap[i0 / kItems] = static_cast<uint8_t>(byte);
    gt_base += tile & 0xffffu;
    eq_base += tile >> 16;
  }
}

struct Grid {
  int blocks;
  int64_t chunk;
};

Grid grid_of(int64_t n) {
  const int64_t tiles = (n + kTile - 1) / kTile;
  const int64_t want = tiles < kMaxBlocks ? tiles : kMaxBlocks;
  const int64_t per = (tiles + want - 1) / want;
  return {static_cast<int>((tiles + per - 1) / per), per * kTile};
}

template <typename T>
int launch_all(const T* x, const float* res, float decay, int64_t n,
               uint32_t k, int bitmap, float* eff_out, uint32_t* scratch,
               uint8_t* out, int64_t pos_off, cudaStream_t stream) {
  const Grid g = grid_of(n);
  const Source<T> first{x, res, decay, nullptr, n};
  const Source<T> later{x, res, decay, eff_out, n};
  cudaError_t err;
  fold_hist_kernel<T><<<g.blocks, kThreads, 0, stream>>>(
      first, eff_out, g.chunk, k, pos_off, scratch, out);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  hist_mid_kernel<T><<<g.blocks, kThreads, 0, stream>>>(later, g.chunk,
                                                        scratch);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  hist_low_kernel<T><<<g.blocks, kThreads, 0, stream>>>(later, g.chunk,
                                                        scratch);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  count_kernel<T><<<g.blocks, kThreads, 0, stream>>>(later, g.chunk, scratch);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  if (bitmap) {
    write_kernel<T, true><<<g.blocks, kThreads, 0, stream>>>(
        later, eff_out, g.chunk, k, pos_off, scratch, out);
  } else {
    write_kernel<T, false><<<g.blocks, kThreads, 0, stream>>>(
        later, eff_out, g.chunk, k, pos_off, scratch, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// uint32 words of scratch the caller allocates zeroed, once per stream.
int slt_topk8_scratch_words(void) { return kScratchWords; }

// The five launches of the topk8 encode of x [n] (float32 if is_bf16 == 0,
// else bfloat16) with the old residual res [n] (or null) at `decay`, k
// survivors (1 <= k <= n < 2^31). `bitmap` selects the position form; out
// holds pos_off + (bitmap ? ceil(n / 8) : 4 k) bytes, pos_off = 16 + k
// rounded up to a multiple of 4. eff_out [n] receives the new residual, or
// is null when none is wanted. Returns the first cudaError_t.
int slt_topk8_encode(const void* x, int is_bf16, const float* res,
                     float decay, int64_t n, int64_t k, int bitmap,
                     float* eff_out, uint32_t* scratch, uint8_t* out,
                     cudaStream_t stream) {
  if (n < 1 || k < 1 || k > n || n >= (int64_t(1) << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t pos_off = kHeader + ((k + 3) / 4) * 4;
  const uint32_t kk = static_cast<uint32_t>(k);
  return is_bf16
             ? launch_all(static_cast<const __nv_bfloat16*>(x), res, decay, n,
                          kk, bitmap, eff_out, scratch, out, pos_off, stream)
             : launch_all(static_cast<const float*>(x), res, decay, n, kk,
                          bitmap, eff_out, scratch, out, pos_off, stream);
}

}  // extern "C"
