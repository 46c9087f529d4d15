// Native host-side wire codec of split_learning_tpu_torch (the port's
// own copy of split_learning_tpu/native/slt_codec.cc, with the same
// entry points and the same bytes out; its loops are reworked so that
// the compiler vectorizes them and a thread is spawned only for a
// chunk worth its cost).
//
// The host-side wire hot ops -- int8 absmax quantize/dequantize of the
// cut-layer tensor, the topk8 select and scatter, and frame
// checksumming -- run in C++ with a thread pool, bound into Python via
// ctypes (split_learning_tpu_torch/native/codec.py). They serve the
// numpy line of transport/codec.py: numpy inputs, and decompress_tree
// with no device. Tensors on the card take the hand-written CUDA
// kernels instead (ops/quantize.py, ops/topk.py); all three paths build
// byte-identical frames.
//
// Semantics match the numpy line bit-for-bit:
//   scale = max(absmax(x) / 127, 1e-12)
//   q     = clip(round_half_even(x / scale), -127, 127)   // = np.round
//   x'    = q * scale
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -pthread, driven by codec.py
// at first use (no build system; the toolchain is enough).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// the elements a thread must have before spawning it pays for itself:
// a spawn costs about as much as a vectorized pass over this many
constexpr int64_t kMinChunk = 1 << 20;

int clamp_threads(int n_threads, int64_t n) {
  int hw = static_cast<int>(std::thread::hardware_concurrency());
  if (hw <= 0) hw = 1;
  int t = n_threads > 0 ? std::min(n_threads, hw) : hw;
  int64_t max_useful = std::max<int64_t>(n / kMinChunk, 1);
  return static_cast<int>(std::min<int64_t>(t, max_useful));
}

// fn(chunk, lo, hi) over t equal chunks of [0, n), chunk 0 on the caller
template <typename Fn>
void parallel_chunks(int64_t n, int t, Fn fn) {
  int64_t chunk = (n + t - 1) / t;
  std::vector<std::thread> pool;
  pool.reserve(t > 0 ? t - 1 : 0);
  for (int c = 1; c < t; ++c) {
    int64_t lo = c * chunk;
    int64_t hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    pool.emplace_back([=] { fn(c, lo, hi); });
  }
  fn(0, 0, std::min(n, chunk));
  for (auto& th : pool) th.join();
}

// |x| as its IEEE bits: for finite floats the unsigned order of these
// keys is the order of the magnitudes (-0 and +0 share the key 0)
inline uint32_t abs_key(float x) {
  uint32_t u;
  std::memcpy(&u, &x, sizeof u);
  return u & 0x7FFFFFFFu;
}

inline float key_float(uint32_t u) {
  float x;
  std::memcpy(&x, &u, sizeof x);
  return x;
}

// q = clip(round_half_even(v), -127, 127) for |v| <= 2^22, as np.round
// then np.clip: adding 1.5 * 2^23 leaves no fraction bits, so the
// hardware's round-to-nearest-even rounds v, and the sum's low mantissa
// bits are the rounded integer. No float compare, so the compiler
// vectorizes the loop (a call to nearbyintf, or a float clamp, it
// does not)
inline int8_t q8_round(float v) {
  float b = v + 12582912.0f;
  int32_t r;
  std::memcpy(&r, &b, sizeof r);
  r -= 0x4B400000;
  r = r < -127 ? -127 : r;
  r = r > 127 ? 127 : r;
  return static_cast<int8_t>(r);
}

uint32_t absmax_key(const float* src, int64_t lo, int64_t hi) {
  // eight independent lanes, so the loop is a vector max
  uint32_t m[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  int64_t i = lo;
  for (; i + 8 <= hi; i += 8)
    for (int j = 0; j < 8; ++j) m[j] = std::max(m[j], abs_key(src[i + j]));
  uint32_t r = 0;
  for (int j = 0; j < 8; ++j) r = std::max(r, m[j]);
  for (; i < hi; ++i) r = std::max(r, abs_key(src[i]));
  return r;
}

}  // namespace

extern "C" {

// Max |x| over n finite floats. Exact regardless of the split: max is
// order-independent.
float slt_absmax_f32(const float* src, int64_t n, int n_threads) {
  int t = clamp_threads(n_threads, n);
  std::vector<uint32_t> partial(t, 0);
  parallel_chunks(n, t, [&](int c, int64_t lo, int64_t hi) {
    partial[c] = absmax_key(src, lo, hi);
  });
  return key_float(*std::max_element(partial.begin(), partial.end()));
}

// x -> (q, scale). Returns the scale; q written into dst.
// The scale is computed in double then narrowed for the division — the
// exact arithmetic of the NumPy fallback (a Python float is f64; the
// array division then runs in f32 against the narrowed scale).
double slt_q8_quantize_f32(const float* src, int64_t n, int8_t* dst,
                           int n_threads) {
  double scale =
      n > 0 ? std::max(
                  static_cast<double>(slt_absmax_f32(src, n, n_threads)) /
                      127.0,
                  1e-12)
            : 1e-12;
  float s32 = static_cast<float>(scale);
  int t = clamp_threads(n_threads, n);
  parallel_chunks(n, t, [=](int, int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      // divide (not multiply by a reciprocal) to match NumPy's x/scale
      // exactly; |x| <= absmax, so |x / scale| <= 127 up to rounding,
      // well inside q8_round's exact range
      dst[i] = q8_round(src[i] / s32);
    }
  });
  return scale;
}

void slt_q8_dequantize_f32(const int8_t* src, int64_t n, float scale,
                           float* dst, int n_threads) {
  int t = clamp_threads(n_threads, n);
  parallel_chunks(n, t, [=](int, int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      dst[i] = static_cast<float>(src[i]) * scale;
    }
  });
}

// Top-k-|x| selection for the topk8 sparse wire mode. Deterministic
// selection rule, shared bit-for-bit with the NumPy fallback
// (_topk8_select_numpy in transport/codec.py): every element strictly
// above the k-th-largest magnitude, then threshold ties in ascending
// index order until exactly k survive; output indices ascending.
//
// The threshold is found by a radix select on the magnitudes' keys
// (abs_key, 31 bits): a histogram of the high 15 bits names the bin
// that holds the k-th largest, a histogram of the low 16 bits of that
// bin's members names its key, and the counts above it give how many
// elements beat it. Each pass streams the input once; chunks keep
// private histograms. Then per-chunk counts of (>thr) and (==thr) ->
// prefix sums give each chunk a disjoint write window (chunk c starts
// at gt_pre[c] + min(eq_pre[c], need)), so chunks write their
// ascending in-chunk survivors concurrently with no atomics and the
// concatenation is globally ascending.
void slt_topk8_select_f32(const float* src, int64_t n, int64_t k,
                          int32_t* idx_out, float* vals_out, int n_threads) {
  if (k >= n) {
    for (int64_t i = 0; i < n; ++i) {
      idx_out[i] = static_cast<int32_t>(i);
      vals_out[i] = src[i];
    }
    return;
  }
  const int t = clamp_threads(n_threads, n);
  constexpr int kHi = 1 << 15, kLo = 1 << 16;

  // pass 1: the high bits
  std::vector<std::vector<uint32_t>> hist(t);
  parallel_chunks(n, t, [&](int c, int64_t lo, int64_t hi) {
    std::vector<uint32_t>& h = hist[c];
    h.assign(kHi, 0);
    for (int64_t i = lo; i < hi; ++i) ++h[abs_key(src[i]) >> 16];
  });
  int64_t above = 0;  // elements in bins above the threshold's
  int bin = kHi - 1;
  for (;; --bin) {
    int64_t cnt = 0;
    for (int c = 0; c < t; ++c) cnt += hist[c][bin];
    if (above + cnt >= k) break;
    above += cnt;
  }

  // pass 2: the low bits of the threshold bin's members
  const uint32_t bin_u = static_cast<uint32_t>(bin);
  parallel_chunks(n, t, [&](int c, int64_t lo, int64_t hi) {
    std::vector<uint32_t>& h = hist[c];
    h.assign(kLo, 0);
    for (int64_t i = lo; i < hi; ++i) {
      uint32_t key = abs_key(src[i]);
      if ((key >> 16) == bin_u) ++h[key & 0xFFFFu];
    }
  });
  int low = kLo - 1;
  for (;; --low) {
    int64_t cnt = 0;
    for (int c = 0; c < t; ++c) cnt += hist[c][low];
    if (above + cnt >= k) break;
    above += cnt;
  }
  const uint32_t thr = (bin_u << 16) | static_cast<uint32_t>(low);
  const int64_t need = k - above;  // ties to keep, lowest-index first

  std::vector<int64_t> gt_pre(t + 1, 0), eq_pre(t + 1, 0);
  if (t > 1) {
    parallel_chunks(n, t, [&](int c, int64_t lo, int64_t hi) {
      int64_t gt = 0, eq = 0;
      for (int64_t i = lo; i < hi; ++i) {
        uint32_t key = abs_key(src[i]);
        gt += key > thr;
        eq += key == thr;
      }
      gt_pre[c + 1] = gt;
      eq_pre[c + 1] = eq;
    });
    for (int c = 0; c < t; ++c) {
      gt_pre[c + 1] += gt_pre[c];
      eq_pre[c + 1] += eq_pre[c];
    }
  }
  parallel_chunks(n, t, [&](int c, int64_t lo, int64_t hi) {
    int64_t out = gt_pre[c] + std::min(eq_pre[c], need);
    int64_t tie_rank = eq_pre[c];
    for (int64_t i = lo; i < hi; ++i) {
      uint32_t key = abs_key(src[i]);
      if (key > thr || (key == thr && tie_rank++ < need)) {
        idx_out[out] = static_cast<int32_t>(i);
        vals_out[out] = src[i];
        ++out;
      }
    }
  });
}

// Sparse dequantize-scatter: dst (pre-zeroed, n floats) gets
// dst[idx[i]] = q[i] * scale. Indices are unique by construction
// (selection output), so parallel writes are disjoint.
void slt_topk8_scatter_f32(const int64_t* idx, const int8_t* q, int64_t k,
                           float scale, float* dst, int n_threads) {
  int t = clamp_threads(n_threads, k);
  parallel_chunks(k, t, [=](int, int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      dst[idx[i]] = static_cast<float>(q[i]) * scale;
    }
  });
}

// CRC-32 (IEEE 802.3, reflected polynomial 0xEDB88320), identical to
// zlib.crc32. NOT on the wire hot path: the Python side uses zlib (which
// is copy-free and GIL-releasing); this is the parity reference for the C
// framing, exercised by tests/test_torch_port_native.py.
namespace {
struct Crc32Table {
  uint32_t t[256];
  Crc32Table() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k)
        c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      t[i] = c;
    }
  }
};
}  // namespace

uint32_t slt_crc32(const uint8_t* data, int64_t n, uint32_t seed) {
  // magic static: thread-safe initialization under C++11, unlike a
  // hand-rolled "static bool init" flag
  static const Crc32Table table;
  uint32_t crc = seed ^ 0xFFFFFFFFu;
  for (int64_t i = 0; i < n; ++i)
    crc = table.t[(crc ^ data[i]) & 0xFFu] ^ (crc >> 8);
  return crc ^ 0xFFFFFFFFu;
}

}  // extern "C"
