// Native data-plane kernels for the feature store (host side), the port's
// copy of native/dataplane.cpp: the two packages build and load their own
// library and never share one.
//
// The hot path gathers B rows of [196, 2048] float16 features from a
// memory-mapped store, raw (the bf16 feed) or widened to float32, and
// densifies the sparse soft answers; NumPy fancy-indexing + astype does the
// gather in two passes with an intermediate copy, this does one pass split
// over host threads. Built with g++ at first use by data/native.py into
// build/native/; every function has a NumPy twin with the same semantics.
//
// C ABI only (consumed via ctypes from data/native.py).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#if defined(__F16C__)
#include <immintrin.h>
#endif

namespace {

// IEEE 754 half -> float, branch-light bit manipulation.
inline float half_to_float(uint16_t h) {
  uint32_t sign = static_cast<uint32_t>(h & 0x8000u) << 16;
  uint32_t exp = (h >> 10) & 0x1Fu;
  uint32_t mant = h & 0x3FFu;
  uint32_t bits;
  if (exp == 0) {
    if (mant == 0) {
      bits = sign;  // +-0
    } else {
      // subnormal: value = mant * 2^-24 -> normalise to 1.f * 2^(-14-shift)
      int shift = 0;
      while ((mant & 0x400u) == 0) {
        mant <<= 1;
        ++shift;
      }
      mant &= 0x3FFu;
      bits = sign | ((127 - 14 - shift) << 23) | (mant << 13);
    }
  } else if (exp == 0x1Fu) {
    bits = sign | 0x7F800000u | (mant << 13);  // inf / nan
  } else {
    bits = sign | ((exp + (127 - 15)) << 23) | (mant << 13);
  }
  float out;
  std::memcpy(&out, &bits, sizeof(out));
  return out;
}

// Split [0, n) into up to max_threads contiguous slices and run fn(lo, hi)
// on each from its own thread. The gathers move ~1 MB/row, so per-call
// std::thread spawn (~tens of us) is noise against the memcpy time; a
// persistent pool would buy nothing and cost shutdown ordering headaches in
// a ctypes-loaded library. n_threads <= 1 runs inline.
template <typename Fn>
void parallel_rows(int64_t n, int n_threads, Fn fn) {
  int64_t t = std::min<int64_t>(n_threads > 1 ? n_threads : 1, n);
  if (t <= 1) {
    fn(0, n);
    return;
  }
  std::vector<std::thread> workers;
  workers.reserve(static_cast<size_t>(t));
  int64_t chunk = (n + t - 1) / t;
  for (int64_t w = 0; w < t; ++w) {
    int64_t lo = w * chunk;
    int64_t hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    workers.emplace_back([fn, lo, hi] { fn(lo, hi); });
  }
  for (auto& th : workers) th.join();
}

}  // namespace

extern "C" {

// Gather n_rows rows of row_elems float16 values from src (a row-major
// [num_rows, row_elems] buffer, e.g. an mmap of features.bin) into a dense
// float32 output [n_rows, row_elems], split across n_threads host threads
// (each batch row is ~0.4-1.6 MB, so the work is pure memory bandwidth and
// scales with the host's memory channels).
void vqa_gather_f16_to_f32_mt(const uint16_t* src, const int64_t* rows,
                              int64_t n_rows, int64_t row_elems, float* out,
                              int32_t n_threads) {
  parallel_rows(n_rows, n_threads, [=](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      const uint16_t* r = src + rows[i] * row_elems;
      float* o = out + i * row_elems;
      int64_t j = 0;
#if defined(__F16C__)
      // hardware half->float: 8 lanes per vcvtph2ps (the rows are 196*2048
      // elements, so the vector loop carries essentially all of the work)
      for (; j + 8 <= row_elems; j += 8) {
        __m128i h = _mm_loadu_si128(reinterpret_cast<const __m128i*>(r + j));
        _mm256_storeu_ps(o + j, _mm256_cvtph_ps(h));
      }
#endif
      for (; j < row_elems; ++j) {
        o[j] = half_to_float(r[j]);
      }
    }
  });
}

// Same gather without conversion (raw f16 rows, for bf16/f16 device feeds).
void vqa_gather_rows_u16_mt(const uint16_t* src, const int64_t* rows,
                            int64_t n_rows, int64_t row_elems, uint16_t* out,
                            int32_t n_threads) {
  parallel_rows(n_rows, n_threads, [=](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      std::memcpy(out + i * row_elems, src + rows[i] * row_elems,
                  static_cast<size_t>(row_elems) * sizeof(uint16_t));
    }
  });
}

// Densify fixed-width sparse soft answers: for each row, scatter
// (idx[row, j] >= 0) ? val[row, j] into out[row, idx[row, j]].
// out must be zero-initialised [n_rows, num_answers]. Rows are independent,
// so the same row-slice threading applies.
void vqa_densify_soft_mt(const int32_t* idx, const float* val, int64_t n_rows,
                         int64_t width, int64_t num_answers, float* out,
                         int32_t n_threads) {
  parallel_rows(n_rows, n_threads, [=](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      const int32_t* ir = idx + i * width;
      const float* vr = val + i * width;
      float* o = out + i * num_answers;
      for (int64_t j = 0; j < width; ++j) {
        int32_t a = ir[j];
        if (a >= 0 && a < num_answers) {
          o[a] = vr[j];
        }
      }
    }
  });
}

}  // extern "C"
