// MCAN's residual add + LayerNorm in one pass (ops/mcan_norm.py):
//
//     z   = bf16(x + r)                          the residual stream's sum
//     out = bf16(a * (z - mean) / (std + eps) + b)
//
// over the last axis of width d, with std the unbiased standard deviation
// and eps added to it, not under the root (mcan-vqa's
// core/model/net_utils.py LayerNorm). The statistics and the affine map are
// f32; a and b are the f32 parameters.
//
// It replaces no TPU kernel: the JAX package has no MCAN. It was added
// because no op of the port computes this function (F.layer_norm puts eps
// under the root and takes the biased variance), and composed from torch
// ops it costs 6-8 launches and as many passes over a [rows, d] tensor.
//
// Bound: bytes. A row is read once from x and r and written once (6 bytes
// an element at bf16); a and b are 8 bytes a column, from L2 after the
// first rows. One warp holds a whole row in registers (d / 32 values a
// lane, loaded 8 bf16 at a time as 16-byte loads), so the two statistics
// are two warp reductions over registers and nothing is read twice from
// device memory. Eight rows a block of 256 threads; at MCAN-large's
// 50,176 image rows a batch that is 6,272 blocks, ~47 a multiprocessor.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarp = 32;
constexpr int kVec = 8;            // bf16 values in a 16-byte load
constexpr int kRowsPerBlock = 8;   // one warp a row
constexpr int kMaxChunks = 16;     // d up to 16 * 32 * 8 = 4096

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = kWarp / 2; m > 0; m >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// CHUNKS 16-byte chunks a lane: d <= CHUNKS * 256, d % 8 == 0
template <int CHUNKS>
__global__ void __launch_bounds__(kWarp * kRowsPerBlock)
add_layernorm_kernel(const bf16* __restrict__ x, const bf16* __restrict__ r,
                     const float* __restrict__ a, const float* __restrict__ b,
                     bf16* __restrict__ out, int64_t rows, int d, float eps) {
  const int lane = threadIdx.x % kWarp;
  const int64_t row =
      (int64_t)blockIdx.x * kRowsPerBlock + threadIdx.x / kWarp;
  if (row >= rows) return;
  const int64_t base = row * (int64_t)d;

  float z[CHUNKS][kVec];
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    const int col = (c * kWarp + lane) * kVec;
    if (col < d) {
      const uint4 xv = *reinterpret_cast<const uint4*>(x + base + col);
      const uint4 rv = *reinterpret_cast<const uint4*>(r + base + col);
      const bf16* xe = reinterpret_cast<const bf16*>(&xv);
      const bf16* re = reinterpret_cast<const bf16*>(&rv);
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        // the sum in f32, rounded once to bf16, as torch adds two bf16
        const float s = __bfloat162float(__float2bfloat16_rn(
            __bfloat162float(xe[i]) + __bfloat162float(re[i])));
        z[c][i] = s;
        sum += s;
      }
    } else {
#pragma unroll
      for (int i = 0; i < kVec; ++i) z[c][i] = 0.f;
    }
  }
  const float mean = warp_sum(sum) / (float)d;

  float ss = 0.f;
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    const int col = (c * kWarp + lane) * kVec;
    if (col < d) {
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const float dv = z[c][i] - mean;
        ss += dv * dv;
      }
    }
  }
  const float denom = sqrtf(warp_sum(ss) / (float)(d - 1)) + eps;

#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    const int col = (c * kWarp + lane) * kVec;
    if (col < d) {
      const float4 a0 = *reinterpret_cast<const float4*>(a + col);
      const float4 a1 = *reinterpret_cast<const float4*>(a + col + 4);
      const float4 b0 = *reinterpret_cast<const float4*>(b + col);
      const float4 b1 = *reinterpret_cast<const float4*>(b + col + 4);
      const float av[kVec] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[kVec] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
      uint4 ov;
      bf16* oe = reinterpret_cast<bf16*>(&ov);
#pragma unroll
      for (int i = 0; i < kVec; ++i)
        // the composed form's order: (a * (z - mean)) / (std + eps) + b
        oe[i] = __float2bfloat16_rn(av[i] * (z[c][i] - mean) / denom + bv[i]);
      *reinterpret_cast<uint4*>(out + base + col) = ov;
    }
  }
}

template <int CHUNKS>
cudaError_t launch(const bf16* x, const bf16* r, const float* a,
                   const float* b, bf16* out, int64_t rows, int d, float eps,
                   cudaStream_t stream) {
  const int64_t blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  add_layernorm_kernel<CHUNKS><<<(unsigned)blocks, kWarp * kRowsPerBlock, 0,
                                 stream>>>(x, r, a, b, out, rows, d, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, r, out: [rows, d] bf16, contiguous, 16-byte aligned; a, b: [d] f32,
// 16-byte aligned. 0, or the CUDA error of the launch.
int mcan_add_layernorm_launch(const void* x, const void* r, const void* a,
                              const void* b, void* out, long long rows, int d,
                              float eps, void* stream) {
  if (rows < 0 || d < 2 || d % kVec || d > kMaxChunks * kWarp * kVec ||
      rows / kRowsPerBlock >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const bf16* xp = static_cast<const bf16*>(x);
  const bf16* rp = static_cast<const bf16*>(r);
  const float* ap = static_cast<const float*>(a);
  const float* bp = static_cast<const float*>(b);
  bf16* op = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int chunks = (d + kWarp * kVec - 1) / (kWarp * kVec);
  if (chunks <= 1) return (int)launch<1>(xp, rp, ap, bp, op, rows, d, eps, s);
  if (chunks <= 2) return (int)launch<2>(xp, rp, ap, bp, op, rows, d, eps, s);
  if (chunks <= 4) return (int)launch<4>(xp, rp, ap, bp, op, rows, d, eps, s);
  if (chunks <= 8) return (int)launch<8>(xp, rp, ap, bp, op, rows, d, eps, s);
  return (int)launch<16>(xp, rp, ap, bp, op, rows, d, eps, s);
}

const char* mcan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
