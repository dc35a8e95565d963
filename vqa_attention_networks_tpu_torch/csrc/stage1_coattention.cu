// Stage-1 fusion + grid L2 + 2-glimpse co-attention for mhb_coAtt, bf16
// inference, hand-written for Hopper (sm_90a).
//
// Replaces fused_stage1_coattention_pallas and its pair twin
// fused_stage1_coattention_pallas_pair (vqa_attention_networks_tpu/ops/
// pallas_wq_fusion.py): the pair twin gives the same bits as the
// single-sample kernel, so this one kernel serves both. Per sample n:
//
//   wq[d,o] = sum_j w3[j,d,o] * q3[n,j,o]      f32, rounded to bf16 once
//   bq[o]   = sum_j b3[j,o]   * q3[n,j,o]      f32
//   z       = signed_sqrt(img[n] @ wq + bq)    [L, O_pad] f32
//   zb      = bf16(z * (1 / max(||z||, eps)))  norm over the whole grid
//   h1      = bf16(relu(zb @ c1w + c1b))       [L, C]
//   logits  = h1 @ c2w + c2b                   [L, G] f32
//   att     = softmax over L, rounded to bf16
//   out[n]  = bf16(att^T @ img[n])             [G, D], f32 accumulation
//
// What bounds it on this card. The TPU kernel keeps the whole refactored
// w3 [k, D, O_pad] resident in VMEM as f32 (42 MB at D=2048, k=5,
// O_pad=1024). A Hopper block has at most 227 KB of shared memory, so w3
// streams through the 50 MB L2 instead: every sample's wq build reads all
// of w3, 42 MB per sample, 10.7 GB at batch 256. The product itself is
// about 0.8 GFLOP per sample. This first kernel is bound by that W stream
// and the f32 wq build, not by the tensor cores.
//
// What the design does about it. Three launches from one wrapper:
//   A  stage1_grid_kernel    grid (O_pad/128, N): builds a [32, 128] bf16
//      wq chunk in shared memory from w3 (f32, through L2) and q3, runs
//      img[196(+12 zero rows), 32] x wq[32, 128] on the tensor cores
//      (WMMA bf16, f32 accumulators in registers) down all of D, then adds
//      bq, takes the signed sqrt, writes z (f32) to a scratch buffer and
//      the block's sum of squares to [N, O_pad/128].
//   B  stage1_hidden_kernel  grid (ceil(C/128), N): forms the norm from the
//      partial sums in a fixed order (no atomics: reruns give the same
//      bits), rounds zb to bf16 chunk by chunk into shared memory and runs
//      zb x c1w on the tensor cores; writes h1 (bf16) [N, L, C].
//   C  stage1_pool_kernel    grid (N): logits, the softmax over L for each
//      glimpse, and the attention pool of img, in f32 FMAs.
// Later work (ROADMAP): several samples per block sharing each w3 tile, a
// bf16 w3, wgmma + TMA, and z kept out of device memory.
//
// The C interface takes raw device pointers and the stream; each launch is
// followed by cudaGetLastError(), whose code is returned (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kTile = 128;       // output columns per block (O in A, C in B)
constexpr int kChunk = 32;       // contraction depth per shared-memory stage
constexpr int kRowTiles = 13;    // 13 x 16 = 208 rows >= L = 196
constexpr int kRows = kRowTiles * 16;
constexpr int kWarps = 8;        // warp w owns columns [16w, 16w + 16)
constexpr int kThreads = kWarps * 32;
constexpr int kLdA = kChunk + 8;  // padded rows against bank conflicts
constexpr int kLdB = kTile + 8;
constexpr int kMaxK = 16;
constexpr int kMaxG = 8;

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> AccFrag;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
    AFrag;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
    BFrag;

__device__ __forceinline__ float signed_sqrt(float p) {
  return sqrtf(fmaxf(p, 0.0f)) - sqrtf(fmaxf(-p, 0.0f));
}

// acc[mt] += A[16mt:16mt+16, 0:kChunk] x B[0:kChunk, 16w:16w+16]
__device__ __forceinline__ void mma_chunk(AccFrag (&acc)[kRowTiles],
                                          const bf16* a_s, const bf16* b_s,
                                          int warp) {
#pragma unroll
  for (int kk = 0; kk < kChunk / 16; ++kk) {
    BFrag bf;
    wmma::load_matrix_sync(bf, b_s + kk * 16 * kLdB + warp * 16, kLdB);
#pragma unroll
    for (int mt = 0; mt < kRowTiles; ++mt) {
      AFrag af;
      wmma::load_matrix_sync(af, a_s + mt * 16 * kLdA + kk * 16, kLdA);
      wmma::mma_sync(acc[mt], af, bf, acc[mt]);
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// ---------------------------------------------------------------------------
// A: z = signed_sqrt(img @ bf16(wq) + bq), and per-block sums of squares
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
    stage1_grid_kernel(const bf16* __restrict__ img,   // [N, L, D]
                       const float* __restrict__ w3,   // [k, D, O_pad]
                       const float* __restrict__ b3,   // [k, O_pad]
                       const bf16* __restrict__ q3,    // [N, k, O_pad]
                       float* __restrict__ z,          // [N, L, O_pad]
                       float* __restrict__ ssq_part,   // [N, O_pad / kTile]
                       int l, int d, int k, int o_pad) {
  __shared__ __align__(128) bf16 a_s[kRows * kLdA];
  __shared__ __align__(128) bf16 b_s[kChunk * kLdB];
  __shared__ float q_s[kMaxK * kTile];
  __shared__ float bq_s[kTile];
  __shared__ __align__(128) float stage_s[kWarps][16 * 16];
  __shared__ float red_s[kWarps];

  const int tile = blockIdx.x;
  const int n = blockIdx.y;
  const int o0 = tile * kTile;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const bf16* img_n = img + (size_t)n * l * d;

  for (int i = tid; i < k * kTile; i += kThreads) {
    const int j = i / kTile, o = i % kTile;
    q_s[i] = __bfloat162float(q3[((size_t)n * k + j) * o_pad + o0 + o]);
  }
  // rows [l, kRows) of the A stage are zero for the whole kernel
  for (int i = l * kLdA + tid; i < kRows * kLdA; i += kThreads)
    a_s[i] = __float2bfloat16(0.0f);
  __syncthreads();
  if (tid < kTile) {
    float acc = 0.0f;
    for (int j = 0; j < k; ++j)
      acc = __fadd_rn(acc, __fmul_rn(b3[(size_t)j * o_pad + o0 + tid],
                                     q_s[j * kTile + tid]));
    bq_s[tid] = acc;
  }

  AccFrag acc[kRowTiles];
#pragma unroll
  for (int mt = 0; mt < kRowTiles; ++mt) wmma::fill_fragment(acc[mt], 0.0f);

  for (int d0 = 0; d0 < d; d0 += kChunk) {
    // img[:, d0:d0+32] -> A stage, 16 bytes per thread per step
    for (int i = tid; i < l * (kChunk / 8); i += kThreads) {
      const int r = i / (kChunk / 8), v = i % (kChunk / 8);
      const int col = d0 + v * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (col < d)
        val = *reinterpret_cast<const uint4*>(img_n + (size_t)r * d + col);
      *reinterpret_cast<uint4*>(a_s + r * kLdA + v * 8) = val;
    }
    // wq[d0:d0+32, o0:o0+128], built in f32 and rounded to bf16 once;
    // _rn intrinsics keep the multiply and add unfused, as the reference
    for (int i = tid; i < kChunk * kTile; i += kThreads) {
      const int r = i / kTile, o = i % kTile;
      const int dd = d0 + r;
      float wq = 0.0f;
      if (dd < d) {
        const float* wp = w3 + (size_t)dd * o_pad + o0 + o;
        for (int j = 0; j < k; ++j)
          wq = __fadd_rn(wq, __fmul_rn(wp[(size_t)j * d * o_pad],
                                       q_s[j * kTile + o]));
      }
      b_s[r * kLdB + o] = __float2bfloat16(wq);
    }
    __syncthreads();
    mma_chunk(acc, a_s, b_s, warp);
    __syncthreads();
  }

  float ss = 0.0f;
  float* stage = stage_s[warp];
  const int c_base = warp * 16;
#pragma unroll
  for (int mt = 0; mt < kRowTiles; ++mt) {
    wmma::store_matrix_sync(stage, acc[mt], 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int r = mt * 16 + e / 16, c = e % 16;
      if (r < l) {
        const float zv = signed_sqrt(stage[e] + bq_s[c_base + c]);
        z[((size_t)n * l + r) * o_pad + o0 + c_base + c] = zv;
        ss = __fadd_rn(ss, __fmul_rn(zv, zv));
      }
    }
    __syncwarp();
  }
  ss = warp_sum(ss);
  if (lane == 0) red_s[warp] = ss;
  __syncthreads();
  if (tid == 0) {
    float t = 0.0f;
    for (int w = 0; w < kWarps; ++w) t += red_s[w];
    ssq_part[(size_t)n * gridDim.x + tile] = t;
  }
}

// ---------------------------------------------------------------------------
// B: h1 = bf16(relu(bf16(z / ||z||) @ c1w + c1b))
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
    stage1_hidden_kernel(const float* __restrict__ z,         // [N, L, O_pad]
                         const float* __restrict__ ssq_part,  // [N, O_pad/kTile]
                         const bf16* __restrict__ c1w,        // [O_pad, C]
                         const float* __restrict__ c1b,       // [C]
                         bf16* __restrict__ h1,               // [N, L, C]
                         int l, int o_pad, int c, float eps) {
  __shared__ __align__(128) bf16 a_s[kRows * kLdA];
  __shared__ __align__(128) bf16 b_s[kChunk * kLdB];
  __shared__ __align__(128) float stage_s[kWarps][16 * 16];
  __shared__ float inv_s;

  const int tile = blockIdx.x;
  const int n = blockIdx.y;
  const int c0 = tile * kTile;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const float* z_n = z + (size_t)n * l * o_pad;

  if (tid == 0) {
    const int parts = o_pad / kTile;
    float t = 0.0f;
    for (int i = 0; i < parts; ++i) t += ssq_part[(size_t)n * parts + i];
    inv_s = 1.0f / fmaxf(sqrtf(t), eps);
  }
  for (int i = l * kLdA + tid; i < kRows * kLdA; i += kThreads)
    a_s[i] = __float2bfloat16(0.0f);
  __syncthreads();
  const float inv = inv_s;

  AccFrag acc[kRowTiles];
#pragma unroll
  for (int mt = 0; mt < kRowTiles; ++mt) wmma::fill_fragment(acc[mt], 0.0f);

  for (int o0 = 0; o0 < o_pad; o0 += kChunk) {
    for (int i = tid; i < l * kChunk; i += kThreads) {
      const int r = i / kChunk, cc = i % kChunk;
      a_s[r * kLdA + cc] =
          __float2bfloat16(__fmul_rn(z_n[(size_t)r * o_pad + o0 + cc], inv));
    }
    for (int i = tid; i < kChunk * kTile; i += kThreads) {
      const int r = i / kTile, cc = i % kTile;
      const int col = c0 + cc;
      b_s[r * kLdB + cc] = col < c ? c1w[(size_t)(o0 + r) * c + col]
                                   : __float2bfloat16(0.0f);
    }
    __syncthreads();
    mma_chunk(acc, a_s, b_s, warp);
    __syncthreads();
  }

  float* stage = stage_s[warp];
#pragma unroll
  for (int mt = 0; mt < kRowTiles; ++mt) {
    wmma::store_matrix_sync(stage, acc[mt], 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int r = mt * 16 + e / 16;
      const int col = c0 + warp * 16 + e % 16;
      if (r < l && col < c) {
        const float hv = fmaxf(stage[e] + c1b[col], 0.0f);
        h1[((size_t)n * l + r) * c + col] = __float2bfloat16(hv);
      }
    }
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// C: logits, softmax over L per glimpse, out = bf16(bf16(att)^T @ img)
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
    stage1_pool_kernel(const bf16* __restrict__ h1,    // [N, L, C]
                       const bf16* __restrict__ c2w,   // [C, G]
                       const float* __restrict__ c2b,  // [G]
                       const bf16* __restrict__ img,   // [N, L, D]
                       bf16* __restrict__ out,         // [N, G, D]
                       int l, int d, int c, int g) {
  __shared__ float logit_s[kRows * kMaxG];  // [L][kMaxG]
  __shared__ float att_s[kMaxG * kRows];    // [kMaxG][L]

  const int n = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const bf16* h1_n = h1 + (size_t)n * l * c;
  const bf16* img_n = img + (size_t)n * l * d;

  // one warp per region row: logits[r, :] = h1[r, :] @ c2w + c2b
  for (int r = warp; r < l; r += kWarps) {
    float part[kMaxG];
#pragma unroll
    for (int gi = 0; gi < kMaxG; ++gi) part[gi] = 0.0f;
    for (int cc = lane; cc < c; cc += 32) {
      const float hv = __bfloat162float(h1_n[(size_t)r * c + cc]);
#pragma unroll
      for (int gi = 0; gi < kMaxG; ++gi)
        if (gi < g) part[gi] += hv * __bfloat162float(c2w[cc * g + gi]);
    }
#pragma unroll
    for (int gi = 0; gi < kMaxG; ++gi) {
      if (gi < g) {
        const float s = warp_sum(part[gi]);
        if (lane == 0) logit_s[r * kMaxG + gi] = s + c2b[gi];
      }
    }
  }
  __syncthreads();

  // one warp per glimpse: softmax over the L regions
  if (warp < g) {
    float m = __int_as_float(0xff800000);  // -inf
    for (int r = lane; r < l; r += 32) m = fmaxf(m, logit_s[r * kMaxG + warp]);
    m = warp_max(m);
    float s = 0.0f;
    for (int r = lane; r < l; r += 32) {
      const float e = expf(logit_s[r * kMaxG + warp] - m);
      att_s[warp * kRows + r] = e;
      s += e;
    }
    s = warp_sum(s);
    for (int r = lane; r < l; r += 32)
      att_s[warp * kRows + r] =
          __bfloat162float(__float2bfloat16(att_s[warp * kRows + r] / s));
  }
  __syncthreads();

  // attention pool: two adjacent channels per thread, f32 accumulation
  for (int dc = tid * 2; dc < d; dc += kThreads * 2) {
    float acc0[kMaxG], acc1[kMaxG];
#pragma unroll
    for (int gi = 0; gi < kMaxG; ++gi) acc0[gi] = acc1[gi] = 0.0f;
    for (int r = 0; r < l; ++r) {
      const float2 v = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(img_n + (size_t)r * d + dc));
#pragma unroll
      for (int gi = 0; gi < kMaxG; ++gi) {
        if (gi < g) {
          const float a = att_s[gi * kRows + r];
          acc0[gi] += a * v.x;
          acc1[gi] += a * v.y;
        }
      }
    }
#pragma unroll
    for (int gi = 0; gi < kMaxG; ++gi) {
      if (gi < g) {
        bf16* o = out + ((size_t)n * g + gi) * d + dc;
        o[0] = __float2bfloat16(acc0[gi]);
        o[1] = __float2bfloat16(acc1[gi]);
      }
    }
  }
}

}  // namespace

extern "C" {

int stage1_coattention_launch(const void* img, const void* w3,
                              const void* b3, const void* q3, const void* c1w,
                              const void* c1b, const void* c2w,
                              const void* c2b, void* z, void* ssq_part,
                              void* h1, void* out, int n, int l, int d, int k,
                              int o_pad, int c, int g, float eps,
                              void* stream) {
  if (l < 1 || l > kRows || d < 8 || d % 8 || k < 1 || k > kMaxK ||
      o_pad < kTile || o_pad % kTile || c < 1 || g < 1 || g > kMaxG ||
      n < 0 || n > 65535)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);

  stage1_grid_kernel<<<dim3(o_pad / kTile, n), kThreads, 0, s>>>(
      static_cast<const bf16*>(img), static_cast<const float*>(w3),
      static_cast<const float*>(b3), static_cast<const bf16*>(q3),
      static_cast<float*>(z), static_cast<float*>(ssq_part), l, d, k, o_pad);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  stage1_hidden_kernel<<<dim3((c + kTile - 1) / kTile, n), kThreads, 0, s>>>(
      static_cast<const float*>(z), static_cast<const float*>(ssq_part),
      static_cast<const bf16*>(c1w), static_cast<const float*>(c1b),
      static_cast<bf16*>(h1), l, o_pad, c, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  stage1_pool_kernel<<<n, kThreads, 0, s>>>(
      static_cast<const bf16*>(h1), static_cast<const bf16*>(c2w),
      static_cast<const float*>(c2b), static_cast<const bf16*>(img),
      static_cast<bf16*>(out), l, d, c, g);
  return (int)cudaGetLastError();
}

const char* stage1_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
