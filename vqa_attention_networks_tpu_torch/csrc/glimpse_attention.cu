// The 2-glimpse attention block, bf16 inference, hand-written for Hopper
// (sm_90a).
//
// Replaces _glimpse_pallas (vqa_attention_networks_tpu/ops/
// pallas_attention.py). With x [N, P, C], W1 [A, C], W2 [G, A], v [N, P, D]
// (bf16) and the biases b1 [A], b2 [G] (f32), m = n*P + p the flat row:
//
//   h[m,a]     = bf16(relu(sum_c x[m,c] W1[a,c] + b1[a]))     f32 sum
//   logit[m,g] = sum_a h[m,a] W2[g,a] + b2[g]                 f32
//   w[n,p,g]   = bf16(softmax over p of logit[n*P+p, g])      (1 under the
//                                                              quirk)
//   out[n,g,d] = sum_p w[n,p,g] v[n,p,d]                      f32
//
// What bounds it on this card. At the question glimpse of mhb_coAtt
// (N=256, P=22, C=1024, A=512, D=1024) the MLP is 5.9 GFLOP against 25 MB
// of inputs; at the co-attention (P=196, C=1000, D=2048) 51 GFLOP against
// 305 MB: about 50 us of tensor-core work against 91 us of reads. The
// second is bound by reading x and v once.
//
// What the design does about it. The TPU kernel keeps 8 samples' x, v and
// the weights in VMEM and runs the whole block per grid step. Here two
// launches from one entry:
//   1  glimpse_mlp_kernel   grid (ceil(A/128), ceil(N*P/128)): a [128, 128]
//      tile of x @ W1^T on the tensor cores (WMMA bf16, f32 accumulators,
//      a 32-deep shared-memory stage), then in the epilogue + b1, relu, the
//      bf16 rounding and the product with W2's [G, 128] slice, so h never
//      reaches device memory: each block writes its partial logits
//      [N*P, G] for its 128 hidden units.
//   2  glimpse_pool_kernel  grid (ceil(D/512), N): sums the partial logits
//      of the A tiles in a fixed order (no atomics: reruns give the same
//      bits), + b2, the softmax over P per glimpse, and the pool of v, each
//      thread a pair of columns, v read once.
//
// The C interface takes raw device pointers and the stream; each launch is
// followed by cudaGetLastError(), whose code is returned (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf16x2;

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = 8;
constexpr int kTileM = 128;    // rows of x per MLP block
constexpr int kTileA = 128;    // hidden units per MLP block
constexpr int kChunk = 32;     // contraction depth per shared-memory stage
constexpr int kLd = kChunk + 8;  // padded against bank conflicts
constexpr int kMaxG = 4;
constexpr int kMaxP = 1024;
constexpr int kPoolCols = 2 * kThreads;

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> AccFrag;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
    ARow;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>
    BCol;

__device__ __forceinline__ uint4 load16(const bf16* p, bool ok) {
  return ok ? *reinterpret_cast<const uint4*>(p) : make_uint4(0u, 0u, 0u, 0u);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// ---------------------------------------------------------------------------
// 1: partial logits of 128 hidden units for 128 rows
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
    glimpse_mlp_kernel(const bf16* __restrict__ x,    // [M, C]
                       const bf16* __restrict__ w1,   // [A, C]
                       const float* __restrict__ b1,  // [A]
                       const bf16* __restrict__ w2,   // [G, A]
                       float* __restrict__ part,      // [A tiles, M, G]
                       int mrows, int c_dim, int a_dim, int g) {
  __shared__ __align__(128) bf16 a_s[kTileM * kLd];   // x [m][c]
  __shared__ __align__(128) bf16 b_s[kTileA * kLd];   // W1 [a][c]
  __shared__ __align__(128) float stage_s[kWarps][256];
  __shared__ float plog_s[2][kTileM][kMaxG];

  const int a0 = blockIdx.x * kTileA;
  const int m0 = blockIdx.y * kTileM;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wr = warp / 2, wc = warp % 2;  // 32 rows x 64 hidden units

  AccFrag acc[2][4];
#pragma unroll
  for (int rt = 0; rt < 2; ++rt)
#pragma unroll
    for (int ct = 0; ct < 4; ++ct) wmma::fill_fragment(acc[rt][ct], 0.0f);

  for (int c0 = 0; c0 < c_dim; c0 += kChunk) {
    for (int i = tid; i < kTileM * (kChunk / 8); i += kThreads) {
      const int r = i / (kChunk / 8), vv = i % (kChunk / 8);
      const int m = m0 + r, col = c0 + vv * 8;
      *reinterpret_cast<uint4*>(a_s + r * kLd + vv * 8) =
          load16(x + (size_t)m * c_dim + col, m < mrows && col < c_dim);
    }
    for (int i = tid; i < kTileA * (kChunk / 8); i += kThreads) {
      const int r = i / (kChunk / 8), vv = i % (kChunk / 8);
      const int a = a0 + r, col = c0 + vv * 8;
      *reinterpret_cast<uint4*>(b_s + r * kLd + vv * 8) =
          load16(w1 + (size_t)a * c_dim + col, a < a_dim && col < c_dim);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk) {
      ARow f0, f1;
      wmma::load_matrix_sync(f0, a_s + (wr * 32) * kLd + kk * 16, kLd);
      wmma::load_matrix_sync(f1, a_s + (wr * 32 + 16) * kLd + kk * 16, kLd);
#pragma unroll
      for (int ct = 0; ct < 4; ++ct) {
        BCol bfr;  // element (c, a) at b_s[a * kLd + c]
        wmma::load_matrix_sync(bfr, b_s + (wc * 64 + ct * 16) * kLd + kk * 16,
                               kLd);
        wmma::mma_sync(acc[0][ct], f0, bfr, acc[0][ct]);
        wmma::mma_sync(acc[1][ct], f1, bfr, acc[1][ct]);
      }
    }
    __syncthreads();
  }

  // epilogue: lane (r = lane % 16, half = lane / 16) takes row r and the 8
  // hidden units [8 half, 8 half + 8) of each 16x16 fragment
  const int r = lane % 16, half = lane / 16;
  float* st = stage_s[warp];
  float plog[2][kMaxG];
#pragma unroll
  for (int rt = 0; rt < 2; ++rt) {
#pragma unroll
    for (int gg = 0; gg < kMaxG; ++gg) plog[rt][gg] = 0.0f;
#pragma unroll
    for (int ct = 0; ct < 4; ++ct) {
      wmma::store_matrix_sync(st, acc[rt][ct], 16, wmma::mem_row_major);
      __syncwarp();
      for (int j = 0; j < 8; ++j) {
        const int col = half * 8 + j;
        const int a = a0 + wc * 64 + ct * 16 + col;
        if (a < a_dim) {
          const float h = round_bf16(fmaxf(st[r * 16 + col] + b1[a], 0.0f));
#pragma unroll
          for (int gg = 0; gg < kMaxG; ++gg)
            if (gg < g)
              plog[rt][gg] += h * __bfloat162float(w2[(size_t)gg * a_dim + a]);
        }
      }
      __syncwarp();
    }
#pragma unroll
    for (int gg = 0; gg < kMaxG; ++gg)
      plog[rt][gg] += __shfl_xor_sync(0xffffffffu, plog[rt][gg], 16);
    if (half == 0)
#pragma unroll
      for (int gg = 0; gg < kMaxG; ++gg)
        plog_s[wc][wr * 32 + rt * 16 + r][gg] = plog[rt][gg];
  }
  __syncthreads();
  for (int i = tid; i < kTileM * g; i += kThreads) {
    const int rr = i / g, gg = i % g, m = m0 + rr;
    if (m < mrows)
      part[((size_t)blockIdx.x * mrows + m) * g + gg] =
          plog_s[0][rr][gg] + plog_s[1][rr][gg];
  }
}

// ---------------------------------------------------------------------------
// 2: logits, softmax over P per glimpse, pool of v
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
    glimpse_pool_kernel(const float* __restrict__ part,  // [A tiles, M, G]
                        const float* __restrict__ b2,    // [G]
                        const bf16* __restrict__ v,      // [N, P, D]
                        float* __restrict__ out,         // [N, G, D]
                        int p_dim, int d_dim, int g, int a_tiles, int mrows,
                        int uniform) {
  __shared__ float w_s[kMaxG * kMaxP];  // [G][P]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t n = blockIdx.y;

  if (uniform) {
    for (int i = tid; i < g * p_dim; i += kThreads) w_s[i] = 1.0f;
  } else {
    for (int i = tid; i < g * p_dim; i += kThreads) {
      const int p = i / g, gg = i % g;
      const size_t m = n * p_dim + p;
      float s = 0.0f;
      for (int t = 0; t < a_tiles; ++t)
        s += part[((size_t)t * mrows + m) * g + gg];
      w_s[gg * p_dim + p] = s + b2[gg];
    }
  }
  __syncthreads();
  if (!uniform && warp < g) {  // warp gg: the softmax of glimpse gg
    float* w = w_s + warp * p_dim;
    float mx = -INFINITY;
    for (int p = lane; p < p_dim; p += 32) mx = fmaxf(mx, w[p]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float s = 0.0f;
    for (int p = lane; p < p_dim; p += 32) {
      const float e = expf(w[p] - mx);
      w[p] = e;
      s += e;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    __syncwarp();
    for (int p = lane; p < p_dim; p += 32) w[p] = round_bf16(w[p] / s);
  }
  __syncthreads();

  const int c = blockIdx.x * kPoolCols + 2 * tid;
  if (c >= d_dim) return;
  float acc[kMaxG][2];
#pragma unroll
  for (int gg = 0; gg < kMaxG; ++gg) acc[gg][0] = acc[gg][1] = 0.0f;
  const bf16* vn = v + n * p_dim * d_dim;
  for (int p = 0; p < p_dim; ++p) {
    const float2 x = __bfloat1622float2(
        *reinterpret_cast<const bf16x2*>(vn + (size_t)p * d_dim + c));
#pragma unroll
    for (int gg = 0; gg < kMaxG; ++gg)
      if (gg < g) {
        const float w = w_s[gg * p_dim + p];
        acc[gg][0] += w * x.x;
        acc[gg][1] += w * x.y;
      }
  }
#pragma unroll
  for (int gg = 0; gg < kMaxG; ++gg)
    if (gg < g) {
      float* o = out + (n * g + gg) * d_dim + c;
      o[0] = acc[gg][0];
      o[1] = acc[gg][1];
    }
}

}  // namespace

extern "C" {

int glimpse_attention_launch(const void* x, const void* w1, const void* b1,
                             const void* w2, const void* b2, const void* v,
                             void* part, void* out, int n, int p, int c,
                             int a, int g, int d, int uniform,
                             void* stream) {
  if (n < 1 || n > 65535 || p < 1 || p > kMaxP || c < 8 || c % 8 || a < 1 ||
      g < 1 || g > kMaxG || d < 2 || d % 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int mrows = n * p;
  const int a_tiles = (a + kTileA - 1) / kTileA;
  if (!uniform) {  // under the quirk the logits are value-dead
    const dim3 grid1(a_tiles, (mrows + kTileM - 1) / kTileM);
    glimpse_mlp_kernel<<<grid1, kThreads, 0, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
        static_cast<const float*>(b1), static_cast<const bf16*>(w2),
        static_cast<float*>(part), mrows, c, a, g);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid2((d + kPoolCols - 1) / kPoolCols, n);
  glimpse_pool_kernel<<<grid2, kThreads, 0, s>>>(
      static_cast<const float*>(part), static_cast<const float*>(b2),
      static_cast<const bf16*>(v), static_cast<float*>(out), p, d, g,
      a_tiles, mrows, uniform);
  return (int)cudaGetLastError();
}

const char* glimpse_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
