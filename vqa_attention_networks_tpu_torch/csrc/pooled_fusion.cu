// Pooled-site training grid fusion (bf16), its forward and backward,
// hand-written for Hopper (sm_90a): kernel K3.
//
// Replaces pooled_grid_fuse (vqa_attention_networks_tpu/ops/
// pallas_pooled_fusion.py): its forward kernel _fwd_kernel (_fwd_local),
// and its two backward kernels _bwd_img_kernel (_dimg_local) and
// _bwd_w_kernel (_dww_local). With F = O*k, channel c = o*k + j, and W, q
// bf16, b f32:
//
//   wq[n,d,o]  = sum_j f32(W[d,c]) * f32(q[n,c])   f32, j in order; -> bf16
//   bq[n,o]    = sum_j b[c] * f32(q[n,c])          f32, j in order
//   out[n,l,o] = signed_sqrt(img[n] @ bf16(wq[n]) + bq[n])   f32 [N, L, O]
//
//   g_pooled   = g * (out == 0 ? 0 : 0.5 / max(|out|, 1e-20))
//   d_img[n]   = bf16(g_pooled[n]) @ bf16(wq[n])^T           f32 [N, L, D]
//   d_wq[n]    = img[n]^T @ bf16(g_pooled[n])                f32 [D, O]
//   d_bq[n,o]  = sum_l g_pooled[n,l,o]                       f32
//   d_W[d,c]   = sum_n d_wq[n,d,o] * f32(q[n,c])             f32 [D, F]
//   d_b[c]     = sum_n d_bq[n,o] * f32(q[n,c])               f32 [F]
//   d_q[n,c]   = sum_d d_wq[n,d,o] * f32(W[d,c]) + d_bq[n,o] * b[c]
//
// The plain PyTorch version (ops/pooled_fusion.py) rounds at the same
// points: wq's sum over j is the same chain of unfused f32 adds (its
// products of two bf16 values are exact), so the bf16 wq the products see
// has the plain version's bits.
//
// The file also carries kernel K6, the standalone weight-contracted grid
// fusion with grid-flat L2: _wq_grid_fuse_pallas (vqa_attention_networks_
// tpu/ops/pallas_wq_fusion.py:88, its _kernel :56-85), the forward of the
// entry _wq_grid_fuse_tpu (:447-465). Its first stage is this forward, with
// the same operands and rounding points; then, per sample,
//
//   out[n]     = bf16(z * (1 / max(||z||, eps)))   z = the forward's out[n],
//                                                  the norm over all of [L, O]
//
// (the TPU kernel pads O to a multiple of 128 with columns that are exactly
// 0 and sliced off, so the grid here is [L, O]). The TPU instance sees a
// sample's whole grid and finishes the norm in-kernel; a block here sees
// 128 outputs of it, so the norm takes two more launches. At N = 256 K6's
// bound is ~0.29 ms of operations (the 205 GFLOP product and the 5.2 GFLOP
// f32 wq build); the norm's extra bytes (z written and read twice, f32, and
// the bf16 out) are ~0.15 ms at 3.35 TB/s, small beside the forward's time.
//
// What bounds it on this card, at N = 64, L = 196, D = 2048, O = 1000,
// k = 5. Each launch is one product of 2*N*L*D*O = 51.4 GFLOP (0.052 ms at
// 989 TFLOP/s bf16) plus f32 elementwise work: the wq build, 2*N*k*D*O =
// 1.3 GFLOP (forward, d_img), and d_W's and d_q's contractions with q and
// W, 4*N*D*F = 2.6 GFLOP (d_W). The bytes each must move once: forward
// ~121 MB (img, W, out), d_img ~224 MB (g, out, d_img in f32), d_W ~213 MB
// (g, out, img, W, d_W in f32); 0.036-0.067 ms at 3.35 TB/s. So the
// operations bound it (0.07-0.09 ms, the f32 work at 67 TFLOP/s added to
// the product's), and these first kernels use the tensor cores through
// WMMA (bf16 16x16x16, f32 accumulators). The forward and d_img have one
// shared-memory stage and no load in flight during the MMAs, and rebuild
// wq from W in L2 element by element: correct and simple, not yet fast.
//
// What the design does about the TPU's structure. The TPU kernel keeps the
// whole k-major W [k, D, O_pad] (20 MB bf16) resident in VMEM and rebuilds
// each sample's wq there; 227 KB of shared memory cannot hold it, so W is
// read in its natural [D, F] layout from L2 (20 MB fits the 50 MB L2) and
// each block builds the wq tile it needs in shared memory, once per
// (sample, D chunk, O tile). The TPU's d_W kernel accumulated d_W and d_b
// over consecutive sample revisits of a sequential grid; blocks here run in
// parallel, so a d_W block owns a (D tile, O tile) of d_W for all k and
// loops over the samples inside the block, with its k*64*64 f32 sums in
// dynamic shared memory (k <= 7 fits). d_q sums over D, across blocks: each
// block writes its D tile's partial sums, and a later launch of the same
// entry adds them in D-tile order. No atomics: reruns give the same bits.
// g_pooled is formed once per entry (bf16 for the products, its f32 sum
// over L for d_bq), not in each of the 32 D tiles that read it.
//
// Launches:
//   pooled_fusion_forward  grid (ceil(O/128), N): one sample's L <= 208
//       rows (13 row tiles of 16) and 128 outputs; per 32-deep D chunk it
//       builds the [32, 128] wq tile, then the MMAs; epilogue + bq, signed
//       sqrt -> out.
//   pooled_fusion_d_img    grid (ceil(D/128), N): one sample's rows and 128
//       columns of D; per 32-output chunk it rebuilds the [128, 32] wq tile
//       and bf16(g_pooled) [L, 32], then the MMAs.
//   pooled_fusion_d_w      four launches: g_pooled (bf16 [N, L, O8]) and
//       d_bq; d_b; d_W and d_q's partials, grid (ceil(O/64), ceil(D/64)),
//       each block streaming 64-row stages of img and g_pooled with
//       cp.async (the next stage in flight during this one's MMAs and
//       d_W's update): per sample, d_wq [64, 64] by MMA over L, added into
//       d_W's sums with q and contracted with the block's W tile (kept in
//       shared memory) into d_q's partial; then d_q's reduction over
//       ceil(N*F/256) blocks.
//   pooled_fusion_wq_grid  (K6) three launches: the forward into an f32 z
//       scratch; grid_ssq_kernel, grid (ceil(L*O/2048), N): each block's
//       sum of squares of 2048 elements of one sample's z in a fixed order;
//       grid_scale_kernel, the same grid: the sample's norm from those
//       sums in chunk order (no atomics: reruns give the same bits), and
//       bf16(z * (1 / max(norm, eps))).
// Each entry returns cudaGetLastError() after its launches (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = 8;
constexpr int kChunk = 32;      // contraction depth per shared-memory stage
constexpr int kLdChunk = kChunk + 8;  // padded against bank conflicts
constexpr int kRowTiles = 13;   // 13 x 16 = 208 rows >= L
constexpr int kRows = kRowTiles * 16;
constexpr int kFwdO = 128;      // forward: outputs per block, 16 per warp
constexpr int kLdFwdO = kFwdO + 8;
constexpr int kImgD = 128;      // d_img: D columns per block, 16 per warp
constexpr int kTileD = 64;      // d_W block: D rows
constexpr int kTileO = 64;      // d_W block: outputs
constexpr int kRowsW = 64;      // d_W: rows of img and g_pooled per stage
constexpr int kLdTile = kTileO + 8;   // img and g_pooled stages of d_W
constexpr int kLdWq = kTileO + 4;     // d_wq stage (f32)
constexpr int kMaxK = 7;        // d_W's k sums per (d, o) in shared memory
constexpr size_t kMaxSmem = 232448;   // dynamic shared memory of a block

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> AccFrag;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
    ARow;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>
    ACol;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
    BRow;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>
    BCol;

__device__ __forceinline__ float signed_sqrt(float p) {
  return __fsub_rn(sqrtf(fmaxf(p, 0.0f)), sqrtf(fmaxf(-p, 0.0f)));
}

// g * d out / d pooled, with the zero-cotangent rule at out == 0
__device__ __forceinline__ float pooled_grad(float g, float out) {
  if (out == 0.0f) return 0.0f;
  return __fmul_rn(g, __fdiv_rn(0.5f, fmaxf(fabsf(out), 1e-20f)));
}

__device__ __forceinline__ uint4 load16(const bf16* p, bool ok) {
  return ok ? *reinterpret_cast<const uint4*>(p) : make_uint4(0u, 0u, 0u, 0u);
}

// wq[d, o] = sum_j f32(W[d, o*k + j]) * qo[j] in f32, j in order, where qo
// holds f32(q[n, o*k + j]); 0 outside [0, D) x [0, O)
__device__ __forceinline__ float wq_at(const bf16* __restrict__ w,
                                       const float* qo, int dd, int o, int d,
                                       int o_dim, int f, int k) {
  if (dd >= d || o >= o_dim) return 0.0f;
  const bf16* wr = w + (size_t)dd * f + (size_t)o * k;
  float s = __fmul_rn(__bfloat162float(wr[0]), qo[0]);
  for (int j = 1; j < k; ++j)
    s = __fadd_rn(s, __fmul_rn(__bfloat162float(wr[j]), qo[j]));
  return s;
}

// stage the 13 row tiles of a warp's [208, 16] accumulator column in its
// buffer and hand each element to fn(row, col, value), 8 per lane a tile
template <typename Fn>
__device__ __forceinline__ void drain_rows(AccFrag (&acc)[kRowTiles],
                                           float* st, int lane, Fn fn) {
#pragma unroll
  for (int mt = 0; mt < kRowTiles; ++mt) {
    wmma::store_matrix_sync(st, acc[mt], 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) fn(mt * 16 + e / 16, e % 16, st[e]);
    __syncwarp();
  }
}

// 16 bytes global -> shared without a register round trip; zero-filled
// (nothing read) when !ok
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until all but the newest commit group have landed
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// ---------------------------------------------------------------------------
// forward: out = signed_sqrt(img @ bf16(wq) + bq)
// ---------------------------------------------------------------------------

// dynamic shared memory of fwd_kernel, in bytes
size_t fwd_smem(int k) {
  return (size_t)kWarps * 256 * 4                            // drain buffers
         + (size_t)kChunk * kLdFwdO * 2                      // wq tile
         + 2 * (size_t)kRows * kLdChunk * 2                  // img: 2 stages
         + 2 * (size_t)kChunk * (kFwdO * k + 8) * 2          // W: 2 stages
         + (size_t)kFwdO * k * 4 + kFwdO * 4;                // q, bq
}

__global__ void __launch_bounds__(kThreads)
    fwd_kernel(const bf16* __restrict__ img,  // [N, L, D]
               const bf16* __restrict__ w,    // [D, F]
               const float* __restrict__ b,   // [F]
               const bf16* __restrict__ q,    // [N, F]
               float* __restrict__ out,       // [N, L, O]
               int l, int d, int f, int k) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ld_w = kFwdO * k + 8;
  const int a_stage = kRows * kLdChunk, w_stage = kChunk * ld_w;
  float* stage_s = reinterpret_cast<float*>(smem);    // [8 warps][256]
  bf16* b_s = reinterpret_cast<bf16*>(stage_s + kWarps * 256);  // wq [d][o]
  bf16* a_s = b_s + kChunk * kLdFwdO;    // img[n] [2 stages][l][32 d]
  bf16* w_s = a_s + 2 * a_stage;         // W [2 stages][32 d][128k channels]
  float* q_s = reinterpret_cast<float*>(w_s + 2 * w_stage);  // [128 k]
  float* bq_s = q_s + kFwdO * k;                             // [128]

  const int o_dim = f / k;
  const int o0 = blockIdx.x * kFwdO, c0 = o0 * k;
  const int n = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const bf16* img_n = img + (size_t)n * l * d;
  const int chunks = (d + kChunk - 1) / kChunk;

  // copy the img and W rows of D chunk t into stage t & 1; one commit group
  // per call (empty past the end, so that "all but the newest group" is
  // always chunk t). c0 and F are multiples of 8.
  auto prefetch = [&](int t) {
    if (t < chunks) {
      const int d0 = t * kChunk;
      bf16* a = a_s + (t & 1) * a_stage;
      for (int i = tid; i < l * (kChunk / 8); i += kThreads) {
        const int r = i / (kChunk / 8), col = d0 + (i % (kChunk / 8)) * 8;
        cp_async16(a + r * kLdChunk + col - d0,
                   col < d ? img_n + (size_t)r * d + col : img_n, col < d);
      }
      bf16* ws = w_s + (t & 1) * w_stage;
      const int per_row = kFwdO * k / 8;
      for (int i = tid; i < kChunk * per_row; i += kThreads) {
        const int r = i / per_row, v = i % per_row;
        const int dd = d0 + r, c = c0 + v * 8;
        const bool ok = dd < d && c < f;
        cp_async16(ws + r * ld_w + v * 8, ok ? w + (size_t)dd * f + c : w,
                   ok);
      }
    }
    cp_async_commit();
  };

  prefetch(0);
  for (int i = tid; i < kFwdO * k; i += kThreads) {
    const int c = c0 + i;
    q_s[i] = c < f ? __bfloat162float(q[(size_t)n * f + c]) : 0.0f;
  }
  // rows [l, kRows) of both img stages are zero for the whole kernel
  for (int i = l * kLdChunk + tid; i < kRows * kLdChunk; i += kThreads) {
    a_s[i] = __float2bfloat16(0.0f);
    a_s[a_stage + i] = __float2bfloat16(0.0f);
  }
  __syncthreads();
  if (tid < kFwdO) {
    const int o = o0 + tid;
    float s = 0.0f;
    if (o < o_dim) {
      s = __fmul_rn(b[o * k], q_s[tid * k]);
      for (int j = 1; j < k; ++j)
        s = __fadd_rn(s, __fmul_rn(b[o * k + j], q_s[tid * k + j]));
    }
    bq_s[tid] = s;
  }

  AccFrag acc[kRowTiles];
#pragma unroll
  for (int mt = 0; mt < kRowTiles; ++mt) wmma::fill_fragment(acc[mt], 0.0f);

  for (int t = 0; t < chunks; ++t) {
    prefetch(t + 1);  // in flight during this chunk's wq build and MMAs
    cp_async_wait_prior();
    __syncthreads();
    // the [32, 128] wq tile from the W stage: the f32 chain over j, then
    // one bf16 rounding (0 past O, and past D where W's rows are 0)
    const bf16* ws = w_s + (t & 1) * w_stage;
    for (int i = tid; i < kChunk * kFwdO; i += kThreads) {
      const int r = i / kFwdO, oo = i % kFwdO;
      float s = 0.0f;
      if (o0 + oo < o_dim) {
        const bf16* wr = ws + r * ld_w + oo * k;
        const float* qo = q_s + oo * k;
        s = __fmul_rn(__bfloat162float(wr[0]), qo[0]);
        for (int j = 1; j < k; ++j)
          s = __fadd_rn(s, __fmul_rn(__bfloat162float(wr[j]), qo[j]));
      }
      b_s[r * kLdFwdO + oo] = __float2bfloat16(s);
    }
    __syncthreads();
    const bf16* a = a_s + (t & 1) * a_stage;
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk) {
      BRow bfr;
      wmma::load_matrix_sync(bfr, b_s + kk * 16 * kLdFwdO + warp * 16,
                             kLdFwdO);
#pragma unroll
      for (int mt = 0; mt < kRowTiles; ++mt) {
        ARow af;
        wmma::load_matrix_sync(af, a + mt * 16 * kLdChunk + kk * 16,
                               kLdChunk);
        wmma::mma_sync(acc[mt], af, bfr, acc[mt]);
      }
    }
    __syncthreads();  // b_s and stage t & 1 are free for chunk t + 2
  }

  const int ob = warp * 16;
  drain_rows(acc, stage_s + warp * 256, lane, [&](int row, int cc, float v) {
    const int o = o0 + ob + cc;
    if (row < l && o < o_dim)
      out[((size_t)n * l + row) * o_dim + o] =
          signed_sqrt(__fadd_rn(v, bq_s[ob + cc]));
  });
}

// ---------------------------------------------------------------------------
// d_img = bf16(g_pooled) @ bf16(wq)^T
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
    d_img_kernel(const float* __restrict__ g,    // [N, L, O]
                 const float* __restrict__ out,  // [N, L, O]
                 const bf16* __restrict__ w,     // [D, F]
                 const bf16* __restrict__ q,     // [N, F]
                 float* __restrict__ d_img,      // [N, L, D]
                 int l, int d, int f, int k) {
  __shared__ __align__(128) bf16 a_s[kRows * kLdChunk];   // g_pooled [l][o]
  __shared__ __align__(128) bf16 b_s[kImgD * kLdChunk];   // wq [d][o]
  __shared__ __align__(128) float stage_s[kWarps][256];
  __shared__ float q_s[kChunk * kMaxK];

  const int o_dim = f / k;
  const int dt0 = blockIdx.x * kImgD;
  const int n = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  for (int i = l * kLdChunk + tid; i < kRows * kLdChunk; i += kThreads)
    a_s[i] = __float2bfloat16(0.0f);

  AccFrag acc[kRowTiles];
#pragma unroll
  for (int mt = 0; mt < kRowTiles; ++mt) wmma::fill_fragment(acc[mt], 0.0f);

  for (int o0 = 0; o0 < o_dim; o0 += kChunk) {
    for (int i = tid; i < kChunk * k; i += kThreads) {
      const int c = o0 * k + i;
      q_s[i] = c < f ? __bfloat162float(q[(size_t)n * f + c]) : 0.0f;
    }
    // bf16(g_pooled) [l, 32]; a warp reads 32 neighbouring outputs of a row
    for (int i = tid; i < l * kChunk; i += kThreads) {
      const int r = i / kChunk, oo = i % kChunk, o = o0 + oo;
      float v = 0.0f;
      if (o < o_dim) {
        const size_t p = ((size_t)n * l + r) * o_dim + o;
        v = pooled_grad(g[p], out[p]);
      }
      a_s[r * kLdChunk + oo] = __float2bfloat16(v);
    }
    __syncthreads();  // q_s
    for (int i = tid; i < kImgD * kChunk; i += kThreads) {
      const int r = i / kChunk, oo = i % kChunk;
      b_s[r * kLdChunk + oo] = __float2bfloat16(
          wq_at(w, q_s + oo * k, dt0 + r, o0 + oo, d, o_dim, f, k));
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk) {
      BCol bfr;  // element (o, d) at b_s[d * ld + o]
      wmma::load_matrix_sync(bfr, b_s + warp * 16 * kLdChunk + kk * 16,
                             kLdChunk);
#pragma unroll
      for (int mt = 0; mt < kRowTiles; ++mt) {
        ARow af;
        wmma::load_matrix_sync(af, a_s + mt * 16 * kLdChunk + kk * 16,
                               kLdChunk);
        wmma::mma_sync(acc[mt], af, bfr, acc[mt]);
      }
    }
    __syncthreads();
  }

  const int db = dt0 + warp * 16;
  drain_rows(acc, stage_s[warp], lane, [&](int row, int cc, float v) {
    if (row < l && db + cc < d)
      d_img[((size_t)n * l + row) * d + db + cc] = v;
  });
}

// ---------------------------------------------------------------------------
// d_W, d_b and d_q's partial sums per D tile; d_q's reduction
// ---------------------------------------------------------------------------

// g_pooled once: bf16 [N, L, O8] (0 past O) for the d_W products, and
// d_bq[n, o] = sum_l g_pooled in f32, in l order
__global__ void __launch_bounds__(kThreads)
    g_pooled_kernel(const float* __restrict__ g,    // [N, L, O]
                    const float* __restrict__ out,  // [N, L, O]
                    bf16* __restrict__ gp,          // [N, L, O8]
                    float* __restrict__ d_bq,       // [N, O]
                    int l, int o_dim, int o8) {
  const int o = blockIdx.x * kThreads + threadIdx.x;
  const int n = blockIdx.y;
  if (o >= o8) return;
  float s = 0.0f;
  for (int r = 0; r < l; ++r) {
    float v = 0.0f;
    if (o < o_dim) {
      const size_t p = ((size_t)n * l + r) * o_dim + o;
      v = pooled_grad(g[p], out[p]);
      s = __fadd_rn(s, v);
    }
    gp[((size_t)n * l + r) * o8 + o] = __float2bfloat16(v);
  }
  if (o < o_dim) d_bq[(size_t)n * o_dim + o] = s;
}

// d_b[c] = sum_n d_bq[n, o] * q[n, c], in sample order
__global__ void __launch_bounds__(kThreads)
    d_b_kernel(const float* __restrict__ d_bq,  // [N, O]
               const bf16* __restrict__ q,      // [N, F]
               float* __restrict__ d_b,         // [F]
               int nn, int f, int k) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= f) return;
  const int o_dim = f / k;
  float s = 0.0f;
  for (int n = 0; n < nn; ++n)
    s = __fadd_rn(s, __fmul_rn(d_bq[(size_t)n * o_dim + c / k],
                               __bfloat162float(q[(size_t)n * f + c])));
  d_b[c] = s;
}

// dynamic shared memory of d_w_kernel, in bytes
size_t d_w_smem(int k) {
  return (size_t)k * kTileD * kTileO * 4          // d_W sums
         + (size_t)kTileD * kLdWq * 4             // d_wq stage
         + (size_t)kTileD * (kTileO * k + 8) * 2  // W tile
         + 2 * 2 * (size_t)kRowsW * kLdTile * 2   // img, g_pooled: 2 stages
         + (size_t)kTileO * k * 4;                // q
}

__global__ void __launch_bounds__(kThreads)
    d_w_kernel(const bf16* __restrict__ gp,   // [N, L, O8]
               const bf16* __restrict__ img,  // [N, L, D]
               const bf16* __restrict__ w,    // [D, F]
               const bf16* __restrict__ q,    // [N, F]
               float* __restrict__ d_w,       // [D, F]
               float* __restrict__ parts,     // [D tiles, N, F]
               int nn, int l, int d, int f, int k, int o8) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ld_w = kTileO * k + 8;
  const int stage = kRowsW * kLdTile;  // elements of one img or g stage
  float* sums_s = reinterpret_cast<float*>(smem);       // [k][64 d][64 o]
  float* wq_s = sums_s + k * kTileD * kTileO;            // [64 d][kLdWq]
  bf16* w_s = reinterpret_cast<bf16*>(wq_s + kTileD * kLdWq);  // [64][ld_w]
  bf16* a_s = w_s + kTileD * ld_w;   // img [2 stages][64 l][64 d]
  bf16* g_s = a_s + 2 * stage;       // g_pooled [2 stages][64 l][64 o]
  float* q_s = reinterpret_cast<float*>(g_s + 2 * stage);  // [64 k]

  const int o0 = blockIdx.x * kTileO, c0 = o0 * k;
  const int dt0 = blockIdx.y * kTileD;
  const int cw = kTileO * k;  // channels of the block's outputs
  const int tid = threadIdx.x, warp = tid / 32;
  const int wr = warp % 4;        // the warp's 16 d rows of d_wq
  const int wc = (warp / 4) * 2;  // and its two 16-output column tiles
  const int chunks = (l + kRowsW - 1) / kRowsW;
  const int total = nn * chunks;  // stages: (sample, 64-row chunk)

  // copy stage t into buffer t & 1; one commit group per call (empty past
  // the end, so that "all but the newest group" is always stage t)
  auto prefetch = [&](int t) {
    if (t < total) {
      const int n = t / chunks, l0 = (t % chunks) * kRowsW;
      bf16* a = a_s + (t & 1) * stage;
      bf16* gg = g_s + (t & 1) * stage;
      for (int i = tid; i < kRowsW * 8; i += kThreads) {
        const int r = i / 8, v = i % 8, row = l0 + r;
        const int col = dt0 + v * 8, oc = o0 + v * 8;
        const bool ok_a = row < l && col < d, ok_g = row < l && oc < o8;
        cp_async16(a + r * kLdTile + v * 8,
                   ok_a ? img + ((size_t)n * l + row) * d + col : img, ok_a);
        cp_async16(gg + r * kLdTile + v * 8,
                   ok_g ? gp + ((size_t)n * l + row) * o8 + oc : gp, ok_g);
      }
    }
    cp_async_commit();
  };

  prefetch(0);
  // the W tile [64 d][cw channels], read once; c0 and F are multiples of 8
  for (int i = tid; i < kTileD * (cw / 8); i += kThreads) {
    const int r = i / (cw / 8), v = i % (cw / 8);
    const int dd = dt0 + r, c = c0 + v * 8;
    *reinterpret_cast<uint4*>(w_s + r * ld_w + v * 8) =
        load16(w + (size_t)dd * f + c, dd < d && c < f);
  }
  for (int i = tid; i < k * kTileD * kTileO; i += kThreads) sums_s[i] = 0.0f;

  AccFrag acc[2];
  for (int t = 0; t < total; ++t) {
    const int n = t / chunks, chunk = t % chunks;
    if (chunk == 0) {
      // q of sample n; its last readers passed the previous sample's sync
      for (int i = tid; i < cw; i += kThreads) {
        const int c = c0 + i;
        q_s[i] = c < f ? __bfloat162float(q[(size_t)n * f + c]) : 0.0f;
      }
      wmma::fill_fragment(acc[0], 0.0f);
      wmma::fill_fragment(acc[1], 0.0f);
    }
    prefetch(t + 1);  // in flight during this stage's MMAs and d_W's update
    cp_async_wait_prior();
    __syncthreads();
    const bf16* a = a_s + (t & 1) * stage;
    const bf16* gg = g_s + (t & 1) * stage;
#pragma unroll
    for (int kk = 0; kk < kRowsW / 16; ++kk) {
      ACol af;  // element (d, l) at a[l * ld + d]
      wmma::load_matrix_sync(af, a + kk * 16 * kLdTile + wr * 16, kLdTile);
#pragma unroll
      for (int tt = 0; tt < 2; ++tt) {
        BRow bfr;
        wmma::load_matrix_sync(bfr, gg + kk * 16 * kLdTile + (wc + tt) * 16,
                               kLdTile);
        wmma::mma_sync(acc[tt], af, bfr, acc[tt]);
      }
    }
    __syncthreads();  // buffer t & 1 is free for stage t + 2
    if (chunk < chunks - 1) continue;

    // d_wq [64 d][64 o] of sample n, in shared memory
#pragma unroll
    for (int tt = 0; tt < 2; ++tt)
      wmma::store_matrix_sync(wq_s + wr * 16 * kLdWq + (wc + tt) * 16,
                              acc[tt], kLdWq, wmma::mem_row_major);
    __syncthreads();
    // d_W sums: + d_wq * q, in sample order
    for (int e = tid; e < kTileD * kTileO; e += kThreads) {
      const int dd = e / kTileO, oo = e % kTileO;
      const float v = wq_s[dd * kLdWq + oo];
      for (int j = 0; j < k; ++j) {
        float* s = sums_s + (j * kTileD + dd) * kTileO + oo;
        *s = __fadd_rn(*s, __fmul_rn(v, q_s[oo * k + j]));
      }
    }
    // d_q's partial over this D tile: sum_d d_wq[d, o] * W[d, c], in d order
    for (int cc = tid; cc < cw; cc += kThreads) {
      const int c = c0 + cc;
      if (c < f) {
        const int oo = cc / k;
        float s = 0.0f;
        for (int dd = 0; dd < kTileD; ++dd)
          s = __fadd_rn(s, __fmul_rn(wq_s[dd * kLdWq + oo],
                                     __bfloat162float(w_s[dd * ld_w + cc])));
        parts[((size_t)blockIdx.y * nn + n) * f + c] = s;
      }
    }
    __syncthreads();  // q_s and wq_s are rewritten for the next sample
  }

  for (int i = tid; i < kTileD * cw; i += kThreads) {
    const int dd = i / cw, cc = i % cw;
    const int row = dt0 + dd, c = c0 + cc;
    if (row < d && c < f)
      d_w[(size_t)row * f + c] =
          sums_s[((cc % k) * kTileD + dd) * kTileO + cc / k];
  }
}

// d_q[n, c] = (sum of the D tiles' partials, in tile order) + d_bq * b
__global__ void __launch_bounds__(kThreads)
    d_q_reduce_kernel(const float* __restrict__ parts,  // [tiles, N, F]
                      const float* __restrict__ d_bq,   // [N, O]
                      const float* __restrict__ b,      // [F]
                      float* __restrict__ d_q,          // [N, F]
                      int nn, int f, int k, int tiles) {
  const size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x;
  const size_t total = (size_t)nn * f;
  if (i >= total) return;
  const int n = (int)(i / f), c = (int)(i % f);
  float s = parts[i];
  for (int t = 1; t < tiles; ++t) s = __fadd_rn(s, parts[t * total + i]);
  d_q[i] = __fadd_rn(s, __fmul_rn(d_bq[(size_t)n * (f / k) + c / k], b[c]));
}

// ---------------------------------------------------------------------------
// K6's grid-flat L2 over the forward's output z [N, L, O]:
// out = bf16(z * (1 / max(||z[n]||, eps)))
// ---------------------------------------------------------------------------
constexpr int kNormItems = 8;                      // elements per thread
constexpr int kNormChunk = kThreads * kNormItems;  // elements per block

// the sum of squares of one kNormChunk-element chunk of a sample's z, in a
// fixed order: each thread's items, the warp's lanes, the block's warps
__global__ void __launch_bounds__(kThreads)
    grid_ssq_kernel(const float* __restrict__ z,  // [N, L*O]
                    float* __restrict__ ssq,      // [N, chunks]
                    int grid_size) {
  __shared__ float red_s[kWarps];
  const int n = blockIdx.y, tid = threadIdx.x;
  const float* zn = z + (size_t)n * grid_size;
  const int base = blockIdx.x * kNormChunk + tid;
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < kNormItems; ++i) {
    const int e = base + i * kThreads;
    if (e < grid_size) s = __fadd_rn(s, __fmul_rn(zn[e], zn[e]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
  if (tid % 32 == 0) red_s[tid / 32] = s;
  __syncthreads();
  if (tid == 0) {
    float t = red_s[0];
    for (int w = 1; w < kWarps; ++w) t = __fadd_rn(t, red_s[w]);
    ssq[(size_t)n * gridDim.x + blockIdx.x] = t;
  }
}

// the sample's norm from its chunks' sums, in chunk order (no atomics:
// reruns give the same bits), then the scaled bf16 output
__global__ void __launch_bounds__(kThreads)
    grid_scale_kernel(const float* __restrict__ z,    // [N, L*O]
                      const float* __restrict__ ssq,  // [N, chunks]
                      bf16* __restrict__ out,         // [N, L*O]
                      int grid_size, float eps) {
  __shared__ float inv_s;
  const int n = blockIdx.y;
  if (threadIdx.x == 0) {
    const float* part = ssq + (size_t)n * gridDim.x;
    float t = part[0];
    for (int i = 1; i < (int)gridDim.x; ++i) t = __fadd_rn(t, part[i]);
    inv_s = __fdiv_rn(1.0f, fmaxf(sqrtf(t), eps));
  }
  __syncthreads();
  const float inv = inv_s;
  const float* zn = z + (size_t)n * grid_size;
  bf16* on = out + (size_t)n * grid_size;
  const int base = blockIdx.x * kNormChunk + threadIdx.x;
#pragma unroll
  for (int i = 0; i < kNormItems; ++i) {
    const int e = base + i * kThreads;
    if (e < grid_size) on[e] = __float2bfloat16(__fmul_rn(zn[e], inv));
  }
}

bool dims_ok(int n, int l, int d, int f, int k) {
  return n >= 1 && n <= 65535 && l >= 1 && l <= kRows && d >= 8 &&
         d % 8 == 0 && k >= 1 && k <= kMaxK && f >= k && f % k == 0 &&
         f % 8 == 0;
}

}  // namespace

extern "C" {

int pooled_fusion_forward(const void* img, const void* w, const void* b,
                          const void* q, void* out, int n, int l, int d,
                          int f, int k, void* stream) {
  if (!dims_ok(n, l, d, f, k)) return (int)cudaErrorInvalidValue;
  const size_t smem = fwd_smem(k);
  const cudaError_t err = cudaFuncSetAttribute(
      fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((f / k + kFwdO - 1) / kFwdO, n);
  fwd_kernel<<<grid, kThreads, smem,
               reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(img), static_cast<const bf16*>(w),
      static_cast<const float*>(b), static_cast<const bf16*>(q),
      static_cast<float*>(out), l, d, f, k);
  return (int)cudaGetLastError();
}

// K6: the forward into z (f32 scratch [N, L, O]), then the grid-flat L2
// into out (bf16 [N, L, O]); ssq is scratch [N, ceil(L*O / 2048)]
int pooled_fusion_wq_grid(const void* img, const void* w, const void* b,
                          const void* q, void* z, void* ssq, void* out, int n,
                          int l, int d, int f, int k, float eps,
                          void* stream) {
  if (!dims_ok(n, l, d, f, k) || (size_t)l * (f / k) >= (1u << 31))
    return (int)cudaErrorInvalidValue;
  const int err = pooled_fusion_forward(img, w, b, q, z, n, l, d, f, k,
                                        stream);
  if (err != 0) return err;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int grid_size = l * (f / k);
  const dim3 grid((grid_size + kNormChunk - 1) / kNormChunk, n);
  grid_ssq_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(z), static_cast<float*>(ssq), grid_size);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  grid_scale_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(z), static_cast<const float*>(ssq),
      static_cast<bf16*>(out), grid_size, eps);
  return (int)cudaGetLastError();
}

int pooled_fusion_d_img(const void* g, const void* out, const void* w,
                        const void* q, void* d_img, int n, int l, int d,
                        int f, int k, void* stream) {
  if (!dims_ok(n, l, d, f, k)) return (int)cudaErrorInvalidValue;
  const dim3 grid((d + kImgD - 1) / kImgD, n);
  d_img_kernel<<<grid, kThreads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const float*>(out),
      static_cast<const bf16*>(w), static_cast<const bf16*>(q),
      static_cast<float*>(d_img), l, d, f, k);
  return (int)cudaGetLastError();
}

int pooled_fusion_d_w(const void* g, const void* out, const void* img,
                      const void* w, const void* b, const void* q, void* d_w,
                      void* d_b, void* d_q, void* gp, void* d_bq, void* parts,
                      int n, int l, int d, int f, int k, void* stream) {
  const size_t smem = d_w_smem(k);
  if (!dims_ok(n, l, d, f, k) || smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int o_dim = f / k, o8 = (o_dim + 7) / 8 * 8;
  g_pooled_kernel<<<dim3((o8 + kThreads - 1) / kThreads, n), kThreads, 0,
                    s>>>(static_cast<const float*>(g),
                         static_cast<const float*>(out),
                         static_cast<bf16*>(gp), static_cast<float*>(d_bq),
                         l, o_dim, o8);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  d_b_kernel<<<(f + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      static_cast<const float*>(d_bq), static_cast<const bf16*>(q),
      static_cast<float*>(d_b), n, f, k);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      d_w_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (d + kTileD - 1) / kTileD;
  const dim3 grid((o_dim + kTileO - 1) / kTileO, tiles);
  d_w_kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const bf16*>(gp), static_cast<const bf16*>(img),
      static_cast<const bf16*>(w), static_cast<const bf16*>(q),
      static_cast<float*>(d_w), static_cast<float*>(parts), n, l, d, f, k,
      o8);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t total = (size_t)n * f;
  d_q_reduce_kernel<<<(unsigned)((total + kThreads - 1) / kThreads), kThreads,
                      0, s>>>(
      static_cast<const float*>(parts), static_cast<const float*>(d_bq),
      static_cast<const float*>(b), static_cast<float*>(d_q), n, f, k, tiles);
  return (int)cudaGetLastError();
}

const char* pooled_fusion_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
