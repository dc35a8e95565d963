// Training-mode grid fusion with pre-pool dropout (mhb_coAtt, bf16), its
// forward and backward, hand-written for Hopper (sm_90a).
//
// Replaces train_grid_fuse (vqa_attention_networks_tpu/ops/
// pallas_train_fusion.py): its forward kernel _fwd_kernel and its two
// backward kernels _bwd_img_kernel and _bwd_w_kernel. With F = O*k and
// channel c = o*k + j, m = n*L + l the flat row:
//
//   z0[m,c]   = bf16(img)[m,:] @ bf16(W)[:,c] (f32 accumulate) + b[c]
//   zd[m,c]   = (z0 * q[n,c]) * (mask[m,c] * inv_keep)
//   out[m,o]  = signed_sqrt(sum_j zd[m, o*k+j])            f32 [N*L, O]
//
//   g_pooled  = g * (out == 0 ? 0 : 0.5 / max(|out|, 1e-20))
//   g_prod    = (g_pooled[m,o] * (mask * inv_keep)) * q[n,c]    f32
//   d_img     = bf16(g_prod) @ bf16(W)^T        -> bf16 [N*L, D]
//   d_W       = bf16(img)^T @ bf16(g_prod)      -> f32 [D, F]
//   d_b       = sum_m g_prod (the f32 g_prod)   -> f32 [F]
//   d_q[n,c]  = sum_l (g_pooled * (mask * inv_keep)) * z0   -> f32 [N, F]
//
// The mask is Philox4x32-10, key (seed, 0), counter (i, i >> 32, 0, 0) for
// the flat element index i = (row0*L + m)*F_total + col0 + c, kept iff
// word 0 < thr. row0 is the global index of the launch's first sample: a
// rank of a data-parallel run holds samples [row0, row0 + N) of the global
// batch. col0 and F_total place the launch's F columns in the global
// fusion width: a rank of a tensor-parallel run holds columns [col0, col0 +
// F) of F_total. So the ranks draw the mask one process draws (row0 = col0
// = 0 and F_total = F there, the bits this kernel always drew; a shard
// padded with zero columns draws bits for them that no output reads).
// It depends on the element and
// the seed only, so the launches (and the plain PyTorch version in
// ops/train_fusion.py) replay the same bits whatever their tiling; thr == 0
// means rate 0, and then no bits are drawn. z0 and the mask never reach
// device memory: the only residual is out.
//
// What bounds it on this card. Each of the forward, d_img, d_W and d_q is
// a product of 2*N*L*D*F operations, 257 GFLOP at N = 64, L = 196,
// D = 2048, F = 5000; the operands are a few tens of MB. So the tensor
// cores bound it. The forward (also K5, 1.03 TFLOP at N = 256) is a
// pipelined Hopper GEMM: a tile of 256 rows x 32 outputs (160 channels at
// k = 5), a 4-stage TMA ring that thread 0 keeps three stages ahead, and
// two warpgroups on wgmma, with the bias, q, mask, k-pool and signed sqrt
// in the epilogue; its L2 traffic, (256 + 160) x 2 B per depth step of a
// 256 x 160 tile, ~10 GB at N = 256, is what holds it above its bound.
// d_q recomputes z0, as the TPU kernel does (z0 is never stored), with the
// forward's product turned around: a block owns one sample and 128
// channels, and the sample's L rows are wgmma's N, so that no row of
// another sample enters the tile and L = 196 pads to 200, not 256. Its L2
// traffic is ~3.4 GB at N = 64 (each block reads its sample's img, 0.80
// MB, and a 2048 x 128 slab of W, 0.52 MB), which a 5-stage TMA ring
// streams at several TB/s; what is left of its time is the epilogue's
// Philox draws (62.7 M at N = 64), which run while the SM's second block
// loads and multiplies. d_W and d_img share one g_prod build (bound by its
// ~230 MB of bytes, ~0.07 ms); each is then a pipelined product over it,
// bound by its operations (0.26 ms). d_img's (launched only when img needs
// a gradient) is the forward's GEMM with no epilogue work: both of its
// operands, g_prod [M, F] and W [D, F], have F contiguous, the K-major
// layout wgmma reads as it is, so a 4-stage TMA ring of 64-deep stages
// feeds two warpgroups on wgmma m64n256k16 (128 x 256 tiles, 784 of them
// at N = 64: 5.9 waves over 132 SMs; 256 x 128 tiles ran as fast on an
// H100), and past F both operands come in as zeros.
//
// What the design does about the TPU's structure. The TPU kernels carried
// d_img and d_W/d_b across sequential grid steps in VMEM scratch. Blocks
// here run in parallel and in no order, so each block owns its output
// tile and loops over the whole contraction inside the block: no atomics,
// and reruns give the same bits. W is read in its natural [D, F] layout
// (no per-step refactor to [k, D, O_pad]: W changes every step).
//
// The g_prod build is this card's choice, not the TPU kernel's: the TPU
// never wrote g_prod to HBM, and built it in VMEM inside its d_img and
// d_W passes. Here a d_W block owns 128 d x 128 channels and walks all M
// rows, and a d_img block 128 rows x 256 d and all of F, so building g_prod
// inside a product would redo it in each of 16 (d_W) or 8 (d_img) D
// tiles: ~1.0 G Philox draws where 62.7 M suffice (N = 64), ~19 ms of a
// first d_W design's 21.5 on an H100. Instead one launch builds it once,
// elementwise, and writes it as bf16 (125 MB at N = 64, ~0.04 ms of
// bandwidth at 3.35 TB/s), with f32 d_b partials of 64 rows each summed in
// row order. The d_W product reads it
// through a 4-stage cp.async ring (three 16 KB stages in flight) of 32-row
// stages of img and g_prod, on mma.sync m16n8k16 with ldmatrix.trans for
// both operands (each has M, the contraction axis, as its strided axis), 8
// warps of 64 d x 32 channels; the blocks of the first D tile also sum the
// d_b partials in chunk order.
//
// Launches:
//   train_fusion_forward  grid (ceil(O/32), ceil(M/rows)): a [rows, 32k]
//       tile of z0 = img @ W by wgmma (rows = 256 for k <= 5, 128 above,
//       where the accumulators of 32k channels fill the registers), then
//       bias, *q, mask, k-pool and signed sqrt in the epilogue -> out
//       [rows, 32].
//   train_fusion_inference_forward  the same kernel with the mask compiled
//       out: kernel K5, the inference fusion (pallas_fusion.py
//       _grid_fuse_pallas), which computes exactly the forward at rate 0.
//   train_fusion_d_img    grid (ceil(D/256), ceil(M/128)): a [128, 256]
//       d_img tile = g_prod @ W^T by wgmma over all of F, from the g_prod
//       build's operand; bf16 out through a staged tile.
//   train_fusion_g_prod   grid (ceil(F/256), ceil(M/64)): one channel per
//       thread over 64 rows -> bf16 g_prod [M, F] and the f32 d_b partial
//       of those rows [ceil(M/64), F].
//   train_fusion_d_w      grid (ceil(F/128), ceil(D/128)): a [128, 128]
//       d_W tile = bf16(img)^T @ g_prod over all M rows; the blocks of the
//       first D tile sum d_b from the partials.
//   train_fusion_d_q      grid (ceil(F/128), N): recomputes z0^T for one
//       128-channel tile and the sample's L rows by wgmma (W MN-major as A,
//       img as B), stages it in shared memory, and reduces over L with the
//       mask replayed, one channel per thread and half of the rows each.
// Each entry returns cudaGetLastError() after its launch (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;  // 8 warps
constexpr int kMaxRows = 208;   // L rows: d_q's wgmma N (200, or 208 past 200)
constexpr int kMaxK = 8;

// Word 0 of Philox4x32-10 at key (seed, 0), counter (idx, idx >> 32, 0, 0).
__device__ __forceinline__ uint32_t philox_word0(uint32_t seed,
                                                 unsigned long long idx) {
  uint32_t c0 = (uint32_t)idx, c1 = (uint32_t)(idx >> 32), c2 = 0u, c3 = 0u;
  uint32_t k0 = seed, k1 = 0u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c1 = lo1;
    c3 = lo0;
    c0 = n0;
    c2 = n2;
  }
  return c0;
}

// mask * inv_keep for element idx (only called when thr != 0)
__device__ __forceinline__ float keep_scale(uint32_t seed, uint32_t thr,
                                            float inv_keep,
                                            unsigned long long idx) {
  return philox_word0(seed, idx) < thr ? inv_keep : 0.0f;
}

__device__ __forceinline__ float signed_sqrt(float p) {
  return __fsub_rn(sqrtf(fmaxf(p, 0.0f)), sqrtf(fmaxf(-p, 0.0f)));
}

// g * d out / d pooled, with the zero-cotangent rule at out == 0
__device__ __forceinline__ float pooled_grad(float g, float out) {
  if (out == 0.0f) return 0.0f;
  return __fmul_rn(g, __fdiv_rn(0.5f, fmaxf(fabsf(out), 1e-20f)));
}

// ---------------------------------------------------------------------------
// forward: out = signed_sqrt(k-pool(((img @ W + b) * q) * mask * inv_keep))
// ---------------------------------------------------------------------------
// A tile is kRows rows of img x 32 outputs (32 K channels, so the k-pool
// stays inside it), computed by two warpgroups of kMT m64 row tiles each.
// Thread 0 keeps a ring of kStages stages full with TMA (img [kRows, 64]
// with 128-byte swizzle, W [64, 32 K] as K boxes of 32 channels with
// 64-byte swizzle), three stages ahead: each stage's "full" barrier counts
// its bytes, its "empty" barrier the 8 warps' releases. The warpgroups run
// wgmma m64n(32K)k16 (A = img K-major, B = W MN-major), one stage's group
// in flight while the next stage is awaited.
constexpr int kFwdOut = 32;        // pooled outputs per tile
constexpr int kFwdDepth = 64;      // D per ring stage: a 128-byte img row
constexpr int kFwdConsumers = 2;   // warpgroups
constexpr int kFwdThreads = kFwdConsumers * 128;
constexpr int kFwdAtom = 32 * kFwdDepth * 2;  // one 32-channel W box

template <int K>
struct FwdShape {
  static constexpr int kMT = K <= 5 ? 2 : 1;  // m64 tiles per warpgroup
  static constexpr int kRows = kFwdConsumers * 64 * kMT;
  static constexpr int kCols = kFwdOut * K;
  static constexpr int kABytes = kRows * kFwdDepth * 2;
  static constexpr int kStageBytes = kABytes + K * kFwdAtom;
  static constexpr int kStages = 4;
  static constexpr int kLd = kCols + 4;  // f32 row of the epilogue's tile
  static constexpr int kRing = kStages * kStageBytes;
  static constexpr int kTile = kRows * kLd * 4;
  // 1 KB of alignment slack, 1 KB of barriers, then the ring (reused as
  // the epilogue's f32 tile)
  static constexpr int kSmem = 2048 + (kRing > kTile ? kRing : kTile);
};

// kMask false compiles the mask out: the inference fusion (K5)
template <int K, bool kMask>
__global__ void __launch_bounds__(kFwdThreads, 1)
    fwd_kernel(const __grid_constant__ CUtensorMap img_map,  // [M, D] bf16
               const __grid_constant__ CUtensorMap w_map,    // [D, F] bf16
               const float* __restrict__ b,  // [F]
               const float* __restrict__ q,  // [N, F]
               float* __restrict__ out,      // [M, O]
               int mrows, int l, int d, int f, uint32_t seed, uint32_t thr,
               float inv_keep, unsigned long long base, int f_mask) {
  using S = FwdShape<K>;
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + S::kStages;
  unsigned char* ring = smem + 1024;

  const int o_dim = f / K;
  const int o0 = blockIdx.x * kFwdOut, c0 = o0 * K;
  const int m0 = blockIdx.y * S::kRows;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int steps = (d + kFwdDepth - 1) / kFwdDepth;
  // W boxes wholly past F are not loaded: their channels belong to outputs
  // past O, which the epilogue drops
  const int atoms = min(K, (f - c0 + 31) / 32);

  if (tid == 0) {
    for (int s = 0; s < S::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kFwdConsumers * 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // step kt into stage kt % kStages, requested by thread 0 (every thread
  // walks the same path: see mbar_expect_tx)
  const bool leader = tid == 0;
  auto load = [&](int kt) {
    const int s = kt % S::kStages;
    unsigned char* a = ring + s * S::kStageBytes;
    mbar_expect_tx(&full[s], S::kABytes + atoms * kFwdAtom, leader);
    tma_load_2d(a, &img_map, &full[s], kt * kFwdDepth, m0, leader);
    for (int at = 0; at < atoms; ++at)
      tma_load_2d(a + S::kABytes + at * kFwdAtom, &w_map, &full[s],
                  c0 + 32 * at, kt * kFwdDepth, leader);
  };
  for (int kt = 0; kt < S::kStages - 1 && kt < steps; ++kt) load(kt);

  const int wg = warp / 4;
  float acc[S::kMT][S::kCols / 2];
#pragma unroll
  for (int mt = 0; mt < S::kMT; ++mt)
#pragma unroll
    for (int i = 0; i < S::kCols / 2; ++i) acc[mt][i] = 0.0f;

  for (int kt = 0; kt < steps; ++kt) {
    const int s = kt % S::kStages;
    mbar_wait(&full[s], (kt / S::kStages) & 1);
    const unsigned char* a = ring + s * S::kStageBytes;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kFwdDepth / 16; ++ks) {
      // B: 16 rows of d (two 8-row groups, 512 B apart), the K atoms of 32
      // channels 4 KB apart
      const uint64_t db = smem_desc(a + S::kABytes + ks * 16 * 64, kFwdAtom,
                                    512, kSwizzle64);
#pragma unroll
      for (int mt = 0; mt < S::kMT; ++mt) {
        // A: 64 rows of 128 B from row 64 (wg kMT + mt), k at 32 B a step
        const uint64_t da = smem_desc(
            a + (wg * S::kMT + mt) * 64 * 128 + ks * 32, 16, 1024,
            kSwizzle128);
        Wgmma<S::kCols>::template ss<1>(acc[mt], da, db);
      }
    }
    wgmma_commit();
    wgmma_wait<1>();  // the group of step kt - 1 is done: release its stage
    if (kt > 0 && lane == 0)
      mbar_arrive(&empty[(kt - 1) % S::kStages]);
    // that stage is refilled with step kt + kStages - 1 once all 8 warps
    // have released it
    const int next = kt + S::kStages - 1;
    if (next < steps) {
      if (kt > 0)
        mbar_wait(&empty[next % S::kStages], ((kt - 1) / S::kStages) & 1);
      load(next);
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int mt = 0; mt < S::kMT; ++mt) fence_operands(acc[mt]);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();  // both groups past their products

  // the accumulators to an f32 [kRows, kCols] tile over the ring
  float* tile = reinterpret_cast<float*>(ring);
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int mt = 0; mt < S::kMT; ++mt) {
    const int r = (wg * S::kMT + mt) * 64 + (warp % 4) * 16 + g;
#pragma unroll
    for (int i = 0; i < S::kCols / 8; ++i) {
      const int c = 8 * i + 2 * t;
      *reinterpret_cast<float2*>(tile + r * S::kLd + c) =
          make_float2(acc[mt][4 * i], acc[mt][4 * i + 1]);
      *reinterpret_cast<float2*>(tile + (r + 8) * S::kLd + c) =
          make_float2(acc[mt][4 * i + 2], acc[mt][4 * i + 3]);
    }
  }
  __syncthreads();

  // epilogue: thread (oo, r0) walks rows r0, r0 + 8, ... of output oo
  const int oo = tid % kFwdOut, o = o0 + oo;
  if (o >= o_dim) return;
  for (int r = tid / kFwdOut; r < S::kRows;
       r += kFwdConsumers * 128 / kFwdOut) {
    const int m = m0 + r;
    if (m >= mrows) break;
    const int n = m / l;
    float pooled = 0.0f;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int c = o * K + j;
      const float z0 = __fadd_rn(tile[r * S::kLd + oo * K + j], b[c]);
      float zd = __fmul_rn(z0, q[(size_t)n * f + c]);
      if (kMask && thr != 0u)
        zd = __fmul_rn(zd, keep_scale(seed, thr, inv_keep,
                                      base + (unsigned long long)m * f_mask +
                                          c));
      pooled = j == 0 ? zd : __fadd_rn(pooled, zd);
    }
    out[(size_t)m * o_dim + o] = signed_sqrt(pooled);
  }
}

// ---------------------------------------------------------------------------
// g_prod, built once: bf16 g_prod [M, F] and f32 d_b partials [chunks, F]
// ---------------------------------------------------------------------------
constexpr int kBuildRows = 64;  // rows per d_b partial (ops/train_fusion.py)

// a thread owns one channel c and walks the block's 64 rows in order; the
// zero rule is written as the plain version computes it, g * (out == 0 ? 0
// : 0.5 / max(|out|, 1e-20)), so even the sign of a zero agrees
__global__ void __launch_bounds__(kThreads)
    g_prod_kernel(const float* __restrict__ g,    // [M, O]
                  const float* __restrict__ out,  // [M, O]
                  const float* __restrict__ q,    // [N, F]
                  bf16* __restrict__ gp,          // [M, F]
                  float* __restrict__ db_part,    // [ceil(M / 64), F]
                  int mrows, int l, int f, int k, uint32_t seed, uint32_t thr,
                  float inv_keep, unsigned long long base, int f_mask) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= f) return;
  const int o_dim = f / k, o = c / k;
  const int m0 = blockIdx.y * kBuildRows;
  const int m_end = min(mrows, m0 + kBuildRows);
  float part = 0.0f;
  for (int m = m0; m < m_end; ++m) {
    const size_t po = (size_t)m * o_dim + o;
    const float y = out[po];
    float v = __fmul_rn(
        g[po], y == 0.0f ? 0.0f : __fdiv_rn(0.5f, fmaxf(fabsf(y), 1e-20f)));
    if (thr != 0u)
      v = __fmul_rn(v, keep_scale(seed, thr, inv_keep,
                                  base + (unsigned long long)m * f_mask + c));
    v = __fmul_rn(v, q[(size_t)(m / l) * f + c]);
    gp[(size_t)m * f + c] = __float2bfloat16(v);
    part = __fadd_rn(part, v);
  }
  db_part[(size_t)blockIdx.y * f + c] = part;
}

// ---------------------------------------------------------------------------
// d_img = g_prod @ W^T over the build's bf16 operand, pipelined
// ---------------------------------------------------------------------------
// A block owns 128 rows of M (64 per warpgroup) x 256 columns of D and walks
// all of F, so reruns give the same bits. Both operands have F, the
// contraction axis, contiguous: the K-major layout wgmma reads with no
// transposition. Thread 0 keeps a ring of kImgStages stages full with TMA,
// three ahead: g_prod [128 m, 64 f] and W [256 d, 64 f], 128-byte rows with
// 128-byte swizzle; past F both come in as zeros, so the last stage adds 0.
// Each warpgroup runs wgmma m64n256k16 (A = its g_prod rows, B = W), one
// stage's group in flight while the next stage is awaited. The epilogue
// rounds to bf16 into a padded tile over the ring and stores whole 16-byte
// pieces of rows. A 256 x 128 tile (two m64 row tiles a warpgroup,
// wgmma m64n128k16) ran as fast on the card, 0.527 ms against 0.523 at
// N = 64 (PERF.md), so there is one form.
constexpr int kImgConsumers = 2;  // warpgroups
constexpr int kImgRows = kImgConsumers * 64;  // M rows per block
constexpr int kImgCols = 256;  // D columns per block: wgmma's N
constexpr int kImgDepth = 64;     // F per ring stage: a 128-byte row
constexpr int kImgThreads = kImgConsumers * 128;
constexpr int kImgABytes = kImgRows * kImgDepth * 2;
constexpr int kImgStageBytes = kImgABytes + kImgCols * kImgDepth * 2;
constexpr int kImgStages = 4;
constexpr int kImgLd = kImgCols + 8;  // bf16 row of the staged tile
// 1 KB of alignment slack, 1 KB of barriers, then the ring (reused as the
// epilogue's bf16 tile)
constexpr int kImgSmem = 2048 + kImgStages * kImgStageBytes;
static_assert(kImgRows * kImgLd * 2 <= kImgStages * kImgStageBytes,
              "the staged tile fits over the ring");

__global__ void __launch_bounds__(kImgThreads, 1)
    d_img_kernel(const __grid_constant__ CUtensorMap gp_map,  // [M, F] bf16
                 const __grid_constant__ CUtensorMap w_map,   // [D, F] bf16
                 bf16* __restrict__ d_img,                    // [M, D]
                 int mrows, int d, int f) {
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kImgStages;
  unsigned char* ring = smem + 1024;

  const int d0 = blockIdx.x * kImgCols;
  const int m0 = blockIdx.y * kImgRows;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int steps = (f + kImgDepth - 1) / kImgDepth;

  if (tid == 0) {
    for (int s = 0; s < kImgStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kImgConsumers * 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // step kt into stage kt % kImgStages, requested by thread 0 (every thread
  // walks the same path: see mbar_expect_tx)
  const bool leader = tid == 0;
  auto load = [&](int kt) {
    const int s = kt % kImgStages;
    unsigned char* st = ring + s * kImgStageBytes;
    mbar_expect_tx(&full[s], kImgStageBytes, leader);
    tma_load_2d(st, &gp_map, &full[s], kt * kImgDepth, m0, leader);
    tma_load_2d(st + kImgABytes, &w_map, &full[s], kt * kImgDepth, d0,
                leader);
  };
  for (int kt = 0; kt < kImgStages - 1 && kt < steps; ++kt) load(kt);

  const int wg = warp / 4;
  float acc[kImgCols / 2];
#pragma unroll
  for (int i = 0; i < kImgCols / 2; ++i) acc[i] = 0.0f;

  for (int kt = 0; kt < steps; ++kt) {
    const int s = kt % kImgStages;
    mbar_wait(&full[s], (kt / kImgStages) & 1);
    const unsigned char* st = ring + s * kImgStageBytes;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kImgDepth / 16; ++ks) {
      // A: 64 rows of 128 B from row 64 wg, k at 32 B a step; B: the
      // kImgCols rows of W the same way (both K-major, 8-row groups 1 KB
      // apart)
      const uint64_t da =
          smem_desc(st + wg * 64 * 128 + ks * 32, 16, 1024, kSwizzle128);
      const uint64_t db =
          smem_desc(st + kImgABytes + ks * 32, 16, 1024, kSwizzle128);
      Wgmma<kImgCols>::ss<0>(acc, da, db);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the group of step kt - 1 is done: release its stage
    if (kt > 0 && lane == 0) mbar_arrive(&empty[(kt - 1) % kImgStages]);
    // that stage is refilled with step kt + kImgStages - 1 once all 8 warps
    // have released it
    const int next = kt + kImgStages - 1;
    if (next < steps) {
      if (kt > 0)
        mbar_wait(&empty[next % kImgStages], ((kt - 1) / kImgStages) & 1);
      load(next);
    }
  }
  wgmma_wait<0>();
  fence_operands(acc);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();  // both groups past their products

  // the accumulators, rounded to bf16, to a [kImgRows, kImgCols] tile over
  // the ring (rows kImgCols + 8 apart: the quad's four columns and the 8
  // rows of a warp's stores fall in distinct banks)
  bf16* tile = reinterpret_cast<bf16*>(ring);
  const int r = wg * 64 + (warp % 4) * 16 + lane / 4;
  const int t = lane % 4;
#pragma unroll
  for (int i = 0; i < kImgCols / 8; ++i) {
    const int c = 8 * i + 2 * t;
    *reinterpret_cast<__nv_bfloat162*>(tile + r * kImgLd + c) =
        __floats2bfloat162_rn(acc[4 * i], acc[4 * i + 1]);
    *reinterpret_cast<__nv_bfloat162*>(tile + (r + 8) * kImgLd + c) =
        __floats2bfloat162_rn(acc[4 * i + 2], acc[4 * i + 3]);
  }
  __syncthreads();

  // 16-byte pieces, a warp on contiguous bytes of a row; D % 8 == 0, so a
  // piece lies wholly inside or wholly past D
  constexpr int kPieces = kImgCols / 8;
  for (int i = tid; i < kImgRows * kPieces; i += kImgThreads) {
    const int r = i / kPieces, c = (i % kPieces) * 8;
    if (m0 + r < mrows && d0 + c < d)
      *reinterpret_cast<uint4*>(d_img + (size_t)(m0 + r) * d + d0 + c) =
          *reinterpret_cast<const uint4*>(tile + r * kImgLd + c);
  }
}

// ---------------------------------------------------------------------------
// d_W = bf16(img)^T @ g_prod, pipelined; d_b = sum of the partials
// ---------------------------------------------------------------------------
constexpr int kGemmTile = 128;      // d rows and channels per block
constexpr int kGemmDepth = 32;      // rows of M per ring stage
constexpr int kGemmStages = 4;      // ring stages, three in flight
constexpr int kLdG = kGemmTile + 8;  // 272-byte rows: ldmatrix conflict-free
constexpr int kGemmStageElems = kGemmDepth * kLdG;  // one operand's stage
constexpr int kGemmSmem = kGemmStages * 2 * kGemmStageElems * 2;

// 16 bytes global -> shared, cached in L2 only; zero-filled (nothing read)
// when !ok
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most kPending of the newest commit groups are in flight
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// four 8x8 bf16 matrices, transposed: lane i gives the row address of
// matrix i / 8, row i % 8
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// d += a (16x16, row-major) @ b (16x8, column-major), bf16 in, f32 sums
__device__ __forceinline__ void mma_16816(float (&d)[4],
                                          const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kThreads, 2)
    d_w_gemm_kernel(const bf16* __restrict__ img,      // [M, D]
                    const bf16* __restrict__ gp,       // [M, F]
                    const float* __restrict__ db_part,  // [chunks, F]
                    float* __restrict__ d_w,           // [D, F]
                    float* __restrict__ d_b,           // [F]
                    int mrows, int d, int f, int chunks) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* a_s = reinterpret_cast<bf16*>(smem);        // img [stage][m][d]
  bf16* b_s = a_s + kGemmStages * kGemmStageElems;  // g_prod [stage][m][c]
  const int c0 = blockIdx.x * kGemmTile, d0 = blockIdx.y * kGemmTile;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;  // 64 d x 32 channels per warp

  // d_b: the first D tile's blocks sum the partials in chunk order
  if (blockIdx.y == 0 && tid < kGemmTile && c0 + tid < f) {
    float s = 0.0f;
    for (int i = 0; i < chunks; ++i)
      s = __fadd_rn(s, db_part[(size_t)i * f + c0 + tid]);
    d_b[c0 + tid] = s;
  }

  float acc[4][4][4];  // [16-row d tile][8-wide channel tile][fragment]
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  // rows [32 s, 32 s + 32) of img (d0..d0+127) and of g_prod (c0..c0+127)
  // into stage s % 4; one commit group per call (empty past the end)
  const int stages = (mrows + kGemmDepth - 1) / kGemmDepth;
  auto prefetch = [&](int s) {
    if (s < stages) {
      bf16* a = a_s + (s % kGemmStages) * kGemmStageElems;
      bf16* b = b_s + (s % kGemmStages) * kGemmStageElems;
      for (int i = tid; i < kGemmDepth * (kGemmTile / 8); i += kThreads) {
        const int r = i / (kGemmTile / 8), v = i % (kGemmTile / 8);
        const int m = s * kGemmDepth + r;
        const int dd = d0 + v * 8, cc = c0 + v * 8;
        const bool ok_a = m < mrows && dd < d, ok_b = m < mrows && cc < f;
        cp_async16(a + r * kLdG + v * 8, ok_a ? img + (size_t)m * d + dd : img,
                   ok_a);
        cp_async16(b + r * kLdG + v * 8, ok_b ? gp + (size_t)m * f + cc : gp,
                   ok_b);
      }
    }
    cp_async_commit();
  };

  // ldmatrix lanes: matrix mat = lane / 8, row r8 = lane % 8. A (img^T,
  // d x m) tiles: matrices (m +0, d +0), (m +0, d +8), (m +8, d +0),
  // (m +8, d +8) give a0..a3; B (g_prod, m x c) tiles: (m +0, c +0),
  // (m +8, c +0), (m +0, c +8), (m +8, c +8) give b0, b1 of two 8-wide
  // channel tiles
  const int mat = lane / 8, r8 = lane % 8;
  const int a_off = (r8 + (mat / 2) * 8) * kLdG + wm * 64 + (mat % 2) * 8;
  const int b_off = (r8 + (mat % 2) * 8) * kLdG + wn * 32 + (mat / 2) * 8;

#pragma unroll
  for (int s = 0; s < kGemmStages - 1; ++s) prefetch(s);
  for (int s = 0; s < stages; ++s) {
    cp_async_wait<kGemmStages - 2>();  // stage s has landed
    __syncthreads();  // ... for every thread; stage s - 1 is consumed
    prefetch(s + kGemmStages - 1);
    const bf16* a = a_s + (s % kGemmStages) * kGemmStageElems + a_off;
    const bf16* b = b_s + (s % kGemmStages) * kGemmStageElems + b_off;
#pragma unroll
    for (int kk = 0; kk < kGemmDepth; kk += 16) {
      uint32_t af[4][4], bfr[2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldmatrix_x4_trans(af[i], a + kk * kLdG + i * 16);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        ldmatrix_x4_trans(bfr[j], b + kk * kLdG + j * 16);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_16816(acc[i][j], af[i], bfr[j / 2][(j % 2) * 2],
                    bfr[j / 2][(j % 2) * 2 + 1]);
    }
  }
  cp_async_wait<0>();

  // fragment: rows lane / 4 and + 8, channels 2 (lane % 4) and + 1
  const int gid = lane / 4, tig = lane % 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int dr = d0 + wm * 64 + i * 16 + gid;
      const int cc = c0 + wn * 32 + j * 8 + tig * 2;
      if (cc < f) {  // F % 8 == 0: cc + 1 < F too
        if (dr < d)
          *reinterpret_cast<float2*>(d_w + (size_t)dr * f + cc) =
              make_float2(acc[i][j][0], acc[i][j][1]);
        if (dr + 8 < d)
          *reinterpret_cast<float2*>(d_w + (size_t)(dr + 8) * f + cc) =
              make_float2(acc[i][j][2], acc[i][j][3]);
      }
    }
}

// ---------------------------------------------------------------------------
// d_q[n, c] = sum_l (g_pooled * mask * inv_keep) * z0, z0 recomputed
// ---------------------------------------------------------------------------
// A block owns one sample and 128 channels, 64 per warpgroup, and computes
// z0^T [64 c, kRowsN l] = W^T x img_n^T with the sample's L rows as wgmma's
// N (kRowsN = 200, or 208 past L = 200). Thread 0 keeps a ring of kQStages
// stages full with TMA, four ahead: W's two [32 d, 64 c] boxes (128-byte
// swizzle; boxes wholly past F are not loaded) and the sample's img
// [kRowsN l, 32 d] (a 3D box over [N, L, D], 64-byte swizzle; the rows past
// L come in as zeros, so no row of the next sample). Each warpgroup runs
// wgmma m64n{kRowsN}k16 with A = its W box MN-major (transposed) and B =
// the img box K-major, one stage's group in flight while the next stage is
// awaited. The stages are 32 deep so that two blocks fit an SM at kRowsN
// = 200 (108 KB of shared memory and 128 registers a thread each): one
// block's epilogue runs while the other's loads and products do.
//
// The epilogue draws one Philox word per element (25,600 a block), which
// is what costs: with the 100 accumulators in registers, a thread has no
// room to keep several draws in flight. So the accumulators go to shared
// memory first, z0 [kRowsN l, 128 c] over the ring, and a thread then owns
// one channel and half of the rows: its sum over them runs in row order
// with the registers free for the draws, and the two halves are added in
// order. No atomics: reruns give the same bits.
constexpr int kQDepth = 32;       // D per ring stage: a 64-byte img row
constexpr int kQChannels = 64;    // channels per warpgroup: wgmma's M
constexpr int kQConsumers = 2;    // warpgroups
constexpr int kQThreads = kQConsumers * 128;
constexpr int kQTile = kQConsumers * kQChannels;  // channels per block
constexpr int kQWBox = kQDepth * kQChannels * 2;  // one [32 d, 64 c] W box
constexpr int kQStages = 5;
constexpr int kQZLd = kQTile + 4;  // f32 row of the staged z0: no conflicts

template <int kRowsN>
struct DqShape {
  static constexpr int kImgBytes = kRowsN * kQDepth * 2;
  // W's boxes first (1 KB aligned for their swizzle), then img, the stage
  // rounded up to 1 KB
  static constexpr int kStageBytes =
      (kQConsumers * kQWBox + kImgBytes + 1023) / 1024 * 1024;
  static constexpr int kRing = kQStages * kStageBytes;
  static constexpr int kZ0 = kRowsN * kQZLd * 4;
  // 1 KB of alignment slack, 1 KB of barriers, then the ring (reused for
  // the staged z0)
  static constexpr int kSmem = 2048 + (kRing > kZ0 ? kRing : kZ0);
  // two blocks an SM where their registers allow it
  static constexpr int kBlocksPerSm = kRowsN <= 200 ? 2 : 1;
};

// sum over rows [r0, r1) of (g_pooled * mask * inv_keep) * (z0 + b) for
// channel c, in row order; z0_c[r * kQZLd] is z0 of row r
template <bool kMask>
__device__ __forceinline__ float d_q_rows(
    const float* z0_c, const float* __restrict__ g,
    const float* __restrict__ out, float bc, size_t m0, int r0, int r1,
    int o_dim, int c, int k, int f_mask, uint32_t seed, uint32_t thr,
    float inv_keep, unsigned long long base) {
  const int o = c / k;
  float part = 0.0f;
#pragma unroll 4
  for (int r = r0; r < r1; ++r) {
    const size_t po = (m0 + r) * o_dim + o;
    float gz = pooled_grad(g[po], out[po]);
    if (kMask)
      gz = __fmul_rn(gz,
                     keep_scale(seed, thr, inv_keep,
                                base + (m0 + r) * f_mask + c));
    const float z0 = __fadd_rn(z0_c[r * kQZLd], bc);
    part = __fadd_rn(part, __fmul_rn(gz, z0));
  }
  return part;
}

template <int kRowsN>
__global__ void __launch_bounds__(kQThreads, DqShape<kRowsN>::kBlocksPerSm)
    d_q_kernel(const __grid_constant__ CUtensorMap img_map,  // [N, L, D] bf16
               const __grid_constant__ CUtensorMap w_map,    // [D, F] bf16
               const float* __restrict__ g,    // [M, O]
               const float* __restrict__ out,  // [M, O]
               const float* __restrict__ b,    // [F]
               float* __restrict__ d_q,        // [N, F]
               int l, int d, int f, int k, uint32_t seed, uint32_t thr,
               float inv_keep, unsigned long long base, int f_mask) {
  using S = DqShape<kRowsN>;
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kQStages;
  unsigned char* ring = smem + 1024;

  const int c0 = blockIdx.x * kQTile;
  const int n = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int steps = (d + kQDepth - 1) / kQDepth;
  const int boxes = min(kQConsumers, (f - c0 + kQChannels - 1) / kQChannels);

  if (tid == 0) {
    for (int s = 0; s < kQStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kQConsumers * 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // step kt into stage kt % kQStages, requested by thread 0 (every thread
  // walks the same path: see mbar_expect_tx)
  const bool leader = tid == 0;
  auto load = [&](int kt) {
    const int s = kt % kQStages;
    unsigned char* st = ring + s * S::kStageBytes;
    mbar_expect_tx(&full[s], boxes * kQWBox + S::kImgBytes, leader);
    for (int i = 0; i < boxes; ++i)
      tma_load_2d(st + i * kQWBox, &w_map, &full[s], c0 + i * kQChannels,
                  kt * kQDepth, leader);
    tma_load_3d(st + kQConsumers * kQWBox, &img_map, &full[s], kt * kQDepth,
                0, n, leader);
  };
  for (int kt = 0; kt < kQStages - 1 && kt < steps; ++kt) load(kt);

  const int wg = warp / 4;
  float acc[kRowsN / 2];
#pragma unroll
  for (int i = 0; i < kRowsN / 2; ++i) acc[i] = 0.0f;

  for (int kt = 0; kt < steps; ++kt) {
    const int s = kt % kQStages;
    mbar_wait(&full[s], (kt / kQStages) & 1);
    const unsigned char* st = ring + s * S::kStageBytes;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kQDepth / 16; ++ks) {
      // A: the warpgroup's W box, MN-major: 16 rows of d (2 KB) a step,
      // 8-row groups 1 KB apart, one 64-channel swizzle atom along M
      const uint64_t da = smem_desc(st + wg * kQWBox + ks * 16 * 128, kQWBox,
                                    1024, kSwizzle128);
      // B: kRowsN img rows of 64 B, k at 32 B a step, 8-row groups 512 B
      // apart
      const uint64_t db = smem_desc(st + kQConsumers * kQWBox + ks * 32, 16,
                                    512, kSwizzle64);
      Wgmma<kRowsN>::template ss<0, 1>(acc, da, db);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the group of step kt - 1 is done: release its stage
    if (kt > 0 && lane == 0) mbar_arrive(&empty[(kt - 1) % kQStages]);
    // that stage is refilled with step kt + kQStages - 1 once all 8 warps
    // have released it
    const int next = kt + kQStages - 1;
    if (next < steps) {
      if (kt > 0)
        mbar_wait(&empty[next % kQStages], ((kt - 1) / kQStages) & 1);
      load(next);
    }
  }
  wgmma_wait<0>();
  fence_operands(acc);

  // every warp is past its products: the ring takes z0 [kRowsN l, 128 c]
  // (channel row g + 8 h of the warp's 16, rows 8 i + 2 t + e in
  // acc[4 i + 2 h + e])
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  float* z0_s = reinterpret_cast<float*>(ring);
  {
    const int cc = wg * kQChannels + (warp % 4) * 16 + lane / 4;
    const int t = lane % 4;
#pragma unroll
    for (int i = 0; i < kRowsN / 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          z0_s[(8 * i + 2 * t + e) * kQZLd + cc + 8 * h] =
              acc[4 * i + 2 * h + e];
  }
  __syncthreads();

  // thread (half, cc): channel c0 + cc over rows [half * lh, lh + half * lh)
  __shared__ float half_s[kQTile];
  const int cc = tid % kQTile, half = tid / kQTile;
  const int c = c0 + cc, lh = (l + 1) / 2;
  const int r0 = half * lh, r1 = min(l, r0 + lh);
  float part = 0.0f;
  if (c < f) {
    const float* z0_c = z0_s + cc;
    const size_t m0 = (size_t)n * l;
    part = thr != 0u
               ? d_q_rows<true>(z0_c, g, out, b[c], m0, r0, r1, f / k, c, k,
                                f_mask, seed, thr, inv_keep, base)
               : d_q_rows<false>(z0_c, g, out, b[c], m0, r0, r1, f / k, c,
                                 k, f_mask, seed, thr, inv_keep, base);
  }
  if (half == 1) half_s[cc] = part;
  __syncthreads();
  if (half == 0 && c < f)
    d_q[(size_t)n * f + c] = __fadd_rn(part, half_s[cc]);
}

// the mask counter of sample row0's first element at column col0
unsigned long long mask_base(long long row0, int l, int f_total,
                             long long col0) {
  return (unsigned long long)row0 * (unsigned long long)l * f_total +
         (unsigned long long)col0;
}

// a launch's columns [col0, col0 + f) inside the global width f_total
bool cols_ok(long long col0, int f_total) {
  return col0 >= 0 && f_total >= 1 && col0 < f_total;
}

bool dims_ok(int n, int l, int d, int f, int k) {
  return n >= 1 && n <= 65535 && l >= 1 && l <= kMaxRows && d >= 8 &&
         d % 8 == 0 && k >= 1 && k <= kMaxK && f >= k && f % k == 0 &&
         f % 8 == 0 && (long long)n * l <= 65535LL * 128;  // row tiles
}

template <int K, bool kMask>
int launch_fwd(const void* img, const void* w, const void* b, const void* q,
               void* out, int mrows, int l, int d, int f, uint32_t seed,
               uint32_t thr, float inv_keep, unsigned long long base,
               int f_mask, cudaStream_t s) {
  using S = FwdShape<K>;
  CUtensorMap img_map, w_map;
  const uint64_t img_dims[2] = {(uint64_t)d, (uint64_t)mrows};
  const uint64_t img_strides[1] = {(uint64_t)d * 2};
  const uint32_t img_box[2] = {kFwdDepth, S::kRows};
  cudaError_t err = hopper::make_map(
      &img_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, img, img_dims,
      img_strides, img_box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return (int)err;
  const uint64_t w_dims[2] = {(uint64_t)f, (uint64_t)d};
  const uint64_t w_strides[1] = {(uint64_t)f * 2};
  const uint32_t w_box[2] = {32, kFwdDepth};
  err = hopper::make_map(&w_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w,
                         w_dims, w_strides, w_box, CU_TENSOR_MAP_SWIZZLE_64B);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(fwd_kernel<K, kMask>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             S::kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((f / K + kFwdOut - 1) / kFwdOut,
                  (mrows + S::kRows - 1) / S::kRows);
  fwd_kernel<K, kMask><<<grid, kFwdThreads, S::kSmem, s>>>(
      img_map, w_map, static_cast<const float*>(b),
      static_cast<const float*>(q), static_cast<float*>(out), mrows, l, d, f,
      seed, thr, inv_keep, base, f_mask);
  return (int)cudaGetLastError();
}

template <bool kMask>
int launch_fwd_k(const void* img, const void* w, const void* b,
                 const void* q, void* out, int m, int l, int d, int f, int k,
                 uint32_t seed, uint32_t thr, float inv_keep,
                 unsigned long long base, int f_mask, cudaStream_t s) {
  switch (k) {
    case 1: return launch_fwd<1, kMask>(img, w, b, q, out, m, l, d, f, seed, thr, inv_keep, base, f_mask, s);
    case 2: return launch_fwd<2, kMask>(img, w, b, q, out, m, l, d, f, seed, thr, inv_keep, base, f_mask, s);
    case 3: return launch_fwd<3, kMask>(img, w, b, q, out, m, l, d, f, seed, thr, inv_keep, base, f_mask, s);
    case 4: return launch_fwd<4, kMask>(img, w, b, q, out, m, l, d, f, seed, thr, inv_keep, base, f_mask, s);
    case 5: return launch_fwd<5, kMask>(img, w, b, q, out, m, l, d, f, seed, thr, inv_keep, base, f_mask, s);
    case 6: return launch_fwd<6, kMask>(img, w, b, q, out, m, l, d, f, seed, thr, inv_keep, base, f_mask, s);
    case 7: return launch_fwd<7, kMask>(img, w, b, q, out, m, l, d, f, seed, thr, inv_keep, base, f_mask, s);
    case 8: return launch_fwd<8, kMask>(img, w, b, q, out, m, l, d, f, seed, thr, inv_keep, base, f_mask, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <int kRowsN>
int launch_d_q(const void* g, const void* out, const void* img,
               const void* w, const void* b, void* d_q, int n, int l, int d,
               int f, int k, uint32_t seed, uint32_t thr, float inv_keep,
               unsigned long long base, int f_mask, void* stream) {
  using S = DqShape<kRowsN>;
  CUtensorMap img_map, w_map;
  const uint64_t img_dims[3] = {(uint64_t)d, (uint64_t)l, (uint64_t)n};
  const uint64_t img_strides[2] = {(uint64_t)d * 2, (uint64_t)l * d * 2};
  const uint32_t img_box[3] = {kQDepth, kRowsN, 1};
  cudaError_t err = hopper::make_map(
      &img_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, img, img_dims,
      img_strides, img_box, CU_TENSOR_MAP_SWIZZLE_64B);
  if (err != cudaSuccess) return (int)err;
  const uint64_t w_dims[2] = {(uint64_t)f, (uint64_t)d};
  const uint64_t w_strides[1] = {(uint64_t)f * 2};
  const uint32_t w_box[2] = {kQChannels, kQDepth};
  err = hopper::make_map(&w_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w,
                         w_dims, w_strides, w_box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(d_q_kernel<kRowsN>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             S::kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((f + kQTile - 1) / kQTile, n);
  d_q_kernel<kRowsN><<<grid, kQThreads, S::kSmem,
                       reinterpret_cast<cudaStream_t>(stream)>>>(
      img_map, w_map, static_cast<const float*>(g),
      static_cast<const float*>(out), static_cast<const float*>(b),
      static_cast<float*>(d_q), l, d, f, k, seed, thr, inv_keep, base,
      f_mask);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// row0 (>= 0): the global index of sample 0; col0 (>= 0) and f_total: the
// global index of column 0 and the global width. They place the mask's
// counter (the header); the entries that draw the mask take them
int train_fusion_forward(const void* img, const void* w, const void* b,
                         const void* q, void* out, int n, int l, int d, int f,
                         int k, uint32_t seed, uint32_t thr, float inv_keep,
                         long long row0, long long col0, int f_total,
                         void* stream) {
  if (!dims_ok(n, l, d, f, k) || row0 < 0 || !cols_ok(col0, f_total))
    return (int)cudaErrorInvalidValue;
  return launch_fwd_k<true>(img, w, b, q, out, n * l, l, d, f, k, seed, thr,
                            inv_keep, mask_base(row0, l, f_total, col0),
                            f_total, reinterpret_cast<cudaStream_t>(stream));
}

// K5, the inference fusion (replaces _grid_fuse_pallas, vqa_attention_
// networks_tpu/ops/pallas_fusion.py): the forward above with the mask
// compiled out, out = signed_sqrt(k-pool((img @ W + b) * q)), f32 [N, L, O].
int train_fusion_inference_forward(const void* img, const void* w,
                                   const void* b, const void* q, void* out,
                                   int n, int l, int d, int f, int k,
                                   void* stream) {
  if (!dims_ok(n, l, d, f, k)) return (int)cudaErrorInvalidValue;
  return launch_fwd_k<false>(img, w, b, q, out, n * l, l, d, f, k, 0u, 0u,
                             1.0f, 0ull, f,
                             reinterpret_cast<cudaStream_t>(stream));
}

// d_img from train_fusion_g_prod's bf16 g_prod [N*L, F] and bf16 W [D, F]
int train_fusion_d_img(const void* gp, const void* w, void* d_img, int n,
                       int l, int d, int f, void* stream) {
  if (!dims_ok(n, l, d, f, 1)) return (int)cudaErrorInvalidValue;
  const int m = n * l;
  CUtensorMap gp_map, w_map;
  const uint64_t gp_dims[2] = {(uint64_t)f, (uint64_t)m};
  const uint64_t gp_strides[1] = {(uint64_t)f * 2};
  const uint32_t gp_box[2] = {kImgDepth, kImgRows};
  cudaError_t err = hopper::make_map(
      &gp_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, gp, gp_dims, gp_strides,
      gp_box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return (int)err;
  const uint64_t w_dims[2] = {(uint64_t)f, (uint64_t)d};
  const uint32_t w_box[2] = {kImgDepth, kImgCols};
  err = hopper::make_map(&w_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w,
                         w_dims, gp_strides, w_box,
                         CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(d_img_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kImgSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((d + kImgCols - 1) / kImgCols,
                  (m + kImgRows - 1) / kImgRows);
  d_img_kernel<<<grid, kImgThreads, kImgSmem,
                 reinterpret_cast<cudaStream_t>(stream)>>>(
      gp_map, w_map, static_cast<bf16*>(d_img), m, d, f);
  return (int)cudaGetLastError();
}

int train_fusion_g_prod(const void* g, const void* out, const void* q,
                        void* gp, void* db_part, int n, int l, int d, int f,
                        int k, uint32_t seed, uint32_t thr, float inv_keep,
                        long long row0, long long col0, int f_total,
                        void* stream) {
  if (!dims_ok(n, l, d, f, k) || row0 < 0 || !cols_ok(col0, f_total))
    return (int)cudaErrorInvalidValue;
  const int m = n * l;
  const dim3 grid((f + kThreads - 1) / kThreads,
                  (m + kBuildRows - 1) / kBuildRows);
  g_prod_kernel<<<grid, kThreads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const float*>(out),
      static_cast<const float*>(q), static_cast<bf16*>(gp),
      static_cast<float*>(db_part), m, l, f, k, seed, thr, inv_keep,
      mask_base(row0, l, f_total, col0), f_total);
  return (int)cudaGetLastError();
}

// d_W and d_b from train_fusion_g_prod's bf16 g_prod and d_b partials
int train_fusion_d_w(const void* img, const void* gp, const void* db_part,
                     void* d_w, void* d_b, int n, int l, int d, int f,
                     void* stream) {
  if (!dims_ok(n, l, d, f, 1)) return (int)cudaErrorInvalidValue;
  const int m = n * l;
  cudaError_t err = cudaFuncSetAttribute(
      d_w_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kGemmSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((f + kGemmTile - 1) / kGemmTile,
                  (d + kGemmTile - 1) / kGemmTile);
  d_w_gemm_kernel<<<grid, kThreads, kGemmSmem,
                    reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(img), static_cast<const bf16*>(gp),
      static_cast<const float*>(db_part), static_cast<float*>(d_w),
      static_cast<float*>(d_b), m, d, f, (m + kBuildRows - 1) / kBuildRows);
  return (int)cudaGetLastError();
}

int train_fusion_d_q(const void* g, const void* out, const void* img,
                     const void* w, const void* b, void* d_q, int n, int l,
                     int d, int f, int k, uint32_t seed, uint32_t thr,
                     float inv_keep, long long row0, long long col0,
                     int f_total, void* stream) {
  if (!dims_ok(n, l, d, f, k) || row0 < 0 || !cols_ok(col0, f_total))
    return (int)cudaErrorInvalidValue;
  const unsigned long long base = mask_base(row0, l, f_total, col0);
  return l <= 200 ? launch_d_q<200>(g, out, img, w, b, d_q, n, l, d, f, k,
                                    seed, thr, inv_keep, base, f_total,
                                    stream)
                  : launch_d_q<kMaxRows>(g, out, img, w, b, d_q, n, l, d, f, k,
                                       seed, thr, inv_keep, base, f_total,
                                       stream);
}

const char* train_fusion_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
