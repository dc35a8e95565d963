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
// O_pad=1024) and loops over samples. A Hopper block has at most 227 KB of
// shared memory, so w3 streams through the 50 MB L2 instead, and what the
// design controls is how many samples share each streamed tile and whether
// loads stay in flight. The products are ~0.26 TFLOP at N=256 (~0.26 ms
// of bf16 tensor time) and the f32 wq build ~2.6 G multiply-adds (~0.08 ms
// of the FP32 pipes); the bytes the function must move, ~0.25 GB. What
// bounds launch A is its L2 traffic: each block streams its O tile's
// slice of w3 (2.6 MB) and two samples' img (1.6 MB), ~8.8 GB at N=256.
//
// What the design does about it. Three launches from one wrapper; A and B
// are pipelined: thread 0 of the block keeps a ring of TMA stages full
// (mbarriers count each stage's bytes and the 8 warps' releases) while the
// two warpgroups run wgmma, and reruns give the same bits (no atomics;
// every sum in a fixed order):
//   A  stage1_grid_kernel    grid (O_pad/64, ceil(N/2)): one 64-wide O tile
//      for two samples, one warpgroup each, so each w3 tile is read from L2
//      once for both. pooled^T [64 o, 208 l] = wq^T x img^T by wgmma
//      m64n208k16, A (wq^T) built in registers from w3 in shared memory
//      (f32, unfused, j in order, rounded to bf16 once), B = img K-major.
//      Then + bq, the signed sqrt, z (f32) to a scratch buffer, and the
//      tile's sum of squares to [N, O_pad/64].
//   B  stage1_hidden_kernel  grid (ceil(C/128), N): the norm from the
//      partial sums in order; h1 [L, 128 c] = bf16(z * inv) x c1w by wgmma
//      m64n128k16, A (zb) built in registers from the z tile, B = c1w
//      MN-major (prepare_stage1_weights pads its columns to a multiple of
//      8, so each row is whole 16-byte units); + c1b, relu, h1 (bf16)
//      [N, L, C].
//   C  stage1_pool_kernel    grid (ceil(D/512), N): logits, the softmax over
//      L for each glimpse, and the attention pool of img, in f32 FMAs.
// Later work (ROADMAP): a cluster multicast of w3 tiles across blocks
// (half A's L2 traffic per doubling), and z kept out of device memory.
//
// The C interface takes raw device pointers and the stream; each launch is
// followed by cudaGetLastError(), whose code is returned (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kRows = 208;       // the most L rows any launch takes
constexpr int kWarps = 8;        // launch C
constexpr int kThreads = kWarps * 32;
constexpr int kPoolCols = kThreads * 2;  // D channels per launch-C block
constexpr int kMaxK = 16;
constexpr int kMaxG = 8;

__device__ __forceinline__ float signed_sqrt(float p) {
  return sqrtf(fmaxf(p, 0.0f)) - sqrtf(fmaxf(-p, 0.0f));
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
// A: z = signed_sqrt(img @ bf16(wq) + bq), and per-sample sums of squares
// ---------------------------------------------------------------------------
// A block owns one 64-wide O tile for kSamples samples, one warpgroup
// each. Thread 0 keeps a ring of TMA stages full: w3's [k, 32 d, 64 o]
// tile (f32, two boxes of 32 o with 128-byte swizzle), read from L2 once
// for all the block's samples, and each sample's img [208 l, 32 d] (bf16,
// 64-byte swizzle; rows past L come in as zeros, samples past N are not
// loaded). Each warpgroup builds its sample's wq^T fragments in registers,
// wq[d, o] = sum_j w3[j, d, o] * q3[n, j, o] in f32 (unfused, j in order),
// rounded to bf16 once, and runs pooled^T [64 o, 208 l] += wq^T [64 o,
// 16 d] x img^T [16 d, 208 l] with wgmma (A from registers, B = img
// K-major from shared memory), building the next fragment while the
// product before it runs.
constexpr int kSamples = 2;          // warpgroups, one sample each
constexpr int kOTile = 64;           // o per block: wgmma's M
constexpr int kDepth = 32;           // D per ring stage
constexpr int kLRows = 208;          // wgmma's N: L rows, padded to 8
constexpr int kGridThreads = kSamples * 128;
constexpr int kImgTile = kLRows * kDepth * 2;  // one sample's img stage
constexpr int kMaxStages = 4;
constexpr int kSmemBudget = 232448;  // the card's shared memory per block

// bytes of one ring stage at factor k: w3 [k, 32, 64] f32, then the img
// tiles; every part a multiple of 1 KB (the swizzle atoms' alignment)
__host__ __device__ constexpr int grid_stage_bytes(int k) {
  return k * kDepth * kOTile * 4 + kSamples * kImgTile;
}

// w3[j, dd, o] of the stage: box o / 32, row j * 32 + dd of 128 B, its
// 16-byte chunks swizzled by dd % 8 (the row's index mod 8)
__device__ __forceinline__ float w3_at(const unsigned char* w3_s, int k,
                                       int j, int dd, int o) {
  const int oo = o & 31;
  const int off = (o >> 5) * (k * kDepth * 128) + (j * kDepth + dd) * 128 +
                  ((((oo >> 2) ^ (dd & 7)) << 4) | ((oo & 3) << 2));
  return *reinterpret_cast<const float*>(w3_s + off);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__global__ void __launch_bounds__(kGridThreads, 1)
    stage1_grid_kernel(const __grid_constant__ CUtensorMap w3_map,   // w3
                       const __grid_constant__ CUtensorMap img_map,  // img
                       const float* __restrict__ b3,  // [k, O_pad]
                       const bf16* __restrict__ q3,   // [N, k, O_pad]
                       float* __restrict__ z,         // [N, L, O_pad]
                       float* __restrict__ ssq_part,  // [N, O_pad / kOTile]
                       int n_total, int l, int d, int k, int o_pad,
                       int stages) {
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  unsigned char* ring = smem + 1024;
  __shared__ float red_s[kSamples][4];

  const int tile = blockIdx.x, o0 = tile * kOTile;
  const int s0 = blockIdx.y * kSamples;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int steps = (d + kDepth - 1) / kDepth;
  const int stage_bytes = grid_stage_bytes(k);
  const int w3_bytes = k * kDepth * kOTile * 4;
  const int present = min(kSamples, n_total - s0);
  // a stage is released once the product after it has started (lag 1)
  // or, with a single stage, at once after its own products (lag 0)
  const int lag = stages > 1 ? 1 : 0;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kSamples * 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // step kt into stage kt % stages, requested by thread 0 (every thread
  // walks the same path: see mbar_expect_tx)
  const bool leader = tid == 0;
  auto load = [&](int kt) {
    const int s = kt % stages;
    unsigned char* st = ring + s * stage_bytes;
    mbar_expect_tx(&full[s], w3_bytes + present * kImgTile, leader);
    tma_load_3d(st, &w3_map, &full[s], o0, kt * kDepth, 0, leader);
    tma_load_3d(st + w3_bytes / 2, &w3_map, &full[s], o0 + 32, kt * kDepth,
                0, leader);
    for (int i = 0; i < present; ++i)
      tma_load_3d(st + w3_bytes + i * kImgTile, &img_map, &full[s],
                  kt * kDepth, 0, s0 + i, leader);
  };
  for (int kt = 0; kt < stages - lag && kt < steps; ++kt) load(kt);

  // warpgroup wg owns sample n; its thread holds rows o_lo and o_hi =
  // o_lo + 8 of the m64 tile in the A fragment
  const int wg = warp / 4, w4 = warp % 4, g = lane / 4, t = lane % 4;
  const int n = s0 + wg;
  const bool live = wg < present;
  const int o_lo = w4 * 16 + g, o_hi = o_lo + 8;
  float q_lo[kMaxK], q_hi[kMaxK];
#pragma unroll
  for (int j = 0; j < kMaxK; ++j) {
    q_lo[j] = q_hi[j] = 0.0f;
    if (j < k && live) {
      const bf16* qp = q3 + ((size_t)n * k + j) * o_pad + o0;
      q_lo[j] = __bfloat162float(qp[o_lo]);
      q_hi[j] = __bfloat162float(qp[o_hi]);
    }
  }

  float acc[kLRows / 2];
#pragma unroll
  for (int i = 0; i < kLRows / 2; ++i) acc[i] = 0.0f;

  for (int kt = 0; kt < steps; ++kt) {
    const int s = kt % stages;
    mbar_wait(&full[s], (kt / stages) & 1);
    const unsigned char* st = ring + s * stage_bytes;
#pragma unroll
    for (int ks = 0; ks < kDepth / 16; ++ks) {
      // wq at rows o_lo, o_hi and depths dd, dd + 1, dd + 8, dd + 9
      const int dd = ks * 16 + 2 * t;
      float wq[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) wq[h][e] = 0.0f;
#pragma unroll
      for (int j = 0; j < kMaxK; ++j) {
        if (j < k) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int de = dd + (e & 1) + (e >> 1) * 8;
            wq[0][e] = __fadd_rn(
                wq[0][e], __fmul_rn(w3_at(st, k, j, de, o_lo), q_lo[j]));
            wq[1][e] = __fadd_rn(
                wq[1][e], __fmul_rn(w3_at(st, k, j, de, o_hi), q_hi[j]));
          }
        }
      }
      const uint32_t a[4] = {pack_bf16(wq[0][0], wq[0][1]),
                             pack_bf16(wq[1][0], wq[1][1]),
                             pack_bf16(wq[0][2], wq[0][3]),
                             pack_bf16(wq[1][2], wq[1][3])};
      const uint64_t db = smem_desc(st + w3_bytes + wg * kImgTile + ks * 32,
                                    16, 512, kSwizzle64);
      wgmma_fence();
      WgmmaRS<kLRows>::rs<0>(acc, a, db);
      wgmma_commit();
      // the product before this one is done (the next fragment is built
      // while this one runs); at ks == 0 that was the previous stage's last
      wgmma_wait<1>();
      if (ks == 0 && kt > 0 && lag == 1 && lane == 0)
        mbar_arrive(&empty[(kt - 1) % stages]);
    }
    if (lag == 0) {
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    // the released stage is refilled with step kt + stages - lag once all
    // 8 warps have released it
    const int next = kt + stages - lag;
    if (next < steps) {
      if (next >= stages)
        mbar_wait(&empty[next % stages], ((next - stages) / stages) & 1);
      load(next);
    }
  }
  wgmma_wait<0>();
  fence_operands(acc);

  // epilogue: bq in f32 (j in order), the signed sqrt, z, and the sum of
  // squares in a fixed order: the thread's elements, the warp's lanes by
  // butterfly, then the group's 4 warps in order
  float bq_lo = 0.0f, bq_hi = 0.0f;
#pragma unroll
  for (int j = 0; j < kMaxK; ++j) {
    if (j < k) {
      const float* bp = b3 + (size_t)j * o_pad + o0;
      bq_lo = __fadd_rn(bq_lo, __fmul_rn(bp[o_lo], q_lo[j]));
      bq_hi = __fadd_rn(bq_hi, __fmul_rn(bp[o_hi], q_hi[j]));
    }
  }
  float ss = 0.0f;
  if (live) {
    float* z_n = z + (size_t)n * l * o_pad + o0;
#pragma unroll
    for (int i = 0; i < kLRows / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = 8 * i + 2 * t + (e & 1);
        if (row < l) {
          const bool hi = e >= 2;
          const float zv =
              signed_sqrt(acc[4 * i + e] + (hi ? bq_hi : bq_lo));
          z_n[(size_t)row * o_pad + (hi ? o_hi : o_lo)] = zv;
          ss = __fadd_rn(ss, __fmul_rn(zv, zv));
        }
      }
    }
  }
  ss = warp_sum(ss);
  if (lane == 0) red_s[wg][w4] = ss;
  named_sync(1 + wg, 128);
  if (live && w4 == 0 && lane == 0) {
    float tsum = 0.0f;
    for (int w = 0; w < 4; ++w) tsum += red_s[wg][w];
    ssq_part[(size_t)n * gridDim.x + tile] = tsum;
  }
}

// ---------------------------------------------------------------------------
// B: h1 = bf16(relu(bf16(z / ||z||) @ c1w + c1b))
// ---------------------------------------------------------------------------
// A block owns one sample and 128 columns of C: two warpgroups of two m64
// row tiles each (rows 0-255 cover L <= 208). Thread 0 keeps a ring of TMA
// stages full, three ahead: z's [256 l, 32 o] f32 tile (128-byte swizzle;
// rows past L come in as zeros) and c1w's [32 o, 128 c] bf16 tile (two
// boxes of 64 c, 128-byte swizzle). Each warpgroup builds its zb fragments
// in registers from the z tile, zb = bf16(z * inv) with inv =
// 1 / max(||z||, eps) from the partial sums in a fixed order, and runs
// h1 [64 l, 128 c] += zb [64 l, 16 o] x c1w [16 o, 128 c] with wgmma (B
// MN-major from shared memory).
constexpr int kHidTile = 128;                  // C per block: wgmma's N
constexpr int kHidDepth = 32;                  // O_pad per ring stage
constexpr int kHidRows = 256;                  // 4 m64 tiles of L rows
constexpr int kHidZTile = kHidRows * kHidDepth * 4;
constexpr int kHidWAtom = 64 * kHidDepth * 2;  // one 64-column c1w box
constexpr int kHidStage = kHidZTile + 2 * kHidWAtom;
constexpr int kHidStages = 4;
constexpr int kHidThreads = 2 * 128;

// the f32 pair z[row, o], z[row, o + 1] of the stage's z tile (rows of
// 128 B, 16-byte chunks swizzled by row % 8)
__device__ __forceinline__ float2 z_pair(const unsigned char* z_s, int row,
                                         int o) {
  const int off = row * 128 + ((((o >> 2) ^ (row & 7)) << 4) | ((o & 3) << 2));
  return *reinterpret_cast<const float2*>(z_s + off);
}

__global__ void __launch_bounds__(kHidThreads, 1)
    stage1_hidden_kernel(const __grid_constant__ CUtensorMap z_map,    // z
                         const __grid_constant__ CUtensorMap c1w_map,  // c1w
                         const float* __restrict__ ssq_part,  // [N, parts]
                         const float* __restrict__ c1b,       // [C]
                         bf16* __restrict__ h1,               // [N, L, C]
                         int l, int o_pad, int c, int parts, float eps) {
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kHidStages;
  unsigned char* ring = smem + 1024;

  const int c0 = blockIdx.x * kHidTile;
  const int n = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int steps = o_pad / kHidDepth;

  if (tid == 0) {
    for (int s = 0; s < kHidStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // step kt into stage kt % kHidStages, requested by thread 0
  const bool leader = tid == 0;
  auto load = [&](int kt) {
    const int s = kt % kHidStages;
    unsigned char* st = ring + s * kHidStage;
    mbar_expect_tx(&full[s], kHidStage, leader);
    tma_load_3d(st, &z_map, &full[s], kt * kHidDepth, 0, n, leader);
    tma_load_2d(st + kHidZTile, &c1w_map, &full[s], c0, kt * kHidDepth,
                leader);
    tma_load_2d(st + kHidZTile + kHidWAtom, &c1w_map, &full[s], c0 + 64,
                kt * kHidDepth, leader);
  };
  for (int kt = 0; kt < kHidStages - 1 && kt < steps; ++kt) load(kt);

  // the norm: the partial sums in order, as every thread computes it
  float ssq = 0.0f;
  for (int i = 0; i < parts; ++i) ssq += ssq_part[(size_t)n * parts + i];
  const float inv = 1.0f / fmaxf(sqrtf(ssq), eps);

  const int wg = warp / 4, w4 = warp % 4, g = lane / 4, t = lane % 4;
  float acc[2][kHidTile / 2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int i = 0; i < kHidTile / 2; ++i) acc[mt][i] = 0.0f;

  for (int kt = 0; kt < steps; ++kt) {
    const int s = kt % kHidStages;
    mbar_wait(&full[s], (kt / kHidStages) & 1);
    const unsigned char* st = ring + s * kHidStage;
#pragma unroll
    for (int ks = 0; ks < kHidDepth / 16; ++ks) {
      // c1w: 16 rows of o (8-row groups 1 KB apart), the two 64-column
      // boxes kHidWAtom apart
      const uint64_t db = smem_desc(st + kHidZTile + ks * 16 * 128,
                                    kHidWAtom, 1024, kSwizzle128);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int row = (wg * 2 + mt) * 64 + w4 * 16 + g;
        const int o = ks * 16 + 2 * t;
        const float2 v0 = z_pair(st, row, o), v1 = z_pair(st, row + 8, o);
        const float2 v2 = z_pair(st, row, o + 8);
        const float2 v3 = z_pair(st, row + 8, o + 8);
        const uint32_t a[4] = {
            pack_bf16(__fmul_rn(v0.x, inv), __fmul_rn(v0.y, inv)),
            pack_bf16(__fmul_rn(v1.x, inv), __fmul_rn(v1.y, inv)),
            pack_bf16(__fmul_rn(v2.x, inv), __fmul_rn(v2.y, inv)),
            pack_bf16(__fmul_rn(v3.x, inv), __fmul_rn(v3.y, inv))};
        wgmma_fence();
        WgmmaRS<kHidTile>::rs<1>(acc[mt], a, db);
        wgmma_commit();
        wgmma_wait<1>();
        if (ks == 0 && mt == 0 && kt > 0 && lane == 0)
          mbar_arrive(&empty[(kt - 1) % kHidStages]);
      }
    }
    // the stage of step kt - 1 is refilled once all 8 warps released it
    const int next = kt + kHidStages - 1;
    if (next < steps) {
      if (kt > 0)
        mbar_wait(&empty[next % kHidStages], ((kt - 1) / kHidStages) & 1);
      load(next);
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) fence_operands(acc[mt]);

  bf16* h1_n = h1 + (size_t)n * l * c;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int row = (wg * 2 + mt) * 64 + w4 * 16 + g;
#pragma unroll
    for (int i = 0; i < kHidTile / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row + (e >> 1) * 8, col = c0 + 8 * i + 2 * t + (e & 1);
        if (r < l && col < c)
          h1_n[(size_t)r * c + col] =
              __float2bfloat16(fmaxf(acc[mt][4 * i + e] + c1b[col], 0.0f));
      }
    }
  }
}

// ---------------------------------------------------------------------------
// C: logits, softmax over L per glimpse, out = bf16(bf16(att)^T @ img)
// ---------------------------------------------------------------------------
// grid (ceil(D / 512), N): each block forms its sample's logits and softmax
// (recomputed by each of the sample's blocks, a few hundred kFLOP) and
// pools its 512 channels of img.
__global__ void __launch_bounds__(kThreads)
    stage1_pool_kernel(const bf16* __restrict__ h1,    // [N, L, C]
                       const bf16* __restrict__ c2w,   // [C, G]
                       const float* __restrict__ c2b,  // [G]
                       const bf16* __restrict__ img,   // [N, L, D]
                       bf16* __restrict__ out,         // [N, G, D]
                       int l, int d, int c, int g) {
  __shared__ float logit_s[kRows * kMaxG];  // [L][kMaxG]
  __shared__ float att_s[kMaxG * kRows];    // [kMaxG][L]

  const int n = blockIdx.y;
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

  // attention pool of the block's 512 channels: two adjacent channels per
  // thread, f32 accumulation
  const int dc = blockIdx.x * kPoolCols + tid * 2;
  if (dc < d) {
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
                              int o_pad, int c, int c_pad, int g, float eps,
                              void* stream) {
  if (l < 1 || l > kRows || d < 8 || d % 8 || k < 1 || k > kMaxK ||
      o_pad < kOTile || o_pad % kOTile || c < 1 || c_pad < c || c_pad % 8 ||
      g < 1 || g > kMaxG || n < 0 || n > 65535)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);

  CUtensorMap w3_map, img_map;
  const uint64_t w3_dims[3] = {(uint64_t)o_pad, (uint64_t)d, (uint64_t)k};
  const uint64_t w3_strides[2] = {(uint64_t)o_pad * 4,
                                  (uint64_t)d * o_pad * 4};
  const uint32_t w3_box[3] = {32, kDepth, (uint32_t)k};
  cudaError_t err = hopper::make_map(
      &w3_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, w3, w3_dims, w3_strides,
      w3_box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return (int)err;
  const uint64_t img_dims[3] = {(uint64_t)d, (uint64_t)l, (uint64_t)n};
  const uint64_t img_strides[2] = {(uint64_t)d * 2, (uint64_t)l * d * 2};
  const uint32_t img_box[3] = {kDepth, kLRows, 1};
  err = hopper::make_map(&img_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, img,
                         img_dims, img_strides, img_box,
                         CU_TENSOR_MAP_SWIZZLE_64B);
  if (err != cudaSuccess) return (int)err;
  // as many stages as fit: 3 at k = 5, 1 at k = 16
  int stages = (kSmemBudget - 4096) / grid_stage_bytes(k);
  stages = stages < kMaxStages ? stages : kMaxStages;
  const int smem = 2048 + stages * grid_stage_bytes(k);
  err = cudaFuncSetAttribute(stage1_grid_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return (int)err;
  stage1_grid_kernel<<<dim3(o_pad / kOTile, (n + kSamples - 1) / kSamples),
                       kGridThreads, smem, s>>>(
      w3_map, img_map, static_cast<const float*>(b3),
      static_cast<const bf16*>(q3), static_cast<float*>(z),
      static_cast<float*>(ssq_part), n, l, d, k, o_pad, stages);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  CUtensorMap z_map, c1w_map;
  const uint64_t z_dims[3] = {(uint64_t)o_pad, (uint64_t)l, (uint64_t)n};
  const uint64_t z_strides[2] = {(uint64_t)o_pad * 4, (uint64_t)l * o_pad * 4};
  const uint32_t z_box[3] = {kHidDepth, kHidRows, 1};
  err = hopper::make_map(&z_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, z,
                         z_dims, z_strides, z_box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return (int)err;
  const uint64_t c1w_dims[2] = {(uint64_t)c_pad, (uint64_t)o_pad};
  const uint64_t c1w_strides[1] = {(uint64_t)c_pad * 2};
  const uint32_t c1w_box[2] = {64, kHidDepth};
  err = hopper::make_map(&c1w_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, c1w,
                         c1w_dims, c1w_strides, c1w_box,
                         CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return (int)err;
  const int hid_smem = 2048 + kHidStages * kHidStage;
  err = cudaFuncSetAttribute(stage1_hidden_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             hid_smem);
  if (err != cudaSuccess) return (int)err;
  stage1_hidden_kernel<<<dim3((c + kHidTile - 1) / kHidTile, n), kHidThreads,
                         hid_smem, s>>>(
      z_map, c1w_map, static_cast<const float*>(ssq_part),
      static_cast<const float*>(c1b), static_cast<bf16*>(h1), l, o_pad, c,
      o_pad / kOTile, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  stage1_pool_kernel<<<dim3((d + kPoolCols - 1) / kPoolCols, n), kThreads,
                       0, s>>>(
      static_cast<const bf16*>(h1), static_cast<const bf16*>(c2w),
      static_cast<const float*>(c2b), static_cast<const bf16*>(img),
      static_cast<bf16*>(out), l, d, c, g);
  return (int)cudaGetLastError();
}

// the O tile of a block of launch A: ssq_part holds o_pad / stage1_o_tile()
// partials a sample
int stage1_o_tile(void) { return kOTile; }

const char* stage1_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
