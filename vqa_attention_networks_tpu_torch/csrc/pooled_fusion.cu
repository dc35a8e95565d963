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
// 64 outputs of it, so the forward's epilogue (an instantiation that only
// K6 compiles) writes each sample's sum of squares over its tile, and one
// more launch adds a sample's tile sums and scales z. At N = 256 K6's
// bound is ~0.29 ms of operations (the 205 GFLOP product and the 5.2 GFLOP
// f32 wq build); the norm's extra bytes (z written and read once, f32, and
// the bf16 out) are ~0.09 ms at 3.35 TB/s.
//
// What bounds it on this card, at N = 64, L = 196, D = 2048, O = 1000,
// k = 5. Each launch is one product of 2*N*L*D*O = 51.4 GFLOP (0.052 ms at
// 989 TFLOP/s bf16) plus f32 elementwise work: the wq build, 2*N*k*D*O =
// 1.3 GFLOP (forward, d_img), and d_W's and d_q's contractions with q and
// W, 4*N*D*F = 2.6 GFLOP (d_W). The bytes each must move once: forward
// ~121 MB (img, W, out), d_img ~148 MB (g_pooled, W, d_img in f32), d_W
// ~213 MB (g, out, img, W, d_W in f32); 0.036-0.067 ms at 3.35 TB/s. So
// the operations bound it (0.07-0.09 ms, the f32 work at 67 TFLOP/s added
// to the product's). The forward is a TMA ring with wgmma: what holds it
// is its L2 traffic, each block reading its O tile's W slab (1.3 MB) and
// two samples' img (1.6 MB), ~1.5 GB at N = 64 (a 2-block cluster
// multicasting img, tried, was slower). d_img is the forward turned
// around, d_img[n]^T [64 d, 208 l] = wq[n] [64 d, O] x g_pooled[n]^T, with
// the same ring, the same wq build in registers (from W's [64 d, 32 k
// channels] slab and the sample's q) and the same wgmma m64n208k16; its L2
// traffic is ~1.7 GB at N = 64 (each block reads a 64-row slab of W, 0.79
// MB with its 64-channel boxes' overlap, and two samples' g_pooled, 0.85
// MB). One sample a block, two blocks an SM, ran 12% slower on an H100.
// What holds it is the wq build's shared-memory reads, W and q taken as
// 4-byte words (K of each for two neighbouring outputs).
// d_W's product kernel is a TMA ring with wgmma; what holds it is the f32
// work per sample (d_W's k sums and d_q's partial, unfused as the plain
// version rounds them), which one block of 8 warps an SM does in turn with
// the sample's products while the ring's loads run beside them.
//
// What the design does about the TPU's structure. The TPU kernel keeps the
// whole k-major W [k, D, O_pad] (20 MB bf16) resident in VMEM and rebuilds
// each sample's wq there; 227 KB of shared memory cannot hold it, so W is
// read in its natural [D, F] layout from L2 (20 MB fits the 50 MB L2) and
// each block builds the wq tile it needs, once per (sample, D chunk, O
// tile): the forward in registers, as wgmma's A operand. The TPU's d_W
// kernel accumulated d_W and d_b over consecutive sample revisits of a
// sequential grid; blocks here run in parallel, so a d_W block owns a (D
// tile, O tile) of d_W for all k and loops over the samples inside the
// block, with its k*64*64 f32 sums in registers (16 accumulators a thread,
// and k sums for each: k <= 7 fits).
// d_q sums over D, across blocks: each block writes its D tile's partial
// sums, and a later launch of the same entry adds them in D-tile order. No
// atomics: reruns give the same bits.
// g_pooled is formed once by its own launch (bf16 for the products, its
// f32 sum over L for d_bq), not in each of the 32 D tiles that read it;
// the backward hands it to both d_img and d_W.
//
// Launches:
//   pooled_fusion_forward  fwd_kernel<k, false>, grid (ceil(O/64), ceil(N/2)):
//       64 outputs of two samples, one warpgroup each, over a 4-stage TMA
//       ring of W's slab and the samples' img (32 deep); out^T [64 o,
//       208 l] by wgmma m64n208k16 with wq^T built in registers; epilogue
//       + bq, signed sqrt -> out.
//   pooled_fusion_g_pooled g_pooled once: bf16 gp [N, L, O8] (0 past O) and
//       the f32 d_bq [N, O], grid (ceil(O8/256), N).
//   pooled_fusion_d_img    d_img_kernel<k>, grid (ceil(D/64), ceil(N/2)):
//       64 rows of D for two samples, one warpgroup each, over a TMA ring
//       of W's slab and the samples' gp and q (32 outputs deep);
//       d_img^T [64 d, 208 l] by wgmma m64n208k16 with wq built in
//       registers; f32 out through a staged tile.
//   pooled_fusion_d_w      three launches over gp and d_bq: d_b; d_W and
//       d_q's partials, grid (ceil(O/64), ceil(D/64)),
//       each block walking the samples through a TMA ring (one sample's
//       g_pooled and img rows a stage): per sample, d_wq^T [64 o, 64 d] by
//       wgmma over L, added into d_W's k sums with q in registers and
//       contracted with the block's W tile (kept in shared memory) into
//       d_q's partial; then d_q's reduction over ceil(N*F/256) blocks.
//   pooled_fusion_wq_grid  (K6) two launches: fwd_kernel<k, true>, the
//       forward into an f32 z scratch whose epilogue writes each sample's
//       sum of squares over the block's 64 outputs and L rows (the
//       thread's elements, the warp's lanes, the 4 warps, in order);
//       grid_scale_kernel, grid (ceil(L*O/2048), N): the sample's norm
//       from its ceil(O/64) tile sums in tile order (no atomics: reruns
//       give the same bits), and bf16(z * (1 / max(norm, eps))).
// Each entry returns cudaGetLastError() after its launches (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;  // 8 warps
constexpr int kRows = 208;      // L rows a kernel holds: wgmma's N
constexpr int kMaxK = 7;        // d_W's k sums per (d, o) in registers
constexpr int kMaxSmem = 232448;  // dynamic shared memory of a block

// sqrt(max(p, 0)) - sqrt(max(-p, 0)) with one square root in the code
// (the same bits, 0 and NaN giving +0; only a -0 from the two-root form
// could differ): each sqrtf inlines a slow path behind a branch, and two
// of them took the forward from 1.97-2.00 to 2.18-2.28 ms at N = 256 on
// an H100
__device__ __forceinline__ float signed_sqrt(float p) {
  const float r = sqrtf(fabsf(p));
  return p > 0.0f ? r : p < 0.0f ? -r : 0.0f;
}

// g * d out / d pooled, with the zero-cotangent rule at out == 0
__device__ __forceinline__ float pooled_grad(float g, float out) {
  if (out == 0.0f) return 0.0f;
  return __fmul_rn(g, __fdiv_rn(0.5f, fmaxf(fabsf(out), 1e-20f)));
}

// ---------------------------------------------------------------------------
// forward: out = signed_sqrt(img @ bf16(wq) + bq)
// ---------------------------------------------------------------------------
// A block owns one 64-wide O tile for kFwdSamples samples, one warpgroup
// each (the grid's x, the O tile, runs fastest, so the blocks resident at
// once share a few sample pairs' img in L2 beside all of W). Thread 0
// keeps a ring of kFwdStages TMA stages full: W's [32 d, 64 K channels]
// slab (bf16, read in place from [D, F] as K boxes of 64 channels with
// 128-byte swizzle; boxes wholly past F are not loaded, since their
// channels belong to outputs past O, which the epilogue drops), read from
// L2 once for both samples, and each sample's img [208 l, 32 d] (bf16,
// 64-byte swizzle, a 3D box over [N, L, D] whose rows past L come in as
// zeros; samples past N are not loaded). Each warpgroup builds its
// sample's wq^T fragments in registers, wq[d, o] = sum_j f32(W[d, o K + j])
// * f32(q[n, o K + j]) (unfused, j in order), rounded to bf16 once, and
// runs out^T [64 o, 208 l] += wq^T [64 o, 16 d] x img^T [16 d, 208 l] with
// wgmma (A from registers, B = img K-major from shared memory), building
// the next fragment while the product before it runs.
constexpr int kFwdSamples = 2;   // warpgroups, one sample each
constexpr int kFwdOTile = 64;    // o per block: wgmma's M
constexpr int kFwdDepth = 32;    // D per ring stage
constexpr int kFwdThreads = kFwdSamples * 128;
constexpr int kFwdStages = 4;    // 4 fit at every K <= 7 (223 KB at K = 7)
constexpr int kFwdWBox = kFwdDepth * 64 * 2;    // one 64-channel W box
constexpr int kFwdImg = kRows * kFwdDepth * 2;  // one sample's img stage

// bytes of one ring stage: W's K boxes, then the img tiles; every part a
// multiple of 1 KB (the swizzle atoms' alignment)
__host__ __device__ constexpr int fwd_stage_bytes(int k) {
  return k * kFwdWBox + kFwdSamples * kFwdImg;
}

// f32(W[d0 + row, c0 + c]) from the stage's W boxes: box c / 64, rows of
// 128 B whose 16-byte chunks are swizzled by row % 8
__device__ __forceinline__ float w_at(const unsigned char* w_s, int c,
                                      int row) {
  const int cc = c & 63;
  const int off = (c >> 6) * kFwdWBox + row * 128 +
                  ((((cc >> 3) ^ (row & 7)) << 4) | ((cc & 7) << 1));
  return __bfloat162float(__ushort_as_bfloat16(
      *reinterpret_cast<const unsigned short*>(w_s + off)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// kSsq (K6 only): each sample's sum of squares of its outputs in the
// block's tile goes to ssq [N, ceil(O/64)], in a fixed order: the
// thread's elements, the warp's lanes, the warpgroup's 4 warps
template <int K, bool kSsq>
__global__ void __launch_bounds__(kFwdThreads, 1)
    fwd_kernel(const __grid_constant__ CUtensorMap w_map,    // [D, F] bf16
               const __grid_constant__ CUtensorMap img_map,  // [N, L, D]
               const float* __restrict__ b,   // [F]
               const bf16* __restrict__ q,    // [N, F]
               float* __restrict__ out,       // [N, L, O]
               float* __restrict__ ssq,       // [N, ceil(O/64)] if kSsq
               int n_total, int l, int d, int f) {
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kFwdStages;
  unsigned char* ring = smem + 1024;

  const int o_dim = f / K;
  const int o0 = blockIdx.x * kFwdOTile, c0 = o0 * K;
  const int s0 = blockIdx.y * kFwdSamples;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int steps = (d + kFwdDepth - 1) / kFwdDepth;
  constexpr int kStage = fwd_stage_bytes(K);
  const int boxes = min(K, (f - c0 + 63) / 64);
  const int present = min(kFwdSamples, n_total - s0);

  if (tid == 0) {
    for (int s = 0; s < kFwdStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kFwdSamples * 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // step kt into stage kt % kFwdStages, requested by thread 0 (every thread
  // walks the same path: see mbar_expect_tx)
  const bool leader = tid == 0;
  auto load = [&](int kt) {
    const int s = kt % kFwdStages;
    unsigned char* st = ring + s * kStage;
    mbar_expect_tx(&full[s], boxes * kFwdWBox + present * kFwdImg, leader);
    for (int bx = 0; bx < boxes; ++bx)
      tma_load_2d(st + bx * kFwdWBox, &w_map, &full[s], c0 + 64 * bx,
                  kt * kFwdDepth, leader);
    for (int i = 0; i < present; ++i)
      tma_load_3d(st + K * kFwdWBox + i * kFwdImg, &img_map, &full[s],
                  kt * kFwdDepth, 0, s0 + i, leader);
  };
  for (int kt = 0; kt < kFwdStages - 1 && kt < steps; ++kt) load(kt);

  // warpgroup wg owns sample n; its thread holds outputs o_lo and o_hi =
  // o_lo + 8 of the m64 tile in the A fragment
  const int wg = warp / 4, w4 = warp % 4, g = lane / 4, t = lane % 4;
  const int n = s0 + wg;
  const bool live = wg < present;
  const int o_lo = w4 * 16 + g, o_hi = o_lo + 8;
  const bool ok_lo = live && o0 + o_lo < o_dim;
  const bool ok_hi = live && o0 + o_hi < o_dim;
  float q_lo[K], q_hi[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const bf16* qp = q + (size_t)n * f + c0 + j;
    q_lo[j] = ok_lo ? __bfloat162float(qp[o_lo * K]) : 0.0f;
    q_hi[j] = ok_hi ? __bfloat162float(qp[o_hi * K]) : 0.0f;
  }

  float acc[kRows / 2];
#pragma unroll
  for (int i = 0; i < kRows / 2; ++i) acc[i] = 0.0f;

  for (int kt = 0; kt < steps; ++kt) {
    const int s = kt % kFwdStages;
    mbar_wait(&full[s], (kt / kFwdStages) & 1);
    const unsigned char* st = ring + s * kStage;
#pragma unroll
    for (int ks = 0; ks < kFwdDepth / 16; ++ks) {
      // wq at outputs o_lo, o_hi and depths dd, dd + 1, dd + 8, dd + 9
      const int dd = ks * 16 + 2 * t;
      float wq[2][4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int de = dd + (e & 1) + (e >> 1) * 8;
        wq[0][e] = __fmul_rn(w_at(st, o_lo * K, de), q_lo[0]);
        wq[1][e] = __fmul_rn(w_at(st, o_hi * K, de), q_hi[0]);
#pragma unroll
        for (int j = 1; j < K; ++j) {
          wq[0][e] = __fadd_rn(
              wq[0][e], __fmul_rn(w_at(st, o_lo * K + j, de), q_lo[j]));
          wq[1][e] = __fadd_rn(
              wq[1][e], __fmul_rn(w_at(st, o_hi * K + j, de), q_hi[j]));
        }
      }
      const uint32_t a[4] = {pack_bf16(wq[0][0], wq[0][1]),
                             pack_bf16(wq[1][0], wq[1][1]),
                             pack_bf16(wq[0][2], wq[0][3]),
                             pack_bf16(wq[1][2], wq[1][3])};
      const uint64_t db = smem_desc(st + K * kFwdWBox + wg * kFwdImg + ks * 32,
                                    16, 512, kSwizzle64);
      wgmma_fence();
      WgmmaRS<kRows>::rs<0>(acc, a, db);
      wgmma_commit();
      // the product before this one is done (the next fragment is built
      // while this one runs); at ks == 0 that was the previous stage's last
      wgmma_wait<1>();
      if (ks == 0 && kt > 0 && lane == 0)
        mbar_arrive(&empty[(kt - 1) % kFwdStages]);
    }
    // the stage of step kt - 1 is refilled with step kt + kFwdStages - 1
    // once all 8 warps have released it
    const int next = kt + kFwdStages - 1;
    if (next < steps) {
      if (kt > 0)
        mbar_wait(&empty[next % kFwdStages], ((kt - 1) / kFwdStages) & 1);
      load(next);
    }
  }
  wgmma_wait<0>();
  fence_operands(acc);

  // epilogue: bq in f32 (j in order), the signed sqrt, out masked past L
  // and O
  float bq_lo = 0.0f, bq_hi = 0.0f;
  if (ok_lo) {
    const float* bp = b + c0 + o_lo * K;
    bq_lo = __fmul_rn(bp[0], q_lo[0]);
#pragma unroll
    for (int j = 1; j < K; ++j)
      bq_lo = __fadd_rn(bq_lo, __fmul_rn(bp[j], q_lo[j]));
  }
  if (ok_hi) {
    const float* bp = b + c0 + o_hi * K;
    bq_hi = __fmul_rn(bp[0], q_hi[0]);
#pragma unroll
    for (int j = 1; j < K; ++j)
      bq_hi = __fadd_rn(bq_hi, __fmul_rn(bp[j], q_hi[j]));
  }
  float* out_n = out + (size_t)n * l * o_dim + o0;
  float ss = 0.0f;
#pragma unroll
  for (int i = 0; i < kRows / 8; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = 8 * i + 2 * t + (e & 1);
      const bool hi = e >= 2;
      if (row < l && (hi ? ok_hi : ok_lo)) {
        const float p = __fadd_rn(acc[4 * i + e], hi ? bq_hi : bq_lo);
        const float z = signed_sqrt(p);
        out_n[(size_t)row * o_dim + (hi ? o_hi : o_lo)] = z;
        if constexpr (kSsq) ss = __fadd_rn(ss, __fmul_rn(z, z));
      }
    }
  }
  if constexpr (kSsq) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, off));
    // the ring's first KB holds only the barriers: 8 floats at 512
    float* red_s = reinterpret_cast<float*>(smem + 512);
    if (lane == 0) red_s[warp] = ss;
    __syncthreads();
    if (live && w4 == 0 && lane == 0) {
      float tsum = red_s[4 * wg];
      for (int w = 1; w < 4; ++w) tsum = __fadd_rn(tsum, red_s[4 * wg + w]);
      ssq[(size_t)n * gridDim.x + blockIdx.x] = tsum;
    }
  }
}

template <int K, bool kSsq>
int launch_fwd(const void* img, const void* w, const void* b, const void* q,
               void* out, void* ssq, int n, int l, int d, int f,
               cudaStream_t s) {
  CUtensorMap w_map, img_map;
  const uint64_t w_dims[2] = {(uint64_t)f, (uint64_t)d};
  const uint64_t w_strides[1] = {(uint64_t)f * 2};
  const uint32_t w_box[2] = {64, kFwdDepth};
  cudaError_t err = hopper::make_map(
      &w_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w, w_dims, w_strides,
      w_box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return (int)err;
  const uint64_t img_dims[3] = {(uint64_t)d, (uint64_t)l, (uint64_t)n};
  const uint64_t img_strides[2] = {(uint64_t)d * 2, (uint64_t)l * d * 2};
  const uint32_t img_box[3] = {kFwdDepth, kRows, 1};
  err = hopper::make_map(&img_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, img,
                         img_dims, img_strides, img_box,
                         CU_TENSOR_MAP_SWIZZLE_64B);
  if (err != cudaSuccess) return (int)err;
  const int smem = 2048 + kFwdStages * fwd_stage_bytes(K);
  err = cudaFuncSetAttribute(fwd_kernel<K, kSsq>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((f / K + kFwdOTile - 1) / kFwdOTile,
                  (n + kFwdSamples - 1) / kFwdSamples);
  fwd_kernel<K, kSsq><<<grid, kFwdThreads, smem, s>>>(
      w_map, img_map, static_cast<const float*>(b),
      static_cast<const bf16*>(q), static_cast<float*>(out),
      static_cast<float*>(ssq), n, l, d, f);
  return (int)cudaGetLastError();
}

template <bool kSsq>
int launch_fwd_k(const void* img, const void* w, const void* b,
                 const void* q, void* out, void* ssq, int n, int l, int d,
                 int f, int k, cudaStream_t s) {
  switch (k) {
    case 1: return launch_fwd<1, kSsq>(img, w, b, q, out, ssq, n, l, d, f, s);
    case 2: return launch_fwd<2, kSsq>(img, w, b, q, out, ssq, n, l, d, f, s);
    case 3: return launch_fwd<3, kSsq>(img, w, b, q, out, ssq, n, l, d, f, s);
    case 4: return launch_fwd<4, kSsq>(img, w, b, q, out, ssq, n, l, d, f, s);
    case 5: return launch_fwd<5, kSsq>(img, w, b, q, out, ssq, n, l, d, f, s);
    case 6: return launch_fwd<6, kSsq>(img, w, b, q, out, ssq, n, l, d, f, s);
    case 7: return launch_fwd<7, kSsq>(img, w, b, q, out, ssq, n, l, d, f, s);
  }
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// d_img = bf16(g_pooled) @ bf16(wq)^T: the forward turned around
// ---------------------------------------------------------------------------
// A block owns 64 rows of D for kImgSamples samples, one warpgroup each,
// and computes d_img[n]^T [64 d, 208 l] = wq[n] [64 d, O] x g_pooled[n]^T
// by wgmma m64n208k16, 16 outputs a step. Thread 0 keeps a ring of
// ImgShape<K>::kStages stages full with TMA, each 32 outputs deep: W's
// [64 d, 32 K channels] slab (bf16, read in place from [D, F] as boxes of
// 64 channels with 128-byte swizzle, as the forward reads W; boxes wholly
// past F are not loaded), and for each sample its g_pooled [208 l, 32 o]
// from the g_pooled launch (bf16, 64-byte swizzle, a 3D box over
// [N, L, O8] whose rows past L and outputs past O8 come in as zeros) and
// its q [32 K channels] (zeros past F; samples past N are not loaded). A
// warpgroup builds its sample's wq fragments in registers, wq[d, o] =
// sum_j f32(W[d, o K + j]) * f32(q[n, o K + j]) (unfused, j in order),
// rounded to bf16 once, as wgmma's A; B is g_pooled, K-major. The next
// fragment is built while the product before it runs. The epilogue stages
// each sample's f32 tile [208 l, 64 d] over the ring and stores its rows
// in 16-byte pieces, 256 contiguous bytes a row. Two samples a block, as
// the forward: one sample a block (grid (D / 64, N), two blocks an SM) ran
// at 0.563 ms against 0.503 at N = 64 on the card (PERF.md).
constexpr int kImgSamples = 2;  // warpgroups, a sample each
constexpr int kImgDTile = 64;   // d per block: wgmma's M
constexpr int kImgDepth = 32;   // outputs per ring stage
constexpr int kImgThreads = kImgSamples * 128;
constexpr int kImgWBox = kImgDTile * 128;       // one [64 d, 64 c] W box
constexpr int kImgGp = kRows * kImgDepth * 2;   // a sample's g_pooled stage
constexpr int kImgQ = 512;       // a sample's q slot: 32 K bf16 (<= 448 B)
constexpr int kImgLd = kImgDTile + 4;  // f32 row of the staged tile

template <int K>
struct ImgShape {
  static constexpr int kBoxes = (kImgDepth * K + 63) / 64;  // W boxes
  static constexpr int kWBytes = kBoxes * kImgWBox;
  // W's boxes, the samples' g_pooled, their q: each part 1 KB aligned
  static constexpr int kStageBytes = kWBytes + kImgSamples * kImgGp +
                                     (kImgSamples * kImgQ + 1023) / 1024 * 1024;
  // the SM's 228 KB, less 1 KB the system's and this block's 2 KB
  static constexpr int kFit = (233472 - 1024 - 2048) / kStageBytes;
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static constexpr int kRing = kStages * kStageBytes;
  // 1 KB of alignment slack, 1 KB of barriers, then the ring (reused as
  // the epilogue's f32 tiles)
  static constexpr int kSmem = 2048 + kRing;
  static_assert(kStages >= 2, "two ring stages fit");
  static_assert(kImgSamples * kRows * kImgLd * 4 <= kRing,
                "the staged tiles fit over the ring");
};

// f32 of the 2 K channels c0 .. c0 + 2 K - 1 (c0 even) of D row `row` of
// the stage's W boxes (128-byte rows, 16-byte chunks swizzled by row % 8),
// K 4-byte words: one word never straddles a chunk
template <int K>
__device__ __forceinline__ void w_run(const unsigned char* w_s, int c0,
                                      int row, float (&v)[2 * K]) {
#pragma unroll
  for (int m = 0; m < K; ++m) {
    const int c = c0 + 2 * m, cc = c & 63;
    const int off = (c >> 6) * kImgWBox + row * 128 +
                    ((((cc >> 3) ^ (row & 7)) << 4) | ((cc & 7) << 1));
    const float2 x = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(w_s + off));
    v[2 * m] = x.x;
    v[2 * m + 1] = x.y;
  }
}

template <int K>
__global__ void __launch_bounds__(kImgThreads, 1)
    d_img_kernel(const __grid_constant__ CUtensorMap w_map,   // [D, F] bf16
                 const __grid_constant__ CUtensorMap gp_map,  // [N, L, O8]
                 const __grid_constant__ CUtensorMap q_map,   // [N, F] bf16
                 float* __restrict__ d_img,                   // [N, L, D]
                 int n_total, int l, int d, int f) {
  using S = ImgShape<K>;
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + S::kStages;
  unsigned char* ring = smem + 1024;

  const int o_dim = f / K;
  const int d0 = blockIdx.x * kImgDTile;
  const int s0 = blockIdx.y * kImgSamples;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int steps = (o_dim + kImgDepth - 1) / kImgDepth;
  const int present = min(kImgSamples, n_total - s0);

  // A W box that is never loaded must read as finite: zero them all once
  // (its q is 0, so a finite stale value adds 0)
  for (int s = 0; s < S::kStages; ++s)
    for (int i = tid; i < S::kWBytes / 16; i += kImgThreads)
      reinterpret_cast<uint4*>(ring + s * S::kStageBytes)[i] =
          make_uint4(0u, 0u, 0u, 0u);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  if (tid == 0) {
    for (int s = 0; s < S::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kImgSamples * 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // step kt into stage kt % kStages, requested by thread 0 (every thread
  // walks the same path: see mbar_expect_tx)
  const bool leader = tid == 0;
  auto load = [&](int kt) {
    const int s = kt % S::kStages;
    unsigned char* st = ring + s * S::kStageBytes;
    const int c0 = kt * kImgDepth * K;
    const int boxes = min(S::kBoxes, (f - c0 + 63) / 64);
    mbar_expect_tx(&full[s],
                   boxes * kImgWBox + present * (kImgGp + kImgDepth * K * 2),
                   leader);
    for (int bx = 0; bx < boxes; ++bx)
      tma_load_2d(st + bx * kImgWBox, &w_map, &full[s], c0 + 64 * bx, d0,
                  leader);
    for (int i = 0; i < present; ++i) {
      tma_load_3d(st + S::kWBytes + i * kImgGp, &gp_map, &full[s],
                  kt * kImgDepth, 0, s0 + i, leader);
      tma_load_2d(st + S::kWBytes + kImgSamples * kImgGp + i * kImgQ, &q_map,
                  &full[s], c0, s0 + i, leader);
    }
  };
  for (int kt = 0; kt < S::kStages - 1 && kt < steps; ++kt) load(kt);

  // warpgroup wg owns sample s0 + wg; its thread holds D rows d_lo and
  // d_lo + 8 of the m64 tile in the A fragment
  const int wg = warp / 4, w4 = warp % 4, g = lane / 4, t = lane % 4;
  const int d_lo = w4 * 16 + g;
  float acc[kRows / 2];
#pragma unroll
  for (int i = 0; i < kRows / 2; ++i) acc[i] = 0.0f;

  for (int kt = 0; kt < steps; ++kt) {
    const int s = kt % S::kStages;
    mbar_wait(&full[s], (kt / S::kStages) & 1);
    const unsigned char* st = ring + s * S::kStageBytes;
    const bf16* q_s = reinterpret_cast<const bf16*>(
        st + S::kWBytes + kImgSamples * kImgGp + wg * kImgQ);
#pragma unroll
    for (int ks = 0; ks < kImgDepth / 16; ++ks) {
      // wq at D rows d_lo, d_lo + 8 (h) and outputs oo, oo + 1, oo + 8,
      // oo + 9 (e) of the stage, oo = 16 ks + 2 t: the 2 K channels of each
      // pair of neighbouring outputs read as K words of W and of q
      float wq[2][4];
#pragma unroll
      for (int pair = 0; pair < 2; ++pair) {
        const int c0 = (ks * 16 + 2 * t + 8 * pair) * K;
        float w[2][2 * K], qv[2 * K];
        w_run<K>(st, c0, d_lo, w[0]);
        w_run<K>(st, c0, d_lo + 8, w[1]);
#pragma unroll
        for (int m = 0; m < K; ++m) {
          const float2 x = __bfloat1622float2(
              reinterpret_cast<const __nv_bfloat162*>(q_s + c0)[m]);
          qv[2 * m] = x.x;
          qv[2 * m + 1] = x.y;
        }
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const float* wj = w[h] + half * K;
            const float* qj = qv + half * K;
            float sum = __fmul_rn(wj[0], qj[0]);
#pragma unroll
            for (int j = 1; j < K; ++j)
              sum = __fadd_rn(sum, __fmul_rn(wj[j], qj[j]));
            wq[h][2 * pair + half] = sum;
          }
      }
      const uint32_t a[4] = {pack_bf16(wq[0][0], wq[0][1]),
                             pack_bf16(wq[1][0], wq[1][1]),
                             pack_bf16(wq[0][2], wq[0][3]),
                             pack_bf16(wq[1][2], wq[1][3])};
      // B: the sample's g_pooled rows of 64 B, k at 32 B a step, 8-row
      // groups 512 B apart
      const uint64_t db = smem_desc(st + S::kWBytes + wg * kImgGp + ks * 32,
                                    16, 512, kSwizzle64);
      wgmma_fence();
      WgmmaRS<kRows>::rs<0>(acc, a, db);
      wgmma_commit();
      // the product before this one is done (the next fragment is built
      // while this one runs); at ks == 0 that was the previous stage's last
      wgmma_wait<1>();
      if (ks == 0 && kt > 0 && lane == 0)
        mbar_arrive(&empty[(kt - 1) % S::kStages]);
    }
    // the stage of step kt - 1 is refilled with step kt + kStages - 1 once
    // all 8 warps have released it
    const int next = kt + S::kStages - 1;
    if (next < steps) {
      if (kt > 0)
        mbar_wait(&empty[next % S::kStages], ((kt - 1) / S::kStages) & 1);
      load(next);
    }
  }
  wgmma_wait<0>();
  fence_operands(acc);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();  // both groups past their products

  // each sample's tile [208 l, 64 d] over the ring (D row d_lo + 8 h, L
  // rows 8 i + 2 t + e in acc[4 i + 2 h + e]; rows 68 floats apart: a
  // warp's 32 stores fall in 32 banks). The thread's base address is taken
  // once: with the whole index computed at each store, ptxas placed that
  // work among the products and serialised them (C7515).
  float* tile = reinterpret_cast<float*>(ring) + wg * kRows * kImgLd;
  float* tile_t = tile + 2 * t * kImgLd + d_lo;
#pragma unroll
  for (int i = 0; i < kRows / 8; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        tile_t[(8 * i + e) * kImgLd + 8 * h] = acc[4 * i + 2 * h + e];
  __syncthreads();

  // 16-byte pieces, 16 a row; D % 8 == 0, so a piece lies wholly inside or
  // wholly past D
  if (wg >= present) return;
  constexpr int kPieces = kImgDTile / 4;
  float* out_n = d_img + (size_t)(s0 + wg) * l * d + d0;
  for (int i = tid % 128; i < l * kPieces; i += 128) {
    const int r = i / kPieces, c = (i % kPieces) * 4;
    if (d0 + c < d)
      *reinterpret_cast<float4*>(out_n + (size_t)r * d + c) =
          *reinterpret_cast<const float4*>(tile + r * kImgLd + c);
  }
}

template <int K>
int launch_d_img(const void* gp, const void* w, const void* q, void* d_img,
                 int n, int l, int d, int f, int o8, cudaStream_t s) {
  using S = ImgShape<K>;
  CUtensorMap w_map, gp_map, q_map;
  const uint64_t w_dims[2] = {(uint64_t)f, (uint64_t)d};
  const uint64_t w_strides[1] = {(uint64_t)f * 2};
  const uint32_t w_box[2] = {64, kImgDTile};
  cudaError_t err = hopper::make_map(
      &w_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w, w_dims, w_strides,
      w_box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return (int)err;
  const uint64_t gp_dims[3] = {(uint64_t)o8, (uint64_t)l, (uint64_t)n};
  const uint64_t gp_strides[2] = {(uint64_t)o8 * 2, (uint64_t)l * o8 * 2};
  const uint32_t gp_box[3] = {kImgDepth, kRows, 1};
  err = hopper::make_map(&gp_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, gp,
                         gp_dims, gp_strides, gp_box,
                         CU_TENSOR_MAP_SWIZZLE_64B);
  if (err != cudaSuccess) return (int)err;
  const uint64_t q_dims[2] = {(uint64_t)f, (uint64_t)n};
  const uint32_t q_box[2] = {(uint32_t)(kImgDepth * K), 1};
  err = hopper::make_map(&q_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, q,
                         q_dims, w_strides, q_box,
                         CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(d_img_kernel<K>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             S::kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((d + kImgDTile - 1) / kImgDTile,
                  (n + kImgSamples - 1) / kImgSamples);
  d_img_kernel<K><<<grid, kImgThreads, S::kSmem, s>>>(
      w_map, gp_map, q_map, static_cast<float*>(d_img), n, l, d, f);
  return (int)cudaGetLastError();
}

int launch_d_img_k(const void* gp, const void* w, const void* q,
                   void* d_img, int n, int l, int d, int f, int k, int o8,
                   cudaStream_t s) {
  switch (k) {
    case 1: return launch_d_img<1>(gp, w, q, d_img, n, l, d, f, o8, s);
    case 2: return launch_d_img<2>(gp, w, q, d_img, n, l, d, f, o8, s);
    case 3: return launch_d_img<3>(gp, w, q, d_img, n, l, d, f, o8, s);
    case 4: return launch_d_img<4>(gp, w, q, d_img, n, l, d, f, o8, s);
    case 5: return launch_d_img<5>(gp, w, q, d_img, n, l, d, f, o8, s);
    case 6: return launch_d_img<6>(gp, w, q, d_img, n, l, d, f, o8, s);
    case 7: return launch_d_img<7>(gp, w, q, d_img, n, l, d, f, o8, s);
  }
  return (int)cudaErrorInvalidValue;
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
  const size_t m0 = (size_t)n * l;
  float s = 0.0f;
  // 8 rows' loads in flight at a time; the sum still runs in l order
  for (int r0 = 0; r0 < l; r0 += 8) {
    float gv[8], yv[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      gv[u] = yv[u] = 0.0f;
      if (o < o_dim && r0 + u < l) {
        const size_t p = (m0 + r0 + u) * o_dim + o;
        gv[u] = g[p];
        yv[u] = out[p];
      }
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (r0 + u < l) {
        float v = 0.0f;
        if (o < o_dim) {
          v = pooled_grad(gv[u], yv[u]);
          s = __fadd_rn(s, v);
        }
        gp[(m0 + r0 + u) * o8 + o] = __float2bfloat16(v);
      }
    }
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

// A block owns a tile of 64 outputs x 64 D rows (32 per warpgroup) of
// d_wq^T = g_pooled_n^T x img_n for every sample n, and walks the samples
// in order, one ring stage each. Thread 0 keeps a ring of `stages` (3 or
// 4) stages full with TMA: the sample's g_pooled [208 l, 64 o] (bf16,
// 128-byte swizzle) and img's two [208 l, 32 d] boxes (64-byte swizzle),
// each a 3D box over [N, L, *] whose rows past L come in as zeros (boxes
// wholly past D are not loaded). Each warpgroup runs wgmma m64n32k16 over
// the 13 row steps, A = g_pooled MN-major and B = its img box MN-major
// (both transposed); the step count is fixed at compile time, since a loop
// of run-time length leaves ptxas to move the accumulators between its
// products and serialise them (C7515). Then, in registers: d_W[d, o k +
// j] += d_wq[d, o] * q[n, o k + j] (k sums per accumulator element, in
// sample order), and d_q's partial sum_d d_wq[d, o] * W[d, o k + j] over
// the thread's D rows, then the quad's lanes by shuffles, then the two
// warpgroups through shared memory, in a fixed order, to parts[D tile, n,
// c]. W's tile stays in shared memory as bf16 pairs of neighbouring D rows
// (a padded row of 64 outputs per pair: no bank conflicts). A sample's
// products and its f32 work run in turn; the ring keeps the next samples'
// loads in flight meanwhile.
constexpr int kDwO = 64;          // outputs per block: wgmma's M
constexpr int kDwD = 64;          // D rows per block (the D tile)
constexpr int kDwHalf = 32;       // D rows per warpgroup: wgmma's N
constexpr int kDwThreads = 256;   // two warpgroups
constexpr int kDwMaxStages = 4;
constexpr int kDwPairLd = kDwO + 8;  // 32-bit words per D pair of W's tile

constexpr int kDwGpBytes = kRows * kDwO * 2;     // g_pooled's box
constexpr int kDwImgBytes = kRows * kDwHalf * 2;  // each of img's two boxes
constexpr int kDwStageBytes = kDwGpBytes + 2 * kDwImgBytes;  // one sample

// 1 KB of alignment slack and 1 KB of barriers, W's tile, the two
// warpgroups' d_q partials: the shared memory besides the ring
constexpr int dw_fixed_bytes(int k) {
  return 2048 + k * (kDwD / 2) * kDwPairLd * 4 + 2 * kDwO * k * 4;
}

__device__ __forceinline__ uint32_t pack_bf16x2(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

template <int K>
__global__ void __launch_bounds__(kDwThreads, 1)
    d_w_kernel(const __grid_constant__ CUtensorMap gp_map,   // [N, L, O8]
               const __grid_constant__ CUtensorMap img_map,  // [N, L, D]
               const bf16* __restrict__ w,    // [D, F]
               const bf16* __restrict__ q,    // [N, F]
               float* __restrict__ d_w,       // [D, F]
               float* __restrict__ parts,     // [D tiles, N, F]
               int nn, int d, int f, int stages) {
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kDwMaxStages;
  unsigned char* ring = smem + 1024;
  // W's tile: word (j * 32 + p) * kDwPairLd + o holds W[d0 + 2 p + e,
  // (o0 + o) K + j] in its half e (0 past D or O)
  uint32_t* wt_s = reinterpret_cast<uint32_t*>(ring + stages * kDwStageBytes);
  float* red_s = reinterpret_cast<float*>(wt_s + K * (kDwD / 2) * kDwPairLd);

  const int o_dim = f / K;
  const int o0 = blockIdx.x * kDwO, c0 = o0 * K;
  const int d0 = blockIdx.y * kDwD;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wg = warp / 4, t = lane % 4;
  const int boxes = min(2, (d - d0 + kDwHalf - 1) / kDwHalf);

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kDwThreads / 32);
    }
    mbar_fence_init();
  }
  const bf16 zero = __float2bfloat16(0.0f);
  for (int i = tid; i < K * (kDwD / 2) * kDwO; i += kDwThreads) {
    const int o = i % kDwO, p = (i / kDwO) % (kDwD / 2);
    const int j = i / (kDwO * (kDwD / 2));
    const int dd = d0 + 2 * p;
    bf16 lo = zero, hi = zero;
    if (o0 + o < o_dim) {
      const size_t c = (size_t)(o0 + o) * K + j;
      if (dd < d) lo = w[(size_t)dd * f + c];
      if (dd + 1 < d) hi = w[(size_t)(dd + 1) * f + c];
    }
    wt_s[(j * (kDwD / 2) + p) * kDwPairLd + o] = pack_bf16x2(lo, hi);
  }
  __syncthreads();

  // sample n into stage n % stages, requested by thread 0 (every thread
  // walks the same path: see mbar_expect_tx)
  const bool leader = tid == 0;
  auto load = [&](int n) {
    const int s = n % stages;
    unsigned char* st = ring + s * kDwStageBytes;
    mbar_expect_tx(&full[s], kDwGpBytes + boxes * kDwImgBytes, leader);
    tma_load_3d(st, &gp_map, &full[s], o0, 0, n, leader);
    for (int i = 0; i < boxes; ++i)
      tma_load_3d(st + kDwGpBytes + i * kDwImgBytes, &img_map, &full[s],
                  d0 + i * kDwHalf, 0, n, leader);
  };
  for (int n = 0; n < stages && n < nn; ++n) load(n);

  // the thread's outputs ol + 8 h (rows g, g + 8 of its warp's 16) and D
  // rows 32 wg + 8 i + 2 t + e of the tile, in acc[4 i + 2 h + e]
  const int ol = (warp % 4) * 16 + lane / 4;
  bool ov[2], dv[4];
#pragma unroll
  for (int h = 0; h < 2; ++h) ov[h] = o0 + ol + 8 * h < o_dim;
#pragma unroll
  for (int i = 0; i < 4; ++i) dv[i] = d0 + kDwHalf * wg + 8 * i < d;
  float sums[16][K];
#pragma unroll
  for (int a = 0; a < 16; ++a)
#pragma unroll
    for (int j = 0; j < K; ++j) sums[a][j] = 0.0f;

  float acc[16];

  for (int n = 0; n < nn; ++n) {
    const int s = n % stages;
    float qv[2][K];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < K; ++j)
        qv[h][j] = ov[h] ? __bfloat162float(
                               q[(size_t)n * f + (size_t)(o0 + ol + 8 * h) *
                                                     K + j])
                         : 0.0f;
#pragma unroll
    for (int a = 0; a < 16; ++a) acc[a] = 0.0f;
    mbar_wait(&full[s], (n / stages) & 1);
    const unsigned char* st = ring + s * kDwStageBytes;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kRows / 16; ++ks) {
      // A: g_pooled MN-major, 16 rows (2 KB) a step, 8-row groups 1 KB
      // apart, one 64-output swizzle atom along M
      const uint64_t da = smem_desc(st + ks * 16 * 128, kDwGpBytes, 1024,
                                    kSwizzle128);
      // B: the warpgroup's img box MN-major, 16 rows (1 KB) a step, 8-row
      // groups 512 B apart, one 32-row swizzle atom along N
      const uint64_t db = smem_desc(st + kDwGpBytes + wg * kDwImgBytes +
                                        ks * 16 * 64,
                                    kDwImgBytes, 512, kSwizzle64);
      Wgmma<kDwHalf>::template ss<1, 1>(acc, da, db);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(acc);
    // release the stage; it is refilled with sample n + stages once all 8
    // warps have released it
    if (lane == 0) mbar_arrive(&empty[s]);
    if (n + stages < nn) {
      mbar_wait(&empty[s], (n / stages) & 1);
      load(n + stages);
    }

    // d_W's sums, in sample order
#pragma unroll
    for (int a = 0; a < 16; ++a)
#pragma unroll
      for (int j = 0; j < K; ++j)
        sums[a][j] = __fadd_rn(sums[a][j],
                               __fmul_rn(acc[a], qv[(a >> 1) & 1][j]));
    // d_q's partial over the thread's D rows, in (i, e) order
    float part[2][K];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < K; ++j) {
        float p = 0.0f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (dv[i]) {
            const uint32_t word =
                wt_s[(j * (kDwD / 2) + wg * (kDwHalf / 2) + 4 * i + t) *
                         kDwPairLd + ol + 8 * h];
            const float2 wv = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&word));
            p = __fadd_rn(p, __fmul_rn(acc[4 * i + 2 * h], wv.x));
            p = __fadd_rn(p, __fmul_rn(acc[4 * i + 2 * h + 1], wv.y));
          }
        }
        part[h][j] = p;
      }
    // ... over the quad's lanes (the warpgroup's 32 D rows), then the two
    // warpgroups, in that order
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < K; ++j) {
        float p = part[h][j];
        p = __fadd_rn(p, __shfl_xor_sync(0xffffffffu, p, 1));
        p = __fadd_rn(p, __shfl_xor_sync(0xffffffffu, p, 2));
        if (t == 0) red_s[(wg * kDwO + ol + 8 * h) * K + j] = p;
      }
    __syncthreads();
    for (int cc = tid; cc < kDwO * K; cc += kDwThreads)
      if (c0 + cc < f)
        parts[((size_t)blockIdx.y * nn + n) * f + c0 + cc] =
            __fadd_rn(red_s[cc], red_s[kDwO * K + cc]);
    __syncthreads();  // red_s is rewritten for the next sample
  }

#pragma unroll
  for (int a = 0; a < 16; ++a) {
    const int i = a >> 2, h = (a >> 1) & 1, e = a & 1;
    if (ov[h] && dv[i]) {
      const int row = d0 + kDwHalf * wg + 8 * i + 2 * t + e;
      float* dst = d_w + (size_t)row * f + (size_t)(o0 + ol + 8 * h) * K;
#pragma unroll
      for (int j = 0; j < K; ++j) dst[j] = sums[a][j];
    }
  }
}

template <int K>
int launch_d_w(const void* gp, const void* img, const void* w,
               const void* q, void* d_w, void* parts, int n, int l, int d,
               int f, int o8, cudaStream_t s) {
  CUtensorMap gp_map, img_map;
  const uint64_t gp_dims[3] = {(uint64_t)o8, (uint64_t)l, (uint64_t)n};
  const uint64_t gp_strides[2] = {(uint64_t)o8 * 2, (uint64_t)l * o8 * 2};
  const uint32_t gp_box[3] = {kDwO, kRows, 1};
  cudaError_t err = hopper::make_map(
      &gp_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, gp, gp_dims, gp_strides,
      gp_box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return (int)err;
  const uint64_t img_dims[3] = {(uint64_t)d, (uint64_t)l, (uint64_t)n};
  const uint64_t img_strides[2] = {(uint64_t)d * 2, (uint64_t)l * d * 2};
  const uint32_t img_box[3] = {kDwHalf, kRows, 1};
  err = hopper::make_map(&img_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, img,
                         img_dims, img_strides, img_box,
                         CU_TENSOR_MAP_SWIZZLE_64B);
  if (err != cudaSuccess) return (int)err;
  // as many stages as fit, at most 4 (4 at k = 1, 3 above)
  int stages = (kMaxSmem - dw_fixed_bytes(K)) / kDwStageBytes;
  stages = stages < kDwMaxStages ? stages : kDwMaxStages;
  const int smem = dw_fixed_bytes(K) + stages * kDwStageBytes;
  err = cudaFuncSetAttribute(d_w_kernel<K>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((f / K + kDwO - 1) / kDwO, (d + kDwD - 1) / kDwD);
  d_w_kernel<K><<<grid, kDwThreads, smem, s>>>(
      gp_map, img_map, static_cast<const bf16*>(w),
      static_cast<const bf16*>(q), static_cast<float*>(d_w),
      static_cast<float*>(parts), n, d, f, stages);
  return (int)cudaGetLastError();
}

int launch_d_w_k(const void* gp, const void* img, const void* w,
                 const void* q, void* d_w, void* parts, int n, int l, int d,
                 int f, int k, int o8, cudaStream_t s) {
  switch (k) {
    case 1: return launch_d_w<1>(gp, img, w, q, d_w, parts, n, l, d, f, o8, s);
    case 2: return launch_d_w<2>(gp, img, w, q, d_w, parts, n, l, d, f, o8, s);
    case 3: return launch_d_w<3>(gp, img, w, q, d_w, parts, n, l, d, f, o8, s);
    case 4: return launch_d_w<4>(gp, img, w, q, d_w, parts, n, l, d, f, o8, s);
    case 5: return launch_d_w<5>(gp, img, w, q, d_w, parts, n, l, d, f, o8, s);
    case 6: return launch_d_w<6>(gp, img, w, q, d_w, parts, n, l, d, f, o8, s);
    case 7: return launch_d_w<7>(gp, img, w, q, d_w, parts, n, l, d, f, o8, s);
  }
  return (int)cudaErrorInvalidValue;
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
// K6's grid-flat L2 over the forward's output z [N, L, O], from the sums of
// squares its epilogue wrote: out = bf16(z * (1 / max(||z[n]||, eps)))
// ---------------------------------------------------------------------------
constexpr int kNormItems = 8;                      // elements per thread
constexpr int kNormChunk = kThreads * kNormItems;  // elements per block

// the sample's norm from its O tiles' sums, in tile order (no atomics:
// reruns give the same bits), then the scaled bf16 output; 16-byte loads
// where a sample's grid is a whole number of them
__global__ void __launch_bounds__(kThreads)
    grid_scale_kernel(const float* __restrict__ z,    // [N, L*O]
                      const float* __restrict__ ssq,  // [N, tiles]
                      bf16* __restrict__ out,         // [N, L*O]
                      int grid_size, int tiles, float eps) {
  __shared__ float inv_s;
  const int n = blockIdx.y;
  if (threadIdx.x == 0) {
    const float* part = ssq + (size_t)n * tiles;
    float t = part[0];
    for (int i = 1; i < tiles; ++i) t = __fadd_rn(t, part[i]);
    inv_s = __fdiv_rn(1.0f, fmaxf(sqrtf(t), eps));
  }
  __syncthreads();
  const float inv = inv_s;
  const float* zn = z + (size_t)n * grid_size;
  bf16* on = out + (size_t)n * grid_size;
  if (grid_size % 4 == 0) {
    constexpr int kVecs = kNormItems / 4;
    const int base = blockIdx.x * kNormChunk + 4 * threadIdx.x;
    float4 x[kVecs];
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      const int e = base + i * 4 * kThreads;
      if (e < grid_size) x[i] = *reinterpret_cast<const float4*>(zn + e);
    }
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      const int e = base + i * 4 * kThreads;
      if (e < grid_size) {
        __nv_bfloat162 lo = __floats2bfloat162_rn(__fmul_rn(x[i].x, inv),
                                                  __fmul_rn(x[i].y, inv));
        __nv_bfloat162 hi = __floats2bfloat162_rn(__fmul_rn(x[i].z, inv),
                                                  __fmul_rn(x[i].w, inv));
        uint2 v;
        v.x = *reinterpret_cast<uint32_t*>(&lo);
        v.y = *reinterpret_cast<uint32_t*>(&hi);
        *reinterpret_cast<uint2*>(on + e) = v;
      }
    }
    return;
  }
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
  return launch_fwd_k<false>(img, w, b, q, out, nullptr, n, l, d, f, k,
                             reinterpret_cast<cudaStream_t>(stream));
}

// the O tile of K6's forward: ssq holds ceil(O / pooled_fusion_o_tile())
// sums a sample
int pooled_fusion_o_tile(void) { return kFwdOTile; }

// K6: the forward into z (f32 scratch [N, L, O]) with each O tile's sums
// of squares into ssq (scratch [N, ceil(O / pooled_fusion_o_tile())]),
// then the grid-flat L2 into out (bf16 [N, L, O])
int pooled_fusion_wq_grid(const void* img, const void* w, const void* b,
                          const void* q, void* z, void* ssq, void* out, int n,
                          int l, int d, int f, int k, float eps,
                          void* stream) {
  if (!dims_ok(n, l, d, f, k) || (size_t)l * (f / k) >= (1u << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int err =
      launch_fwd_k<true>(img, w, b, q, z, ssq, n, l, d, f, k, s);
  if (err != 0) return err;
  const int grid_size = l * (f / k);
  const dim3 grid((grid_size + kNormChunk - 1) / kNormChunk, n);
  grid_scale_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(z), static_cast<const float*>(ssq),
      static_cast<bf16*>(out), grid_size,
      (f / k + kFwdOTile - 1) / kFwdOTile, eps);
  return (int)cudaGetLastError();
}

// g_pooled once, for both d_img and d_W: bf16 gp [N, L, O8] (0 past O)
// and d_bq [N, O]
int pooled_fusion_g_pooled(const void* g, const void* out, void* gp,
                           void* d_bq, int n, int l, int d, int f, int k,
                           void* stream) {
  if (!dims_ok(n, l, d, f, k)) return (int)cudaErrorInvalidValue;
  const int o_dim = f / k, o8 = (o_dim + 7) / 8 * 8;
  g_pooled_kernel<<<dim3((o8 + kThreads - 1) / kThreads, n), kThreads, 0,
                    reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const float*>(out),
      static_cast<bf16*>(gp), static_cast<float*>(d_bq), l, o_dim, o8);
  return (int)cudaGetLastError();
}

// d_img (f32 [N, L, D]) from pooled_fusion_g_pooled's gp
int pooled_fusion_d_img(const void* gp, const void* w, const void* q,
                        void* d_img, int n, int l, int d, int f, int k,
                        void* stream) {
  if (!dims_ok(n, l, d, f, k)) return (int)cudaErrorInvalidValue;
  return launch_d_img_k(gp, w, q, d_img, n, l, d, f, k,
                        (f / k + 7) / 8 * 8,
                        reinterpret_cast<cudaStream_t>(stream));
}

// d_W, d_b and d_q from pooled_fusion_g_pooled's gp and d_bq: three
// launches (d_b; d_W and d_q's partials; d_q's reduction)
int pooled_fusion_d_w(const void* gp, const void* d_bq, const void* img,
                      const void* w, const void* b, const void* q, void* d_w,
                      void* d_b, void* d_q, void* parts, int n, int l, int d,
                      int f, int k, void* stream) {
  if (!dims_ok(n, l, d, f, k)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int o8 = (f / k + 7) / 8 * 8;
  d_b_kernel<<<(f + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      static_cast<const float*>(d_bq), static_cast<const bf16*>(q),
      static_cast<float*>(d_b), n, f, k);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int code = launch_d_w_k(gp, img, w, q, d_w, parts, n, l, d, f, k,
                                o8, s);
  if (code != 0) return code;
  const int tiles = (d + kDwD - 1) / kDwD;
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
