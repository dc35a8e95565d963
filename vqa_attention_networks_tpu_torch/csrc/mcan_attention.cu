// MCAN's masked multi-head attention, bf16 inference, hand-written for
// Hopper (sm_90a) (ops/mcan_attention.py). With q [N, Lq, d], k and v
// [N, Lk, d] (bf16, the projections' outputs as they are), heads of 64
// (head h is columns 64 h .. 64 h + 63) and the key mask [N, Lk] (true at
// padding):
//
//   s[i, j]  = (q_h[i] . k_h[j]) / 8              f32 (the scale is exact)
//   s[i, j]  = -1e9 where mask[n, j]               mcan-vqa's masked_fill
//   e[i, j]  = exp(s[i, j] - max_j s[i, j])         f32 softmax, one pass
//   out_h[i] = bf16(sum_j bf16(e[i, j]) v_h[j] / sum_j e[i, j])  f32 sums
//
// out is [N, Lq, d], heads side by side: the merge projection's input.
// A row whose keys are all masked is the mean of its Lk values, as the
// composed form's softmax over equal scores gives.
//
// It replaces no TPU kernel: the JAX package has no MCAN. Composed
// (MCAN._mha's torch ops), a layer splits and re-joins the heads with
// copies, writes a bf16 score map ([256, 16, 196, 196] is 315 MB), and
// reads and rewrites it in masked_fill and softmax before the PV product
// reads it again: ~20 ms of MCAN-large's 39.7 ms batch.
//
// Bound: bytes. A call reads q, k, v and the mask once and writes out once
// (4 x 103 MB for the image self-attention at N = 256, ~0.12 ms at 3.35
// TB/s); its products are ~1/10 of that in tensor-core time.
//
// Design. One block of one warpgroup (128 threads) a (sample, head): Lk is
// at most 256, so the head's whole K and V fit in shared memory (kKeys
// rows of 128 B each, 53 KB at kKeys = 208), loaded once by TMA from the
// strided [N, L, d] tensors (128-byte swizzle; rows past Lk come in as
// zeros), and the block walks the Q tiles of 64 rows. Per tile: S = Q K^T
// by wgmma m64n<kKeys>k16 into f32 registers, the mask (each thread's
// columns as bits in registers) and the softmax over the whole row in
// registers (a row lies in the 4 lanes of a quad: two shuffles), P
// rounded to bf16 in place as the A operand of O = P V (wgmma m64n64k16,
// V MN-major in shared memory), O divided by the f32 row sum into shared
// memory and stored by one TMA store (rows past Lq are not written). A Q
// tile is loaded as soon as the S product of the tile before it in its
// stage is done (two stages where shared memory allows), under the
// softmax and the PV product. Padding keys (kKeys > Lk) score -inf and add
// exactly 0. At 70 KB of shared memory and at most 168 registers a thread
// (151 at kKeys = 208), three blocks share an SM, so one block's loads run
// under another's products. Nothing is summed across blocks: reruns give
// the same bits.
//
// On an H100 at N = 256 (device time, PERF.md has the runs): the grid's
// self-attention 0.20 ms against its 0.123 ms bound, the guided 0.083
// against 0.066, the words' 0.020 against 0.009. The TMA store of O took
// the guided from 0.16 ms (16 four-byte stores a thread a tile); at the
// grid, the softmax's instructions (~9 a score) and each warpgroup's
// serial S -> softmax -> PV chain are what is left above the bound.
//
// The C interface takes raw device pointers and the stream; the launch is
// followed by cudaGetLastError(), whose code is returned (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

typedef __nv_bfloat162 bf16x2;

constexpr int kHead = 64;                 // head width: a 128-byte row
constexpr int kRowBytes = kHead * 2;
constexpr int kQRows = 64;                // a Q tile: wgmma's M
constexpr int kThreads = 128;             // one warpgroup
constexpr int kQBytes = kQRows * kRowBytes;
// the softmax works on unscaled scores q . k: 1/8 is a power of two, so
// (s - max) / 8 is the scaled difference exactly, and a masked key's -1e9
// after the scale is -8e9 before it (both exact in f32)
constexpr float kMaskFillUnscaled = -8e9f;
constexpr float kScaleLog2e = 0.125f * 1.4426950408889634f;  // log2(e) / 8

template <int kKeys>
struct Tile {
  static constexpr int kKVBytes = kKeys * kRowBytes;
  // Q tiles in flight: two where shared memory leaves room for them
  static constexpr int kQStages = kKeys <= 128 ? 2 : 1;
  // 1 KB of alignment slack, 1 KB of barriers and the mask, the Q ring,
  // the O tile, K and V
  static constexpr int kSmem =
      2048 + (kQStages + 1) * kQBytes + 2 * kKVBytes;
  static constexpr int kBlocksPerSM = kKeys <= 208 ? 3 : 2;
  // the key columns a thread holds: 8 i + 2 t + b, bit 2 i + b of a word
  static constexpr int kColumns = kKeys / 4;
  static constexpr int kWords = (kColumns + 31) / 32;
};

__device__ __forceinline__ uint32_t as_u32(bf16x2 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 2^x by the special-function unit; a result below 2^-126 flushes to 0,
// which moves a weight of a row whose sum is at least 1 by less than that
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int kKeys>
__global__ void __launch_bounds__(kThreads, Tile<kKeys>::kBlocksPerSM)
    mcan_attention_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const __grid_constant__ CUtensorMap o_map,
                          const unsigned char* __restrict__ mask,  // [N, Lk]
                          int lq, int lk, int heads) {
  using namespace hopper;
  using T = Tile<kKeys>;
  constexpr int kStages = T::kQStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem);  // [kStages]
  uint64_t* kv_full = q_full + kStages;                    // K, V
  unsigned char* masked_s = smem + 64;                     // [kKeys]
  unsigned char* q_s = smem + 1024;                        // [kStages]
  unsigned char* o_s = q_s + kStages * kQBytes;
  unsigned char* k_s = o_s + kQBytes;
  unsigned char* v_s = k_s + T::kKVBytes;

  const int n = blockIdx.x / heads, h = blockIdx.x % heads;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int tiles = (lq + kQRows - 1) / kQRows;
  // every thread walks the loads' path; thread 0 issues them (see
  // mbar_expect_tx)
  const bool leader = tid == 0;

  if (leader) {
    for (int i = 0; i < kStages + 2; ++i) mbar_init(&q_full[i], 1);
    mbar_fence_init();
  }
  __syncthreads();
  for (int i = 0; i < kStages && i < tiles; ++i) {
    mbar_expect_tx(&q_full[i], kQBytes, leader);
    tma_load_3d(q_s + i * kQBytes, &q_map, &q_full[i], h * kHead,
                i * kQRows, n, leader);
  }
  mbar_expect_tx(&kv_full[0], T::kKVBytes, leader);
  tma_load_3d(k_s, &k_map, &kv_full[0], h * kHead, 0, n, leader);
  mbar_expect_tx(&kv_full[1], T::kKVBytes, leader);
  tma_load_3d(v_s, &v_map, &kv_full[1], h * kHead, 0, n, leader);
  for (int j = tid; j < lk; j += kThreads)
    masked_s[j] = mask[(size_t)n * lk + j] != 0;
  __syncthreads();
  // the thread's columns: kept (a real, unmasked key) and masked bits;
  // neither is a padding key past Lk
  uint32_t kept[T::kWords], masked[T::kWords];
#pragma unroll
  for (int w = 0; w < T::kWords; ++w) kept[w] = masked[w] = 0u;
#pragma unroll
  for (int c = 0; c < T::kColumns; ++c) {
    const int j = 8 * (c / 2) + 2 * t + (c & 1);
    if (j < lk) {
      const uint32_t m = masked_s[j];
      kept[c / 32] |= (1u - m) << (c % 32);
      masked[c / 32] |= m << (c % 32);
    }
  }

  for (int tile = 0; tile < tiles; ++tile) {
    // the words are opaque to the compiler from one tile to the next, so
    // that it keeps them as they are: hoisted out of the loop, what it
    // derives from them would hold a register for each column
#pragma unroll
    for (int w = 0; w < T::kWords; ++w)
      asm volatile("" : "+r"(kept[w]), "+r"(masked[w]));
    const int stage = tile % kStages;
    unsigned char* qt = q_s + stage * kQBytes;
    // S = Q K^T, unscaled: the thread holds rows 16 warp + g (+ 8) and
    // columns 8 i + 2 t (+ 1) in s[4 i + e] (hopper.cuh)
    float s[kKeys / 2];
#pragma unroll
    for (int i = 0; i < kKeys / 2; ++i) s[i] = 0.0f;
    mbar_wait(&q_full[stage], (tile / kStages) & 1);
    mbar_wait(&kv_full[0], 0);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kHead / 16; ++ks) {
      // both K-major: 64 Q rows / kKeys K rows of 128 B, 32 B a step,
      // 8-row groups 1 KB apart
      const uint64_t da = smem_desc(qt + ks * 32, 16, 1024, kSwizzle128);
      const uint64_t db = smem_desc(k_s + ks * 32, 16, 1024, kSwizzle128);
      Wgmma<kKeys>::template ss<0>(s, da, db);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(s);

    // the stage is free once all four warps are past the product, and the
    // O tile once the last tile's store has read it: the stage takes the
    // tile kStages ahead, which comes in under this one's softmax and PV
    // product
    bulk_wait_read<0>();
    __syncthreads();
    if (tile + kStages < tiles) {
      mbar_expect_tx(&q_full[stage], kQBytes, leader);
      tma_load_3d(qt, &q_map, &q_full[stage], h * kHead,
                  (tile + kStages) * kQRows, n, leader);
    }

    // the mask, the row max over the quad
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < kKeys / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 2 * i + (e & 1);
        const float x = (kept[c / 32] >> (c % 32)) & 1u ? s[4 * i + e]
                        : (masked[c / 32] >> (c % 32)) & 1u
                            ? kMaskFillUnscaled
                            : -INFINITY;
        s[4 * i + e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }

    // P = exp((s - max) / 8), summed in f32 and rounded to bf16 pairs,
    // p[2 i + r] for row half r: the m16n8k16 A fragment of keys
    // 16 ks .. 16 ks + 15 is p[4 ks .. 4 ks + 3]. A row whose keys are all
    // masked has s = max at each: p = 1 there.
    uint32_t p[kKeys / 4];
    float sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < kKeys / 8; ++i) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float e0 = exp2_ftz((s[4 * i + 2 * r] - mx[r]) * kScaleLog2e);
        const float e1 =
            exp2_ftz((s[4 * i + 2 * r + 1] - mx[r]) * kScaleLog2e);
        sum[r] += e0 + e1;
        p[2 * i + r] = as_u32(__floats2bfloat162_rn(e0, e1));
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
    }

    // O = P V: V MN-major, 16 key rows (2 KB) a step, 8-row groups 1 KB
    // apart, one 64-column swizzle atom
    float o[kHead / 2];
#pragma unroll
    for (int i = 0; i < kHead / 2; ++i) o[i] = 0.0f;
    mbar_wait(&kv_full[1], 0);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kKeys / 16; ++ks) {
      const uint32_t a[4] = {p[4 * ks], p[4 * ks + 1], p[4 * ks + 2],
                             p[4 * ks + 3]};
      const uint64_t db = smem_desc(v_s + ks * 16 * kRowBytes, T::kKVBytes,
                                    1024, kSwizzle128);
      WgmmaRS<kHead>::rs<1>(o, a, db);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(o);

    // O / sum in bf16 into the O tile as TMA's 128-byte swizzle lays it
    // out (the 16-byte chunk i of row r at chunk i ^ (r % 8): no bank
    // conflicts), then one TMA store of the tile (rows past Lq are not
    // written)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = warp * 16 + g + 8 * r;
#pragma unroll
      for (int i = 0; i < kHead / 8; ++i)
        *reinterpret_cast<bf16x2*>(o_s + row * kRowBytes +
                                   ((i ^ (row & 7)) << 4) + 4 * t) =
            __floats2bfloat162_rn(o[4 * i + 2 * r] / sum[r],
                                  o[4 * i + 2 * r + 1] / sum[r]);
    }
    fence_proxy_async();
    __syncthreads();
    tma_store_3d(&o_map, o_s, h * kHead, tile * kQRows, n, leader);
    bulk_commit();
  }
  bulk_wait_read<0>();  // shared memory stays the block's until then
}

template <int kKeys>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const unsigned char* mask, void* out, int n, int lq,
                   int lk, int d, cudaStream_t s) {
  // [N, L, d] as TMA sees it, innermost first: d, L, N
  CUtensorMap q_map, k_map, v_map, o_map;
  const uint64_t q_dims[3] = {(uint64_t)d, (uint64_t)lq, (uint64_t)n};
  const uint64_t q_strides[2] = {(uint64_t)d * 2, (uint64_t)lq * d * 2};
  const uint32_t q_box[3] = {kHead, kQRows, 1};
  cudaError_t err = hopper::make_map(&q_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                                     3, q, q_dims, q_strides, q_box,
                                     CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  err = hopper::make_map(&o_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, out,
                         q_dims, q_strides, q_box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  const uint64_t kv_dims[3] = {(uint64_t)d, (uint64_t)lk, (uint64_t)n};
  const uint64_t kv_strides[2] = {(uint64_t)d * 2, (uint64_t)lk * d * 2};
  const uint32_t kv_box[3] = {kHead, (uint32_t)kKeys, 1};
  err = hopper::make_map(&k_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, k,
                         kv_dims, kv_strides, kv_box,
                         CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  err = hopper::make_map(&v_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, v,
                         kv_dims, kv_strides, kv_box,
                         CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(mcan_attention_kernel<kKeys>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Tile<kKeys>::kSmem);
  if (err != cudaSuccess) return err;
  const int heads = d / kHead;
  mcan_attention_kernel<kKeys>
      <<<(unsigned)(n * heads), kThreads, Tile<kKeys>::kSmem, s>>>(
          q_map, k_map, v_map, o_map, mask, lq, lk, heads);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q [N, Lq, d], k, v [N, Lk, d], out [N, Lq, d]: bf16, contiguous, 16-byte
// aligned; mask [N, Lk] bool (one byte each, true at padding); d a
// multiple of 64; key_tile one of 16, 32, 64, 128, 208, 256, at least Lk.
// 0, or the CUDA error of the launch.
int mcan_attention_launch(const void* q, const void* k, const void* v,
                          const void* mask, void* out, int n, int lq, int lk,
                          int d, int key_tile, void* stream) {
  if (n < 0 || lq < 1 || lk < 1 || lk > key_tile || d < kHead ||
      d % kHead || (long long)n * (d / kHead) >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const unsigned char* m = static_cast<const unsigned char*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (key_tile) {
    case 16: return (int)launch<16>(q, k, v, m, out, n, lq, lk, d, s);
    case 32: return (int)launch<32>(q, k, v, m, out, n, lq, lk, d, s);
    case 64: return (int)launch<64>(q, k, v, m, out, n, lq, lk, d, s);
    case 128: return (int)launch<128>(q, k, v, m, out, n, lq, lk, d, s);
    case 208: return (int)launch<208>(q, k, v, m, out, n, lq, lk, d, s);
    case 256: return (int)launch<256>(q, k, v, m, out, n, lq, lk, d, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* mcan_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
