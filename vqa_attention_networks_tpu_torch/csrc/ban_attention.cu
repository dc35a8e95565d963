// BAN's bilinear attention map, bf16 inference, hand-written for Hopper
// (sm_90a) (ops/ban_attention.py). With av [N, L, K] and aq [N, T, K] (bf16,
// BiAttention's two ReLU projections as they are), h [G, K] (f32, the
// weight-normalised h_mat) and the grid mask [N, L] (true where a cell's
// features are all 0):
//
//   a[g, j, c] = bf16(h[g, c] * aq[n, j, c])          the scaled words
//   s[g, i, j] = sum_c av[n, i, c] a[g, j, c]          f32
//   s[g, i, j] = -inf where mask[n, i]
//   p[n, g, i, j] = bf16(exp(s - max) / sum)           over all (i, j) of g
//
// in f32 throughout, rounded once at the end. P is [N, G, L, T]: ban-vqa's
// BiAttention output (logits.view(-1, glimpse, v_num * q_num) softmaxed).
// h_bias shifts each glimpse's scores by one constant, which the softmax
// cancels: the kernel does not take it. A sample whose cells are all
// masked gives NaN, as the composed softmax over -inf does.
//
// It replaces no TPU kernel: the JAX package has no BAN. Composed as
// ban-vqa writes it (einsum('xhyk,bvk,bqk->bhvq')), h (x) av is a
// [N, G, L, K] tensor, 3.08 GB in bf16 at N = 256, written and read again.
//
// Bound: bytes. A call reads av (385 MB at N = 256, L = 196, K = 3,840),
// aq (27.5 MB), h and the mask once and writes P (11.2 MB): 0.127 ms at
// 3.35 TB/s. The products, 2 N G T L K = 43.2 GFLOP, take 0.044 ms at the
// bf16 peak.
//
// Design. One block a sample, two warpgroups (256 threads), or three (384)
// where the rows or the words need them. The block computes S^T = A av^T,
// with A the sample's G T scaled word rows (at most 128, or 192 with three:
// warpgroup w holds rows 64 w .. 64 w + 63) and av's L cells as the N side
// of one wgmma m64n200k16 (L <= 200; cells past L come in as zeros). Two
// warpgroups take T <= 16 (BAN-8's 8 x 14), three T <= 24 (the port's
// default widths, 6 glimpses of 22 words: 132 rows). K is walked in tiles
// of 64 (128 B a row): a ring of kStages stages, each the av tile (200 x 64,
// TMA, 128-byte swizzle), the aq tile (16 or 24 x 64) and the h tile (8 x 64
// f32), filled by thread 0's TMA loads on one mbarrier.
// Each warpgroup scales its own 64 rows of A from the stage's aq and h
// tiles into one of two A buffers (the same 128-byte swizzle, by hand),
// then issues the tile's four products; it waits for the tile before's
// (wgmma_wait<1>) and the block then frees that tile's stage for the tile
// kStages ahead. So the av loads, the scaling and the products of three
// tiles overlap. At the end each thread holds 2 rows x 50 cells of S^T in
// f32; the masked joint softmax takes each row's max and sum over its quad
// and each glimpse's over its T rows through shared memory; P is staged in
// shared memory in its [G, L, T] order and written out with 16-byte stores
// (a sample's P is one contiguous block). Nothing is summed across blocks:
// reruns give the same bits.
//
// The C interface takes raw device pointers and the stream; the launch is
// followed by cudaGetLastError(), whose code is returned (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kCells = 200;   // wgmma's N: cells of a sample, padded
constexpr int kKTile = 64;    // K a stage: one 128-byte row
constexpr int kRowBytes = kKTile * 2;
constexpr int kGBox = 8;      // h rows a stage (G <= 8)
constexpr int kStages = 4;
constexpr int kAvBytes = kCells * kRowBytes;      // 25,600: 25 KB, aligned
constexpr int kHBytes = kGBox * kKTile * 4;       // 2,048
// 2 KB of barriers (at 0), the mask (at 64), the row maxima (at 512) and
// sums
constexpr int kHeader = 2048;
constexpr float kLog2e = 1.4426950408889634f;

// the block's shape by its warpgroups: two take G T <= 128 rows of T <= 16
// words, three G T <= 192 of T <= 24
template <int kWarpgroups>
struct Tile {
  static constexpr int kRows = 64 * kWarpgroups;  // A rows (G T)
  static constexpr int kThreads = 128 * kWarpgroups;
  static constexpr int kTBox = kWarpgroups == 2 ? 16 : 24;  // aq rows a stage
  static constexpr int kAqBytes = kTBox * kRowBytes;        // 2 or 3 KB
  static constexpr int kStageBytes = kAvBytes + kAqBytes + kHBytes;
  static constexpr int kABytes = kRows * kRowBytes;  // an A buffer
  // 1 KB of alignment slack, the header, the ring, two A buffers
  static constexpr int kSmem =
      1024 + kHeader + kStages * kStageBytes + 2 * kABytes;
  static_assert(kStageBytes % 1024 == 0, "stages keep 1 KB alignment");
  static_assert(512 + 2 * 4 * kRows <= kHeader, "the header holds the rows");
  static_assert(kSmem <= 227 * 1024, "one block an SM");
};

__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int kWarpgroups>
__global__ void __launch_bounds__(Tile<kWarpgroups>::kThreads, 1)
    ban_attention_kernel(const __grid_constant__ CUtensorMap av_map,
                         const __grid_constant__ CUtensorMap aq_map,
                         const __grid_constant__ CUtensorMap h_map,
                         const unsigned char* __restrict__ mask,  // [N, L]
                         __nv_bfloat16* __restrict__ out,  // [N, G, L, T]
                         int l, int t, int g, int k) {
  using namespace hopper;
  using Shape = Tile<kWarpgroups>;
  constexpr int kThreads = Shape::kThreads, kStageBytes = Shape::kStageBytes;
  constexpr int kAqBytes = Shape::kAqBytes, kABytes = Shape::kABytes;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);       // [kStages]
  unsigned char* masked_s = smem + 64;                       // [kCells]
  float* row_max = reinterpret_cast<float*>(smem + 512);    // [kRows]
  float* row_sum = row_max + Shape::kRows;                   // [kRows]
  unsigned char* ring = smem + kHeader;
  unsigned char* a_buf = ring + kStages * kStageBytes;      // [2]

  const int n = blockIdx.x;
  const int tid = threadIdx.x, wg = tid / 128, tw = tid % 128;
  const int warp = tw / 32, lane = tid % 32, gq = lane / 4, tq = lane % 4;
  const int rows = g * t;
  const int tiles = k / kKTile;
  const bool leader = tid == 0;

  if (leader) {
    for (int i = 0; i < kStages; ++i) mbar_init(&full[i], 1);
    mbar_fence_init();
  }
  for (int i = tid; i < kCells; i += kThreads)
    masked_s[i] = i < l ? mask[(size_t)n * l + i] != 0 : 1;
  __syncthreads();

  auto load = [&](int tile) {
    unsigned char* st = ring + (tile % kStages) * kStageBytes;
    uint64_t* bar = &full[tile % kStages];
    mbar_expect_tx(bar, kStageBytes, leader);
    tma_load_3d(st, &av_map, bar, tile * kKTile, 0, n, leader);
    tma_load_3d(st + kAvBytes, &aq_map, bar, tile * kKTile, 0, n, leader);
    tma_load_2d(st + kAvBytes + kAqBytes, &h_map, bar, tile * kKTile, 0,
                leader);
  };
  for (int i = 0; i < kStages && i < tiles; ++i) load(i);

  float acc[kCells / 2];
#pragma unroll
  for (int i = 0; i < kCells / 2; ++i) acc[i] = 0.0f;

  for (int tile = 0; tile < tiles; ++tile) {
    const unsigned char* st = ring + (tile % kStages) * kStageBytes;
    const unsigned char* aq_s = st + kAvBytes;
    const float* h_s = reinterpret_cast<const float*>(st + kAvBytes +
                                                      kAqBytes);
    unsigned char* a_s = a_buf + (tile & 1) * kABytes + wg * 64 * kRowBytes;
    mbar_wait(&full[tile % kStages], (tile / kStages) & 1);
    // the warpgroup's 64 rows of A: row r = glimpse r / T, word r % T; 8
    // chunks of 8 values a row, 4 a thread, chunk c of row r at chunk
    // c ^ (r % 8) (TMA's 128-byte swizzle, which the descriptor reads)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int item = tw + 128 * q;
      const int r = item / 8, c = item % 8;
      const int row = wg * 64 + r;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (row < rows) {
        const int gl = row / t, j = row % t;
        const uint4 x = *reinterpret_cast<const uint4*>(
            aq_s + j * kRowBytes + c * 16);
        const float4 h0 = *reinterpret_cast<const float4*>(
            h_s + gl * kKTile + c * 8);
        const float4 h1 = *reinterpret_cast<const float4*>(
            h_s + gl * kKTile + c * 8 + 4);
        const __nv_bfloat162* xb = reinterpret_cast<const __nv_bfloat162*>(
            &x);
        const float2 x0 = __bfloat1622float2(xb[0]);
        const float2 x1 = __bfloat1622float2(xb[1]);
        const float2 x2 = __bfloat1622float2(xb[2]);
        const float2 x3 = __bfloat1622float2(xb[3]);
        v.x = pack_bf16(h0.x * x0.x, h0.y * x0.y);
        v.y = pack_bf16(h0.z * x1.x, h0.w * x1.y);
        v.z = pack_bf16(h1.x * x2.x, h1.y * x2.y);
        v.w = pack_bf16(h1.z * x3.x, h1.w * x3.y);
      }
      *reinterpret_cast<uint4*>(a_s + r * kRowBytes + ((c ^ (r & 7)) << 4)) =
          v;
    }
    fence_proxy_async();
    named_sync(1 + wg, 128);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kKTile / 16; ++ks) {
      // both K-major: 64 A rows / 200 cells of 128 B, 32 B a step, 8-row
      // groups 1 KB apart
      const uint64_t da = smem_desc(a_s + ks * 32, 16, 1024, kSwizzle128);
      const uint64_t db = smem_desc(st + ks * 32, 16, 1024, kSwizzle128);
      Wgmma<kCells>::template ss<0>(acc, da, db);
    }
    wgmma_commit();
    // the tile before is done in this warpgroup; once in both, its stage
    // and its A buffer are free: the stage takes the tile kStages ahead
    wgmma_wait<1>();
    __syncthreads();
    if (tile >= 1 && tile - 1 + kStages < tiles) load(tile - 1 + kStages);
  }
  wgmma_wait<0>();
  fence_operands(acc);

  // the thread's rows: 64 wg + 16 warp + gq (+ 8); its cells 8 i + 2 tq
  // (+ 1) in acc[4 i + e], row half e / 2
  const int row0 = wg * 64 + warp * 16 + gq;
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < kCells / 8; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int cell = 8 * i + 2 * tq + (e & 1);
      const float x = masked_s[cell] ? -INFINITY : acc[4 * i + e];
      acc[4 * i + e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    if (tq == 0) row_max[row0 + 8 * r] = mx[r];
  }
  __syncthreads();
  // each glimpse's max over its T rows; rows past G T are not written
  float gmax[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    gmax[r] = -INFINITY;
    if (row < rows) {
      const int first = (row / t) * t;
      for (int j = 0; j < t; ++j) gmax[r] = fmaxf(gmax[r], row_max[first + j]);
    }
  }
#pragma unroll
  for (int i = 0; i < kCells / 8; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      const float x = exp2_ftz((acc[4 * i + e] - gmax[r]) * kLog2e);
      acc[4 * i + e] = x;
      sum[r] += x;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
    if (tq == 0) row_sum[row0 + 8 * r] = sum[r];
  }
  __syncthreads();
  // P into the ring, now idle, in [G, L, T] order
  __nv_bfloat16* p_s = reinterpret_cast<__nv_bfloat16*>(ring);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= rows) continue;
    const int gl = row / t, j = row % t;
    float total = 0.0f;
    for (int jj = 0; jj < t; ++jj) total += row_sum[gl * t + jj];
    const float inv = 1.0f / total;
#pragma unroll
    for (int i = 0; i < kCells / 8; ++i) {
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int cell = 8 * i + 2 * tq + b;
        if (cell < l)
          p_s[((size_t)gl * l + cell) * t + j] =
              __float2bfloat16_rn(acc[4 * i + 2 * r + b] * inv);
      }
    }
  }
  __syncthreads();
  const size_t elems = (size_t)g * l * t;
  __nv_bfloat16* dst = out + (size_t)n * elems;
  if (elems % 8 == 0) {
    const uint4* src4 = reinterpret_cast<const uint4*>(p_s);
    uint4* dst4 = reinterpret_cast<uint4*>(dst);
    for (size_t i = tid; i < elems / 8; i += kThreads) dst4[i] = src4[i];
  } else {
    for (size_t i = tid; i < elems; i += kThreads) dst[i] = p_s[i];
  }
}

// one launch at kWarpgroups: the tensor maps (aq's box Tile's kTBox rows),
// the shared memory, the grid; 0 or the CUDA error
template <int kWarpgroups>
int launch(const void* av, const void* aq, const void* h, const void* mask,
           void* out, int n, int l, int t, int g, int k, void* stream) {
  using Shape = Tile<kWarpgroups>;
  if ((size_t)g * l * t * 2 > (size_t)kStages * Shape::kStageBytes)
    return (int)cudaErrorInvalidValue;  // P is staged in the ring
  // innermost first: K, then rows, then samples
  CUtensorMap av_map, aq_map, h_map;
  const uint64_t av_dims[3] = {(uint64_t)k, (uint64_t)l, (uint64_t)n};
  const uint64_t av_strides[2] = {(uint64_t)k * 2, (uint64_t)l * k * 2};
  const uint32_t av_box[3] = {kKTile, kCells, 1};
  cudaError_t err = hopper::make_map(&av_map,
                                     CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, av,
                                     av_dims, av_strides, av_box,
                                     CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return (int)err;
  const uint64_t aq_dims[3] = {(uint64_t)k, (uint64_t)t, (uint64_t)n};
  const uint64_t aq_strides[2] = {(uint64_t)k * 2, (uint64_t)t * k * 2};
  const uint32_t aq_box[3] = {kKTile, Shape::kTBox, 1};
  err = hopper::make_map(&aq_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, aq,
                         aq_dims, aq_strides, aq_box,
                         CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != cudaSuccess) return (int)err;
  const uint64_t h_dims[2] = {(uint64_t)k, (uint64_t)g};
  const uint64_t h_strides[1] = {(uint64_t)k * 4};
  const uint32_t h_box[2] = {kKTile, kGBox};
  err = hopper::make_map(&h_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, h,
                         h_dims, h_strides, h_box, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(ban_attention_kernel<kWarpgroups>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Shape::kSmem);
  if (err != cudaSuccess) return (int)err;
  ban_attention_kernel<kWarpgroups>
      <<<(unsigned)n, Shape::kThreads, Shape::kSmem,
         static_cast<cudaStream_t>(stream)>>>(
          av_map, aq_map, h_map, static_cast<const unsigned char*>(mask),
          static_cast<__nv_bfloat16*>(out), l, t, g, k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// av [N, L, K], aq [N, T, K] bf16, h [G, K] f32, mask [N, L] bool (one
// byte each), out [N, G, L, T] bf16: contiguous, 16-byte aligned;
// 1 <= L <= 200, 1 <= T <= 24, 1 <= G <= 8, G T <= 192, K a positive
// multiple of 64: two warpgroups where T <= 16 and G T <= 128, else three.
// 0, or the CUDA error of the launch.
int ban_attention_launch(const void* av, const void* aq, const void* h,
                         const void* mask, void* out, int n, int l, int t,
                         int g, int k, void* stream) {
  if (n < 0 || l < 1 || l > kCells || t < 1 || t > Tile<3>::kTBox ||
      g < 1 || g > kGBox || g * t > Tile<3>::kRows || k < kKTile ||
      k % kKTile)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  if (t <= Tile<2>::kTBox && g * t <= Tile<2>::kRows)
    return launch<2>(av, aq, h, mask, out, n, l, t, g, k, stream);
  return launch<3>(av, aq, h, mask, out, n, l, t, g, k, stream);
}

const char* ban_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
