// The 2-glimpse attention block, bf16 inference, hand-written for Hopper
// (sm_90a).
//
// Replaces _glimpse_pallas (vqa_attention_networks_tpu/ops/
// pallas_attention.py). With x [N, P, C], W1 [A, C], W2 [G, A], v [N, P, D]
// (bf16; W2 comes in f32 and is rounded to bf16 in the kernel) and the
// biases b1 [A], b2 [G] (f32), m = n*P + p the flat row:
//
//   h[m,a]     = bf16(relu(sum_c x[m,c] W1[a,c] + b1[a]))     f32 sum
//   logit[m,g] = sum_a h[m,a] W2[g,a] + b2[g]                 f32
//   w[n,p,g]   = bf16(softmax over p of logit[n*P+p, g])      (1 under the
//                                                              quirk)
//   out[n,g,d] = bf16(sum_p w[n,p,g] v[n,p,d])                f32 sum
//
// What bounds it on this card. At the question glimpse of mhb_coAtt
// (N=256, P=22, C=1024, A=512, D=1024) the MLP is 5.9 GFLOP against 25 MB
// of inputs; at the co-attention (P=196, C=1000, D=2048) 51 GFLOP against
// 305 MB: about 52 us of tensor-core work against 93 us of reads. The
// second is bound by reading x and v once.
//
// What the design does about it. The TPU kernel keeps 8 samples' x, v and
// the weights in VMEM and runs the whole block per grid step. Here two
// launches from one entry, every sum in a fixed order (no atomics: reruns
// give the same bits):
//   1  glimpse_mlp_kernel   one block per (128 rows, 256 hidden units), the
//      hidden tile running fastest so that both tiles of a row block read
//      its x while it is in L2. Thread 0 keeps a ring of TMA stages full,
//      x's [128 m, 64 c] and W1's [256 a, 64 c] tiles (bf16, 128-byte
//      swizzle; C past its end comes in as zeros), while two warpgroups run
//      wgmma m64n256k16 on them (A = x, B = W1, both K-major). The epilogue,
//      in registers: + b1, relu, the bf16 rounding and the dot with W2's
//      [G, 256] slice, each thread over its 64 hidden units in order, then
//      the quad's lanes by shuffles, so h never reaches device memory: each
//      block writes the partial logits [N*P, G] of its 256 hidden units.
//      L2 traffic: x twice and W1's half per row block, ~0.6 GB at the
//      co-attention.
//   2  glimpse_pool_kernel  grid (ceil(D/512), N): sums the partial logits
//      of the hidden tiles in order, + b2, the softmax over P per glimpse
//      (redone by each of a sample's blocks, a few microseconds), and the
//      pool of v, each thread 4 columns with 8-byte loads, 8 rows' loads in
//      flight with no branch between them (bf16 pairs where D % 4 != 0); v
//      read once, out written in bf16.
//
// The C interface takes raw device pointers and the stream; each launch is
// followed by cudaGetLastError(), whose code is returned (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf16x2;

constexpr int kMaxG = 4;
constexpr int kMaxP = 1024;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// ---------------------------------------------------------------------------
// 1: partial logits of 256 hidden units for 128 rows
// ---------------------------------------------------------------------------
constexpr int kMlpRows = 128;       // rows of x per block: 2 x wgmma's M
constexpr int kMlpHidden = 256;     // hidden units per block: wgmma's N
constexpr int kMlpDepth = 64;       // C per ring stage: a 128-byte row
constexpr int kMlpStages = 4;
constexpr int kMlpThreads = 256;    // two warpgroups
constexpr int kMlpXBytes = kMlpRows * kMlpDepth * 2;
constexpr int kMlpWBytes = kMlpHidden * kMlpDepth * 2;
constexpr int kMlpStage = kMlpXBytes + kMlpWBytes;
// 1 KB of alignment slack and 1 KB of barriers, then the ring
constexpr int kMlpSmem = 2048 + kMlpStages * kMlpStage;

__global__ void __launch_bounds__(kMlpThreads, 1)
    glimpse_mlp_kernel(const __grid_constant__ CUtensorMap x_map,   // [M, C]
                       const __grid_constant__ CUtensorMap w1_map,  // [A, C]
                       const float* __restrict__ b1,  // [A]
                       const float* __restrict__ w2,  // [G, A]
                       float* __restrict__ part,      // [A tiles, M, G]
                       int mrows, int c_dim, int a_dim, int g,
                       int a_tiles) {
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMlpStages;
  unsigned char* ring = smem + 1024;
  // b1 and bf16(W2) of the block's hidden units, 0 past A
  __shared__ float b1_s[kMlpHidden];
  __shared__ float w2_s[kMaxG][kMlpHidden];

  const int a_tile = blockIdx.x % a_tiles;
  const int a0 = a_tile * kMlpHidden;
  const int m0 = (blockIdx.x / a_tiles) * kMlpRows;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int steps = (c_dim + kMlpDepth - 1) / kMlpDepth;

  if (tid == 0) {
    for (int s = 0; s < kMlpStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kMlpThreads / 32);
    }
    mbar_fence_init();
  }
  for (int i = tid; i < kMlpHidden; i += kMlpThreads) {
    const int a = a0 + i;
    b1_s[i] = a < a_dim ? b1[a] : 0.0f;
#pragma unroll
    for (int gg = 0; gg < kMaxG; ++gg)
      w2_s[gg][i] = gg < g && a < a_dim
                        ? round_bf16(w2[(size_t)gg * a_dim + a])
                        : 0.0f;
  }
  __syncthreads();

  // step kt into stage kt % kMlpStages, requested by thread 0 (every
  // thread walks the same path: see mbar_expect_tx)
  const bool leader = tid == 0;
  auto load = [&](int kt) {
    const int s = kt % kMlpStages;
    unsigned char* st = ring + s * kMlpStage;
    mbar_expect_tx(&full[s], kMlpStage, leader);
    tma_load_2d(st, &x_map, &full[s], kt * kMlpDepth, m0, leader);
    tma_load_2d(st + kMlpXBytes, &w1_map, &full[s], kt * kMlpDepth, a0,
                leader);
  };
  for (int kt = 0; kt < kMlpStages - 1 && kt < steps; ++kt) load(kt);

  const int wg = warp / 4;
  float acc[kMlpHidden / 2];
#pragma unroll
  for (int i = 0; i < kMlpHidden / 2; ++i) acc[i] = 0.0f;

  for (int kt = 0; kt < steps; ++kt) {
    const int s = kt % kMlpStages;
    mbar_wait(&full[s], (kt / kMlpStages) & 1);
    const unsigned char* st = ring + s * kMlpStage;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kMlpDepth / 16; ++ks) {
      // A: the warpgroup's 64 rows of 128 B, k at 32 B a step; B: W1's 256
      // rows of 128 B, likewise (8-row groups 1 KB apart in both)
      const uint64_t da = smem_desc(st + wg * 64 * 128 + ks * 32, 16, 1024,
                                    kSwizzle128);
      const uint64_t db = smem_desc(st + kMlpXBytes + ks * 32, 16, 1024,
                                    kSwizzle128);
      Wgmma<kMlpHidden>::ss<0>(acc, da, db);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the group of step kt - 1 is done: release its stage
    if (kt > 0 && lane == 0) mbar_arrive(&empty[(kt - 1) % kMlpStages]);
    // that stage is refilled with step kt + kMlpStages - 1 once all 8 warps
    // have released it
    const int next = kt + kMlpStages - 1;
    if (next < steps) {
      if (kt > 0)
        mbar_wait(&empty[next % kMlpStages], ((kt - 1) / kMlpStages) & 1);
      load(next);
    }
  }
  wgmma_wait<0>();
  fence_operands(acc);

  // epilogue: the thread holds rows r and r + 8 (h = 0, 1) and hidden units
  // 8 i + 2 t + e of the tile, in acc[4 i + 2 h + e]; its partial logits
  // over them in (i, e) order, then the quad's 4 lanes by shuffles
  const int g4 = lane / 4, t = lane % 4;
  const int r = m0 + wg * 64 + (warp % 4) * 16 + g4;
  float plog[2][kMaxG];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int gg = 0; gg < kMaxG; ++gg) plog[h][gg] = 0.0f;
#pragma unroll
  for (int i = 0; i < kMlpHidden / 8; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * i + 2 * t + (e & 1);
      const float hv = round_bf16(fmaxf(acc[4 * i + e] + b1_s[col], 0.0f));
#pragma unroll
      for (int gg = 0; gg < kMaxG; ++gg)
        if (gg < g) plog[e >> 1][gg] += hv * w2_s[gg][col];
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int gg = 0; gg < kMaxG; ++gg) {
      float v = plog[h][gg];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      plog[h][gg] = v;
    }
    const int m = r + 8 * h;
    if (t == 0 && m < mrows) {
      float* dst = part + ((size_t)a_tile * mrows + m) * g;
#pragma unroll
      for (int gg = 0; gg < kMaxG; ++gg)
        if (gg < g) dst[gg] = plog[h][gg];
    }
  }
}

// ---------------------------------------------------------------------------
// 2: logits, softmax over P per glimpse, pool of v
// ---------------------------------------------------------------------------
constexpr int kPoolThreads = 128;  // 4 warps: one per glimpse's softmax
constexpr int kPoolUnroll = 8;     // rows of v in flight a thread

// kVec columns of a row of v, as raw bf16: 4 by one 8-byte load, or 2 by
// a bf16 pair
template <int kVec>
struct Cols;
template <>
struct Cols<4> {
  typedef uint2 Raw;
  __device__ static void unpack(const Raw& r, float (&x)[4]) {
    const float2 lo =
        __bfloat1622float2(*reinterpret_cast<const bf16x2*>(&r.x));
    const float2 hi =
        __bfloat1622float2(*reinterpret_cast<const bf16x2*>(&r.y));
    x[0] = lo.x;
    x[1] = lo.y;
    x[2] = hi.x;
    x[3] = hi.y;
  }
  __device__ static void store(bf16* o, const float (&a)[4]) {
    const bf16x2 lo = __floats2bfloat162_rn(a[0], a[1]);
    const bf16x2 hi = __floats2bfloat162_rn(a[2], a[3]);
    *reinterpret_cast<uint2*>(o) =
        make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                   *reinterpret_cast<const uint32_t*>(&hi));
  }
};
template <>
struct Cols<2> {
  typedef uint32_t Raw;
  __device__ static void unpack(const Raw& r, float (&x)[2]) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const bf16x2*>(&r));
    x[0] = f.x;
    x[1] = f.y;
  }
  __device__ static void store(bf16* o, const float (&a)[2]) {
    *reinterpret_cast<bf16x2*>(o) = __floats2bfloat162_rn(a[0], a[1]);
  }
};

template <int kVec>
__global__ void __launch_bounds__(kPoolThreads)
    glimpse_pool_kernel(const float* __restrict__ part,  // [A tiles, M, G]
                        const float* __restrict__ b2,    // [G]
                        const bf16* __restrict__ v,      // [N, P, D]
                        bf16* __restrict__ out,          // [N, G, D]
                        int p_dim, int d_dim, int g, int a_tiles, int mrows,
                        int uniform) {
  typedef typename Cols<kVec>::Raw Raw;
  __shared__ float w_s[kMaxG * kMaxP];  // [G][P]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t n = blockIdx.y;

  if (uniform) {
    for (int i = tid; i < g * p_dim; i += kPoolThreads) w_s[i] = 1.0f;
  } else {
    for (int i = tid; i < g * p_dim; i += kPoolThreads) {
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

  const int c = (blockIdx.x * kPoolThreads + tid) * kVec;
  if (c >= d_dim) return;
  float acc[kMaxG][kVec];
#pragma unroll
  for (int gg = 0; gg < kMaxG; ++gg)
#pragma unroll
    for (int u = 0; u < kVec; ++u) acc[gg][u] = 0.0f;
  const bf16* vn = v + n * p_dim * d_dim + c;
  // row p of v into acc, weighted by each glimpse's w[p]
  auto add_row = [&](const Raw& raw, int p) {
    float x[kVec];
    Cols<kVec>::unpack(raw, x);
#pragma unroll
    for (int gg = 0; gg < kMaxG; ++gg) {
      if (gg < g) {
        const float w = w_s[gg * p_dim + p];
#pragma unroll
        for (int i = 0; i < kVec; ++i) acc[gg][i] += w * x[i];
      }
    }
  };
  // whole batches of kPoolUnroll rows: the batch's loads first, with no
  // branch among them or their sums (a branch per row let the compiler
  // sink each load into it, one load in flight), then the sums in row
  // order; the last P % kPoolUnroll rows one by one, in order
  int p0 = 0;
  for (; p0 + kPoolUnroll <= p_dim; p0 += kPoolUnroll) {
    Raw raw[kPoolUnroll];
#pragma unroll
    for (int u = 0; u < kPoolUnroll; ++u)
      raw[u] = *reinterpret_cast<const Raw*>(vn + (size_t)(p0 + u) * d_dim);
#pragma unroll
    for (int u = 0; u < kPoolUnroll; ++u) add_row(raw[u], p0 + u);
  }
  for (; p0 < p_dim; ++p0)
    add_row(*reinterpret_cast<const Raw*>(vn + (size_t)p0 * d_dim), p0);
#pragma unroll
  for (int gg = 0; gg < kMaxG; ++gg)
    if (gg < g) Cols<kVec>::store(out + (n * g + gg) * d_dim + c, acc[gg]);
}

template <int kVec>
cudaError_t launch_pool(const void* part, const void* b2, const void* v,
                        void* out, int n, int p, int d, int g, int a_tiles,
                        int mrows, int uniform, cudaStream_t s) {
  constexpr int cols = kPoolThreads * kVec;
  glimpse_pool_kernel<kVec><<<dim3((d + cols - 1) / cols, n), kPoolThreads,
                              0, s>>>(
      static_cast<const float*>(part), static_cast<const float*>(b2),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), p, d, g,
      a_tiles, mrows, uniform);
  return cudaGetLastError();
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
  const int a_tiles = (a + kMlpHidden - 1) / kMlpHidden;
  if (!uniform) {  // under the quirk the logits are value-dead
    CUtensorMap x_map, w1_map;
    const uint64_t x_dims[2] = {(uint64_t)c, (uint64_t)mrows};
    const uint64_t row_stride[1] = {(uint64_t)c * 2};
    const uint32_t x_box[2] = {kMlpDepth, kMlpRows};
    cudaError_t err = hopper::make_map(
        &x_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, x_dims, row_stride,
        x_box, CU_TENSOR_MAP_SWIZZLE_128B);
    if (err != cudaSuccess) return (int)err;
    const uint64_t w1_dims[2] = {(uint64_t)c, (uint64_t)a};
    const uint32_t w1_box[2] = {kMlpDepth, kMlpHidden};
    err = hopper::make_map(&w1_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w1,
                           w1_dims, row_stride, w1_box,
                           CU_TENSOR_MAP_SWIZZLE_128B);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(glimpse_mlp_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMlpSmem);
    if (err != cudaSuccess) return (int)err;
    const unsigned blocks =
        (unsigned)a_tiles * (unsigned)((mrows + kMlpRows - 1) / kMlpRows);
    glimpse_mlp_kernel<<<blocks, kMlpThreads, kMlpSmem, s>>>(
        x_map, w1_map, static_cast<const float*>(b1),
        static_cast<const float*>(w2), static_cast<float*>(part), mrows, c, a,
        g, a_tiles);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  // 8-byte loads of v where D and v's address allow them
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(v) % 8 == 0;
  return (int)(vec ? launch_pool<4>(part, b2, v, out, n, p, d, g, a_tiles,
                                    mrows, uniform, s)
                   : launch_pool<2>(part, b2, v, out, n, p, d, g, a_tiles,
                                    mrows, uniform, s));
}

const char* glimpse_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
