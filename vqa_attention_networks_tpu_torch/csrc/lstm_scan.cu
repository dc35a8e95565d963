// LSTM recurrence (bf16 inference), hand-written for Hopper (sm_90a):
// kernel K8.
//
// Replaces _lstm_scan_pallas (vqa_attention_networks_tpu/ops/pallas_lstm.py
// :74, its _kernel :46-71), reached through the entry lstm_seq (:137). The
// input projection xp = x @ W_ih + b stays outside, as in the JAX package.
// Gates in PyTorch's order i, f, g, o; for t = 0 .. T-1, with h_{-1} = 0 and
// c_{-1} = 0:
//
//   gates = f32(xp[:, t]) + h_{t-1} @ W_hh^T     bf16 x bf16, f32 accumulate
//   i, f, o = sigmoid(.), g = tanh(.)            f32
//   c_t   = f * c_{t-1} + i * g                  f32 carry
//   h_t   = bf16(o * tanh(c_t))                  bf16 carry, = out[:, t]
//
// W_hh is [4H, H] (PyTorch's layout): gate column c of the product is row c
// of W_hh. sigmoid is 1 / (1 + expf(-x)) and tanh is tanhf, both at full
// precision (no __expf intrinsics); the cell update keeps its multiplies
// and add unfused, as the plain PyTorch version (ops/lstm.py) computes it.
//
// What bounds it on this card, at N = 256, T = 22, H = 1024: the 22
// recurrent products, 2*N*T*H*4H = 47 GFLOP, 0.048 ms at 989 TFLOP/s bf16;
// the bytes moved once (xp, W_hh, out) are ~66 MB, 0.02 ms. The 22 steps
// depend on each other, a latency floor that the bound does not count: each
// step is a small product (N x H x 4H) whose blocks all wait for the last
// step's h.
//
// What the design does about the TPU's structure. The TPU kernel runs the
// whole recurrence in one pallas_call on a sequential grid (batch tiles x
// T), carrying h and c in VMEM scratch and keeping W_hh (8 MB) resident.
// Blocks here run in parallel with no order, so each time step is one
// launch (T launches from one call, on one stream): a block owns 64 rows x
// 32 hidden units and computes their four gate column blocks (i, f, g, o at
// columns u, H+u, 2H+u, 3H+u) on the tensor cores (WMMA bf16, f32
// accumulators), streaming h_{t-1} (read from out[:, t-1]) and the 128 rows
// of W_hh it needs in 32-deep stages with cp.async (the next stage in
// flight during this one's MMAs); W_hh stays in the 50 MB L2 across steps.
// The gate epilogue and the cell update are fused behind the product; c
// lives in an f32 buffer [N, H], each element read and written by one
// thread. Later work (ROADMAP): one persistent launch with a grid-wide
// barrier per step, W_hh slices kept in shared memory across steps.
//
// The C interface takes raw device pointers and the stream, and returns
// cudaGetLastError() after its launches (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;  // 8 warps; warp w owns gate columns 16w..+16
constexpr int kRowsPerBlock = 64;  // 4 row tiles of 16
constexpr int kRowTiles = kRowsPerBlock / 16;
constexpr int kUnits = 32;      // hidden units per block
constexpr int kCols = 4 * kUnits;  // the four gates' columns of those units
constexpr int kDepth = 32;      // contraction depth per shared-memory stage
constexpr int kLd = kDepth + 8;  // padded against bank conflicts
constexpr int kLdGates = kCols + 4;
constexpr int kStageBytes = 2 * (kRowsPerBlock + kCols) * kLd * 2;
constexpr int kGateBytes = kRowsPerBlock * kLdGates * 4;
constexpr int kSmem = kStageBytes > kGateBytes ? kStageBytes : kGateBytes;

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> AccFrag;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
    AFrag;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>
    BFrag;

__device__ __forceinline__ float sigmoid(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
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

// one time step: out[:, step] and c from xp[:, step], out[:, step - 1], c
__global__ void __launch_bounds__(kThreads)
    lstm_step_kernel(const bf16* __restrict__ xp,    // [N, T, 4H]
                     const bf16* __restrict__ w_hh,  // [4H, H]
                     float* __restrict__ c,          // [N, H]
                     bf16* __restrict__ out,         // [N, T, H]
                     int n, int t_len, int hdim, int step) {
  __shared__ __align__(128) unsigned char smem[kSmem];
  bf16* a_s = reinterpret_cast<bf16*>(smem);      // h [2][64 rows][32 u]
  bf16* b_s = a_s + 2 * kRowsPerBlock * kLd;      // W_hh [2][128 cols][32 u]
  float* gates_s = reinterpret_cast<float*>(smem);  // [64][128], after MMAs

  const int u0 = blockIdx.x * kUnits;
  const int n0 = blockIdx.y * kRowsPerBlock;
  const int tid = threadIdx.x, warp = tid / 32;

  AccFrag acc[kRowTiles];
#pragma unroll
  for (int mt = 0; mt < kRowTiles; ++mt) wmma::fill_fragment(acc[mt], 0.0f);

  if (step > 0) {  // h_{-1} = 0: the first step's product is 0
    const size_t row_stride = (size_t)t_len * hdim;
    const bf16* h_prev = out + (size_t)(step - 1) * hdim;
    const int chunks = hdim / kDepth;
    // copy the h and W_hh columns of chunk s into stage s & 1; one commit
    // group per call (empty past the end)
    auto prefetch = [&](int s) {
      if (s < chunks) {
        const int d0 = s * kDepth;
        bf16* a = a_s + (s & 1) * kRowsPerBlock * kLd;
        for (int i = tid; i < kRowsPerBlock * (kDepth / 8); i += kThreads) {
          const int r = i / (kDepth / 8), v = i % (kDepth / 8);
          const bool ok = n0 + r < n;
          cp_async16(a + r * kLd + v * 8,
                     ok ? h_prev + (size_t)(n0 + r) * row_stride + d0 + v * 8
                        : h_prev,
                     ok);
        }
        bf16* bs = b_s + (s & 1) * kCols * kLd;
        for (int i = tid; i < kCols * (kDepth / 8); i += kThreads) {
          const int j = i / (kDepth / 8), v = i % (kDepth / 8);
          const int col = (j / kUnits) * hdim + u0 + j % kUnits;
          cp_async16(bs + j * kLd + v * 8,
                     w_hh + (size_t)col * hdim + d0 + v * 8, true);
        }
      }
      cp_async_commit();
    };

    prefetch(0);
    for (int s = 0; s < chunks; ++s) {
      prefetch(s + 1);  // in flight during this chunk's MMAs
      cp_async_wait_prior();
      __syncthreads();
      const bf16* a = a_s + (s & 1) * kRowsPerBlock * kLd;
      const bf16* bs = b_s + (s & 1) * kCols * kLd;
#pragma unroll
      for (int kk = 0; kk < kDepth / 16; ++kk) {
        BFrag bfr;  // B[u, col] = W_hh[col, u]: column-major in the stage
        wmma::load_matrix_sync(bfr, bs + warp * 16 * kLd + kk * 16, kLd);
#pragma unroll
        for (int mt = 0; mt < kRowTiles; ++mt) {
          AFrag af;
          wmma::load_matrix_sync(af, a + mt * 16 * kLd + kk * 16, kLd);
          wmma::mma_sync(acc[mt], af, bfr, acc[mt]);
        }
      }
      __syncthreads();  // stage s & 1 is free for chunk s + 2
    }
  }

  // the stages are free: the products go to gates_s, which aliases them
#pragma unroll
  for (int mt = 0; mt < kRowTiles; ++mt)
    wmma::store_matrix_sync(gates_s + mt * 16 * kLdGates + warp * 16, acc[mt],
                            kLdGates, wmma::mem_row_major);
  __syncthreads();

  // gate epilogue and cell update; neighbouring threads take neighbouring
  // hidden units
  for (int e = tid; e < kRowsPerBlock * kUnits; e += kThreads) {
    const int r = e / kUnits, uu = e % kUnits;
    const int row = n0 + r;
    if (row >= n) continue;
    const int u = u0 + uu;
    const bf16* x = xp + ((size_t)row * t_len + step) * 4 * hdim + u;
    const float* gr = gates_s + r * kLdGates + uu;
    const float gi = __fadd_rn(__bfloat162float(x[0]), gr[0]);
    const float gf = __fadd_rn(__bfloat162float(x[hdim]), gr[kUnits]);
    const float gg = __fadd_rn(__bfloat162float(x[2 * hdim]), gr[2 * kUnits]);
    const float go = __fadd_rn(__bfloat162float(x[3 * hdim]), gr[3 * kUnits]);
    const float ig = sigmoid(gi), fg = sigmoid(gf), og = sigmoid(go);
    const float cell = tanhf(gg);
    float* cp = c + (size_t)row * hdim + u;
    const float c_prev = step > 0 ? *cp : 0.0f;
    const float c_new = __fadd_rn(__fmul_rn(fg, c_prev), __fmul_rn(ig, cell));
    *cp = c_new;
    out[((size_t)row * t_len + step) * hdim + u] =
        __float2bfloat16(__fmul_rn(og, tanhf(c_new)));
  }
}

}  // namespace

extern "C" {

int lstm_scan_launch(const void* xp, const void* w_hh, void* c, void* out,
                     int n, int t_len, int hdim, void* stream) {
  if (n < 1 || n > 65535 * kRowsPerBlock || t_len < 1 || hdim < kUnits ||
      hdim % kUnits)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const dim3 grid(hdim / kUnits, (n + kRowsPerBlock - 1) / kRowsPerBlock);
  for (int step = 0; step < t_len; ++step) {
    lstm_step_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const bf16*>(xp), static_cast<const bf16*>(w_hh),
        static_cast<float*>(c), static_cast<bf16*>(out), n, t_len, hdim,
        step);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

const char* lstm_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
