// LSTM recurrence (bf16 inference), hand-written for Hopper (sm_90a):
// kernel K8, the whole scan in one persistent launch.
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
// the bytes moved once (xp, W_hh, out) are ~66 MB, 0.02 ms. The steps
// depend on each other: every block waits for the whole of h_{t-1}, a
// latency floor that the bound does not count.
//
// The design. The TPU kernel runs the recurrence on a sequential grid,
// carrying h and c in VMEM and keeping W_hh (8 MB at H = 1024) resident.
// Here one cooperative launch of at most one block per SM runs all T steps:
//
// - A block owns kUnits = 16 hidden units, the 64 gate columns i, f, g, o
//   of those units, and one group of rows. Their 64 rows of W_hh (128 KB at
//   H = 1024) are copied into shared memory once and stay there for every
//   step: W_hh is read from device memory once per call, not once per step.
// - H / 16 unit tiles times G row groups make the grid; G is as large as
//   the card's SMs allow (2 at H = 1024: 128 blocks on 132 SMs). Each block
//   streams its rows of h_{t-1} from L2 every step, so the L2 traffic of a
//   step is (H / 16) * N * H * 2 bytes whatever G is: 32 MB at N = 256
//   (with 8 units a block it would be 64 MB, and 32 units do not fit).
// - h_{t-1} is read through a cp.async.cg ring of 18 KB stages (128 rows x
//   64 deep) in tiles of 128 rows; .cg caches in L2 only, so a line that
//   another SM rewrote in the last step is never read stale from L1. A
//   step is a chain of H / 64 such loads, each an L2 round trip, so the
//   ring takes as many stages (3 to 8, all but one in flight) as the
//   shared memory left beside W_hh holds: 5 at H = 1024. The 4 warps
//   that read a 32-row slice of a stage copy it themselves and wait for
//   one another on a named barrier, not for the whole block.
// - The product runs on the tensor cores (mma.sync m16n8k16, bf16 in, f32
//   sums, fragments by ldmatrix). 16 warps: 4 row groups of 32 x 2 unit
//   groups of 8 x 2 halves of each stage's depth. A warp's 4 column tiles
//   of 8 are the gates i, f, g, o of its 8 units, so after the two halves
//   are added the four gates of each (row, unit) meet in one thread, and
//   the gate epilogue and cell update run from registers, 4 elements a
//   thread.
// - After each step but the last, a barrier over the row group (its blocks
//   read only its rows of h): every thread's h stores, then
//   __syncthreads, then one thread's release add on the group's counter
//   (zeroed by the wrapper), and a spin on an acquire load until it
//   reaches (step + 1) * H / 16. The cooperative launch guarantees that
//   all blocks are resident, so the spin cannot wait on a block that never
//   runs. The next step's xp is read into registers before the barrier.
// - c lives in shared memory (rows_per_block x 16 f32) where it fits
//   beside W_hh and 3 stages of the ring: N up to 1,408 at H = 1024. Past
//   that it lives in an f32 [N, H] scratch in device memory, so a block
//   takes any number of row tiles (kCInSmem false; the wrapper passes the
//   scratch). Either way each element is read and written by one thread
//   in every step. No atomics touch a floating-point value: reruns give
//   the same bits.
// - xp is x @ W_ih without the bias, and the epilogue adds the bias in
//   bf16 as the input projection would (one pass over xp fewer).
//
// Shared memory: 64 x (H + 8) bf16 of W_hh, the ring (18,432 B a stage;
// the two halves' partial sums swap through it after the product) and c
// where it fits: 232,448 B at H = 1024, N = 256 (5 stages), 220,160 B at
// N = 1024 (3 stages) and 224,256 B at N = 2048 (c in device memory, 5
// stages), of the 232,448 a block may have. So H is at most 1280 (3
// stages) and at most 16 x the SMs; a wider
// W_hh (8 H^2 bytes: 32 MB at H = 2048) does not fit in the shared memory
// of the whole card. ops/lstm.py ``geometry`` computes the grid, the stages
// and the bytes, and ``supported`` refuses a shape it does not take; the
// entry checks them against its own constants.
//
// The C interface takes raw device pointers and the stream, and returns
// cudaGetLastError() after its launch (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 512;  // 16 warps: 4 row groups x 2 unit groups x
                               // 2 halves of each chunk's depth
constexpr int kUnits = 16;         // hidden units per block
constexpr int kCols = 4 * kUnits;  // their four gates' columns
constexpr int kWarpUnits = 8;      // a warp's units: 4 gates x 8 columns
constexpr int kTileRows = 128;     // rows of h per product tile
constexpr int kDepth = 64;         // contraction depth per ring stage
constexpr int kMinStages = 3;      // ring stages: 3 to 8, by the memory left
constexpr int kLdA = kDepth + 8;   // 144-byte rows: ldmatrix conflict-free
constexpr int kStageElems = kTileRows * kLdA;
// the partial sums the warps of a row group swap after a product fit in
// the group's 32 rows of a stage
static_assert(16 * 64 * 4 <= 32 * kLdA * 2, "the swap fits in a stage");

__device__ __forceinline__ float sigmoid(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

// 16 bytes global -> shared, cached in L2 only
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most kPending of the newest commit groups are in flight
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// four 8x8 bf16 matrices: lane i gives the row address of matrix i / 8,
// row i % 8
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
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

// the 128 threads of row group `group` (named barrier 1 + group; 0 is
// __syncthreads')
__device__ __forceinline__ void group_sync(int group) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + group) : "memory");
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// every global store of the blocks of a row group before the call is
// visible to each of them after it: the stores are ordered before one
// thread's release add by the block barrier, and the spinning acquire load
// orders the block's later reads after every other block's add
__device__ __forceinline__ void group_barrier(unsigned* counter,
                                              unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("red.release.gpu.global.add.u32 [%0], %1;\n" ::"l"(counter),
                 "r"(1u)
                 : "memory");
    while (ld_acquire(counter) < target) {
    }
  }
  __syncthreads();
}

__device__ __forceinline__ float bf16_lo(uint32_t v) {
  return __uint_as_float(v << 16);
}

__device__ __forceinline__ float bf16_hi(uint32_t v) {
  return __uint_as_float(v & 0xFFFF0000u);
}

// x + b rounded to bf16, as the bf16 add of the input projection rounds it
__device__ __forceinline__ float add_bias(float x, float b) {
  return __bfloat162float(__float2bfloat16(__fadd_rn(x, b)));
}

// A thread's accumulator fragments hold, for each of its 2 row tiles i
// (16 rows) and 4 gates j (8 columns each), rows g and g + 8 (g = lane / 4)
// of units 2 (lane % 4) and + 1 of its warp's 8: element e = 2 * half +
// unit of acc[i][j][e]. The two warps of a pair (kh = 0, 1) sum the two
// halves of each 64-deep chunk; after the product they swap the partial
// sums of one row tile through shared memory, each adds kh 0's + kh 1's
// for the row tile it keeps (i = kh), and the four gates of each of its 4
// (row, unit) elements meet in one thread for the epilogue.
template <int kStages, bool kCInSmem>
__global__ void __launch_bounds__(kThreads, 1)
    lstm_persistent_kernel(const bf16* __restrict__ xp,    // [N, T, 4H]
                           const bf16* __restrict__ bias,  // [4H]
                           const bf16* __restrict__ w_hh,  // [4H, H]
                           bf16* out,                      // [N, T, H]
                           float* c_buf,  // [N, H], or null: c_s
                           unsigned* counter, int n, int t_len, int hdim,
                           int rows_per_block) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldw = hdim + 8;  // 16 bytes of padding: ldmatrix conflict-free
  bf16* w_s = reinterpret_cast<bf16*>(smem);  // [64 columns][H + 8]
  bf16* ring = w_s + kCols * ldw;             // [stages][128 rows][72]
  float* c_s = reinterpret_cast<float*>(ring + kStages * kStageElems);

  const int unit_tiles = hdim / kUnits;
  const int u0 = (blockIdx.x % unit_tiles) * kUnits;
  const int row0 = (blockIdx.x / unit_tiles) * rows_per_block;
  const int row_end = min(n, row0 + rows_per_block);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int kh = warp / 8, pair = warp % 8;  // kh: half of the depth
  const int wr = pair / 2, wc = pair % 2;  // 32 rows x 8 units (32 columns)
  const int g = lane / 4, tig = lane % 4;
  const int unit = wc * kWarpUnits + 2 * tig;  // and unit + 1, of the 16
  const size_t row_stride = (size_t)t_len * hdim;
  const int chunks = hdim / kDepth;

  // W_hh's rows of this block's gate columns, once: shared-memory row
  // wc * 32 + j * 8 + uu is gate j of unit u0 + wc * 8 + uu
  const int vecs = hdim / 8;
  for (int i = tid; i < kCols * vecs; i += kThreads) {
    const int r = i / vecs, v = i % vecs;
    const int wrow = ((r % 32) / 8) * hdim + u0 + (r / 32) * kWarpUnits + r % 8;
    cp_async16(w_s + r * ldw + v * 8, w_hh + (size_t)wrow * hdim + v * 8);
  }
  cp_async_commit();

  // the bias of this thread's 4 gates x 2 units, fixed for the call
  float bv[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t b =
        *reinterpret_cast<const uint32_t*>(bias + j * hdim + u0 + unit);
    bv[j][0] = bf16_lo(b);
    bv[j][1] = bf16_hi(b);
  }

  // xp of this thread's 4 elements (row tile kh) at (step, tile0), as bf16
  // pairs [half][gate]; read one (step, tile) ahead of its use
  uint32_t xr[2][4];
  auto load_x = [&](int step, int tile0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = tile0 + wr * 32 + kh * 16 + h * 8 + g;
      const bf16* x = xp + ((size_t)row * t_len + step) * 4 * hdim + u0 +
                      unit;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        xr[h][j] = row < row_end
            ? *reinterpret_cast<const uint32_t*>(x + j * hdim) : 0u;
    }
  };
  load_x(0, row0);
  cp_async_wait<0>();
  __syncthreads();

  // ldmatrix lane offsets: A (h rows, k contiguous) matrices (rows +0,
  // k +0), (+8, +0), (+0, +8), (+8, +8) give a0..a3; B (W rows = columns,
  // k contiguous) matrices (columns +0, k +0), (+0, +8), (+8, +0), (+8, +8)
  // give b0, b1 of two gates
  const int mat = lane / 8, r8 = lane % 8;
  const int a_off = (wr * 32 + r8 + (mat % 2) * 8) * kLdA + (mat / 2) * 8;
  const bf16* w_lane = w_s + (wc * 32 + r8 + (mat / 2) * 8) * ldw + (mat % 2) * 8;

  for (int step = 0; step < t_len; ++step) {
    for (int tile0 = row0; tile0 < row_end; tile0 += kTileRows) {
      float acc[2][4][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

      // the 4 warps of row group wr (2 unit groups x 2 halves of the
      // depth) read only its 32 rows of each stage: they copy them and
      // wait for one another alone
      const int group_rows = min(32, row_end - tile0 - wr * 32);
      if (step > 0 && group_rows > 0) {  // h_{-1} = 0: no product at step 0
        const bf16* h_prev = out + (size_t)(step - 1) * hdim;
        const int gtid = (kh * 2 + wc) * 32 + lane;  // of the group's 128
        // the group's rows of h_{t-1}, columns of chunk s, into stage
        // s % kStages; one commit group per call (empty past the end).
        // Rows past row_end are not copied: their products land only in
        // accumulator rows that the epilogue skips.
        auto prefetch = [&](int s) {
          if (s < chunks) {
            bf16* a = ring + (s % kStages) * kStageElems + wr * 32 * kLdA;
            const bf16* h = h_prev + (size_t)(tile0 + wr * 32) * row_stride +
                            s * kDepth;
            for (int i = gtid; i < group_rows * (kDepth / 8); i += 128) {
              const int r = i / (kDepth / 8), v = i % (kDepth / 8);
              cp_async16(a + r * kLdA + v * 8, h + r * row_stride + v * 8);
            }
          }
          cp_async_commit();
        };
#pragma unroll
        for (int s = 0; s < kStages - 1; ++s) prefetch(s);
        for (int s = 0; s < chunks; ++s) {
          cp_async_wait<kStages - 2>();  // chunk s has landed
          // ... for the whole group; its chunk s - 1 is consumed
          group_sync(wr);
          prefetch(s + kStages - 1);
          const bf16* a = ring + (s % kStages) * kStageElems + a_off;
          const bf16* w = w_lane + s * kDepth;
#pragma unroll
          for (int kk = kh * kDepth / 2; kk < (kh + 1) * kDepth / 2;
               kk += 16) {
            uint32_t af[2][4], bfr[2][4];
            ldmatrix_x4(af[0], a + kk);
            ldmatrix_x4(af[1], a + 16 * kLdA + kk);
            ldmatrix_x4(bfr[0], w + kk);
            ldmatrix_x4(bfr[1], w + 16 * ldw + kk);
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j)
                mma_16816(acc[i][j], af[i], bfr[j / 2][(j % 2) * 2],
                          bfr[j / 2][(j % 2) * 2 + 1]);
          }
        }
        cp_async_wait<0>();
      }

      // c_{t-1} of this thread's 4 elements (row tile kh) in device
      // memory, which it wrote itself in the last step: read before the
      // swap, whose barriers hide the load (read before the product, it
      // would hold registers across it)
      float2 c_prev[2] = {make_float2(0.0f, 0.0f), make_float2(0.0f, 0.0f)};
      if (!kCInSmem && step > 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = tile0 + wr * 32 + kh * 16 + h * 8 + g;
          if (row < row_end)
            c_prev[h] = *reinterpret_cast<const float2*>(
                c_buf + (size_t)row * hdim + u0 + unit);
        }
      }

      // the row tile this warp keeps (i = kh); after a product, swap the
      // other with the warp's pair through the group's own rows of stages
      // 0 (kh 0 writes) and 1 (kh 1 writes), once the group is past its
      // last read of them, and add kh 0's partial sums to kh 1's
      float keep[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          keep[j][e] = kh ? acc[1][j][e] : acc[0][j][e];
      if (step > 0) {
        auto xch = [&](int half) {  // [16][64] floats in 4,608 bytes
          return reinterpret_cast<float*>(ring + half * kStageElems +
                                          wr * 32 * kLdA) + wc * 32 + lane;
        };
        group_sync(wr);
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            xch(kh)[(j * 4 + e) * 64] = kh ? acc[0][j][e] : acc[1][j][e];
        group_sync(wr);
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float other = xch(1 - kh)[(j * 4 + e) * 64];
            keep[j][e] = kh ? __fadd_rn(other, keep[j][e])
                            : __fadd_rn(keep[j][e], other);
          }
      }

      // gates, cell update and h of row tile kh, from the registers; the
      // next (step, tile)'s xp is read as soon as this one's is consumed
      uint32_t xc[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 4; ++j) xc[h][j] = xr[h][j];
      const int next_tile = tile0 + kTileRows < row_end ? tile0 + kTileRows
                                                        : row0;
      const int next_step = next_tile == row0 ? step + 1 : step;
      if (next_step < t_len) load_x(next_step, next_tile);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = tile0 + wr * 32 + kh * 16 + h * 8 + g;
        if (row >= row_end) continue;
        float hv[2], c_new[2];
#pragma unroll
        for (int uo = 0; uo < 2; ++uo) {
          float gate[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float x = uo ? bf16_hi(xc[h][j]) : bf16_lo(xc[h][j]);
            gate[j] = __fadd_rn(add_bias(x, bv[j][uo]), keep[j][2 * h + uo]);
          }
          const float ig = sigmoid(gate[0]), fg = sigmoid(gate[1]);
          const float cell = tanhf(gate[2]), og = sigmoid(gate[3]);
          float* cs = c_s + (row - row0) * kUnits + unit + uo;
          const float cp = kCInSmem ? (step > 0 ? *cs : 0.0f)
                                    : (uo ? c_prev[h].y : c_prev[h].x);
          c_new[uo] = __fadd_rn(__fmul_rn(fg, cp), __fmul_rn(ig, cell));
          if (kCInSmem) *cs = c_new[uo];
          hv[uo] = __fmul_rn(og, tanhf(c_new[uo]));
        }
        if (!kCInSmem)
          *reinterpret_cast<float2*>(c_buf + (size_t)row * hdim + u0 +
                                     unit) = make_float2(c_new[0], c_new[1]);
        *reinterpret_cast<__nv_bfloat162*>(
            out + (size_t)row * row_stride + (size_t)step * hdim + u0 +
            unit) = __floats2bfloat162_rn(hv[0], hv[1]);
      }
      // the group's rows of the ring are reused by the next tile (the
      // barrier below syncs too)
      if (tile0 + kTileRows < row_end) group_sync(wr);
    }
    // a row group's blocks read only its rows of h: its own barrier
    if (step + 1 < t_len)
      group_barrier(counter + blockIdx.x / unit_tiles,
                    (unsigned)(step + 1) * unit_tiles);
  }
}

// the dynamic shared memory of one block (ops/lstm.py ``geometry``)
long long smem_bytes_for(int hdim, int rows_per_block, int stages,
                         bool c_in_smem) {
  return (long long)kCols * (hdim + 8) * 2 +
         (long long)stages * kStageElems * 2 +
         (c_in_smem ? (long long)rows_per_block * kUnits * 4 : 0);
}

template <int kStages, bool kCInSmem>
cudaError_t launch(const void* xp, const void* bias, const void* w_hh,
                   void* out, void* c_buf, void* counter, int n, int t_len,
                   int hdim, int blocks, int rows_per_block, int smem_bytes,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      lstm_persistent_kernel<kStages, kCInSmem>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  const bf16* xp_p = static_cast<const bf16*>(xp);
  const bf16* bias_p = static_cast<const bf16*>(bias);
  const bf16* w_p = static_cast<const bf16*>(w_hh);
  bf16* out_p = static_cast<bf16*>(out);
  float* c_p = static_cast<float*>(c_buf);
  unsigned* counter_p = static_cast<unsigned*>(counter);
  void* args[] = {&xp_p,      &bias_p, &w_p,   &out_p, &c_p,
                  &counter_p, &n,      &t_len, &hdim,  &rows_per_block};
  // refused (cudaErrorCooperativeLaunchTooLarge) unless every block fits on
  // the card at once
  return cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(lstm_persistent_kernel<kStages, kCInSmem>),
      dim3(blocks), dim3(kThreads), args, (size_t)smem_bytes, stream);
}

}  // namespace

extern "C" {

// blocks = (H / 16) * ceil(N / rows_per_block); stages: of the h ring;
// bias: bf16 [4H], added to xp (x @ W_ih without it) in bf16; c_buf: null
// (c in shared memory) or an f32 [N, H] scratch; counter: one zeroed u32
// per row group
int lstm_scan_launch(const void* xp, const void* bias, const void* w_hh,
                     void* out, void* c_buf, void* counter, int n, int t_len,
                     int hdim, int blocks, int rows_per_block, int stages,
                     int smem_bytes, void* stream) {
  if (bias == nullptr || n < 1 || t_len < 1 || hdim < kDepth ||
      hdim % kDepth || hdim % kUnits || rows_per_block < 1)
    return (int)cudaErrorInvalidValue;
  const int groups = (n + rows_per_block - 1) / rows_per_block;
  if (blocks != (hdim / kUnits) * groups ||
      smem_bytes != smem_bytes_for(hdim, rows_per_block, stages,
                                   c_buf == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
#define K8_LAUNCH(S)                                                     \
  case S:                                                                \
    err = c_buf == nullptr                                               \
        ? launch<S, true>(xp, bias, w_hh, out, c_buf, counter, n, t_len, \
                          hdim, blocks, rows_per_block, smem_bytes, s)   \
        : launch<S, false>(xp, bias, w_hh, out, c_buf, counter, n, t_len,\
                           hdim, blocks, rows_per_block, smem_bytes, s); \
    break;
  switch (stages) {
    K8_LAUNCH(3)
    K8_LAUNCH(4)
    K8_LAUNCH(5)
    K8_LAUNCH(6)
    K8_LAUNCH(7)
    K8_LAUNCH(8)
  }
#undef K8_LAUNCH
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

const char* lstm_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
