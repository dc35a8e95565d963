// The parallel co-attention core of hieCoAtten, bf16 inference,
// hand-written for Hopper (sm_90a).
//
// Replaces coattention_core_pallas (vqa_attention_networks_tpu/ops/
// pallas_coattention.py). Per sample n, with img, cv, img_w [L, E] and que,
// cq, que_w [T, E] in bf16:
//
//   C[t,l]  = bf16(tanh(sum_e cq[t,e] cv[l,e]))                  f32 sum
//   Hv[l,e] = bf16(tanh(img_w[l,e] + sum_t C[t,l] que_w[t,e]))
//   Hq[t,e] = bf16(tanh(que_w[t,e] + sum_l C[t,l] img_w[l,e]))
//   av      = softmax over l of sum_e Hv[l,e] whv[e]             f32
//   aq      = softmax over t of sum_e Hq[t,e] whq[e]             f32
//   v[e]    = sum_l av[l] img[l,e],  q[e] = sum_t aq[t] que[t,e] f32
//
// (the biases of fc_Whv / fc_Whq shift every logit of a softmax alike and
// are dropped, as in the TPU kernel).
//
// What bounds it on this card. At L=196, T=22, E=512 a sample is 13 MFLOP
// of products against 0.67 MB of bf16 inputs (img, cv, img_w 196x512 each,
// and the three 22x512 question tensors): 172 MB at N=256, which the
// memory reads in ~51 us, while the products on the tensor cores would
// take ~3 us. So it is bound by reading its inputs once, and the design
// has to keep enough bytes in flight on every SM through all of a
// sample's phases, with the products and the ~0.1 M tanh of a sample off
// the loads' critical path.
//
// The design. One block (8 warps) per sample, two blocks an SM (94 KB of
// shared memory and at most 128 registers a thread at L=196), so N=256 is
// one wave. A block walks one sequence of ring steps through a 4-stage
// cp.async ring (16-byte copies, zero-filled past L, T and E; 4-byte
// copies where E % 8 != 0 or an input is not 16-byte aligned). A step
// stages two tiles of 32 rows x 128 columns: a question tile (cq, que_w or
// que: rows t, zero past T, so T is padded to 32) and a region tile (cv,
// img_w or img: 32 rows l of the sample). Every product runs on the tensor
// cores (mma.sync m16n8k16, bf16 in, each product from zero and added to
// its f32 sum by a round-to-nearest add, fragments by ldmatrix from
// rows padded to 272 bytes, which no ldmatrix reads with a conflict):
//   phase 1  C: per 32-row chunk of cv, over the 128-column slices of E,
//            warp w owns the 16x8 tile (t rows 16(w/4).., l cols 8(w%4)..)
//            of C[:, chunk]; after the last slice bf16(tanh) goes to shared
//            memory, C [32, L] (rows past T and columns past L exactly 0,
//            since their inputs were zero-filled: they add nothing below).
//   phase 2  per 128-column slice of E, one pass down the img_w chunks:
//            warp w owns 16 columns. Hv[chunk] = C[:, chunk]^T que_w is a
//            [32 l, 16 e] product (K = 32 t); img_w is added from the staged
//            tile, then tanh, bf16 and the dot with whv, so only each row's
//            logit partial leaves the registers (a quad shuffle, then one
//            slot per (row, warp) in shared memory: Hv never leaves the
//            SM). From the same staged tile Hq's [32 t, 16 e] accumulators
//            += C[:, chunk] img_w[chunk] (K = 32 l), kept in registers over
//            the pass; after the last chunk, tanh(que_w + acc), bf16, and
//            the dot with whq, likewise.
//   phase 3  the logits (each row's warp partials, slices in order, warps
//            in order), then the two softmaxes, in shared memory.
//   phase 4  per slice, one pass down the img chunks (and the que tile):
//            4 row groups x 64 column pairs, each thread summing av[l]
//            img[l, e] over its rows, then the 4 groups in order.
// The ring runs on across the phases, so phase 4's first tiles load while
// the softmaxes run. Every sum has a fixed order and there are no atomics:
// reruns give the same bits.
//
// The C interface takes raw device pointers and the stream; the launch is
// followed by cudaGetLastError(), whose code is returned (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf16x2;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxT = 32;        // T is padded to 32 rows (two m16 tiles)
constexpr int kMaxL = 1024;
constexpr int kRows = 32;        // rows of a tile: t, or l of one chunk
constexpr int kCols = 128;       // columns of E in a slice
constexpr int kLd = kCols + 8;   // 272-byte rows: ldmatrix conflict-free
constexpr int kTile = kRows * kLd;  // elements of one staged tile
constexpr int kStages = 4;
constexpr int kGroups = kThreads / (kCols / 2);  // phase 4's row groups
constexpr int kMaxSmem = 232448;  // 227 KB, the opt-in limit of a block

static_assert(kWarps * 16 == kCols, "phase 2: 16 columns a warp");
static_assert(kGroups * 8 == kRows, "phase 4: 8 rows a group");

// L padded to whole 32-row chunks
__host__ __device__ inline int padded_l(int l) {
  return (l + kRows - 1) / kRows * kRows;
}

// floats of the region that holds svp [Lp][kWarps] (phases 2 and 3),
// then pool [2][kGroups][kCols] (phase 4)
__host__ __device__ inline int part_floats(int lp) {
  return lp * kWarps > 2 * kGroups * kCols ? lp * kWarps
                                           : 2 * kGroups * kCols;
}

// shared memory, in bytes: the ring (a question and a region tile a
// stage), C [32][Lp + 8] bf16, then in f32: svp / pool, sqp [32][kWarps],
// av [Lp], aq [32], red [kWarps]
__host__ __device__ inline size_t smem_bytes(int l) {
  const int lp = padded_l(l);
  return (size_t)kStages * 2 * kTile * 2 + (size_t)kMaxT * (lp + 8) * 2 +
         4 * ((size_t)part_floats(lp) + kMaxT * kWarps + lp + kMaxT +
              kWarps);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const bf16x2*>(p));
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

// the sum over the 4 lanes of a quad (the lanes that share a fragment row)
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// VEC bytes global -> shared, or zeros where src_bytes is 0
template <int VEC>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (VEC == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(src_bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                 "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most kPending of the newest commit groups are in flight
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// 8x8 bf16 matrices from shared memory: lane i gives the row address of
// matrix i / 8, row i % 8; .trans hands each thread the transpose
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void ldsm_x2(uint32_t& r0, uint32_t& r1,
                                        const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(s));
}

// d += a (16x16, row-major) @ b (16x8, column-major), bf16 in, f32 sums.
// d[0], d[1]: row lane/4, columns 2 (lane%4) + 0, 1; d[2], d[3]: row + 8.
// The product starts from zero and is added to d by one f32 add rounded
// to nearest. Chained on d inside the tensor cores instead (C sums 32
// mma.sync over E = 512, Hq 14 over L = 196), the outputs' mean error
// against an f64 version with the same rounding points was 2.5x the plain
// version's (geometric mean over 5 seeds at N = 256 on an H100); this way
// it is 0.85x, at 4% more time (PERF.md section 6, k4_precision.py).
__device__ __forceinline__ void mma_16816(float (&d)[4],
                                          const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  float p[4];
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(p[0]), "=f"(p[1]), "=f"(p[2]), "=f"(p[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.0f));
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] = __fadd_rn(d[i], p[i]);
}

// In place over x[0:p): the softmax, with the block's kThreads threads.
// red holds kWarps floats. Every thread calls it.
__device__ void block_softmax(float* x, int p, float* red) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float m = -INFINITY;
  for (int i = tid; i < p; i += kThreads) m = fmaxf(m, x[i]);
  m = warp_max(m);
  if (lane == 0) red[warp] = m;
  __syncthreads();
  m = red[0];
  for (int w = 1; w < kWarps; ++w) m = fmaxf(m, red[w]);
  __syncthreads();
  float s = 0.0f;
  for (int i = tid; i < p; i += kThreads) {
    const float ex = expf(x[i] - m);
    x[i] = ex;
    s += ex;
  }
  s = warp_sum(s);
  if (lane == 0) red[warp] = s;
  __syncthreads();
  s = 0.0f;
  for (int w = 0; w < kWarps; ++w) s += red[w];  // a fixed order
  for (int i = tid; i < p; i += kThreads) x[i] = x[i] / s;
  __syncthreads();
}

struct Inputs {
  const bf16* img;    // [N, L, E]
  const bf16* que;    // [N, T, E]
  const bf16* cv;     // [N, L, E]
  const bf16* cq;     // [N, T, E]
  const bf16* img_w;  // [N, L, E]
  const bf16* que_w;  // [N, T, E]
  const bf16* whv;    // [E]
  const bf16* whq;    // [E]
};

// One [32, 128] tile of a [rows, e] matrix, rows r0.. and columns c0..,
// into dst (rows of kLd), zero-filled past `rows` and e
template <int VEC>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          int r0, int rows, int c0, int e) {
  constexpr int kPer = VEC / 2;             // elements a copy
  constexpr int kRowCopies = kCols / kPer;  // copies a row
  for (int i = threadIdx.x; i < kRows * kRowCopies; i += kThreads) {
    const int r = i / kRowCopies, c = (i % kRowCopies) * kPer;
    // e % kPer == 0: a copy is wholly inside or wholly past E
    const bool in = r < rows && c0 + c < e;
    const bf16* p = in ? src + (size_t)(r0 + r) * e + c0 + c : src;
    cp_async<VEC>(dst + r * kLd + c, p, in ? VEC : 0);
  }
}

template <int VEC>
__global__ void __launch_bounds__(kThreads, 2)
    coattention_kernel(Inputs in, float* __restrict__ v_out,   // [N, E]
                       float* __restrict__ q_out,              // [N, E]
                       float* __restrict__ av_out,             // [N, L]
                       float* __restrict__ aq_out,             // [N, T]
                       int l, int t, int e) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lp = padded_l(l), ldc = lp + 8;
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  bf16* c_s = ring + kStages * 2 * kTile;            // [32][ldc]
  float* svp_s = reinterpret_cast<float*>(c_s + kMaxT * ldc);  // [lp][8]
  float* pool_s = svp_s;  // [2][kGroups][kCols], once the logits are read
  float* sqp_s = svp_s + part_floats(lp);            // [32][8]
  float* av_s = sqp_s + kMaxT * kWarps;              // [lp]
  float* aq_s = av_s + lp;                           // [32]
  float* red_s = aq_s + kMaxT;                       // [8]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const size_t n = blockIdx.x;
  const size_t big = n * l * e, small = n * t * e;
  const int chunks = lp / kRows;
  const int slices = (e + kCols - 1) / kCols;
  const int per_phase = chunks * slices;
  const int steps = 3 * per_phase;

  // ring step s: phase 1 (s < per_phase) walks the chunks, each over the
  // slices; phases 2 and 4 walk the slices, each over the chunks
  auto where = [&](int s, int& phase, int& chunk, int& slice) {
    phase = s / per_phase;
    const int r = s % per_phase;
    if (phase == 0) {
      chunk = r / slices;
      slice = r % slices;
    } else {
      slice = r / chunks;
      chunk = r % chunks;
    }
  };
  auto issue = [&](int s) {
    if (s < steps) {
      int phase, chunk, slice;
      where(s, phase, chunk, slice);
      bf16* qt = ring + (s % kStages) * 2 * kTile;
      const bf16* qsrc = phase == 0 ? in.cq : phase == 1 ? in.que_w : in.que;
      const bf16* rsrc = phase == 0 ? in.cv : phase == 1 ? in.img_w : in.img;
      // phase 4 reads the que tile at a slice's first chunk only
      if (phase < 2 || chunk == 0)
        load_tile<VEC>(qt, qsrc + small, 0, t, slice * kCols, e);
      load_tile<VEC>(qt + kTile, rsrc + big, chunk * kRows,
                     min(kRows, l - chunk * kRows), slice * kCols, e);
    }
    cp_async_commit();  // an empty group past the last step keeps count
  };

  for (int s = 0; s < kStages - 1; ++s) issue(s);

  float acc_c[4];          // phase 1: the warp's C tile
  float acc_hq[2][2][4];   // phase 2: Hq [32 t, 16 e] over a pass
  float wv[2][2], wq[2][2];  // phase 2: whv, whq at the thread's columns
  float pv[2], pq[2];      // phase 4: v and q at the thread's column pair
  const int cp2 = 2 * (tid % (kCols / 2)), grp = tid / (kCols / 2);

  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    issue(s + kStages - 1);
    int phase, chunk, slice;
    where(s, phase, chunk, slice);
    const bf16* qt = ring + (s % kStages) * 2 * kTile;
    const bf16* rt = qt + kTile;
    const int c0 = slice * kCols;

    if (phase == 0) {
      // C[:, chunk] = cq . cv[chunk]^T over this slice of E
      const int mi = warp / 4, ni = warp % 4;
      if (slice == 0)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc_c[i] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < kCols / 16; ++kk) {
        uint32_t a[4], b0, b1;
        ldsm_x4(a, qt + (16 * mi + (lane & 15)) * kLd + 16 * kk +
                       (lane >> 4) * 8);
        ldsm_x2(b0, b1, rt + (8 * ni + (lane & 7)) * kLd + 16 * kk +
                            ((lane >> 3) & 1) * 8);
        mma_16816(acc_c, a, b0, b1);
      }
      if (slice == slices - 1) {
        bf16* cr = c_s + (16 * mi + g) * ldc + chunk * kRows + 8 * ni +
                   2 * t4;
        *reinterpret_cast<bf16x2*>(cr) = __floats2bfloat162_rn(
            tanhf(acc_c[0]), tanhf(acc_c[1]));
        *reinterpret_cast<bf16x2*>(cr + 8 * ldc) = __floats2bfloat162_rn(
            tanhf(acc_c[2]), tanhf(acc_c[3]));
      }
    } else if (phase == 1) {
      const int col = 16 * warp;  // the warp's 16 columns of the slice
      if (chunk == 0) {
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 2; ++ni)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc_hq[mi][ni][i] = 0.0f;
#pragma unroll
        for (int ni = 0; ni < 2; ++ni)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int ce = c0 + col + 8 * ni + 2 * t4 + j;
            wv[ni][j] = ce < e ? __bfloat162float(in.whv[ce]) : 0.0f;
            wq[ni][j] = ce < e ? __bfloat162float(in.whq[ce]) : 0.0f;
          }
      }
      // Hv[chunk] = C[:, chunk]^T que_w: A = C^T (C is [t][l]: .trans),
      // B = que_w [t][e] (.trans)
      float hv[2][2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 2; ++ni)
#pragma unroll
          for (int i = 0; i < 4; ++i) hv[mi][ni][i] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t b[4];
        ldsm_x4_t(b, qt + (16 * kk + ((lane >> 3) & 1) * 8 + (lane & 7)) *
                              kLd + col + (lane >> 4) * 8);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          uint32_t a[4];
          ldsm_x4_t(a, c_s + (16 * kk + (lane >> 4) * 8 + (lane & 7)) * ldc +
                           chunk * kRows + 16 * mi + ((lane >> 3) & 1) * 8);
          mma_16816(hv[mi][0], a, b[0], b[1]);
          mma_16816(hv[mi][1], a, b[2], b[3]);
        }
      }
      // + img_w, tanh, bf16, . whv: each row's partial over the warp's 16
      // columns (the thread's 4 in order, then the quad)
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = 16 * mi + g + 8 * h;
          float p = 0.0f;
#pragma unroll
          for (int ni = 0; ni < 2; ++ni) {
            const float2 x = load2(rt + row * kLd + col + 8 * ni + 2 * t4);
            p = fmaf(round_bf16(tanhf(x.x + hv[mi][ni][2 * h])), wv[ni][0],
                     p);
            p = fmaf(round_bf16(tanhf(x.y + hv[mi][ni][2 * h + 1])),
                     wv[ni][1], p);
          }
          p = quad_sum(p);
          const int lr = chunk * kRows + row;
          if (t4 == 0 && lr < l) {
            float* slot = svp_s + lr * kWarps + warp;
            *slot = slice == 0 ? p : *slot + p;
          }
        }
      // Hq += C[:, chunk] img_w[chunk]: A = C [t][l], B = img_w [l][e]
      // (.trans)
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t b[4];
        ldsm_x4_t(b, rt + (16 * kk + ((lane >> 3) & 1) * 8 + (lane & 7)) *
                              kLd + col + (lane >> 4) * 8);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          uint32_t a[4];
          ldsm_x4(a, c_s + (16 * mi + (lane & 15)) * ldc + chunk * kRows +
                         16 * kk + (lane >> 4) * 8);
          mma_16816(acc_hq[mi][0], a, b[0], b[1]);
          mma_16816(acc_hq[mi][1], a, b[2], b[3]);
        }
      }
      if (chunk == chunks - 1) {
        // Hq = bf16(tanh(que_w + acc)) . whq, per row t as for Hv
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = 16 * mi + g + 8 * h;
            float p = 0.0f;
#pragma unroll
            for (int ni = 0; ni < 2; ++ni) {
              const float2 x = load2(qt + row * kLd + col + 8 * ni + 2 * t4);
              p = fmaf(round_bf16(tanhf(x.x + acc_hq[mi][ni][2 * h])),
                       wq[ni][0], p);
              p = fmaf(round_bf16(tanhf(x.y + acc_hq[mi][ni][2 * h + 1])),
                       wq[ni][1], p);
            }
            p = quad_sum(p);
            if (t4 == 0 && row < t) {
              float* slot = sqp_s + row * kWarps + warp;
              *slot = slice == 0 ? p : *slot + p;
            }
          }
      }
      if (s == 2 * per_phase - 1) {
        // phase 3: the logits (the warps' partials in order), softmaxes
        __syncthreads();
        for (int r = tid; r < lp; r += kThreads) {
          float sum = 0.0f;
          if (r < l)
            for (int w = 0; w < kWarps; ++w) sum += svp_s[r * kWarps + w];
          av_s[r] = sum;
        }
        for (int r = tid; r < kMaxT; r += kThreads) {
          float sum = 0.0f;
          if (r < t)
            for (int w = 0; w < kWarps; ++w) sum += sqp_s[r * kWarps + w];
          aq_s[r] = sum;
        }
        __syncthreads();
        block_softmax(av_s, l, red_s);
        block_softmax(aq_s, t, red_s);
        // av, aq are 0 past L, T (phase 4 multiplies zero-filled rows)
        for (int r = tid; r < l; r += kThreads) av_out[n * l + r] = av_s[r];
        for (int r = tid; r < t; r += kThreads) aq_out[n * t + r] = aq_s[r];
      }
    } else {
      // phase 4: v over this chunk's rows (8 a group) and, at the slice's
      // first chunk, q over the que tile's
      if (chunk == 0) {
        pv[0] = pv[1] = pq[0] = pq[1] = 0.0f;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int r = 8 * grp + i;
          const float2 x = load2(qt + r * kLd + cp2);
          pq[0] = fmaf(aq_s[r], x.x, pq[0]);
          pq[1] = fmaf(aq_s[r], x.y, pq[1]);
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = 8 * grp + i;
        const float a = av_s[chunk * kRows + r];
        const float2 x = load2(rt + r * kLd + cp2);
        pv[0] = fmaf(a, x.x, pv[0]);
        pv[1] = fmaf(a, x.y, pv[1]);
      }
      if (chunk == chunks - 1) {
        float* pool_v = pool_s + grp * kCols + cp2;
        float* pool_q = pool_v + kGroups * kCols;
        pool_v[0] = pv[0];
        pool_v[1] = pv[1];
        pool_q[0] = pq[0];
        pool_q[1] = pq[1];
        __syncthreads();
        // the groups in order: threads 0-127 v, 128-255 q
        const int which = tid / kCols, c = tid % kCols;
        const float* part = pool_s + which * kGroups * kCols + c;
        float sum = part[0];
        for (int gi = 1; gi < kGroups; ++gi) sum += part[gi * kCols];
        if (c0 + c < e) (which ? q_out : v_out)[n * e + c0 + c] = sum;
      }
    }
  }
  cp_async_wait<0>();
}

template <int VEC>
int launch(const Inputs& in, void* const* out, int n, int l, int t, int e,
           cudaStream_t s) {
  const size_t smem = smem_bytes(l);
  cudaError_t err = cudaFuncSetAttribute(
      coattention_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  coattention_kernel<VEC><<<n, kThreads, smem, s>>>(
      in, static_cast<float*>(out[0]), static_cast<float*>(out[1]),
      static_cast<float*>(out[2]), static_cast<float*>(out[3]), l, t, e);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

int coattention_launch(const void* img, const void* que, const void* cv,
                       const void* cq, const void* img_w, const void* que_w,
                       const void* whv, const void* whq, void* v, void* q,
                       void* av, void* aq, int n, int l, int t, int e,
                       void* stream) {
  if (n < 1 || l < 1 || l > kMaxL || t < 1 || t > kMaxT || e < 2 || e % 2 ||
      smem_bytes(l) > (size_t)kMaxSmem)
    return (int)cudaErrorInvalidValue;
  const Inputs in = {
      static_cast<const bf16*>(img),   static_cast<const bf16*>(que),
      static_cast<const bf16*>(cv),    static_cast<const bf16*>(cq),
      static_cast<const bf16*>(img_w), static_cast<const bf16*>(que_w),
      static_cast<const bf16*>(whv),   static_cast<const bf16*>(whq)};
  void* out[4] = {v, q, av, aq};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  // 16-byte copies where every row and input allows them
  if (e % 8 == 0 && aligned16(img) && aligned16(que) && aligned16(cv) &&
      aligned16(cq) && aligned16(img_w) && aligned16(que_w))
    return launch<16>(in, out, n, l, t, e, s);
  return launch<4>(in, out, n, l, t, e, s);
}

// the shared memory of a block at L = l, in bytes (ops/coattention.py
// holds the same reckoning for its gate; a card test compares the two)
int coattention_smem_bytes(int l) { return (int)smem_bytes(l); }

const char* coattention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
