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
// take ~3 us. So it is bound by reading its inputs once.
//
// What the design does about it. The TPU kernel holds 8 whole samples
// (~1 MB each) in VMEM. A Hopper block cannot, so one block streams one
// sample's rows, reading every input exactly once:
//   phase 1  C: cq sits in shared memory; warp w takes regions l = w, w+8,
//            ..., reads the cv row once (bf16 pairs, coalesced) and reduces
//            the T dot products across the warp; C [T, L] (rounded to bf16)
//            stays in shared memory.
//   phase 2  each thread owns a pair of columns e and keeps que_w[:, e] and
//            the Hq accumulators sum_l C[t,l] img_w[l,e] in registers. One
//            pass down the img_w rows then gives every Hv row (never
//            stored: only its logit Hv[l,:] . whv is needed, reduced across
//            the warp per row and across the 8 warps after the pass) and
//            the Hq accumulators; Hq's logits follow from the registers.
//   phase 3  the two softmaxes, in shared memory.
//   phase 4  one pass down the img and que rows for the two pools.
// Scalar f32 FMAs throughout: the 13 MFLOP are small beside the read, and
// a first kernel that is right comes before a tensor-core one.
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
constexpr int kPassCols = 2 * kThreads;  // columns per phase-2 pass
constexpr int kMaxT = 32;
constexpr int kMaxL = 1024;
constexpr int kMaxSmem = 232448;  // 227 KB, the opt-in limit of a block

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

// shared memory, in floats then bf16: c [T][L], svp [L][kWarps],
// sqp [T][kWarps], av [L], aq [T], red [kWarps]; cq [T][E] bf16
__host__ __device__ inline size_t smem_floats(int l, int t) {
  return (size_t)t * l + (size_t)l * kWarps + (size_t)t * kWarps + l + t +
         kWarps;
}

__host__ __device__ inline size_t smem_bytes(int l, int t, int e) {
  return smem_floats(l, t) * 4 + (size_t)t * e * 2;
}

template <int TM>  // TM >= T: the register arrays are sized by it
__global__ void __launch_bounds__(kThreads)
    coattention_kernel(const bf16* __restrict__ img,    // [N, L, E]
                       const bf16* __restrict__ que,    // [N, T, E]
                       const bf16* __restrict__ cv,     // [N, L, E]
                       const bf16* __restrict__ cq,     // [N, T, E]
                       const bf16* __restrict__ img_w,  // [N, L, E]
                       const bf16* __restrict__ que_w,  // [N, T, E]
                       const bf16* __restrict__ whv,    // [E]
                       const bf16* __restrict__ whq,    // [E]
                       float* __restrict__ v_out,       // [N, E]
                       float* __restrict__ q_out,       // [N, E]
                       float* __restrict__ av_out,      // [N, L]
                       float* __restrict__ aq_out,      // [N, T]
                       int l, int t, int e) {
  extern __shared__ __align__(16) float smem[];
  float* c_s = smem;                      // [T][L]
  float* svp_s = c_s + (size_t)t * l;     // [L][kWarps]
  float* sqp_s = svp_s + (size_t)l * kWarps;  // [T][kWarps]
  float* av_s = sqp_s + (size_t)t * kWarps;   // [L]
  float* aq_s = av_s + l;                 // [T]
  float* red_s = aq_s + t;                // [kWarps]
  bf16* cq_s = reinterpret_cast<bf16*>(red_s + kWarps);  // [T][E]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t n = blockIdx.x;
  const bf16* img_n = img + n * l * e;
  const bf16* cv_n = cv + n * l * e;
  const bf16* imgw_n = img_w + n * l * e;
  const bf16* que_n = que + n * t * e;
  const bf16* cq_n = cq + n * t * e;
  const bf16* quew_n = que_w + n * t * e;

  for (int i = tid; i < t * e / 2; i += kThreads)
    reinterpret_cast<bf16x2*>(cq_s)[i] =
        reinterpret_cast<const bf16x2*>(cq_n)[i];
  for (int i = tid; i < l * kWarps; i += kThreads) svp_s[i] = 0.0f;
  for (int i = tid; i < t * kWarps; i += kThreads) sqp_s[i] = 0.0f;
  __syncthreads();

  // phase 1: C[t, l] = bf16(tanh(cq[t] . cv[l])), one warp per region
  for (int r = warp; r < l; r += kWarps) {
    float acc[TM];
#pragma unroll
    for (int tt = 0; tt < TM; ++tt) acc[tt] = 0.0f;
    const bf16* row = cv_n + (size_t)r * e;
    for (int c = 2 * lane; c < e; c += 64) {
      const float2 x = load2(row + c);
#pragma unroll
      for (int tt = 0; tt < TM; ++tt)
        if (tt < t) {
          const float2 y = load2(cq_s + (size_t)tt * e + c);
          acc[tt] += y.x * x.x + y.y * x.y;
        }
    }
#pragma unroll
    for (int tt = 0; tt < TM; ++tt)
      if (tt < t) {
        const float s = warp_sum(acc[tt]);
        if (lane == 0) c_s[(size_t)tt * l + r] = round_bf16(tanhf(s));
      }
  }
  __syncthreads();

  // phase 2: per pass of kPassCols columns, one pass down the img_w rows
  for (int p0 = 0; p0 < e; p0 += kPassCols) {
    const int c = p0 + 2 * tid;
    const bool on = c < e;  // e is even: c + 1 < e too
    float qw[TM][2], hq_acc[TM][2];
#pragma unroll
    for (int tt = 0; tt < TM; ++tt) {
      float2 y = make_float2(0.0f, 0.0f);
      if (on && tt < t) y = load2(quew_n + (size_t)tt * e + c);
      qw[tt][0] = y.x;
      qw[tt][1] = y.y;
      hq_acc[tt][0] = 0.0f;
      hq_acc[tt][1] = 0.0f;
    }
    const float2 wv = on ? load2(whv + c) : make_float2(0.0f, 0.0f);
    for (int r = 0; r < l; ++r) {
      const float2 iw =
          on ? load2(imgw_n + (size_t)r * e + c) : make_float2(0.0f, 0.0f);
      float h0 = 0.0f, h1 = 0.0f;
#pragma unroll
      for (int tt = 0; tt < TM; ++tt)
        if (tt < t) {
          const float ct = c_s[(size_t)tt * l + r];
          h0 += ct * qw[tt][0];
          h1 += ct * qw[tt][1];
          hq_acc[tt][0] += ct * iw.x;
          hq_acc[tt][1] += ct * iw.y;
        }
      const float hv0 = round_bf16(tanhf(iw.x + h0));
      const float hv1 = round_bf16(tanhf(iw.y + h1));
      const float part = warp_sum(on ? hv0 * wv.x + hv1 * wv.y : 0.0f);
      if (lane == 0) svp_s[(size_t)r * kWarps + warp] += part;
    }
    const float2 wq = on ? load2(whq + c) : make_float2(0.0f, 0.0f);
#pragma unroll
    for (int tt = 0; tt < TM; ++tt)
      if (tt < t) {
        const float hq0 = round_bf16(tanhf(qw[tt][0] + hq_acc[tt][0]));
        const float hq1 = round_bf16(tanhf(qw[tt][1] + hq_acc[tt][1]));
        const float part = warp_sum(on ? hq0 * wq.x + hq1 * wq.y : 0.0f);
        if (lane == 0) sqp_s[tt * kWarps + warp] += part;
      }
  }
  __syncthreads();

  // phase 3: logits (the 8 warp partials in a fixed order), softmaxes
  for (int r = tid; r < l; r += kThreads) {
    float s = 0.0f;
    for (int w = 0; w < kWarps; ++w) s += svp_s[(size_t)r * kWarps + w];
    av_s[r] = s;
  }
  for (int tt = tid; tt < t; tt += kThreads) {
    float s = 0.0f;
    for (int w = 0; w < kWarps; ++w) s += sqp_s[tt * kWarps + w];
    aq_s[tt] = s;
  }
  __syncthreads();
  block_softmax(av_s, l, red_s);
  block_softmax(aq_s, t, red_s);
  for (int r = tid; r < l; r += kThreads) av_out[n * l + r] = av_s[r];
  for (int tt = tid; tt < t; tt += kThreads) aq_out[n * t + tt] = aq_s[tt];

  // phase 4: v = av^T img, q = aq^T que
  for (int c = 2 * tid; c < e; c += kPassCols) {
    float v0 = 0.0f, v1 = 0.0f;
    for (int r = 0; r < l; ++r) {
      const float2 x = load2(img_n + (size_t)r * e + c);
      v0 += av_s[r] * x.x;
      v1 += av_s[r] * x.y;
    }
    float q0 = 0.0f, q1 = 0.0f;
    for (int tt = 0; tt < t; ++tt) {
      const float2 x = load2(que_n + (size_t)tt * e + c);
      q0 += aq_s[tt] * x.x;
      q1 += aq_s[tt] * x.y;
    }
    v_out[n * e + c] = v0;
    v_out[n * e + c + 1] = v1;
    q_out[n * e + c] = q0;
    q_out[n * e + c + 1] = q1;
  }
}

template <int TM>
int launch(const void* const* in, void* const* out, int n, int l, int t,
           int e, cudaStream_t s) {
  const size_t smem = smem_bytes(l, t, e);
  cudaError_t err = cudaFuncSetAttribute(
      coattention_kernel<TM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  coattention_kernel<TM><<<n, kThreads, smem, s>>>(
      static_cast<const bf16*>(in[0]), static_cast<const bf16*>(in[1]),
      static_cast<const bf16*>(in[2]), static_cast<const bf16*>(in[3]),
      static_cast<const bf16*>(in[4]), static_cast<const bf16*>(in[5]),
      static_cast<const bf16*>(in[6]), static_cast<const bf16*>(in[7]),
      static_cast<float*>(out[0]), static_cast<float*>(out[1]),
      static_cast<float*>(out[2]), static_cast<float*>(out[3]), l, t, e);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int coattention_launch(const void* img, const void* que, const void* cv,
                       const void* cq, const void* img_w, const void* que_w,
                       const void* whv, const void* whq, void* v, void* q,
                       void* av, void* aq, int n, int l, int t, int e,
                       void* stream) {
  if (n < 1 || l < 1 || l > kMaxL || t < 1 || t > kMaxT || e < 2 || e % 2 ||
      smem_bytes(l, t, e) > (size_t)kMaxSmem)
    return (int)cudaErrorInvalidValue;
  const void* in[8] = {img, que, cv, cq, img_w, que_w, whv, whq};
  void* out[4] = {v, q, av, aq};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (t <= 8) return launch<8>(in, out, n, l, t, e, s);
  if (t <= 16) return launch<16>(in, out, n, l, t, e, s);
  if (t <= 24) return launch<24>(in, out, n, l, t, e, s);
  return launch<32>(in, out, n, l, t, e, s);
}

const char* coattention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
