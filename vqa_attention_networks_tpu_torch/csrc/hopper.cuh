// Hopper (sm_90a) building blocks shared by the port's pipelined kernels:
// mbarriers, TMA tile loads and stores, wgmma and its shared-memory
// descriptors, and the host-side tensor-map encoder.
//
// - mbarrier: a wait on a parity passes once the phase of that parity has
//   completed; a barrier starts in phase 0 and completes a phase when its
//   count of arrivals (and, for TMA, its expected bytes) has come in.
// - TMA: one thread asks for a whole box; the hardware fills the elements
//   outside the tensor with zeros and adds the box's full byte count to
//   the barrier's transaction count.
// - wgmma: a warpgroup (4 warps) starts an asynchronous m64nNk16 bf16
//   product with f32 accumulators in registers. The accumulator fragment
//   of warp w of the group, lane = 4 g + t: d[4i], d[4i+1] at row
//   16 w + g, columns 8 i + 2 t and + 1; d[4i+2], d[4i+3] at row
//   16 w + g + 8, the same columns. An A operand in registers takes the
//   m16n8k16 A fragment of the warp's 16 rows: a0 (row g, k = 2t, 2t+1),
//   a1 (row g + 8, same k), a2 (row g, k + 8), a3 (row g + 8, k + 8), two
//   bf16 a register, the lower k in the low half. With both operands in
//   shared memory, either may be MN-major (transposed: M or N contiguous,
//   bf16 only): Wgmma<N>::ss<kTransB, kTransA>.
// - Descriptors (PTX ISA, "matrix descriptor"): start address, leading and
//   stride byte offsets in 16-byte units, swizzle mode in bits 62-63. In a
//   K-major swizzled tile, SBO is the stride between groups of 8 rows and
//   LBO is unused; in an MN-major swizzled tile, LBO is the stride between
//   swizzle atoms along MN and SBO the stride between groups of 8 rows
//   along K. A tile's base is aligned to its swizzle atom (8 rows of the
//   swizzle width), as TMA writes it.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums: types only, nothing linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the first 1024-byte boundary at or after p: the alignment of a swizzle
// atom (8 rows of 128 B), which TMA and the descriptors assume
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// ---------------------------------------------------------------- mbarrier
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// make the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// the producer's arrival: expect `bytes` more from TMA in this phase. The
// one thread that arrives is chosen by a predicate (`leader`), not a
// branch, so that the caller's control flow stays uniform across its
// warpgroups: a branch taken by one thread makes the compiler serialise
// the wgmma pipeline.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes,
                                               bool leader) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %2, 0;\n"
      "@p mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n}\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes), "r"((uint32_t)leader)
      : "memory");
}

// a pipeline that waits ~10 s (2^34 cycles) on one phase has lost a
// producer or a consumer: trap, so that the launch fails instead of
// hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long start = clock64();
  uint32_t done = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > (1LL << 34)) __trap();
  }
}

// ---------------------------------------------------------------- TMA
// one box at coordinates (c0, c1[, c2]), requested by the thread whose
// `leader` is true
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            bool leader) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %5, 0;\n"
      "@p cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n}\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"((uint32_t)leader)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, bool leader) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "@p cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n}\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"((uint32_t)leader)
      : "memory");
}

// a box at coordinates (c0, c1, c2) from shared memory to the tensor,
// stored by the thread whose `leader` is true (elements outside the tensor
// are not written); it joins the thread's next bulk_commit group. Writes
// to `src` by the generic proxy must be fenced first (fence_proxy_async)
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2, bool leader) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %5, 0;\n"
      "@p cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, "
      "%3, %4}], [%1];\n}\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"((uint32_t)leader)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// the thread's bulk stores but the newest kPending have read their source
template <int kPending>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(kPending)
               : "memory");
}

// make the thread's shared-memory writes visible to the async proxy (TMA)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---------------------------------------------------------------- wgmma
enum Swizzle : uint64_t { kSwizzle128 = 1, kSwizzle64 = 2, kSwizzle32 = 3 };

__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo, Swizzle mode) {
  return (uint64_t)((smem_u32(p) >> 4) & 0x3FFF) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)mode << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}

// pin accumulators in place around the asynchronous products, so that no
// read of them moves above a wgmma_wait
template <int kN>
__device__ __forceinline__ void fence_operands(float (&d)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// barrier `id` (1..15) among `threads` threads (whole warps) of the block
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// The wgmma wrappers name each accumulator register in the instruction.
// One line below makes the specialisation for a width N: its R = N / 2
// accumulator registers in C chunks of 8 (C = N / 16; 12H is 12 and a
// half, for N = 200), then the numbers of the operands that follow the
// accumulators in the asm statement (R, R + 1, ...). HOPPER_ACC_NAMES_c
// lists the first 8 c registers' names, HOPPER_ACC_c their operands.
#define HOPPER_ACC8(i)                                                     \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),              \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define HOPPER_ACC_NAMES_1 "%0, %1, %2, %3, %4, %5, %6, %7"
#define HOPPER_ACC_NAMES_2 \
  HOPPER_ACC_NAMES_1 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define HOPPER_ACC_NAMES_3 \
  HOPPER_ACC_NAMES_2 ", %16, %17, %18, %19, %20, %21, %22, %23"
#define HOPPER_ACC_NAMES_4 \
  HOPPER_ACC_NAMES_3 ", %24, %25, %26, %27, %28, %29, %30, %31"
#define HOPPER_ACC_NAMES_5 \
  HOPPER_ACC_NAMES_4 ", %32, %33, %34, %35, %36, %37, %38, %39"
#define HOPPER_ACC_NAMES_6 \
  HOPPER_ACC_NAMES_5 ", %40, %41, %42, %43, %44, %45, %46, %47"
#define HOPPER_ACC_NAMES_7 \
  HOPPER_ACC_NAMES_6 ", %48, %49, %50, %51, %52, %53, %54, %55"
#define HOPPER_ACC_NAMES_8 \
  HOPPER_ACC_NAMES_7 ", %56, %57, %58, %59, %60, %61, %62, %63"
#define HOPPER_ACC_NAMES_9 \
  HOPPER_ACC_NAMES_8 ", %64, %65, %66, %67, %68, %69, %70, %71"
#define HOPPER_ACC_NAMES_10 \
  HOPPER_ACC_NAMES_9 ", %72, %73, %74, %75, %76, %77, %78, %79"
#define HOPPER_ACC_NAMES_11 \
  HOPPER_ACC_NAMES_10 ", %80, %81, %82, %83, %84, %85, %86, %87"
#define HOPPER_ACC_NAMES_12 \
  HOPPER_ACC_NAMES_11 ", %88, %89, %90, %91, %92, %93, %94, %95"
#define HOPPER_ACC_NAMES_12H HOPPER_ACC_NAMES_12 ", %96, %97, %98, %99"
#define HOPPER_ACC_NAMES_13 \
  HOPPER_ACC_NAMES_12 ", %96, %97, %98, %99, %100, %101, %102, %103"
#define HOPPER_ACC_NAMES_14 \
  HOPPER_ACC_NAMES_13 ", %104, %105, %106, %107, %108, %109, %110, %111"
#define HOPPER_ACC_NAMES_15 \
  HOPPER_ACC_NAMES_14 ", %112, %113, %114, %115, %116, %117, %118, %119"
#define HOPPER_ACC_NAMES_16 \
  HOPPER_ACC_NAMES_15 ", %120, %121, %122, %123, %124, %125, %126, %127"
#define HOPPER_ACC_1 HOPPER_ACC8(0)
#define HOPPER_ACC_2 HOPPER_ACC_1, HOPPER_ACC8(8)
#define HOPPER_ACC_3 HOPPER_ACC_2, HOPPER_ACC8(16)
#define HOPPER_ACC_4 HOPPER_ACC_3, HOPPER_ACC8(24)
#define HOPPER_ACC_5 HOPPER_ACC_4, HOPPER_ACC8(32)
#define HOPPER_ACC_6 HOPPER_ACC_5, HOPPER_ACC8(40)
#define HOPPER_ACC_7 HOPPER_ACC_6, HOPPER_ACC8(48)
#define HOPPER_ACC_8 HOPPER_ACC_7, HOPPER_ACC8(56)
#define HOPPER_ACC_9 HOPPER_ACC_8, HOPPER_ACC8(64)
#define HOPPER_ACC_10 HOPPER_ACC_9, HOPPER_ACC8(72)
#define HOPPER_ACC_11 HOPPER_ACC_10, HOPPER_ACC8(80)
#define HOPPER_ACC_12 HOPPER_ACC_11, HOPPER_ACC8(88)
#define HOPPER_ACC_12H \
  HOPPER_ACC_12, "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99])
#define HOPPER_ACC_13 HOPPER_ACC_12, HOPPER_ACC8(96)
#define HOPPER_ACC_14 HOPPER_ACC_13, HOPPER_ACC8(104)
#define HOPPER_ACC_15 HOPPER_ACC_14, HOPPER_ACC8(112)
#define HOPPER_ACC_16 HOPPER_ACC_15, HOPPER_ACC8(120)

template <int kN>
struct Wgmma;
template <int kN>
struct WgmmaRS;

// A and B from shared memory (descriptors a, b); operands after the
// accumulators: a, b, the scale-d flag, A's and B's transpose (1: MN-major,
// bf16 only)
#define HOPPER_WGMMA_SS(N, R, C, A, B, P, TA, TB)                          \
  template <>                                                              \
  struct Wgmma<N> {                                                        \
    template <int kTransB, int kTransA = 0>                                \
    __device__ static void ss(float (&d)[R], uint64_t a, uint64_t b) {     \
      asm volatile(                                                        \
          "{\n.reg .pred p;\nsetp.ne.b32 p, %" #P ", 0;\n"                 \
          "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {"     \
          HOPPER_ACC_NAMES_##C " }, %" #A ", %" #B ", p, 1, 1, %" #TA      \
          ", %" #TB ";\n}\n"                                               \
          : HOPPER_ACC_##C                                                 \
          : "l"(a), "l"(b), "r"(1), "n"(kTransA), "n"(kTransB));           \
    }                                                                      \
  };

// A from registers (the m16n8k16 A fragment, a[0..3]), B from shared
// memory; operands after the accumulators: a[0..3] from A0, b, the
// scale-d flag, B's transpose
#define HOPPER_WGMMA_RS(N, C, A0, A1, A2, A3, B, P, T)                     \
  template <>                                                              \
  struct WgmmaRS<N> {                                                      \
    template <int kTransB>                                                 \
    __device__ static void rs(float (&d)[8 * C], const uint32_t (&a)[4],   \
                              uint64_t b) {                                \
      asm volatile(                                                        \
          "{\n.reg .pred p;\nsetp.ne.b32 p, %" #P ", 0;\n"                 \
          "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {"     \
          HOPPER_ACC_NAMES_##C " }, {%" #A0 ", %" #A1 ", %" #A2 ", %" #A3  \
          "}, %" #B ", p, 1, 1, %" #T ";\n}\n"                             \
          : HOPPER_ACC_##C                                                 \
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1),    \
            "n"(kTransB));                                                 \
    }                                                                      \
  };

HOPPER_WGMMA_SS(16, 8, 1, 8, 9, 10, 11, 12)
HOPPER_WGMMA_SS(32, 16, 2, 16, 17, 18, 19, 20)
HOPPER_WGMMA_SS(64, 32, 4, 32, 33, 34, 35, 36)
HOPPER_WGMMA_SS(96, 48, 6, 48, 49, 50, 51, 52)
HOPPER_WGMMA_SS(128, 64, 8, 64, 65, 66, 67, 68)
HOPPER_WGMMA_SS(160, 80, 10, 80, 81, 82, 83, 84)
HOPPER_WGMMA_SS(192, 96, 12, 96, 97, 98, 99, 100)
HOPPER_WGMMA_SS(200, 100, 12H, 100, 101, 102, 103, 104)
HOPPER_WGMMA_SS(208, 104, 13, 104, 105, 106, 107, 108)
HOPPER_WGMMA_SS(224, 112, 14, 112, 113, 114, 115, 116)
HOPPER_WGMMA_SS(256, 128, 16, 128, 129, 130, 131, 132)
HOPPER_WGMMA_RS(64, 4, 32, 33, 34, 35, 36, 37, 38)
HOPPER_WGMMA_RS(128, 8, 64, 65, 66, 67, 68, 69, 70)
HOPPER_WGMMA_RS(208, 13, 104, 105, 106, 107, 108, 109, 110)

// ---------------------------------------------------------------- host
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded (the
// build links no libcuda); nullptr if the driver does not give it
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A tensor map of `rank` dims (innermost first: dims[0] is contiguous),
// strides in bytes of dims 1.. , boxes of `box` elements. Returns
// cudaSuccess or cudaErrorInvalidValue.
inline cudaError_t make_map(CUtensorMap* map, CUtensorMapDataType type,
                            int rank, const void* base,
                            const uint64_t* dims, const uint64_t* strides,
                            const uint32_t* box, CUtensorMapSwizzle swizzle) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorInvalidValue;
  cuuint64_t d[5], s[4];
  cuuint32_t b[5], e[5];
  for (int i = 0; i < rank; ++i) {
    d[i] = dims[i];
    b[i] = box[i];
    e[i] = 1;
    if (i + 1 < rank) s[i] = strides[i];
  }
  const CUresult r = encode(map, type, (cuuint32_t)rank,
                            const_cast<void*>(base), d, s, b, e,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace hopper
