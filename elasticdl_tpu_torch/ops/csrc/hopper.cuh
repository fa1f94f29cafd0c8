// Hopper (sm_90a) building blocks for the port's warp-specialised kernels:
// mbarriers, TMA tile loads, cp.async into an mbarrier, wgmma on
// 128-byte-swizzled shared tiles, named barriers, the ring of stages that
// a producer warp fills for consumer warpgroups, and the host-side
// encoding of TMA tensor maps.  Used by flash_attention.cu (the bf16
// D = 64 forward) and flash_attention_bwd.cu (the bf16 D = 64 backward).
//
// Shared tiles are rows of exactly 128 bytes (64 bf16) that TMA writes
// with CU_TENSOR_MAP_SWIZZLE_128B: the 16-byte chunk c of row r lands at
// chunk c ^ (r % 8).  wgmma reads them through descriptors of the same
// swizzle (layout type 1); both apply the XOR to address bits, so every
// tile starts on a 1024-byte boundary (8 rows).

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers ------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA) and to
// the other threads; follow it with __syncthreads().
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces `bytes` of TMA traffic for this phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Waits until the phase of parity `parity` has completed.  Every wait of
// these kernels ends within microseconds, so one that polls 2^24 times is a
// deadlock: it traps (a launch failure) rather than hold the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0, polls = 0;
  do {
    if (++polls == (1u << 24)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// ---- TMA ------------------------------------------------------------------

// One box of a 4-D map (coordinates innermost first) into shared memory;
// completion is counted on `bar` in bytes.  Out-of-bounds elements are
// written as zeros and counted too.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// 16 bytes from global into shared memory by cp.async; `bytes` 0 reads
// nothing and writes zeros.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// One arrival on `bar` once every cp.async this thread issued before it has
// landed; it counts among the barrier's expected arrivals.
__device__ __forceinline__ void cp_async_mbar_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// 2^x on the MUFU unit; subnormal results flush to zero.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---- warpgroups -----------------------------------------------------------

constexpr int kWgThreads = 128;

// Barrier `id` (1-15; 0 is __syncthreads) over `threads` threads.
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// The calling threads' arrival on barrier `id` without waiting: they count
// among its `threads`, and the threads that named_barrier() on it go on
// once all have come.
__device__ __forceinline__ void named_barrier_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// The calling thread's warpgroup, as a value the compiler can see is the
// same across the warp, as the role branches around the warp-collective
// wgmma and barrier instructions are.
__device__ __forceinline__ int warpgroup_index() {
  return __shfl_sync(0xffffffffu, threadIdx.x / kWgThreads, 0);
}

// ---- a ring of stages -----------------------------------------------------
//
// A producer warp fills a ring of shared-memory stages for consumer
// warpgroups; each stage has a full barrier (the producer's TMA bytes) and
// an empty one (one arrival per consumer warp).

// Swizzled tiles start on 1024-byte boundaries.
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// A consumer warp's arrival on a stage's empty barrier, once all its lanes
// are done with the stage: one arrival per warp.
__device__ __forceinline__ void warp_release(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// The ring's position, shared by the producer's and each consumer's walk.
template <int kStages>
struct Ring {
  int stage = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void advance() {
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// ---- wgmma ----------------------------------------------------------------

// Descriptor of a shared tile of 128-byte rows with the 128-byte swizzle:
// stride 1024 bytes between groups of 8 rows (SBO), leading offset unused
// for a 64-wide extent.  The same descriptor serves a K-major operand (rows
// are M or N, a 16-deep k-step is +32 bytes: add 2) and an MN-major one
// (rows are K, a k-step is 16 rows, +2048 bytes: add 128).
__device__ __forceinline__ uint64_t desc_sw128(const void* tile) {
  return static_cast<uint64_t>((smem_u32(tile) & 0x3FFFF) >> 4) |
         (1ull << 16) | (64ull << 32) | (1ull << 62);
}
constexpr uint64_t kDescKStepKMajor = 2;     // 32 bytes >> 4
constexpr uint64_t kDescKStepMNMajor = 128;  // 16 rows x 128 bytes >> 4

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of registers that an
// in-flight wgmma owns across this point.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

#define EDL_WGMMA_D32                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "     \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, " \
  "%29, %30, %31}"
#define EDL_WGMMA_OUT32(d)                                                  \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])

// d (64 x 64 f32, this warpgroup's accumulator) = a b^T (+ d when
// `accumulate`): a 64 x 16 and b 64 x 16 bf16, both K-major in shared
// memory.  Thread layout of d: warp w holds rows 16 w .. 16 w + 15; lane
// L holds, for each 8-column group j, d[4j], d[4j+1] at row L/4, columns
// 8j + 2(L%4) + {0, 1}, and d[4j+2], d[4j+3] at row L/4 + 8.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a,
                                         uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " EDL_WGMMA_D32
      ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : EDL_WGMMA_OUT32(d)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 x 64 f32) += a b: a 64 x 16 bf16 from registers (the m16n8k16 A
// fragment of each warp's 16 rows, see pack_acc_a), b 16 x 64 bf16 in
// shared memory, MN-major (its 16 rows of 64 contiguous columns).
__device__ __forceinline__ void wgmma_rs_mn(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " EDL_WGMMA_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : EDL_WGMMA_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

#undef EDL_WGMMA_D32
#undef EDL_WGMMA_OUT32

// The A fragments of a 64 x 64 accumulator (rows M, columns the next
// product's K), each element rounded to bf16: k-step kk takes columns
// 16 kk .. 16 kk + 15, which are exactly accumulator registers 8 kk ..
// 8 kk + 7 in the order the A operand wants them.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ void pack_acc_a(uint32_t (&a)[4][4],
                                           const float (&d)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[kk][i] = pack_bf16x2(d[8 * kk + 2 * i], d[8 * kk + 2 * i + 1]);
}

// ---- host: tensor maps ----------------------------------------------------

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                   cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle,
                                   CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the CUDA driver, fetched through the runtime
// so the library links nothing beyond it; null when the driver lacks it.
inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &status) != cudaSuccess ||
        status != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// A map over bf16 rows [B, H, T, 64] with element strides (b, h, t) (the
// last dim contiguous), read in 64 x 64 boxes with the 128-byte swizzle;
// rows at or past T read as zeros.  Returns false if the CUDA driver
// refuses.
inline bool encode_rows_bf16(CUtensorMap* map, const void* base, long long sb,
                             long long sh, long long st, int B, int H, int T) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {64, (cuuint64_t)T, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st * 2, (cuuint64_t)sh * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, 64, 1, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hopper
