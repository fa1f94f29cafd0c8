// Helpers shared by the flash attention kernels for Hopper (sm_90a):
// flash_attention.cu (the forward) and flash_attention_bwd.cu (the
// backward).  Tile geometry, the attention mask, cp.async tile loads,
// mma.sync m16n8k16 in bfloat16 and its fragment packing.
//
// Lane roles in an m16n8k16 fragment: g = lane / 4 owns rows g and g + 8,
// t = lane % 4 owns columns 2t and 2t + 1 (and 2t + 8, 2t + 9 of A).  An
// accumulator (C) tile of two neighbouring n-tiles holds exactly the
// elements of one A fragment, so a score tile goes from an accumulator to
// the next product's A operand in registers (pack_a).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

using bf16 = __nv_bfloat16;
constexpr int kStages = 2;        // streamed tiles in flight (bf16 paths)

constexpr int kBQ = 64;         // q rows per tile
constexpr int kBK = 64;         // keys per tile
constexpr int kWarps = 4;       // 16 rows each
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 16;       // rows per warp
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
static_assert(kBQ == kBK, "q, k and v tiles have one height");

// bf16 tiles: 16-byte rows, no bank conflicts for 32-bit fragment loads.
template <int D> constexpr int kPitchBf16 = D + 8;
// f32 tiles: lanes reading one column of consecutive rows hit distinct
// banks.
template <int D> constexpr int kPitchF32 = D + 1;

__host__ __device__ constexpr int align128(int bytes) {
  return (bytes + 127) / 128 * 128;
}

struct Strides {
  long long b, h, t;
};

// The key range a q tile starting at q0 attends: causal stops after the
// tile holding the last row's diagonal; a window starts at the tile
// holding the first row's band.  P carries T, causal and window.
template <typename P>
__device__ __forceinline__ void key_range(const P& prm, int q0, int* k_begin,
                                          int* k_end) {
  *k_begin = 0;
  *k_end = prm.T;
  if (prm.causal) {
    *k_end = min(prm.T, q0 + kBQ);
    if (prm.window > 0) *k_begin = max(0, q0 - prm.window + 1) / kBK * kBK;
  }
}

// True when every (query, key) pair of the q tile at q0 and the key tile at
// k0 is kept, so the tile needs no mask.
template <typename P>
__device__ __forceinline__ bool tile_unmasked(const P& prm, int q0, int k0) {
  if (k0 + kBK > prm.T || q0 + kBQ > prm.T) return false;
  if (!prm.causal) return true;
  if (k0 + kBK - 1 > q0) return false;
  return prm.window == 0 || q0 + kBQ - 1 - k0 < prm.window;
}

// Whether any (query, key) pair of the 64 queries at r0 and the 64 keys at
// c0 is kept; a tile with none is neither loaded for nor multiplied.
template <typename P>
__device__ __forceinline__ bool tile_live(const P& prm, int r0, int c0) {
  if (r0 >= prm.T || c0 >= prm.T) return false;
  if (!prm.causal) return true;
  if (c0 > r0 + kBQ - 1) return false;  // above the diagonal
  return prm.window == 0 || r0 - (c0 + kBK - 1) < prm.window;
}

// This block's (batch * head, rank) on a grid (heads, ranks), rank 0 the
// heaviest.  Blocks launch in groups of kGroup heads, each group's heads at
// rank 0 first, then rank 1, and so on: the heaviest go first within a
// group, and a group's streamed tiles (16 heads x 512 KB at T = 2048) stay
// in L2 while its blocks run, where heads outermost would reread them from
// memory.
template <int kGroup>
__device__ __forceinline__ void block_order(int* bh, int* rank) {
  const int heads = gridDim.x, ranks = gridDim.y;
  const int id = blockIdx.x + heads * blockIdx.y;  // launch order
  const int group = id / (kGroup * ranks);
  const int n = min(kGroup, heads - group * kGroup);
  const int rem = id - group * kGroup * ranks;
  *rank = rem / n;
  *bh = group * kGroup + rem % n;
}

// Whether query qi attends key kj; positions at or past T are never kept.
template <typename P>
__device__ __forceinline__ bool keep(const P& prm, int qi, int kj) {
  if (kj >= prm.T || qi >= prm.T) return false;
  if (!prm.causal) return true;
  return kj <= qi && (prm.window == 0 || qi - kj < prm.window);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Rows [r0, r0 + 64) of one (b, h) slice into a shared tile of pitch
// kPitchBf16<D>, 16 bytes per cp.async; rows at or past T are zero-filled
// (src-size 0 reads nothing), so a product with them is 0, never a NaN.
template <int D>
__device__ __forceinline__ void fetch_tile(bf16* dst, const bf16* src,
                                           long long row_stride, int r0,
                                           int Tlen) {
  constexpr int kPerRow = D / 8;
  constexpr int kPitch = kPitchBf16<D>;
  for (int i = threadIdx.x; i < kBQ * kPerRow; i += kThreads) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * 8;
    const bool in = r0 + r < Tlen;
    const bf16* g = src + (in ? (long long)(r0 + r) * row_stride + c : 0);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst + r * kPitch + c)),
                 "l"(g), "r"(in ? 16 : 0));
  }
}

// 64 floats from src[r0 ..] into dst, 4 bytes per cp.async; entries at or
// past T are zero.
__device__ __forceinline__ void fetch_row_stats(float* dst, const float* src,
                                                int r0, int Tlen) {
  for (int r = threadIdx.x; r < kBQ; r += kThreads) {
    const bool in = r0 + r < Tlen;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_addr(dst + r)),
                 "l"(src + (in ? r0 + r : 0)), "r"(in ? 4 : 0));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// c += a b for one m16n8k16 tile: a 16 x 16 bf16 (4 registers), b 16 x 8 bf16
// (2 registers), c 16 x 8 f32.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The A fragment of a 16 x 16 product from two accumulator n-tiles (columns
// 0-7 and 8-15), each element rounded to bf16.
__device__ __forceinline__ void pack_a(uint32_t* a, const float* c0,
                                       const float* c1) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// The A fragments of rows [0, 16) of a shared bf16 tile of pitch kPitch
// (row-major, 16 x D): D / 16 k-steps of 4 registers.
template <int D, int kPitch>
__device__ __forceinline__ void load_a(uint32_t (*a)[4], const bf16* tile,
                                       int lane) {
  const bf16* p = tile + (lane >> 2) * kPitch + 2 * (lane & 3);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    a[kk][0] = ld_u32(p + kk * 16);
    a[kk][1] = ld_u32(p + 8 * kPitch + kk * 16);
    a[kk][2] = ld_u32(p + kk * 16 + 8);
    a[kk][3] = ld_u32(p + 8 * kPitch + kk * 16 + 8);
  }
}

// acc[n] += a * tile^T for the 16 rows [r0, r0 + 16) of a shared bf16 tile
// (row-major, 16 x D): a 16 x 16 product, two n-tiles of 8 columns, over D
// in k-steps of 16.  One ldmatrix.x4 gives the B fragments of two k-steps
// (lane L addresses row n*8 + L%8 at column kk*16 + (L/8)*8).
template <int D, int kPitch>
__device__ __forceinline__ void mma_abt(float (*acc)[4], uint32_t (*a)[4],
                                        const bf16* rows, int lane) {
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    const bf16* r = rows + (n * 8 + (lane & 7)) * kPitch + (lane >> 3) * 8;
#pragma unroll
    for (int kk = 0; kk < D / 16; kk += 2) {
      uint32_t b0, b1, b2, b3;
      asm volatile(
          "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
          : "=r"(b0), "=r"(b1), "=r"(b2), "=r"(b3)
          : "r"(smem_addr(r + kk * 16)));
      mma_bf16(acc[n], a[kk], b0, b1);
      mma_bf16(acc[n], a[kk + 1], b2, b3);
    }
  }
}

// acc[n] (n over D / 8 column tiles) += a * rows, where a is 16 x 16 and
// rows is 16 rows of a shared bf16 tile (row-major, 16 x D): the B fragments
// come transposed by ldmatrix (lane L addresses row (L/8 & 1)*8 + L%8 at
// columns n*8, matrices 0 and 1, or n*8 + 8, matrices 2 and 3).
template <int D, int kPitch>
__device__ __forceinline__ void mma_ab(float (*acc)[4], const uint32_t* a,
                                       const bf16* rows, int lane) {
  const bf16* r =
      rows + (((lane >> 3) & 1) * 8 + (lane & 7)) * kPitch + (lane >> 4) * 8;
#pragma unroll
  for (int n = 0; n < D / 8; n += 2) {
    uint32_t b0, b1, b2, b3;
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
        "{%0,%1,%2,%3}, [%4];\n"
        : "=r"(b0), "=r"(b1), "=r"(b2), "=r"(b3)
        : "r"(smem_addr(r + n * 8)));
    mma_bf16(acc[n], a, b0, b1);
    mma_bf16(acc[n + 1], a, b2, b3);
  }
}

// Rows [r0, r0 + 64) into a shared f32 tile of pitch kPitchF32<D>; rows at
// or past T are zero.
template <int D>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src,
                                              long long row_stride, int r0,
                                              int Tlen) {
  constexpr int kPerRow = D / 4;
  constexpr int kPitch = kPitchF32<D>;
  for (int i = threadIdx.x; i < kBQ * kPerRow; i += kThreads) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < Tlen) {
      val = __ldg(reinterpret_cast<const float4*>(
          src + (long long)(r0 + r) * row_stride + c));
    }
    float* d = dst + r * kPitch + c;
    d[0] = val.x;
    d[1] = val.y;
    d[2] = val.z;
    d[3] = val.w;
  }
}

template <typename Kernel, typename P>
int launch(Kernel kernel, int bytes, const P& prm, dim3 grid,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, bytes, stream>>>(prm);
  return (int)cudaGetLastError();
}

}  // namespace flash
