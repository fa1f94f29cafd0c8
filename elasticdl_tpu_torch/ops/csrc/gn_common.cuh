// Shared by the GroupNorm forward (group_norm.cu) and backward
// (group_norm_bwd.cu): the block size, the plan's limits, 16-byte vector
// loads and stores in float32 or bfloat16 (every sum is float32), the
// affine coefficients both directions form, the cluster barrier and the
// bulk copy that fills a block's resident rows.
//
// Both kernels give a batch row to one thread-block cluster of K blocks
// (gridDim.x = K); block k owns rows [k R, min((k + 1) R, HW)) of it.
// The clusters are persistent: as many as the card holds at once
// (gridDim.y, at most B), each walking the batch rows blockIdx.y,
// blockIdx.y + gridDim.y, ...  A block's first `rr` rows are copied into
// shared memory by cp.async.bulk in up to kMaxPieces pieces, each
// completing on its own mbarrier (one phase per batch row), and read from
// there by both passes; the rest are read from device memory by each
// pass.  As the second pass finishes a piece, the copy of the same piece
// of the cluster's next batch row is issued into it, so the next row's
// reads overlap this row's writes.  The blocks exchange their partial
// sums through distributed shared memory: each pushes its values into
// the others' shared memory, then the cluster barrier.
//
// Thread t serves the channel vector cv = t % tc (V channels; tc =
// min(C / V, kThreads) vectors side by side) on row lane t / tc; with
// C / V > kThreads one lane walks C in steps of kThreads vectors.  A
// thread's channels, and with them its per-channel coefficients, stay
// fixed for its whole walk.
//
// The plan (cluster size, rows, resident rows, pieces, vector width,
// shared bytes) is computed by the wrapper (ops/group_norm.py, `plan`);
// the entry points recompute the shared-memory layout from it with
// smem_bytes() below and refuse a plan whose bytes differ.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <vector>

#include "hopper.cuh"

namespace gn {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kMaxCluster = 16;   // non-portable above 8
constexpr int kMaxPieces = 8;
constexpr int kSmemMax = 232448;  // what one block may use (227 KB)

// Bytes of dynamic shared memory for a plan; must match `_smem_bytes`
// in ops/group_norm.py.  Layout: rr rows of x (and of dy in the
// backward) as they lie in device memory, then `floats` float32 of
// reduction and exchange buffers, then one 8-byte mbarrier per piece.
__host__ __device__ inline int64_t floats_of(int C, int G, int K, int lanes,
                                             bool backward) {
  const int64_t cpg = C / G;
  int64_t f = 2 * (int64_t)lanes * C;   // red1, red2: [lanes][C]
  if (backward) {
    const int64_t own = (G + K - 1) / K * cpg;
    f += 2 * (int64_t)K * own + 2 * (int64_t)G;   // recv, gall
  } else {
    // shift, parts (two rows' worth), gstat
    f += G + 6 * (int64_t)K * G + 2 * (int64_t)G;
  }
  return f;
}

__host__ __device__ inline int64_t smem_bytes(int C, int G, int K, int rr,
                                              int pieces, int esize,
                                              int vec_elems, bool backward) {
  const int nv = C / vec_elems;
  const int lanes = kThreads / (nv < kThreads ? nv : kThreads);
  const int64_t data =
      (int64_t)rr * C * esize * (backward ? 2 : 1);   // 16-byte rows
  const int64_t fl = floats_of(C, G, K, lanes, backward) * 4;
  return data + (fl + 7) / 8 * 8 + 8 * (int64_t)pieces;
}

// ---- loads and stores of V channels as float32 ----------------------------

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
// bf16 -> f32 is exact: the 16 bits are the top half of the float.
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ uint4 pack(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}
__device__ __forceinline__ uint4 pack(const float (&f)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    w[i] = *reinterpret_cast<uint32_t*>(&h);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// From device memory (read-only for the kernel's life).
template <typename T, int V>
__device__ __forceinline__ void load_global(const T* p, float (&f)[V]) {
  if constexpr (V == 1) {
    f[0] = to_f(p[0]);
  } else {
    unpack(__ldg(reinterpret_cast<const uint4*>(p)), f);
  }
}

// From this block's shared memory.
template <typename T, int V>
__device__ __forceinline__ void load_shared(const T* p, float (&f)[V]) {
  if constexpr (V == 1) {
    f[0] = to_f(p[0]);
  } else {
    unpack(*reinterpret_cast<const uint4*>(p), f);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_global(T* p, const float (&f)[V]) {
  if constexpr (V == 1) {
    p[0] = from_f<T>(f[0]);
  } else {
    *reinterpret_cast<uint4*>(p) = pack(f);
  }
}

// ---- the affine both directions form --------------------------------------

// The forward's affine coefficients for one (batch, channel), formed in
// this association order with no contraction: a = rstd * scale,
// b = bias - mean * a.  The forward writes y = fma(x, a, b); the backward
// re-derives its ReLU mask from the same expression, so the two agree
// bit for bit on every element, boundary ones included.
__device__ __forceinline__ float affine_a(float rstd, float scale) {
  return __fmul_rn(rstd, scale);
}
__device__ __forceinline__ float affine_b(float bias, float mean, float a) {
  return __fsub_rn(bias, __fmul_rn(mean, a));
}

// ---- the cluster ----------------------------------------------------------

// The cluster barrier in two halves.  Every block arrives (relaxed) when
// it starts and waits before its first push, so no block writes into the
// shared memory of one that has not started; cluster.sync() after the
// pushes makes them visible.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// This block's value `v` into slot `i` of `buf` in block `rank`'s shared
// memory (`buf` is this block's address of the same buffer).
__device__ __forceinline__ void push(const cg::cluster_group& cluster,
                                     float* buf, int rank, int64_t i,
                                     float v) {
  cluster.map_shared_rank(buf, rank)[i] = v;
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(hopper::smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(hopper::smem_u32(bar))
      : "memory");
}

// Rows of piece p are [p per, min((p + 1) per, rows)), per =
// rows_per_piece(rows, pieces); pieces past the rows are unused.
__device__ __forceinline__ int rows_per_piece(int rows, int pieces) {
  return (rows + pieces - 1) / pieces;
}

// Copies piece p of `rows` rows (row_elems elements each, a multiple of
// 16 bytes; every address 16-byte aligned) from src0 to dst0, and from
// src1 to dst1 where src1 is not null, completing on `bar`.  One thread
// calls it, after the barrier is initialised and made visible, and
// before anything waits on the barrier's phase.
template <typename T>
__device__ __forceinline__ void bulk_load_piece(T* dst0, const T* src0,
                                                T* dst1, const T* src1,
                                                int rows, int per, int p,
                                                int row_elems,
                                                uint64_t* bar) {
  const int64_t first = (int64_t)p * per * row_elems;
  const uint32_t bytes =
      (uint32_t)((int64_t)min(per, rows - p * per) * row_elems * sizeof(T));
  hopper::mbar_arrive_expect_tx(bar, src1 ? 2 * bytes : bytes);
  bulk_load(dst0 + first, src0 + first, bytes, bar);
  if (src1) bulk_load(dst1 + first, src1 + first, bytes, bar);
}

// Asks for the 128-byte lines of `n` floats at `p` to be brought into L2
// (thread t takes lines t, t + blockDim.x, ...), so a later load waits on
// L2, not on device memory.
__device__ __forceinline__ void prefetch_l2(const float* p, int n) {
  for (int i = threadIdx.x * 32; i < n; i += blockDim.x * 32)
    asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p + i));
}

// In a kernel launched with programmatic stream serialization: waits for
// the grid before it to finish and its writes to land.
__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// ---- host -----------------------------------------------------------------

// The attributes every launch of `kernel` needs: any dynamic shared size
// up to kSmemMax, and clusters above the portable 8 blocks.
template <typename Kernel>
cudaError_t prepare(Kernel kernel) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

// A launch of `grid` in clusters of K blocks along x, `smem` dynamic
// bytes each.
inline void cluster_config(dim3 grid, int K, int smem, cudaStream_t stream,
                           cudaLaunchAttribute* attr,
                           cudaLaunchConfig_t* cfg) {
  *cfg = {};
  cfg->gridDim = grid;
  cfg->blockDim = dim3(kThreads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = K;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

// How many clusters of K blocks of `kernel` with `smem` bytes each the
// card holds at once (-1 if the runtime refuses to say).
template <typename Kernel>
int max_active_clusters(Kernel kernel, int K, int smem) {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  cluster_config(dim3(K), K, smem, 0, &attr, &cfg);
  int n = -1;
  if (prepare(kernel) != cudaSuccess ||
      cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess)
    return -1;
  return n;
}

// max_active_clusters, remembered per (kernel, device, K, smem): the
// query, and the attributes it sets, cost host time on every call.
template <typename Kernel>
int resident_clusters(Kernel kernel, int K, int smem) {
  struct Entry {
    const void* kernel;
    int device, K, smem, n;
  };
  static std::mutex mu;
  static std::vector<Entry> cache;
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess) return -1;
  std::lock_guard<std::mutex> lock(mu);
  for (const Entry& e : cache)
    if (e.kernel == (const void*)kernel && e.device == device && e.K == K &&
        e.smem == smem)
      return e.n;
  const int n = max_active_clusters(kernel, K, smem);
  if (n > 0) cache.push_back({(const void*)kernel, device, K, smem, n});
  return n;
}

// Launches `kernel` in clusters of K blocks along x, as many clusters as
// the card holds at once and at most B (the batch rows they walk).  The
// kernel's attributes were set when resident_clusters first saw it.
template <typename Kernel, typename... Args>
cudaError_t launch_persistent(Kernel kernel, int K, int B, int smem,
                              cudaStream_t stream, Args... args) {
  const int n = resident_clusters(kernel, K, smem);
  if (n <= 0) return cudaErrorInvalidConfiguration;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  cluster_config(dim3(K, n < B ? n : B), K, smem, stream, &attr, &cfg);
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// The plan's checks shared by both entry points.
inline bool plan_ok(int B, int HW, int C, int G, int R, int rr, int pieces,
                    int vec, int esize, const void* const* ptrs, int nptrs) {
  if (B <= 0 || HW <= 0 || C <= 0 || G <= 0 || C % G != 0 || R <= 0 ||
      B > 65535 || (int64_t)HW * C > INT32_MAX || rr < 0 || rr > R ||
      pieces < 0 || pieces > kMaxPieces || (rr > 0) != (pieces > 0) ||
      pieces > rr)
    return false;
  const int K = (HW + R - 1) / R;
  if (K > kMaxCluster) return false;
  if (vec) {
    if ((C * esize) % 16 != 0) return false;
    for (int i = 0; i < nptrs; ++i)
      if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 != 0) return false;
  } else if (rr > 0) {
    return false;   // the bulk copy needs 16-byte rows and addresses
  }
  return true;
}

}  // namespace gn
