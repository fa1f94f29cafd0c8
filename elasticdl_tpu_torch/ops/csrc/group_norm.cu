// GroupNorm + affine (+ ReLU) forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_fwd_kernel` of elasticdl_tpu/ops/group_norm.py
// (launched by `_fwd_pallas`).  Computes, for x [B, HW, C] channels-last in
// float32 or bfloat16, scale/bias [C] float32 and G groups:
//   mean, var  per (batch, group) over HW x C/G, var CENTERED (never
//              E[x^2] - E[x]^2, which cancels when |mean| >> std);
//   a = rstd * scale;  b = bias - mean * a;  y = x * a + b;  optional ReLU;
//   y in x's dtype, plus float32 per-channel mean and rstd [B, 1, C]
//   (the residuals the backward kernel reads).
//
// What bounds it on this card: device-memory bytes.  The least work is one
// read of x and one write of y; a few flops per element are far below the
// card's arithmetic rate.  The TPU kernel held a whole batch row in VMEM,
// grid (B,).  Here a batch row is held by one thread-block cluster of K
// blocks (up to 16, so a 3.2 MB row fits in their shared memory), one
// launch per call, the clusters persistent over the batch rows
// (gn_common.cuh describes the layout):
//   1. block k copies its rows into shared memory by cp.async.bulk, in
//      pieces, and starts summing as each piece lands; rows past its
//      shared budget are read from device memory (the plan says how many
//      fit: all of them at every ResNet-50 shape);
//   2. per-channel sums of x - shift_g, shift_g a value of the group in
//      the block's first row, in 16-byte vectors, one channel vector per
//      thread; summed over the block's lanes and the group's channels in
//      a fixed order, then (count, mean, M2) per group;
//   3. each block pushes its (count, mean, M2) into every block of the
//      cluster (distributed shared memory); after the cluster barrier
//      each merges the K partials in rank order by Chan's parallel update,
//      so all K blocks hold the same mean and rstd;
//   4. y = fma(x, a, b) (+ ReLU) from the resident rows, a and b per
//      channel in registers, stored in 16-byte vectors, a piece at a time;
//      each piece, once done, receives the cluster's next batch row.
// x is read once from device memory where its rows are resident.  A C
// that is not a multiple of 16 bytes, or an x not 16-byte aligned, takes
// the same kernel with one channel per access and no resident rows.
//
// C interface (bound with ctypes): edl_group_norm_fwd returns 0 or the
// cudaError_t code of a bad plan or refused launch.  It allocates nothing.

#include "gn_common.cuh"

namespace {

namespace cg = cooperative_groups;
using gn::kThreads;

// Rows in flight per thread from device memory: 16 values.
template <int V>
constexpr int kUnroll = 16 / V;

// Chan et al.: merge (nb, mb, M2b) into (n, m, M2).
__device__ __forceinline__ void chan_merge(float& n, float& m, float& m2,
                                           float nb, float mb, float m2b) {
  if (nb == 0.f) return;
  const float nt = n + nb;
  const float d = mb - m;
  const float w = nb / nt;
  m = fmaf(d, w, m);
  m2 = m2 + m2b + d * d * n * w;
  n = nt;
}

// At most 128 registers: two blocks of small clusters share an SM.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads, 2)
gn_fwd_cluster(const T* __restrict__ x, const float* __restrict__ scale,
               const float* __restrict__ bias, T* __restrict__ y,
               float* __restrict__ mean_out, float* __restrict__ rstd_out,
               int B, int HW, int C, int G, int R, int rr, int pieces,
               float eps, int relu) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  gn::cluster_arrive_relaxed();
  const int K = gridDim.x;
  const int k = blockIdx.x;   // the cluster spans x: k is its rank
  const int cpg = C / G;
  const int nv = C / V;
  const int tc = min(nv, kThreads);
  const int lanes = kThreads / tc;
  const int lane = threadIdx.x / tc;
  const int cv0 = threadIdx.x % tc;
  const int n = min(R, HW - k * R);
  const int nres = min(rr, n);
  const int per = nres > 0 ? gn::rows_per_piece(nres, pieces) : 1;
  const int used = (nres + per - 1) / per;   // pieces holding rows

  T* xs = reinterpret_cast<T*>(smem);
  float* red1 = reinterpret_cast<float*>(smem + (int64_t)rr * C * sizeof(T));
  float* red2 = red1 + lanes * C;
  float* shift = red2 + lanes * C;
  float* parts = shift + G;           // [row parity][K][G][count, mean, M2]
  float* gstat = parts + 6 * K * G;   // [G][mean, rstd]
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      smem + gn::smem_bytes(C, G, K, rr, pieces, sizeof(T), V, false) -
      8 * pieces);
  auto rows_of = [&](int b) { return ((int64_t)b * HW + (int64_t)k * R) * C; };

  // The copy of the first row's resident rows, and scale and bias (read
  // after the exchange), are requested before anything waits on device
  // memory.
  if (threadIdx.x == 0 && nres > 0) {
    for (int p = 0; p < pieces; ++p) hopper::mbar_init(&bars[p], 1);
    hopper::mbar_init_fence();
    for (int p = 0; p < used; ++p)
      gn::bulk_load_piece<T>(xs, x + rows_of(blockIdx.y), nullptr, nullptr,
                             nres, per, p, C, &bars[p]);
  }
  gn::prefetch_l2(scale, C);
  gn::prefetch_l2(bias, C);
  __syncthreads();   // the barriers are initialised

  uint32_t phase = 0;
  for (int b = blockIdx.y; b < B; b += gridDim.y, phase ^= 1) {
    const T* xb = x + rows_of(b);
    T* yb = y + rows_of(b);
    const int next = b + gridDim.y;
    // The shifts come from the block's first row: in shared memory once
    // the first piece has landed, where rows are resident.
    for (int g = threadIdx.x; g < G; g += kThreads) {
      if (nres > 0) {
        hopper::mbar_wait(&bars[0], phase);
        shift[g] = gn::to_f(xs[g * cpg]);
      } else {
        shift[g] = gn::to_f(xb[g * cpg]);
      }
    }
    __syncthreads();

    // Pass 1: shifted per-channel sums over the block's rows.
    for (int cv = cv0; lane < lanes && cv < nv; cv += kThreads) {
      const int c0 = cv * V;
      float sh[V], s1[V], s2[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        sh[v] = shift[(c0 + v) / cpg];
        s1[v] = s2[v] = 0.f;
      }
      for (int p = 0; p < used; ++p) {
        hopper::mbar_wait(&bars[p], phase);
        const int end = min(nres, (p + 1) * per);
#pragma unroll 4
        for (int r = p * per + lane; r < end; r += lanes) {
          float f[V];
          gn::load_shared<T, V>(xs + (int64_t)r * C + c0, f);
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const float d = f[v] - sh[v];
            s1[v] += d;
            s2[v] = fmaf(d, d, s2[v]);
          }
        }
      }
      for (int r = nres + lane; r < n; r += kUnroll<V> * lanes) {
        float f[kUnroll<V>][V];
#pragma unroll
        for (int u = 0; u < kUnroll<V>; ++u)
          if (r + u * lanes < n)
            gn::load_global<T, V>(xb + (int64_t)(r + u * lanes) * C + c0,
                                  f[u]);
#pragma unroll
        for (int u = 0; u < kUnroll<V>; ++u)
          if (r + u * lanes < n) {
#pragma unroll
            for (int v = 0; v < V; ++v) {
              const float d = f[u][v] - sh[v];
              s1[v] += d;
              s2[v] = fmaf(d, d, s2[v]);
            }
          }
      }
#pragma unroll
      for (int v = 0; v < V; ++v) {
        red1[lane * C + c0 + v] = s1[v];
        red2[lane * C + c0 + v] = s2[v];
      }
    }
    __syncthreads();
    // Per channel over the lanes, in lane order (column c is read and then
    // overwritten in row 0 by one thread).
    for (int c = threadIdx.x; c < C; c += kThreads) {
      float t1 = 0.f, t2 = 0.f;
      for (int l = 0; l < lanes; ++l) {
        t1 += red1[l * C + c];
        t2 += red2[l * C + c];
      }
      red1[c] = t1;
      red2[c] = t2;
    }
    __syncthreads();
    // Per group over its channels in order; (count, mean, M2) to every
    // block, into this row's half of `parts` (a block a row ahead writes
    // the other half).
    if (b == blockIdx.y) gn::cluster_wait();
    float* row_parts = parts + 3 * K * G * phase;
    for (int g = threadIdx.x; g < G; g += kThreads) {
      float u1 = 0.f, u2 = 0.f;
      for (int j = 0; j < cpg; ++j) {
        u1 += red1[g * cpg + j];
        u2 += red2[g * cpg + j];
      }
      const float cnt = (float)n * (float)cpg;
      const float mk = shift[g] + u1 / cnt;
      const float qk = fmaxf(u2 - u1 * (u1 / cnt), 0.f);
      const int64_t o = ((int64_t)k * G + g) * 3;
      for (int kk = 0; kk < K; ++kk) {
        gn::push(cluster, row_parts, kk, o, cnt);
        gn::push(cluster, row_parts, kk, o + 1, mk);
        gn::push(cluster, row_parts, kk, o + 2, qk);
      }
    }
    cluster.sync();
    // Every block merges the K partials in rank order: the same result in
    // each.
    for (int g = threadIdx.x; g < G; g += kThreads) {
      float nn = 0.f, m = 0.f, q = 0.f;
      for (int kk = 0; kk < K; ++kk) {
        const float* pr = row_parts + ((int64_t)kk * G + g) * 3;
        chan_merge(nn, m, q, pr[0], pr[1], pr[2]);
      }
      gstat[2 * g] = m;
      gstat[2 * g + 1] = rsqrtf(q / nn + eps);
    }
    __syncthreads();
    for (int c = threadIdx.x; c < C; c += kThreads) {
      const int g = c / cpg;
      const float m = gstat[2 * g], rs = gstat[2 * g + 1];
      // The backward re-derives the ReLU mask from the same a and b.
      const float a = gn::affine_a(rs, scale[c]);
      red1[c] = a;
      red2[c] = gn::affine_b(bias[c], m, a);
      if (k == 0) {
        mean_out[(int64_t)b * C + c] = m;
        rstd_out[(int64_t)b * C + c] = rs;
      }
    }
    __syncthreads();

    // Pass 2: y = fma(x, a, b) (+ ReLU), a piece at a time; once every
    // thread is done with a piece, the next row's copy into it starts.
    for (int p = 0; p < used; ++p) {
      const int end = min(nres, (p + 1) * per);
      for (int cv = cv0; lane < lanes && cv < nv; cv += kThreads) {
        const int c0 = cv * V;
        float a[V], bb[V];
#pragma unroll
        for (int v = 0; v < V; ++v) {
          a[v] = red1[c0 + v];
          bb[v] = red2[c0 + v];
        }
#pragma unroll 4
        for (int r = p * per + lane; r < end; r += lanes) {
          float f[V];
          gn::load_shared<T, V>(xs + (int64_t)r * C + c0, f);
#pragma unroll
          for (int v = 0; v < V; ++v) {
            f[v] = fmaf(f[v], a[v], bb[v]);
            if (relu) f[v] = fmaxf(f[v], 0.f);
          }
          gn::store_global<T, V>(yb + (int64_t)r * C + c0, f);
        }
      }
      __syncthreads();
      if (threadIdx.x == 0 && next < B)
        gn::bulk_load_piece<T>(xs, x + rows_of(next), nullptr, nullptr, nres,
                               per, p, C, &bars[p]);
    }
    for (int cv = cv0; lane < lanes && cv < nv; cv += kThreads) {
      const int c0 = cv * V;
      float a[V], bb[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        a[v] = red1[c0 + v];
        bb[v] = red2[c0 + v];
      }
      for (int r = nres + lane; r < n; r += kUnroll<V> * lanes) {
        float f[kUnroll<V>][V];
#pragma unroll
        for (int u = 0; u < kUnroll<V>; ++u)
          if (r + u * lanes < n)
            gn::load_global<T, V>(xb + (int64_t)(r + u * lanes) * C + c0,
                                  f[u]);
#pragma unroll
        for (int u = 0; u < kUnroll<V>; ++u)
          if (r + u * lanes < n) {
#pragma unroll
            for (int v = 0; v < V; ++v) {
              f[u][v] = fmaf(f[u][v], a[v], bb[v]);
              if (relu) f[u][v] = fmaxf(f[u][v], 0.f);
            }
            gn::store_global<T, V>(yb + (int64_t)(r + u * lanes) * C + c0,
                                   f[u]);
          }
      }
    }
    __syncthreads();   // red1, red2 and shift are the next row's now
  }
}

template <typename T, int V>
cudaError_t launch(const void* x, const float* scale, const float* bias,
                   void* y, float* mean, float* rstd, int B, int HW, int C,
                   int G, int R, int rr, int pieces, int smem, float eps,
                   int relu, cudaStream_t stream) {
  const int K = (HW + R - 1) / R;
  return gn::launch_persistent(gn_fwd_cluster<T, V>, K, B, smem, stream,
                               static_cast<const T*>(x), scale, bias,
                               static_cast<T*>(y), mean, rstd, B, HW, C, G,
                               R, rr, pieces, eps, relu);
}

}  // namespace

extern "C" {

// The plan (ops/group_norm.py `plan`): R rows per block (the cluster has
// ceil(HW / R) blocks), rr of them resident in shared memory, copied in
// `pieces` pieces; vec = 1 for 16-byte accesses; smem the dynamic shared
// bytes, which must equal the layout's.  dtype: 0 = float32, 1 =
// bfloat16.  scale, bias, mean and rstd are float32.  Returns 0, or the
// cudaError_t of a bad argument or refused launch.
int edl_group_norm_fwd(const void* x, const void* scale, const void* bias,
                       void* y, void* mean, void* rstd, int B, int HW, int C,
                       int G, int R, int rr, int pieces, int vec, int smem,
                       float eps, int relu, int dtype, void* stream) {
  const int esize = dtype == 0 ? 4 : 2;
  const void* ptrs[2] = {x, y};
  const int V = vec ? 16 / esize : 1;
  const int K = R > 0 ? (HW + R - 1) / R : 0;
  if ((dtype != 0 && dtype != 1) ||
      !gn::plan_ok(B, HW, C, G, R, rr, pieces, vec, esize, ptrs, 2) ||
      smem > gn::kSmemMax ||
      smem != gn::smem_bytes(C, G, K, rr, pieces, esize, V, false)) {
    return (int)cudaErrorInvalidValue;
  }
  // Clear an error left by an earlier launch, so that the code returned
  // below is this call's own.
  cudaGetLastError();
  const float* s = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  float* m = static_cast<float*>(mean);
  float* r = static_cast<float*>(rstd);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = vec ? launch<float, 4>(x, s, bi, y, m, r, B, HW, C, G, R, rr,
                                 pieces, smem, eps, relu, st)
              : launch<float, 1>(x, s, bi, y, m, r, B, HW, C, G, R, rr,
                                 pieces, smem, eps, relu, st);
  } else {
    err = vec ? launch<__nv_bfloat16, 8>(x, s, bi, y, m, r, B, HW, C, G, R,
                                         rr, pieces, smem, eps, relu, st)
              : launch<__nv_bfloat16, 1>(x, s, bi, y, m, r, B, HW, C, G, R,
                                         rr, pieces, smem, eps, relu, st);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Clusters of K forward blocks of `smem` bytes the card holds at once
// (-1 if unknown); for the sweep's report (scripts/sweep_group_norm.py).
int edl_group_norm_fwd_max_clusters(int K, int smem, int dtype, int vec) {
  if (dtype == 0)
    return vec ? gn::max_active_clusters(gn_fwd_cluster<float, 4>, K, smem)
               : gn::max_active_clusters(gn_fwd_cluster<float, 1>, K, smem);
  return vec ? gn::max_active_clusters(gn_fwd_cluster<__nv_bfloat16, 8>, K,
                                       smem)
             : gn::max_active_clusters(gn_fwd_cluster<__nv_bfloat16, 1>, K,
                                       smem);
}

}  // extern "C"
