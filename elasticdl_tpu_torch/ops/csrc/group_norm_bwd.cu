// GroupNorm + affine (+ ReLU) backward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_bwd_kernel` of elasticdl_tpu/ops/group_norm.py
// (launched by `_bwd_pallas`).  For x, dy [B, HW, C] channels-last in
// float32 or bfloat16, scale/bias [C] float32, G groups and the forward's
// float32 per-channel mean and rstd [B, 1, C]:
//   dy is masked by the forward's ReLU decision (relu = 1): kept where
//     fma(x, a, b) > 0 with a, b formed as the forward forms them
//     (gn_common.cuh), so the mask is the forward's, bit for bit;
//   xhat = (x - mean) * rstd;
//   s1 = sum(dy), s2 = sum(dy * xhat) per (batch, channel) over HW;
//   dbias = s1 and dscale = s2 summed over the batch, float32 [C];
//   dx = rstd * (dy * scale - mean_g(s1 * scale) - xhat * mean_g(s2 * scale))
//     in x's dtype, mean_g the mean over the group's HW x C/G elements.
//
// What bounds it on this card: device-memory bytes.  The least work reads
// x and dy once and writes dx once; about 15 flops per element are far
// below the arithmetic rate.  The TPU kernel held a batch row in VMEM and
// carried dscale/dbias across its sequential grid (B,); Hopper's blocks run
// in no order, and the design must not use atomics: two runs on one input
// give bitwise-equal dx, dscale and dbias (the trainer's bitwise contracts
// rest on it).  So, in B1's image (gn_common.cuh), two launches:
//   1. gn_bwd_cluster: a cluster of K blocks per batch row, persistent
//      over the batch rows (gn_common.cuh).  Block k copies its rows of x
//      and dy into shared memory by cp.async.bulk (as many as fit: all of
//      them in bfloat16; about half of the float32 stem's and of
//      56x56x256's), and sums s1, s2 per channel in 16-byte vectors, one
//      channel vector per thread, over its lanes in a fixed order.  Rank
//      k owns a run of groups: every block pushes its per-channel sums of
//      those groups into rank k's shared memory, which adds them in rank
//      order, writes the row's per-channel s1, s2 to the workspace and
//      pushes the two group means of s * scale into every block.  Then dx
//      from the resident rows, coefficients in registers, a piece at a
//      time; each piece, once done, receives the cluster's next batch row.
//   2. gn_bwd_affine: dscale and dbias, the workspace summed over the batch
//      in a fixed order: 8 runs of the batch per channel, then the 8 in
//      order.  Launched with programmatic stream serialization: it is
//      launched as the first kernel's blocks exit, and waits for the
//      first kernel's writes (griddepcontrol.wait).
// Every sum has a fixed order, so the result does not depend on how the
// blocks are scheduled.
//
// C interface (bound with ctypes): edl_group_norm_bwd returns 0 or the
// cudaError_t code of a bad plan or refused launch.  It allocates
// nothing: the caller passes a float32 workspace of 2 B C floats.

#include "gn_common.cuh"

namespace {

namespace cg = cooperative_groups;
using gn::kThreads;

// Rows in flight per thread from device memory: 8 values of x and of dy.
template <int V>
constexpr int kUnroll = 8 / V;
constexpr int kAffineRuns = 8;  // runs of the batch per channel

// At most 128 registers: two blocks of small clusters share an SM.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads, 2)
gn_bwd_cluster(const T* __restrict__ x, const T* __restrict__ dy,
               const float* __restrict__ scale,
               const float* __restrict__ bias,
               const float* __restrict__ mean,
               const float* __restrict__ rstd, T* __restrict__ dx,
               float* __restrict__ csum, int B, int HW, int C, int G, int R,
               int rr, int pieces, int relu) {
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
  // Rank kk owns groups [kk G / K, (kk + 1) G / K); `own` channels fit
  // any rank's.
  const int own = (G + K - 1) / K * cpg;
  const int g0 = k * G / K, g1 = (k + 1) * G / K;

  T* xs = reinterpret_cast<T*>(smem);
  T* dys = xs + (int64_t)rr * C;
  float* red1 =
      reinterpret_cast<float*>(smem + 2 * (int64_t)rr * C * sizeof(T));
  float* red2 = red1 + lanes * C;
  float* recv = red2 + lanes * C;   // [s1, s2][K][own]
  float* gall = recv + 2 * K * own;   // [G][mean_g(s1 sc), mean_g(s2 sc)]
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      smem + gn::smem_bytes(C, G, K, rr, pieces, sizeof(T), V, true) -
      8 * pieces);
  auto rows_of = [&](int b) { return ((int64_t)b * HW + (int64_t)k * R) * C; };

  if (threadIdx.x == 0 && nres > 0) {
    for (int p = 0; p < pieces; ++p) hopper::mbar_init(&bars[p], 1);
    hopper::mbar_init_fence();
    for (int p = 0; p < used; ++p)
      gn::bulk_load_piece<T>(xs, x + rows_of(blockIdx.y), dys,
                             dy + rows_of(blockIdx.y), nres, per, p, C,
                             &bars[p]);
  }
  __syncthreads();

  uint32_t phase = 0;
  for (int b = blockIdx.y; b < B; b += gridDim.y, phase ^= 1) {
    const T* xb = x + rows_of(b);
    const T* dyb = dy + rows_of(b);
    T* dxb = dx + rows_of(b);
    const float* mb = mean + (int64_t)b * C;
    const float* rb = rstd + (int64_t)b * C;
    const int next = b + gridDim.y;

    // Pass 1: per-channel s1 = sum(g), s2 = sum(g * xhat).
    for (int cv = cv0; lane < lanes && cv < nv; cv += kThreads) {
      const int c0 = cv * V;
      float m[V], rs[V], a[V], bb[V], s1[V], s2[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        m[v] = mb[c0 + v];
        rs[v] = rb[c0 + v];
        a[v] = gn::affine_a(rs[v], scale[c0 + v]);
        bb[v] = gn::affine_b(bias[c0 + v], m[v], a[v]);
        s1[v] = s2[v] = 0.f;
      }
      auto add = [&](const float (&xv)[V], const float (&gv)[V]) {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          float g = gv[v];
          if (relu && !(fmaf(xv[v], a[v], bb[v]) > 0.f)) g = 0.f;
          s1[v] += g;
          s2[v] = fmaf(g, (xv[v] - m[v]) * rs[v], s2[v]);
        }
      };
      for (int p = 0; p < used; ++p) {
        hopper::mbar_wait(&bars[p], phase);
        const int end = min(nres, (p + 1) * per);
#pragma unroll 2
        for (int r = p * per + lane; r < end; r += lanes) {
          float xv[V], gv[V];
          gn::load_shared<T, V>(xs + (int64_t)r * C + c0, xv);
          gn::load_shared<T, V>(dys + (int64_t)r * C + c0, gv);
          add(xv, gv);
        }
      }
      for (int r = nres + lane; r < n; r += kUnroll<V> * lanes) {
        float xv[kUnroll<V>][V], gv[kUnroll<V>][V];
#pragma unroll
        for (int u = 0; u < kUnroll<V>; ++u)
          if (r + u * lanes < n) {
            const int64_t o = (int64_t)(r + u * lanes) * C + c0;
            gn::load_global<T, V>(xb + o, xv[u]);
            gn::load_global<T, V>(dyb + o, gv[u]);
          }
#pragma unroll
        for (int u = 0; u < kUnroll<V>; ++u)
          if (r + u * lanes < n) add(xv[u], gv[u]);
      }
#pragma unroll
      for (int v = 0; v < V; ++v) {
        red1[lane * C + c0 + v] = s1[v];
        red2[lane * C + c0 + v] = s2[v];
      }
    }
    __syncthreads();
    // Per channel over the lanes in lane order, pushed to the channel's
    // owner (slot k of its receive buffer).  The owner read the last
    // row's before the cluster barrier this block passed since.
    if (b == blockIdx.y) gn::cluster_wait();
    for (int c = threadIdx.x; c < C; c += kThreads) {
      float t1 = 0.f, t2 = 0.f;
      for (int l = 0; l < lanes; ++l) {
        t1 += red1[l * C + c];
        t2 += red2[l * C + c];
      }
      const int g = c / cpg;
      const int owner = ((g + 1) * K - 1) / G;   // largest kk: kk G / K <= g
      const int j = c - owner * G / K * cpg;
      gn::push(cluster, recv, owner, (int64_t)k * own + j, t1);
      gn::push(cluster, recv, owner, (int64_t)(K + k) * own + j, t2);
    }
    cluster.sync();
    // The owner: each channel's s1, s2 over the K blocks in rank order, to
    // the workspace; s * scale kept in slot 0 (column j is read, then
    // overwritten, by one thread).
    const int nown = (g1 - g0) * cpg;
    for (int j = threadIdx.x; j < nown; j += kThreads) {
      float t1 = 0.f, t2 = 0.f;
      for (int kk = 0; kk < K; ++kk) {
        t1 += recv[(int64_t)kk * own + j];
        t2 += recv[(int64_t)(K + kk) * own + j];
      }
      const int c = g0 * cpg + j;
      csum[(int64_t)b * C + c] = t1;
      csum[((int64_t)B + b) * C + c] = t2;
      recv[j] = t1 * scale[c];
      recv[(int64_t)K * own + j] = t2 * scale[c];
    }
    __syncthreads();
    // Per owned group, over its channels in order; to every block (which
    // all read the last row's in their second pass, before this row's
    // first cluster barrier).
    const float inv = 1.f / ((float)HW * (float)cpg);
    for (int g = g0 + threadIdx.x; g < g1; g += kThreads) {
      float t1 = 0.f, t2 = 0.f;
      for (int i = 0; i < cpg; ++i) {
        const int j = (g - g0) * cpg + i;
        t1 += recv[j];
        t2 += recv[(int64_t)K * own + j];
      }
      for (int kk = 0; kk < K; ++kk) {
        gn::push(cluster, gall, kk, 2 * g, t1 * inv);
        gn::push(cluster, gall, kk, 2 * g + 1, t2 * inv);
      }
    }
    cluster.sync();

    // Pass 2: dx, a piece at a time; once every thread is done with a
    // piece, the next row's copy into it starts.
    auto coefficients = [&](int c0, float (&m)[V], float (&rs)[V],
                            float (&sc)[V], float (&a)[V], float (&bb)[V],
                            float (&k1)[V], float (&k2)[V]) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int c = c0 + v;
        m[v] = mb[c];
        rs[v] = rb[c];
        sc[v] = scale[c];
        a[v] = gn::affine_a(rs[v], sc[v]);
        bb[v] = gn::affine_b(bias[c], m[v], a[v]);
        k1[v] = gall[2 * (c / cpg)];
        k2[v] = gall[2 * (c / cpg) + 1];
      }
    };
    auto grad = [&](const float (&xv)[V], float (&gv)[V], const float (&m)[V],
                    const float (&rs)[V], const float (&sc)[V],
                    const float (&a)[V], const float (&bb)[V],
                    const float (&k1)[V], const float (&k2)[V]) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        float g = gv[v];
        if (relu && !(fmaf(xv[v], a[v], bb[v]) > 0.f)) g = 0.f;
        const float xhat = (xv[v] - m[v]) * rs[v];
        gv[v] = rs[v] * (g * sc[v] - k1[v] - xhat * k2[v]);
      }
    };
    // With one channel vector per thread its coefficients are loaded once
    // for the row.
    const bool once = nv <= kThreads;
    float m[V], rs[V], sc[V], a[V], bb[V], k1[V], k2[V];
    if (once && lane < lanes) coefficients(cv0 * V, m, rs, sc, a, bb, k1, k2);
    if (next < B) {   // the next row's statistics, read by its pass 1
      gn::prefetch_l2(mean + (int64_t)next * C, C);
      gn::prefetch_l2(rstd + (int64_t)next * C, C);
    }
    for (int p = 0; p < used; ++p) {
      const int end = min(nres, (p + 1) * per);
      for (int cv = cv0; lane < lanes && cv < nv; cv += kThreads) {
        const int c0 = cv * V;
        if (!once) coefficients(c0, m, rs, sc, a, bb, k1, k2);
#pragma unroll 2
        for (int r = p * per + lane; r < end; r += lanes) {
          float xv[V], gv[V];
          gn::load_shared<T, V>(xs + (int64_t)r * C + c0, xv);
          gn::load_shared<T, V>(dys + (int64_t)r * C + c0, gv);
          grad(xv, gv, m, rs, sc, a, bb, k1, k2);
          gn::store_global<T, V>(dxb + (int64_t)r * C + c0, gv);
        }
      }
      __syncthreads();
      if (threadIdx.x == 0 && next < B)
        gn::bulk_load_piece<T>(xs, x + rows_of(next), dys, dy + rows_of(next),
                               nres, per, p, C, &bars[p]);
    }
    for (int cv = cv0; lane < lanes && cv < nv; cv += kThreads) {
      const int c0 = cv * V;
      if (!once) coefficients(c0, m, rs, sc, a, bb, k1, k2);
      for (int r = nres + lane; r < n; r += kUnroll<V> * lanes) {
        float xv[kUnroll<V>][V], gv[kUnroll<V>][V];
#pragma unroll
        for (int u = 0; u < kUnroll<V>; ++u)
          if (r + u * lanes < n) {
            const int64_t o = (int64_t)(r + u * lanes) * C + c0;
            gn::load_global<T, V>(xb + o, xv[u]);
            gn::load_global<T, V>(dyb + o, gv[u]);
          }
#pragma unroll
        for (int u = 0; u < kUnroll<V>; ++u)
          if (r + u * lanes < n) {
            grad(xv[u], gv[u], m, rs, sc, a, bb, k1, k2);
            gn::store_global<T, V>(dxb + (int64_t)(r + u * lanes) * C + c0,
                                   gv[u]);
          }
      }
    }
    __syncthreads();   // red1 and red2 are the next row's now
  }
}

// dbias[c] = sum_b csum[b][c], dscale[c] = sum_b csum[B + b][c]: thread
// (run, channel) adds its run of the batch in order, then run 0 adds the
// runs in order.
__global__ void __launch_bounds__(kThreads)
gn_bwd_affine(const float* __restrict__ csum, float* __restrict__ dscale,
              float* __restrict__ dbias, int B, int C) {
  constexpr int kCh = kThreads / kAffineRuns;
  __shared__ float p1[kAffineRuns][kCh];
  __shared__ float p2[kAffineRuns][kCh];
  gn::griddep_wait();
  const int i = threadIdx.x % kCh;
  const int run = threadIdx.x / kCh;
  const int c = blockIdx.x * kCh + i;
  float u1 = 0.f, u2 = 0.f;
  if (c < C) {
    const int b1 = (run + 1) * B / kAffineRuns;
#pragma unroll 4
    for (int b = run * B / kAffineRuns; b < b1; ++b) {
      u1 += csum[(int64_t)b * C + c];
      u2 += csum[((int64_t)B + b) * C + c];
    }
  }
  p1[run][i] = u1;
  p2[run][i] = u2;
  __syncthreads();
  if (run == 0 && c < C) {
    float t1 = 0.f, t2 = 0.f;
    for (int q = 0; q < kAffineRuns; ++q) {
      t1 += p1[q][i];
      t2 += p2[q][i];
    }
    dbias[c] = t1;
    dscale[c] = t2;
  }
}

template <typename T, int V>
cudaError_t launch(const void* x, const void* dy, const float* scale,
                   const float* bias, const float* mean, const float* rstd,
                   void* dx, float* dscale, float* dbias, float* csum, int B,
                   int HW, int C, int G, int R, int rr, int pieces, int smem,
                   int relu, cudaStream_t stream) {
  const int K = (HW + R - 1) / R;
  cudaError_t err = gn::launch_persistent(
      gn_bwd_cluster<T, V>, K, B, smem, stream, static_cast<const T*>(x),
      static_cast<const T*>(dy), scale, bias, mean, rstd, static_cast<T*>(dx),
      csum, B, HW, C, G, R, rr, pieces, relu);
  if (err != cudaSuccess) return err;
  constexpr int kCh = kThreads / kAffineRuns;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((C + kCh - 1) / kCh);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, gn_bwd_affine,
                            static_cast<const float*>(csum), dscale, dbias,
                            B, C);
}

}  // namespace

extern "C" {

// The plan as for edl_group_norm_fwd (group_norm.cu); its resident rows
// hold x and dy.  dtype: 0 = float32, 1 = bfloat16 (x, dy and dx).
// scale, bias, mean, rstd, dscale, dbias and work are float32.  Returns 0,
// or the cudaError_t of a bad argument or refused launch.
int edl_group_norm_bwd(const void* x, const void* dy, const void* scale,
                       const void* bias, const void* mean, const void* rstd,
                       void* dx, void* dscale, void* dbias, void* work,
                       int B, int HW, int C, int G, int R, int rr, int pieces,
                       int vec, int smem, int relu, int dtype,
                       void* stream) {
  const int esize = dtype == 0 ? 4 : 2;
  const void* ptrs[3] = {x, dy, dx};
  const int V = vec ? 16 / esize : 1;
  const int K = R > 0 ? (HW + R - 1) / R : 0;
  if ((dtype != 0 && dtype != 1) ||
      !gn::plan_ok(B, HW, C, G, R, rr, pieces, vec, esize, ptrs, 3) ||
      smem > gn::kSmemMax ||
      smem != gn::smem_bytes(C, G, K, rr, pieces, esize, V, true)) {
    return (int)cudaErrorInvalidValue;
  }
  // Clear an error left by an earlier launch, so that the code returned
  // below is this call's own.
  cudaGetLastError();
  const float* s = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  const float* m = static_cast<const float*>(mean);
  const float* r = static_cast<const float*>(rstd);
  float* ds = static_cast<float*>(dscale);
  float* db = static_cast<float*>(dbias);
  float* w = static_cast<float*>(work);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = vec ? launch<float, 4>(x, dy, s, bi, m, r, dx, ds, db, w, B, HW,
                                 C, G, R, rr, pieces, smem, relu, st)
              : launch<float, 1>(x, dy, s, bi, m, r, dx, ds, db, w, B, HW,
                                 C, G, R, rr, pieces, smem, relu, st);
  } else {
    err = vec ? launch<__nv_bfloat16, 8>(x, dy, s, bi, m, r, dx, ds, db, w,
                                         B, HW, C, G, R, rr, pieces, smem,
                                         relu, st)
              : launch<__nv_bfloat16, 1>(x, dy, s, bi, m, r, dx, ds, db, w,
                                         B, HW, C, G, R, rr, pieces, smem,
                                         relu, st);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Clusters of K backward blocks of `smem` bytes the card holds at once
// (-1 if unknown); for the sweep's report (scripts/sweep_group_norm.py).
int edl_group_norm_bwd_max_clusters(int K, int smem, int dtype, int vec) {
  if (dtype == 0)
    return vec ? gn::max_active_clusters(gn_bwd_cluster<float, 4>, K, smem)
               : gn::max_active_clusters(gn_bwd_cluster<float, 1>, K, smem);
  return vec ? gn::max_active_clusters(gn_bwd_cluster<__nv_bfloat16, 8>, K,
                                       smem)
             : gn::max_active_clusters(gn_bwd_cluster<__nv_bfloat16, 1>, K,
                                       smem);
}

}  // extern "C"
