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
// grid (B,); on Hopper that gives B blocks, fewer than the 132 SMs at
// serving batch sizes, and a block per (batch, group) would read 8-byte
// fragments (channels of one group sit at stride C; C/G is 2 in the stem).
// So the work is split three ways:
//   1. gn_partial_stats: one block per (batch, chunk of rows).  Threads run
//      along C, so each warp reads whole rows coalesced.  Each channel's
//      (mean, M2) over the chunk comes from sums shifted by the chunk's first
//      value of that channel, so the centered variance survives a large
//      mean.  x is read here once.
//   2. gn_merge: one block per (batch, group) merges the chunk partials with
//      Chan's parallel (count, mean, M2) update into the group mean and rstd,
//      and writes the per-channel mean, rstd and the affine a, b.
//   3. gn_normalize: one elementwise pass, y = fma(x, a, b) (+ ReLU).  x is
//      read a second time here.  Where x outgrows the 50 MB L2 (the stem
//      at batch 32 holds 25.7 M elements) that read comes from device
//      memory, so this simple design moves up to 1.5x the minimum bytes.
//      Keeping a chunk on chip between the passes is later work.
//
// C interface (bound with ctypes): edl_group_norm_fwd returns 0 or the
// cudaError_t code of a refused launch.  It allocates nothing: the caller
// passes a float32 workspace of edl_group_norm_fwd_workspace(...) floats.

#include <algorithm>

#include "gn_common.cuh"

namespace {

using gn::from_f;
using gn::kThreads;
using gn::load_f;

// Partial (mean, M2) per (batch, chunk, channel) over `rows` rows.
// Thread t serves channel (t % tc) on row lane (t / tc): tc = min(C, 256)
// channels side by side, lanes = 256 / tc rows at a time.  With C > 256
// there is one lane and each thread walks C in steps of 256.
template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_partial_stats(const T* __restrict__ x, float* __restrict__ pmean,
                 float* __restrict__ pm2, int HW, int C, int rows,
                 int nchunks) {
  __shared__ float s1[kThreads];
  __shared__ float s2[kThreads];
  const int b = blockIdx.y;
  const int k = blockIdx.x;
  const int r0 = k * rows;
  const int n = min(rows, HW - r0);
  const int tc = min(C, kThreads);
  const int lanes = kThreads / tc;
  const int c0 = threadIdx.x % tc;
  const int lane = threadIdx.x / tc;
  const T* xb = x + ((int64_t)b * HW + r0) * C;
  for (int cb = 0; cb < C; cb += tc) {
    const int c = cb + c0;
    float a1 = 0.f, a2 = 0.f, shift = 0.f;
    if (lane < lanes && c < C) {
      shift = load_f(xb + c);
      for (int r = lane; r < n; r += lanes) {
        const float d = load_f(xb + (int64_t)r * C + c) - shift;
        a1 += d;
        a2 = fmaf(d, d, a2);
      }
    }
    s1[threadIdx.x] = a1;
    s2[threadIdx.x] = a2;
    __syncthreads();
    if (threadIdx.x < tc && c < C) {
      float t1 = 0.f, t2 = 0.f;
      for (int l = 0; l < lanes; ++l) {
        t1 += s1[l * tc + threadIdx.x];
        t2 += s2[l * tc + threadIdx.x];
      }
      const float inv = 1.f / (float)n;
      const int64_t o = ((int64_t)b * nchunks + k) * C + c;
      pmean[o] = shift + t1 * inv;
      pm2[o] = fmaxf(t2 - t1 * t1 * inv, 0.f);
    }
    __syncthreads();
  }
}

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

__global__ void __launch_bounds__(kThreads)
gn_merge(const float* __restrict__ pmean, const float* __restrict__ pm2,
         const float* __restrict__ scale, const float* __restrict__ bias,
         float* __restrict__ mean_out, float* __restrict__ rstd_out,
         float* __restrict__ coef_a, float* __restrict__ coef_b, int HW,
         int C, int G, int rows, int nchunks, float eps) {
  __shared__ float sn[kThreads];
  __shared__ float sm[kThreads];
  __shared__ float sq[kThreads];
  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int cpg = C / G;
  const int items = nchunks * cpg;
  float n = 0.f, m = 0.f, m2 = 0.f;
  for (int i = threadIdx.x; i < items; i += kThreads) {
    const int k = i / cpg;
    const int c = g * cpg + i % cpg;
    const int64_t o = ((int64_t)b * nchunks + k) * C + c;
    chan_merge(n, m, m2, (float)min(rows, HW - k * rows), pmean[o], pm2[o]);
  }
  sn[threadIdx.x] = n;
  sm[threadIdx.x] = m;
  sq[threadIdx.x] = m2;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
      float n0 = sn[threadIdx.x], m0 = sm[threadIdx.x],
            q0 = sq[threadIdx.x];
      chan_merge(n0, m0, q0, sn[threadIdx.x + s], sm[threadIdx.x + s],
                 sq[threadIdx.x + s]);
      sn[threadIdx.x] = n0;
      sm[threadIdx.x] = m0;
      sq[threadIdx.x] = q0;
    }
    __syncthreads();
  }
  const float mean = sm[0];
  const float rstd = rsqrtf(sq[0] / sn[0] + eps);
  for (int j = threadIdx.x; j < cpg; j += kThreads) {
    const int c = g * cpg + j;
    const int64_t o = (int64_t)b * C + c;
    // The backward re-derives the ReLU mask from the same a and b.
    const float a = gn::affine_a(rstd, scale[c]);
    mean_out[o] = mean;
    rstd_out[o] = rstd;
    coef_a[o] = a;
    coef_b[o] = gn::affine_b(bias[c], mean, a);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_normalize(const T* __restrict__ x, T* __restrict__ y,
             const float* __restrict__ coef_a,
             const float* __restrict__ coef_b, int hwc, int C, int relu) {
  // One batch row per blockIdx.y, so the channel index needs only a
  // 32-bit remainder.
  const int b = blockIdx.y;
  const T* xb = x + (int64_t)b * hwc;
  T* yb = y + (int64_t)b * hwc;
  const float* ab = coef_a + (int64_t)b * C;
  const float* bb = coef_b + (int64_t)b * C;
  for (int j = blockIdx.x * kThreads + threadIdx.x; j < hwc;
       j += gridDim.x * kThreads) {
    const int c = j % C;
    float v = fmaf(load_f(xb + j), __ldg(ab + c), __ldg(bb + c));
    if (relu) v = fmaxf(v, 0.f);
    yb[j] = from_f<T>(v);
  }
}

template <typename T>
void launch(const void* x, const float* scale, const float* bias, void* y,
            float* mean, float* rstd, float* work, int B, int HW, int C,
            int G, int rows, float eps, int relu, cudaStream_t stream) {
  const int nchunks = (HW + rows - 1) / rows;
  float* pmean = work;
  float* pm2 = pmean + (int64_t)B * nchunks * C;
  float* coef_a = pm2 + (int64_t)B * nchunks * C;
  float* coef_b = coef_a + (int64_t)B * C;
  gn_partial_stats<T><<<dim3(nchunks, B), kThreads, 0, stream>>>(
      static_cast<const T*>(x), pmean, pm2, HW, C, rows, nchunks);
  gn_merge<<<dim3(G, B), kThreads, 0, stream>>>(
      pmean, pm2, scale, bias, mean, rstd, coef_a, coef_b, HW, C, G, rows,
      nchunks, eps);
  const int hwc = HW * C;
  const int blocks = std::min((hwc + kThreads - 1) / kThreads, 1024);
  gn_normalize<T><<<dim3(blocks, B), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), coef_a, coef_b, hwc, C,
      relu);
}

}  // namespace

extern "C" {

// Floats of workspace edl_group_norm_fwd needs.
int64_t edl_group_norm_fwd_workspace(int B, int HW, int C, int rows) {
  const int64_t nchunks = (HW + rows - 1) / rows;
  return 2 * (int64_t)B * nchunks * C + 2 * (int64_t)B * C;
}

// dtype: 0 = float32, 1 = bfloat16.  scale, bias, mean, rstd and work are
// float32.  Returns 0, or the cudaError_t of a bad argument or refused
// launch.
int edl_group_norm_fwd(const void* x, const void* scale, const void* bias,
                       void* y, void* mean, void* rstd, void* work, int B,
                       int HW, int C, int G, int rows, float eps, int relu,
                       int dtype, void* stream) {
  if (B <= 0 || HW <= 0 || C <= 0 || G <= 0 || C % G != 0 || rows <= 0 ||
      B > 65535 || G > 65535 || (int64_t)HW * C > INT32_MAX ||
      (dtype != 0 && dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  // Clear an error left by an earlier launch, so that the code returned
  // below is this call's own.
  cudaGetLastError();
  const float* s = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(x, s, bi, y, static_cast<float*>(mean),
                  static_cast<float*>(rstd), static_cast<float*>(work), B,
                  HW, C, G, rows, eps, relu, st);
  } else {
    launch<__nv_bfloat16>(x, s, bi, y, static_cast<float*>(mean),
                          static_cast<float*>(rstd),
                          static_cast<float*>(work), B, HW, C, G, rows, eps,
                          relu, st);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
