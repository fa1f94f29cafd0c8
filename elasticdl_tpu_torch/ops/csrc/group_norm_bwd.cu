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
// rest on it).  So, in B1's image, four launches:
//   1. gn_bwd_partial: one block per (batch, chunk of rows), threads along
//      C (coalesced rows); per-(batch, chunk, channel) partial s1, s2.
//      Reads x and dy once.
//   2. gn_bwd_merge: one block per (batch, group): per channel, s1 and s2
//      summed over the chunks in chunk order; per group, the two means of
//      s * scale, by a fixed-shape tree in shared memory.
//   3. gn_bwd_affine: per channel, dscale and dbias summed over the batch
//      in batch order.
//   4. gn_bwd_dx: one elementwise pass; reads x and dy a second time.
// Every sum has a fixed order, so the result does not depend on how the
// blocks are scheduled.  Reading x and dy twice makes 5 passes over the
// data where 3 is the least; keeping a chunk on chip between passes 1
// and 4 is later work.
//
// C interface (bound with ctypes): edl_group_norm_bwd returns 0 or the
// cudaError_t code of a bad argument or refused launch.  It allocates
// nothing: the caller passes a float32 workspace of
// edl_group_norm_bwd_workspace(...) floats.

#include <algorithm>

#include "gn_common.cuh"

namespace {

using gn::from_f;
using gn::kThreads;
using gn::load_f;

// Partial s1, s2 per (batch, chunk, channel) over `rows` rows; the thread
// layout is gn_partial_stats' (group_norm.cu): tc = min(C, 256) channels
// side by side, lanes = 256 / tc rows at a time.
template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_bwd_partial(const T* __restrict__ x, const T* __restrict__ dy,
               const float* __restrict__ scale,
               const float* __restrict__ bias,
               const float* __restrict__ mean,
               const float* __restrict__ rstd, float* __restrict__ ps1,
               float* __restrict__ ps2, int HW, int C, int rows,
               int nchunks, int relu) {
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
  const int64_t base = ((int64_t)b * HW + r0) * C;
  const T* xb = x + base;
  const T* dyb = dy + base;
  for (int cb = 0; cb < C; cb += tc) {
    const int c = cb + c0;
    float a1 = 0.f, a2 = 0.f;
    if (lane < lanes && c < C) {
      const float m = mean[(int64_t)b * C + c];
      const float rs = rstd[(int64_t)b * C + c];
      const float a = gn::affine_a(rs, scale[c]);
      const float bb = gn::affine_b(bias[c], m, a);
      for (int r = lane; r < n; r += lanes) {
        const int64_t o = (int64_t)r * C + c;
        const float xv = load_f(xb + o);
        float g = load_f(dyb + o);
        if (relu && !(fmaf(xv, a, bb) > 0.f)) g = 0.f;
        a1 += g;
        a2 = fmaf(g, (xv - m) * rs, a2);
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
      const int64_t o = ((int64_t)b * nchunks + k) * C + c;
      ps1[o] = t1;
      ps2[o] = t2;
    }
    __syncthreads();
  }
}

// Per (batch, group): per-channel totals cs1, cs2 [B, C] over the chunks,
// and the group means gcoef[(b * G + g) * 2 + {0, 1}] of s1 * scale and
// s2 * scale.
__global__ void __launch_bounds__(kThreads)
gn_bwd_merge(const float* __restrict__ ps1, const float* __restrict__ ps2,
             const float* __restrict__ scale, float* __restrict__ cs1,
             float* __restrict__ cs2, float* __restrict__ gcoef, int HW,
             int C, int G, int nchunks) {
  __shared__ float t1[kThreads];
  __shared__ float t2[kThreads];
  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int cpg = C / G;
  float g1 = 0.f, g2 = 0.f;
  for (int j = threadIdx.x; j < cpg; j += kThreads) {
    const int c = g * cpg + j;
    float u1 = 0.f, u2 = 0.f;
    for (int k = 0; k < nchunks; ++k) {
      const int64_t o = ((int64_t)b * nchunks + k) * C + c;
      u1 += ps1[o];
      u2 += ps2[o];
    }
    cs1[(int64_t)b * C + c] = u1;
    cs2[(int64_t)b * C + c] = u2;
    g1 = fmaf(u1, scale[c], g1);
    g2 = fmaf(u2, scale[c], g2);
  }
  t1[threadIdx.x] = g1;
  t2[threadIdx.x] = g2;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
      t1[threadIdx.x] += t1[threadIdx.x + s];
      t2[threadIdx.x] += t2[threadIdx.x + s];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const float inv = 1.f / ((float)HW * (float)cpg);
    const int64_t o = ((int64_t)b * G + g) * 2;
    gcoef[o] = t1[0] * inv;
    gcoef[o + 1] = t2[0] * inv;
  }
}

__global__ void __launch_bounds__(kThreads)
gn_bwd_affine(const float* __restrict__ cs1, const float* __restrict__ cs2,
              float* __restrict__ dscale, float* __restrict__ dbias, int B,
              int C) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= C) return;
  float u1 = 0.f, u2 = 0.f;
  for (int b = 0; b < B; ++b) {
    u1 += cs1[(int64_t)b * C + c];
    u2 += cs2[(int64_t)b * C + c];
  }
  dbias[c] = u1;
  dscale[c] = u2;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_bwd_dx(const T* __restrict__ x, const T* __restrict__ dy,
          T* __restrict__ dx, const float* __restrict__ scale,
          const float* __restrict__ bias, const float* __restrict__ mean,
          const float* __restrict__ rstd, const float* __restrict__ gcoef,
          int hwc, int C, int G, int relu) {
  // One batch row per blockIdx.y, so the channel index needs only a
  // 32-bit remainder.
  const int b = blockIdx.y;
  const int cpg = C / G;
  const int64_t row = (int64_t)b * hwc;
  const float* mb = mean + (int64_t)b * C;
  const float* rb = rstd + (int64_t)b * C;
  const float* gb = gcoef + (int64_t)b * G * 2;
  for (int j = blockIdx.x * kThreads + threadIdx.x; j < hwc;
       j += gridDim.x * kThreads) {
    const int c = j % C;
    const float m = __ldg(mb + c);
    const float rs = __ldg(rb + c);
    const float sc = __ldg(scale + c);
    const float xv = load_f(x + row + j);
    float g = load_f(dy + row + j);
    if (relu) {
      const float a = gn::affine_a(rs, sc);
      if (!(fmaf(xv, a, gn::affine_b(__ldg(bias + c), m, a)) > 0.f)) {
        g = 0.f;
      }
    }
    const int gi = (c / cpg) * 2;
    const float xhat = (xv - m) * rs;
    const float v = rs * (g * sc - __ldg(gb + gi) - xhat * __ldg(gb + gi + 1));
    dx[row + j] = from_f<T>(v);
  }
}

template <typename T>
void launch(const void* x, const void* dy, const float* scale,
            const float* bias, const float* mean, const float* rstd,
            void* dx, float* dscale, float* dbias, float* work, int B,
            int HW, int C, int G, int rows, int relu, cudaStream_t stream) {
  const int nchunks = (HW + rows - 1) / rows;
  float* ps1 = work;
  float* ps2 = ps1 + (int64_t)B * nchunks * C;
  float* cs1 = ps2 + (int64_t)B * nchunks * C;
  float* cs2 = cs1 + (int64_t)B * C;
  float* gcoef = cs2 + (int64_t)B * C;
  const T* xt = static_cast<const T*>(x);
  const T* dyt = static_cast<const T*>(dy);
  gn_bwd_partial<T><<<dim3(nchunks, B), kThreads, 0, stream>>>(
      xt, dyt, scale, bias, mean, rstd, ps1, ps2, HW, C, rows, nchunks,
      relu);
  gn_bwd_merge<<<dim3(G, B), kThreads, 0, stream>>>(
      ps1, ps2, scale, cs1, cs2, gcoef, HW, C, G, nchunks);
  gn_bwd_affine<<<(C + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      cs1, cs2, dscale, dbias, B, C);
  const int hwc = HW * C;
  const int blocks = std::min((hwc + kThreads - 1) / kThreads, 1024);
  gn_bwd_dx<T><<<dim3(blocks, B), kThreads, 0, stream>>>(
      xt, dyt, static_cast<T*>(dx), scale, bias, mean, rstd, gcoef, hwc, C,
      G, relu);
}

}  // namespace

extern "C" {

// Floats of workspace edl_group_norm_bwd needs.
int64_t edl_group_norm_bwd_workspace(int B, int HW, int C, int G,
                                     int rows) {
  const int64_t nchunks = (HW + rows - 1) / rows;
  return 2 * (int64_t)B * nchunks * C + 2 * (int64_t)B * C +
         2 * (int64_t)B * G;
}

// dtype: 0 = float32, 1 = bfloat16 (x, dy and dx).  scale, bias, mean,
// rstd, dscale, dbias and work are float32.  Returns 0, or the cudaError_t
// of a bad argument or refused launch.
int edl_group_norm_bwd(const void* x, const void* dy, const void* scale,
                       const void* bias, const void* mean, const void* rstd,
                       void* dx, void* dscale, void* dbias, void* work,
                       int B, int HW, int C, int G, int rows, int relu,
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
  const float* m = static_cast<const float*>(mean);
  const float* r = static_cast<const float*>(rstd);
  float* ds = static_cast<float*>(dscale);
  float* db = static_cast<float*>(dbias);
  float* w = static_cast<float*>(work);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(x, dy, s, bi, m, r, dx, ds, db, w, B, HW, C, G, rows,
                  relu, st);
  } else {
    launch<__nv_bfloat16>(x, dy, s, bi, m, r, dx, ds, db, w, B, HW, C, G,
                          rows, relu, st);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
