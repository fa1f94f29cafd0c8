// Flash attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_flash_kernel` of
// elasticdl_tpu/ops/flash_attention.py (launched by `_flash_forward`).
// Computes, for q, k, v [B, H, T, D] (any strides with the last dim
// contiguous) in float32 or bfloat16:
//   s = (q k^T) * scale in f32, masked with -1e30 (causal: k > q; window W:
//       q - k >= W; ragged tail: k >= T);
//   online softmax over K tiles: m = running row max, p = exp(s - m),
//       l = running sum of p (f32), acc = acc * exp(m_old - m) + p v;
//   in bfloat16, p is rounded to bf16 before the p v product, as the TPU
//   kernel casts p to v's dtype; the product accumulates in f32;
//   out = acc / max(l, 1e-30) in q's dtype, and the f32 row stats l and m
//   [B, H, T] (the residuals the backward kernels read).
//
// What bounds it on this card.  At the flagship long prefill (B=8, H=16,
// T=2048, D=64, causal, bf16) the live (i, j) pairs number T(T+1)/2 per head,
// 4 D flops each (q k^T and p v): 68.75 GFLOP, 0.0695 ms at 989 TFLOP/s,
// against 136 MB of q, k, v, out, l, m, 0.041 ms at 3.35 TB/s: bound by
// tensor-core operations.  At the serving prompt (T=128) the same call moves
// 8.5 MB, 2.5 us, and is bound by bytes (launch latency dominates).  In f32
// there are no tensor cores for full-precision products: 1.03 ms per
// flagship call at 67 TFLOP/s.
//
// How it splits the work.  The TPU walked K/V tiles along a sequential grid
// axis, carrying (acc, l, m) in VMEM scratch.  Here one block owns one
// (batch*head, 64-row q tile) and loops over 64-row K/V tiles itself, so the
// loop takes the place of that grid axis; its 4 warps own 16 q rows each and
// share the K/V tiles in shared memory.  Tiles above the diagonal (causal)
// and below the band (window) are never loaded, and only tiles that cross
// the diagonal, the band's edge or the ragged tail are masked.  Blocks are
// scheduled heaviest first (causal q tiles near the end see the most keys),
// heads along the grid's fastest axis (measured faster than a head's q
// tiles together).
//
//  - bfloat16 (the served path), bound by tensor-core operations: both
//    products run on the tensor cores through mma.sync m16n8k16 (bf16 in,
//    f32 accumulate).  A warp keeps its q fragments, its 16 x 64 score tile,
//    its running (m, l) and its 16 x D accumulator in registers; the score
//    tile's accumulator layout is the layout of the p v product's A operand,
//    so p goes from the softmax to the tensor cores without touching shared
//    memory.  Scores are kept in log2 units, so each p is one exp2; row max
//    and sum take two shuffles within a quad of lanes.  K and V tiles are
//    double-buffered: cp.async fetches tile j + 1 while tile j is computed;
//    their B fragments come through ldmatrix (V's transposed).  For
//    D = 64 the registers are held to 128 a thread, so that four blocks
//    share an SM (scripts/sweep_flash_attention.py measured it faster than
//    the two blocks that the compiler's own register count leaves room for).
//  - float32, bound by the CUDA cores' f32 rate (TF32 would lose the
//    float32 accuracy this path promises): FMA products over tiles in
//    shared memory, the online softmax one row at a time with warp
//    shuffles.  It is the simple design.
//
// Not done yet (later work): wgmma, TMA, warp specialisation, a persistent
// schedule.
//
// C interface (bound with ctypes): edl_flash_attention_fwd returns 0 or the
// cudaError_t code of a refused launch.  It allocates nothing: the caller
// passes out, l and m.  It launches on the given stream.

#include "flash_common.cuh"

namespace {

using namespace flash;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* l;
  float* m;
  int H, T, causal, window;
  float scale;
  Strides sq, sk, sv, so;
};

// ---------------------------------------------------------------------------
// bfloat16: mma.sync m16n8k16, registers, double-buffered cp.async tiles.
// ---------------------------------------------------------------------------

template <int D> struct Bf16Smem {
  static constexpr int kPitch = kPitchBf16<D>;
  static constexpr int kTile = align128(kBQ * kPitch * 2);
  static constexpr int q = 0;
  static constexpr int k = q + kTile;
  static constexpr int v = k + kStages * kTile;
  static constexpr int bytes = v + kStages * kTile;
};

template <int D, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
flash_fwd_bf16(Params prm) {
  using L = Bf16Smem<D>;
  constexpr int kPitch = L::kPitch;
  constexpr int kDSteps = D / 16;     // k-steps of q k^T
  constexpr int kDTiles = D / 8;      // n-tiles of p v
  constexpr int kKTiles = kBK / 8;    // n-tiles of q k^T (keys)
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem + L::q);
  bf16* sK = reinterpret_cast<bf16*>(smem + L::k);
  bf16* sV = reinterpret_cast<bf16*>(smem + L::v);
  constexpr int kTileElems = L::kTile / 2;

  const int Tlen = prm.T;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int b = bh / prm.H, h = bh % prm.H;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + warp * kRows + g;   // this lane's rows: row0, +8

  const bf16* q =
      static_cast<const bf16*>(prm.q) + b * prm.sq.b + h * prm.sq.h;
  const bf16* k =
      static_cast<const bf16*>(prm.k) + b * prm.sk.b + h * prm.sk.h;
  const bf16* v =
      static_cast<const bf16*>(prm.v) + b * prm.sv.b + h * prm.sv.h;

  int k_begin, k_end;
  key_range(prm, q0, &k_begin, &k_end);
  const int n_tiles = (k_end - k_begin + kBK - 1) / kBK;

  // One cp.async group per K/V tile (q rides with the first): tile
  // j + kStages - 1 is fetched while tile j is computed.
  fetch_tile<D>(sQ, q, prm.sq.t, q0, Tlen);
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_tiles) {
      const int r0 = k_begin + st * kBK;
      fetch_tile<D>(sK + st * kTileElems, k, prm.sk.t, r0, Tlen);
      fetch_tile<D>(sV + st * kTileElems, v, prm.sv.t, r0, Tlen);
    }
    cp_async_commit();
  }

  uint32_t qf[kDSteps][4];
  float o[kDTiles][4];
#pragma unroll
  for (int n = 0; n < kDTiles; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = k_begin + j * kBK;
    const int buf = j % kStages;
    {
      const int ahead = j + kStages - 1;
      if (ahead < n_tiles) {
        const int ab = ahead % kStages, r0 = k_begin + ahead * kBK;
        fetch_tile<D>(sK + ab * kTileElems, k, prm.sk.t, r0, Tlen);
        fetch_tile<D>(sV + ab * kTileElems, v, prm.sv.t, r0, Tlen);
      }
      cp_async_commit();
      cp_async_wait<kStages - 1>();
    }
    __syncthreads();
    if (j == 0) load_a<D, kPitch>(qf, sQ + warp * kRows * kPitch, lane);
    const bf16* kt = sK + buf * kTileElems;
    const bf16* vt = sV + buf * kTileElems;

    // s = q k^T for this warp's 16 rows and the tile's 64 keys, 16 keys
    // (two n-tiles) per call.
    float s[kKTiles][4] = {};
#pragma unroll
    for (int c = 0; c < kBK / 16; ++c)
      mma_abt<D, kPitch>(s + 2 * c, qf, kt + c * 16 * kPitch, lane);

    // Scale, mask, online softmax for rows row0 (half 0) and row0 + 8.
    // Scores are kept in log2 units (s * scale * log2 e), so that p is
    // one exp2; m is turned back into natural units at the end.
    const float scale_log2 = prm.scale * kLog2e;
    const bool unmasked = tile_unmasked(prm, q0, k0);
    float m_tile[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < kKTiles; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int half = e >> 1;
        float x = s[n][e] * scale_log2;
        const int kj = k0 + n * 8 + 2 * t + (e & 1);
        if (!unmasked && !keep(prm, row0 + 8 * half, kj)) x = kNegInf;
        s[n][e] = x;
        m_tile[half] = fmaxf(m_tile[half], x);
      }
    }
    float alpha[2], row_sum[2] = {0.f, 0.f};
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float mt = m_tile[half];
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      const float m_new = fmaxf(m_run[half], mt);
      alpha[half] = exp2f(m_run[half] - m_new);
      m_run[half] = m_new;
    }
#pragma unroll
    for (int n = 0; n < kKTiles; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int half = e >> 1;
        const float p = exp2f(s[n][e] - m_run[half]);
        s[n][e] = p;
        row_sum[half] += p;
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float rs = row_sum[half];
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      l_run[half] = l_run[half] * alpha[half] + rs;
    }
#pragma unroll
    for (int n = 0; n < kDTiles; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // o += p v: p (rounded to bf16) is the A operand straight from the
    // score accumulators; V's B fragments come transposed by ldmatrix.
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t pa[4];
      pack_a(pa, s[2 * kk], s[2 * kk + 1]);
      mma_ab<D, kPitch>(o, pa, vt + kk * 16 * kPitch, lane);
    }
    __syncthreads();   // the next fetch overwrites the buffer just read
  }

  bf16* out = static_cast<bf16*>(prm.o) + b * prm.so.b + h * prm.so.h;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qi = row0 + 8 * half;
    if (qi >= Tlen) continue;
    const float l_safe = fmaxf(l_run[half], 1e-30f);
    bf16* orow = out + (long long)qi * prm.so.t + 2 * t;
#pragma unroll
    for (int n = 0; n < kDTiles; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) = __floats2bfloat162_rn(
          o[n][2 * half] / l_safe, o[n][2 * half + 1] / l_safe);
    }
    if (t == 0) {
      prm.l[(long long)bh * Tlen + qi] = l_run[half];
      prm.m[(long long)bh * Tlen + qi] = m_run[half] * kLn2;
    }
  }
}

// ---------------------------------------------------------------------------
// float32: FMA over shared-memory tiles, the online softmax row by row.
// ---------------------------------------------------------------------------

template <int D> struct F32Smem {
  static constexpr int kPitch = kPitchF32<D>;
  static constexpr int kSPitch = kBK + 4;  // scores, then p in place
  static constexpr int kOPitch = D + 4;
  static constexpr int q = 0;
  static constexpr int k = q + align128(kBQ * kPitch * 4);
  static constexpr int v = k + align128(kBK * kPitch * 4);
  static constexpr int s = v + align128(kBK * kPitch * 4);
  static constexpr int o = s + align128(kBQ * kSPitch * 4);
  static constexpr int bytes = o + align128(kBQ * kOPitch * 4);
};

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32(Params prm) {
  using L = F32Smem<D>;
  constexpr int kPitch = L::kPitch;
  constexpr int kSPitch = L::kSPitch;
  constexpr int kOPitch = L::kOPitch;
  constexpr int kCols = D / 32;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem + L::q);
  float* sK = reinterpret_cast<float*>(smem + L::k);
  float* sV = reinterpret_cast<float*>(smem + L::v);
  float* sS = reinterpret_cast<float*>(smem + L::s);
  float* sO = reinterpret_cast<float*>(smem + L::o);

  const int Tlen = prm.T;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int b = bh / prm.H, h = bh % prm.H;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  const float* q =
      static_cast<const float*>(prm.q) + b * prm.sq.b + h * prm.sq.h;
  const float* k =
      static_cast<const float*>(prm.k) + b * prm.sk.b + h * prm.sk.h;
  const float* v =
      static_cast<const float*>(prm.v) + b * prm.sv.b + h * prm.sv.h;

  load_tile_f32<D>(sQ, q, prm.sq.t, q0, Tlen);
  for (int i = threadIdx.x; i < kBQ * kOPitch; i += kThreads) sO[i] = 0.f;

  int k_begin, k_end;
  key_range(prm, q0, &k_begin, &k_end);

  float m_row[kRows], l_row[kRows], alpha[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m_row[r] = kNegInf;
    l_row[r] = 0.f;
  }
  const int row0 = q0 + warp * kRows;
  const float* qw = sQ + warp * kRows * kPitch;
  float* s_w = sS + warp * kRows * kSPitch;
  float* o_w = sO + warp * kRows * kOPitch;

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();   // the previous tile's K and V are no longer read
    load_tile_f32<D>(sK, k, prm.sk.t, k0, Tlen);
    load_tile_f32<D>(sV, v, prm.sv.t, k0, Tlen);
    __syncthreads();

    // Scores: lanes hold keys lane and lane + 32 of the tile.
    {
      float acc[kRows][2];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r][0] = acc[r][1] = 0.f;
      const float* k_lo = sK + lane * kPitch;
      const float* k_hi = sK + (lane + 32) * kPitch;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float a = k_lo[d], c = k_hi[d];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float qv = qw[r * kPitch + d];
          acc[r][0] = fmaf(qv, a, acc[r][0]);
          acc[r][1] = fmaf(qv, c, acc[r][1]);
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        s_w[r * kSPitch + lane] = acc[r][0];
        s_w[r * kSPitch + lane + 32] = acc[r][1];
      }
    }
    __syncwarp();

    // Masked online softmax, one row at a time; p overwrites s.
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qi = row0 + r;
      float s2[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = lane + 32 * half;
        const float x = s_w[r * kSPitch + c] * prm.scale;
        s2[half] = keep(prm, qi, k0 + c) ? x : kNegInf;
      }
      const float m_new = fmaxf(m_row[r], warp_max(fmaxf(s2[0], s2[1])));
      alpha[r] = expf(m_row[r] - m_new);
      const float p0 = expf(s2[0] - m_new);
      const float p1 = expf(s2[1] - m_new);
      l_row[r] = l_row[r] * alpha[r] + warp_sum(p0 + p1);
      m_row[r] = m_new;
      s_w[r * kSPitch + lane] = p0;
      s_w[r * kSPitch + lane + 32] = p1;
    }
    __syncwarp();

    // acc rows of this warp: acc = acc * alpha_row + p v.
    {
      float acc[kRows][kCols];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int i = 0; i < kCols; ++i) acc[r][i] = 0.f;
#pragma unroll 2
      for (int jj = 0; jj < kBK; ++jj) {
        float vj[kCols];
#pragma unroll
        for (int i = 0; i < kCols; ++i) vj[i] = sV[jj * kPitch + lane + 32 * i];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float pr = s_w[r * kSPitch + jj];
#pragma unroll
          for (int i = 0; i < kCols; ++i)
            acc[r][i] = fmaf(pr, vj[i], acc[r][i]);
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int i = 0; i < kCols; ++i) {
          float& dst = o_w[r * kOPitch + lane + 32 * i];
          dst = fmaf(dst, alpha[r], acc[r][i]);
        }
    }
  }
  __syncwarp();

  float* out = static_cast<float*>(prm.o) + b * prm.so.b + h * prm.so.h;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qi = row0 + r;
    if (qi >= Tlen) break;
    const float l_safe = fmaxf(l_row[r], 1e-30f);
    for (int c = lane; c < D; c += 32) {
      out[(long long)qi * prm.so.t + c] = o_w[r * kOPitch + c] / l_safe;
    }
    if (lane == 0) {
      prm.l[(long long)bh * Tlen + qi] = l_row[r];
      prm.m[(long long)bh * Tlen + qi] = m_row[r];
    }
  }
}

}  // namespace

extern "C" {

// q, k, v, o: [B, H, T, D] with element strides (batch, head, seq) given and
// the last dim contiguous, 16-byte aligned rows; l, m: contiguous [B, H, T]
// float32.  dtype 0 = float32, 1 = bfloat16; D must be 64 or 128.
int edl_flash_attention_fwd(const void* q, const void* k, const void* v,
                            void* o, float* l, float* m, int B, int H, int T,
                            int D, long long q_sb, long long q_sh,
                            long long q_st, long long k_sb, long long k_sh,
                            long long k_st, long long v_sb, long long v_sh,
                            long long v_st, long long o_sb, long long o_sh,
                            long long o_st, float scale, int causal,
                            int window, int dtype, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || T <= 0) return (int)cudaSuccess;
  Params prm;
  prm.q = q;
  prm.k = k;
  prm.v = v;
  prm.o = o;
  prm.l = l;
  prm.m = m;
  prm.H = H;
  prm.T = T;
  prm.causal = causal;
  prm.window = window;
  prm.scale = scale;
  prm.sq = {q_sb, q_sh, q_st};
  prm.sk = {k_sb, k_sh, k_st};
  prm.sv = {v_sb, v_sh, v_st};
  prm.so = {o_sb, o_sh, o_st};
  const dim3 grid(B * H, (T + kBQ - 1) / kBQ);
  if (dtype == 1) {
    if (D == 64)
      return launch(flash_fwd_bf16<64, 4>, Bf16Smem<64>::bytes, prm, grid,
                    stream);
    if (D == 128)
      return launch(flash_fwd_bf16<128, 1>, Bf16Smem<128>::bytes, prm, grid,
                    stream);
  } else if (dtype == 0) {
    if (D == 64)
      return launch(flash_fwd_f32<64>, F32Smem<64>::bytes, prm, grid,
                    stream);
    if (D == 128)
      return launch(flash_fwd_f32<128>, F32Smem<128>::bytes, prm, grid,
                    stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
