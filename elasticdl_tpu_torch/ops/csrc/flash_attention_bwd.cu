// Flash attention backward for Hopper (sm_90a): dq (B4) and dk, dv (B5).
//
// Replaces the TPU kernels `_bwd_dq_kernel` and `_bwd_dkv_kernel` of
// elasticdl_tpu/ops/flash_attention.py (both launched by `_pallas_bwd`).
// From the forward's residuals q, k, v, out (o) [B, H, T, D] and its f32 row
// stats l, m [B, H, T], and the incoming gradient g = dO (any strides with
// the last dim contiguous, float32 or bfloat16), with s = (q k^T) * scale
// masked with -1e30 (causal: k > q; window W: q - k >= W; ragged: k or q at
// or past T):
//   p  = exp(s - m) / max(l, 1e-30)              (f32, rebuilt per tile)
//   dp = dO v^T                                    (f32 accumulate)
//   delta = rowsum(dO * O)                         (f32, from the inputs
//                                                   upcast)
//   ds = p * (dp - delta) * scale, rounded to the input dtype
//   dq = ds k,  dk = ds^T q,  dv = p^T dO, with p rounded to the input dtype
//   before the dv product; every product accumulates in f32 and is written
//   in its input's dtype.  The roundings are the TPU kernels'.
//
// B4 (edl_flash_attention_bwd_dq): one block per (batch*head, 64-row q
// tile) loops over the live 64-key K/V tiles, as the TPU's K grid axis
// did; q, dO and the row stats stay resident, dq accumulates in f32
// registers.  It also computes delta for its rows and writes it to a
// [B, H, T] f32 scratch that B5 reads, so the rowsum is taken once.
// B5 (edl_flash_attention_bwd_dkv): one block per (batch*head, 64-key
// tile) loops over the live q tiles; k, v and both f32 accumulators stay
// resident.  Launch B5 after B4 on the same stream.  Each dq, dk and dv
// tile belongs to one block and no atomics are used, so two runs are
// bitwise equal.  Tiles above the diagonal (causal) and beyond the band
// (window) are never loaded, and within a loaded tile each warp skips the
// 16-wide chunks that are wholly masked for its 16 rows (a masked p is 0,
// so its terms are exactly 0 and skipping them changes no bit).
//
// What bounds it on this card.  At the flagship training shape (B=8, H=16,
// T=2048, D=64, causal, bf16) there are T(T+1)/2 live (query, key) pairs
// per head, 268.6 M in all.  B4 does q k^T, dO v^T and ds k per pair: 6 D =
// 384 operations, 103.1 GFLOP, 0.104 ms at 989 TFLOP/s, against ~203 MB of
// compulsory bytes (q, k, v, o, dO read, dq written, l, m read, delta
// written), 0.061 ms at 3.35 TB/s.  B5 does q k^T, dO v^T, p^T dO and
// ds^T q: 8 D = 512 operations, 137.5 GFLOP, 0.139 ms, against ~237 MB,
// 0.071 ms.  Both are bound by tensor-core operations; in f32 (FMA, no
// tensor cores: TF32 would lose the float32 accuracy this path promises)
// 1.54 ms and 2.05 ms at 67 TFLOP/s.
//
// What the design does about it.  bf16 runs every product on the tensor
// cores through mma.sync m16n8k16 (bf16 in, f32 accumulate), as the
// forward (flash_attention.cu) does: score and dp tiles live in registers,
// are turned into p and ds there, and go from the accumulator layout
// straight into the next product's A operand (pack_a) without touching
// shared memory.  The streamed tiles are double-buffered with cp.async.
// Scores are rebuilt in log2 units (p = exp2(s * scale * log2 e - m *
// log2 e) / l), the forward's units.  The work is cut into 16-wide chunks,
// so a warp holds a 16 x 16 score tile and a 16 x 16 dp tile at a time, not
// 16 x 64: registers set occupancy here, as they did for the forward.
// For D = 64 the A fragments of the resident tiles (q and dO in B4, k and
// v in B5) are kept in registers and the register count is capped (B4 at
// 128 a thread, 4 blocks per SM; B5 at 168, 3 blocks); for D = 128 they are
// reloaded from shared memory for each chunk.  float32 is the simple
// design: FMA products over shared tiles, p and ds through shared memory.
//
// Not done yet (later work): wgmma, TMA, warp specialisation, one fused
// kernel for dq, dk and dv.
//
// C interface (bound with ctypes): both functions take the same arguments
// and return 0 or the cudaError_t code of a refused launch.  They allocate
// nothing and launch on the given stream.

#include "flash_common.cuh"

namespace {

using namespace flash;

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* g;
  void* dq;
  void* dk;
  void* dv;
  const float* l;
  const float* m;
  float* delta;
  int H, T, causal, window;
  float scale;
  Strides sq, sk, sv, so, sg, sdq, sdk, sdv;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename E>
__device__ __forceinline__ const E* slice(const void* base, const Strides& s,
                                          int b, int h) {
  return static_cast<const E*>(base) + b * s.b + h * s.h;
}

template <typename E>
__device__ __forceinline__ E* slice(void* base, const Strides& s, int b,
                                    int h) {
  return static_cast<E*>(base) + b * s.b + h * s.h;
}

// delta = rowsum(dO * O) in f32 for the 64 rows at q0, two threads per
// row; into sDelta (0 past T) and prm.delta (rows before T).
template <typename E, int D>
__device__ __forceinline__ void row_delta(const BwdParams& prm, int bh, int b,
                                          int h, int q0, float* sDelta) {
  static_assert(kThreads == 2 * kBQ, "two threads per row");
  const int r = threadIdx.x >> 1, part = threadIdx.x & 1;
  const int qi = q0 + r;
  float acc = 0.f;
  if (qi < prm.T) {
    const E* o = slice<E>(prm.o, prm.so, b, h) + (long long)qi * prm.so.t;
    const E* g = slice<E>(prm.g, prm.sg, b, h) + (long long)qi * prm.sg.t;
#pragma unroll 8
    for (int c = part * (D / 2); c < (part + 1) * (D / 2); ++c)
      acc = fmaf(to_f32(g[c]), to_f32(o[c]), acc);
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  if (part == 0) {
    sDelta[r] = acc;
    if (qi < prm.T) prm.delta[(long long)bh * prm.T + qi] = acc;
  }
}

// The q range that the key tile at k0 is attended by (causal: from the
// tile's own rows; a window: up to the last row whose band reaches it).
__device__ __forceinline__ void query_range(const BwdParams& prm, int k0,
                                            int* q_begin, int* q_end) {
  *q_begin = 0;
  *q_end = prm.T;
  if (prm.causal) {
    *q_begin = k0;
    if (prm.window > 0) *q_end = min(prm.T, k0 + kBK - 1 + prm.window);
  }
}

// True when every pair of the 16 rows at r0 and the 16 keys at c0 is
// masked (rows attend only keys at or before them, within the window).
__device__ __forceinline__ bool chunk_dead(const BwdParams& prm, int r0,
                                           int c0) {
  if (!prm.causal) return false;
  if (c0 > r0 + kRows - 1) return true;
  return prm.window > 0 && r0 - (c0 + kRows - 1) >= prm.window;
}

// ---------------------------------------------------------------------------
// bfloat16: mma.sync m16n8k16, 16-wide chunks in registers, double-buffered
// cp.async tiles.
// ---------------------------------------------------------------------------

template <int D> struct DqSmem {
  static constexpr int kPitch = kPitchBf16<D>;
  static constexpr int kTile = align128(kBQ * kPitch * 2);
  static constexpr int q = 0;
  static constexpr int g = q + kTile;
  static constexpr int k = g + kTile;
  static constexpr int v = k + kStages * kTile;
  static constexpr int delta = v + kStages * kTile;
  static constexpr int bytes = delta + align128(kBQ * 4);
};

template <int D, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
bwd_dq_bf16(BwdParams prm) {
  using L = DqSmem<D>;
  constexpr int kPitch = L::kPitch;
  constexpr int kTileElems = L::kTile / 2;
  constexpr int kDSteps = D / 16;
  constexpr bool kResident = D == 64;  // q, dO A fragments in registers
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem + L::q);
  bf16* sG = reinterpret_cast<bf16*>(smem + L::g);
  bf16* sK = reinterpret_cast<bf16*>(smem + L::k);
  bf16* sV = reinterpret_cast<bf16*>(smem + L::v);
  float* sDelta = reinterpret_cast<float*>(smem + L::delta);

  const int Tlen = prm.T;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heaviest first
  const int b = bh / prm.H, h = bh % prm.H;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = q0 + warp * kRows;  // the warp's first row
  const int row0 = wrow + g;           // this lane's rows: row0, row0 + 8

  const bf16* k = slice<bf16>(prm.k, prm.sk, b, h);
  const bf16* v = slice<bf16>(prm.v, prm.sv, b, h);
  int k_begin, k_end;
  key_range(prm, q0, &k_begin, &k_end);
  const int n_tiles = (k_end - k_begin + kBK - 1) / kBK;

  // One cp.async group per K/V tile (q and dO ride with the first).
  fetch_tile<D>(sQ, slice<bf16>(prm.q, prm.sq, b, h), prm.sq.t, q0, Tlen);
  fetch_tile<D>(sG, slice<bf16>(prm.g, prm.sg, b, h), prm.sg.t, q0, Tlen);
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_tiles) {
      const int r0 = k_begin + st * kBK;
      fetch_tile<D>(sK + st * kTileElems, k, prm.sk.t, r0, Tlen);
      fetch_tile<D>(sV + st * kTileElems, v, prm.sv.t, r0, Tlen);
    }
    cp_async_commit();
  }
  row_delta<bf16, D>(prm, bh, b, h, q0, sDelta);

  // Row stats: m in log2 units, 1 / max(l, 1e-30); delta after the sync.
  float m2[2], il[2], dl[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qi = row0 + 8 * half;
    const bool in = qi < Tlen;
    m2[half] = in ? prm.m[(long long)bh * Tlen + qi] * kLog2e : 0.f;
    il[half] = in ? 1.f / fmaxf(prm.l[(long long)bh * Tlen + qi], 1e-30f)
                  : 0.f;
  }
  const float scale_log2 = prm.scale * kLog2e;

  uint32_t qf[kResident ? kDSteps : 1][4], gf[kResident ? kDSteps : 1][4];
  float dq[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;

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
    if (j == 0) {
      dl[0] = sDelta[warp * kRows + g];
      dl[1] = sDelta[warp * kRows + g + 8];
      if constexpr (kResident) {
        load_a<D, kPitch>(qf, sQ + warp * kRows * kPitch, lane);
        load_a<D, kPitch>(gf, sG + warp * kRows * kPitch, lane);
      }
    }
    const bf16* kt = sK + buf * kTileElems;
    const bf16* vt = sV + buf * kTileElems;
    const bool unmasked = tile_unmasked(prm, q0, k0);

#pragma unroll 1
    for (int c = 0; c < kBK / 16; ++c) {
      const int kc = k0 + c * 16;
      if (kc >= Tlen) break;
      if (chunk_dead(prm, wrow, kc)) continue;
      // s = q k^T and dp = dO v^T for the warp's 16 rows and 16 keys.
      float s[2][4] = {}, dp[2][4] = {};
      if constexpr (kResident) {
        mma_abt<D, kPitch>(s, qf, kt + c * 16 * kPitch, lane);
        mma_abt<D, kPitch>(dp, gf, vt + c * 16 * kPitch, lane);
      } else {
        uint32_t a[kDSteps][4];
        load_a<D, kPitch>(a, sQ + warp * kRows * kPitch, lane);
        mma_abt<D, kPitch>(s, a, kt + c * 16 * kPitch, lane);
        load_a<D, kPitch>(a, sG + warp * kRows * kPitch, lane);
        mma_abt<D, kPitch>(dp, a, vt + c * 16 * kPitch, lane);
      }
      // p, then ds = p (dp - delta) scale in place of s.
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int half = e >> 1;
          const int kj = kc + n * 8 + 2 * t + (e & 1);
          float p = 0.f;
          if (unmasked || keep(prm, row0 + 8 * half, kj))
            p = exp2f(s[n][e] * scale_log2 - m2[half]) * il[half];
          s[n][e] = p * (dp[n][e] - dl[half]) * prm.scale;
        }
      }
      // dq += ds k: ds (rounded to bf16) is the A operand straight from
      // the accumulators; k's B fragments come transposed by ldmatrix.
      uint32_t da[4];
      pack_a(da, s[0], s[1]);
      mma_ab<D, kPitch>(dq, da, kt + c * 16 * kPitch, lane);
    }
    __syncthreads();  // the next fetch overwrites the buffer just read
  }

  bf16* out = slice<bf16>(prm.dq, prm.sdq, b, h);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qi = row0 + 8 * half;
    if (qi >= Tlen) continue;
    bf16* orow = out + (long long)qi * prm.sdq.t + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) =
          __floats2bfloat162_rn(dq[n][2 * half], dq[n][2 * half + 1]);
  }
}

template <int D> struct DkvSmem {
  static constexpr int kPitch = kPitchBf16<D>;
  static constexpr int kTile = align128(kBQ * kPitch * 2);
  static constexpr int kStats = 3 * kBQ;  // m, l, delta of one q tile
  static constexpr int k = 0;
  static constexpr int v = k + kTile;
  static constexpr int q = v + kTile;
  static constexpr int g = q + kStages * kTile;
  static constexpr int stats = g + kStages * kTile;
  static constexpr int bytes = stats + align128(kStages * kStats * 4);
};

template <int D, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
bwd_dkv_bf16(BwdParams prm) {
  using L = DkvSmem<D>;
  constexpr int kPitch = L::kPitch;
  constexpr int kTileElems = L::kTile / 2;
  constexpr int kDSteps = D / 16;
  constexpr bool kResident = D == 64;  // k, v A fragments in registers
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem + L::k);
  bf16* sV = reinterpret_cast<bf16*>(smem + L::v);
  bf16* sQ = reinterpret_cast<bf16*>(smem + L::q);
  bf16* sG = reinterpret_cast<bf16*>(smem + L::g);
  float* sStats = reinterpret_cast<float*>(smem + L::stats);

  const int Tlen = prm.T;
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kBK;  // causal: the first keys see the most
  const int b = bh / prm.H, h = bh % prm.H;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wkey = k0 + warp * kRows;  // the warp's first key
  const int key0 = wkey + g;           // this lane's keys: key0, key0 + 8

  const bf16* q = slice<bf16>(prm.q, prm.sq, b, h);
  const bf16* gr = slice<bf16>(prm.g, prm.sg, b, h);
  const long long stat0 = (long long)bh * Tlen;
  int q_begin, q_end;
  query_range(prm, k0, &q_begin, &q_end);
  const int n_tiles = (q_end - q_begin + kBQ - 1) / kBQ;

  auto fetch_q_tile = [&](int stage, int r0) {
    fetch_tile<D>(sQ + stage * kTileElems, q, prm.sq.t, r0, Tlen);
    fetch_tile<D>(sG + stage * kTileElems, gr, prm.sg.t, r0, Tlen);
    float* st = sStats + stage * L::kStats;
    fetch_row_stats(st, prm.m + stat0, r0, Tlen);
    fetch_row_stats(st + kBQ, prm.l + stat0, r0, Tlen);
    fetch_row_stats(st + 2 * kBQ, prm.delta + stat0, r0, Tlen);
  };

  // One cp.async group per q tile (k and v ride with the first).
  fetch_tile<D>(sK, slice<bf16>(prm.k, prm.sk, b, h), prm.sk.t, k0, Tlen);
  fetch_tile<D>(sV, slice<bf16>(prm.v, prm.sv, b, h), prm.sv.t, k0, Tlen);
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_tiles) fetch_q_tile(st, q_begin + st * kBQ);
    cp_async_commit();
  }

  const float scale_log2 = prm.scale * kLog2e;
  uint32_t kf[kResident ? kDSteps : 1][4], vf[kResident ? kDSteps : 1][4];
  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = 0.f;
    dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.f;
  }

  for (int j = 0; j < n_tiles; ++j) {
    const int q0 = q_begin + j * kBQ;
    const int buf = j % kStages;
    {
      const int ahead = j + kStages - 1;
      if (ahead < n_tiles) fetch_q_tile(ahead % kStages, q_begin + ahead * kBQ);
      cp_async_commit();
      cp_async_wait<kStages - 1>();
    }
    __syncthreads();
    if constexpr (kResident) {
      if (j == 0) {
        load_a<D, kPitch>(kf, sK + warp * kRows * kPitch, lane);
        load_a<D, kPitch>(vf, sV + warp * kRows * kPitch, lane);
      }
    }
    const bf16* qt = sQ + buf * kTileElems;
    const bf16* gt = sG + buf * kTileElems;
    const float* st = sStats + buf * L::kStats;
    const bool unmasked = tile_unmasked(prm, q0, k0);

#pragma unroll 1
    for (int c = 0; c < kBQ / 16; ++c) {
      const int qc = q0 + c * 16;
      if (qc >= Tlen) break;
      if (chunk_dead(prm, qc, wkey)) continue;
      // s^T = k q^T and dp^T = v dO^T: rows are the warp's 16 keys,
      // columns the chunk's 16 queries.
      float s[2][4] = {}, dp[2][4] = {};
      if constexpr (kResident) {
        mma_abt<D, kPitch>(s, kf, qt + c * 16 * kPitch, lane);
        mma_abt<D, kPitch>(dp, vf, gt + c * 16 * kPitch, lane);
      } else {
        uint32_t a[kDSteps][4];
        load_a<D, kPitch>(a, sK + warp * kRows * kPitch, lane);
        mma_abt<D, kPitch>(s, a, qt + c * 16 * kPitch, lane);
        load_a<D, kPitch>(a, sV + warp * kRows * kPitch, lane);
        mma_abt<D, kPitch>(dp, a, gt + c * 16 * kPitch, lane);
      }
      // The stats of the four queries (columns) this lane holds.
      float m2[2][2], il[2][2], dl[2][2];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int col = c * 16 + n * 8 + 2 * t + i;
          m2[n][i] = st[col] * kLog2e;
          il[n][i] = 1.f / fmaxf(st[kBQ + col], 1e-30f);
          dl[n][i] = st[2 * kBQ + col];
        }
      }
      // p^T, then ds^T = p^T (dp^T - delta) scale in place of s^T.
      float p[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e & 1;
          const int qi = qc + n * 8 + 2 * t + i;
          float pe = 0.f;
          if (unmasked || keep(prm, qi, key0 + 8 * (e >> 1)))
            pe = exp2f(s[n][e] * scale_log2 - m2[n][i]) * il[n][i];
          p[n][e] = pe;
          s[n][e] = pe * (dp[n][e] - dl[n][i]) * prm.scale;
        }
      }
      // dv += p^T dO and dk += ds^T q, the A operands (rounded to bf16)
      // straight from the accumulators, dO's and q's B fragments
      // transposed by ldmatrix.
      uint32_t a[4];
      pack_a(a, p[0], p[1]);
      mma_ab<D, kPitch>(dv, a, gt + c * 16 * kPitch, lane);
      pack_a(a, s[0], s[1]);
      mma_ab<D, kPitch>(dk, a, qt + c * 16 * kPitch, lane);
    }
    __syncthreads();  // the next fetch overwrites the buffer just read
  }

  bf16* dk_out = slice<bf16>(prm.dk, prm.sdk, b, h);
  bf16* dv_out = slice<bf16>(prm.dv, prm.sdv, b, h);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int kj = key0 + 8 * half;
    if (kj >= Tlen) continue;
    bf16* krow = dk_out + (long long)kj * prm.sdk.t + 2 * t;
    bf16* vrow = dv_out + (long long)kj * prm.sdv.t + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(krow + n * 8) =
          __floats2bfloat162_rn(dk[n][2 * half], dk[n][2 * half + 1]);
      *reinterpret_cast<__nv_bfloat162*>(vrow + n * 8) =
          __floats2bfloat162_rn(dv[n][2 * half], dv[n][2 * half + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// float32: FMA over shared-memory tiles, p and ds through shared memory.
// Lanes hold two of a tile's 64 columns (lane, lane + 32) while scores
// are built, and D / 32 output columns (lane + 32 i) while products
// accumulate.
// ---------------------------------------------------------------------------

template <int D> struct DqSmemF32 {
  static constexpr int kPitch = kPitchF32<D>;
  static constexpr int kSPitch = kBK + 4;  // p, then ds in place
  static constexpr int kTile = align128(kBQ * kPitch * 4);
  static constexpr int q = 0;
  static constexpr int g = q + kTile;
  static constexpr int k = g + kTile;
  static constexpr int v = k + kTile;
  static constexpr int s = v + kTile;
  static constexpr int stats = s + align128(kBQ * kSPitch * 4);
  static constexpr int bytes = stats + align128(3 * kBQ * 4);
};

template <int D>
__global__ void __launch_bounds__(kThreads)
bwd_dq_f32(BwdParams prm) {
  using L = DqSmemF32<D>;
  constexpr int kPitch = L::kPitch;
  constexpr int kSPitch = L::kSPitch;
  constexpr int kCols = D / 32;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem + L::q);
  float* sG = reinterpret_cast<float*>(smem + L::g);
  float* sK = reinterpret_cast<float*>(smem + L::k);
  float* sV = reinterpret_cast<float*>(smem + L::v);
  float* sS = reinterpret_cast<float*>(smem + L::s);
  float* sM = reinterpret_cast<float*>(smem + L::stats);
  float* sL = sM + kBQ;
  float* sDelta = sL + kBQ;

  const int Tlen = prm.T;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int b = bh / prm.H, h = bh % prm.H;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  const float* k = slice<float>(prm.k, prm.sk, b, h);
  const float* v = slice<float>(prm.v, prm.sv, b, h);
  load_tile_f32<D>(sQ, slice<float>(prm.q, prm.sq, b, h), prm.sq.t, q0,
                   Tlen);
  load_tile_f32<D>(sG, slice<float>(prm.g, prm.sg, b, h), prm.sg.t, q0,
                   Tlen);
  row_delta<float, D>(prm, bh, b, h, q0, sDelta);
  for (int r = threadIdx.x; r < kBQ; r += kThreads) {
    const bool in = q0 + r < Tlen;
    sM[r] = in ? prm.m[(long long)bh * Tlen + q0 + r] : 0.f;
    sL[r] = in ? fmaxf(prm.l[(long long)bh * Tlen + q0 + r], 1e-30f) : 1.f;
  }

  int k_begin, k_end;
  key_range(prm, q0, &k_begin, &k_end);
  const int row0 = q0 + warp * kRows;
  const int rl0 = warp * kRows;  // the warp's first row within the tile
  const float* qw = sQ + rl0 * kPitch;
  const float* gw = sG + rl0 * kPitch;
  float* s_w = sS + rl0 * kSPitch;

  float dq[kRows][kCols];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int i = 0; i < kCols; ++i) dq[r][i] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's K and V are no longer read
    load_tile_f32<D>(sK, k, prm.sk.t, k0, Tlen);
    load_tile_f32<D>(sV, v, prm.sv.t, k0, Tlen);
    __syncthreads();

    // p for keys lane and lane + 32 of the tile.
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
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int col = lane + 32 * half;
          float p = 0.f;
          if (keep(prm, row0 + r, k0 + col))
            p = expf(acc[r][half] * prm.scale - sM[rl0 + r]) / sL[rl0 + r];
          s_w[r * kSPitch + col] = p;
        }
      }
    }
    // dp, then ds = p (dp - delta) scale in place of p.
    {
      float acc[kRows][2];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r][0] = acc[r][1] = 0.f;
      const float* v_lo = sV + lane * kPitch;
      const float* v_hi = sV + (lane + 32) * kPitch;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float a = v_lo[d], c = v_hi[d];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float gv = gw[r * kPitch + d];
          acc[r][0] = fmaf(gv, a, acc[r][0]);
          acc[r][1] = fmaf(gv, c, acc[r][1]);
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float& x = s_w[r * kSPitch + lane + 32 * half];
          x = x * (acc[r][half] - sDelta[rl0 + r]) * prm.scale;
        }
      }
    }
    __syncwarp();
    // dq += ds k.
#pragma unroll 2
    for (int jj = 0; jj < kBK; ++jj) {
      float kj[kCols];
#pragma unroll
      for (int i = 0; i < kCols; ++i) kj[i] = sK[jj * kPitch + lane + 32 * i];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float ds = s_w[r * kSPitch + jj];
#pragma unroll
        for (int i = 0; i < kCols; ++i) dq[r][i] = fmaf(ds, kj[i], dq[r][i]);
      }
    }
  }

  float* out = slice<float>(prm.dq, prm.sdq, b, h);
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qi = row0 + r;
    if (qi >= Tlen) break;
#pragma unroll
    for (int i = 0; i < kCols; ++i)
      out[(long long)qi * prm.sdq.t + lane + 32 * i] = dq[r][i];
  }
}

template <int D> struct DkvSmemF32 {
  static constexpr int kPitch = kPitchF32<D>;
  static constexpr int kSPitch = kBQ + 4;  // p^T and ds^T
  static constexpr int kTile = align128(kBQ * kPitch * 4);
  static constexpr int k = 0;
  static constexpr int v = k + kTile;
  static constexpr int q = v + kTile;
  static constexpr int g = q + kTile;
  static constexpr int p = g + kTile;
  static constexpr int ds = p + align128(kBK * kSPitch * 4);
  static constexpr int stats = ds + align128(kBK * kSPitch * 4);
  static constexpr int bytes = stats + align128(3 * kBQ * 4);
};

template <int D>
__global__ void __launch_bounds__(kThreads)
bwd_dkv_f32(BwdParams prm) {
  using L = DkvSmemF32<D>;
  constexpr int kPitch = L::kPitch;
  constexpr int kSPitch = L::kSPitch;
  constexpr int kCols = D / 32;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sK = reinterpret_cast<float*>(smem + L::k);
  float* sV = reinterpret_cast<float*>(smem + L::v);
  float* sQ = reinterpret_cast<float*>(smem + L::q);
  float* sG = reinterpret_cast<float*>(smem + L::g);
  float* sP = reinterpret_cast<float*>(smem + L::p);
  float* sDS = reinterpret_cast<float*>(smem + L::ds);
  float* sM = reinterpret_cast<float*>(smem + L::stats);
  float* sL = sM + kBQ;
  float* sDelta = sL + kBQ;

  const int Tlen = prm.T;
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kBK;
  const int b = bh / prm.H, h = bh % prm.H;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long stat0 = (long long)bh * Tlen;

  const float* q = slice<float>(prm.q, prm.sq, b, h);
  const float* gr = slice<float>(prm.g, prm.sg, b, h);
  load_tile_f32<D>(sK, slice<float>(prm.k, prm.sk, b, h), prm.sk.t, k0,
                   Tlen);
  load_tile_f32<D>(sV, slice<float>(prm.v, prm.sv, b, h), prm.sv.t, k0,
                   Tlen);
  int q_begin, q_end;
  query_range(prm, k0, &q_begin, &q_end);
  const int key0 = k0 + warp * kRows;
  const float* kw = sK + warp * kRows * kPitch;
  const float* vw = sV + warp * kRows * kPitch;
  float* p_w = sP + warp * kRows * kSPitch;
  float* ds_w = sDS + warp * kRows * kSPitch;

  float dk[kRows][kCols], dv[kRows][kCols];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int i = 0; i < kCols; ++i) dk[r][i] = dv[r][i] = 0.f;

  for (int q0 = q_begin; q0 < q_end; q0 += kBQ) {
    __syncthreads();  // the previous tile's q, dO and stats are no longer read
    load_tile_f32<D>(sQ, q, prm.sq.t, q0, Tlen);
    load_tile_f32<D>(sG, gr, prm.sg.t, q0, Tlen);
    for (int r = threadIdx.x; r < kBQ; r += kThreads) {
      const bool in = q0 + r < Tlen;
      sM[r] = in ? prm.m[stat0 + q0 + r] : 0.f;
      sL[r] = in ? fmaxf(prm.l[stat0 + q0 + r], 1e-30f) : 1.f;
      sDelta[r] = in ? prm.delta[stat0 + q0 + r] : 0.f;
    }
    __syncthreads();

    // p^T for queries lane and lane + 32 of the tile.
    {
      float acc[kRows][2];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r][0] = acc[r][1] = 0.f;
      const float* q_lo = sQ + lane * kPitch;
      const float* q_hi = sQ + (lane + 32) * kPitch;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float a = q_lo[d], c = q_hi[d];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float kv = kw[r * kPitch + d];
          acc[r][0] = fmaf(a, kv, acc[r][0]);
          acc[r][1] = fmaf(c, kv, acc[r][1]);
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int col = lane + 32 * half;
          float p = 0.f;
          if (keep(prm, q0 + col, key0 + r))
            p = expf(acc[r][half] * prm.scale - sM[col]) / sL[col];
          p_w[r * kSPitch + col] = p;
        }
      }
    }
    // dp^T, then ds^T = p^T (dp^T - delta) scale.
    {
      float acc[kRows][2];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r][0] = acc[r][1] = 0.f;
      const float* g_lo = sG + lane * kPitch;
      const float* g_hi = sG + (lane + 32) * kPitch;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float a = g_lo[d], c = g_hi[d];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float vv = vw[r * kPitch + d];
          acc[r][0] = fmaf(a, vv, acc[r][0]);
          acc[r][1] = fmaf(c, vv, acc[r][1]);
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int col = lane + 32 * half;
          ds_w[r * kSPitch + col] = p_w[r * kSPitch + col] *
                                    (acc[r][half] - sDelta[col]) * prm.scale;
        }
      }
    }
    __syncwarp();
    // dv += p^T dO and dk += ds^T q.
#pragma unroll 2
    for (int jj = 0; jj < kBQ; ++jj) {
      float gj[kCols], qj[kCols];
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        gj[i] = sG[jj * kPitch + lane + 32 * i];
        qj[i] = sQ[jj * kPitch + lane + 32 * i];
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float pv = p_w[r * kSPitch + jj];
        const float dsv = ds_w[r * kSPitch + jj];
#pragma unroll
        for (int i = 0; i < kCols; ++i) {
          dv[r][i] = fmaf(pv, gj[i], dv[r][i]);
          dk[r][i] = fmaf(dsv, qj[i], dk[r][i]);
        }
      }
    }
  }

  float* dk_out = slice<float>(prm.dk, prm.sdk, b, h);
  float* dv_out = slice<float>(prm.dv, prm.sdv, b, h);
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int kj = key0 + r;
    if (kj >= Tlen) break;
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      dk_out[(long long)kj * prm.sdk.t + lane + 32 * i] = dk[r][i];
      dv_out[(long long)kj * prm.sdv.t + lane + 32 * i] = dv[r][i];
    }
  }
}

BwdParams make_params(const void* q, const void* k, const void* v,
                      const void* o, const void* g, void* dq, void* dk,
                      void* dv, const float* l, const float* m, float* delta,
                      const long long* strides, int H, int T, float scale,
                      int causal, int window) {
  BwdParams prm;
  prm.q = q;
  prm.k = k;
  prm.v = v;
  prm.o = o;
  prm.g = g;
  prm.dq = dq;
  prm.dk = dk;
  prm.dv = dv;
  prm.l = l;
  prm.m = m;
  prm.delta = delta;
  prm.H = H;
  prm.T = T;
  prm.causal = causal;
  prm.window = window;
  prm.scale = scale;
  Strides* s[8] = {&prm.sq, &prm.sk,  &prm.sv,  &prm.so,
                   &prm.sg, &prm.sdq, &prm.sdk, &prm.sdv};
  for (int i = 0; i < 8; ++i)
    *s[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  return prm;
}

}  // namespace

extern "C" {

// q, k, v, o (the forward's out), g (dO), dq, dk, dv: [B, H, T, D] with
// element strides (batch, head, seq) in `strides`, 24 entries in that
// order, the last dim contiguous and 16-byte aligned rows; l, m, delta:
// contiguous [B, H, T] float32.  dtype 0 = float32, 1 = bfloat16, for all
// eight; D must be 64 or 128.  bwd_dq writes dq and delta; bwd_dkv reads
// delta and writes dk and dv.
int edl_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                               const void* o, const void* g, void* dq,
                               void* dk, void* dv, const float* l,
                               const float* m, float* delta,
                               const long long* strides, int B, int H, int T,
                               int D, float scale, int causal, int window,
                               int dtype, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || T <= 0) return (int)cudaSuccess;
  const BwdParams prm = make_params(q, k, v, o, g, dq, dk, dv, l, m, delta,
                                    strides, H, T, scale, causal, window);
  const dim3 grid(B * H, (T + kBQ - 1) / kBQ);
  if (dtype == 1) {
    if (D == 64)
      return launch(bwd_dq_bf16<64, 4>, DqSmem<64>::bytes, prm, grid,
                    stream);
    if (D == 128)
      return launch(bwd_dq_bf16<128, 1>, DqSmem<128>::bytes, prm, grid,
                    stream);
  } else if (dtype == 0) {
    if (D == 64)
      return launch(bwd_dq_f32<64>, DqSmemF32<64>::bytes, prm, grid, stream);
    if (D == 128)
      return launch(bwd_dq_f32<128>, DqSmemF32<128>::bytes, prm, grid,
                    stream);
  }
  return (int)cudaErrorInvalidValue;
}

int edl_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* o, const void* g, void* dq,
                                void* dk, void* dv, const float* l,
                                const float* m, float* delta,
                                const long long* strides, int B, int H, int T,
                                int D, float scale, int causal, int window,
                                int dtype, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || T <= 0) return (int)cudaSuccess;
  const BwdParams prm = make_params(q, k, v, o, g, dq, dk, dv, l, m, delta,
                                    strides, H, T, scale, causal, window);
  const dim3 grid(B * H, (T + kBK - 1) / kBK);
  if (dtype == 1) {
    if (D == 64)
      return launch(bwd_dkv_bf16<64, 3>, DkvSmem<64>::bytes, prm, grid,
                    stream);
    if (D == 128)
      return launch(bwd_dkv_bf16<128, 1>, DkvSmem<128>::bytes, prm, grid,
                    stream);
  } else if (dtype == 0) {
    if (D == 64)
      return launch(bwd_dkv_f32<64>, DkvSmemF32<64>::bytes, prm, grid,
                    stream);
    if (D == 128)
      return launch(bwd_dkv_f32<128>, DkvSmemF32<128>::bytes, prm, grid,
                    stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
