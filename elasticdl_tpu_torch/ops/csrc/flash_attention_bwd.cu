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
// B4 (edl_flash_attention_bwd_dq) owns q rows and walks the live K/V
// tiles, as the TPU's K grid axis did; it also takes delta for its rows
// and writes each row's stats to a scratch that B5 reads, so the rowsum is
// taken once.  B5 (edl_flash_attention_bwd_dkv) owns keys and walks the
// live q tiles.  Launch B5 after B4 on the same stream.  Each dq, dk and
// dv row belongs to one block and no atomics are used, so two runs are
// bitwise equal.  Tiles above the diagonal (causal) and beyond the band
// (window) are never loaded; only the diagonal and band-edge tiles, and
// the ragged tail, pay for the elementwise mask (a masked p is exactly 0).
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
// 1.54 ms and 2.05 ms at 67 TFLOP/s.  Splitting dq from dk, dv costs 14 D
// operations per pair against 10 D for one fused kernel; it is what gives
// every output row a single owner.
//
// What the design does about it.  Three designs, chosen by dtype and D in
// the C entry points (a dispatch, not a fallback):
//
// bfloat16, D = 64 (the flagship LM's path): wgmma fed by TMA, warp
// specialised.  A block owns 128 rows and runs two consumer warpgroups of
// 64 rows each and a producer warp, one thread of which keeps TMA loads of
// the streamed 64-row tiles in flight (in B5 every lane also copies the
// tile's row stats by cp.async) through a ring of kHopStages stages, each
// with a full and an empty mbarrier; no __syncthreads() in the loop.
// Tiles are rows of 64 bf16 = 128 bytes, loaded with the 128-byte swizzle
// and read by wgmma through descriptors of the same swizzle (hopper.cuh).
// B4 keeps Q and dO resident and computes S = Q K^T and dP = dO V^T with
// both operands in shared memory, P and dS in registers, and dQ += dS K
// with dS from registers and K read MN-major.  B5 keeps K and V resident and
// computes the transposes S^T = K Q^T and dP^T = V dO^T, so keys sit on
// the M side and P^T and dS^T leave the accumulators already in the A
// operand's register layout for dV += P^T dO and dK += dS^T Q (dO and Q
// read MN-major).  P is built while dP is still in flight.  Scores are
// rebuilt in log2 units: p = exp2(s scale log2 e - m log2 e) / max(l,
// 1e-30), with m log2 e and 1 / max(l, 1e-30) taken once per row by B4
// and handed to B5 with delta in the scratch (four floats per row), and
// ds = p (dp scale - delta scale).  Blocks launch in groups of kHeadGroup
// heads, heaviest first within a group, so a group's streamed tiles stay
// in L2.  Registers bound the overlap: ptxas compiles the consumers within
// 168 a thread.  B4's dQ product stays in flight while the next tile's S
// and dP run; B5 ends each tile's dV and dK products within the tile:
// carried over, they, the next S^T and dP^T and the fragments needed more
// than 168, and ptxas serialised every wgmma of B5 (C7512).
//
// bfloat16, D = 128: mma.sync m16n8k16 (the design of the forward,
// flash_attention.cu): 64-row tiles, 4 warps of 16 rows, the work cut into
// 16-wide chunks so a warp holds a 16 x 16 score tile and a 16 x 16 dp tile
// at a time, p and ds packed from the accumulators straight into the next
// product's A operand (pack_a), the streamed tiles double-buffered with
// cp.async, __syncthreads() around each.  The wgmma design does not take
// D = 128 yet: its tiles would be two 128-byte swizzle panels wide, and
// B5's dK and dV alone would hold 128 accumulator registers a thread.
//
// float32: FMA products over shared tiles, p and ds through shared memory.
//
// Not done yet (later work): D = 128 on wgmma; overlapping one consumer
// warpgroup's exp2 with the other's wgmma on purpose (ping-pong); one
// fused kernel for dq, dk and dv.
//
// Every mbarrier wait traps after 2^24 polls (hopper.cuh): a deadlock
// becomes a launch failure instead of a hung card.
//
// C interface (bound with ctypes): both functions take the same arguments
// and return 0 or the cudaError_t code of a refused launch (also when the
// CUDA driver refuses a TMA map).  They allocate nothing and launch on the
// given stream.

#include <string.h>

#include "flash_common.cuh"
#include "hopper.cuh"

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
// cp.async tiles; launched for D = 128.
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
      uint32_t a[kDSteps][4];
      load_a<D, kPitch>(a, sQ + warp * kRows * kPitch, lane);
      mma_abt<D, kPitch>(s, a, kt + c * 16 * kPitch, lane);
      load_a<D, kPitch>(a, sG + warp * kRows * kPitch, lane);
      mma_abt<D, kPitch>(dp, a, vt + c * 16 * kPitch, lane);
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
      uint32_t kv[kDSteps][4];  // the A fragments of k, then of v
      load_a<D, kPitch>(kv, sK + warp * kRows * kPitch, lane);
      mma_abt<D, kPitch>(s, kv, qt + c * 16 * kPitch, lane);
      load_a<D, kPitch>(kv, sV + warp * kRows * kPitch, lane);
      mma_abt<D, kPitch>(dp, kv, gt + c * 16 * kPitch, lane);
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
// bfloat16, D = 64: wgmma fed by TMA.  A block owns 128 rows (q rows in B4,
// keys in B5): two consumer warpgroups of 64 owned rows each, and a
// producer warp that keeps TMA loads of the streamed 64-row tiles in
// flight through a ring of kHopStages stages, each with a full and an
// empty mbarrier.  No __syncthreads() in the loop.
// ---------------------------------------------------------------------------

using hopper::kWgThreads;
// Consumer warpgroups 0 and 1, then one producer warp.  ptxas compiles
// these kernels within 168 registers a thread whether the producer is a
// warp or a warpgroup that hands its registers to the consumers by
// setmaxnreg (which it granted, 232, without the consumers using them), so
// the producer is one warp and nothing is handed over.
constexpr int kHopThreads = 2 * kWgThreads + 32;
constexpr int kOwned = 128;                  // rows a block owns
constexpr int kStream = 64;                  // rows of a streamed tile
constexpr int kHopStages = 4;                // ring depth
constexpr int kTileBf16 = kStream * 64 * 2;  // a 64 x 64 bf16 tile, bytes
constexpr int kTileElems64 = kStream * 64;
constexpr int kHeadGroup = 16;      // heads launched together (block_order)
static_assert(kStream == kBQ && kStream == kBK, "tile_unmasked's tiles");

struct HopParams {
  CUtensorMap q, k, v, g;  // [B, H, T, 64] bf16: 64 x 64 boxes, swizzled
  BwdParams prm;
};

// The row stats of the 64 rows of a warpgroup at qw0, two threads a row:
// (m log2 e, 1 / max(l, 1e-30), delta, delta * scale) with delta =
// rowsum(dO * O) in f32, into sRow (zeros past T) and, for rows before T,
// into the scratch that B5 reads (prm.delta as [B, H, T, 4] f32).
__device__ __forceinline__ void wg_row_stats(const BwdParams& prm, int bh,
                                             int b, int h, int qw0, int tid,
                                             float4* sRow) {
  const int r = tid >> 1, part = tid & 1, qi = qw0 + r;
  float acc = 0.f;
  if (qi < prm.T) {
    const bf16* o =
        slice<bf16>(prm.o, prm.so, b, h) + (long long)qi * prm.so.t + part * 32;
    const bf16* gr =
        slice<bf16>(prm.g, prm.sg, b, h) + (long long)qi * prm.sg.t + part * 32;
#pragma unroll
    for (int c = 0; c < 32; c += 8) {
      const uint4 ov = *reinterpret_cast<const uint4*>(o + c);
      const uint4 gv = *reinterpret_cast<const uint4*>(gr + c);
      const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
      const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 of = __bfloat1622float2(o2[i]);
        const float2 gf = __bfloat1622float2(g2[i]);
        acc = fmaf(gf.x, of.x, acc);
        acc = fmaf(gf.y, of.y, acc);
      }
    }
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  if (part == 0) {
    float4 row = make_float4(0.f, 0.f, 0.f, 0.f);
    if (qi < prm.T) {
      const long long i = (long long)bh * prm.T + qi;
      row = make_float4(prm.m[i] * kLog2e, __frcp_rn(fmaxf(prm.l[i], 1e-30f)),
                        acc, acc * prm.scale);
      reinterpret_cast<float4*>(prm.delta)[i] = row;
    }
    sRow[r] = row;
  }
}

using HopRing = hopper::Ring<kHopStages>;

// A consumer walks past `count` tiles it has no live pair in: it waits
// for each (so it never runs a phase ahead) and releases it.
__device__ __forceinline__ void skip_tiles(HopRing& ring, int count,
                                           uint64_t* full, uint64_t* empty,
                                           int lane) {
  for (int i = 0; i < count; ++i) {
    hopper::mbar_wait(&full[ring.stage], ring.phase);
    hopper::warp_release(&empty[ring.stage], lane);
    ring.advance();
  }
}

struct DqHopSmem {
  static constexpr int q = 0;  // the block's 128 rows: two tiles
  static constexpr int g = q + 2 * kTileBf16;
  static constexpr int k = g + 2 * kTileBf16;  // the ring
  static constexpr int v = k + kHopStages * kTileBf16;
  static constexpr int rows = v + kHopStages * kTileBf16;  // float4 each
  static constexpr int bars = rows + kOwned * 16;
  static constexpr int bytes = bars + (2 * kHopStages + 1) * 8 + 1024;
};

// B4.  Consumer warpgroup w owns q rows q0 + 64 w .. + 63 with Q and dO
// resident; per K/V tile: S = Q K^T and dP = dO V^T (both operands in
// shared memory), P and dS in registers, dQ += dS K (dS from registers, K
// read MN-major).  A tile's dQ product stays in flight while the next
// tile's S and dP run; that tile releases its stage.
__global__ void __launch_bounds__(kHopThreads, 1)
bwd_dq_wgmma(const __grid_constant__ HopParams hp) {
  using L = DqHopSmem;
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  bf16* sQ = reinterpret_cast<bf16*>(smem + L::q);
  bf16* sG = reinterpret_cast<bf16*>(smem + L::g);
  bf16* sK = reinterpret_cast<bf16*>(smem + L::k);
  bf16* sV = reinterpret_cast<bf16*>(smem + L::v);
  float4* sRow = reinterpret_cast<float4*>(smem + L::rows);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* empty = full + kHopStages;
  uint64_t* resident = empty + kHopStages;

  const BwdParams& prm = hp.prm;
  const int Tlen = prm.T;
  int bh, rank;
  block_order<kHeadGroup>(&bh, &rank);
  const int q0 = (gridDim.y - 1 - rank) * kOwned;  // the last rows see most
  const int b = bh / prm.H, h = bh % prm.H;
  int k_begin = 0, k_end = Tlen;
  if (prm.causal) {
    k_end = min(Tlen, q0 + kOwned);
    if (prm.window > 0)
      k_begin = max(0, q0 - prm.window + 1) / kStream * kStream;
  }
  const int n_tiles = (k_end - k_begin + kStream - 1) / kStream;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kHopStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * kWgThreads / 32);
    }
    mbar_init(resident, 1);
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = warpgroup_index();
  const int tid = threadIdx.x % kWgThreads;
  if (wg == 2) {
    // Producer: one thread issues every load.
    if (tid == 0) {
      const int halves = q0 + kStream < Tlen ? 2 : 1;  // never a box past T
      mbar_arrive_expect_tx(resident, halves * 2 * kTileBf16);
      for (int i = 0; i < halves; ++i) {
        tma_load_4d(sQ + i * kTileElems64, &hp.q, resident, 0,
                    q0 + i * kStream, h, b);
        tma_load_4d(sG + i * kTileElems64, &hp.g, resident, 0,
                    q0 + i * kStream, h, b);
      }
      HopRing ring;
      for (int j = 0; j < n_tiles; ++j) {
        const int k0 = k_begin + j * kStream;
        mbar_wait(&empty[ring.stage], ring.phase ^ 1);
        mbar_arrive_expect_tx(&full[ring.stage], 2 * kTileBf16);
        tma_load_4d(sK + ring.stage * kTileElems64, &hp.k, &full[ring.stage],
                    0, k0, h, b);
        tma_load_4d(sV + ring.stage * kTileElems64, &hp.v, &full[ring.stage],
                    0, k0, h, b);
        ring.advance();
      }
    }
  } else {
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int qw0 = q0 + wg * kStream;  // the warpgroup's first row
    wg_row_stats(prm, bh, b, h, qw0, tid, sRow + wg * kStream);
    named_barrier(1 + wg, kWgThreads);
    // This lane's rows: qw0 + 16 warp + g + 8 hh.
    float m2[2], il[2], dls[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float4 row = sRow[wg * kStream + warp * 16 + g + 8 * hh];
      m2[hh] = row.x;
      il[hh] = row.y;
      dls[hh] = row.w;
    }
    const float scale = prm.scale, scale_log2 = scale * kLog2e;
    const uint64_t desc_q = desc_sw128(sQ + wg * kTileElems64);
    const uint64_t desc_g = desc_sw128(sG + wg * kTileElems64);
    float dq[32], s[32], dp[32];
    uint32_t da[4][4] = {};
#pragma unroll
    for (int i = 0; i < 32; ++i) dq[i] = s[i] = dp[i] = 0.f;
    // The warpgroup's live tiles form one run [j_lo, j_hi) (the band).
    int j_lo = 0, j_hi = 0;
    for (int j = n_tiles - 1; j >= 0; --j) {
      if (tile_live(prm, qw0, k_begin + j * kStream)) {
        if (j_hi == 0) j_hi = j + 1;
        j_lo = j;
      }
    }

    HopRing ring;
    skip_tiles(ring, j_lo, full, empty, lane);
    mbar_wait(resident, 0);
    int held = 0;  // the stage the in-flight dQ product reads
    for (int j = j_lo; j < j_hi; ++j) {
      const int k0 = k_begin + j * kStream;
      mbar_wait(&full[ring.stage], ring.phase);
      const uint64_t desc_k = desc_sw128(sK + ring.stage * kTileElems64);
      const uint64_t desc_v = desc_sw128(sV + ring.stage * kTileElems64);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss(s, desc_q + kk * kDescKStepKMajor,
                 desc_k + kk * kDescKStepKMajor, kk);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss(dp, desc_g + kk * kDescKStepKMajor,
                 desc_v + kk * kDescKStepKMajor, kk);
      wgmma_commit();
      wgmma_wait<1>();  // S, and the previous tile's dQ product
      fence_regs(s);
      fence_regs(da);
      if (j > j_lo) warp_release(&empty[held], lane);
      // p in place of s while dP is in flight.
      if (tile_unmasked(prm, qw0, k0)) {
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int hh = (e >> 1) & 1;
          s[e] = ex2(fmaf(s[e], scale_log2, -m2[hh])) * il[hh];
        }
      } else {
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int hh = (e >> 1) & 1;
          const int qi = qw0 + warp * 16 + g + 8 * hh;
          const int kj = k0 + 8 * (e >> 2) + 2 * t + (e & 1);
          const float x = fmaf(s[e], scale_log2, -m2[hh]);
          s[e] = ex2(keep(prm, qi, kj) ? x : -__int_as_float(0x7f800000)) * il[hh];
        }
      }
      wgmma_wait<0>();
      fence_regs(dp);
      // ds = p (dp - delta) scale, rounded into the A fragment.
#pragma unroll
      for (int e = 0; e < 32; ++e)
        s[e] *= fmaf(dp[e], scale, -dls[(e >> 1) & 1]);
      pack_acc_a(da, s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs_mn(dq, da[kk], desc_k + kk * kDescKStepMNMajor);
      wgmma_commit();
      held = ring.stage;
      ring.advance();
    }
    wgmma_wait<0>();
    fence_regs(dq);
    fence_regs(da);
    if (j_hi > j_lo) warp_release(&empty[held], lane);
    skip_tiles(ring, n_tiles - j_hi, full, empty, lane);

    bf16* out = slice<bf16>(prm.dq, prm.sdq, b, h);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int qi = qw0 + warp * 16 + g + 8 * hh;
      if (qi >= Tlen) continue;
      bf16* orow = out + (long long)qi * prm.sdq.t + 2 * t;
#pragma unroll
      for (int j8 = 0; j8 < 8; ++j8)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j8) =
            __floats2bfloat162_rn(dq[4 * j8 + 2 * hh], dq[4 * j8 + 2 * hh + 1]);
    }
  }
}

struct DkvHopSmem {
  static constexpr int kStats = 4 * kStream;  // B4's row stats of a q tile
  static constexpr int k = 0;                 // the block's 128 keys
  static constexpr int v = k + 2 * kTileBf16;
  static constexpr int q = v + 2 * kTileBf16;  // the ring
  static constexpr int g = q + kHopStages * kTileBf16;
  static constexpr int stats = g + kHopStages * kTileBf16;
  static constexpr int bars = stats + kHopStages * kStats * 4;
  static constexpr int bytes = bars + (2 * kHopStages + 1) * 8 + 1024;
};

// B5.  Consumer warpgroup w owns keys k0 + 64 w .. + 63 with K and V
// resident; per q tile: S^T = K Q^T and dP^T = V dO^T (keys on the M side,
// so P^T and dS^T leave the accumulators in the A operand's layout), then
// dV += P^T dO and dK += dS^T Q from registers, dO and Q read MN-major.
// The stats are per column (query) here, read from B4's rows.
__global__ void __launch_bounds__(kHopThreads, 1)
bwd_dkv_wgmma(const __grid_constant__ HopParams hp) {
  using L = DkvHopSmem;
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  bf16* sK = reinterpret_cast<bf16*>(smem + L::k);
  bf16* sV = reinterpret_cast<bf16*>(smem + L::v);
  bf16* sQ = reinterpret_cast<bf16*>(smem + L::q);
  bf16* sG = reinterpret_cast<bf16*>(smem + L::g);
  float* sStats = reinterpret_cast<float*>(smem + L::stats);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* empty = full + kHopStages;
  uint64_t* resident = empty + kHopStages;

  const BwdParams& prm = hp.prm;
  const int Tlen = prm.T;
  int bh, rank;
  block_order<kHeadGroup>(&bh, &rank);
  const int k0 = rank * kOwned;  // causal: the first keys see the most
  const int b = bh / prm.H, h = bh % prm.H;
  int q_begin = 0, q_end = Tlen;
  if (prm.causal) {
    q_begin = k0;
    if (prm.window > 0) q_end = min(Tlen, k0 + kOwned - 1 + prm.window);
  }
  const int n_tiles = (q_end - q_begin + kStream - 1) / kStream;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kHopStages; ++s) {
      mbar_init(&full[s], 1 + 32);  // the TMA arrival, the stats' 32
      mbar_init(&empty[s], 2 * kWgThreads / 32);
    }
    mbar_init(resident, 1);
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = warpgroup_index();
  const int tid = threadIdx.x % kWgThreads;
  if (wg == 2) {
    // Producer: lane 0 issues the TMA loads, every lane two rows of stats
    // by cp.async (TMA would need T to be a multiple of 4).
    {
      const int lane = tid;
      const int halves = k0 + kStream < Tlen ? 2 : 1;  // never a box past T
      if (lane == 0) {
        mbar_arrive_expect_tx(resident, halves * 2 * kTileBf16);
        for (int i = 0; i < halves; ++i) {
          tma_load_4d(sK + i * kTileElems64, &hp.k, resident, 0,
                      k0 + i * kStream, h, b);
          tma_load_4d(sV + i * kTileElems64, &hp.v, resident, 0,
                      k0 + i * kStream, h, b);
        }
      }
      const float4* rows =
          reinterpret_cast<const float4*>(prm.delta) + (long long)bh * Tlen;
      HopRing ring;
      for (int j = 0; j < n_tiles; ++j) {
        const int q0 = q_begin + j * kStream;
        float* st = sStats + ring.stage * L::kStats;
        mbar_wait(&empty[ring.stage], ring.phase ^ 1);
        if (lane == 0) {
          mbar_arrive_expect_tx(&full[ring.stage], 2 * kTileBf16);
          tma_load_4d(sQ + ring.stage * kTileElems64, &hp.q,
                      &full[ring.stage], 0, q0, h, b);
          tma_load_4d(sG + ring.stage * kTileElems64, &hp.g,
                      &full[ring.stage], 0, q0, h, b);
        }
        // st: the row stats B4 wrote for the tile's queries; 0 past T.
        for (int r = lane; r < kStream; r += 32) {
          const int qi = q0 + r;
          cp_async_16(st + 4 * r, rows + min(qi, Tlen - 1),
                      qi < Tlen ? 16 : 0);
        }
        cp_async_mbar_arrive(&full[ring.stage]);
        ring.advance();
      }
    }
  } else {
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int kw0 = k0 + wg * kStream;  // the warpgroup's first key
    const int key = kw0 + warp * 16 + g;  // this lane's keys: key, key + 8
    const float scale = prm.scale, scale_log2 = scale * kLog2e;
    const uint64_t desc_k = desc_sw128(sK + wg * kTileElems64);
    const uint64_t desc_v = desc_sw128(sV + wg * kTileElems64);
    float dk[32], dv[32], s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[i] = dv[i] = s[i] = dp[i] = 0.f;
    int j_lo = 0, j_hi = 0;  // the live tiles: one run (the band)
    for (int j = n_tiles - 1; j >= 0; --j) {
      if (tile_live(prm, q_begin + j * kStream, kw0)) {
        if (j_hi == 0) j_hi = j + 1;
        j_lo = j;
      }
    }

    // Per tile: S^T and dP^T in flight, P^T built while dP^T runs, then
    // dS^T, then both products at once.  Unlike B4 the products end with
    // the tile: carried into the next one, they and its S^T and dP^T
    // would need more registers than the warpgroup has, and ptxas would
    // serialise every wgmma.
    HopRing ring;
    skip_tiles(ring, j_lo, full, empty, lane);
    mbar_wait(resident, 0);
    for (int j = j_lo; j < j_hi; ++j) {
      const int q0 = q_begin + j * kStream;
      mbar_wait(&full[ring.stage], ring.phase);
      const uint64_t desc_q = desc_sw128(sQ + ring.stage * kTileElems64);
      const uint64_t desc_g = desc_sw128(sG + ring.stage * kTileElems64);
      const float4* st =
          reinterpret_cast<const float4*>(sStats + ring.stage * L::kStats);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss(s, desc_k + kk * kDescKStepKMajor,
                 desc_q + kk * kDescKStepKMajor, kk);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss(dp, desc_v + kk * kDescKStepKMajor,
                 desc_g + kk * kDescKStepKMajor, kk);
      wgmma_commit();
      wgmma_wait<1>();  // S^T
      fence_regs(s);
      // p^T in place of s^T while dP^T is in flight; column (query)
      // 8 j8 + 2 t + i of register e = 4 j8 + 2 hh + i, key key + 8 hh.
      if (tile_unmasked(prm, q0, kw0)) {
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const float4 sc = st[8 * (e >> 2) + 2 * t + (e & 1)];
          s[e] = ex2(fmaf(s[e], scale_log2, -sc.x)) * sc.y;
        }
      } else {
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int col = 8 * (e >> 2) + 2 * t + (e & 1);
          const float4 sc = st[col];
          const float x = fmaf(s[e], scale_log2, -sc.x);
          s[e] = ex2(keep(prm, q0 + col, key + 8 * ((e >> 1) & 1))
                         ? x
                         : -__int_as_float(0x7f800000)) *
                 sc.y;
        }
      }
      wgmma_wait<0>();  // dP^T
      fence_regs(dp);
      // ds^T = p^T (dp^T - delta) scale; both rounded into A fragments.
#pragma unroll
      for (int e = 0; e < 32; ++e)
        dp[e] = s[e] * fmaf(dp[e], scale, -st[8 * (e >> 2) + 2 * t + (e & 1)].w);
      uint32_t pa[4][4], da[4][4];
      pack_acc_a(pa, s);
      pack_acc_a(da, dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs_mn(dv, pa[kk], desc_g + kk * kDescKStepMNMajor);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs_mn(dk, da[kk], desc_q + kk * kDescKStepMNMajor);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dk);
      fence_regs(dv);
      fence_regs(pa);
      fence_regs(da);
      warp_release(&empty[ring.stage], lane);
      ring.advance();
    }
    skip_tiles(ring, n_tiles - j_hi, full, empty, lane);

    bf16* dk_out = slice<bf16>(prm.dk, prm.sdk, b, h);
    bf16* dv_out = slice<bf16>(prm.dv, prm.sdv, b, h);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int kj = key + 8 * hh;
      if (kj >= Tlen) continue;
      bf16* krow = dk_out + (long long)kj * prm.sdk.t + 2 * t;
      bf16* vrow = dv_out + (long long)kj * prm.sdv.t + 2 * t;
#pragma unroll
      for (int j8 = 0; j8 < 8; ++j8) {
        *reinterpret_cast<__nv_bfloat162*>(krow + 8 * j8) =
            __floats2bfloat162_rn(dk[4 * j8 + 2 * hh], dk[4 * j8 + 2 * hh + 1]);
        *reinterpret_cast<__nv_bfloat162*>(vrow + 8 * j8) =
            __floats2bfloat162_rn(dv[4 * j8 + 2 * hh], dv[4 * j8 + 2 * hh + 1]);
      }
    }
  }
}

// The tensor maps of a wgmma launch.
bool make_hop_params(HopParams* hp, const BwdParams& prm, int B) {
  using hopper::encode_rows_bf16;
  const int H = prm.H, T = prm.T;
  const Strides* s[4] = {&prm.sq, &prm.sk, &prm.sv, &prm.sg};
  const void* base[4] = {prm.q, prm.k, prm.v, prm.g};
  CUtensorMap* maps[4] = {&hp->q, &hp->k, &hp->v, &hp->g};
  for (int i = 0; i < 4; ++i)
    if (!encode_rows_bf16(maps[i], base[i], s[i]->b, s[i]->h, s[i]->t, B, H,
                          T))
      return false;
  hp->prm = prm;
  return true;
}

template <typename Kernel>
int launch_hop(Kernel kernel, int bytes, const BwdParams& prm, int B,
               cudaStream_t stream) {
  HopParams hp;
  memset(&hp, 0, sizeof(hp));
  if (!make_hop_params(&hp, prm, B)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * prm.H, (prm.T + kOwned - 1) / kOwned);
  kernel<<<grid, kHopThreads, bytes, stream>>>(hp);
  return (int)cudaGetLastError();
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
// order, the last dim contiguous and 16-byte aligned rows; l, m:
// contiguous [B, H, T] float32; delta: a 16-byte aligned [B, H, T, 4]
// float32 scratch (the bf16 D = 64 pair keeps four floats a row there, the
// other designs delta alone in its first B * H * T floats).  dtype 0 =
// float32, 1 = bfloat16, for all eight; D must be 64 or 128.  bwd_dq
// writes dq and the scratch; bwd_dkv reads the scratch and writes dk, dv.
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
      return launch_hop(bwd_dq_wgmma, DqHopSmem::bytes, prm, B, stream);
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
      return launch_hop(bwd_dkv_wgmma, DkvHopSmem::bytes, prm, B, stream);
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
