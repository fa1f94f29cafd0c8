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
// tensor-core operations.  The softmax's exponentials are a second limit
// of the same size: one per live pair, 268.6 M, on the 16 exp2 units a
// cycle of each SM (about 4.2 T/s over 132 SMs at 1.98 GHz): 0.064 ms, so
// the two have to overlap for the kernel to near either.  At the
// serving prompt (T=128) the same call moves 8.5 MB, 2.5 us, and is bound
// by bytes (launch latency dominates).  In f32 there are no tensor cores
// for full-precision products: 1.03 ms per flagship call at 67 TFLOP/s.
//
// How it splits the work.  The TPU walked K/V tiles along a sequential grid
// axis, carrying (acc, l, m) in VMEM scratch.  Here a block owns a run of
// q rows of one (batch, head) and loops over the live 64-row K/V tiles
// itself, so the loop takes the place of that grid axis.  Tiles above the
// diagonal (causal) and below the band (window) are never loaded, and only
// tiles that cross the diagonal, the band's edge or the ragged tail are
// masked.  Causal q rows near the end see the most keys, so blocks launch
// heaviest first.  Three designs, chosen by dtype and D in the C entry
// point (a dispatch, not a fallback):
//
//  - bfloat16, D = 64 (the flagship LM's path): wgmma fed by TMA, warp
//    specialised.  A block owns 128 q rows: two consumer warpgroups of 64
//    rows each and one producer warp, one thread of which keeps TMA loads
//    of the K and V tiles in flight through a ring of kFwdStages stages,
//    each with a full and an empty mbarrier (hopper.cuh); no
//    __syncthreads() in the loop.  Tiles are rows of 64 bf16 = 128 bytes,
//    loaded with the 128-byte swizzle and read by wgmma through
//    descriptors of the same swizzle.  Per K/V tile a warpgroup computes
//    S = Q K^T with both operands in shared memory, the online softmax on
//    S in registers (scores in log2 units, one ex2.approx.ftz per
//    element; each thread keeps partial row sums, reduced once at the
//    end), and O += P V with P from registers (rounded to bf16: the
//    accumulator's layout is the A operand's) and V read MN-major.  The
//    chain S -> softmax -> P V is serial within a warpgroup, and the tile
//    is released when its product is done.  What bounds it is that chain:
//    one warpgroup alone takes 75 % of the time of two, and the kernel
//    without any wgmma 91 % (scripts/sweep_flash_attention.py --ablate,
//    PERF.md), so the tensor cores wait on the softmax's instruction
//    stream.  The lever is the number of chains per SM: the chain needs
//    96 registers a thread, so two blocks (four chains) share an SM.  Two
//    schedules that hide a chain's softmax under products measured slower
//    here and are kept as switches for the sweep: issuing tile j's S
//    before tile j - 1's P V (kOverlap: the product's registers stay live
//    under the next S, which costs the second block per SM), and a
//    ping-pong of the warpgroups on named barriers (kPingPong).  Both
//    warpgroups walk every tile of the block's range in the same rounds
//    (a warpgroup with no live pair in a tile passes it on), so the
//    ping-pong stays in step and the ring never waits on a warpgroup that
//    has run out of work.  Blocks launch in groups of kFwdHeadGroup
//    heads, heaviest first within a group, so a group's K and V stay in
//    L2.  Every output row has one owner and no atomics are used: two
//    runs are bitwise equal.
//  - bfloat16, D = 128: mma.sync m16n8k16 (bf16 in, f32 accumulate).  A
//    block owns 64 q rows; its 4 warps own 16 rows each and keep their q
//    fragments, their 16 x 64 score tile, their running (m, l) and their
//    16 x D accumulator in registers; the score tile's accumulator layout
//    is the layout of the p v product's A operand, so p goes from the
//    softmax to the tensor cores without touching shared memory.  K and V
//    tiles are double-buffered: cp.async fetches tile j + 1 while tile j is
//    computed; their B fragments come through ldmatrix (V's transposed).
//    Heads run along the grid's fastest axis.  The template also takes
//    D = 64 (scripts/sweep_flash_attention.py times it as the earlier
//    design: there 128 registers a thread let four blocks share an SM).
//  - float32, bound by the CUDA cores' f32 rate (TF32 would lose the
//    float32 accuracy this path promises): FMA products over tiles in
//    shared memory, the online softmax one row at a time with warp
//    shuffles.  It is the simple design.
//
// Not done yet (later work): D = 128 on wgmma (two swizzle panels a row),
// a persistent schedule, a TMA store of the output.
//
// Every mbarrier wait traps after 2^24 polls (hopper.cuh): a deadlock
// becomes a launch failure instead of a hung card.
//
// B3p.  The ring attention's per-block step (the TPU kernel launched with
// normalize=False) is the same kernels with another epilogue, a template
// flag: each row's f32 acc is stored as it is, not divided by l, into a
// float32 output whatever q's dtype; l and m are stored as in B3.  Nothing
// else differs, so B3p is bound as B3 is; it writes twice B3's output bytes
// in bf16 (an f32 acc), which the bound counts.
//
// C interface (bound with ctypes): edl_flash_attention_fwd (B3) and
// edl_flash_attention_partial_fwd (B3p) return 0 or the cudaError_t code of
// a refused launch (also when the CUDA driver refuses a TMA map).  They
// allocate nothing: the caller passes out, l and m.  They launch on the
// given stream.

#include <string.h>

#include "flash_common.cuh"
#include "hopper.cuh"

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
  int normalize;  // 0: out is the f32 acc (B3p), not acc / l
  float scale;
  Strides sq, sk, sv, so;
};

// ---------------------------------------------------------------------------
// bfloat16, D = 128: mma.sync m16n8k16, registers, double-buffered cp.async
// tiles.
// ---------------------------------------------------------------------------

template <int D> struct Bf16Smem {
  static constexpr int kPitch = kPitchBf16<D>;
  static constexpr int kTile = align128(kBQ * kPitch * 2);
  static constexpr int q = 0;
  static constexpr int k = q + kTile;
  static constexpr int v = k + kStages * kTile;
  static constexpr int bytes = v + kStages * kTile;
};

template <int D, int kMinBlocks, bool kNormalize = true>
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

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qi = row0 + 8 * half;
    if (qi >= Tlen) continue;
    const long long at =
        b * prm.so.b + h * prm.so.h + (long long)qi * prm.so.t + 2 * t;
    if constexpr (kNormalize) {
      const float l_safe = fmaxf(l_run[half], 1e-30f);
      bf16* orow = static_cast<bf16*>(prm.o) + at;
#pragma unroll
      for (int n = 0; n < kDTiles; ++n) {
        *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) =
            __floats2bfloat162_rn(o[n][2 * half] / l_safe,
                                  o[n][2 * half + 1] / l_safe);
      }
    } else {
      float* orow = static_cast<float*>(prm.o) + at;
#pragma unroll
      for (int n = 0; n < kDTiles; ++n)
        *reinterpret_cast<float2*>(orow + n * 8) =
            make_float2(o[n][2 * half], o[n][2 * half + 1]);
    }
    if (t == 0) {
      prm.l[(long long)bh * Tlen + qi] = l_run[half];
      prm.m[(long long)bh * Tlen + qi] = m_run[half] * kLn2;
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16, D = 64: wgmma fed by TMA, warp specialised (the source header
// says how the work is split).
// ---------------------------------------------------------------------------

using hopper::kWgThreads;
constexpr int kConsumers = 2;                // consumer warpgroups
// The consumer warpgroups, then one producer warp.
constexpr int kFwdThreads = kConsumers * kWgThreads + 32;
constexpr int kStream = 64;                  // rows of a Q, K or V tile
constexpr int kOwned = kConsumers * kStream;  // q rows a block owns
constexpr int kFwdStages = 4;                // ring depth
constexpr int kFwdHeadGroup = 16;            // heads launched together
// Both measured slower at D = 64 and kept for the sweep's variants:
constexpr bool kPingPong = false;  // warpgroups issue products in turn
constexpr bool kOverlap = false;   // P V of tile j - 1 under tile j's softmax
constexpr int kTileBf16 = kStream * 64 * 2;  // a 64 x 64 bf16 tile, bytes
constexpr int kTileElems64 = kStream * 64;
constexpr int kPingPongBar = 1;              // named barriers 1 ..
static_assert(kStream == kBQ && kStream == kBK, "tile_unmasked's tiles");

using FwdRing = hopper::Ring<kFwdStages>;

struct FwdHopParams {
  CUtensorMap q, k, v;  // [B, H, T, 64] bf16: 64 x 64 boxes, swizzled
  Params prm;
};

struct FwdHopSmem {
  static constexpr int q = 0;  // the block's rows: a tile per warpgroup
  static constexpr int k = q + kConsumers * kTileBf16;  // the ring
  static constexpr int v = k + kFwdStages * kTileBf16;
  static constexpr int bars = v + kFwdStages * kTileBf16;
  static constexpr int bytes = bars + (2 * kFwdStages + 1) * 8 + 1024;
};

// The ping-pong: warpgroup wg waits on its own barrier before it issues
// its products and then lets the next one (wg + 1, in a ring) go.  The
// last warpgroup lets 0 go first; 0 takes the last pass after its final
// round, so every barrier phase is completed.
__device__ __forceinline__ void pingpong_wait(int wg) {
  if (kPingPong) hopper::named_barrier(kPingPongBar + wg, 2 * kWgThreads);
}
__device__ __forceinline__ void pingpong_pass(int wg) {
  if (kPingPong)
    hopper::named_barrier_arrive(kPingPongBar + (wg + 1) % kConsumers,
                                 2 * kWgThreads);
}

// o *= alpha, per row (register e holds row 8 ((e >> 1) & 1) + g).
__device__ __forceinline__ void rescale(float (&o)[32],
                                        const float (&alpha)[2]) {
#pragma unroll
  for (int e = 0; e < 32; ++e) o[e] *= alpha[(e >> 1) & 1];
}

// s = Q K^T for the warpgroup's 64 rows and a K tile, both in shared
// memory; committed as one group.
__device__ __forceinline__ void issue_s(float (&s)[32], uint64_t desc_q,
                                        const bf16* k_tile) {
  using namespace hopper;
  const uint64_t desc_k = desc_sw128(k_tile);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss(s, desc_q + kk * kDescKStepKMajor,
             desc_k + kk * kDescKStepKMajor, kk);
  wgmma_commit();
}

// o += P V: P from registers (bf16 A fragments), V read MN-major;
// committed as one group.
__device__ __forceinline__ void issue_pv(float (&o)[32],
                                         const uint32_t (&pa)[4][4],
                                         const bf16* v_tile) {
  using namespace hopper;
  const uint64_t desc_v = desc_sw128(v_tile);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs_mn(o, pa[kk], desc_v + kk * kDescKStepMNMajor);
  wgmma_commit();
}

// The online softmax of one tile for this lane's rows `row` (half 0) and
// row + 8: s (raw scores) becomes p = exp2(s c - m) in place, masked
// where the tile needs it; m_run (log2 units) and the partial sums l_part
// move to the new row max, and alpha is the factor that moves O there.
// Maxima and sums run as two interleaved chains per row (8-column groups
// even and odd), which halves their latency.
__device__ __forceinline__ void online_softmax(
    float (&s)[32], float (&m_run)[2], float (&l_part)[2], float (&alpha)[2],
    const Params& prm, int qw0, int row, int k0, int t, float c) {
  using hopper::ex2;
  float mx[2][2] = {{kNegInf, kNegInf}, {kNegInf, kNegInf}};
  if (tile_unmasked(prm, qw0, k0)) {
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      s[e] *= c;
      float& m = mx[(e >> 1) & 1][(e >> 2) & 1];
      m = fmaxf(m, s[e]);
    }
  } else {
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int hh = (e >> 1) & 1;
      const int kj = k0 + 8 * (e >> 2) + 2 * t + (e & 1);
      s[e] = keep(prm, row + 8 * hh, kj) ? s[e] * c : kNegInf;
      float& m = mx[hh][(e >> 2) & 1];
      m = fmaxf(m, s[e]);
    }
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float mt = fmaxf(mx[hh][0], mx[hh][1]);
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
    const float m_new = fmaxf(m_run[hh], mt);
    alpha[hh] = ex2(m_run[hh] - m_new);
    m_run[hh] = m_new;
  }
  float sum[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const int hh = (e >> 1) & 1;
    s[e] = ex2(s[e] - m_run[hh]);
    sum[hh][(e >> 2) & 1] += s[e];
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
    l_part[hh] = l_part[hh] * alpha[hh] + (sum[hh][0] + sum[hh][1]);
}

// A round in which the warpgroup has no live pair: it keeps its turn in
// the ping-pong and releases the tile.
__device__ __forceinline__ void pass_tile(FwdRing& ring, int wg,
                                          uint64_t* full, uint64_t* empty,
                                          int lane) {
  hopper::mbar_wait(&full[ring.stage], ring.phase);
  pingpong_wait(wg);
  pingpong_pass(wg);
  hopper::warp_release(&empty[ring.stage], lane);
  ring.advance();
}

// B3.  Consumer warpgroup w owns q rows q0 + 64 w .. + 63 with Q resident;
// per K/V tile: S = Q K^T (both in shared memory), the online softmax in
// registers, O += P V (P from registers, V read MN-major), the tile
// released when its product is done: the chain is serial within a
// warpgroup, and the other warpgroup's chain fills the tensor cores.
// With kOverlap the P V product of tile j - 1 is issued after tile j's S
// and runs while tile j's softmax does.  The walk is cut into straight
// runs (the tiles before the warpgroup's live run, its first tile, the
// rest of the run, with kOverlap the run's last P V, the tiles after) so
// that no branch lies between a wgmma and the wait that retires it:
// ptxas cannot see that two branches on the same condition agree, and
// otherwise retires every wgmma at once (C7514).  Two blocks share an SM
// (96 registers a thread, 81 KB of shared memory each): four consumer
// chains per SM, which is what bounds this kernel (PERF.md).
template <bool kNormalize = true>
__global__ void __launch_bounds__(kFwdThreads, 2)
flash_fwd_wgmma(const __grid_constant__ FwdHopParams hp) {
  using L = FwdHopSmem;
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  bf16* sQ = reinterpret_cast<bf16*>(smem + L::q);
  bf16* sK = reinterpret_cast<bf16*>(smem + L::k);
  bf16* sV = reinterpret_cast<bf16*>(smem + L::v);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* empty = full + kFwdStages;
  uint64_t* resident = empty + kFwdStages;

  const Params& prm = hp.prm;
  const int Tlen = prm.T;
  int bh, rank;
  block_order<kFwdHeadGroup>(&bh, &rank);
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
    for (int s = 0; s < kFwdStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * kWgThreads / 32);
    }
    mbar_init(resident, 1);
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = warpgroup_index();
  const int tid = threadIdx.x % kWgThreads;
  if (wg == kConsumers) {
    // Producer: one thread issues every load.
    if (tid == 0) {
      // The Q tiles that hold a row before T: never a box past T.
      const int parts = min(kConsumers, (Tlen - q0 + kStream - 1) / kStream);
      mbar_arrive_expect_tx(resident, parts * kTileBf16);
      for (int i = 0; i < parts; ++i)
        tma_load_4d(sQ + i * kTileElems64, &hp.q, resident, 0,
                    q0 + i * kStream, h, b);
      FwdRing ring;
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
    return;
  }

  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int qw0 = q0 + wg * kStream;    // the warpgroup's first row
  const int row = qw0 + warp * 16 + g;  // this lane's rows: row, row + 8
  const float c = prm.scale * kLog2e;   // scores in log2 units
  const uint64_t desc_q = desc_sw128(sQ + wg * kTileElems64);
  // The warpgroup's live tiles form one run [j_lo, j_hi) (the band).
  int j_lo = 0, j_hi = 0;
  for (int j = n_tiles - 1; j >= 0; --j) {
    if (tile_live(prm, qw0, k_begin + j * kStream)) {
      if (j_hi == 0) j_hi = j + 1;
      j_lo = j;
    }
  }

  float o[32], s[32];
  uint32_t pa[4][4] = {};
#pragma unroll
  for (int e = 0; e < 32; ++e) o[e] = s[e] = 0.f;
  // Per row half: running max (log2 units), this thread's partial sum of
  // p, and the last tile's rescale factor.
  float m_run[2] = {kNegInf, kNegInf}, l_part[2] = {0.f, 0.f};
  float alpha[2] = {1.f, 1.f};

  if (wg == kConsumers - 1) pingpong_pass(wg);
  mbar_wait(resident, 0);
  FwdRing ring;
  int j = 0;
  for (; j < j_lo; ++j) pass_tile(ring, wg, full, empty, lane);
  if (j_hi > j_lo) {
    // The run's first tile: S alone, then (without kOverlap) its P V.
    mbar_wait(&full[ring.stage], ring.phase);
    pingpong_wait(wg);
    issue_s(s, desc_q, sK + ring.stage * kTileElems64);
    pingpong_pass(wg);
    wgmma_wait<0>();
    fence_regs(s);
    online_softmax(s, m_run, l_part, alpha, prm, qw0, row,
                   k_begin + j * kStream, t, c);
    pack_acc_a(pa, s);
    if (!kOverlap) {
      issue_pv(o, pa, sV + ring.stage * kTileElems64);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pa);
      warp_release(&empty[ring.stage], lane);
    }
    int held = ring.stage;  // with kOverlap: the stage the pending P V reads
    ring.advance();
    for (++j; j < j_hi; ++j) {
      mbar_wait(&full[ring.stage], ring.phase);
      pingpong_wait(wg);
      issue_s(s, desc_q, sK + ring.stage * kTileElems64);
      if (kOverlap) {
        rescale(o, alpha);
        issue_pv(o, pa, sV + held * kTileElems64);
      }
      pingpong_pass(wg);
      if (kOverlap)
        wgmma_wait<1>();  // S; the previous P V runs on
      else
        wgmma_wait<0>();
      fence_regs(s);
      online_softmax(s, m_run, l_part, alpha, prm, qw0, row,
                     k_begin + j * kStream, t, c);
      if (kOverlap) {
        wgmma_wait<0>();  // the previous P V
        fence_regs(o);
        fence_regs(pa);
        warp_release(&empty[held], lane);
      }
      pack_acc_a(pa, s);
      if (!kOverlap) {
        // The product ends within the round: none of its registers is
        // live under the next S, which keeps the warpgroup within the 96
        // registers of two blocks per SM and clear of serialised wgmma
        // (C7512).
        rescale(o, alpha);
        issue_pv(o, pa, sV + ring.stage * kTileElems64);
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(pa);
        warp_release(&empty[ring.stage], lane);
      }
      held = ring.stage;
      ring.advance();
    }
    if (kOverlap) {
      // The run's last P V, in the next round's turn when there is one.
      const bool turn = j < n_tiles;
      if (turn) {
        mbar_wait(&full[ring.stage], ring.phase);
        pingpong_wait(wg);
      }
      rescale(o, alpha);
      issue_pv(o, pa, sV + held * kTileElems64);
      if (turn) pingpong_pass(wg);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pa);
      warp_release(&empty[held], lane);
      if (turn) {
        warp_release(&empty[ring.stage], lane);
        ring.advance();
        ++j;
      }
    }
  }
  for (; j < n_tiles; ++j) pass_tile(ring, wg, full, empty, lane);
  if (wg == 0) pingpong_wait(wg);

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float l = l_part[hh];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int qi = row + 8 * hh;
    if (qi >= Tlen) continue;
    const long long at =
        b * prm.so.b + h * prm.so.h + (long long)qi * prm.so.t + 2 * t;
    if constexpr (kNormalize) {
      const float l_safe = fmaxf(l, 1e-30f);
      bf16* orow = static_cast<bf16*>(prm.o) + at;
#pragma unroll
      for (int j8 = 0; j8 < 8; ++j8)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j8) =
            __floats2bfloat162_rn(o[4 * j8 + 2 * hh] / l_safe,
                                  o[4 * j8 + 2 * hh + 1] / l_safe);
    } else {
      float* orow = static_cast<float*>(prm.o) + at;
#pragma unroll
      for (int j8 = 0; j8 < 8; ++j8)
        *reinterpret_cast<float2*>(orow + 8 * j8) =
            make_float2(o[4 * j8 + 2 * hh], o[4 * j8 + 2 * hh + 1]);
    }
    if (t == 0) {
      prm.l[(long long)bh * Tlen + qi] = l;
      prm.m[(long long)bh * Tlen + qi] = m_run[hh] * kLn2;
    }
  }
}

// The tensor maps and the launch of the wgmma kernel; a map the CUDA driver
// refuses is an error, as a refused launch is.
int launch_wgmma(const Params& prm, int B, cudaStream_t stream) {
  FwdHopParams hp;
  memset(&hp, 0, sizeof(hp));
  const Strides* s[3] = {&prm.sq, &prm.sk, &prm.sv};
  const void* base[3] = {prm.q, prm.k, prm.v};
  CUtensorMap* maps[3] = {&hp.q, &hp.k, &hp.v};
  for (int i = 0; i < 3; ++i)
    if (!hopper::encode_rows_bf16(maps[i], base[i], s[i]->b, s[i]->h,
                                  s[i]->t, B, prm.H, prm.T))
      return (int)cudaErrorInvalidValue;
  hp.prm = prm;
  const int bytes = FwdHopSmem::bytes;
  auto kernel = prm.normalize ? flash_fwd_wgmma<true> : flash_fwd_wgmma<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * prm.H, (prm.T + kOwned - 1) / kOwned);
  kernel<<<grid, kFwdThreads, bytes, stream>>>(hp);
  return (int)cudaGetLastError();
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

template <int D, bool kNormalize = true>
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
    const float l_safe = kNormalize ? fmaxf(l_row[r], 1e-30f) : 1.f;
    for (int c = lane; c < D; c += 32) {
      out[(long long)qi * prm.so.t + c] =
          kNormalize ? o_w[r * kOPitch + c] / l_safe : o_w[r * kOPitch + c];
    }
    if (lane == 0) {
      prm.l[(long long)bh * Tlen + qi] = l_row[r];
      prm.m[(long long)bh * Tlen + qi] = m_row[r];
    }
  }
}

// The launch for dtype and D (a dispatch, not a fallback).
int dispatch(const Params& prm, int B, int D, int dtype, cudaStream_t stream) {
  const dim3 grid(B * prm.H, (prm.T + kBQ - 1) / kBQ);
  const bool n = prm.normalize;
  if (dtype == 1) {
    if (D == 64) return launch_wgmma(prm, B, stream);
    if (D == 128)
      return launch(n ? flash_fwd_bf16<128, 1> : flash_fwd_bf16<128, 1, false>,
                    Bf16Smem<128>::bytes, prm, grid, stream);
  } else if (dtype == 0) {
    if (D == 64)
      return launch(n ? flash_fwd_f32<64> : flash_fwd_f32<64, false>,
                    F32Smem<64>::bytes, prm, grid, stream);
    if (D == 128)
      return launch(n ? flash_fwd_f32<128> : flash_fwd_f32<128, false>,
                    F32Smem<128>::bytes, prm, grid, stream);
  }
  return (int)cudaErrorInvalidValue;
}

int forward(const void* q, const void* k, const void* v, void* o, float* l,
            float* m, int B, int H, int T, int D, const long long* s,
            float scale, int causal, int window, int dtype, int normalize,
            cudaStream_t stream) {
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
  prm.normalize = normalize;
  prm.scale = scale;
  prm.sq = {s[0], s[1], s[2]};
  prm.sk = {s[3], s[4], s[5]};
  prm.sv = {s[6], s[7], s[8]};
  prm.so = {s[9], s[10], s[11]};
  return dispatch(prm, B, D, dtype, stream);
}

}  // namespace

extern "C" {

// q, k, v, o: [B, H, T, D] with element strides (batch, head, seq) given and
// the last dim contiguous, 16-byte aligned rows; l, m: contiguous [B, H, T]
// float32.  dtype 0 = float32, 1 = bfloat16; D must be 64 or 128.  o is in
// q's dtype and holds acc / max(l, 1e-30) (B3).
int edl_flash_attention_fwd(const void* q, const void* k, const void* v,
                            void* o, float* l, float* m, int B, int H, int T,
                            int D, long long q_sb, long long q_sh,
                            long long q_st, long long k_sb, long long k_sh,
                            long long k_st, long long v_sb, long long v_sh,
                            long long v_st, long long o_sb, long long o_sh,
                            long long o_st, float scale, int causal,
                            int window, int dtype, cudaStream_t stream) {
  const long long s[12] = {q_sb, q_sh, q_st, k_sb, k_sh, k_st,
                           v_sb, v_sh, v_st, o_sb, o_sh, o_st};
  return forward(q, k, v, o, l, m, B, H, T, D, s, scale, causal, window,
                 dtype, 1, stream);
}

// The same kernels with no final normalisation (B3p, the TPU kernel with
// normalize=False): o is float32 [B, H, T, D] whatever q's dtype and holds
// the unnormalised acc = sum_j exp(s_ij - m_i) v_j; l and m as above.
int edl_flash_attention_partial_fwd(
    const void* q, const void* k, const void* v, float* o, float* l, float* m,
    int B, int H, int T, int D, long long q_sb, long long q_sh, long long q_st,
    long long k_sb, long long k_sh, long long k_st, long long v_sb,
    long long v_sh, long long v_st, long long o_sb, long long o_sh,
    long long o_st, float scale, int causal, int window, int dtype,
    cudaStream_t stream) {
  const long long s[12] = {q_sb, q_sh, q_st, k_sb, k_sh, k_st,
                           v_sb, v_sh, v_st, o_sb, o_sh, o_st};
  return forward(q, k, v, o, l, m, B, H, T, D, s, scale, causal, window,
                 dtype, 0, stream);
}

}  // extern "C"
