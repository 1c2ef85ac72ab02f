// Flash-attention backward for Hopper (sm_90a): dQ, dK and dV of attention
// from the forward's saved row log-sum-exp, in bf16 or fp16 at head dims up
// to 128.
//
// Replaces the gradient of the TPU kernel tensorflowonspark_tpu/ops/
// attention.py: _flash_fwd_kernel (launched by _flash_fwd_pallas through
// pl.pallas_call): its custom_vjp _flash_attention_tpu has no Pallas
// backward, and its _flash_bwd_rule (:299) recomputes through
// blockwise_attention.  Same contract as the forward:
//   q [B,Sq,H,D], k/v [B,Sk,H,D], dO [B,Sq,H,D] in bf16 or fp16, lse and its
//   cotangent g_lse [B,Sq,H] in f32 -> dq [B,Sq,H,D], dk/dv [B,Sk,H,D] in the
//   input type;
//   key j sits at global position kv_offset + j; the causal mask keeps
//   kv_offset + j <= i; a row whose lse is NEG_INF (every key masked) has
//   P = 0 and so contributes nothing and gets dq = 0.
//
// The arithmetic (FA2; ops/attention.py:flash_attn_bwd_reference is the
// plain version):
//   P = exp(S * scale - lse), S = Q K^T;  dP = dO V^T
//   Delta_i = sum_j P_ij dP_ij - g_lse_i     (d lse / d s = P: the lse
//                                             cotangent folds in here)
//   dS = P o (dP - Delta);  dV = P^T dO;  dK = scale * dS^T Q;  dQ = scale * dS K
// with every product on wgmma (16-bit operands, f32 accumulators) and P and
// dS rounded to the input type only as the A operand of the products that
// consume them.  Delta is the f32 sum of P o dP, not FA2's rowsum(dO o O)
// over the stored O: O is stored in bf16, and that rounding (2^-9 of
// |dO||O|) breaks sum_j dS_ij = 0, which dQ needs where the keys share a
// large common component, as in a trained LM's layers (PERF.md, the
// attention backward's findings).
//
// Bound at the LM's training shape (B=8, S=2048, H=8, D=128, causal, bf16):
// the function's five products over the live pairs are 10*B*H*D*S(S+1)/2 =
// 172 GFLOP, 0.174 ms at 989 TFLOP/s, against about 235 MB of q, k, v, dO,
// lse, dq, dk, dv (0.07 ms at 3.35 TB/s): bound by the tensor cores.  This
// design runs nine products (S and dP in each of its three walks), 0.313 ms
// at the peak rate.
//
// Design: three warp-specialised kernels of the forward's shape (a producer
// warpgroup whose one thread issues every TMA load after setmaxnreg.dec to
// 24 registers; two consumer warpgroups at 240 registers, each owning 64
// rows of the CTA's 128; a ring of kBwdStages shared-memory stages, each
// guarded by a "full" mbarrier (TMA transaction bytes) and an "empty" one
// (one arrival per consumer warp); every product a wgmma; 384 threads, one
// CTA an SM), queued by one call of tos_flash_attn_bwd:
// - flash_bwd_delta_kernel: one CTA per (batch*head, 128 query rows), Q and
//   dO resident; the producer streams the K and V tiles of 64 keys up to the
//   last key the CTA's rows may see.  Per tile each consumer runs S = Q K^T
//   and dP = dO V^T (SS: both operands K-major) and sums P o dP in f32; it
//   writes Delta and lse * log2(e) (+inf on a fully masked row or past Sq,
//   so that exp2 gives P = 0 there) into the caller's scratch, f32
//   [B*H, Sq rounded up to 128] each.
// - flash_bwd_dkdv_kernel: one CTA per (batch*head, 128 keys), K and V
//   resident; the producer streams, per query tile of 64 rows from the
//   first one the causal mask and kv_offset let see the CTA's keys, Q, dO
//   and the tile's Delta and lse * log2(e) (one TMA box of both).  Per tile
//   each consumer runs S^T = K Q^T and dP^T = V dO^T (SS), P^T and
//   dS^T = P^T o (dP^T - Delta) in registers, then dV += P^T dO and
//   dK += dS^T Q (RS: P^T and dS^T go from the accumulators, rounded to 16
//   bits, straight into the A registers, and Q and dO are the B operands
//   read MN-major, as the forward's P V reads V).  dK and dV stay in
//   registers until the epilogue.  A tile that holds no live pair of a
//   consumer's keys (the diagonal's first tile for the second consumer) is
//   released unread by it; a key block no query sees walks nothing and
//   writes zeros.
// - flash_bwd_dq_kernel: the delta kernel's walk again with dS = P o
//   (dP - Delta) and dQ += dS K (RS, K read MN-major).  dQ is computed apart,
//   not by f32 atomics from the dK/dV kernel: no f32 scratch of dQ, no cast
//   pass and no zeroing, and every gradient is the same bit for bit from run
//   to run.
// Delta keeps its own walk: a row's Delta needs all of its keys before any
// of its dS, and the dK/dV kernel needs every row's Delta before its first
// tile, so folding it into the dQ walk would save one launch and one load
// of Q and dO per query block, not a product.
// The causal mask is applied only on tiles that straddle the diagonal (and,
// on the query side, the Sk tail); under it the longest CTAs go first: the
// dK/dV kernel's early keys (blockIdx order) and the query kernels' late
// rows (blockIdx reversed).  In each walk a consumer runs its two SS
// products as two wgmma groups and computes P while the second (dP) runs;
// the dK/dV kernel's dV product runs while dS is computed; the two
// consumers overlap each other's register work besides.
//
// Tiles: a head dim d (a multiple of 8) runs on the narrowest tile of
// DT = 32, 64, 96 or 128 columns that holds it; the tensor maps are encoded
// at d, so TMA zero-fills the columns past d (they change no product) and
// rows past Sq or Sk, and the epilogues store only d columns of rows below
// Sq or Sk.  Tiles of 64 and 128 columns take boxes of 64 columns with the
// 128-byte swizzle, tiles of 32 and 96 boxes of 32 columns with the 64-byte
// one: wgmma reads an MN-major operand (dO, Q, K in the RS products, N = DT)
// in whole swizzle atoms.  The operands are read in place through the
// caller's batch, sequence and head strides (16-byte rows and bases,
// checked by the wrapper, ops/attention.py:_kernel_operand).  The kernels
// allocate nothing.
//
// The mbarrier, TMA and wgmma helpers are in hopper_pipeline.cuh, the
// 16-bit wgmma products and the operand tensor maps in wgmma16.cuh.

#include "hopper_pipeline.cuh"
#include "wgmma16.cuh"

namespace {

constexpr int kBwdThreads = 384;    // producer + two consumer warpgroups
constexpr int kBwdWgRows = 64;      // rows a consumer warpgroup owns
constexpr int kBwdCtaRows = 128;    // rows a CTA holds (ops/attention.py:BWD_CTA_ROWS)
constexpr int kBwdStages = 4;       // ring depth
constexpr int kBwdEmptyArrivals = 8;  // one per consumer warp
constexpr int kBwdProducerRegs = 24;  // setmaxnreg: 128 * 24 + 256 * 240
constexpr int kBwdConsumerRegs = 240; //   = 64,512 <= 65,536 registers
constexpr int kBwdLaunchRegs = kBwdProducerRegs * 128 + kBwdConsumerRegs * 256;

// The tile of DT columns.
template <int DT>
struct BwdTile {
  static_assert(DT == 32 || DT == 64 || DT == 96 || DT == 128, "the backward's tiles");
  // The loop tile: query rows a step of the dK/dV kernel, key rows a step of
  // the delta and dQ kernels (ops/attention.py:bwd_inner_rows).
  static constexpr int kInner = 64;
  static_assert(kInner == kBwdWgRows, "the walks' products are m64n64 of four k16 steps");
  static constexpr bool kNarrowBox = DT == 32 || DT == 96;
  static constexpr int kBoxCols = kNarrowBox ? 32 : 64;
  static constexpr int kRowBytes = 2 * kBoxCols;            // a box row
  static constexpr int kSteps = kBoxCols / 16;              // k-steps per box
  static constexpr uint32_t kLayout = kNarrowBox ? kSwizzle64 : kSwizzle128;
  static constexpr int kGroupBytes = 8 * kRowBytes;         // 8 rows: SBO
  static constexpr int kDSteps = DT / 16;                   // k-steps over D
  static constexpr int kBoxes = DT / kBoxCols;
  static constexpr int kCtaBoxBytes = kBwdCtaRows * kRowBytes;   // a resident box
  static constexpr int kInnerBoxBytes = kInner * kRowBytes;      // a ring box
  static constexpr int kCtaTileBytes = kBoxes * kCtaBoxBytes;
  static constexpr int kInnerTileBytes = kBoxes * kInnerBoxBytes;
  static constexpr int kStatBytes = 2 * kInner * 4;  // a query tile's Delta, lse2
  // the two resident tiles, the ring (two tiles a stage), the dK/dV
  // kernel's Delta/lse2 boxes, 1024 bytes to align the base for the
  // swizzle, the mbarriers
  static constexpr int kRingOffset = 2 * kCtaTileBytes;
  static constexpr int kStatOffset = kRingOffset + kBwdStages * 2 * kInnerTileBytes;
  static constexpr int kBarOffset = kStatOffset + kBwdStages * kStatBytes;
  static constexpr int kSmemBytes = kBarOffset + 1024 + 8 * (2 * kBwdStages + 1);
  static_assert(kSmemBytes <= 232448, "a CTA has 227 KB of shared memory");
};

// Rows of the scratch's Delta and lse2 per batch*head: Sq rounded up to the
// query kernels' CTA, so that the delta kernel writes every row the dK/dV
// kernel's query tiles read (ops/attention.py:bwd_scratch_rows).
inline int scratch_rows(int Sq) {
  const int s = Sq > 0 ? Sq : 1;
  return (s + kBwdCtaRows - 1) / kBwdCtaRows * kBwdCtaRows;
}

struct BwdArgs {
  const float* lse;    // [B, Sq, H]
  const float* g_lse;  // [B, Sq, H], may be null
  uint16_t* dq;
  uint16_t* dk;
  uint16_t* dv;
  float* delta;  // [B*H, sq_rows]
  float* lse2;   // [B*H, sq_rows], lse * log2(e) or +inf
  int H, Sq, Sk, d, sq_rows;
  int64_t st[9];  // batch, sequence and head strides (elements) of dq, dk, dv
  int causal, kv_offset;
  float scale, scale_log2;
};

// The accumulator of a consumer (wgmma layout: d[4n + e] holds row
// 16 * warp + g + 8 * (e >> 1), column 8n + 2t + (e & 1)) times `mul`, in
// the input type, to the rows below S of its 64 from r0 of one head's slice
// (row stride rs), its columns below d only.
template <bool kBf16, int N>
__device__ __forceinline__ void store_rows(uint16_t* dst, int64_t rs, const float (&acc)[N / 2],
                                           float mul, int r0, int S, int d, int warp, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < N / 8; ++n) {
    const int c = n * 8 + 2 * t;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + 16 * warp + g + 8 * half;
      if (r < S && c < d)
        *reinterpret_cast<uint32_t*>(dst + static_cast<int64_t>(r) * rs + c) =
            pack2<kBf16>(acc[4 * n + 2 * half] * mul, acc[4 * n + 2 * half + 1] * mul);
    }
  }
}

// The A registers of the k16 steps of a 64 x 64 accumulator, rounded to the
// input type: columns 16kk..16kk+15 are x[8kk .. 8kk+7] in pairs.
template <bool kBf16>
__device__ __forceinline__ void pack_a(uint32_t (&a)[4][4], const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) a[kk][i] = pack2<kBf16>(x[8 * kk + 2 * i], x[8 * kk + 2 * i + 1]);
}

// x (64 x 64) = A B^T over the tile's D/16 k-steps, both K-major: A the
// consumer's 64 rows of a resident tile (a, boxes kCtaBoxBytes apart), B a
// ring tile (boxes kInnerBoxBytes apart).  Issues the wgmma only: the
// caller fences, commits and waits.
template <int DT, bool kBf16>
__device__ __forceinline__ void ss_steps(float (&x)[32], uint32_t a, uint32_t b) {
  using C = BwdTile<DT>;
#pragma unroll
  for (int kk = 0; kk < C::kDSteps; ++kk) {
    const uint32_t at = (kk / C::kSteps) * C::kCtaBoxBytes + (kk % C::kSteps) * 32;
    const uint32_t bt = (kk / C::kSteps) * C::kInnerBoxBytes + (kk % C::kSteps) * 32;
    wgmma_ss<64, kBf16>(x, smem_desc(a + at, 16, C::kGroupBytes, C::kLayout),
                        smem_desc(b + bt, 16, C::kGroupBytes, C::kLayout), kk > 0);
  }
}

// acc (64 x DT) += A B over 64 rows of B: A in registers (pack_a), B a ring
// tile read MN-major (its DT columns along N, boxes kInnerBoxBytes apart).
template <int DT, bool kBf16>
__device__ __forceinline__ void rs_steps(float (&acc)[DT / 2], const uint32_t (&a)[4][4],
                                         uint32_t b) {
  using C = BwdTile<DT>;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs<DT, kBf16>(acc, a[kk],
                        smem_desc(b + kk * 16 * C::kRowBytes, C::kInnerBoxBytes,
                                  C::kGroupBytes, C::kLayout));
}

// ---------------------------------------------------------------------------
// dK and dV: one CTA per (batch*head, 128 keys).
// ---------------------------------------------------------------------------
template <int DT, bool kBf16>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_do,
                      const __grid_constant__ CUtensorMap tm_stat, const BwdArgs p) {
  using C = BwdTile<DT>;
  constexpr int S = kBwdStages;
  constexpr int BQ = C::kInner;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms 1024-aligned
  const float* const stat = reinterpret_cast<const float*>(smem_raw + (base - raw) +
                                                           C::kStatOffset);
  const uint32_t ks = base, vs = base + C::kCtaTileBytes;
  const uint32_t ring = base + C::kRingOffset;  // stage s: Q, then dO
  const uint32_t bars = base + C::kBarOffset;   // full[S], empty[S], kv
  const uint32_t kvbar = bars + 16 * S;

  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int j0 = blockIdx.y * kBwdCtaRows;  // early keys first: the longest walks
  // the first query row that sees key j0 (causal: kv_offset + j0 <= i), its
  // tile, and the tiles from there to Sq; none: the block writes zeros
  const int first = p.causal ? max(0, p.kv_offset + j0) : 0;
  const int i_begin = first / BQ * BQ;
  const int ntiles = first < p.Sq ? (p.Sq - i_begin + BQ - 1) / BQ : 0;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (S + s), kBwdEmptyArrivals);
    }
    mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup, broadcast from lane 0 so that ptxas knows the consumers'
  // branches around wgmma are uniform
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (wg == 0) {
    // ---------------- producer: one thread loads K, V and fills the ring ---
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kBwdProducerRegs) : "memory");
    if (threadIdx.x == 0 && ntiles > 0) {
      prefetch_map(&tm_q);
      prefetch_map(&tm_do);
      prefetch_map(&tm_stat);
      mbar_expect_tx(kvbar, 2 * C::kCtaTileBytes);
#pragma unroll
      for (int x = 0; x < C::kBoxes; ++x) {
        tma_load(ks + x * C::kCtaBoxBytes, &tm_k, kvbar, x * C::kBoxCols, j0, h, b);
        tma_load(vs + x * C::kCtaBoxBytes, &tm_v, kvbar, x * C::kBoxCols, j0, h, b);
      }
      for (int it = 0; it < ntiles; ++it) {
        const int s = it % S;
        const int i0 = i_begin + it * BQ;
        const uint32_t full = bars + 8 * s;
        mbar_wait(bars + 8 * (S + s), ((it / S) & 1) ^ 1);  // stage released
        mbar_expect_tx(full, 2 * C::kInnerTileBytes + C::kStatBytes);
        const uint32_t qs = ring + s * 2 * C::kInnerTileBytes;
#pragma unroll
        for (int x = 0; x < C::kBoxes; ++x) {
          tma_load(qs + x * C::kInnerBoxBytes, &tm_q, full, x * C::kBoxCols, i0, h, b);
          tma_load(qs + C::kInnerTileBytes + x * C::kInnerBoxBytes, &tm_do, full,
                   x * C::kBoxCols, i0, h, b);
        }
        tma_load(base + C::kStatOffset + s * C::kStatBytes, &tm_stat, full, i0, bh, 0, 0);
      }
    }
  } else {
    // ---------------- consumers: 64 keys each -----------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kBwdConsumerRegs) : "memory");
    const int cw = wg - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int jw0 = j0 + kBwdWgRows * cw;  // this consumer's first key
    const int jr = jw0 + 16 * warp + g;    // this thread's keys: jr, jr + 8
    const uint32_t k_rows = ks + cw * kBwdWgRows * C::kRowBytes;  // its rows of each box
    const uint32_t v_rows = vs + cw * kBwdWgRows * C::kRowBytes;
    const bool has_keys = jw0 < p.Sk;

    float dk[DT / 2], dv[DT / 2];
#pragma unroll
    for (int i = 0; i < DT / 2; ++i) dk[i] = dv[i] = 0.f;

    if (ntiles > 0) mbar_wait(kvbar, 0);
    for (int it = 0; it < ntiles; ++it) {
      const int s = it % S;
      const int i0 = i_begin + it * BQ;
      mbar_wait(bars + 8 * s, (it / S) & 1);
      // a tile with a live pair of this consumer's keys (causal: its first
      // key seen by the tile's last row)
      if (has_keys && (!p.causal || p.kv_offset + jw0 <= min(i0 + BQ, p.Sq) - 1)) {
        const uint32_t qs = ring + s * 2 * C::kInnerTileBytes;
        const uint32_t dos = qs + C::kInnerTileBytes;
        const float* const ld = stat + s * (C::kStatBytes / 4);  // Delta[64], lse2[64]

        // S^T = K Q^T and dP^T = V dO^T (64 keys x 64 queries each), two
        // wgmma groups: P^T is computed while dP^T runs
        float sc[32], dp[32];
        pin(sc);
        pin(dp);
        wgmma_fence();
        ss_steps<DT, kBf16>(sc, k_rows, qs);
        wgmma_commit();
        ss_steps<DT, kBf16>(dp, v_rows, dos);
        wgmma_commit();
        wgmma_wait<1>();
        pin(sc);

        // P^T (masked only on tiles that straddle the diagonal; a query row
        // past Sq or fully masked has lse2 = +inf, so P = 0), then dV +=
        // P^T dO, run while dS^T is computed
        const bool edge = p.causal && p.kv_offset + jw0 + kBwdWgRows - 1 > i0;
#pragma unroll
        for (int n = 0; n < BQ / 8; ++n) {
          const float2 l2 = *reinterpret_cast<const float2*>(ld + BQ + 8 * n + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float pe = ex2(fmaf(sc[4 * n + e], p.scale_log2, -((e & 1) ? l2.y : l2.x)));
            if (edge && p.kv_offset + jr + 8 * (e >> 1) > i0 + 8 * n + 2 * t + (e & 1))
              pe = 0.f;
            sc[4 * n + e] = pe;
          }
        }
        uint32_t pa[4][4];
        pack_a<kBf16>(pa, sc);
        pin(dv);
        wgmma_fence();
        rs_steps<DT, kBf16>(dv, pa, dos);
        wgmma_commit();
        wgmma_wait<1>();  // dP^T
        pin(dp);

        // dS^T = P^T o (dP^T - Delta), then dK += dS^T Q
#pragma unroll
        for (int n = 0; n < BQ / 8; ++n) {
          const float2 dl = *reinterpret_cast<const float2*>(ld + 8 * n + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dp[4 * n + e] = sc[4 * n + e] * (dp[4 * n + e] - ((e & 1) ? dl.y : dl.x));
        }
        uint32_t da[4][4];
        pack_a<kBf16>(da, dp);
        pin(dk);
        wgmma_fence();
        rs_steps<DT, kBf16>(dk, da, qs);
        wgmma_commit();
        wgmma_wait_all();
        pin(dv);
        pin(dk);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(bars + 8 * (S + s));  // release the stage
    }
    if (has_keys) {
      const int64_t* st = p.st;
      store_rows<kBf16, DT>(p.dk + b * st[3] + h * st[5], st[4], dk, p.scale, jw0, p.Sk, p.d,
                            warp, lane);
      store_rows<kBf16, DT>(p.dv + b * st[6] + h * st[8], st[7], dv, 1.f, jw0, p.Sk, p.d, warp,
                            lane);
    }
  }
}

// ---------------------------------------------------------------------------
// The query-side walk, one CTA per (batch*head, 128 query rows), the longest
// causal rows first: the K and V tiles up to the last key its rows may see,
// S = Q K^T and dP = dO V^T on each.  kDelta: the delta pass, Delta =
// sum_j P o dP - g_lse and lse * log2(e) into the scratch; else the dQ
// pass, dQ = scale * sum_j P o (dP - Delta) K.
// ---------------------------------------------------------------------------
template <int DT, bool kBf16, bool kDelta>
__device__ __forceinline__ void query_pass(const CUtensorMap& tm_q, const CUtensorMap& tm_do,
                                           const CUtensorMap& tm_k, const CUtensorMap& tm_v,
                                           const BwdArgs& p) {
  using C = BwdTile<DT>;
  constexpr int S = kBwdStages;
  constexpr int BK = C::kInner;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms 1024-aligned
  const uint32_t qs = base, dos = base + C::kCtaTileBytes;
  const uint32_t ring = base + C::kRingOffset;  // stage s: K, then V
  const uint32_t bars = base + C::kBarOffset;   // full[S], empty[S], q
  const uint32_t qbar = bars + 16 * S;

  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int i0 = (gridDim.y - 1 - blockIdx.y) * kBwdCtaRows;  // longest first
  // the keys the CTA's last row may see (causal: kv_offset + j <= i)
  int keys = p.Sk;
  if (p.causal) keys = max(0, min(p.Sk, min(i0 + kBwdCtaRows, p.Sq) - p.kv_offset));
  const int nkb = (keys + BK - 1) / BK;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (S + s), kBwdEmptyArrivals);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (wg == 0) {
    // ---------------- producer: one thread loads Q, dO and fills the ring --
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kBwdProducerRegs) : "memory");
    if (threadIdx.x == 0 && nkb > 0) {
      prefetch_map(&tm_k);
      prefetch_map(&tm_v);
      mbar_expect_tx(qbar, 2 * C::kCtaTileBytes);
#pragma unroll
      for (int x = 0; x < C::kBoxes; ++x) {
        tma_load(qs + x * C::kCtaBoxBytes, &tm_q, qbar, x * C::kBoxCols, i0, h, b);
        tma_load(dos + x * C::kCtaBoxBytes, &tm_do, qbar, x * C::kBoxCols, i0, h, b);
      }
      for (int kb = 0; kb < nkb; ++kb) {
        const int s = kb % S;
        const uint32_t full = bars + 8 * s;
        mbar_wait(bars + 8 * (S + s), ((kb / S) & 1) ^ 1);  // stage released
        mbar_expect_tx(full, 2 * C::kInnerTileBytes);
        const uint32_t kt = ring + s * 2 * C::kInnerTileBytes;
#pragma unroll
        for (int x = 0; x < C::kBoxes; ++x) {
          tma_load(kt + x * C::kInnerBoxBytes, &tm_k, full, x * C::kBoxCols, kb * BK, h, b);
          tma_load(kt + C::kInnerTileBytes + x * C::kInnerBoxBytes, &tm_v, full,
                   x * C::kBoxCols, kb * BK, h, b);
        }
      }
    }
  } else {
    // ---------------- consumers: 64 query rows each -----------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kBwdConsumerRegs) : "memory");
    const int cw = wg - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int qw0 = i0 + kBwdWgRows * cw;  // this consumer's first row
    const int r0 = qw0 + 16 * warp + g;    // this thread's rows: r0, r0 + 8
    const uint32_t q_rows = qs + cw * kBwdWgRows * C::kRowBytes;  // its rows of each box
    const uint32_t do_rows = dos + cw * kBwdWgRows * C::kRowBytes;
    // the keys this consumer's last row may see
    int my_keys = qw0 < p.Sq ? p.Sk : 0;
    if (p.causal) my_keys = max(0, min(my_keys, min(qw0 + kBwdWgRows, p.Sq) - p.kv_offset));

    // the thread's two rows: lse * log2(e) (+inf on a fully masked row or
    // past Sq) and Delta
    float lse2[2], delta[2] = {0.f, 0.f};
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = r0 + 8 * half;
      if constexpr (kDelta) {
        const float l = i < p.Sq ? p.lse[(static_cast<int64_t>(b) * p.Sq + i) * p.H + h] : kNegInf;
        lse2[half] = l > kHalfNegInf ? l * kLog2e : __int_as_float(0x7f800000);
      } else {
        const int64_t at = static_cast<int64_t>(bh) * p.sq_rows + i;
        lse2[half] = p.lse2[at];
        delta[half] = p.delta[at];
      }
    }
    // kDelta: the thread's share of its two rows' sum of P o dP; else dQ
    float acc[kDelta ? 2 : DT / 2];
#pragma unroll
    for (int i = 0; i < (kDelta ? 2 : DT / 2); ++i) acc[i] = 0.f;

    if (nkb > 0) mbar_wait(qbar, 0);
    for (int kb = 0; kb < nkb; ++kb) {
      const int s = kb % S;
      const int k0 = kb * BK;
      mbar_wait(bars + 8 * s, (kb / S) & 1);
      if (k0 < my_keys) {
        const uint32_t kt = ring + s * 2 * C::kInnerTileBytes;
        const uint32_t vt = kt + C::kInnerTileBytes;

        // S = Q K^T and dP = dO V^T (64 queries x 64 keys each), two wgmma
        // groups: P is computed while dP runs
        float sc[32], dp[32];
        pin(sc);
        pin(dp);
        wgmma_fence();
        ss_steps<DT, kBf16>(sc, q_rows, kt);
        wgmma_commit();
        ss_steps<DT, kBf16>(dp, do_rows, vt);
        wgmma_commit();
        wgmma_wait<1>();
        pin(sc);

        // P (masked only on tiles that straddle the diagonal or the Sk tail)
        const bool edge =
            k0 + BK > p.Sk || (p.causal && p.kv_offset + k0 + BK - 1 > qw0);
#pragma unroll
        for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float pe = ex2(fmaf(sc[4 * n + e], p.scale_log2, -lse2[e >> 1]));
            if (edge) {
              const int j = k0 + 8 * n + 2 * t + (e & 1);
              if (!(j < p.Sk && (!p.causal || p.kv_offset + j <= r0 + 8 * (e >> 1)))) pe = 0.f;
            }
            sc[4 * n + e] = pe;
          }
        }
        wgmma_wait<0>();  // dP
        pin(dp);
#pragma unroll
        for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if constexpr (kDelta) {
              acc[e >> 1] = fmaf(sc[4 * n + e], dp[4 * n + e], acc[e >> 1]);
            } else {
              sc[4 * n + e] *= dp[4 * n + e] - delta[e >> 1];  // dS
            }
          }
        }
        if constexpr (!kDelta) {
          // dQ += dS K
          uint32_t da[4][4];
          pack_a<kBf16>(da, sc);
          pin(acc);
          wgmma_fence();
          rs_steps<DT, kBf16>(acc, da, kt);
          wgmma_commit();
          wgmma_wait_all();
          pin(acc);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(bars + 8 * (S + s));  // release the stage
    }
    if constexpr (kDelta) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        // the four threads of a row group hold the row's columns
        float sum = acc[half];
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        const int i = r0 + 8 * half;
        if (t == 0) {  // every row below sq_rows: the dK/dV kernel reads them
          const int64_t at = static_cast<int64_t>(bh) * p.sq_rows + i;
          const float gl =
              i < p.Sq && p.g_lse != nullptr
                  ? p.g_lse[(static_cast<int64_t>(b) * p.Sq + i) * p.H + h]
                  : 0.f;
          p.delta[at] = sum - gl;
          p.lse2[at] = lse2[half];
        }
      }
    } else {
      const int64_t* st = p.st;
      store_rows<kBf16, DT>(p.dq + b * st[0] + h * st[2], st[1], acc, p.scale, qw0, p.Sq, p.d,
                            warp, lane);
    }
  }
}

template <int DT, bool kBf16>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_bwd_delta_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_do,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v, const BwdArgs p) {
  query_pass<DT, kBf16, true>(tm_q, tm_do, tm_k, tm_v, p);
}

template <int DT, bool kBf16>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_do,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v, const BwdArgs p) {
  query_pass<DT, kBf16, false>(tm_q, tm_do, tm_k, tm_v, p);
}

// ---------------------------------------------------------------------------
// Host side.
// ---------------------------------------------------------------------------

// The scratch's Delta and lse2 as one rank-4 f32 map: dims (sq_rows, B*H,
// 2, 1), box (`rows`, 1, both, 1), so one TMA box brings a query tile's
// Delta and lse2.
bool encode_stat_map(CUtensorMap* map, float* scratch, int BH, int sq_rows, int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(sq_rows), static_cast<cuuint64_t>(BH),
                              2, 1};
  const cuuint64_t plane = static_cast<cuuint64_t>(BH) * sq_rows * 4;
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sq_rows) * 4, plane, 2 * plane};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(rows), 1, 2, 1};
  return encode_map_4d(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, scratch, dims, strides, box,
                       CU_TENSOR_MAP_SWIZZLE_NONE);
}

template <int DT, bool kBf16>
cudaError_t launch_bwd(const BwdArgs& p, int B, const void* q, const void* k, const void* v,
                       const void* dout, const int64_t* st, cudaStream_t stream) {
  using C = BwdTile<DT>;
  const int BH = B * p.H;
  // the resident tiles' maps (128 rows a box) and the ring's (64)
  CUtensorMap q_cta, do_cta, k_cta, v_cta, q_in, do_in, k_in, v_in, stat;
  const int cols = C::kBoxCols;
  if (!encode_map(&q_cta, q, kBf16, B, p.Sq, p.H, p.d, st, kBwdCtaRows, cols) ||
      !encode_map(&do_cta, dout, kBf16, B, p.Sq, p.H, p.d, st + 9, kBwdCtaRows, cols) ||
      !encode_map(&k_cta, k, kBf16, B, p.Sk, p.H, p.d, st + 3, kBwdCtaRows, cols) ||
      !encode_map(&v_cta, v, kBf16, B, p.Sk, p.H, p.d, st + 6, kBwdCtaRows, cols) ||
      !encode_map(&q_in, q, kBf16, B, p.Sq, p.H, p.d, st, C::kInner, cols) ||
      !encode_map(&do_in, dout, kBf16, B, p.Sq, p.H, p.d, st + 9, C::kInner, cols) ||
      !encode_map(&k_in, k, kBf16, B, p.Sk, p.H, p.d, st + 3, C::kInner, cols) ||
      !encode_map(&v_in, v, kBf16, B, p.Sk, p.H, p.d, st + 6, C::kInner, cols) ||
      !encode_stat_map(&stat, p.delta, BH, p.sq_rows, C::kInner))
    return cudaErrorInvalidValue;
  auto* delta_kernel = flash_bwd_delta_kernel<DT, kBf16>;
  auto* dkdv_kernel = flash_bwd_dkdv_kernel<DT, kBf16>;
  auto* dq_kernel = flash_bwd_dq_kernel<DT, kBf16>;
  constexpr int smem = C::kSmemBytes;
  const void* kernels[3] = {reinterpret_cast<const void*>(delta_kernel),
                            reinterpret_cast<const void*>(dkdv_kernel),
                            reinterpret_cast<const void*>(dq_kernel)};
  for (const void* kernel : kernels) {
    const cudaError_t err = configure_once(kernel, smem, kBwdLaunchRegs, kBwdThreads);
    if (err != cudaSuccess) return err;
  }
  const dim3 query_grid(BH, (p.Sq + kBwdCtaRows - 1) / kBwdCtaRows);
  cudaError_t err = cudaSuccess;
  if (p.Sq > 0) {
    delta_kernel<<<query_grid, kBwdThreads, smem, stream>>>(q_cta, do_cta, k_in, v_in, p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (p.Sk > 0) {
    dkdv_kernel<<<dim3(BH, (p.Sk + kBwdCtaRows - 1) / kBwdCtaRows), kBwdThreads, smem,
                  stream>>>(k_cta, v_cta, q_in, do_in, stat, p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (p.Sq > 0) {
    dq_kernel<<<query_grid, kBwdThreads, smem, stream>>>(q_cta, do_cta, k_in, v_in, p);
    err = cudaGetLastError();
  }
  return err;
}

template <bool kBf16>
cudaError_t launch_bwd_tile(const BwdArgs& p, int B, const void* q, const void* k,
                            const void* v, const void* dout, const int64_t* st,
                            cudaStream_t s) {
  if (p.d <= 32) return launch_bwd<32, kBf16>(p, B, q, k, v, dout, st, s);
  if (p.d <= 64) return launch_bwd<64, kBf16>(p, B, q, k, v, dout, st, s);
  if (p.d <= 96) return launch_bwd<96, kBf16>(p, B, q, k, v, dout, st, s);
  return launch_bwd<128, kBf16>(p, B, q, k, v, dout, st, s);
}

}  // namespace

// dq, dk, dv of attention (see the top of this file).  `strides` holds the
// batch, sequence and head strides (elements) of q, k, v, dout, dq, dk and
// dv, 21 in all; every head dim stride is 1, every other stride a multiple
// of 8 and every base 16-byte aligned.  lse and g_lse (may be null) are
// contiguous [B, Sq, H].  `scratch` holds 2 * B * H * scratch_rows(Sq)
// floats (Delta and lse2), 16-byte aligned.  dtype: 0 bf16, 1 fp16.  Returns
// cudaGetLastError() of the launches (0 on success), or
// cudaErrorInvalidValue for an input it does not take or a tensor map
// cuTensorMapEncodeTiled refuses.  Launches on `stream`, does not
// synchronise, and allocates nothing.
extern "C" int tos_flash_attn_bwd(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse, const void* g_lse,
                                  void* dq, void* dk, void* dv, void* scratch, int B,
                                  int Sq, int Sk, int H, int D, const int64_t* strides,
                                  int causal, int kv_offset, float sm_scale, int dtype,
                                  void* stream) {
  if (B <= 0 || H <= 0) return 0;  // nothing to launch
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (D < 1 || D > 128 || D % 8 != 0 || Sq < 0 || Sk < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs p;
  p.lse = static_cast<const float*>(lse);
  p.g_lse = static_cast<const float*>(g_lse);
  p.dq = static_cast<uint16_t*>(dq);
  p.dk = static_cast<uint16_t*>(dk);
  p.dv = static_cast<uint16_t*>(dv);
  p.sq_rows = scratch_rows(Sq);
  p.delta = static_cast<float*>(scratch);
  p.lse2 = p.delta + static_cast<int64_t>(B) * H * p.sq_rows;
  p.H = H;
  p.Sq = Sq;
  p.Sk = Sk;
  p.d = D;
  for (int i = 0; i < 9; ++i) p.st[i] = strides[12 + i];
  p.causal = causal;
  p.kv_offset = kv_offset;
  p.scale = sm_scale;
  p.scale_log2 = sm_scale * kLog2e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 0 ? launch_bwd_tile<true>(p, B, q, k, v, dout, strides, s)
                                     : launch_bwd_tile<false>(p, B, q, k, v, dout, strides, s);
  return static_cast<int>(err);
}

// Dynamic shared memory of one CTA of the three kernels (the same) on the
// tile of D columns (32, 64, 96 or 128); else 0.
extern "C" int tos_flash_attn_bwd_smem_bytes(int D) {
  return D == 32 ? BwdTile<32>::kSmemBytes
         : D == 64 ? BwdTile<64>::kSmemBytes
         : D == 96 ? BwdTile<96>::kSmemBytes
         : D == 128 ? BwdTile<128>::kSmemBytes
                    : 0;
}
