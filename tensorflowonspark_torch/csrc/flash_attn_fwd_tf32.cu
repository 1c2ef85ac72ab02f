// Flash-attention forward for f32 inputs on Hopper's tensor cores (sm_90a),
// each f32 product as three TF32 `wgmma`s (3xTF32): online softmax over key
// blocks, returning the output O and the row log-sum-exp.
//
// Replaces, for f32 inputs at every head dim, the TPU kernel
// tensorflowonspark_tpu/ops/attention.py:_flash_fwd_kernel (launched by
// _flash_fwd_pallas through pl.pallas_call), which computes in f32.  Every
// head dim runs at its real value, padded by the wrapper (ops/attention.py)
// only to a multiple of 4 where it is not one: up to 128 on the tile of 32,
// 64, 96 or 128 columns that holds it (TMA zero-fills the tile's columns
// past D), above 128 on the wide route (below).  The contract is the other
// kernels':
//   q [B,Sq,H,D], k/v [B,Sk,H,D] in f32 with unit stride along D ->
//   O [B,Sq,H,D] in f32 and lse [B,Sq,H] in f32;
//   key j sits at global position kpos = kv_offset + j; the causal mask keeps
//   kpos <= qpos, the tail mask keeps j < Sk; masked logits are NEG_INF =
//   -1e30 and every exp is guarded, so a row with every position masked
//   gives O = 0 and lse = NEG_INF, never NaN; key blocks wholly in the
//   causal future of a CTA's rows are not loaded.
//
// Precision.  TF32 keeps 10 mantissa bits, too coarse for the f32 gate
// (1e-4 against an f32 reference).  Each operand is split x = hi + lo with
// hi = x with its low 13 mantissa bits cleared and lo = tf32(x - hi), and
// a.b ~ a_lo.b_hi + a_hi.b_lo + a_hi.b_hi (the lo.lo term, ~2^-20 of a.b,
// is dropped; small terms are summed first), so a product is good to about
// 2^-20 relative.  The tensor cores read only the upper 19 bits of a .tf32
// operand, so hi needs no plane of its own where the raw f32 can be read:
// K is read by TMA straight from the caller's tensor.  Q's and P's hi are
// cleared explicitly (they are touched anyway), and V's is written by the
// pre-pass.
//
// Bound at the serving shape (B=4, S=2048, H=8, D=128, causal): the two
// products cost 34.4 GFLOP, so 3xTF32 is 103 GFLOP, 0.209 ms at the card's
// 495 TFLOP/s of dense TF32 (against 0.514 ms for the same 34.4 GFLOP as
// f32 FMA on CUDA cores), and q/k/v/O/lse plus the pre-pass's scratch move
// about 0.4 GB, 0.12 ms at 3.35 TB/s: bound by the tensor cores.
//
// Design (simple and right first: no ping-pong, no in-smem K/V split):
// - Pre-pass kernel (split_kv_kernel), same stream: reads k and v through
//   their strides and writes, into scratch the wrapper allocates,
//   K_lo [B,H,Sk,D], and V transposed to keys-contiguous, Vt_hi and Vt_lo
//   [B,H,D,Skp] (Skp = Sk rounded up to 8, zeros past Sk).  The transpose is
//   needed because a .tf32 wgmma takes its B operand only K-major (there is
//   no transpose bit for .tf32), and in P V the keys are K.  Within each
//   group of 8 keys the pre-pass stores key pi(j) = 2(j & 3) + (j >> 2) at
//   position j: the k8 A fragment of a tf32 wgmma wants, per thread, the
//   columns t and t+4 of its rows, while the S accumulator holds columns 2t
//   and 2t+1, so permuting V's keys to match lets P go from the S
//   accumulator straight into the A registers with no shuffle.
// - Main kernel: one CTA per (batch*head, 64 query rows), the longest
//   causal tiles first; 160 threads.  Warp 4 is the producer: one thread
//   starts every load with TMA, the Q tile once, then per block of 32 keys
//   K_hi (the caller's k), K_lo, Vt_hi and Vt_lo into a 2-stage ring guarded
//   by "full" (transaction bytes) and "empty" (one arrival per consumer
//   warp) mbarriers.  Warps 0-3 are one consumer warpgroup.  It splits its
//   Q tile into Q_hi and Q_lo in shared memory once (elementwise, so the
//   swizzle does not matter), then per key block: S = Q K^T as 3 x D/8
//   `wgmma` m64n32k8 SS (both operands K-major, 128-byte swizzle), the mask
//   on blocks that straddle the diagonal or the Sk tail, the online softmax
//   with exp2 (the same guards as the bf16 kernel), P split into hi and lo
//   in registers, and O += P V as 3 x 4 `wgmma` m64nDk8 RS.
// - Epilogue: O / l stored from registers as float2 (each warp store fills
//   whole 32-byte sectors); lse = m + log l, or NEG_INF where l = 0.
//
// Tiles and shared memory at D=128: Q_hi + Q_lo 2 x 32 KB; a stage K_hi,
// K_lo, Vt_hi, Vt_lo 4 x 16 KB; 2 stages: 192 KB + the mbarriers.  At D=64
// half of that (96 KB), at D=96 three quarters (144 KB); at D=32 16 KB of Q
// and 16 KB a stage, 4 stages deep (80 KB).  Registers per consumer thread:
// O D/2, S 16, P hi/lo 32, plus the row state.
//
// The real head dim d (a multiple of 4 up to 128) runs on the tile of D =
// 32, 64, 96 or 128 columns that holds it: a box is 32 f32 columns (one
// 128-byte swizzle row), so every tile is whole boxes and every box holds a
// real column.  The tensor maps of q, k and the pre-pass's planes are
// encoded at d, so TMA zero-fills the columns (of Vt: the rows) past d; the
// pre-pass reads and writes d columns, Q K^T and P V run at the tile's
// width (the zero columns' products included: see the main kernel), and the
// epilogue writes O's d columns into the caller's tensor.  Nothing is padded
// or copied in device memory.
//
// D > 128 (flash_fwd_tf32_wide_kernel, at the real head dim): one tile of
// 64 query rows per CTA, the head dim split between two consumer
// warpgroups (each owns half of Q K^T's contraction and up to 256 columns of
// O; the partial S tiles summed through shared memory), the hi/lo split of
// Q, K and Vt done in shared memory from the tiles TMA loaded, V's
// transpose the only pre-pass, split-KV with a combine kernel on small
// grids; see the section below.
//
// The TF32 split, the .tf32 wgmma products and the f32 tensor map are in
// wgmma_tf32.cuh, shared with the f32 backward (flash_attn_bwd_tf32.cu).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (tensorflowonspark_torch/ops/cuda_build.py does it).

#include "hopper_pipeline.cuh"
#include "wgmma_tf32.cuh"

namespace {

constexpr int kBlockQ = 64;        // query rows per CTA: one consumer warpgroup
constexpr int kBlockK = 32;        // keys per ring stage
constexpr int kThreads = 160;      // consumer warps 0-3, producer warp 4
constexpr int kBoxCols = 32;       // 128-byte swizzle: 32 f32 values
constexpr int kEmptyArrivals = 4;  // one per consumer warp

// The tile of D columns (32, 64, 96 or 128).
template <int D>
struct Cfg {
  static_assert(D == 32 || D == 64 || D == 96 || D == 128, "the tiles of D <= 128");
  static constexpr int kBoxes = D / kBoxCols;             // 32-column boxes
  static constexpr int kQBoxBytes = kBlockQ * 128;
  static constexpr int kKBoxBytes = kBlockK * 128;
  static constexpr int kQTileBytes = kBoxes * kQBoxBytes;  // Q_hi or Q_lo
  static constexpr int kKTileBytes = kBoxes * kKBoxBytes;  // K_hi or K_lo
  static constexpr int kVTileBytes = D * 128;              // D rows x 32 keys
  static constexpr int kQKSteps = D / 8;                   // Q K^T's k-steps of 8
  static constexpr int kStageBytes = 2 * kKTileBytes + 2 * kVTileBytes;
  // ring depth: deeper where a stage is small
  static constexpr int kStages = D == 32 ? 4 : 2;
  static constexpr int kBarOffset = 2 * kQTileBytes + kStages * kStageBytes;
  // tiles, 1024 bytes to align the base for the swizzle, the mbarriers
  static constexpr int kSmemBytes = kBarOffset + 1024 + 8 * (2 * kStages + 1);
  static_assert(kSmemBytes <= 232448, "a CTA has 227 KB of shared memory");
};

// ---------------------------------------------------------------------------
// Pre-pass: K_lo [B,H,Sk,D], and V transposed (keys contiguous, permuted in
// groups of 8) as Vt_hi and Vt_lo [B,H,D,Skp], at the real head dim D.  Grid
// (ceil(Skp / 32), ceil(D / 32), B*H), 32 x 8 threads.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(256)
split_kv_kernel(const float* __restrict__ k, const float* __restrict__ v,
                float* __restrict__ klo, float* __restrict__ vt_hi,
                float* __restrict__ vt_lo, int H, int Sk, int Skp, int D,
                int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb,
                int64_t v_ss, int64_t v_sh) {
  __shared__ float tile[32][33];
  const int bh = blockIdx.z;
  const int b = bh / H;
  const int h = bh % H;
  const int j0 = blockIdx.x * 32;
  const int d0 = blockIdx.y * 32;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const float* kh = k + b * k_sb + h * k_sh + d0 + tx;
  const float* vh = v + b * v_sb + h * v_sh + d0 + tx;
#pragma unroll
  for (int r = ty; r < 32; r += 8) {
    const int j = j0 + r;
    float y = 0.f;
    if (j < Sk && d0 + tx < D) {
      klo[(static_cast<int64_t>(bh) * Sk + j) * D + d0 + tx] = tf32_lo(kh[j * k_ss]);
      y = vh[j * v_ss];
    }
    tile[r][tx] = y;  // zero past Sk and D
  }
  __syncthreads();
  // position tx of its group of 8 holds key pi(tx & 7) of the group
  const int src = (tx & ~7) | ((tx & 3) << 1) | ((tx >> 2) & 1);
  if (j0 + tx < Skp) {
#pragma unroll
    for (int r = ty; r < 32; r += 8) {
      if (d0 + r < D) {
        const float y = tile[src][r];
        const int64_t at = (static_cast<int64_t>(bh) * D + d0 + r) * Skp + j0 + tx;
        vt_hi[at] = tf32_hi(y);
        vt_lo[at] = tf32_lo(y);
      }
    }
  }
}

// S = Q_lo K_hi + Q_hi K_lo + Q_hi K_hi over the tile's k-steps of 8
// columns, one straight run of wgmma from the fence to the wait: after 4
// steps the next 32-column box.
template <class C>
__device__ __forceinline__ void qk_product(float (&sc)[16], uint32_t q_hi, uint32_t q_lo,
                                           uint32_t k_hi, uint32_t k_lo) {
  pin(sc);
  wgmma_fence();
#pragma unroll
  for (int term = 0; term < 3; ++term) {
    const uint32_t qa = term == 0 ? q_lo : q_hi;
    const uint32_t kb_ = term == 1 ? k_lo : k_hi;
#pragma unroll
    for (int kk = 0; kk < C::kQKSteps; ++kk) {
      const uint32_t col = (kk % 4) * 32;
      wgmma_ss_n32(sc, smem_desc(qa + (kk / 4) * C::kQBoxBytes + col, 16, 1024),
                   smem_desc(kb_ + (kk / 4) * C::kKBoxBytes + col, 16, 1024),
                   term > 0 || kk > 0);
    }
  }
  wgmma_commit();
  wgmma_wait_all();
  pin(sc);
}

// ---------------------------------------------------------------------------
// Main kernel.
// Accumulator layout of wgmma m64nN (f32), per warp w of the warpgroup and
// lane = 4g + t: d[4n + e] holds row 16w + g + 8*(e >> 1), column
// 8n + 2t + (e & 1).  The A fragment of a tf32 k8 step: a0 = (row g, k t),
// a1 = (g + 8, t), a2 = (g, t + 4), a3 = (g + 8, t + 4).  So for the 8 keys
// 8kk..8kk+7, {d[4kk], d[4kk+2], d[4kk+1], d[4kk+3]} is an A fragment whose
// k index t stands for key 2t and t + 4 for key 2t + 1: the permutation pi
// the pre-pass applied to Vt.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_tf32_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_klo,
                      const __grid_constant__ CUtensorMap tm_vt_hi,
                      const __grid_constant__ CUtensorMap tm_vt_lo,
                      float* __restrict__ o, float* __restrict__ lse, int H,
                      int Sq, int Sk, int d, int64_t o_sb, int64_t o_ss, int64_t o_sh,
                      int causal, int kv_offset, float scale_log2) {
  using C = Cfg<D>;
  constexpr int S = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms 1024-aligned
  uint8_t* const sbase = smem_raw + (base - raw);
  const uint32_t q_hi = base;
  const uint32_t q_lo = base + C::kQTileBytes;
  const uint32_t ring = base + 2 * C::kQTileBytes;
  const uint32_t bars = base + C::kBarOffset;  // full[S], empty[S], q
  const uint32_t qbar = bars + 16 * S;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;  // longest first
  // Keys past the last one any row of this tile may see are never loaded.
  int kend = Sk;
  if (causal) {
    const int qlast = min(q0 + kBlockQ, Sq) - 1;
    kend = min(Sk, max(0, qlast - kv_offset + 1));
  }
  const int nkb = (kend + kBlockK - 1) / kBlockK;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (S + s), kEmptyArrivals);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp == 4) {
    // ---------------- producer: one thread keeps the ring full ----------
    if (lane == 0 && nkb > 0) {
      prefetch_map(&tm_k);
      prefetch_map(&tm_klo);
      prefetch_map(&tm_vt_hi);
      prefetch_map(&tm_vt_lo);
      mbar_expect_tx(qbar, C::kQTileBytes);
#pragma unroll
      for (int x = 0; x < C::kBoxes; ++x)
        tma_load(q_hi + x * C::kQBoxBytes, &tm_q, qbar, x * kBoxCols, q0, h, b);
      for (int kb = 0; kb < nkb; ++kb) {
        const int s = kb % S;
        const uint32_t full = bars + 8 * s;
        mbar_wait(bars + 8 * (S + s), ((kb / S) & 1) ^ 1);  // stage released
        mbar_expect_tx(full, C::kStageBytes);
        const uint32_t st = ring + s * C::kStageBytes;
        const int k0 = kb * kBlockK;
#pragma unroll
        for (int x = 0; x < C::kBoxes; ++x) {
          tma_load(st + x * C::kKBoxBytes, &tm_k, full, x * kBoxCols, k0, h, b);
          tma_load(st + C::kKTileBytes + x * C::kKBoxBytes, &tm_klo, full,
                   x * kBoxCols, k0, h, b);
        }
        tma_load(st + 2 * C::kKTileBytes, &tm_vt_hi, full, k0, 0, h, b);
        tma_load(st + 2 * C::kKTileBytes + C::kVTileBytes, &tm_vt_lo, full, k0,
                 0, h, b);
      }
    }
    return;
  }

  // ---------------- consumer warpgroup: the tile's 64 query rows --------
  const int tid = threadIdx.x;
  const int g = lane / 4;
  const int t = lane % 4;
  const int r0 = q0 + 16 * warp + g;  // this thread's rows: r0, r0 + 8

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};  // running max of the raw logits
  float l[2] = {0.f, 0.f};          // this thread's share of the row sums

  if (nkb > 0) {
    // Split Q into hi and lo, in place and beside it; elementwise, so the
    // swizzled layout TMA wrote is kept.  Then make the generic-proxy
    // writes visible to wgmma (the async proxy) before any thread uses them.
    mbar_wait(qbar, 0);
    float4* const qh4 = reinterpret_cast<float4*>(sbase);
    float4* const ql4 = reinterpret_cast<float4*>(sbase + C::kQTileBytes);
#pragma unroll 4
    for (int i = tid; i < C::kQTileBytes / 16; i += 128) {
      const float4 x = qh4[i];
      const float4 hi = make_float4(tf32_hi(x.x), tf32_hi(x.y), tf32_hi(x.z),
                                    tf32_hi(x.w));
      qh4[i] = hi;
      ql4[i] = make_float4(tf32_round(x.x - hi.x), tf32_round(x.y - hi.y),
                           tf32_round(x.z - hi.z), tf32_round(x.w - hi.w));
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync 1, 128;\n" ::: "memory");
  }

  for (int kb = 0; kb < nkb; ++kb) {
    const int s = kb % S;
    const int k0 = kb * kBlockK;
    const uint32_t k_hi = ring + s * C::kStageBytes;
    const uint32_t k_lo = k_hi + C::kKTileBytes;
    const uint32_t vt_hi = k_hi + 2 * C::kKTileBytes;
    const uint32_t vt_lo = vt_hi + C::kVTileBytes;
    mbar_wait(bars + 8 * s, (kb / S) & 1);

    // S = Q_lo K_hi + Q_hi K_lo + Q_hi K_hi over the tile's k-steps: a head
    // dim between two tiles multiplies its zero columns too (at most 28 of
    // them, 3 k-steps of 8).  Issuing only the k-steps with real columns
    // took one straight run of wgmma per count (a branch inside a run is
    // slow, a guarded first step serialised, C7515): four runs, 186 HGMMA
    // at D=128 against 60, and the full tiles ran 3% slower on an H100 SXM.
    float sc[16];
    qk_product<C>(sc, q_hi, q_lo, k_hi, k_lo);

    // The mask (on blocks that straddle the diagonal or the Sk tail) and
    // the online softmax: S becomes P; m, l and O are rescaled.
    online_softmax_block<kBlockK>(sc, acc, m, l, k0, q0, r0, t, Sk, causal,
                                  kv_offset, scale_log2);

    // O += P_lo Vt_hi + P_hi Vt_lo + P_hi Vt_hi: 4 k-steps of 8 keys, P from
    // the S accumulator in the order that matches Vt's key permutation.
    uint32_t ph[kBlockK / 8][4];
    uint32_t pl[kBlockK / 8][4];
#pragma unroll
    for (int kk = 0; kk < kBlockK / 8; ++kk) {
      const float p[4] = {sc[4 * kk + 0], sc[4 * kk + 2], sc[4 * kk + 1],
                          sc[4 * kk + 3]};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float hi = tf32_hi(p[i]);
        ph[kk][i] = __float_as_uint(hi);
        pl[kk][i] = __float_as_uint(tf32_round(p[i] - hi));
      }
    }
    pin(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBlockK / 8; ++kk)
      wgmma_rs<D>(acc, pl[kk], smem_desc(vt_hi + kk * 32, 16, 1024));
#pragma unroll
    for (int kk = 0; kk < kBlockK / 8; ++kk)
      wgmma_rs<D>(acc, ph[kk], smem_desc(vt_lo + kk * 32, 16, 1024));
#pragma unroll
    for (int kk = 0; kk < kBlockK / 8; ++kk)
      wgmma_rs<D>(acc, ph[kk], smem_desc(vt_hi + kk * 32, 16, 1024));
    wgmma_commit();
    wgmma_wait_all();
    pin(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8 * (S + s));  // release the stage
  }

  // Epilogue: O / l from registers at O's d columns, lse = m + log l.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const float lsafe = fmaxf(l[i], 1e-30f);
    const float inv = 1.f / lsafe;
    const int row = r0 + 8 * i;
    if (row < Sq) {
      float* const orow = o + b * o_sb + row * o_ss + h * o_sh + 2 * t;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        if (8 * n + 2 * t < d)  // d is a multiple of 4: the pair is whole
          *reinterpret_cast<float2*>(orow + 8 * n) =
              make_float2(acc[4 * n + 2 * i] * inv, acc[4 * n + 2 * i + 1] * inv);
      }
      if (t == 0)
        lse[(static_cast<int64_t>(b) * Sq + row) * H + h] =
            l[i] > 0.f ? fmaxf(m[i], kHalfNegInf) * (scale_log2 * kLn2) + logf(lsafe)
                       : kNegInf;
    }
  }
}

// ---------------------------------------------------------------------------
// The wide route: D > 128, at the real head dim (TMA zero-fills the columns
// of a box past D; the wrapper pads only a D that is not a multiple of 4).
// The design follows the bf16 wide route (flash_attn_fwd.cu): one tile of
// 64 query rows per CTA, a producer warpgroup and two consumer warpgroups
// that split the head dim.  Consumer c owns W columns of O (W = 128 up to
// D = 256, 192 up to 384, else 256; above D = 512 the grid's third dimension
// holds groups of 512 columns, each recomputing S) and half of the
// contraction's 32-column chunks; the two partial S tiles (64 x 32 f32)
// are summed through shared memory in the same order in both, so both run
// the same online softmax and Q K^T is computed once per query tile.
//
// Shared memory, in rings of each consumer's own, each ring filled by a
// producer thread of its own (so no ring waits behind another): Q/K stages
// of one chunk as TMA loaded them (Q 64 rows and K 32 keys), 12 KB each;
// Vt stages of one unit of 64 columns of O by 32 keys, 4 x 8 KB; and three
// lo buffers, into which the consumer splits the lo parts of the tiles it
// is about to use (three, so that the barrier of one step shows that every
// warp's wgmma of the step three back is done); 2 x 8 KB to exchange S:
// 224 KB.  At W = 128 Q's hi and lo parts are split in registers, as the A
// operand of Q K^T, from the raw tile: 4 Q/K stages and lo buffers of 8 KB
// (K_lo or Vt_lo).  At W = 192 and 256, where O takes more of a consumer's
// registers, Q_lo is split into shared memory beside K_lo: 3 Q/K stages
// and lo buffers of 12 KB.  No Q pre-pass, no lo plane of Q or K in device
// memory.  Q is not resident: its 64 rows are 64 KB at D=256 and 128 KB at
// D=512, more than fits beside the K and Vt rings, so Q is read again (4
// bytes an element) for every block of 32 keys.  The Vt ring streams O's
// columns a unit at a time (the "narrow column slice"), so its stages stay
// small enough to be four deep at any W; the P V of unit u overlaps the
// split of unit u+1.
//
// V's transpose stays a pre-pass (transpose_v_kernel): a .tf32 wgmma takes
// its B operand only K-major, and in P V the keys are K, so Vt holds V
// keys-contiguous, the keys of each group of 8 permuted as pi (see
// split_kv_kernel), as raw f32; the kernel splits its lo part as it does
// Q's and K's.  Split-KV and the combine as on the bf16 route.
//
// Bound at the head-dim-256 f32 train step's shape (B=2, S=2048, H=4,
// D=256, causal): 17.2 GFLOP, 3xTF32 51.6, 0.104 ms at 495 TFLOP/s, against
// 33.6 MB of q/k/v/O (0.010 ms) and the pre-pass's 33.6 MB: the tensor cores
// bound it.  Per block of 32 keys a CTA reads Q (64 KB at D=256), K and Vt
// (32 KB each) from L2 for 6.3 MFLOP of TF32 products, and its wgmma read
// them again from shared memory, with the lo parts split there.
// ---------------------------------------------------------------------------
constexpr int kWideRows = 64;        // query rows per CTA: both consumers
constexpr int kWideBlockK = 32;      // keys per key block
constexpr int kWideThreads = 384;    // producer + two consumer warpgroups
constexpr int kWideVStages = 4;      // per consumer
constexpr int kWideLoBufs = 3;       // per consumer
constexpr int kVUnitCols = 64;       // columns of O per Vt stage
constexpr int kWideCtaCols = 512;    // most O columns of one CTA: 2 x 256
constexpr int kWideEmptyArrivals = 4;  // one per warp of the stage's consumer
constexpr int kProducerRegs = 24;    // setmaxnreg: 128 * 24 + 256 * 240
constexpr int kConsumerRegs = 240;   //   = 64,512 <= 65,536 registers

template <int W>
struct WideCfg {
  // Q's hi and lo parts in the A registers (W = 128), or, where O takes
  // more of a consumer's registers, Q_lo split into shared memory with K_lo
  // (in the registers, ptxas serialises the wgmma for want of registers at
  // W = 192)
  static constexpr bool kQInRegs = W == 128;
  static constexpr int kQKStages = kQInRegs ? 4 : 3;          // per consumer
  static constexpr int kUnits = W / kVUnitCols;             // Vt stages a block
  static constexpr int kQBoxBytes = kWideRows * 128;        // 64 rows x 32 cols
  static constexpr int kKBoxBytes = kWideBlockK * 128;      // 32 keys x 32 cols
  static constexpr int kVBoxBytes = kVUnitCols * 128;       // 64 cols x 32 keys
  static constexpr int kQKStageBytes = kQBoxBytes + kKBoxBytes;  // Q, K: 12 KB
  // K_lo or Vt_lo; or Q_lo and K_lo
  static constexpr int kLoBytes = kQInRegs ? kVBoxBytes : kQKStageBytes;
  // a consumer's region: its Q/K ring, its Vt ring, its lo buffers
  static constexpr int kVOffset = kQKStages * kQKStageBytes;
  static constexpr int kLoOffset = kVOffset + kWideVStages * kVBoxBytes;
  static constexpr int kConsumerBytes = kLoOffset + kWideLoBufs * kLoBytes;
  static constexpr int kXOffset = 2 * kConsumerBytes;
  static constexpr int kXBytes = kWideRows * kWideBlockK * 4;     // one partial S
  static constexpr int kBarOffset = kXOffset + 2 * kXBytes;
  // per consumer: qk_full[QS], qk_empty[QS], v_full[VS], v_empty[VS]
  static constexpr int kBarsPerConsumer = 2 * (kQKStages + kWideVStages);
  // tiles, 1024 bytes to align the base for the swizzle, the mbarriers
  static constexpr int kSmemBytes = kBarOffset + 1024 + 8 * 2 * kBarsPerConsumer;
  static_assert(kSmemBytes <= 232448, "a CTA has 227 KB of shared memory");
};

__device__ __forceinline__ float4 tf32_lo4(float4 x) {
  return make_float4(tf32_lo(x.x), tf32_lo(x.y), tf32_lo(x.z), tf32_lo(x.w));
}

// dst[i] = lo part of src[i] for `n` float4s, by one consumer's 128
// threads (elementwise, so the swizzled layout TMA wrote is kept).
__device__ __forceinline__ void split_lo(const uint8_t* src, uint8_t* dst, int n,
                                         int tid) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
  float4* d4 = reinterpret_cast<float4*>(dst);
  for (int i = tid; i < n; i += 128) d4[i] = tf32_lo4(s4[i]);
}

// Make a consumer's generic-proxy writes (the lo parts) visible to wgmma
// (the async proxy), then meet its other threads at its named barrier.
__device__ __forceinline__ void lo_ready(int c) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" ::"r"(3 + c) : "memory");
}

// Vt [B,H,D,Skp] for the wide route: V transposed to keys-contiguous, the
// keys of each group of 8 permuted as pi (split_kv_kernel's order), raw f32,
// zeros past Sk.  Grid (ceil(Skp / 32), ceil(D / 32), B*H), 32 x 8 threads.
__global__ void __launch_bounds__(256)
transpose_v_kernel(const float* __restrict__ v, float* __restrict__ vt, int H,
                   int Sk, int Skp, int D, int64_t v_sb, int64_t v_ss,
                   int64_t v_sh) {
  __shared__ float tile[32][33];
  const int bh = blockIdx.z;
  const int b = bh / H;
  const int h = bh % H;
  const int j0 = blockIdx.x * 32;
  const int d0 = blockIdx.y * 32;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const float* vh = v + b * v_sb + h * v_sh + d0 + tx;
#pragma unroll
  for (int r = ty; r < 32; r += 8) {
    const int j = j0 + r;
    tile[r][tx] = (j < Sk && d0 + tx < D) ? vh[j * v_ss] : 0.f;
  }
  __syncthreads();
  // position tx of its group of 8 holds key pi(tx & 7) of the group
  const int src = (tx & ~7) | ((tx & 3) << 1) | ((tx >> 2) & 1);
  if (j0 + tx < Skp) {
#pragma unroll
    for (int r = ty; r < 32; r += 8) {
      if (d0 + r < D)
        vt[(static_cast<int64_t>(bh) * D + d0 + r) * Skp + j0 + tx] = tile[src][r];
    }
  }
}

template <int W>
__global__ void __launch_bounds__(kWideThreads, 1)
flash_fwd_tf32_wide_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_vt,
                           float* __restrict__ o, float* __restrict__ lse,
                           float* __restrict__ o_part, float* __restrict__ lse_part,
                           int B, int H, int Sq, int Sk, int D, int splits,
                           int64_t o_sb, int64_t o_ss, int64_t o_sh, int causal,
                           int kv_offset, float scale_log2) {
  using C = WideCfg<W>;
  constexpr int QS = C::kQKStages;
  constexpr int VS = kWideVStages;
  constexpr int BK = kWideBlockK;
  constexpr int U = C::kUnits;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms 1024-aligned
  uint8_t* const sbase = smem_raw + (base - raw);
  float* const xch = reinterpret_cast<float*>(sbase + C::kXOffset);

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kWideRows;  // longest first
  const int split = blockIdx.z % splits;
  const int col0 = (blockIdx.z / splits) * 2 * W;  // this CTA's first column
  // This tile's key ranges; a CTA of a range the tile does not have exits.
  const TileRanges ranges = tile_ranges(q0, kWideRows, Sq, Sk, causal, kv_offset,
                                        kWideBlockK, splits);
  if (split >= ranges.count) return;
  const bool part = ranges.count > 1;  // O to o_part, merged by the combine
  const int nch = (D + kBoxCols - 1) / kBoxCols;   // chunks of the contraction
  const int hc = (nch + 1) / 2;                    // consumer 0's chunks
  // This range's key blocks, within those any row of the tile may see.
  const int kb0 = split * ranges.per;
  const int nkb = max(0, min(kb0 + ranges.per, ranges.blocks) - kb0);

  if (threadIdx.x == 0) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const uint32_t bars = base + C::kBarOffset + c * 8 * C::kBarsPerConsumer;
#pragma unroll
      for (int s = 0; s < QS; ++s) {
        mbar_init(bars + 8 * s, 1);
        mbar_init(bars + 8 * (QS + s), kWideEmptyArrivals);
      }
#pragma unroll
      for (int s = 0; s < VS; ++s) {
        mbar_init(bars + 8 * (2 * QS + s), 1);
        mbar_init(bars + 8 * (2 * QS + VS + s), kWideEmptyArrivals);
      }
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup, broadcast from lane 0 so that ptxas knows it is uniform:
  // the consumers' branches around wgmma (their chunks and units) derive
  // from it, and a branch it cannot prove uniform serialises wgmma
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (wg == 0) {
    // ---------------- producers: lane 0 of warp 2c + r fills consumer c's
    // Q/K ring (r = 0) or Vt ring (r = 1), each in its own order ----------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs) : "memory");
    const int warp = threadIdx.x / 32;
    if (threadIdx.x % 32 == 0 && nkb > 0) {
      const int c = warp / 2;
      const uint32_t bars = base + C::kBarOffset + c * 8 * C::kBarsPerConsumer;
      const uint32_t region = base + c * C::kConsumerBytes;
      if (warp % 2 == 0) {
        prefetch_map(&tm_q);
        prefetch_map(&tm_k);
        const int chunks = c == 0 ? min(hc, nch) : max(0, nch - hc);
        int it = 0;
        for (int j = 0; j < nkb; ++j) {
          const int k0 = (kb0 + j) * BK;
          for (int i = 0; i < chunks; ++i, ++it) {
            const int s = it % QS;
            const uint32_t full = bars + 8 * s;
            mbar_wait(bars + 8 * (QS + s), ((it / QS) & 1) ^ 1);  // released
            mbar_expect_tx(full, C::kQKStageBytes);
            const uint32_t st = region + s * C::kQKStageBytes;
            const int col = (c * hc + i) * kBoxCols;
            tma_load(st, &tm_q, full, col, q0, h, b);
            tma_load(st + C::kQBoxBytes, &tm_k, full, col, k0, h, b);
          }
        }
      } else {
        prefetch_map(&tm_vt);
        const int units =
            min(U, max(0, (D - col0 - c * W + kVUnitCols - 1) / kVUnitCols));
        int it = 0;
        for (int j = 0; j < nkb; ++j) {
          const int k0 = (kb0 + j) * BK;
          for (int u = 0; u < units; ++u, ++it) {
            const int s = it % VS;
            const uint32_t full = bars + 8 * (2 * QS + s);
            mbar_wait(bars + 8 * (2 * QS + VS + s), ((it / VS) & 1) ^ 1);
            mbar_expect_tx(full, C::kVBoxBytes);
            tma_load(region + C::kVOffset + s * C::kVBoxBytes, &tm_vt, full, k0,
                     col0 + c * W + u * kVUnitCols, h, b);
          }
        }
      }
    }
    return;
  }

  // ---------------- consumers: the tile's 64 rows, W columns each --------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs) : "memory");
  const int c = wg - 1;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int r0 = q0 + 16 * warp + g;  // this thread's rows: r0, r0 + 8
  const int my_col0 = col0 + c * W;   // this consumer's first column of O
  const int my_chunks = c == 0 ? min(hc, nch) : max(0, nch - hc);
  const int my_units = min(U, max(0, (D - my_col0 + kVUnitCols - 1) / kVUnitCols));
  const uint32_t region = base + c * C::kConsumerBytes;
  uint8_t* const sregion = sbase + c * C::kConsumerBytes;
  const uint32_t bars = base + C::kBarOffset + c * 8 * C::kBarsPerConsumer;
  float4* const x_own = reinterpret_cast<float4*>(xch) + c * (C::kXBytes / 16);
  const float4* const x_other =
      reinterpret_cast<const float4*>(xch) + (1 - c) * (C::kXBytes / 16);

  float acc[W / 2];
#pragma unroll
  for (int i = 0; i < W / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};  // running max of the raw logits
  float l[2] = {0.f, 0.f};          // this thread's share of the row sums

  int qi = 0;  // Q/K stages consumed
  int vi = 0;  // Vt stages consumed
  int li = 0;  // lo buffers filled: step li writes buffer li % 3
  for (int j = 0; j < nkb; ++j) {
    const int k0 = (kb0 + j) * BK;

    // Partial S = Q_lo K + Q_hi K_lo + Q_hi K over this consumer's chunks,
    // 3 x 4 k-steps of 8 a chunk.  K is read raw as its hi part (the tensor
    // cores read only a .tf32 operand's upper 19 bits) and its lo part is
    // split into a lo buffer.  At W = 128, Q's hi and lo parts go from the
    // raw tile into the A registers (no Q_lo in shared memory, no Q operand
    // read from it by the tensor cores), loaded once the chunk before is
    // done; at W = 192 and 256 Q_lo is split beside K_lo and Q read raw as
    // its hi part.  The split of chunk i and its barrier overlap chunk i-1's
    // wgmma.
    float sc[BK / 2];
    pin(sc);
    for (int i = 0; i < my_chunks; ++i, ++qi, ++li) {
      const int s = qi % QS;
      mbar_wait(bars + 8 * s, (qi / QS) & 1);
      const int lb = li % kWideLoBufs;
      if constexpr (!C::kQInRegs) {
        split_lo(sregion + s * C::kQKStageBytes, sregion + C::kLoOffset + lb * C::kLoBytes,
                 C::kQKStageBytes / 16, tid);  // Q_lo then K_lo, as the stage holds them
        lo_ready(c);
        const uint32_t q_hi = region + s * C::kQKStageBytes;
        const uint32_t k_hi = q_hi + C::kQBoxBytes;
        const uint32_t q_lo = region + C::kLoOffset + lb * C::kLoBytes;
        const uint32_t k_lo = q_lo + C::kQBoxBytes;
        wgmma_fence();
#pragma unroll
        for (int term = 0; term < 3; ++term) {
          const uint32_t qa = term == 0 ? q_lo : q_hi;
          const uint32_t kb_ = term == 1 ? k_lo : k_hi;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss_n32(sc, smem_desc(qa + kk * 32, 16, 1024),
                         smem_desc(kb_ + kk * 32, 16, 1024), i > 0 || term > 0 || kk > 0);
        }
        wgmma_commit();
        if (i > 0) {  // the chunk before has completed: release its stage
          wgmma_wait<1>();
          __syncwarp();
          if (lane == 0) mbar_arrive(bars + 8 * (QS + (qi - 1) % QS));
        }
      } else {
        uint8_t* const st = sregion + s * C::kQKStageBytes;
        split_lo(st + C::kQBoxBytes, sregion + C::kLoOffset + lb * C::kLoBytes,
                 C::kKBoxBytes / 16, tid);
        lo_ready(c);
        if (i > 0) {  // the chunk before has completed: release its stage
          wgmma_wait<0>();
          __syncwarp();
          if (lane == 0) mbar_arrive(bars + 8 * (QS + (qi - 1) % QS));
        }
        // A fragment of k-step kk: rows 16 warp + g (+ 8), columns 8 kk + t
        // (+ 4), in the 128-byte-swizzled box
        uint32_t qh[4][4];
        uint32_t ql[4][4];
        const float* const qbox = reinterpret_cast<const float*>(st);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = 16 * warp + g + 8 * (e & 1);
            const int col = 8 * kk + t + 4 * (e >> 1);
            const float x = qbox[row * 32 + ((((col >> 2) ^ g) << 2) | (col & 3))];
            const float hi = tf32_hi(x);
            qh[kk][e] = __float_as_uint(hi);
            ql[kk][e] = __float_as_uint(tf32_round(x - hi));
          }
        }
        const uint32_t k_hi = region + s * C::kQKStageBytes + C::kQBoxBytes;
        const uint32_t k_lo = region + C::kLoOffset + lb * C::kLoBytes;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs<32>(sc, ql[kk], smem_desc(k_hi + kk * 32, 16, 1024), i > 0 || kk > 0);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs<32>(sc, qh[kk], smem_desc(k_lo + kk * 32, 16, 1024), 1);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs<32>(sc, qh[kk], smem_desc(k_hi + kk * 32, 16, 1024), 1);
        wgmma_commit();
      }
    }
    wgmma_wait<0>();
    pin(sc);
    if (my_chunks > 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bars + 8 * (QS + (qi - 1) % QS));
    } else {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
    }

    // The exchange: S = consumer 0's partial + consumer 1's, the same sum in
    // both.  Barrier 1: the other consumer has read this one's last partial;
    // barrier 2: both partials are written.
    if (j > 0) asm volatile("bar.sync 1, 256;\n" ::: "memory");
#pragma unroll
    for (int i = 0; i < BK / 8; ++i)
      x_own[i * 128 + tid] = make_float4(sc[4 * i], sc[4 * i + 1], sc[4 * i + 2],
                                         sc[4 * i + 3]);
    asm volatile("bar.sync 2, 256;\n" ::: "memory");
#pragma unroll
    for (int i = 0; i < BK / 8; ++i) {
      const float4 y = x_other[i * 128 + tid];
      sc[4 * i] += y.x;
      sc[4 * i + 1] += y.y;
      sc[4 * i + 2] += y.z;
      sc[4 * i + 3] += y.w;
    }

    // The mask (on blocks that straddle the diagonal or the Sk tail) and
    // the online softmax: S becomes P; m, l and O are rescaled.
    online_softmax_block<BK>(sc, acc, m, l, k0, q0, r0, t, Sk, causal, kv_offset,
                             scale_log2);

    // O[:, unit u] += P_lo Vt + P_hi Vt_lo + P_hi Vt, a unit of 64 columns
    // at a time: 4 k-steps of 8 keys, P from the S accumulator in the order
    // that matches Vt's key permutation.
    uint32_t ph[BK / 8][4];
    uint32_t pl[BK / 8][4];
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      const float p[4] = {sc[4 * kk + 0], sc[4 * kk + 2], sc[4 * kk + 1],
                          sc[4 * kk + 3]};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float hi = tf32_hi(p[i]);
        ph[kk][i] = __float_as_uint(hi);
        pl[kk][i] = __float_as_uint(tf32_round(p[i] - hi));
      }
    }
    pin(acc);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (u < my_units) {
        const int s = vi % VS;
        mbar_wait(bars + 8 * (2 * QS + s), (vi / VS) & 1);
        const int lb = li % kWideLoBufs;
        split_lo(sregion + C::kVOffset + s * C::kVBoxBytes,
                 sregion + C::kLoOffset + lb * C::kLoBytes, C::kVBoxBytes / 16, tid);
        lo_ready(c);
        const uint32_t vt_hi = region + C::kVOffset + s * C::kVBoxBytes;
        const uint32_t vt_lo = region + C::kLoOffset + lb * C::kLoBytes;
        float(&a)[32] = *reinterpret_cast<float(*)[32]>(acc + 32 * u);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 8; ++kk)
          wgmma_rs<64>(a, pl[kk], smem_desc(vt_hi + kk * 32, 16, 1024));
#pragma unroll
        for (int kk = 0; kk < BK / 8; ++kk)
          wgmma_rs<64>(a, ph[kk], smem_desc(vt_lo + kk * 32, 16, 1024));
#pragma unroll
        for (int kk = 0; kk < BK / 8; ++kk)
          wgmma_rs<64>(a, ph[kk], smem_desc(vt_hi + kk * 32, 16, 1024));
        wgmma_commit();
        if (u > 0) {  // the unit before has completed: release its stage
          wgmma_wait<1>();
          __syncwarp();
          if (lane == 0) mbar_arrive(bars + 8 * (2 * QS + VS + (vi - 1) % VS));
        }
        ++vi;
        ++li;
      }
    }
    wgmma_wait<0>();
    pin(acc);
    if (my_units > 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bars + 8 * (2 * QS + VS + (vi - 1) % VS));
    }
  }

  // Epilogue from registers: O / l at this consumer's columns below D (to O,
  // or to this split's slot of o_part); consumer 0 of the first column group
  // writes lse.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const float lsafe = fmaxf(l[i], 1e-30f);
    const float inv = 1.f / lsafe;
    const float row_lse =
        l[i] > 0.f ? fmaxf(m[i], kHalfNegInf) * (scale_log2 * kLn2) + logf(lsafe)
                   : kNegInf;
    const int row = r0 + 8 * i;
    if (row < Sq) {
      const int64_t r = ((static_cast<int64_t>(split) * B + b) * Sq + row) * H + h;
      float* const orow = part ? o_part + r * D : o + b * o_sb + row * o_ss + h * o_sh;
#pragma unroll
      for (int n = 0; n < W / 8; ++n) {
        const int col = my_col0 + 8 * n + 2 * t;
        if (col < D)
          *reinterpret_cast<float2*>(orow + col) =
              make_float2(acc[4 * n + 2 * i] * inv, acc[4 * n + 2 * i + 1] * inv);
      }
      if (c == 0 && t == 0 && col0 == 0) {
        if (part) {
          lse_part[r] = row_lse;
        } else {
          lse[(static_cast<int64_t>(b) * Sq + row) * H + h] = row_lse;
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Host side: scratch layout, tensor maps and the launches.
// ---------------------------------------------------------------------------

int64_t padded_keys(int Sk) { return Sk > 8 ? (Sk + 7) / 8 * 8 : 8; }

// Scratch, all f32: the D <= 128 kernel's K_lo [B,H,Sk,D], Vt_hi and Vt_lo
// [B,H,D,Skp]; the wide route's Vt [B,H,D,Skp], then, over more than one key
// range, the ranges' O [splits,B,Sq,H,D] and lse [splits,B,Sq,H].
int64_t scratch_floats(int B, int Sq, int Sk, int H, int D, bool wide, int splits) {
  const int64_t vt_n = static_cast<int64_t>(B) * H * D * padded_keys(Sk);
  if (!wide) return static_cast<int64_t>(B) * H * Sk * D + 2 * vt_n;
  const int64_t part_n =
      splits > 1 ? static_cast<int64_t>(splits) * B * Sq * H * (D + 1) : 0;
  return vt_n + part_n;
}

// The pre-pass, then the tile of D columns at head dim d (d <= D, a
// multiple of 4).
template <int D>
cudaError_t launch(const float* q, const float* k, const float* v, float* o,
                   float* lse, float* scratch, int B, int Sq, int Sk, int H, int d,
                   const int64_t* st, int causal, int kv_offset, float sm_scale,
                   cudaStream_t stream) {
  const int64_t skp = padded_keys(Sk);
  const int64_t klo_n = static_cast<int64_t>(B) * H * Sk * d;
  const int64_t vt_n = static_cast<int64_t>(B) * H * d * skp;
  float* const klo = scratch;
  float* const vt_hi = scratch + klo_n;
  float* const vt_lo = vt_hi + vt_n;

  const dim3 pgrid(static_cast<unsigned>((skp + 31) / 32),
                   static_cast<unsigned>((d + 31) / 32), B * H);
  split_kv_kernel<<<pgrid, dim3(32, 8), 0, stream>>>(
      k, v, klo, vt_hi, vt_lo, H, Sk, static_cast<int>(skp), d, st[3], st[4],
      st[5], st[6], st[7], st[8]);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // d columns (Vt: d rows) of a tile of D: TMA zero-fills the rest
  CUtensorMap mq, mk, mklo, mvh, mvl;
  if (!encode_f32(&mq, q, d, Sq, H, B, st[1], st[2], st[0], kBlockQ) ||
      !encode_f32(&mk, k, d, Sk, H, B, st[4], st[5], st[3], kBlockK) ||
      !encode_f32(&mklo, klo, d, Sk, H, B, d, static_cast<int64_t>(Sk) * d,
                  static_cast<int64_t>(H) * Sk * d, kBlockK) ||
      !encode_f32(&mvh, vt_hi, skp, d, H, B, skp, d * skp, H * d * skp, D) ||
      !encode_f32(&mvl, vt_lo, skp, d, H, B, skp, d * skp, H * d * skp, D))
    return cudaErrorInvalidValue;
  auto* kernel = flash_fwd_tf32_kernel<D>;
  constexpr int smem = Cfg<D>::kSmemBytes;
  err = configure_once(reinterpret_cast<const void*>(kernel), smem, 0, kThreads);
  if (err != cudaSuccess) return err;
  const int tiles = (Sq + kBlockQ - 1) / kBlockQ;
  if (tiles > 65535) return cudaErrorInvalidValue;
  const dim3 grid(B * H, tiles);
  kernel<<<grid, kThreads, smem, stream>>>(mq, mk, mklo, mvh, mvl, o, lse, H, Sq,
                                           Sk, d, st[9], st[10], st[11], causal,
                                           kv_offset, sm_scale * kLog2e);
  return cudaGetLastError();
}

// The narrowest tile that holds head dim d (a multiple of 4, at most 128).
cudaError_t launch_tile(const float* q, const float* k, const float* v, float* o,
                        float* lse, float* scratch, int B, int Sq, int Sk, int H, int d,
                        const int64_t* st, int causal, int kv_offset, float sm_scale,
                        cudaStream_t s) {
  if (d <= 0 || d % 4 != 0 || d > 128) return cudaErrorInvalidValue;
  if (d <= 32)
    return launch<32>(q, k, v, o, lse, scratch, B, Sq, Sk, H, d, st, causal, kv_offset,
                      sm_scale, s);
  if (d <= 64)
    return launch<64>(q, k, v, o, lse, scratch, B, Sq, Sk, H, d, st, causal, kv_offset,
                      sm_scale, s);
  if (d <= 96)
    return launch<96>(q, k, v, o, lse, scratch, B, Sq, Sk, H, d, st, causal, kv_offset,
                      sm_scale, s);
  return launch<128>(q, k, v, o, lse, scratch, B, Sq, Sk, H, d, st, causal, kv_offset,
                     sm_scale, s);
}

// The wide kernel with W columns of O per consumer, then, over `splits` key
// ranges, the combine.
template <int W>
cudaError_t launch_wide_w(const CUtensorMap& mq, const CUtensorMap& mk,
                          const CUtensorMap& mvt, float* o, float* lse,
                          float* o_part, float* lse_part, int B, int Sq, int Sk,
                          int H, int D, int splits, const int64_t* st, int causal,
                          int kv_offset, float sm_scale, cudaStream_t stream) {
  auto* kernel = flash_fwd_tf32_wide_kernel<W>;
  constexpr int smem = WideCfg<W>::kSmemBytes;
  cudaError_t err = configure_once(reinterpret_cast<const void*>(kernel), smem,
                                   kProducerRegs * 128 + kConsumerRegs * 256,
                                   kWideThreads);
  if (err != cudaSuccess) return err;
  const int tiles = (Sq + kWideRows - 1) / kWideRows;
  const int groups = (D + 2 * W - 1) / (2 * W);
  if (tiles > 65535 || groups * splits > 65535) return cudaErrorInvalidValue;
  kernel<<<dim3(B * H, tiles, groups * splits), kWideThreads, smem, stream>>>(
      mq, mk, mvt, o, lse, o_part, lse_part, B, H, Sq, Sk, D, splits, st[9],
      st[10], st[11], causal, kv_offset, sm_scale * kLog2e);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  return launch_combine<kOutF32>(o_part, lse_part, o, lse, B, Sq, Sk, H, D, splits,
                                causal, kv_offset, kWideRows, kWideBlockK, st, stream);
}

// V's transpose, then the wide kernel (and the combine) at D, a multiple
// of 4.
cudaError_t launch_wide(const float* q, const float* k, const float* v, float* o,
                        float* lse, float* scratch, int B, int Sq, int Sk, int H,
                        int D, const int64_t* st, int causal, int kv_offset,
                        float sm_scale, int splits, cudaStream_t stream) {
  if (D <= 0 || D % 4 != 0 || splits < 1 || splits > kMaxSplits)
    return cudaErrorInvalidValue;
  const int64_t skp = padded_keys(Sk);
  float* const vt = scratch;
  float* const o_part = vt + static_cast<int64_t>(B) * H * D * skp;
  float* const lse_part = o_part + static_cast<int64_t>(splits) * B * Sq * H * D;

  const dim3 pgrid(static_cast<unsigned>((skp + 31) / 32),
                   static_cast<unsigned>((D + 31) / 32), B * H);
  transpose_v_kernel<<<pgrid, dim3(32, 8), 0, stream>>>(
      v, vt, H, Sk, static_cast<int>(skp), D, st[6], st[7], st[8]);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  CUtensorMap mq, mk, mvt;
  if (!encode_f32(&mq, q, D, Sq, H, B, st[1], st[2], st[0], kWideRows) ||
      !encode_f32(&mk, k, D, Sk, H, B, st[4], st[5], st[3], kWideBlockK) ||
      !encode_f32(&mvt, vt, skp, D, H, B, skp, D * skp, H * D * skp, kVUnitCols))
    return cudaErrorInvalidValue;
  if (D <= 256)
    return launch_wide_w<128>(mq, mk, mvt, o, lse, o_part, lse_part, B, Sq, Sk, H,
                              D, splits, st, causal, kv_offset, sm_scale, stream);
  if (D <= 384)
    return launch_wide_w<192>(mq, mk, mvt, o, lse, o_part, lse_part, B, Sq, Sk, H,
                              D, splits, st, causal, kv_offset, sm_scale, stream);
  return launch_wide_w<256>(mq, mk, mvt, o, lse, o_part, lse_part, B, Sq, Sk, H, D,
                            splits, st, causal, kv_offset, sm_scale, stream);
}

}  // namespace

// C entry point, loaded with ctypes.  q, k, v, o are f32; `wide` = 0: head
// dim D a multiple of 4 up to 128, on the narrowest tile that holds it;
// `wide` = 1: the wide route at D, a multiple of 4 (the wrapper takes it
// above 128), over `splits` key ranges (1 to 16).  `strides` holds 12 element
// strides, (batch, seq, head) for q, k, v and o in that order, the head_dim
// stride 1, every other stride a multiple of 4 and every base 16-byte
// aligned.  `scratch` holds tos_flash_attn_fwd_tf32_scratch_bytes(...)
// bytes, 16-byte aligned.  Runs the pre-pass, the main kernel and (over
// more than one key range) the combine on `stream`; returns
// cudaGetLastError() after the launches (0 on success), or
// cudaErrorInvalidValue for an input it does not take or a tensor map
// cuTensorMapEncodeTiled refuses.  Does not synchronise, allocates nothing.
extern "C" int tos_flash_attn_fwd_tf32(const void* q, const void* k,
                                       const void* v, void* o, void* lse,
                                       void* scratch, int B, int Sq, int Sk,
                                       int H, int D, const int64_t* strides,
                                       int causal, int kv_offset,
                                       float sm_scale, int wide, int splits,
                                       void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0) return 0;  // nothing to launch
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fq = static_cast<const float*>(q);
  const float* fk = static_cast<const float*>(k);
  const float* fv = static_cast<const float*>(v);
  float* fo = static_cast<float*>(o);
  float* fl = static_cast<float*>(lse);
  float* sc = static_cast<float*>(scratch);
  cudaError_t err;
  if (wide) {
    err = launch_wide(fq, fk, fv, fo, fl, sc, B, Sq, Sk, H, D, strides, causal,
                      kv_offset, sm_scale, splits, s);
  } else {
    err = launch_tile(fq, fk, fv, fo, fl, sc, B, Sq, Sk, H, D, strides, causal,
                      kv_offset, sm_scale, s);
  }
  return static_cast<int>(err);
}

// Bytes of scratch the launch needs (scratch_floats).
extern "C" int64_t tos_flash_attn_fwd_tf32_scratch_bytes(int B, int Sq, int Sk,
                                                         int H, int D, int wide,
                                                         int splits) {
  return 4 * scratch_floats(B, Sq, Sk, H, D, wide != 0, splits);
}

// Dynamic shared memory of one CTA: `wide` = 0, the tile of D columns (32,
// 64, 96 or 128); `wide` = 1, the wide kernel's with D columns of O per
// consumer (128, 192 or 256); else 0.
extern "C" int tos_flash_attn_fwd_tf32_smem_bytes(int D, int wide) {
  if (wide)
    return D == 128 ? WideCfg<128>::kSmemBytes
           : D == 192 ? WideCfg<192>::kSmemBytes
           : D == 256 ? WideCfg<256>::kSmemBytes
                      : 0;
  return D == 32    ? Cfg<32>::kSmemBytes
         : D == 64  ? Cfg<64>::kSmemBytes
         : D == 96  ? Cfg<96>::kSmemBytes
         : D == 128 ? Cfg<128>::kSmemBytes
                    : 0;
}

// Most columns of O one CTA of the wide route covers; a wider head runs
// column groups of this many, each recomputing S.
extern "C" int tos_flash_attn_fwd_tf32_cta_cols() { return kWideCtaCols; }
