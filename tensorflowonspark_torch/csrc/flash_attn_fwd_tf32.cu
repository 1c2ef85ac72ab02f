// Flash-attention forward for f32 inputs on Hopper's tensor cores (sm_90a),
// each f32 product as three TF32 `wgmma`s (3xTF32): online softmax over key
// blocks, returning the output O and the row log-sum-exp.
//
// Replaces, for f32 inputs at every head dim, the TPU kernel
// tensorflowonspark_tpu/ops/attention.py:_flash_fwd_kernel (launched by
// _flash_fwd_pallas through pl.pallas_call), which computes in f32.  The
// wrapper (ops/attention.py) zero-pads D to 64 or 128, and a D over 128 to a
// multiple of 128 for the wide route (below), as the TPU kernel pads it.  The contract is the other
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
// half of that (96 KB).  Registers per consumer thread: O 64 (D/2), S 16,
// P hi/lo 32, plus the row state.
//
// D > 128 (flash_fwd_tf32_wide_kernel): O's columns in slices of 256 across
// a third grid dimension, key blocks of 64, Q K^T streamed in 32-column
// chunks with Q_lo from a second pre-pass (split_q_kernel); shared memory 3
// x 32 KB of Q/K stages + one Vt stage of 128 KB = 224 KB.  Bound at the head-dim-256 f32 train
// step's shape (B=2, S=2048, H=4, D=256, causal, one slice): the function is
// 17.2 GFLOP, 3xTF32 51.6, 0.104 ms at 495 TFLOP/s, against about 120 MB of
// q/k/v/O and scratch, 0.036 ms: the tensor cores bound it.  Q is read
// again for every key block (2 x 64 KB a block of 64 keys at D=256), so
// the traffic from L2 into shared memory is well above the operands'
// bytes.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (tensorflowonspark_torch/ops/cuda_build.py does it).

#include "hopper_pipeline.cuh"

namespace {

constexpr int kBlockQ = 64;        // query rows per CTA: one consumer warpgroup
constexpr int kBlockK = 32;        // keys per ring stage
constexpr int kStages = 2;
constexpr int kThreads = 160;      // consumer warps 0-3, producer warp 4
constexpr int kBoxCols = 32;       // 128-byte swizzle: 32 f32 values
constexpr int kEmptyArrivals = 4;  // one per consumer warp

template <int D>
struct Cfg {
  static constexpr int kBoxes = D / kBoxCols;             // 32-column boxes
  static constexpr int kQBoxBytes = kBlockQ * 128;
  static constexpr int kKBoxBytes = kBlockK * 128;
  static constexpr int kQTileBytes = kBoxes * kQBoxBytes;  // Q_hi or Q_lo
  static constexpr int kKTileBytes = kBoxes * kKBoxBytes;  // K_hi or K_lo
  static constexpr int kVTileBytes = D * 128;              // D rows x 32 keys
  static constexpr int kStageBytes = 2 * kKTileBytes + 2 * kVTileBytes;
  static constexpr int kBarOffset = 2 * kQTileBytes + kStages * kStageBytes;
  // tiles, 1024 bytes to align the base for the swizzle, the mbarriers
  static constexpr int kSmemBytes = kBarOffset + 1024 + 8 * (2 * kStages + 1);
};

// x with its low 13 mantissa bits cleared: what a .tf32 operand reads.
__device__ __forceinline__ float tf32_hi(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xffffe000u);
}
// x rounded to TF32, to nearest (ties away from zero), as an f32 bit pattern.
__device__ __forceinline__ float tf32_round(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}
__device__ __forceinline__ float tf32_lo(float x) {
  return tf32_round(x - tf32_hi(x));
}

// S (64 x 32, f32) (+)= A (64 x 8, smem K-major) * B^T (32 x 8, smem
// K-major), tf32; scale_d = 0 overwrites S.
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32"
               " {" TOS_R16 "}, %16, %17, p, 1, 1;\n}\n"
               : TOS_ACC16 : "l"(da), "l"(db), "r"(scale_d));
}

// O (64 x N, f32) += A (64 x 8, registers) * B (8 x N, smem K-major), tf32.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  static_assert(N == 64 || N == 128 || N == 256, "P V is m64n64, n128 or n256, k8");
  if constexpr (N == 256) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32"
                 " {" TOS_R128 "}, {%128, %129, %130, %131}, %132, p, 1, 1;\n}\n"
                 : TOS_ACC128
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else if constexpr (N == 128) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32"
                 " {" TOS_R64 "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
                 : TOS_ACC64
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32"
                 " {" TOS_R32 "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
                 : TOS_ACC32
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
}

// ---------------------------------------------------------------------------
// Pre-pass: K_lo, and V transposed (keys contiguous, permuted in groups of
// 8) as Vt_hi and Vt_lo.  Grid (ceil(Skp / 32), D / 32, B*H), 32 x 8 threads.
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
    if (j < Sk) {
      klo[(static_cast<int64_t>(bh) * Sk + j) * D + d0 + tx] = tf32_lo(kh[j * k_ss]);
      y = vh[j * v_ss];
    }
    tile[r][tx] = y;  // zero past Sk
  }
  __syncthreads();
  // position tx of its group of 8 holds key pi(tx & 7) of the group
  const int src = (tx & ~7) | ((tx & 3) << 1) | ((tx >> 2) & 1);
  if (j0 + tx < Skp) {
#pragma unroll
    for (int r = ty; r < 32; r += 8) {
      const float y = tile[src][r];
      const int64_t at = (static_cast<int64_t>(bh) * D + d0 + r) * Skp + j0 + tx;
      vt_hi[at] = tf32_hi(y);
      vt_lo[at] = tf32_lo(y);
    }
  }
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
                      int Sq, int Sk, int64_t o_sb, int64_t o_ss, int64_t o_sh,
                      int causal, int kv_offset, float scale_log2) {
  using C = Cfg<D>;
  constexpr int S = kStages;
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

    // S = Q_lo K_hi + Q_hi K_lo + Q_hi K_hi: D/8 k-steps of 8 each; after 4
    // steps the next 32-column box.
    float sc[16];
    pin(sc);
    wgmma_fence();
#pragma unroll
    for (int term = 0; term < 3; ++term) {
      const uint32_t qa = term == 0 ? q_lo : q_hi;
      const uint32_t kb_ = term == 1 ? k_lo : k_hi;
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        const uint32_t col = (kk % 4) * 32;
        wgmma_ss_n32(sc, smem_desc(qa + (kk / 4) * C::kQBoxBytes + col, 16, 1024),
                     smem_desc(kb_ + (kk / 4) * C::kKBoxBytes + col, 16, 1024),
                     term > 0 || kk > 0);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    pin(sc);

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

  // Epilogue: O / l from registers, lse = m + log l.
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
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<float2*>(orow + 8 * n) =
            make_float2(acc[4 * n + 2 * i] * inv, acc[4 * n + 2 * i + 1] * inv);
      if (t == 0)
        lse[(static_cast<int64_t>(b) * Sq + row) * H + h] =
            l[i] > 0.f ? fmaxf(m[i], kHalfNegInf) * (scale_log2 * kLn2) + logf(lsafe)
                       : kNegInf;
    }
  }
}

// ---------------------------------------------------------------------------
// The wide route: D > 128 (the wrapper pads it to a multiple of 128).  Q
// (2 x 64 KB at D=256) and a whole-D ring stage do not fit beside each
// other, nor O a consumer thread's registers above D=256, so the grid gains
// a dimension over slices of O's columns, W = kSliceCols = 256 wide (the
// last one 128 where D is an odd multiple of 128), and
// each CTA streams the contraction of S = Q K^T through its ring in chunks
// of 32 columns: a stage holds Q_hi (the caller's q, read raw), Q_lo (from
// the pre-pass), K_hi (the caller's k) and K_lo for one chunk and one key
// block of 64, 32 KB, in 3 stages.  Every slice computes the same S, m and l
// in the same order, then O += P V against its own slice of Vt only, from
// one stage of its own (Vt_hi, Vt_lo: W rows x 64 keys each, 128 KB at
// W=256), which the producer fills for key block j as soon as block j-1 has
// released it, ahead of block j's Q/K chunks.  Slice 0 alone writes lse.
// Q K^T is recomputed once per slice, so a head of 256 or less (one slice)
// does the unsliced work.  Q is read again for every key block; the key
// block of 64 (against the D<=128 kernel's 32) halves those reads.  A
// consumer thread holds O (W/2 = 128 registers at W=256) and S (32), and
// splits P into hi/lo 32 keys at a time (32 registers), so P V runs as two
// groups.  Within a key block the consumer keeps one chunk's wgmma group in
// flight while it releases the stage of the chunk before.
// ---------------------------------------------------------------------------
constexpr int kSliceCols = 256;
constexpr int kWideBlockK = 64;  // keys per key block
constexpr int kWideQKStages = 3;

template <int W>
struct WideCfg {
  static constexpr int kQBoxBytes = kBlockQ * 128;          // 64 rows x 32 cols: 8 KB
  static constexpr int kKBoxBytes = kWideBlockK * 128;      // 64 keys x 32 cols: 8 KB
  static constexpr int kQKStageBytes = 2 * kQBoxBytes + 2 * kKBoxBytes;  // 32 KB
  static constexpr int kVBoxBytes = W * 128;                // W rows x 32 keys
  static constexpr int kVTileBytes = 2 * kVBoxBytes;        // W rows x 64 keys
  static constexpr int kVStageBytes = 2 * kVTileBytes;      // Vt_hi, Vt_lo
  static constexpr int kVOffset = kWideQKStages * kQKStageBytes;
  static constexpr int kBarOffset = kVOffset + kVStageBytes;
  // tiles, 1024 bytes to align the base for the swizzle, the mbarriers
  static constexpr int kSmemBytes = kBarOffset + 1024 + 8 * 2 * (kWideQKStages + 1);
};

// S (64 x 64, f32) (+)= A (64 x 8, smem K-major) * B^T (64 x 8, smem
// K-major), tf32; scale_d = 0 overwrites S.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32"
               " {" TOS_R32 "}, %32, %33, p, 1, 1;\n}\n"
               : TOS_ACC32 : "l"(da), "l"(db), "r"(scale_d));
}

// Q_lo [B,H,Sq,D] for the wide route.  Grid (ceil(Sq / 8), D / 32, B*H),
// 32 x 8 threads.
__global__ void __launch_bounds__(256)
split_q_kernel(const float* __restrict__ q, float* __restrict__ qlo, int H,
               int Sq, int D, int64_t q_sb, int64_t q_ss, int64_t q_sh) {
  const int bh = blockIdx.z;
  const int b = bh / H;
  const int h = bh % H;
  const int i = blockIdx.x * 8 + threadIdx.y;
  const int d = blockIdx.y * 32 + threadIdx.x;
  if (i < Sq)
    qlo[(static_cast<int64_t>(bh) * Sq + i) * D + d] =
        tf32_lo(q[b * q_sb + i * q_ss + h * q_sh + d]);
}

template <int W>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_tf32_wide_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_qlo,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_klo,
                           const __grid_constant__ CUtensorMap tm_vt_hi,
                           const __grid_constant__ CUtensorMap tm_vt_lo,
                           float* __restrict__ o, float* __restrict__ lse,
                           int H, int Sq, int Sk, int nchunks, int col0,
                           int64_t o_sb, int64_t o_ss, int64_t o_sh, int causal,
                           int kv_offset, float scale_log2) {
  using C = WideCfg<W>;
  constexpr int QS = kWideQKStages;
  constexpr int BK = kWideBlockK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms 1024-aligned
  const uint32_t vt_hi = base + C::kVOffset;
  const uint32_t vt_lo = vt_hi + C::kVTileBytes;
  // qk_full[QS], qk_empty[QS], v_full, v_empty
  const uint32_t qk_full = base + C::kBarOffset;
  const uint32_t qk_empty = qk_full + 8 * QS;
  const uint32_t v_full = qk_empty + 8 * QS;
  const uint32_t v_empty = v_full + 8;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;  // longest first
  const int c0 = col0 + blockIdx.z * W;                   // this CTA's columns
  // Keys past the last one any row of this tile may see are never loaded.
  int kend = Sk;
  if (causal) {
    const int qlast = min(q0 + kBlockQ, Sq) - 1;
    kend = min(Sk, max(0, qlast - kv_offset + 1));
  }
  const int nkb = (kend + BK - 1) / BK;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < QS; ++s) {
      mbar_init(qk_full + 8 * s, 1);
      mbar_init(qk_empty + 8 * s, kEmptyArrivals);
    }
    mbar_init(v_full, 1);
    mbar_init(v_empty, kEmptyArrivals);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp == 4) {
    // ---------------- producer: one thread keeps both rings full ---------
    if (lane == 0 && nkb > 0) {
      prefetch_map(&tm_q);
      prefetch_map(&tm_qlo);
      prefetch_map(&tm_k);
      prefetch_map(&tm_klo);
      prefetch_map(&tm_vt_hi);
      prefetch_map(&tm_vt_lo);
      int it = 0;  // Q/K stages filled, over (key block, chunk)
      for (int kb = 0; kb < nkb; ++kb) {
        const int k0 = kb * BK;
        // Vt first: block kb-1 released it after its P V, before the
        // consumer starts block kb's Q K^T
        mbar_wait(v_empty, (kb & 1) ^ 1);
        mbar_expect_tx(v_full, C::kVStageBytes);
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          tma_load(vt_hi + x * C::kVBoxBytes, &tm_vt_hi, v_full, k0 + 32 * x, c0, h, b);
          tma_load(vt_lo + x * C::kVBoxBytes, &tm_vt_lo, v_full, k0 + 32 * x, c0, h, b);
        }
        for (int c = 0; c < nchunks; ++c, ++it) {
          const int s = it % QS;
          const uint32_t full = qk_full + 8 * s;
          mbar_wait(qk_empty + 8 * s, ((it / QS) & 1) ^ 1);  // stage released
          mbar_expect_tx(full, C::kQKStageBytes);
          const uint32_t st = base + s * C::kQKStageBytes;
          const int col = c * kBoxCols;
          tma_load(st, &tm_q, full, col, q0, h, b);
          tma_load(st + C::kQBoxBytes, &tm_qlo, full, col, q0, h, b);
          tma_load(st + 2 * C::kQBoxBytes, &tm_k, full, col, k0, h, b);
          tma_load(st + 2 * C::kQBoxBytes + C::kKBoxBytes, &tm_klo, full, col, k0, h, b);
        }
      }
    }
    return;
  }

  // ---------------- consumer warpgroup: the tile's 64 query rows --------
  const int g = lane / 4;
  const int t = lane % 4;
  const int r0 = q0 + 16 * warp + g;  // this thread's rows: r0, r0 + 8

  float acc[W / 2];
#pragma unroll
  for (int i = 0; i < W / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};  // running max of the raw logits
  float l[2] = {0.f, 0.f};          // this thread's share of the row sums

  int it = 0;  // Q/K stages consumed
  for (int kb = 0; kb < nkb; ++kb) {
    const int k0 = kb * BK;

    // S = Q_lo K_hi + Q_hi K_lo + Q_hi K_hi, chunk by chunk: per 32-column
    // chunk 3 x 4 k-steps of 8.
    float sc[BK / 2];
    for (int c = 0; c < nchunks; ++c, ++it) {
      const int s = it % QS;
      mbar_wait(qk_full + 8 * s, (it / QS) & 1);
      const uint32_t q_hi = base + s * C::kQKStageBytes;
      const uint32_t q_lo = q_hi + C::kQBoxBytes;
      const uint32_t k_hi = q_hi + 2 * C::kQBoxBytes;
      const uint32_t k_lo = k_hi + C::kKBoxBytes;
      wgmma_fence();
#pragma unroll
      for (int term = 0; term < 3; ++term) {
        const uint32_t qa = term == 0 ? q_lo : q_hi;
        const uint32_t kb_ = term == 1 ? k_lo : k_hi;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss_n64(sc, smem_desc(qa + kk * 32, 16, 1024),
                       smem_desc(kb_ + kk * 32, 16, 1024),
                       c > 0 || term > 0 || kk > 0);
      }
      wgmma_commit();
      if (c > 0) {  // the chunk before has completed: release its stage
        wgmma_wait<1>();
        __syncwarp();
        if (lane == 0) mbar_arrive(qk_empty + 8 * ((it - 1) % QS));
      }
    }
    wgmma_wait<0>();
    pin(sc);
    __syncwarp();
    if (lane == 0) mbar_arrive(qk_empty + 8 * ((it - 1) % QS));

    // The mask (on blocks that straddle the diagonal or the Sk tail) and
    // the online softmax: S becomes P; m, l and O are rescaled.
    online_softmax_block<BK>(sc, acc, m, l, k0, q0, r0, t, Sk, causal,
                             kv_offset, scale_log2);

    // O[:, slice] += P_lo Vt_hi + P_hi Vt_lo + P_hi Vt_hi on this slice, in
    // two groups of 32 keys (one 32-key box of Vt each), so that only one
    // group's P hi/lo is held at a time.
    mbar_wait(v_full, kb & 1);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      uint32_t ph[4][4];
      uint32_t pl[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int n = 4 * half + kk;
        const float p[4] = {sc[4 * n + 0], sc[4 * n + 2], sc[4 * n + 1],
                            sc[4 * n + 3]};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float hi = tf32_hi(p[i]);
          ph[kk][i] = __float_as_uint(hi);
          pl[kk][i] = __float_as_uint(tf32_round(p[i] - hi));
        }
      }
      const uint32_t vh = vt_hi + half * C::kVBoxBytes;
      const uint32_t vl = vt_lo + half * C::kVBoxBytes;
      pin(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<W>(acc, pl[kk], smem_desc(vh + kk * 32, 16, 1024));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<W>(acc, ph[kk], smem_desc(vl + kk * 32, 16, 1024));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<W>(acc, ph[kk], smem_desc(vh + kk * 32, 16, 1024));
      wgmma_commit();
      wgmma_wait_all();
      pin(acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(v_empty);  // release the Vt stage
  }

  // Epilogue: this slice of O / l from registers; slice 0 writes lse.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const float lsafe = fmaxf(l[i], 1e-30f);
    const float inv = 1.f / lsafe;
    const int row = r0 + 8 * i;
    if (row < Sq) {
      float* const orow = o + b * o_sb + row * o_ss + h * o_sh + c0 + 2 * t;
#pragma unroll
      for (int n = 0; n < W / 8; ++n)
        *reinterpret_cast<float2*>(orow + 8 * n) =
            make_float2(acc[4 * n + 2 * i] * inv, acc[4 * n + 2 * i + 1] * inv);
      if (t == 0 && c0 == 0)
        lse[(static_cast<int64_t>(b) * Sq + row) * H + h] =
            l[i] > 0.f ? fmaxf(m[i], kHalfNegInf) * (scale_log2 * kLn2) + logf(lsafe)
                       : kNegInf;
    }
  }
}

// ---------------------------------------------------------------------------
// Host side: scratch layout, tensor maps and the launches.
// ---------------------------------------------------------------------------

int64_t padded_keys(int Sk) { return Sk > 8 ? (Sk + 7) / 8 * 8 : 8; }

// Scratch: K_lo [B,H,Sk,D], then Vt_hi and Vt_lo [B,H,D,Skp], all f32; the
// wide route also Q_lo [B,H,Sq,D] after them.
int64_t scratch_floats(int B, int Sq, int Sk, int H, int D, bool wide,
                       int64_t* klo_n, int64_t* vt_n) {
  *klo_n = static_cast<int64_t>(B) * H * Sk * D;
  *vt_n = static_cast<int64_t>(B) * H * D * padded_keys(Sk);
  const int64_t qlo_n = wide ? static_cast<int64_t>(B) * H * Sq * D : 0;
  return *klo_n + 2 * *vt_n + qlo_n;
}

// Map of an f32 tensor with dims (d0, d1, d2, d3), innermost first, element
// strides s1..s3, box (32, rows, 1, 1).  A dimension of size 1 is never
// stepped over, so its stride is set to a legal 16 bytes; a zero-length one
// is declared 1 (nothing is loaded from it).
bool encode_f32(CUtensorMap* map, const void* ptr, int64_t d0, int64_t d1,
                int64_t d2, int64_t d3, int64_t s1, int64_t s2, int64_t s3,
                int rows) {
  auto bytes = [](int64_t stride, int64_t n) -> cuuint64_t {
    return n <= 1 ? 16 : static_cast<cuuint64_t>(stride) * 4;
  };
  auto dim = [](int64_t n) -> cuuint64_t { return n > 0 ? n : 1; };
  const cuuint64_t dims[4] = {dim(d0), dim(d1), dim(d2), dim(d3)};
  const cuuint64_t strides[3] = {bytes(s1, d1), bytes(s2, d2), bytes(s3, d3)};
  const cuuint32_t box[4] = {kBoxCols, static_cast<cuuint32_t>(rows), 1, 1};
  return encode_map_4d(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, ptr, dims, strides,
                       box);
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v, float* o,
                   float* lse, float* scratch, int B, int Sq, int Sk, int H,
                   const int64_t* st, int causal, int kv_offset, float sm_scale,
                   cudaStream_t stream) {
  int64_t klo_n, vt_n;
  scratch_floats(B, Sq, Sk, H, D, false, &klo_n, &vt_n);
  const int64_t skp = padded_keys(Sk);
  float* const klo = scratch;
  float* const vt_hi = scratch + klo_n;
  float* const vt_lo = vt_hi + vt_n;

  const dim3 pgrid(static_cast<unsigned>((skp + 31) / 32), D / 32, B * H);
  split_kv_kernel<<<pgrid, dim3(32, 8), 0, stream>>>(
      k, v, klo, vt_hi, vt_lo, H, Sk, static_cast<int>(skp), D, st[3], st[4],
      st[5], st[6], st[7], st[8]);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  CUtensorMap mq, mk, mklo, mvh, mvl;
  if (!encode_f32(&mq, q, D, Sq, H, B, st[1], st[2], st[0], kBlockQ) ||
      !encode_f32(&mk, k, D, Sk, H, B, st[4], st[5], st[3], kBlockK) ||
      !encode_f32(&mklo, klo, D, Sk, H, B, D, static_cast<int64_t>(Sk) * D,
                  static_cast<int64_t>(H) * Sk * D, kBlockK) ||
      !encode_f32(&mvh, vt_hi, skp, D, H, B, skp, D * skp, H * D * skp, D) ||
      !encode_f32(&mvl, vt_lo, skp, D, H, B, skp, D * skp, H * D * skp, D))
    return cudaErrorInvalidValue;
  auto* kernel = flash_fwd_tf32_kernel<D>;
  constexpr int smem = Cfg<D>::kSmemBytes;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  const int tiles = (Sq + kBlockQ - 1) / kBlockQ;
  if (tiles > 65535) return cudaErrorInvalidValue;
  const dim3 grid(B * H, tiles);
  kernel<<<grid, kThreads, smem, stream>>>(mq, mk, mklo, mvh, mvl, o, lse, H, Sq,
                                           Sk, st[9], st[10], st[11], causal,
                                           kv_offset, sm_scale * kLog2e);
  return cudaGetLastError();
}

// The wide kernel over `slices` slices of O's columns, W wide, the first at
// column col0.
template <int W>
cudaError_t launch_slices(const CUtensorMap& mq, const CUtensorMap& mqlo,
                          const CUtensorMap& mk, const CUtensorMap& mklo,
                          const float* vt_hi, const float* vt_lo, float* o,
                          float* lse, int B, int Sq, int Sk, int H, int D,
                          int64_t skp, int tiles, int slices, int col0,
                          const int64_t* st, int causal, int kv_offset,
                          float sm_scale, cudaStream_t stream) {
  CUtensorMap mvh, mvl;  // box: 32 keys x W rows of Vt
  if (!encode_f32(&mvh, vt_hi, skp, D, H, B, skp, D * skp, H * D * skp, W) ||
      !encode_f32(&mvl, vt_lo, skp, D, H, B, skp, D * skp, H * D * skp, W))
    return cudaErrorInvalidValue;
  auto* kernel = flash_fwd_tf32_wide_kernel<W>;
  constexpr int smem = WideCfg<W>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, tiles, slices);
  kernel<<<grid, kThreads, smem, stream>>>(
      mq, mqlo, mk, mklo, mvh, mvl, o, lse, H, Sq, Sk, D / kBoxCols, col0,
      st[9], st[10], st[11], causal, kv_offset, sm_scale * kLog2e);
  return cudaGetLastError();
}

// Runs the K/V and Q pre-passes, then the wide kernel over the slices of
// O's columns at D, a multiple of 128: D / 256 of 256, then one of 128 for
// the rest.
cudaError_t launch_wide(const float* q, const float* k, const float* v, float* o,
                        float* lse, float* scratch, int B, int Sq, int Sk, int H,
                        int D, const int64_t* st, int causal, int kv_offset,
                        float sm_scale, cudaStream_t stream) {
  if (D <= 0 || D % 128 != 0) return cudaErrorInvalidValue;
  int64_t klo_n, vt_n;
  scratch_floats(B, Sq, Sk, H, D, true, &klo_n, &vt_n);
  const int64_t skp = padded_keys(Sk);
  float* const klo = scratch;
  float* const vt_hi = scratch + klo_n;
  float* const vt_lo = vt_hi + vt_n;
  float* const qlo = vt_lo + vt_n;

  const dim3 pgrid(static_cast<unsigned>((skp + 31) / 32), D / 32, B * H);
  split_kv_kernel<<<pgrid, dim3(32, 8), 0, stream>>>(
      k, v, klo, vt_hi, vt_lo, H, Sk, static_cast<int>(skp), D, st[3], st[4],
      st[5], st[6], st[7], st[8]);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 qgrid(static_cast<unsigned>((Sq + 7) / 8), D / 32, B * H);
  split_q_kernel<<<qgrid, dim3(32, 8), 0, stream>>>(q, qlo, H, Sq, D, st[0],
                                                     st[1], st[2]);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int64_t sqd = static_cast<int64_t>(Sq) * D;
  CUtensorMap mq, mqlo, mk, mklo;
  if (!encode_f32(&mq, q, D, Sq, H, B, st[1], st[2], st[0], kBlockQ) ||
      !encode_f32(&mqlo, qlo, D, Sq, H, B, D, sqd, H * sqd, kBlockQ) ||
      !encode_f32(&mk, k, D, Sk, H, B, st[4], st[5], st[3], kWideBlockK) ||
      !encode_f32(&mklo, klo, D, Sk, H, B, D, static_cast<int64_t>(Sk) * D,
                  static_cast<int64_t>(H) * Sk * D, kWideBlockK))
    return cudaErrorInvalidValue;
  const int tiles = (Sq + kBlockQ - 1) / kBlockQ;
  if (tiles > 65535) return cudaErrorInvalidValue;
  const int full = D / kSliceCols;
  if (full > 0)
    err = launch_slices<kSliceCols>(mq, mqlo, mk, mklo, vt_hi, vt_lo, o, lse, B,
                                    Sq, Sk, H, D, skp, tiles, full, 0, st, causal,
                                    kv_offset, sm_scale, stream);
  if (err == cudaSuccess && D % kSliceCols != 0)
    err = launch_slices<128>(mq, mqlo, mk, mklo, vt_hi, vt_lo, o, lse, B, Sq, Sk,
                             H, D, skp, tiles, 1, full * kSliceCols, st, causal,
                             kv_offset, sm_scale, stream);
  return err;
}

}  // namespace

// C entry point, loaded with ctypes.  q, k, v, o are f32; `wide` = 0: head
// dim D = 64 or 128; `wide` = 1: the wide route, D a multiple of 128 (the
// wrapper takes it above 128 and zero-pads other head dims up to one of
// those).  `strides` holds 12 element
// strides, (batch, seq, head) for q, k, v and o in that order, the head_dim
// stride 1, every other stride a multiple of 4 and every base 16-byte
// aligned.  `scratch` holds tos_flash_attn_fwd_tf32_scratch_bytes(..., wide) bytes,
// 16-byte aligned.  Runs the pre-pass(es) and the main kernel(s) on
// `stream`; returns cudaGetLastError() after the launches (0 on success), or
// cudaErrorInvalidValue for an input it does not take or a tensor map
// cuTensorMapEncodeTiled refuses.  Does not synchronise, allocates nothing.
extern "C" int tos_flash_attn_fwd_tf32(const void* q, const void* k,
                                       const void* v, void* o, void* lse,
                                       void* scratch, int B, int Sq, int Sk,
                                       int H, int D, const int64_t* strides,
                                       int causal, int kv_offset,
                                       float sm_scale, int wide, void* stream) {
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
                      kv_offset, sm_scale, s);
  } else if (D == 64) {
    err = launch<64>(fq, fk, fv, fo, fl, sc, B, Sq, Sk, H, strides, causal,
                     kv_offset, sm_scale, s);
  } else if (D == 128) {
    err = launch<128>(fq, fk, fv, fo, fl, sc, B, Sq, Sk, H, strides, causal,
                      kv_offset, sm_scale, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// Bytes of scratch the launch needs (K_lo, Vt_hi, Vt_lo; and Q_lo on the
// wide route).
extern "C" int64_t tos_flash_attn_fwd_tf32_scratch_bytes(int B, int Sq, int Sk,
                                                         int H, int D, int wide) {
  int64_t klo_n, vt_n;
  return 4 * scratch_floats(B, Sq, Sk, H, D, wide != 0, &klo_n, &vt_n);
}

// Dynamic shared memory of one CTA: `wide` = 0, the configuration for head
// dim D (64 or 128); `wide` = 1, the wide kernel's for slices D columns wide
// (128 or 256); else 0.
extern "C" int tos_flash_attn_fwd_tf32_smem_bytes(int D, int wide) {
  if (wide)
    return D == 128 ? WideCfg<128>::kSmemBytes
           : D == kSliceCols ? WideCfg<kSliceCols>::kSmemBytes
                             : 0;
  return D == 64 ? Cfg<64>::kSmemBytes : D == 128 ? Cfg<128>::kSmemBytes : 0;
}

// Columns of O per CTA on the wide route (the last slice may be 128).
extern "C" int tos_flash_attn_fwd_tf32_slice_cols() { return kSliceCols; }
