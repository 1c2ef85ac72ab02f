// Flash-attention forward for f32 inputs on Hopper's tensor cores (sm_90a),
// each f32 product as three TF32 `wgmma`s (3xTF32): online softmax over key
// blocks, returning the output O and the row log-sum-exp.
//
// Replaces, for f32 inputs with head dim D <= 128, the TPU kernel
// tensorflowonspark_tpu/ops/attention.py:_flash_fwd_kernel (launched by
// _flash_fwd_pallas through pl.pallas_call), which computes in f32.  The
// wrapper (ops/attention.py) zero-pads D to 64 or 128.  The contract is the
// other kernels':
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
  static_assert(N == 64 || N == 128, "P V is m64n64k8 or m64n128k8");
  if constexpr (N == 128) {
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

    // Mask only blocks that straddle the causal diagonal or the Sk tail.
    if (k0 + kBlockK > Sk || (causal && kv_offset + k0 + kBlockK - 1 > q0)) {
#pragma unroll
      for (int n = 0; n < kBlockK / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = r0 + ((e >> 1) << 3);
          const int j = k0 + n * 8 + 2 * t + (e & 1);
          if (!(j < Sk && (!causal || kv_offset + j <= row)))
            sc[4 * n + e] = kNegInf;
        }
      }
    }

    // Online softmax on the raw logits; exp2 with the scale folded in.
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < kBlockK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * n + e]);
    }
    float alpha[2];
    float mscaled[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      // the four threads of a row group hold the row's 32 columns
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      // guard the max so exp(NEG_INF - NEG_INF) of a masked row isn't 1
      const float msafe = fmaxf(mx[i], kHalfNegInf);
      alpha[i] = m[i] <= kHalfNegInf ? 0.f : ex2((m[i] - msafe) * scale_log2);
      mscaled[i] = msafe * scale_log2;
      m[i] = mx[i];
    }
    float lsum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < kBlockK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // a masked logit gives exp2(<= -6e28) = 0 exactly
        const float p = ex2(fmaf(sc[4 * n + e], scale_log2, -mscaled[e >> 1]));
        sc[4 * n + e] = p;
        lsum[e >> 1] += p;
      }
    }
    l[0] = l[0] * alpha[0] + lsum[0];
    l[1] = l[1] * alpha[1] + lsum[1];
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[4 * n + 0] *= alpha[0];
      acc[4 * n + 1] *= alpha[0];
      acc[4 * n + 2] *= alpha[1];
      acc[4 * n + 3] *= alpha[1];
    }

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
// Host side: scratch layout, tensor maps and the launches.
// ---------------------------------------------------------------------------

int64_t padded_keys(int Sk) { return Sk > 8 ? (Sk + 7) / 8 * 8 : 8; }

// Scratch: K_lo [B,H,Sk,D], then Vt_hi and Vt_lo [B,H,D,Skp], all f32.
int64_t scratch_floats(int B, int Sk, int H, int D, int64_t* klo_n, int64_t* vt_n) {
  *klo_n = static_cast<int64_t>(B) * H * Sk * D;
  *vt_n = static_cast<int64_t>(B) * H * D * padded_keys(Sk);
  return *klo_n + 2 * *vt_n;
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
  scratch_floats(B, Sk, H, D, &klo_n, &vt_n);
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

}  // namespace

// C entry point, loaded with ctypes.  q, k, v, o are f32 with head dim D =
// 64 or 128 (the wrapper zero-pads other D <= 128); `strides` holds 12
// element strides, (batch, seq, head) for q, k, v and o in that order, the
// head_dim stride 1, every other stride a multiple of 4 and every base
// 16-byte aligned.  `scratch` holds tos_flash_attn_fwd_tf32_scratch_bytes()
// bytes, 16-byte aligned.  Runs the pre-pass and the main kernel on
// `stream`; returns cudaGetLastError() after the launches (0 on success), or
// cudaErrorInvalidValue for an input it does not take or a tensor map
// cuTensorMapEncodeTiled refuses.  Does not synchronise, allocates nothing.
extern "C" int tos_flash_attn_fwd_tf32(const void* q, const void* k,
                                       const void* v, void* o, void* lse,
                                       void* scratch, int B, int Sq, int Sk,
                                       int H, int D, const int64_t* strides,
                                       int causal, int kv_offset,
                                       float sm_scale, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0) return 0;  // nothing to launch
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fq = static_cast<const float*>(q);
  const float* fk = static_cast<const float*>(k);
  const float* fv = static_cast<const float*>(v);
  float* fo = static_cast<float*>(o);
  float* fl = static_cast<float*>(lse);
  float* sc = static_cast<float*>(scratch);
  cudaError_t err;
  if (D == 64) {
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

// Bytes of scratch the launch needs (K_lo, Vt_hi, Vt_lo).
extern "C" int64_t tos_flash_attn_fwd_tf32_scratch_bytes(int B, int Sk, int H,
                                                         int D) {
  int64_t klo_n, vt_n;
  return 4 * scratch_floats(B, Sk, H, D, &klo_n, &vt_n);
}

// Dynamic shared memory of one CTA for head dim D (64 or 128), else 0.
extern "C" int tos_flash_attn_fwd_tf32_smem_bytes(int D) {
  return D == 64 ? Cfg<64>::kSmemBytes : D == 128 ? Cfg<128>::kSmemBytes : 0;
}
