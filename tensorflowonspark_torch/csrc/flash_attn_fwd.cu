// Flash-attention forward for Hopper (sm_90a): online softmax over key
// blocks, returning the output O and the row log-sum-exp.
//
// Replaces the TPU kernel tensorflowonspark_tpu/ops/attention.py:
// _flash_fwd_kernel (launched by _flash_fwd_pallas through pl.pallas_call,
// wrapped by the custom_vjp _flash_attention_tpu), with the same contract:
//   q [B,Sq,H,D], k/v [B,Sk,H,D] in bf16 or fp16 -> O [B,Sq,H,D] in the input
//   type and lse [B,Sq,H] in f32;
//   key j sits at global position kpos = kv_offset + j; the causal mask keeps
//   kpos <= qpos (top-left aligned, global), the tail mask keeps j < Sk;
//   masked logits are NEG_INF = -1e30 and every exp is guarded, so a row
//   with every position masked gives O = 0 and lse = NEG_INF, never NaN;
//   key blocks wholly in the causal future or wholly past Sk are skipped.
//
// Bound at the serving shape (B=4, S=2048, H=8, D=128, causal, bf16): the two
// products cost 4*B*H*D * (S*(S+1)/2) = 34.4 GFLOP, 35 us at the card's
// 989 TFLOP/s, against 67 MB of q/k/v/O/lse traffic, 20 us at 3.35 TB/s.
// So the kernel is bound by the tensor cores, not by memory.
//
// Design (warp-specialised, one CTA per (batch*head, 128 query rows), the
// longest causal tiles first; 3 warpgroups, 384 threads):
// - Warpgroup 0 is the producer.  After `setmaxnreg.dec` to 24 registers one
//   thread starts every load with TMA: the Q tile once, then K and V tiles of
//   BK keys (128, or 64 at D=256) into a ring of shared-memory stages (3 at
//   D=64, 2 at D=128 and D=256), each stage guarded by a "full" mbarrier
//   (TMA transaction bytes) and an "empty" one (one arrival per consumer
//   warp).  Rows past Sq or Sk arrive zero-filled, so 0 * garbage cannot
//   become NaN.
// - Warpgroups 1 and 2 are consumers (`setmaxnreg.inc` to 240), each owning
//   64 query rows.  Per key block: S = Q K^T by `wgmma` m64nBKk16 with both
//   operands K-major in 128-byte-swizzled shared memory; the online softmax
//   in registers with exp2 and sm_scale*log2(e) folded into one FMA, the
//   causal/tail mask applied only to blocks that straddle the diagonal or
//   the Sk tail; then O += P V by `wgmma` m64nDk16 in RS form: P goes from
//   the S accumulator, rounded to 16 bits, straight into the A registers,
//   and V is the B operand read MN-major (transpose bit set).  The consumer
//   releases the stage once its wgmma groups on it have completed.
// - Epilogue: O is scaled by 1/l, staged 16-bit in the consumer's rows of
//   the Q tile (swizzled, no bank conflicts) and written out with 16-byte
//   stores through O's strides; lse = m + log l, or NEG_INF where l = 0.
//
// D=256 (bf16/fp16 heads of 129-256, zero-padded to 256 by the wrapper):
// the key tile halves to BK=64 so that a consumer thread holds O (128 f32),
// S (32) and P (16) in its 240 registers; shared memory is Q 64 KB + 2
// stages x (K 32 KB + V 32 KB) = 192 KB.  P V is one m64n256k16 per 16 keys.
//
// D > 256 (flash_fwd_wide_kernel, any head dim the wrapper pads to a multiple
// of 128): O's columns in slices of 256 across a third grid dimension, Q K^T
// streamed in 64-column boxes through a ring of its own; shared memory 4 x
// 24 KB of Q/K stages + 2 x 32 KB of V stages = 160 KB.  Bound at B=2,
// S=2048, H=2, D=512, causal: 17.2 GFLOP, 0.0174 ms at 989 TFLOP/s; sliced in
// two, 25.8 GFLOP, 0.026 ms; the bytes take 0.010 ms.
//
// Tensor maps: rank 4, dims (D, S, H, B) with the tensors' own byte
// strides, box (64, 128 or BK, 1, 1) with 128-byte swizzle, encoded on the
// host on every call.  A head of D columns is D/64 boxes per tile, so the
// K-steps of Q K^T cross from one box's base to the next after 4 steps.
// The mbarrier, TMA and wgmma helpers are in hopper_pipeline.cuh.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (tensorflowonspark_torch/ops/cuda_build.py does it).

#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include "hopper_pipeline.cuh"

namespace {

constexpr int kBlockQ = 128;           // query rows per CTA, 64 per consumer
constexpr int kThreads = 384;          // producer + two consumer warpgroups
constexpr int kBoxCols = 64;           // 128-byte swizzle: 64 16-bit values
constexpr int kBoxBytes = 128 * 128;   // one 128-row x 64-column box of Q
constexpr int kEmptyArrivals = 8;      // one per consumer warp
constexpr int kProducerRegs = 24;      // setmaxnreg: 128 * 24 + 256 * 240
constexpr int kConsumerRegs = 240;     //   = 64,512 <= 65,536 registers

template <int D>
struct Cfg {
  // keys per ring stage: 128, or 64 at D=256 so that O (128 registers),
  // S and P fit a consumer thread's 240 registers and two stages fit
  static constexpr int kBlockK = D == 256 ? 64 : 128;
  static constexpr int kBoxes = D / kBoxCols;              // boxes per tile
  static constexpr int kKVBoxBytes = kBlockK * 128;        // one K or V box
  static constexpr int kQTileBytes = kBoxes * kBoxBytes;
  static constexpr int kKVTileBytes = kBoxes * kKVBoxBytes;
  static constexpr int kStages = D == 64 ? 3 : 2;          // K/V ring depth
  static constexpr int kBarOffset = kQTileBytes + 2 * kStages * kKVTileBytes;
  // tiles, 1024 bytes to align the base for the swizzle, the mbarriers
  static constexpr int kSmemBytes = kBarOffset + 1024 + 8 * (2 * kStages + 1);
};

// S (64 x N, f32) = A (64 x 16, smem K-major) * B^T (N x 16, smem K-major);
// scale_d = 0 overwrites S.
#define TOS_SS_N128(TY)                                                  \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"              \
               "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY \
               " {" TOS_R64 "}, %64, %65, p, 1, 1, 0, 0;\n}\n"           \
               : TOS_ACC64 : "l"(da), "l"(db), "r"(scale_d))
#define TOS_SS_N64(TY)                                                  \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"             \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY \
               " {" TOS_R32 "}, %32, %33, p, 1, 1, 0, 0;\n}\n"          \
               : TOS_ACC32 : "l"(da), "l"(db), "r"(scale_d))

template <int N, bool kBf16>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  static_assert(N == 64 || N == 128, "Q K^T is m64n64 or m64n128");
  if constexpr (N == 128) {
    if constexpr (kBf16) {
      TOS_SS_N128("bf16");
    } else {
      TOS_SS_N128("f16");
    }
  } else {
    if constexpr (kBf16) {
      TOS_SS_N64("bf16");
    } else {
      TOS_SS_N64("f16");
    }
  }
}

// O (64 x N, f32) += A (64 x 16, registers) * B (16 x N, smem MN-major).
#define TOS_RS_N256(TY)                                                        \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"                   \
               "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY       \
               " {" TOS_R128 "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n" \
               : TOS_ACC128                                                    \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))
#define TOS_RS_N128(TY)                                                      \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                  \
               "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY     \
               " {" TOS_R64 "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n" \
               : TOS_ACC64                                                   \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))
#define TOS_RS_N64(TY)                                                       \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                  \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY      \
               " {" TOS_R32 "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n" \
               : TOS_ACC32                                                   \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

template <int N, bool kBf16>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  static_assert(N == 64 || N == 128 || N == 256, "P V is m64n64, n128 or n256");
  if constexpr (N == 256) {
    if constexpr (kBf16) {
      TOS_RS_N256("bf16");
    } else {
      TOS_RS_N256("f16");
    }
  } else if constexpr (N == 128) {
    if constexpr (kBf16) {
      TOS_RS_N128("bf16");
    } else {
      TOS_RS_N128("f16");
    }
  } else {
    if constexpr (kBf16) {
      TOS_RS_N64("bf16");
    } else {
      TOS_RS_N64("f16");
    }
  }
}

// Two floats -> one register of two 16-bit values, `lo` in the low half.
template <bool kBf16>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  uint32_t r;
  if constexpr (kBf16) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    r = *reinterpret_cast<uint32_t*>(&v);
  } else {
    __half2 v = __floats2half2_rn(lo, hi);
    r = *reinterpret_cast<uint32_t*>(&v);
  }
  return r;
}

// Accumulator layout of wgmma m64nN (f32), per warp w of the warpgroup and
// lane = 4g + t: d[4n + e] holds row 16w + g + 8*(e >> 1), column
// 8n + 2t + (e & 1).  Read as the A registers of a k16 step, the 16 columns
// 16kk..16kk+15 are d[8kk .. 8kk+7] packed in pairs, so P never leaves the
// registers.
template <int D, bool kBf16>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 uint16_t* __restrict__ o, float* __restrict__ lse, int H,
                 int Sq, int Sk, int64_t o_sb, int64_t o_ss, int64_t o_sh,
                 int causal, int kv_offset, float scale_log2) {
  using C = Cfg<D>;
  constexpr int S = C::kStages;
  constexpr int BK = C::kBlockK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms 1024-aligned
  uint8_t* const sbase = smem_raw + (base - raw);
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
  const int nkb = (kend + BK - 1) / BK;

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

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---------------- producer: one thread keeps the ring full ----------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs) : "memory");
    if (threadIdx.x == 0 && nkb > 0) {
      prefetch_map(&tm_k);
      prefetch_map(&tm_v);
      mbar_expect_tx(qbar, C::kQTileBytes);
#pragma unroll
      for (int x = 0; x < C::kBoxes; ++x)
        tma_load(base + x * kBoxBytes, &tm_q, qbar, x * kBoxCols, q0, h, b);
      for (int kb = 0; kb < nkb; ++kb) {
        const int s = kb % S;
        const uint32_t full = bars + 8 * s;
        mbar_wait(bars + 8 * (S + s), ((kb / S) & 1) ^ 1);  // stage released
        mbar_expect_tx(full, 2 * C::kKVTileBytes);
        const uint32_t ks = base + C::kQTileBytes + C::kKVTileBytes * s;
        const uint32_t vs = base + C::kQTileBytes + C::kKVTileBytes * (S + s);
#pragma unroll
        for (int x = 0; x < C::kBoxes; ++x) {
          tma_load(ks + x * C::kKVBoxBytes, &tm_k, full, x * kBoxCols, kb * BK,
                   h, b);
          tma_load(vs + x * C::kKVBoxBytes, &tm_v, full, x * kBoxCols, kb * BK,
                   h, b);
        }
      }
    }
  } else {
    // ---------------- consumers: 64 query rows each ---------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs) : "memory");
    const int cw = wg - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane / 4;
    const int t = lane % 4;
    const int qw0 = q0 + 64 * cw;          // this consumer's first row
    const int r0 = qw0 + 16 * warp + g;    // this thread's rows: r0, r0 + 8
    const uint32_t q_rows = base + cw * 64 * 128;  // its rows of each Q box

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m[2] = {kNegInf, kNegInf};  // running max of the raw logits
    float l[2] = {0.f, 0.f};          // this thread's share of the row sums

    if (nkb > 0) mbar_wait(qbar, 0);
    for (int kb = 0; kb < nkb; ++kb) {
      const int s = kb % S;
      const int k0 = kb * BK;
      const uint32_t ks = base + C::kQTileBytes + C::kKVTileBytes * s;
      const uint32_t vs = base + C::kQTileBytes + C::kKVTileBytes * (S + s);
      mbar_wait(bars + 8 * s, (kb / S) & 1);

      // S = Q K^T: D/16 k-steps of 16; after 4 steps the next 64-column box.
      float sc[BK / 2];
      pin(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t col = (kk % 4) * 32;
        wgmma_ss<BK, kBf16>(sc, smem_desc(q_rows + (kk / 4) * kBoxBytes + col, 16, 1024),
                            smem_desc(ks + (kk / 4) * C::kKVBoxBytes + col, 16, 1024),
                            kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(sc);

      // The mask (on blocks that straddle the diagonal or the Sk tail) and
      // the online softmax: S becomes P; m, l and O are rescaled.
      online_softmax_block<BK>(sc, acc, m, l, k0, qw0, r0, t, Sk, causal,
                               kv_offset, scale_log2);

      // O += P V: BK/16 k-steps of 16 keys, P from the S accumulator.
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        pa[kk][0] = pack2<kBf16>(sc[8 * kk + 0], sc[8 * kk + 1]);
        pa[kk][1] = pack2<kBf16>(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[kk][2] = pack2<kBf16>(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[kk][3] = pack2<kBf16>(sc[8 * kk + 6], sc[8 * kk + 7]);
      }
      pin(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs<D, kBf16>(acc, pa[kk],
                           smem_desc(vs + kk * 16 * 128, C::kKVBoxBytes, 1024));
      wgmma_commit();
      wgmma_wait_all();
      pin(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(bars + 8 * (S + s));  // release the stage
    }

    // Epilogue: normalise, stage in this consumer's Q rows, store rows.
    uint8_t* const stage = sbase + cw * 64 * 128;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      const float lsafe = fmaxf(l[i], 1e-30f);
      const float inv = 1.f / lsafe;
      const int rl = 16 * warp + g + 8 * i;  // row within the consumer's 64
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const int c = n % 8;  // 16-byte chunk within the 128-byte box row
        *reinterpret_cast<uint32_t*>(stage + (n / 8) * kBoxBytes + rl * 128 +
                                     ((c ^ (rl & 7)) << 4) + 4 * t) =
            pack2<kBf16>(acc[4 * n + 2 * i] * inv, acc[4 * n + 2 * i + 1] * inv);
      }
      const int row = r0 + 8 * i;
      if (t == 0 && row < Sq) {
        lse[(static_cast<int64_t>(b) * Sq + row) * H + h] =
            l[i] > 0.f ? fmaxf(m[i], kHalfNegInf) * (scale_log2 * kLn2) + logf(lsafe)
                       : kNegInf;
      }
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
    constexpr int kChunks = D / 8;  // 16-byte chunks per row
    uint16_t* const obase = o + b * o_sb + h * o_sh;
#pragma unroll 4
    for (int idx = tid; idx < 64 * kChunks; idx += 128) {
      const int rl = idx / kChunks;
      const int cc = idx % kChunks;
      const int row = qw0 + rl;
      if (row < Sq) {
        const uint4 v = *reinterpret_cast<const uint4*>(
            stage + (cc / 8) * kBoxBytes + rl * 128 + (((cc % 8) ^ (rl & 7)) << 4));
        *reinterpret_cast<uint4*>(obase + row * o_ss + cc * 8) = v;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The wide route: D > 256 (the wrapper pads it to a multiple of 128, as the
// TPU kernel pads its head dim).  Q (128 rows x D) and the K/V ring do not
// fit one CTA's shared memory beside each other, nor O a consumer thread's
// registers, so the grid gains a dimension over slices of O's columns,
// W = kSliceCols = 256 wide (the D=256 configuration's key tile of 64 and
// its P V m64n256k16; the last slice 128 wide where D is an odd multiple of
// 128), and each CTA
// streams the contraction of S = Q K^T through a ring of 4 stages, one
// 64-column box of Q (128 rows) and of K (64 keys) each, 24 KB.  Every
// slice computes the same S, m and l in the same order, then O += P V
// against its own slice of V only, from a second ring of 2 stages (W/64
// boxes of 64 keys).  Slice 0 alone writes lse.  Q K^T is recomputed once
// per slice.  Within a key block a consumer keeps one chunk's wgmma group in
// flight while it releases the stage of the chunk before.  The epilogue
// stages O over the Q/K ring once both consumers are past their last wgmma.
// ---------------------------------------------------------------------------
constexpr int kSliceCols = 256;
constexpr int kWideBlockK = 64;
constexpr int kWideQKStages = 4;
constexpr int kWideVStages = 2;

template <int W>
struct WideCfg {
  static constexpr int kKBoxBytes = kWideBlockK * 128;             // 8 KB
  static constexpr int kQKStageBytes = kBoxBytes + kKBoxBytes;     // 24 KB
  static constexpr int kVStageBytes = (W / kBoxCols) * kKBoxBytes;  // 32 KB at W=256
  static constexpr int kVOffset = kWideQKStages * kQKStageBytes;
  static constexpr int kBarOffset = kVOffset + kWideVStages * kVStageBytes;
  // tiles, 1024 bytes to align the base for the swizzle, the mbarriers
  static constexpr int kSmemBytes =
      kBarOffset + 1024 + 8 * 2 * (kWideQKStages + kWideVStages);
  static_assert((W / kBoxCols) * kBoxBytes <= kVOffset,
                "the epilogue stages O (128 rows x W) over the Q/K ring");
};

template <int W, bool kBf16>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wide_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      uint16_t* __restrict__ o, float* __restrict__ lse, int H,
                      int Sq, int Sk, int nchunks, int col0, int64_t o_sb,
                      int64_t o_ss, int64_t o_sh, int causal, int kv_offset,
                      float scale_log2) {
  using C = WideCfg<W>;
  constexpr int QS = kWideQKStages;
  constexpr int VS = kWideVStages;
  constexpr int BK = kWideBlockK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms 1024-aligned
  uint8_t* const sbase = smem_raw + (base - raw);
  const uint32_t v_ring = base + C::kVOffset;
  // qk_full[QS], qk_empty[QS], v_full[VS], v_empty[VS]
  const uint32_t qk_full = base + C::kBarOffset;
  const uint32_t qk_empty = qk_full + 8 * QS;
  const uint32_t v_full = qk_empty + 8 * QS;
  const uint32_t v_empty = v_full + 8 * VS;

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
#pragma unroll
    for (int s = 0; s < VS; ++s) {
      mbar_init(v_full + 8 * s, 1);
      mbar_init(v_empty + 8 * s, kEmptyArrivals);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---------------- producer: one thread keeps both rings full ---------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs) : "memory");
    if (threadIdx.x == 0 && nkb > 0) {
      prefetch_map(&tm_q);
      prefetch_map(&tm_k);
      prefetch_map(&tm_v);
      int it = 0;  // Q/K stages filled, over (key block, chunk)
      for (int kb = 0; kb < nkb; ++kb) {
        for (int c = 0; c < nchunks; ++c, ++it) {
          const int s = it % QS;
          const uint32_t full = qk_full + 8 * s;
          mbar_wait(qk_empty + 8 * s, ((it / QS) & 1) ^ 1);  // stage released
          mbar_expect_tx(full, C::kQKStageBytes);
          const uint32_t st = base + s * C::kQKStageBytes;
          tma_load(st, &tm_q, full, c * kBoxCols, q0, h, b);
          tma_load(st + kBoxBytes, &tm_k, full, c * kBoxCols, kb * BK, h, b);
        }
        const int sv = kb % VS;
        const uint32_t full = v_full + 8 * sv;
        mbar_wait(v_empty + 8 * sv, ((kb / VS) & 1) ^ 1);
        mbar_expect_tx(full, C::kVStageBytes);
        const uint32_t vs = v_ring + sv * C::kVStageBytes;
#pragma unroll
        for (int x = 0; x < W / kBoxCols; ++x)
          tma_load(vs + x * C::kKBoxBytes, &tm_v, full, c0 + x * kBoxCols, kb * BK,
                   h, b);
      }
    }
  } else {
    // ---------------- consumers: 64 query rows each ---------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs) : "memory");
    const int cw = wg - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane / 4;
    const int t = lane % 4;
    const int qw0 = q0 + 64 * cw;          // this consumer's first row
    const int r0 = qw0 + 16 * warp + g;    // this thread's rows: r0, r0 + 8

    float acc[W / 2];
#pragma unroll
    for (int i = 0; i < W / 2; ++i) acc[i] = 0.f;
    float m[2] = {kNegInf, kNegInf};  // running max of the raw logits
    float l[2] = {0.f, 0.f};          // this thread's share of the row sums

    int it = 0;  // Q/K stages consumed
    for (int kb = 0; kb < nkb; ++kb) {
      const int k0 = kb * BK;

      // S = Q K^T chunk by chunk: 4 k-steps of 16 per 64-column box.
      float sc[BK / 2];
      for (int c = 0; c < nchunks; ++c, ++it) {
        const int s = it % QS;
        mbar_wait(qk_full + 8 * s, (it / QS) & 1);
        const uint32_t q_rows = base + s * C::kQKStageBytes + cw * 64 * 128;
        const uint32_t ks = base + s * C::kQKStageBytes + kBoxBytes;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<BK, kBf16>(sc, smem_desc(q_rows + kk * 32, 16, 1024),
                              smem_desc(ks + kk * 32, 16, 1024), c > 0 || kk > 0);
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
      online_softmax_block<BK>(sc, acc, m, l, k0, qw0, r0, t, Sk, causal,
                               kv_offset, scale_log2);

      // O[:, slice] += P V[:, slice]: BK/16 k-steps of 16 keys.
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        pa[kk][0] = pack2<kBf16>(sc[8 * kk + 0], sc[8 * kk + 1]);
        pa[kk][1] = pack2<kBf16>(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[kk][2] = pack2<kBf16>(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[kk][3] = pack2<kBf16>(sc[8 * kk + 6], sc[8 * kk + 7]);
      }
      const int sv = kb % VS;
      mbar_wait(v_full + 8 * sv, (kb / VS) & 1);
      const uint32_t vs = v_ring + sv * C::kVStageBytes;
      pin(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs<W, kBf16>(acc, pa[kk],
                           smem_desc(vs + kk * 16 * 128, C::kKBoxBytes, 1024));
      wgmma_commit();
      wgmma_wait_all();
      pin(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(v_empty + 8 * sv);  // release the V stage
    }

    // Epilogue: once both consumers are past their last wgmma on the ring,
    // normalise, stage in this consumer's rows over the ring, store rows.
    asm volatile("bar.sync 3, 256;\n" ::: "memory");
    uint8_t* const stage = sbase + cw * 64 * 128;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      const float lsafe = fmaxf(l[i], 1e-30f);
      const float inv = 1.f / lsafe;
      const int rl = 16 * warp + g + 8 * i;  // row within the consumer's 64
#pragma unroll
      for (int n = 0; n < W / 8; ++n) {
        const int c = n % 8;  // 16-byte chunk within the 128-byte box row
        *reinterpret_cast<uint32_t*>(stage + (n / 8) * kBoxBytes + rl * 128 +
                                     ((c ^ (rl & 7)) << 4) + 4 * t) =
            pack2<kBf16>(acc[4 * n + 2 * i] * inv, acc[4 * n + 2 * i + 1] * inv);
      }
      const int row = r0 + 8 * i;
      if (t == 0 && row < Sq && c0 == 0) {
        lse[(static_cast<int64_t>(b) * Sq + row) * H + h] =
            l[i] > 0.f ? fmaxf(m[i], kHalfNegInf) * (scale_log2 * kLn2) + logf(lsafe)
                       : kNegInf;
      }
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
    constexpr int kChunks = W / 8;  // 16-byte chunks per row
    uint16_t* const obase = o + b * o_sb + h * o_sh + c0;
#pragma unroll 4
    for (int idx = tid; idx < 64 * kChunks; idx += 128) {
      const int rl = idx / kChunks;
      const int cc = idx % kChunks;
      const int row = qw0 + rl;
      if (row < Sq) {
        const uint4 v = *reinterpret_cast<const uint4*>(
            stage + (cc / 8) * kBoxBytes + rl * 128 + (((cc % 8) ^ (rl & 7)) << 4));
        *reinterpret_cast<uint4*>(obase + row * o_ss + cc * 8) = v;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Host side: tensor maps and the launch.
// ---------------------------------------------------------------------------

// Map of a [B, S, H, D] operand read through its element strides
// (batch, seq, head): dims (D, S, H, B), box (64, rows, 1, 1), 128-byte
// swizzle, rows out of bounds zero-filled.  A dimension of size 1 is never
// stepped over, so its stride is set to a legal 16 bytes.
bool encode_map(CUtensorMap* map, const void* ptr, bool bf16, int B, int S,
                int H, int D, const int64_t* st, int rows) {
  const int s = S > 0 ? S : 1;  // Sk = 0: nothing is loaded, the map stays legal
  auto bytes = [](int64_t stride, int n) -> cuuint64_t {
    return n == 1 ? 16 : static_cast<cuuint64_t>(stride) * 2;
  };
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {bytes(st[1], s), bytes(st[2], H), bytes(st[0], B)};
  const cuuint32_t box[4] = {kBoxCols, static_cast<cuuint32_t>(rows), 1, 1};
  return encode_map_4d(map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                 : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
                       ptr, dims, strides, box);
}

template <int D, bool kBf16>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int Sq, int Sk, int H, const int64_t* st,
                   int causal, int kv_offset, float sm_scale,
                   cudaStream_t stream) {
  constexpr int kRowsKV = Cfg<D>::kBlockK;
  CUtensorMap mq, mk, mv;
  if (!encode_map(&mq, q, kBf16, B, Sq, H, D, st, kBlockQ) ||
      !encode_map(&mk, k, kBf16, B, Sk, H, D, st + 3, kRowsKV) ||
      !encode_map(&mv, v, kBf16, B, Sk, H, D, st + 6, kRowsKV))
    return cudaErrorInvalidValue;
  auto* kernel = flash_fwd_kernel<D, kBf16>;
  constexpr int smem = Cfg<D>::kSmemBytes;
  // setmaxnreg moves registers within the CTA's pool: the consumers' 240
  // are only there if the launch reserves 24*128 + 240*256 = 168 * 384.
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  if (attr.numRegs * kThreads < kProducerRegs * 128 + kConsumerRegs * 256)
    return cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Sq + kBlockQ - 1) / kBlockQ);
  kernel<<<grid, kThreads, smem, stream>>>(
      mq, mk, mv, static_cast<uint16_t*>(o), lse, H, Sq, Sk, st[9], st[10],
      st[11], causal, kv_offset, sm_scale * kLog2e);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_typed(bool bf16, const void* q, const void* k, const void* v,
                         void* o, float* lse, int B, int Sq, int Sk, int H,
                         const int64_t* st, int causal, int kv_offset,
                         float sm_scale, cudaStream_t s) {
  return bf16 ? launch<D, true>(q, k, v, o, lse, B, Sq, Sk, H, st, causal,
                                kv_offset, sm_scale, s)
              : launch<D, false>(q, k, v, o, lse, B, Sq, Sk, H, st, causal,
                                 kv_offset, sm_scale, s);
}

// The wide kernel over `slices` slices of O's columns, W wide, the first at
// column col0.
template <int W, bool kBf16>
cudaError_t launch_slices(const CUtensorMap& mq, const CUtensorMap& mk,
                          const CUtensorMap& mv, void* o, float* lse, int B,
                          int Sq, int Sk, int H, int D, int slices, int col0,
                          const int64_t* st, int causal, int kv_offset,
                          float sm_scale, cudaStream_t stream) {
  auto* kernel = flash_fwd_wide_kernel<W, kBf16>;
  constexpr int smem = WideCfg<W>::kSmemBytes;
  // setmaxnreg moves registers within the CTA's pool (see launch())
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  if (attr.numRegs * kThreads < kProducerRegs * 128 + kConsumerRegs * 256)
    return cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Sq + kBlockQ - 1) / kBlockQ, slices);
  kernel<<<grid, kThreads, smem, stream>>>(
      mq, mk, mv, static_cast<uint16_t*>(o), lse, H, Sq, Sk, D / kBoxCols, col0,
      st[9], st[10], st[11], causal, kv_offset, sm_scale * kLog2e);
  return cudaGetLastError();
}

// The wide route at D, a multiple of 128: slices of 256 columns, then one of
// 128 for the rest.
template <bool kBf16>
cudaError_t launch_wide(const void* q, const void* k, const void* v, void* o,
                        float* lse, int B, int Sq, int Sk, int H, int D,
                        const int64_t* st, int causal, int kv_offset,
                        float sm_scale, cudaStream_t stream) {
  if (D <= 0 || D % 128 != 0) return cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv;
  if (!encode_map(&mq, q, kBf16, B, Sq, H, D, st, kBlockQ) ||
      !encode_map(&mk, k, kBf16, B, Sk, H, D, st + 3, kWideBlockK) ||
      !encode_map(&mv, v, kBf16, B, Sk, H, D, st + 6, kWideBlockK))
    return cudaErrorInvalidValue;
  const int full = D / kSliceCols;
  cudaError_t err = cudaSuccess;
  if (full > 0)
    err = launch_slices<kSliceCols, kBf16>(mq, mk, mv, o, lse, B, Sq, Sk, H, D,
                                           full, 0, st, causal, kv_offset,
                                           sm_scale, stream);
  if (err == cudaSuccess && D % kSliceCols != 0)
    err = launch_slices<128, kBf16>(mq, mk, mv, o, lse, B, Sq, Sk, H, D, 1,
                                    full * kSliceCols, st, causal, kv_offset,
                                    sm_scale, stream);
  return err;
}

}  // namespace

// C entry point, loaded with ctypes.  `strides` holds 12 element strides:
// (batch, seq, head) for q, k, v and o, in that order; the head_dim stride
// is 1, every other stride a multiple of 8 and every base 16-byte aligned.
// `wide` = 0: D is 64, 128 or 256; `wide` = 1: the wide route, D a multiple
// of 128 (the wrapper takes it above 256); dtype: 0 = bf16, 1 = fp16.  Returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for an input it does not take or a tensor map
// cuTensorMapEncodeTiled refuses.  Launches on `stream`, does not
// synchronise, and allocates nothing.
extern "C" int tos_flash_attn_fwd(const void* q, const void* k, const void* v,
                                  void* o, void* lse, int B, int Sq, int Sk,
                                  int H, int D, const int64_t* strides,
                                  int causal, int kv_offset, float sm_scale,
                                  int wide, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0) return 0;  // nothing to launch
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  const bool bf16 = dtype == 0;
  cudaError_t err;
  if (wide) {
    err = bf16 ? launch_wide<true>(q, k, v, o, l, B, Sq, Sk, H, D, strides,
                                   causal, kv_offset, sm_scale, s)
               : launch_wide<false>(q, k, v, o, l, B, Sq, Sk, H, D, strides,
                                    causal, kv_offset, sm_scale, s);
  } else if (D == 64) {
    err = launch_typed<64>(bf16, q, k, v, o, l, B, Sq, Sk, H, strides, causal,
                           kv_offset, sm_scale, s);
  } else if (D == 128) {
    err = launch_typed<128>(bf16, q, k, v, o, l, B, Sq, Sk, H, strides, causal,
                            kv_offset, sm_scale, s);
  } else if (D == 256) {
    err = launch_typed<256>(bf16, q, k, v, o, l, B, Sq, Sk, H, strides, causal,
                            kv_offset, sm_scale, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// Dynamic shared memory of one CTA: `wide` = 0, the configuration for head
// dim D (64, 128 or 256); `wide` = 1, the wide kernel's for slices D columns
// wide (128 or 256); else 0.
extern "C" int tos_flash_attn_fwd_smem_bytes(int D, int wide) {
  if (wide)
    return D == 128 ? WideCfg<128>::kSmemBytes
           : D == kSliceCols ? WideCfg<kSliceCols>::kSmemBytes
                             : 0;
  return D == 64 ? Cfg<64>::kSmemBytes
         : D == 128 ? Cfg<128>::kSmemBytes
         : D == 256 ? Cfg<256>::kSmemBytes
                    : 0;
}

// Columns of O per CTA on the wide route (the last slice may be 128).
extern "C" int tos_flash_attn_fwd_slice_cols() { return kSliceCols; }
