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
//   BK keys (128, or 64 at tiles of 192 and 256 columns) into a ring of
//   shared-memory stages (4 at 32 columns, 3 at 64, 96 and 192, 2 at 128
//   and 256), each stage guarded by a "full" mbarrier (TMA transaction
//   bytes) and an "empty" one (one arrival per consumer warp).  Rows past
//   Sq or Sk, and columns past the head dim, arrive zero-filled, so
//   0 * garbage cannot become NaN.
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
//   stores through O's strides, only its columns below the head dim;
//   lse = m + log l, or NEG_INF where l = 0.
//
// The real head dim (every d up to 256 whose rows are whole 16-byte rows:
// a multiple of 8).  The kernel is compiled for tiles of D = 32, 64, 96,
// 128, 192 and 256 columns and a head of d columns runs on the narrowest
// tile that holds it, straight from the caller's tensors: the tensor maps
// are encoded at d, so TMA zero-fills the tile's columns past d (zero
// columns change neither Q K^T nor O's first d columns), and the epilogue
// writes only O's d columns into the caller's [B,Sq,H,d] tensor.  Q K^T
// and P V run at the tile's width: wgmma's N is an immediate, and the
// tiles are spaced so that every box of a tile holds a real column (at most
// 24 zero columns past d on the tiles of 32 to 128 columns, 56 on those of
// 192 and 256).  Issuing only the k-steps of Q K^T with real columns took
// one straight run of wgmma per count (up to three times the code) and won
// nothing at B=4 S=2048 causal on an H100 SXM: 2.7% at d=48, level at 80
// and 224, 1.4% slower at 160, and 0.4-1.2% slower on the full tiles.
// Nothing is padded or copied in device memory.
// - Tiles of 32 and 96 columns take boxes of 32 columns (64-byte rows) with
//   the 64-byte swizzle: wgmma reads an MN-major operand (V in P V) in whole
//   swizzle atoms, 32 columns wide at the 64-byte swizzle, so N = 32 and
//   N = 96 are whole atoms, where a 128-byte-swizzled box of 64 columns
//   would leave P V's last atom half read.  The K-major descriptors step
//   8-row groups at 512 bytes and a k-step of 16 columns within a row at 32
//   bytes, as at the 128-byte swizzle.  So a D=32 stage is 8 KB of K and 8 KB
//   of V, and the ring is 4 stages deep: at that width the kernel is bound
//   by the bytes it reads and the exps it takes (33.5 M at the example LM's
//   B=8 S=1024 H=8 causal, 16 a clock on each SM), not by products.
// - Tiles of 192 and 256 columns halve the key tile to BK=64 so that a
//   consumer thread holds O (96 or 128 f32), S (32) and P (16) in its 240
//   registers; shared memory is Q 48 KB + 3 stages x (K 24 KB + V 24 KB) =
//   192 KB at 192, Q 64 KB + 2 x (32 + 32) = 192 KB at 256.  P V is one
//   m64n192k16 or m64n256k16 per 16 keys.
//
// D > 256 (flash_fwd_wide_kernel, at the real head dim): one tile of 64
// query rows per CTA, the head dim split between the two consumers (each
// owns half of Q K^T's contraction and up to 256 columns of O; the partial S
// tiles summed through shared memory), Q resident, split-KV with a combine
// kernel on small grids; see the section below.
//
// Tensor maps: rank 4, dims (d, S, H, B) with the tensors' own byte
// strides, box (64 or 32, 128 or BK, 1, 1) with the 128- or 64-byte
// swizzle, encoded on the host on every call (the shared-memory attribute
// is set once per instantiation, configure_once).  A tile of D columns is
// D/64 (or D/32) boxes, so the k-steps of Q K^T cross from one box's base to
// the next after 4 (or 2) steps.
// The mbarrier, TMA and wgmma helpers are in hopper_pipeline.cuh, the
// 16-bit wgmma products and the operand tensor maps in wgmma16.cuh.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (tensorflowonspark_torch/ops/cuda_build.py does it).

#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include "hopper_pipeline.cuh"
#include "wgmma16.cuh"

namespace {

constexpr int kBlockQ = 128;           // query rows per CTA, 64 per consumer
constexpr int kThreads = 384;          // producer + two consumer warpgroups
constexpr int kBoxCols = 64;           // 128-byte swizzle: 64 16-bit values
constexpr int kEmptyArrivals = 8;      // one per consumer warp
constexpr int kMaxTile = 256;          // the widest tile; wider heads: the wide route
constexpr int kProducerRegs = 24;      // setmaxnreg: 128 * 24 + 256 * 240
constexpr int kConsumerRegs = 240;     //   = 64,512 <= 65,536 registers

// The tile of D columns (D = 32, 64, 96, 128, 192 or 256).
template <int D>
struct Cfg {
  static_assert(D == 32 || D == 64 || D == 96 || D == 128 || D == 192 || D == 256,
                "the tiles of the D <= 256 route");
  // boxes of 32 columns with the 64-byte swizzle at 32 and 96 (whole
  // swizzle atoms for P V's N), else of 64 with the 128-byte swizzle
  static constexpr bool kNarrowBox = D == 32 || D == 96;
  static constexpr int kBoxCols = kNarrowBox ? 32 : 64;
  static constexpr int kRowBytes = 2 * kBoxCols;            // a box row
  static constexpr int kSteps = kBoxCols / 16;              // k-steps per box
  static constexpr uint32_t kLayout = kNarrowBox ? kSwizzle64 : kSwizzle128;
  static constexpr int kGroupBytes = 8 * kRowBytes;         // 8 rows: SBO
  static constexpr int kQKSteps = D / 16;                   // Q K^T's k-steps of 16
  // keys per ring stage: 128, or 64 at 192 and 256 so that O (96 or 128
  // registers), S and P fit a consumer thread's 240 registers
  static constexpr int kBlockK = D >= 192 ? 64 : 128;
  static constexpr int kBoxes = D / kBoxCols;               // boxes per tile
  static constexpr int kQBoxBytes = kBlockQ * kRowBytes;    // one Q box
  static constexpr int kKVBoxBytes = kBlockK * kRowBytes;   // one K or V box
  static constexpr int kQTileBytes = kBoxes * kQBoxBytes;
  static constexpr int kKVTileBytes = kBoxes * kKVBoxBytes;
  // K/V ring depth: as deep as shared memory allows where a stage is small
  static constexpr int kStages = D == 32 ? 4 : (D == 128 || D == 256) ? 2 : 3;
  static constexpr int kBarOffset = kQTileBytes + 2 * kStages * kKVTileBytes;
  // tiles, 1024 bytes to align the base for the swizzle, the mbarriers
  static constexpr int kSmemBytes = kBarOffset + 1024 + 8 * (2 * kStages + 1);
  static_assert(kSmemBytes <= 232448, "a CTA has 227 KB of shared memory");
};

// A count fixed at compile time that reads as an int: the full tile's
// chunks of O in the epilogue, so that its loops fold as they did when D
// was the only head dim.
template <int N>
struct Count {
  __host__ __device__ constexpr operator int() const { return N; }
};

// S = Q K^T over the tile's k-steps of 16 columns, one straight run of
// wgmma from the fence to the wait: after kSteps steps the next box.
template <class C, bool kBf16>
__device__ __forceinline__ void qk_product(float (&sc)[C::kBlockK / 2], uint32_t q_rows,
                                           uint32_t ks) {
  pin(sc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < C::kQKSteps; ++kk) {
    const uint32_t col = (kk % C::kSteps) * 32;
    const int x = kk / C::kSteps;
    wgmma_ss<C::kBlockK, kBf16>(
        sc, smem_desc(q_rows + x * C::kQBoxBytes + col, 16, C::kGroupBytes, C::kLayout),
        smem_desc(ks + x * C::kKVBoxBytes + col, 16, C::kGroupBytes, C::kLayout), kk > 0);
  }
  wgmma_commit();
  wgmma_wait_all();
  pin(sc);
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
                 int Sq, int Sk, int d, int64_t o_sb, int64_t o_ss, int64_t o_sh,
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
        tma_load(base + x * C::kQBoxBytes, &tm_q, qbar, x * C::kBoxCols, q0, h, b);
      for (int kb = 0; kb < nkb; ++kb) {
        const int s = kb % S;
        const uint32_t full = bars + 8 * s;
        mbar_wait(bars + 8 * (S + s), ((kb / S) & 1) ^ 1);  // stage released
        mbar_expect_tx(full, 2 * C::kKVTileBytes);
        const uint32_t ks = base + C::kQTileBytes + C::kKVTileBytes * s;
        const uint32_t vs = base + C::kQTileBytes + C::kKVTileBytes * (S + s);
#pragma unroll
        for (int x = 0; x < C::kBoxes; ++x) {
          tma_load(ks + x * C::kKVBoxBytes, &tm_k, full, x * C::kBoxCols, kb * BK,
                   h, b);
          tma_load(vs + x * C::kKVBoxBytes, &tm_v, full, x * C::kBoxCols, kb * BK,
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
    const uint32_t q_rows = base + cw * 64 * C::kRowBytes;  // its rows of each Q box

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

      // S = Q K^T: the tile's D/16 k-steps of 16.
      float sc[BK / 2];
      qk_product<C, kBf16>(sc, q_rows, ks);

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
                           smem_desc(vs + kk * 16 * C::kRowBytes, C::kKVBoxBytes,
                                     C::kGroupBytes, C::kLayout));
      wgmma_commit();
      wgmma_wait_all();
      pin(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(bars + 8 * (S + s));  // release the stage
    }

    // Epilogue: normalise, stage O's d columns in this consumer's Q rows
    // (stage_at: 16-byte chunk n of row rl, its place in the box row
    // swizzled by the row, so the 8 rows of a store hit 8 different 16-byte
    // bank groups), store rows.
    uint8_t* const stage = sbase + cw * 64 * C::kRowBytes;
    constexpr int kRowChunks = C::kRowBytes / 16;  // 16-byte chunks a box row
    auto stage_at = [&](int rl, int n) {
      const int c = n % kRowChunks;
      const int swz = kRowChunks == 8 ? (rl & 7) : ((rl >> 1) & 3);
      return stage + (n / kRowChunks) * C::kQBoxBytes + rl * C::kRowBytes +
             ((c ^ swz) << 4);
    };
    float inv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      const float lsafe = fmaxf(l[i], 1e-30f);
      inv[i] = 1.f / lsafe;
      const int row = r0 + 8 * i;
      if (t == 0 && row < Sq) {
        lse[(static_cast<int64_t>(b) * Sq + row) * H + h] =
            l[i] > 0.f ? fmaxf(m[i], kHalfNegInf) * (scale_log2 * kLn2) + logf(lsafe)
                       : kNegInf;
      }
    }
    // O's `chunks` 16-byte chunks a row (d / 8): a compile-time count on a
    // full tile (d == D), as the kernel had before it took d; with the
    // count read from d on every tile the tiles of 128 and 256 columns ran
    // 2-4% slower on an H100 SXM
    auto write_o = [&](auto chunks) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int rl = 16 * warp + g + 8 * i;  // row within the consumer's 64
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          if (n < chunks)
            *reinterpret_cast<uint32_t*>(stage_at(rl, n) + 4 * t) = pack2<kBf16>(
                acc[4 * n + 2 * i] * inv[i], acc[4 * n + 2 * i + 1] * inv[i]);
        }
      }
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
      uint16_t* const obase = o + b * o_sb + h * o_sh;
      constexpr int kTileChunks = D / 8;  // a constant divisor: no division
#pragma unroll 4
      for (int idx = tid; idx < 64 * kTileChunks; idx += 128) {
        const int rl = idx / kTileChunks;
        const int cc = idx % kTileChunks;
        const int row = qw0 + rl;
        if (row < Sq && cc < chunks) {
          const uint4 v = *reinterpret_cast<const uint4*>(stage_at(rl, cc));
          *reinterpret_cast<uint4*>(obase + row * o_ss + cc * 8) = v;
        }
      }
    };
    if (d == D) {
      write_o(Count<D / 8>{});
    } else {
      write_o(d / 8);
    }
  }
}

// ---------------------------------------------------------------------------
// The wide route: D > 256, at the real head dim (TMA zero-fills the columns
// of a box past D; the wrapper pads only a D that is not a multiple of 8,
// whose rows a tensor map cannot describe).  O (64 rows x D in f32) does not
// fit one consumer's registers, so the CTA's two consumer warpgroups share
// one tile of 64 query rows and split the head dim between them: each owns
// W columns of O (W = 192 up to D = 384, else 256), and each computes the
// partial S over its half of the head dim's 64-column boxes.  The two
// partial S tiles (64 x 64 f32, 16 KB each) are summed through shared
// memory, in the same order in both, so both hold the same S, run the same
// online softmax (the same m, l and P), and run P V on their own columns.
// So Q K^T is computed once per query tile: of the three designs (the
// contraction split between the consumers; a 2-CTA cluster sharing S or P
// through distributed shared memory; the slices kept with Q and K
// multicast), this is the only one that neither recomputes S nor needs a
// cluster's barriers, and its exchange costs 2 x 16 KB of shared memory and
// two named barriers a key block.
//
// Q stays resident: its 64 rows at up to 512 columns are 64 KB, loaded once,
// beside one stage of K and one of V (64 keys x up to 512 columns, 64 KB
// each; two K stages at W = 192) and the exchange buffer: 224 KB.  One
// producer thread loads Q and fills the K ring, another the V ring, so
// neither ring's next load waits behind the other's.  Above
// D = 512 the contraction runs in passes of 512 columns (Q reloaded per pass
// and key block) and the grid's third dimension holds groups of 512 columns
// of O, each recomputing S: no repo model has such a head.
//
// Split-KV: where the grid would leave most of the card idle (few heads,
// short Sq, decode), or a causal grid is one wave whose longest tiles would
// run alone at its end, the wrapper asks for `splits` key ranges
// (ops/attention.py:_wide_splits states the rule) and every query tile cuts
// its own key blocks into ranges of ceil(the longest tile's blocks /
// splits) (tile_ranges, hopper_pipeline.cuh).  A tile of one range writes O
// directly; in a tile of more, each range's CTA writes its O (normalised
// over its keys, f32) and lse to scratch and combine_splits_kernel merges
// them: one more launch.
//
// Bound at B=2, S=2048, H=2, D=512, causal: 17.2 GFLOP, 0.0174 ms at 989
// TFLOP/s, against 8.4 MB of q/k/v/O/lse, 0.0025 ms at 3.35 TB/s.  A
// 64-row tile moves K and V (128 KB a block of 64 keys at D=512) into shared
// memory for 8.4 MFLOP, and its wgmma read Q, K, V and the exchange from
// there: shared-memory traffic is the likely limit (a variant that
// multicast each K and V stage to a 2-CTA cluster, halving the L2 reads,
// ran slower: PERF.md, section 6).  The longest causal tile (all 2048 keys)
// alone takes 0.036 ms at one SM's share of the peak rate.  No ping-pong: a
// second S in registers beside O (128 f32 at W=256), S and P does not fit
// the consumers' 240 registers.
// ---------------------------------------------------------------------------
constexpr int kWideRows = 64;       // query rows per CTA: both consumers
constexpr int kWideBlockK = 64;     // keys per key block
constexpr int kWideCtaCols = 512;   // most O columns of one CTA: 2 x 256

template <int W>
struct WideCfg {
  static constexpr int kBoxes = W / kBoxCols;            // O boxes per consumer
  static constexpr int kPassBoxes = 2 * kBoxes;          // Q/K boxes per pass
  static constexpr int kQBoxBytes = kWideRows * 128;     // 8 KB
  static constexpr int kKVBoxBytes = kWideBlockK * 128;  // 8 KB
  static constexpr int kKStageBytes = kPassBoxes * kKVBoxBytes;
  static constexpr int kKStages = W == 192 ? 2 : 1;
  static constexpr int kKOffset = kPassBoxes * kQBoxBytes;
  static constexpr int kVOffset = kKOffset + kKStages * kKStageBytes;
  static constexpr int kXOffset = kVOffset + kPassBoxes * kKVBoxBytes;
  static constexpr int kXBytes = kWideRows * kWideBlockK * 4;  // one partial S
  static constexpr int kBarOffset = kXOffset + 2 * kXBytes;
  // tiles, 1024 bytes to align the base for the swizzle, the mbarriers
  static constexpr int kSmemBytes = kBarOffset + 1024 + 8 * (2 * kKStages + 4);
  static_assert(kSmemBytes <= 232448, "a CTA has 227 KB of shared memory");
};

template <int W, bool kBf16>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wide_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      uint16_t* __restrict__ o, float* __restrict__ lse,
                      float* __restrict__ o_part, float* __restrict__ lse_part,
                      int B, int H, int Sq, int Sk, int D, int splits,
                      int64_t o_sb, int64_t o_ss, int64_t o_sh, int causal,
                      int kv_offset, float scale_log2) {
  using C = WideCfg<W>;
  constexpr int NB = C::kBoxes;
  constexpr int PB = C::kPassBoxes;
  constexpr int KS = C::kKStages;
  constexpr int BK = kWideBlockK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms 1024-aligned
  float* const xch = reinterpret_cast<float*>(smem_raw + (base - raw) + C::kXOffset);
  const uint32_t q_s = base;
  const uint32_t k_ring = base + C::kKOffset;
  const uint32_t v_s = base + C::kVOffset;
  // q_full, q_empty, k_full[KS], k_empty[KS], v_full, v_empty
  const uint32_t q_full = base + C::kBarOffset;
  const uint32_t q_empty = q_full + 8;
  const uint32_t k_full = q_empty + 8;
  const uint32_t k_empty = k_full + 8 * KS;
  const uint32_t v_full = k_empty + 8 * KS;
  const uint32_t v_empty = v_full + 8;

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
  const int nbox = (D + kBoxCols - 1) / kBoxCols;  // boxes of the contraction
  const int passes = (nbox + PB - 1) / PB;
  const bool q_once = passes == 1;  // Q resident for the whole key loop
  // This range's key blocks, within those any row of the tile may see.
  const int kb0 = split * ranges.per;
  const int nkb = max(0, min(kb0 + ranges.per, ranges.blocks) - kb0);
  // O boxes of this CTA that start below D: only those are loaded
  const int vboxes = min(PB, (D - col0 + kBoxCols - 1) / kBoxCols);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, kEmptyArrivals);
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, kEmptyArrivals);
    }
    mbar_init(v_full, 1);
    mbar_init(v_empty, kEmptyArrivals);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup, broadcast from lane 0 so that ptxas knows it is uniform:
  // the consumers' branches around wgmma (their boxes, chunks, units)
  // derive from it, and a branch it cannot prove uniform serialises wgmma
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (wg == 0) {
    // ---------------- producers: lane 0 of warp 0 loads Q and fills the K
    // ring, lane 0 of warp 1 fills the V ring, each in its own order -------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs) : "memory");
    if (threadIdx.x == 0 && nkb > 0) {
      prefetch_map(&tm_q);
      prefetch_map(&tm_k);
      int qi = 0;  // Q loads
      int ki = 0;  // K stages filled, over (key block, pass)
      for (int j = 0; j < nkb; ++j) {
        const int k0 = (kb0 + j) * BK;
        for (int p = 0; p < passes; ++p, ++ki) {
          const int x0 = p * PB;
          const int pb = min(PB, nbox - x0);
          if (!q_once || j == 0) {
            mbar_wait(q_empty, (qi & 1) ^ 1);  // the last pass released Q
            mbar_expect_tx(q_full, pb * C::kQBoxBytes);
            for (int x = 0; x < pb; ++x)
              tma_load(q_s + x * C::kQBoxBytes, &tm_q, q_full, (x0 + x) * kBoxCols,
                       q0, h, b);
            ++qi;
          }
          const int s = ki % KS;
          mbar_wait(k_empty + 8 * s, ((ki / KS) & 1) ^ 1);  // stage released
          mbar_expect_tx(k_full + 8 * s, pb * C::kKVBoxBytes);
          const uint32_t ks = k_ring + s * C::kKStageBytes;
          for (int x = 0; x < pb; ++x)
            tma_load(ks + x * C::kKVBoxBytes, &tm_k, k_full + 8 * s,
                     (x0 + x) * kBoxCols, k0, h, b);
        }
      }
    } else if (threadIdx.x == 32 && nkb > 0) {
      prefetch_map(&tm_v);
      for (int j = 0; j < nkb; ++j) {
        mbar_wait(v_empty, (j & 1) ^ 1);
        mbar_expect_tx(v_full, vboxes * C::kKVBoxBytes);
        for (int x = 0; x < vboxes; ++x)
          tma_load(v_s + x * C::kKVBoxBytes, &tm_v, v_full, col0 + x * kBoxCols,
                   (kb0 + j) * BK, h, b);
      }
    }
  } else {
    // ---------------- consumers: the tile's 64 rows, W columns each ------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs) : "memory");
    const int c = wg - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane / 4;
    const int t = lane % 4;
    const int r0 = q0 + 16 * warp + g;  // this thread's rows: r0, r0 + 8
    const int my_col0 = col0 + c * W;   // this consumer's first column of O
    const bool has_cols = my_col0 < D;
    float4* const x_own = reinterpret_cast<float4*>(xch) + c * (C::kXBytes / 16);
    const float4* const x_other =
        reinterpret_cast<const float4*>(xch) + (1 - c) * (C::kXBytes / 16);

    float acc[W / 2];
#pragma unroll
    for (int i = 0; i < W / 2; ++i) acc[i] = 0.f;
    float m[2] = {kNegInf, kNegInf};  // running max of the raw logits
    float l[2] = {0.f, 0.f};          // this thread's share of the row sums

    int qi = 0;  // Q loads consumed
    int ki = 0;  // K stages consumed
    for (int j = 0; j < nkb; ++j) {
      const int k0 = (kb0 + j) * BK;

      // Partial S = Q K^T over this consumer's boxes of each pass: 4 k-steps
      // of 16 per 64-column box.
      float sc[BK / 2];
      int started = 0;
      for (int p = 0; p < passes; ++p, ++ki) {
        const int pb = min(PB, nbox - p * PB);
        const int hb = (pb + 1) / 2;
        const int xa = c * hb;
        const int xb = min(pb, xa + hb);
        if (!q_once || j == 0) {
          mbar_wait(q_full, qi & 1);
          ++qi;
        }
        const int s = ki % KS;
        mbar_wait(k_full + 8 * s, (ki / KS) & 1);
        const uint32_t ks = k_ring + s * C::kKStageBytes;
        if (xa < xb) {
          pin(sc);
          wgmma_fence();
          for (int x = xa; x < xb; ++x) {
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              wgmma_ss<BK, kBf16>(sc, smem_desc(q_s + x * C::kQBoxBytes + kk * 32, 16, 1024),
                                  smem_desc(ks + x * C::kKVBoxBytes + kk * 32, 16, 1024),
                                  started | (kk > 0));
            started = 1;
          }
          wgmma_commit();
          wgmma_wait<0>();
          pin(sc);
        }
        __syncwarp();
        if (lane == 0) {
          mbar_arrive(k_empty + 8 * s);  // release the K stage
          if (!q_once) mbar_arrive(q_empty);
        }
      }
      if (!started) {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
      }

      // The exchange: S = consumer 0's partial + consumer 1's, the same sum
      // (IEEE addition commutes) in both.  Barrier 1: the other consumer has
      // read this one's last partial; barrier 2: both partials are written.
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

      // O[:, my columns] += P V[:, my columns]: BK/16 k-steps of 16 keys, P
      // from the S accumulator, V MN-major over this consumer's boxes.
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        pa[kk][0] = pack2<kBf16>(sc[8 * kk + 0], sc[8 * kk + 1]);
        pa[kk][1] = pack2<kBf16>(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[kk][2] = pack2<kBf16>(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[kk][3] = pack2<kBf16>(sc[8 * kk + 6], sc[8 * kk + 7]);
      }
      mbar_wait(v_full, j & 1);
      if (has_cols) {
        const uint32_t vs = v_s + c * NB * C::kKVBoxBytes;
        pin(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_rs<W, kBf16>(acc, pa[kk],
                             smem_desc(vs + kk * 16 * 128, C::kKVBoxBytes, 1024));
        wgmma_commit();
        wgmma_wait_all();
        pin(acc);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(v_empty);  // release the V stage
    }

    // Epilogue from registers: O / l at this consumer's columns below D (in
    // the input type, or f32 to this split's slot of o_part); consumer 0 of
    // the first column group writes lse.
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
      const bool writes_lse = c == 0 && t == 0 && col0 == 0;
      if (row < Sq && !part) {
        uint16_t* const orow = o + b * o_sb + row * o_ss + h * o_sh;
#pragma unroll
        for (int n = 0; n < W / 8; ++n) {
          const int col = my_col0 + 8 * n + 2 * t;
          if (col < D)
            *reinterpret_cast<uint32_t*>(orow + col) =
                pack2<kBf16>(acc[4 * n + 2 * i] * inv, acc[4 * n + 2 * i + 1] * inv);
        }
        if (writes_lse) lse[(static_cast<int64_t>(b) * Sq + row) * H + h] = row_lse;
      } else if (row < Sq) {
        const int64_t r = ((static_cast<int64_t>(split) * B + b) * Sq + row) * H + h;
        float* const orow = o_part + r * D;
#pragma unroll
        for (int n = 0; n < W / 8; ++n) {
          const int col = my_col0 + 8 * n + 2 * t;
          if (col < D)
            *reinterpret_cast<float2*>(orow + col) =
                make_float2(acc[4 * n + 2 * i] * inv, acc[4 * n + 2 * i + 1] * inv);
        }
        if (writes_lse) lse_part[r] = row_lse;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Host side: tensor maps and the launch.
// ---------------------------------------------------------------------------

// setmaxnreg moves registers within the CTA's pool: the consumers' 240 are
// only there if the launch reserves 24*128 + 240*256 = 168 * 384.
constexpr int kLaunchRegs = kProducerRegs * 128 + kConsumerRegs * 256;

// The tile of D columns at head dim d (d <= D, a multiple of 8).
template <int D, bool kBf16>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int Sq, int Sk, int H, int d, const int64_t* st,
                   int causal, int kv_offset, float sm_scale,
                   cudaStream_t stream) {
  using C = Cfg<D>;
  CUtensorMap mq, mk, mv;
  if (!encode_map(&mq, q, kBf16, B, Sq, H, d, st, kBlockQ, C::kBoxCols) ||
      !encode_map(&mk, k, kBf16, B, Sk, H, d, st + 3, C::kBlockK, C::kBoxCols) ||
      !encode_map(&mv, v, kBf16, B, Sk, H, d, st + 6, C::kBlockK, C::kBoxCols))
    return cudaErrorInvalidValue;
  auto* kernel = flash_fwd_kernel<D, kBf16>;
  constexpr int smem = C::kSmemBytes;
  cudaError_t err = configure_once(reinterpret_cast<const void*>(kernel), smem,
                                   kLaunchRegs, kThreads);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Sq + kBlockQ - 1) / kBlockQ);
  kernel<<<grid, kThreads, smem, stream>>>(
      mq, mk, mv, static_cast<uint16_t*>(o), lse, H, Sq, Sk, d, st[9], st[10],
      st[11], causal, kv_offset, sm_scale * kLog2e);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_typed(bool bf16, const void* q, const void* k, const void* v,
                         void* o, float* lse, int B, int Sq, int Sk, int H, int d,
                         const int64_t* st, int causal, int kv_offset,
                         float sm_scale, cudaStream_t s) {
  return bf16 ? launch<D, true>(q, k, v, o, lse, B, Sq, Sk, H, d, st, causal,
                                kv_offset, sm_scale, s)
              : launch<D, false>(q, k, v, o, lse, B, Sq, Sk, H, d, st, causal,
                                 kv_offset, sm_scale, s);
}

// The narrowest tile that holds head dim d (a multiple of 8, at most 256).
cudaError_t launch_tile(bool bf16, const void* q, const void* k, const void* v,
                        void* o, float* lse, int B, int Sq, int Sk, int H, int d,
                        const int64_t* st, int causal, int kv_offset, float sm_scale,
                        cudaStream_t s) {
  if (d <= 0 || d % 8 != 0 || d > kMaxTile) return cudaErrorInvalidValue;
  if (d <= 32)
    return launch_typed<32>(bf16, q, k, v, o, lse, B, Sq, Sk, H, d, st, causal,
                            kv_offset, sm_scale, s);
  if (d <= 64)
    return launch_typed<64>(bf16, q, k, v, o, lse, B, Sq, Sk, H, d, st, causal,
                            kv_offset, sm_scale, s);
  if (d <= 96)
    return launch_typed<96>(bf16, q, k, v, o, lse, B, Sq, Sk, H, d, st, causal,
                            kv_offset, sm_scale, s);
  if (d <= 128)
    return launch_typed<128>(bf16, q, k, v, o, lse, B, Sq, Sk, H, d, st, causal,
                             kv_offset, sm_scale, s);
  if (d <= 192)
    return launch_typed<192>(bf16, q, k, v, o, lse, B, Sq, Sk, H, d, st, causal,
                             kv_offset, sm_scale, s);
  return launch_typed<256>(bf16, q, k, v, o, lse, B, Sq, Sk, H, d, st, causal,
                           kv_offset, sm_scale, s);
}

// The wide kernel with W columns of O per consumer, then, over `splits` key
// ranges, the combine.
template <int W, bool kBf16>
cudaError_t launch_wide_w(const CUtensorMap& mq, const CUtensorMap& mk,
                          const CUtensorMap& mv, void* o, float* lse,
                          float* scratch, int B, int Sq, int Sk, int H, int D,
                          int splits, const int64_t* st, int causal,
                          int kv_offset, float sm_scale, cudaStream_t stream) {
  auto* kernel = flash_fwd_wide_kernel<W, kBf16>;
  constexpr int smem = WideCfg<W>::kSmemBytes;
  cudaError_t err = configure_once(reinterpret_cast<const void*>(kernel), smem,
                                   kLaunchRegs, kThreads);
  if (err != cudaSuccess) return err;
  const int tiles = (Sq + kWideRows - 1) / kWideRows;
  const int groups = (D + 2 * W - 1) / (2 * W);
  if (tiles > 65535 || groups * splits > 65535) return cudaErrorInvalidValue;
  float* const o_part = splits > 1 ? scratch : nullptr;
  float* const lse_part =
      splits > 1 ? scratch + static_cast<int64_t>(splits) * B * Sq * H * D : nullptr;
  kernel<<<dim3(B * H, tiles, groups * splits), kThreads, smem, stream>>>(
      mq, mk, mv, static_cast<uint16_t*>(o), lse, o_part, lse_part, B, H, Sq, Sk,
      D, splits, st[9], st[10], st[11], causal, kv_offset, sm_scale * kLog2e);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  return launch_combine<kBf16 ? kOutBf16 : kOutFp16>(o_part, lse_part, o, lse, B, Sq, Sk,
                                                     H, D, splits, causal, kv_offset,
                                                     kWideRows, kWideBlockK, st, stream);
}

// The wide route at D, a multiple of 8.
template <bool kBf16>
cudaError_t launch_wide(const void* q, const void* k, const void* v, void* o,
                        float* lse, float* scratch, int B, int Sq, int Sk, int H,
                        int D, const int64_t* st, int causal, int kv_offset,
                        float sm_scale, int splits, cudaStream_t stream) {
  if (D <= 0 || D % 8 != 0 || splits < 1 || splits > kMaxSplits ||
      (splits > 1 && scratch == nullptr))
    return cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv;
  if (!encode_map(&mq, q, kBf16, B, Sq, H, D, st, kWideRows) ||
      !encode_map(&mk, k, kBf16, B, Sk, H, D, st + 3, kWideBlockK) ||
      !encode_map(&mv, v, kBf16, B, Sk, H, D, st + 6, kWideBlockK))
    return cudaErrorInvalidValue;
  if (D <= 384)
    return launch_wide_w<192, kBf16>(mq, mk, mv, o, lse, scratch, B, Sq, Sk, H, D,
                                     splits, st, causal, kv_offset, sm_scale, stream);
  return launch_wide_w<256, kBf16>(mq, mk, mv, o, lse, scratch, B, Sq, Sk, H, D,
                                   splits, st, causal, kv_offset, sm_scale, stream);
}

}  // namespace

// C entry point, loaded with ctypes.  `strides` holds 12 element strides:
// (batch, seq, head) for q, k, v and o, in that order; the head_dim stride
// is 1, every other stride a multiple of 8 and every base 16-byte aligned.
// `wide` = 0: D is a multiple of 8 up to 256, run on the narrowest tile
// that holds it; `wide` = 1: the wide route at D, a
// multiple of 8 (the wrapper takes it above 256), over `splits` key ranges
// (1 to 16; above 1 the split partials go to `scratch`, which holds
// tos_flash_attn_fwd_scratch_bytes(...) bytes, 16-byte aligned, and a
// combine kernel follows); dtype: 0 = bf16, 1 = fp16.  Returns
// cudaGetLastError() after the launches (0 on success), or
// cudaErrorInvalidValue for an input it does not take or a tensor map
// cuTensorMapEncodeTiled refuses.  Launches on `stream`, does not
// synchronise, and allocates nothing.
extern "C" int tos_flash_attn_fwd(const void* q, const void* k, const void* v,
                                  void* o, void* lse, void* scratch, int B,
                                  int Sq, int Sk, int H, int D,
                                  const int64_t* strides, int causal,
                                  int kv_offset, float sm_scale, int wide,
                                  int splits, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0) return 0;  // nothing to launch
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  float* sc = static_cast<float*>(scratch);
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  const bool bf16 = dtype == 0;
  cudaError_t err;
  if (wide) {
    err = bf16 ? launch_wide<true>(q, k, v, o, l, sc, B, Sq, Sk, H, D, strides,
                                   causal, kv_offset, sm_scale, splits, s)
               : launch_wide<false>(q, k, v, o, l, sc, B, Sq, Sk, H, D, strides,
                                    causal, kv_offset, sm_scale, splits, s);
  } else {
    err = launch_tile(bf16, q, k, v, o, l, B, Sq, Sk, H, D, strides, causal,
                      kv_offset, sm_scale, s);
  }
  return static_cast<int>(err);
}

// Bytes of scratch a launch needs: on the wide route over more than one key
// range, the ranges' O (f32) and lse; else 0.
extern "C" int64_t tos_flash_attn_fwd_scratch_bytes(int B, int Sq, int Sk, int H,
                                                    int D, int wide, int splits) {
  (void)Sk;
  if (!wide || splits <= 1) return 0;
  return 4 * static_cast<int64_t>(splits) * B * Sq * H * (D + 1);
}

// Dynamic shared memory of one CTA: `wide` = 0, the tile of D columns (32,
// 64, 96, 128, 192 or 256); `wide` = 1, the wide kernel's with D columns of
// O per consumer (192 or 256); else 0.
extern "C" int tos_flash_attn_fwd_smem_bytes(int D, int wide) {
  if (wide)
    return D == 192 ? WideCfg<192>::kSmemBytes
           : D == 256 ? WideCfg<256>::kSmemBytes
                      : 0;
  return D == 32 ? Cfg<32>::kSmemBytes
         : D == 64 ? Cfg<64>::kSmemBytes
         : D == 96 ? Cfg<96>::kSmemBytes
         : D == 128 ? Cfg<128>::kSmemBytes
         : D == 192 ? Cfg<192>::kSmemBytes
         : D == 256 ? Cfg<256>::kSmemBytes
                    : 0;
}

// Most columns of O one CTA of the wide route covers; a wider head runs
// column groups of this many, each recomputing S.
extern "C" int tos_flash_attn_fwd_cta_cols() { return kWideCtaCols; }
