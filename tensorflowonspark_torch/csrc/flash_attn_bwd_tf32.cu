// Flash-attention backward for f32 inputs on Hopper's tensor cores (sm_90a):
// dQ, dK and dV of attention from the forward's saved row log-sum-exp, each
// f32 product as three TF32 wgmma (3xTF32), at head dims up to 128.
//
// Replaces, for f32 inputs, the gradient of the TPU kernel
// tensorflowonspark_tpu/ops/attention.py: _flash_fwd_kernel (launched by
// _flash_fwd_pallas through pl.pallas_call): its custom_vjp
// _flash_attention_tpu has no Pallas backward, and its _flash_bwd_rule
// (:299) recomputes through blockwise_attention.  The contract is
// flash_attn_bwd.cu's, in f32:
//   q [B,Sq,H,D], k/v [B,Sk,H,D], dO [B,Sq,H,D] in f32 with unit stride
//   along D, lse and its cotangent g_lse [B,Sq,H] in f32 -> dq [B,Sq,H,D],
//   dk/dv [B,Sk,H,D] in f32;
//   key j sits at global position kv_offset + j; the causal mask keeps
//   kv_offset + j <= i; a row whose lse is NEG_INF (every key masked) has
//   P = 0 and so contributes nothing and gets dq = 0.
//
// The arithmetic (FA2 with the exact Delta; ops/attention.py:
// flash_attn_bwd_reference is the plain version):
//   P = exp(S * scale - lse), S = Q K^T;  dP = dO V^T
//   Delta_i = sum_j P_ij dP_ij - g_lse_i     (d lse / d s = P: the lse
//                                             cotangent folds in here)
//   dS = P o (dP - Delta);  dV = P^T dO;  dK = scale * dS^T Q;  dQ = scale * dS K
// Delta is the f32 sum of P o dP from a walk of its own, as in the bf16/fp16
// kernels (flash_attn_bwd.cu): one definition of Delta across types.
//
// Precision.  TF32 keeps 10 mantissa bits, about 2^-11 a product: too
// coarse for the f32 gate (1e-4 relative L2 against the f32 plain version).
// Each operand is split x = hi + lo (wgmma_tf32.cuh: hi = x with its low 13
// mantissa bits cleared, lo = tf32(x - hi), rounded to nearest), and a.b ~
// a_lo.b_hi + a_hi.b_lo + a_hi.b_hi (the lo.lo term, ~2^-20 of a.b,
// dropped; the small terms issued first), so a product is good to about
// 2^-20 relative.  The tensor cores read only the upper 19 bits of a .tf32
// operand, so a raw f32 tile in shared memory is its own hi part; only lo
// needs a plane of its own.
//
// Centring.  That error is relative to |k| and |v|, and where a head's keys
// and values share a large common component (a trained LM's do), the
// gradient lives in what is left after the component cancels: dP - Delta
// and sum_j dS_ij k_j.  With a component 4x the rest, 3xTF32 on the raw K
// and V puts dq about 6e-5 off the f32 gradient, within a factor 2 of the
// gate (tests/test_torch_attention_bwd.py, the centring test's case).  So
// the kernels work on K' = K - m_k and V' = V - m_v, m the head's mean key
// and value: S' = Q K'^T is S less the row constant q_i.m_k, folded into
// the row's lse in f32 (lse' = lse - scale q_i.m_k, by the delta kernel);
// dP' = dO V'^T is dP less the row constant dO_i.m_v, which the Delta of
// the same dP' cancels in dS; dQ = scale (dS K' + m_k sum_j dS_ij), the
// last term in f32 (sum_j dS_ij is g_lse_i, zero without an lse
// cotangent).  dK = scale dS^T Q and dV = P^T dO do not see the shift.
//
// Bound at the f32 LM step's shape (B=2, S=2048, H=8, D=128, causal): the
// function's five products over the live pairs are 10*B*H*D*S(S+1)/2 =
// 42.9 GFLOP, 0.0868 ms at the card's 495 TFLOP/s of dense TF32, against
// about 118 MB of q, k, v, dO, lse, dq, dk, dv (0.035 ms at 3.35 TB/s):
// bound by the tensor cores.  This design runs nine products (S and dP in
// each of its three walks), each as three TF32 products: 27/5 of the
// function's, 0.469 ms at the peak rate.  So what holds a kernel back is
// how busy it keeps the tensor cores: loads in flight while they work, and
// no operand split or shuffled again where it can be read as it lies.
//
// Layout.  A .tf32 wgmma reads its shared-memory operands only K-major, and
// the backward contracts over queries (dV = P^T dO, dK = dS^T Q) and over
// keys (dQ = dS K), so Q, dO and K would be read MN-major.  The kernels
// compute the transposed gradients instead:
//   dV^T = dO^T P,  dK^T = Q^T dS,  dQ^T = K'^T dS^T.
// The MN-major side is then the A operand, which a wgmma takes from
// registers: each thread loads its fragment from the raw tile already in
// the ring by 32-bit loads, its hi part the raw bits and its lo part from
// the tile's lo plane.  The other side, P or dS, is the B operand: the
// consumer that computed it writes it (raw and lo) into shared memory in
// the K-major, 128-byte-swizzled layout wgmma reads, as FA2 and FA3 write
// dS.  No transposed copy goes through device memory.  The products over D
// (S, dP) read the streamed operand as B (raw, and its lo plane), and the
// resident one as A, its fragments loaded from the raw tile and split in
// registers.  D lies on the transposed products' M: a tile of 32 or 96
// columns fills its last m64 block half, and the rows past D are zero A
// fragments whose results are not stored.
//
// Design: two pre-pass kernels and three warp-specialised walks, queued by
// one call of tos_flash_attn_bwd_tf32.  A walk's CTA is a producer
// warpgroup, whose one thread issues every TMA load after setmaxnreg.dec to
// 24 registers, and two consumer warpgroups at 240 registers; it holds 64
// rows, and both consumers span all of them (wgmma's M is 64).  The
// streamed tiles come through a ring of kStages stages, each guarded by a
// "full" mbarrier (TMA transaction bytes) and an "empty" one (one arrival
// per warp of the consumers that read it); the resident tiles come by TMA
// once.  A product over D loads its A fragments a few k-steps at a time
// into two register sets by turns, so that the loads of one chunk overlap
// the wgmma of the chunk before.
// - flash_bwd_tf32_center_kernel: one CTA per (batch*head, 32 columns), the
//   head's mean key and value over Sk, in a fixed order, into the scratch.
// - flash_bwd_tf32_split_kernel (z = 0): K' = K - m_k and V' = V - m_v, and
//   their lo planes, [B, H, Sk, D] each; (z = 1): the lo planes of Q and dO,
//   [B, H, Sq, D].  The walks read these planes (and q and dO themselves,
//   through the caller's strides) by TMA.
// - flash_bwd_tf32_delta_kernel: one CTA per (batch*head, 64 query rows), Q
//   and dO resident; the producer streams the K', K'_lo, V' and V'_lo tiles
//   of kInner keys up to the last key the CTA's rows may see, and the two
//   consumers take them by turns (consumer c the tiles c, c + 2, ...), each
//   running S' = Q K'^T and dP' = dO V'^T, P (from lse') and its share of
//   sum P o dP' in f32; consumer 0 adds consumer 1's share to its own (the
//   same order every run).  Delta and lse' * log2(e) (+inf on a fully
//   masked row or past Sq, so that exp2 gives P = 0 there) go to the
//   scratch, f32 [B*H, scratch_rows(Sq)].
// - flash_bwd_tf32_dkdv_kernel: one CTA per (batch*head, 64 keys), K' and
//   V' resident; the producer streams, per query tile of kInner rows from
//   the first one the causal mask and kv_offset let see the CTA's keys, Q,
//   Q_lo, dO, dO_lo and the tile's Delta and lse' * log2(e).  Here the
//   consumers split each tile's products (dV^T and dK^T do not both fit
//   one warpgroup's registers): consumer 0 runs S'^T = K' Q^T, P^T, writes
//   P^T and runs dV^T += dO^T P; consumer 1 runs dP'^T = V' dO^T, reads
//   P^T, forms dS^T = P^T o (dP'^T - Delta), writes it and runs dK^T +=
//   Q^T dS; they meet at named barriers.  A key block no query sees writes
//   zeros.
// - flash_bwd_tf32_dq_kernel: the delta kernel's walk again, each consumer
//   forming dS = P o (dP' - Delta) on its tiles, writing it and running
//   dQ^T += K'^T dS^T over the CTA's queries into its own accumulator;
//   consumer 0 adds consumer 1's.  dQ is computed apart, not by atomics
//   from the dK/dV kernel: every gradient is the same bit for bit from run
//   to run.
// Under the causal mask the longest CTAs go first: the dK/dV kernel's early
// keys (blockIdx order), the query kernels' late rows (blockIdx reversed);
// the mask is applied only on tiles that straddle the diagonal or the Sk
// tail.  Every walk waits for its wgmma at the end of each tile, as the
// bf16/fp16 kernels do: letting the next tile's loads run under them made
// the walks slower on the card (PERF.md §6).
//
// Budget (the tiling was chosen from it).  A tile of R rows at D columns is
// R * D * 4 bytes, in boxes of 32 columns; the loop tile kInner is 64 rows
// up to 64 columns and 32 above.  Shared memory at D=128 (kInner 32, 2
// stages): the delta walk's resident Q and dO 64 KB and a stage (K', K'_lo,
// V', V'_lo) 64 KB: 192 KB; the dQ walk's dS and dS_lo of each consumer 32
// KB more: 224 KB; the dK/dV walk's resident K' and V' 64 KB, a stage (Q,
// Q_lo, dO, dO_lo, Delta and lse') 64.25 KB, P^T, P^T_lo, dS^T and dS^T_lo
// 32 KB: 224.5 KB; all one CTA an SM.  At D=32 (kInner 64, 4 stages): 16 KB
// resident, 32 KB a stage, the dS or P^T/dS^T planes 64 KB: delta 144 KB,
// dQ 208 KB, dK/dV 211 KB.  Registers of a consumer thread at D=128: the
// tile's accumulators (64 x 32: 16 each), dV^T or dK^T (D x 64 keys: 64)
// or dQ^T (D x 64 queries: 64), the A fragments of a product over D (two
// sets of kChunk k-steps, hi and lo: 64) or of a transposed one (64):
// about 180 of 240; at D=32 (tile 64 x 64: 32 each) about 170.  The pre-pass's
// planes are 4 * B*H*Sk*D + 2 * B*H*Sq*D floats (101 MB at the f32 LM
// step's shape, written once and read by TMA from L2 and memory).
// The kernels allocate nothing.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (tensorflowonspark_torch/ops/cuda_build.py does it).

#include "hopper_pipeline.cuh"
#include "wgmma_tf32.cuh"

namespace {

constexpr int kThreads = 384;        // producer + two consumer warpgroups
constexpr int kCtaRows = 64;         // the rows a CTA holds (ops/attention.py:BWD_TF32_CTA_ROWS)
constexpr int kWgRows = 64;          // the rows each consumer's products span (BWD_TF32_WG_ROWS)
constexpr int kEmptyArrivals = 8;    // one per consumer warp
constexpr int kProducerRegs = 24;    // setmaxnreg: 128 * 24 + 256 * 240
constexpr int kConsumerRegs = 240;   //   = 64,512 <= 65,536 registers
constexpr int kLaunchRegs = kProducerRegs * 128 + kConsumerRegs * 256;
// k-steps of A fragments a product over D loads at once, into one of two
// register sets: one chunk's loads overlap the wgmma of the chunk before
constexpr int kChunk = 4;
// the scratch's rows per batch*head: flash_attn_bwd.cu's (Sq rounded up to
// 128, ops/attention.py:bwd_scratch_rows), so one allocation serves both
constexpr int kScratchAlign = 128;
constexpr int kCenterCols = 32;      // columns a CTA of the center kernel sums
constexpr int kCenterThreads = 1024;  // 32 warps, each over every 32nd row
constexpr int kSplitThreads = 256;   // a thread per four columns of a row
// named barriers of the two consumers (0 is __syncthreads)
constexpr int kBarReady = 1;  // dK/dV: P^T written; query walks: the partial sums handed over
constexpr int kBarFree = 2;   // dK/dV: P^T read
constexpr int kBarDs = 3;     // dS written (the query walks: consumer c's, 3 + c)

static_assert(kWgRows == kCtaRows, "both consumers span the CTA's rows");

inline int scratch_rows(int Sq) {
  const int s = Sq > 0 ? Sq : 1;
  return (s + kScratchAlign - 1) / kScratchAlign * kScratchAlign;
}

template <int DT>
struct Tf32BwdTile {
  static_assert(DT == 32 || DT == 64 || DT == 96 || DT == 128, "the backward's tiles");
  // the loop tile: query rows a step of the dK/dV kernel, key rows a step of
  // the delta and dQ kernels (ops/attention.py:bwd_tiling)
  static constexpr int kInner = DT <= 64 ? 64 : 32;
  static constexpr int kStages = DT == 32 ? 4 : 2;  // ring depth
  static constexpr int kBoxes = DT / 32;             // 32-column boxes of a tile
  static constexpr int kDSteps = DT / 8;             // k-steps over D
  static constexpr int kISteps = kInner / 8;         // k-steps over the loop tile
  static constexpr int kMBlocks = (DT + 63) / 64;    // m64 blocks of D in the transposed products
  static constexpr int kCtaBoxBytes = kCtaRows * 128;
  static constexpr int kCtaTileBytes = kBoxes * kCtaBoxBytes;      // a resident tile
  static constexpr int kInnerBoxBytes = kInner * 128;
  static constexpr int kInnerTileBytes = kBoxes * kInnerBoxBytes;  // a ring tile
  static constexpr int kStageBytes = 4 * kInnerTileBytes;          // four ring tiles
  static constexpr int kBufBytes = kCtaRows * kInner * 4;  // one 64 x kInner plane (P, dS)
  static constexpr int kStatBytes = 2 * kInner * 4;        // a query tile's Delta, lse2
  static constexpr int kBarBytes = 8 * (2 * kStages + 1);
  static constexpr int kRingOffset = 2 * kCtaTileBytes;
  static constexpr int kPostRing = kRingOffset + kStages * kStageBytes;
  // the query walks: the two resident tiles, the ring, the dQ walk's dS and
  // dS_lo of each consumer, the mbarriers; 1024 bytes to align the base for
  // the swizzle
  static constexpr int kDsOffset = kPostRing;
  static constexpr int kDeltaSmem = kDsOffset + kBarBytes + 1024;
  static constexpr int kDqSmem = kDsOffset + 4 * kBufBytes + kBarBytes + 1024;
  // the dK/dV walk: the two resident tiles, the ring, P^T, P^T_lo, dS^T,
  // dS^T_lo, the stages' Delta and lse2, the mbarriers
  static constexpr int kBufOffset = kPostRing;
  static constexpr int kStatOffset = kBufOffset + 4 * kBufBytes;
  static constexpr int kKvBarOffset = kStatOffset + kStages * kStatBytes;
  static constexpr int kKvSmem = kKvBarOffset + kBarBytes + 1024;
  static_assert(kDeltaSmem <= 232448 && kDqSmem <= 232448 && kKvSmem <= 232448,
                "a CTA has 227 KB of shared memory");
  static constexpr int kMaxSmem = kKvSmem > kDqSmem ? kKvSmem : kDqSmem;
};

struct Tf32BwdParams {
  const float* q;
  const float* k;
  const float* v;
  const float* dout;
  const float* lse;    // [B, Sq, H]
  const float* g_lse;  // [B, Sq, H], may be null
  float* dq;
  float* dk;
  float* dv;
  float* delta;  // [B*H, sq_rows]
  float* lse2;   // [B*H, sq_rows], lse' * log2(e) or +inf
  float* mean;   // [B*H, 2, D]: the head's mean key, then its mean value
  // the pre-pass's planes, [B, H, S, D] each: K', K'_lo, V', V'_lo (Sk
  // rows), Q_lo, dO_lo (Sq rows)
  float* kc;
  float* kc_lo;
  float* vc;
  float* vc_lo;
  float* q_lo;
  float* do_lo;
  int H, Sq, Sk, D, sq_rows;
  // batch, sequence and head strides (elements) of q, k, v, dout, dq, dk, dv
  int64_t st[21];
  int causal, kv_offset;
  float scale, scale_log2;
};

// Float offset of (row r, column c) in a tile of R rows held as 32-column
// boxes of R rows each, with the 128-byte swizzle TMA writes (and wgmma
// reads): the 16-byte chunk c/4 of a 128-byte row is stored at chunk
// (c/4) ^ (r % 8).
template <int R>
__device__ __forceinline__ int sw(int r, int c) {
  return (c >> 5) * (R * 32) + r * 32 + ((((c & 31) >> 2) ^ (r & 7)) << 2) + (c & 3);
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
// Makes this thread's generic-proxy writes to shared memory (P, dS) visible
// to wgmma (the async proxy); a barrier after it publishes them.
__device__ __forceinline__ void proxy_fence() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The tile's 3xTF32 products over k-steps [k0, k0 + NK) (those below
// KSTEPS), B K-major in shared memory (its raw tile b_hi, its lo plane b_lo;
// k-step k at box k / 4, column group k % 4): a_lo b_hi, a_hi b_lo, a_hi
// b_hi.  `overwrite`: the first wgmma overwrites acc.  Issues the wgmma
// only: the caller fences, commits and waits.
template <int N, int NK, int KSTEPS>
__device__ __forceinline__ void rs_steps(float (&acc)[N / 2], const uint32_t (&ah)[NK][4],
                                         const uint32_t (&al)[NK][4], uint32_t b_hi,
                                         uint32_t b_lo, uint32_t box_bytes, int k0,
                                         bool overwrite) {
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    if (k0 + kk < KSTEPS) {
      const uint32_t off = ((k0 + kk) / 4) * box_bytes + ((k0 + kk) % 4) * 32;
      wgmma_rs<N>(acc, al[kk], smem_desc(b_hi + off, 16, 1024), overwrite && kk == 0 ? 0 : 1);
      wgmma_rs<N>(acc, ah[kk], smem_desc(b_lo + off, 16, 1024), 1);
      wgmma_rs<N>(acc, ah[kk], smem_desc(b_hi + off, 16, 1024), 1);
    }
  }
}

// x (64 x N) = A B^T over the DT columns of D, 3xTF32: A the 64 rows of a
// resident raw tile, its fragments loaded and split into hi and lo in
// registers kChunk k-steps at a time, into the register sets ah/al by turns
// (chunk number C0 + c of the caller's sequence, so that products issued one
// after the other keep alternating), B the N rows of a ring tile (raw b_hi,
// lo plane b_lo).  A chunk's loads overlap the wgmma of the chunk before:
// a set is reloaded once the chunk two back has completed.  S = Q K'^T,
// dP = dO V'^T, S^T = K' Q^T, dP^T = V' dO^T.  Ends with the wgmma
// committed, not waited for.
template <int DT, int N, int C0>
__device__ __forceinline__ void product_rows(float (&x)[N / 2], uint32_t (&ah)[2][kChunk][4],
                                             uint32_t (&al)[2][kChunk][4], const float* a_tile,
                                             uint32_t b_hi, uint32_t b_lo, uint32_t box_bytes,
                                             int warp, int g, int t) {
  constexpr int KS = DT / 8, NC = (KS + kChunk - 1) / kChunk;
  pin(x);
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    constexpr int kSets = 2;
    const int set = (C0 + c) % kSets;
    if (C0 + c >= kSets) wgmma_wait<1>();  // the chunk two back has read this set
#pragma unroll
    for (int kk = 0; kk < kChunk; ++kk) {
      const int k = c * kChunk + kk;
      if (k < KS) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // a_e: row 16 warp + g + 8 (e & 1), column 8 k + t + 4 (e >> 1)
          const float v =
              a_tile[sw<kCtaRows>(16 * warp + g + 8 * (e & 1), 8 * k + t + 4 * (e >> 1))];
          const float hi = tf32_hi(v);
          ah[set][kk][e] = __float_as_uint(hi);
          al[set][kk][e] = __float_as_uint(tf32_round(v - hi));
        }
      }
    }
    wgmma_fence();
    rs_steps<N, kChunk, KS>(x, ah[set], al[set], b_hi, b_lo, box_bytes, c * kChunk, c == 0);
    wgmma_commit();
  }
}

// acc[mb] (64 rows of D from 64 mb x N) += X^T B over the loop tile's rows,
// 3xTF32: A = X^T, X a ring tile of kInner rows (raw `raw`, lo plane `lo`),
// its fragments loaded by 32-bit loads (hi the raw bits, lo from the
// plane), zero for rows of D past the tile; B K-major in shared memory (64
// rows a box, N of them from b_hi / b_lo).  dV^T = dO^T P, dK^T = Q^T dS,
// dQ^T = K'^T dS^T.  Ends with the wgmma committed, not waited for.
template <int DT, int N>
__device__ __forceinline__ void product_cols(float (&acc)[Tf32BwdTile<DT>::kMBlocks][N / 2],
                                             const float* raw, const float* lo, uint32_t b_hi,
                                             uint32_t b_lo, int warp, int g, int t) {
  using C = Tf32BwdTile<DT>;
  constexpr int MB = C::kMBlocks, NK = C::kISteps;
  uint32_t ah[MB][NK][4], al[MB][NK][4];
#pragma unroll
  for (int mb = 0; mb < MB; ++mb) {
    const bool in = 64 * mb + 16 * warp < DT;  // the warp's rows of D lie in the tile
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // a_e: row (of D) 64 mb + 16 warp + g + 8 (e & 1), column (a row of
        // X) 8 kk + t + 4 (e >> 1)
        const int off = sw<C::kInner>(8 * kk + t + 4 * (e >> 1),
                                      in ? 64 * mb + 16 * warp + g + 8 * (e & 1) : 0);
        ah[mb][kk][e] = in ? __float_as_uint(tf32_hi(raw[off])) : 0u;
        al[mb][kk][e] = in ? __float_as_uint(lo[off]) : 0u;
      }
    }
  }
#pragma unroll
  for (int mb = 0; mb < MB; ++mb) pin(acc[mb]);
  wgmma_fence();
#pragma unroll
  for (int mb = 0; mb < MB; ++mb)
    rs_steps<N, NK, NK>(acc[mb], ah[mb], al[mb], b_hi, b_lo, kCtaRows * 128, 0, false);
  wgmma_commit();
}

// P (or dS), the 64 x N accumulator x in the wgmma layout (d[4n + e] holds
// row 16 warp + g + 8 (e >> 1), column 8n + 2t + (e & 1)), raw and lo into
// two 64-row swizzled planes, as the B operand of a transposed product.
template <int N>
__device__ __forceinline__ void store_operand(float* hi, float* lo, const float (&x)[N / 2],
                                              int warp, int g, int t) {
#pragma unroll
  for (int n = 0; n < N / 8; ++n) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int off = sw<kCtaRows>(16 * warp + g + 8 * half, 8 * n + 2 * t);
      const float a = x[4 * n + 2 * half], b = x[4 * n + 2 * half + 1];
      *reinterpret_cast<float2*>(hi + off) = make_float2(a, b);
      *reinterpret_cast<float2*>(lo + off) = make_float2(tf32_lo(a), tf32_lo(b));
    }
  }
}

// The m64 blocks of a transposed accumulator (rows of D, N columns of rows
// r0 + 8n + 2t + (e & 1) of one head's slice) times `mul`, plus
// `add_mul` * add_row[c] * add_col[r] where add_row is given, to the rows
// below S and the columns below D of dst (row stride rs).
template <int DT, int N>
__device__ __forceinline__ void store_transposed(
    float* dst, int64_t rs, const float (&acc)[Tf32BwdTile<DT>::kMBlocks][N / 2], float mul,
    int r0, int S, int D, int warp, int g, int t, const float* add_row = nullptr,
    const float* add_col = nullptr) {
#pragma unroll
  for (int mb = 0; mb < Tf32BwdTile<DT>::kMBlocks; ++mb) {
#pragma unroll
    for (int n = 0; n < N / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 64 * mb + 16 * warp + g + 8 * (e >> 1);  // the column of dst
        const int rl = 8 * n + 2 * t + (e & 1);                // the row, from r0
        float val = acc[mb][4 * n + e];
        if (add_row != nullptr && c < D) val = fmaf(add_row[c], add_col[rl], val);
        if (c < D && r0 + rl < S) dst[static_cast<int64_t>(r0 + rl) * rs + c] = val * mul;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The pre-passes.  The head's mean key and value, one CTA per (batch*head,
// 32 columns); warp w sums the rows w, w + 8, ... of its lane's column, and
// the eight partial sums are added in warp order (the same bits every run).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kCenterThreads) flash_bwd_tf32_center_kernel(
    const Tf32BwdParams p) {
  __shared__ float part[2][kCenterThreads / 32][kCenterCols];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int c = blockIdx.y * kCenterCols + lane;
  const int64_t* st = p.st;
  const float* k = p.k + b * st[3] + h * st[5] + c;
  const float* v = p.v + b * st[6] + h * st[8] + c;
  float sk = 0.f, sv = 0.f;
  if (c < p.D) {
    for (int r = warp; r < p.Sk; r += kCenterThreads / 32) {
      sk += k[static_cast<int64_t>(r) * st[4]];
      sv += v[static_cast<int64_t>(r) * st[7]];
    }
  }
  part[0][warp][lane] = sk;
  part[1][warp][lane] = sv;
  __syncthreads();
  if (warp < 2 && c < p.D) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kCenterThreads / 32; ++w) sum += part[warp][w][lane];
    p.mean[static_cast<int64_t>(bh) * 2 * p.D + warp * p.D + c] =
        p.Sk > 0 ? sum / static_cast<float>(p.Sk) : 0.f;
  }
}

__device__ __forceinline__ float4 sub4(float4 x, float4 m) {
  return make_float4(x.x - m.x, x.y - m.y, x.z - m.z, x.w - m.w);
}
__device__ __forceinline__ float4 lo4(float4 x) {
  return make_float4(tf32_lo(x.x), tf32_lo(x.y), tf32_lo(x.z), tf32_lo(x.w));
}

// The planes the walks read by TMA, a thread per four columns of a row:
// blockIdx.z = 0, K' = K - m_k, K'_lo, V' = V - m_v, V'_lo over the Sk
// rows; 1, Q_lo and dO_lo over the Sq rows.  Grid (rows * D / 4 / 256, B*H,
// 2).
__global__ void __launch_bounds__(kSplitThreads) flash_bwd_tf32_split_kernel(
    const Tf32BwdParams p) {
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int quads = p.D / 4;
  const bool keys = blockIdx.z == 0;
  const int rows = keys ? p.Sk : p.Sq;
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * kSplitThreads + threadIdx.x;
  if (idx >= static_cast<int64_t>(rows) * quads) return;
  const int r = static_cast<int>(idx / quads), c = static_cast<int>(idx % quads) * 4;
  const int64_t at = (static_cast<int64_t>(bh) * rows + r) * p.D + c;
  const int64_t* st = p.st;
  if (keys) {
    const float* m = p.mean + static_cast<int64_t>(bh) * 2 * p.D + c;
    const float4 mk = *reinterpret_cast<const float4*>(m);
    const float4 mv = *reinterpret_cast<const float4*>(m + p.D);
    const float4 k = sub4(*reinterpret_cast<const float4*>(p.k + b * st[3] + r * st[4] +
                                                           h * st[5] + c), mk);
    const float4 v = sub4(*reinterpret_cast<const float4*>(p.v + b * st[6] + r * st[7] +
                                                           h * st[8] + c), mv);
    *reinterpret_cast<float4*>(p.kc + at) = k;
    *reinterpret_cast<float4*>(p.kc_lo + at) = lo4(k);
    *reinterpret_cast<float4*>(p.vc + at) = v;
    *reinterpret_cast<float4*>(p.vc_lo + at) = lo4(v);
  } else {
    const float4 q = *reinterpret_cast<const float4*>(p.q + b * st[0] + r * st[1] +
                                                      h * st[2] + c);
    const float4 o = *reinterpret_cast<const float4*>(p.dout + b * st[9] + r * st[10] +
                                                      h * st[11] + c);
    *reinterpret_cast<float4*>(p.q_lo + at) = lo4(q);
    *reinterpret_cast<float4*>(p.do_lo + at) = lo4(o);
  }
}

// ---------------------------------------------------------------------------
// dK and dV: one CTA per (batch*head, 64 keys).
// ---------------------------------------------------------------------------
template <int DT>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_tf32_dkdv_kernel(const __grid_constant__ CUtensorMap tm_kc,
                           const __grid_constant__ CUtensorMap tm_vc,
                           const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_qlo,
                           const __grid_constant__ CUtensorMap tm_do,
                           const __grid_constant__ CUtensorMap tm_dolo,
                           const __grid_constant__ CUtensorMap tm_stat, const Tf32BwdParams p) {
  using C = Tf32BwdTile<DT>;
  constexpr int S = C::kStages, BQ = C::kInner, MB = C::kMBlocks;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms 1024-aligned
  uint8_t* const sbase = smem_raw + (base - raw);
  const uint32_t ring = base + C::kRingOffset;  // stage s: Q, Q_lo, dO, dO_lo
  const uint32_t bufs = base + C::kBufOffset;   // P^T, P^T_lo, dS^T, dS^T_lo
  const uint32_t bars = base + C::kKvBarOffset;  // full[S], empty[S], kv
  const uint32_t kvbar = bars + 16 * S;

  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int j0 = blockIdx.y * kCtaRows;  // early keys first: the longest walks
  // the first query row that sees key j0 (causal: kv_offset + j0 <= i), its
  // tile, and the tiles from there to Sq; none: the block writes zeros
  const int first = p.causal ? max(0, p.kv_offset + j0) : 0;
  const int i_begin = first / BQ * BQ;
  const int ntiles = first < p.Sq ? (p.Sq - i_begin + BQ - 1) / BQ : 0;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (S + s), kEmptyArrivals);
    }
    mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup, broadcast from lane 0 so that ptxas knows the consumers'
  // branches around wgmma are uniform
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (wg == 0) {
    // ---------------- producer: one thread loads K', V' and fills the ring -
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs) : "memory");
    if (threadIdx.x == 0 && ntiles > 0) {
      prefetch_map(&tm_q);
      prefetch_map(&tm_qlo);
      prefetch_map(&tm_do);
      prefetch_map(&tm_dolo);
      prefetch_map(&tm_stat);
      mbar_expect_tx(kvbar, 2 * C::kCtaTileBytes);
#pragma unroll
      for (int x = 0; x < C::kBoxes; ++x) {
        tma_load(base + x * C::kCtaBoxBytes, &tm_kc, kvbar, 32 * x, j0, h, b);
        tma_load(base + C::kCtaTileBytes + x * C::kCtaBoxBytes, &tm_vc, kvbar, 32 * x, j0, h, b);
      }
      for (int it = 0; it < ntiles; ++it) {
        const int s = it % S;
        const int i0 = i_begin + it * BQ;
        const uint32_t full = bars + 8 * s;
        mbar_wait(bars + 8 * (S + s), ((it / S) & 1) ^ 1);  // stage released
        mbar_expect_tx(full, C::kStageBytes + C::kStatBytes);
        const uint32_t st = ring + s * C::kStageBytes;
#pragma unroll
        for (int x = 0; x < C::kBoxes; ++x) {
          const uint32_t bx = st + x * C::kInnerBoxBytes;
          tma_load(bx, &tm_q, full, 32 * x, i0, h, b);
          tma_load(bx + C::kInnerTileBytes, &tm_qlo, full, 32 * x, i0, h, b);
          tma_load(bx + 2 * C::kInnerTileBytes, &tm_do, full, 32 * x, i0, h, b);
          tma_load(bx + 3 * C::kInnerTileBytes, &tm_dolo, full, 32 * x, i0, h, b);
        }
        tma_load(base + C::kStatOffset + s * C::kStatBytes, &tm_stat, full, i0, bh, 0, 0);
      }
    }
  } else {
    // ---------------- consumers: 0 the S^T / dV^T side, 1 dP^T / dK^T ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs) : "memory");
    const int c = wg - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int jr = 16 * warp + g;  // this thread's keys in the block: jr, jr + 8
    // K' (consumer 0) or V' (1), resident
    const float* a_tile = reinterpret_cast<const float*>(sbase + c * C::kCtaTileBytes);
    float* const pt = reinterpret_cast<float*>(sbase + C::kBufOffset);  // P^T
    float* const pt_lo = pt + C::kBufBytes / 4;
    float* const dst = pt_lo + C::kBufBytes / 4;  // dS^T
    float* const dst_lo = dst + C::kBufBytes / 4;
    // this consumer's transposed product: dV^T = dO^T P (0), dK^T = Q^T dS (1)
    const uint32_t b_hi = bufs + c * 2 * C::kBufBytes, b_lo = b_hi + C::kBufBytes;

    float dx[MB][kCtaRows / 2];  // dV^T (0) or dK^T (1): D x 64 keys
    uint32_t ah[2][kChunk][4], al[2][kChunk][4];  // A fragments of the products over D
#pragma unroll
    for (int mb = 0; mb < MB; ++mb)
#pragma unroll
      for (int i = 0; i < kCtaRows / 2; ++i) dx[mb][i] = 0.f;

    if (ntiles > 0) mbar_wait(kvbar, 0);
    for (int it = 0; it < ntiles; ++it) {
      const int s = it % S;
      const int i0 = i_begin + it * BQ;
      mbar_wait(bars + 8 * s, (it / S) & 1);
      const uint32_t st = ring + s * C::kStageBytes;
      const float* const fst = reinterpret_cast<const float*>(sbase + C::kRingOffset +
                                                              s * C::kStageBytes);
      const float* const stat =
          reinterpret_cast<const float*>(sbase + C::kStatOffset + s * C::kStatBytes);
      // S'^T = K' Q^T (0) or dP'^T = V' dO^T (1): 64 keys x BQ queries
      const uint32_t xb = st + c * 2 * C::kInnerTileBytes;
      float x[BQ / 2];
      product_rows<DT, BQ, 0>(x, ah, al, a_tile, xb, xb + C::kInnerTileBytes,
                              C::kInnerBoxBytes, warp, g, t);
      wgmma_wait<0>();
      pin(x);
      if (c == 0) {
        // P^T (masked only on tiles that straddle the diagonal; a query row
        // past Sq or fully masked has lse2 = +inf, so P = 0)
        const bool edge = p.causal && p.kv_offset + j0 + kCtaRows - 1 > i0;
#pragma unroll
        for (int n = 0; n < BQ / 8; ++n) {
          const float2 l2 = *reinterpret_cast<const float2*>(stat + BQ + 8 * n + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float pe = ex2(fmaf(x[4 * n + e], p.scale_log2, -((e & 1) ? l2.y : l2.x)));
            if (edge && p.kv_offset + j0 + jr + 8 * (e >> 1) > i0 + 8 * n + 2 * t + (e & 1))
              pe = 0.f;
            x[4 * n + e] = pe;
          }
        }
        if (it > 0) bar_sync(kBarFree, 256);  // consumer 1 has read the tile before's P^T
        store_operand<BQ>(pt, pt_lo, x, warp, g, t);
        proxy_fence();
      }
      bar_sync(kBarReady, 256);  // P^T written
      if (c == 1) {
        // dS^T = P^T o (dP'^T - Delta)
#pragma unroll
        for (int n = 0; n < BQ / 8; ++n) {
          const float2 dl = *reinterpret_cast<const float2*>(stat + 8 * n + 2 * t);
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const float2 pp =
                *reinterpret_cast<const float2*>(pt + sw<kCtaRows>(jr + 8 * half, 8 * n + 2 * t));
            x[4 * n + 2 * half] = pp.x * (x[4 * n + 2 * half] - dl.x);
            x[4 * n + 2 * half + 1] = pp.y * (x[4 * n + 2 * half + 1] - dl.y);
          }
        }
        if (it + 1 < ntiles) bar_arrive(kBarFree, 256);
        store_operand<BQ>(dst, dst_lo, x, warp, g, t);
        proxy_fence();
        bar_sync(kBarDs, 128);
      }
      // dV^T += dO^T P (0) or dK^T += Q^T dS (1): A from the ring's dO or Q
      // tile and its lo plane
      const float* const xa = fst + (c == 0 ? 2 : 0) * (C::kInnerTileBytes / 4);
      product_cols<DT, kCtaRows>(dx, xa, xa + C::kInnerTileBytes / 4, b_hi, b_lo, warp, g, t);
      wgmma_wait<0>();
#pragma unroll
      for (int mb = 0; mb < MB; ++mb) pin(dx[mb]);
      __syncwarp();
      if (lane == 0) mbar_arrive(bars + 8 * (S + s));  // release the stage
    }
    const int64_t* st = p.st;
    if (c == 0)
      store_transposed<DT, kCtaRows>(p.dv + b * st[18] + h * st[20], st[19], dx, 1.f, j0, p.Sk,
                                     p.D, warp, g, t);
    else
      store_transposed<DT, kCtaRows>(p.dk + b * st[15] + h * st[17], st[16], dx, p.scale, j0,
                                     p.Sk, p.D, warp, g, t);
  }
}

// ---------------------------------------------------------------------------
// The query-side walk, one CTA per (batch*head, 64 query rows), the longest
// first: it walks the key tiles up to the last key its rows may see, and
// recomputes S', P and dP' on each.  Its two consumers take the tiles by
// turns (consumer c the tiles c, c + 2, ...), each running all of a tile's
// products over the CTA's 64 rows, and add their partial sums at the end,
// consumer 0's first (the same bits every run).  kDelta: the Delta walk,
// Delta = sum_j P o dP' - g_lse and lse' * log2(e) (lse' = lse - scale
// q.m_k) into the scratch; else the dQ walk, dQ = scale (sum_j dS_ij K'_j +
// m_k sum_j dS_ij), dS = P o (dP' - Delta).
// ---------------------------------------------------------------------------
template <int DT, bool kDelta>
__device__ __forceinline__ void query_pass(const CUtensorMap& tm_q, const CUtensorMap& tm_do,
                                           const CUtensorMap& tm_kc, const CUtensorMap& tm_kclo,
                                           const CUtensorMap& tm_vc, const CUtensorMap& tm_vclo,
                                           const Tf32BwdParams& p) {
  using C = Tf32BwdTile<DT>;
  constexpr int S = C::kStages, BK = C::kInner, MB = C::kMBlocks;
  constexpr int NC = (C::kDSteps + kChunk - 1) / kChunk;  // A chunks of a product over D
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms 1024-aligned
  uint8_t* const sbase = smem_raw + (base - raw);
  const uint32_t ring = base + C::kRingOffset;  // stage s: K', K'_lo, V', V'_lo
  const uint32_t bars = base + (kDelta ? C::kDsOffset : C::kDsOffset + 4 * C::kBufBytes);
  const uint32_t qbar = bars + 16 * S;  // full[S], empty[S], q

  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int i0 = (gridDim.y - 1 - blockIdx.y) * kCtaRows;  // longest first
  // the keys the CTA's last row may see (causal: kv_offset + j <= i)
  int keys = p.Sk;
  if (p.causal) keys = max(0, min(p.Sk, min(i0 + kCtaRows, p.Sq) - p.kv_offset));
  const int nkb = (keys + BK - 1) / BK;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (S + s), kEmptyArrivals / 2);  // the warps of the tile's consumer
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (wg == 0) {
    // ---------------- producer: one thread loads Q, dO and fills the ring --
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs) : "memory");
    if (threadIdx.x == 0) {
      prefetch_map(&tm_kc);
      prefetch_map(&tm_kclo);
      prefetch_map(&tm_vc);
      prefetch_map(&tm_vclo);
      mbar_expect_tx(qbar, 2 * C::kCtaTileBytes);
#pragma unroll
      for (int x = 0; x < C::kBoxes; ++x) {
        tma_load(base + x * C::kCtaBoxBytes, &tm_q, qbar, 32 * x, i0, h, b);
        tma_load(base + C::kCtaTileBytes + x * C::kCtaBoxBytes, &tm_do, qbar, 32 * x, i0, h, b);
      }
      for (int kb = 0; kb < nkb; ++kb) {
        const int s = kb % S;
        const uint32_t full = bars + 8 * s;
        mbar_wait(bars + 8 * (S + s), ((kb / S) & 1) ^ 1);  // stage released
        mbar_expect_tx(full, C::kStageBytes);
        const uint32_t st = ring + s * C::kStageBytes;
#pragma unroll
        for (int x = 0; x < C::kBoxes; ++x) {
          const uint32_t bx = st + x * C::kInnerBoxBytes;
          tma_load(bx, &tm_kc, full, 32 * x, kb * BK, h, b);
          tma_load(bx + C::kInnerTileBytes, &tm_kclo, full, 32 * x, kb * BK, h, b);
          tma_load(bx + 2 * C::kInnerTileBytes, &tm_vc, full, 32 * x, kb * BK, h, b);
          tma_load(bx + 3 * C::kInnerTileBytes, &tm_vclo, full, 32 * x, kb * BK, h, b);
        }
      }
    }
  } else {
    // ---------------- consumers: the tiles c, c + 2, ... each -------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs) : "memory");
    const int c = wg - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int r0 = i0 + 16 * warp + g;  // this thread's rows: r0, r0 + 8
    const float* const q_tile = reinterpret_cast<const float*>(sbase);
    const float* const do_tile = reinterpret_cast<const float*>(sbase + C::kCtaTileBytes);
    // this consumer's dS and dS_lo (the dQ walk)
    float* const ds = reinterpret_cast<float*>(sbase + C::kDsOffset + c * 2 * C::kBufBytes);
    [[maybe_unused]] float* const ds_lo = ds + C::kBufBytes / 4;
    [[maybe_unused]] const uint32_t dsb = base + C::kDsOffset + c * 2 * C::kBufBytes;
    const float* const mean = p.mean + static_cast<int64_t>(bh) * 2 * p.D;

    mbar_wait(qbar, 0);
    // the thread's two rows: lse' * log2(e) (+inf on a fully masked row or
    // past Sq), Delta (the dQ walk)
    float lse2[2], delta[2] = {0.f, 0.f};
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = r0 + 8 * half;
      if constexpr (kDelta) {
        // q_i . m_k in f32: the four threads of the row group take every
        // fourth column
        float qm = 0.f;
        for (int col = t; col < p.D; col += 4)
          qm = fmaf(q_tile[sw<kCtaRows>(16 * warp + g + 8 * half, col)], mean[col], qm);
        qm += __shfl_xor_sync(0xffffffffu, qm, 1);
        qm += __shfl_xor_sync(0xffffffffu, qm, 2);
        const float l = i < p.Sq ? p.lse[(static_cast<int64_t>(b) * p.Sq + i) * p.H + h] : kNegInf;
        lse2[half] = l > kHalfNegInf ? (l - p.scale * qm) * kLog2e : __int_as_float(0x7f800000);
      } else {
        const int64_t at = static_cast<int64_t>(bh) * p.sq_rows + i;
        lse2[half] = i < p.Sq ? p.lse2[at] : __int_as_float(0x7f800000);
        delta[half] = i < p.Sq ? p.delta[at] : 0.f;
      }
    }
    float acc[2] = {0.f, 0.f};  // this thread's share of its rows' sum of P o dP' or of dS
    float dq[MB][kCtaRows / 2];  // the dQ walk: dQ^T over the CTA's 64 queries
#pragma unroll
    for (int mb = 0; mb < MB; ++mb)
#pragma unroll
      for (int i = 0; i < kCtaRows / 2; ++i) dq[mb][i] = 0.f;
    uint32_t ah[2][kChunk][4], al[2][kChunk][4];  // A fragments of the products over D

    for (int kb = c; kb < nkb; kb += 2) {
      const int s = kb % S;
      const int k0 = kb * BK;
      mbar_wait(bars + 8 * s, (kb / S) & 1);
      const uint32_t st = ring + s * C::kStageBytes;
      // S' = Q K'^T and dP' = dO V'^T: 64 queries x BK keys each
      float sc[BK / 2], dp[BK / 2];
      product_rows<DT, BK, 0>(sc, ah, al, q_tile, st, st + C::kInnerTileBytes,
                              C::kInnerBoxBytes, warp, g, t);
      product_rows<DT, BK, NC>(dp, ah, al, do_tile, st + 2 * C::kInnerTileBytes,
                               st + 3 * C::kInnerTileBytes, C::kInnerBoxBytes, warp, g, t);
      wgmma_wait<0>();
      pin(sc);
      pin(dp);
      // P (masked only on tiles that straddle the diagonal or the Sk tail),
      // then this thread's share of its rows' sum of P o dP', or dS
      const bool edge = k0 + BK > p.Sk || (p.causal && p.kv_offset + k0 + BK - 1 > i0);
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float pe = ex2(fmaf(sc[4 * n + e], p.scale_log2, -lse2[e >> 1]));
          if (edge) {
            const int j = k0 + 8 * n + 2 * t + (e & 1);
            if (!(j < p.Sk && (!p.causal || p.kv_offset + j <= r0 + 8 * (e >> 1)))) pe = 0.f;
          }
          if constexpr (kDelta) {
            acc[e >> 1] = fmaf(pe, dp[4 * n + e], acc[e >> 1]);
          } else {
            sc[4 * n + e] = pe * (dp[4 * n + e] - delta[e >> 1]);  // dS
            acc[e >> 1] += sc[4 * n + e];
          }
        }
      }
      if constexpr (!kDelta) {
        // dQ^T += K'^T dS^T over the CTA's 64 queries: A from the ring's K'
        // tile and its lo plane, B this consumer's dS (its dQ^T of the tile
        // before has read it: every one of its warps has waited above for
        // a wgmma the warpgroup issues only together)
        store_operand<BK>(ds, ds_lo, sc, warp, g, t);
        proxy_fence();
        bar_sync(kBarDs + c, 128);
        const float* const kt = reinterpret_cast<const float*>(sbase + C::kRingOffset +
                                                               s * C::kStageBytes);
        product_cols<DT, kCtaRows>(dq, kt, kt + C::kInnerTileBytes / 4, dsb,
                                   dsb + C::kBufBytes, warp, g, t);
        wgmma_wait<0>();
#pragma unroll
        for (int mb = 0; mb < MB; ++mb) pin(dq[mb]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(bars + 8 * (S + s));  // release the stage
    }
    // consumer 1 hands its partial sums over through the ring, which both
    // have finished with; consumer 0 adds them to its own and stores
    float* const part = reinterpret_cast<float*>(sbase + C::kRingOffset);
    bar_sync(kBarReady, 256);
    if (c == 1) {
      part[tid] = acc[0];
      part[128 + tid] = acc[1];
      if constexpr (!kDelta) {
#pragma unroll
        for (int mb = 0; mb < MB; ++mb)
#pragma unroll
          for (int i = 0; i < kCtaRows / 2; ++i) part[256 + (mb * kCtaRows / 2 + i) * 128 + tid] =
              dq[mb][i];
      }
    }
    bar_sync(kBarReady, 256);
    if (c == 0) {
      float sum[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        // the four threads of a row group hold the row's columns
        sum[half] = acc[half] + part[half * 128 + tid];
        sum[half] += __shfl_xor_sync(0xffffffffu, sum[half], 1);
        sum[half] += __shfl_xor_sync(0xffffffffu, sum[half], 2);
      }
      if constexpr (kDelta) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = r0 + 8 * half;
          if (t == 0) {  // every row of the CTA: below sq_rows
            const int64_t at = static_cast<int64_t>(bh) * p.sq_rows + i;
            const float gl = i < p.Sq && p.g_lse != nullptr
                                 ? p.g_lse[(static_cast<int64_t>(b) * p.Sq + i) * p.H + h]
                                 : 0.f;
            p.delta[at] = sum[half] - gl;
            p.lse2[at] = lse2[half];
          }
        }
      } else {
#pragma unroll
        for (int mb = 0; mb < MB; ++mb)
#pragma unroll
          for (int i = 0; i < kCtaRows / 2; ++i)
            dq[mb][i] += part[256 + (mb * kCtaRows / 2 + i) * 128 + tid];
        // dQ = scale (dQ + m_k sum_j dS_ij), the row sums through shared
        // memory (consumer 0's dS, free now)
        if (t == 0) {
          ds[16 * warp + g] = sum[0];
          ds[16 * warp + g + 8] = sum[1];
        }
        bar_sync(kBarDs, 128);
        const int64_t* st = p.st;
        store_transposed<DT, kCtaRows>(p.dq + b * st[12] + h * st[14], st[13], dq, p.scale, i0,
                                       p.Sq, p.D, warp, g, t, mean, ds);
      }
    }
  }
}

template <int DT>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_tf32_delta_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_do,
                            const __grid_constant__ CUtensorMap tm_kc,
                            const __grid_constant__ CUtensorMap tm_kclo,
                            const __grid_constant__ CUtensorMap tm_vc,
                            const __grid_constant__ CUtensorMap tm_vclo, const Tf32BwdParams p) {
  query_pass<DT, true>(tm_q, tm_do, tm_kc, tm_kclo, tm_vc, tm_vclo, p);
}

template <int DT>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_tf32_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_do,
                         const __grid_constant__ CUtensorMap tm_kc,
                         const __grid_constant__ CUtensorMap tm_kclo,
                         const __grid_constant__ CUtensorMap tm_vc,
                         const __grid_constant__ CUtensorMap tm_vclo, const Tf32BwdParams p) {
  query_pass<DT, false>(tm_q, tm_do, tm_kc, tm_kclo, tm_vc, tm_vclo, p);
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

// A plane of the pre-pass, [B, H, S, D] contiguous, as a map of box rows
// `rows`.
bool encode_plane(CUtensorMap* map, const float* plane, int B, int H, int S, int D, int rows) {
  const int64_t d = D;
  return encode_f32(map, plane, d, S, H, B, d, static_cast<int64_t>(S) * d,
                    static_cast<int64_t>(H) * S * d, rows);
}

template <int DT>
cudaError_t launch_bwd(const Tf32BwdParams& p, int B, cudaStream_t stream) {
  using C = Tf32BwdTile<DT>;
  const int BH = B * p.H;
  const int64_t* st = p.st;
  flash_bwd_tf32_center_kernel<<<dim3(BH, (p.D + kCenterCols - 1) / kCenterCols),
                                 kCenterThreads, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t quads = static_cast<int64_t>(p.Sq > p.Sk ? p.Sq : p.Sk) * (p.D / 4);
  if (quads > 0) {
    flash_bwd_tf32_split_kernel<<<dim3(static_cast<unsigned>((quads + kSplitThreads - 1) /
                                                             kSplitThreads),
                                       BH, 2),
                                  kSplitThreads, 0, stream>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  // the resident tiles' maps (64 rows a box) and the ring's (kInner)
  CUtensorMap q_cta, do_cta, q_in, do_in, qlo_in, dolo_in, kc_cta, vc_cta, kc_in, kclo_in,
      vc_in, vclo_in, stat;
  const int d = p.D, I = C::kInner;
  if (!encode_f32(&q_cta, p.q, d, p.Sq, p.H, B, st[1], st[2], st[0], kCtaRows) ||
      !encode_f32(&do_cta, p.dout, d, p.Sq, p.H, B, st[10], st[11], st[9], kCtaRows) ||
      !encode_f32(&q_in, p.q, d, p.Sq, p.H, B, st[1], st[2], st[0], I) ||
      !encode_f32(&do_in, p.dout, d, p.Sq, p.H, B, st[10], st[11], st[9], I) ||
      !encode_plane(&qlo_in, p.q_lo, B, p.H, p.Sq, d, I) ||
      !encode_plane(&dolo_in, p.do_lo, B, p.H, p.Sq, d, I) ||
      !encode_plane(&kc_cta, p.kc, B, p.H, p.Sk, d, kCtaRows) ||
      !encode_plane(&vc_cta, p.vc, B, p.H, p.Sk, d, kCtaRows) ||
      !encode_plane(&kc_in, p.kc, B, p.H, p.Sk, d, I) ||
      !encode_plane(&kclo_in, p.kc_lo, B, p.H, p.Sk, d, I) ||
      !encode_plane(&vc_in, p.vc, B, p.H, p.Sk, d, I) ||
      !encode_plane(&vclo_in, p.vc_lo, B, p.H, p.Sk, d, I) ||
      !encode_stat_map(&stat, p.delta, BH, p.sq_rows, I))
    return cudaErrorInvalidValue;
  auto* delta_kernel = flash_bwd_tf32_delta_kernel<DT>;
  auto* dkdv_kernel = flash_bwd_tf32_dkdv_kernel<DT>;
  auto* dq_kernel = flash_bwd_tf32_dq_kernel<DT>;
  if ((err = configure_once(reinterpret_cast<const void*>(delta_kernel), C::kDeltaSmem,
                            kLaunchRegs, kThreads)) != cudaSuccess ||
      (err = configure_once(reinterpret_cast<const void*>(dkdv_kernel), C::kKvSmem,
                            kLaunchRegs, kThreads)) != cudaSuccess ||
      (err = configure_once(reinterpret_cast<const void*>(dq_kernel), C::kDqSmem, kLaunchRegs,
                            kThreads)) != cudaSuccess)
    return err;
  const dim3 query_grid(BH, (p.Sq + kCtaRows - 1) / kCtaRows);
  if (p.Sq > 0) {
    delta_kernel<<<query_grid, kThreads, C::kDeltaSmem, stream>>>(q_cta, do_cta, kc_in, kclo_in,
                                                                  vc_in, vclo_in, p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (p.Sk > 0) {
    dkdv_kernel<<<dim3(BH, (p.Sk + kCtaRows - 1) / kCtaRows), kThreads, C::kKvSmem, stream>>>(
        kc_cta, vc_cta, q_in, qlo_in, do_in, dolo_in, stat, p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (p.Sq > 0) {
    dq_kernel<<<query_grid, kThreads, C::kDqSmem, stream>>>(q_cta, do_cta, kc_in, kclo_in,
                                                            vc_in, vclo_in, p);
    err = cudaGetLastError();
  }
  return err;
}

cudaError_t launch_bwd_tile(const Tf32BwdParams& p, int B, cudaStream_t s) {
  if (p.D <= 32) return launch_bwd<32>(p, B, s);
  if (p.D <= 64) return launch_bwd<64>(p, B, s);
  if (p.D <= 96) return launch_bwd<96>(p, B, s);
  return launch_bwd<128>(p, B, s);
}

}  // namespace

// dq, dk, dv of attention in f32 (see the top of this file).  `strides`
// holds the batch, sequence and head strides (elements) of q, k, v, dout,
// dq, dk and dv, 21 in all; every head dim stride is 1, every other stride
// a multiple of 4 and every base 16-byte aligned.  lse and g_lse (may be
// null) are contiguous [B, Sq, H].  `scratch` holds, 16-byte aligned, f32
// Delta and lse2 (B*H * scratch_rows(Sq) each), the heads' mean keys and
// values (B*H * 2 * D), then the pre-pass's planes: K', K'_lo, V', V'_lo
// (B*H * Sk * D each), Q_lo and dO_lo (B*H * Sq * D each)
// (ops/attention.py:bwd_tf32_scratch_floats).  Returns cudaGetLastError()
// of the launches (0 on success), or cudaErrorInvalidValue for an input it
// does not take or a tensor map cuTensorMapEncodeTiled refuses.  Launches
// on `stream`, does not synchronise, and allocates nothing.
extern "C" int tos_flash_attn_bwd_tf32(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse, const void* g_lse,
                                       void* dq, void* dk, void* dv, void* scratch, int B,
                                       int Sq, int Sk, int H, int D, const int64_t* strides,
                                       int causal, int kv_offset, float sm_scale,
                                       void* stream) {
  if (B <= 0 || H <= 0) return 0;  // nothing to launch
  if (D < 1 || D > 128 || D % 4 != 0 || Sq < 0 || Sk < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Tf32BwdParams p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.dout = static_cast<const float*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.g_lse = static_cast<const float*>(g_lse);
  p.dq = static_cast<float*>(dq);
  p.dk = static_cast<float*>(dk);
  p.dv = static_cast<float*>(dv);
  p.sq_rows = scratch_rows(Sq);
  const int64_t bh = static_cast<int64_t>(B) * H;
  p.delta = static_cast<float*>(scratch);
  p.lse2 = p.delta + bh * p.sq_rows;
  p.mean = p.lse2 + bh * p.sq_rows;
  const int64_t kn = bh * Sk * D, qn = bh * Sq * D;
  p.kc = p.mean + bh * 2 * D;
  p.kc_lo = p.kc + kn;
  p.vc = p.kc_lo + kn;
  p.vc_lo = p.vc + kn;
  p.q_lo = p.vc_lo + kn;
  p.do_lo = p.q_lo + qn;
  p.H = H;
  p.Sq = Sq;
  p.Sk = Sk;
  p.D = D;
  for (int i = 0; i < 21; ++i) p.st[i] = strides[i];
  p.causal = causal;
  p.kv_offset = kv_offset;
  p.scale = sm_scale;
  p.scale_log2 = sm_scale * kLog2e;
  return static_cast<int>(launch_bwd_tile(p, B, static_cast<cudaStream_t>(stream)));
}

// Dynamic shared memory of one CTA of the largest walk (dK/dV or dQ) on the
// tile of D columns (32, 64, 96 or 128); else 0.
extern "C" int tos_flash_attn_bwd_tf32_smem_bytes(int D) {
  return D == 32 ? Tf32BwdTile<32>::kMaxSmem
         : D == 64 ? Tf32BwdTile<64>::kMaxSmem
         : D == 96 ? Tf32BwdTile<96>::kMaxSmem
         : D == 128 ? Tf32BwdTile<128>::kMaxSmem
                    : 0;
}
