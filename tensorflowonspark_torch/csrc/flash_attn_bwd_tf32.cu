// Flash-attention backward for f32 inputs on Hopper's tensor cores (sm_90a):
// dQ, dK and dV of attention from the forward's saved row log-sum-exp, each
// f32 product as three TF32 mma.sync (3xTF32), at head dims up to 128.
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
// Each operand is split x = hi + lo as the forward's f32 kernel splits it
// (flash_attn_fwd_tf32.cu: hi = x with its low 13 mantissa bits cleared,
// lo = tf32(x - hi), rounded to nearest), and a.b ~ a_lo.b_hi + a_hi.b_lo
// + a_hi.b_hi (the lo.lo term, ~2^-20 of a.b, dropped; small terms summed
// first), so a product is good to about 2^-20 relative.  The split is done
// in registers, on the fragments as they are loaded.
//
// Centring.  That error is relative to |k| and |v|, and where a head's keys
// and values share a large common component (a trained LM's do), the
// gradient lives in what is left after the component cancels: dP - Delta
// and sum_j dS_ij k_j.  With a component 4x the rest, 3xTF32 on the raw K
// and V puts dq about 6e-5 off the f32 gradient, within a factor 2 of the
// gate (tests/test_torch_attention_bwd.py, the centring test's case).  So
// the kernels work on K' = K - m_k and V' = V -
// m_v, m the head's mean key and value (flash_bwd_tf32_center_kernel, a
// pre-pass): S' = Q K'^T is S less the row constant q_i.m_k, folded into
// the row's lse in f32 (lse' = lse - scale q_i.m_k, by the delta kernel);
// dP' = dO V'^T is dP less the row constant dO_i.m_v, which the Delta of
// the same dP' cancels in dS; dQ = scale (dS K' + m_k sum_j dS_ij), the
// last term in f32 (sum_j dS_ij is g_lse_i, zero without an lse
// cotangent).  dK = scale dS^T Q and dV = P^T dO do not see the shift.  The
// same inputs then give dq an order of magnitude inside the gate.
//
// Bound at the f32 LM step's shape (B=2, S=2048, H=8, D=128, causal): the
// function's five products over the live pairs are 10*B*H*D*S(S+1)/2 =
// 42.9 GFLOP, 0.0868 ms at the card's 495 TFLOP/s of dense TF32, against
// about 118 MB of q, k, v, dO, lse, dq, dk, dv (0.035 ms at 3.35 TB/s):
// bound by the tensor cores.  This design runs nine products (S and dP in
// each of its three walks), each as three TF32 products: 27/5 of the
// function's, 0.469 ms at the peak rate.
//
// Design (simple and right first): every product is a warp's mma.sync
// m16n8k8 on TF32 fragments loaded from shared memory by plain 32-bit loads.
// A .tf32 wgmma takes both shared-memory operands only K-major (there is no
// transpose bit), and the backward contracts over queries (dV = P^T dO,
// dK = dS^T Q) and over keys (dQ = dS K), so Q, dO and K would be read
// MN-major; mma.sync's fragments read any layout, P and dS go from the
// accumulators into the A registers in place (below), and no transposing
// pre-pass or lo plane is needed.  Four kernels, queued by one call of
// tos_flash_attn_bwd_tf32; rows are loaded into shared memory with 16-byte
// loads through the caller's strides (K and V less their means) and a
// __syncthreads on each side (overlap comes from the CTAs resident on an
// SM: two at the 128-column tile); the three walks run four warps of 16
// rows each, a CTA of 64 rows:
// - flash_bwd_tf32_center_kernel: one CTA per (batch*head, 32 columns),
//   the head's mean key and value over Sk, in a fixed order, into the
//   caller's scratch (f32 [B*H, 2, D]).
// - flash_bwd_tf32_delta_kernel: one CTA per (batch*head, 64 query rows), Q
//   and dO resident; it walks the key tiles of kInner rows up to the last
//   key its rows may see, recomputes S', P (from lse') and dP', and
//   writes Delta and lse' * log2(e) (+inf on a fully masked row, so that
//   exp2 gives P = 0 there) into the scratch, f32 [B*H, scratch_rows(Sq)]
//   each.
// - flash_bwd_tf32_dkdv_kernel: one CTA per (batch*head, 64 keys), K and V
//   resident; it walks the query tiles of kInner rows from the first one the
//   causal mask and kv_offset let see its keys, recomputes S'^T = K' Q^T,
//   P^T and dP'^T = V' dO^T, and accumulates dV += P^T dO and
//   dK += dS^T Q in registers.  A key block no query sees writes zeros.
// - flash_bwd_tf32_dq_kernel: the delta kernel's walk again, accumulating
//   dQ += dS K' in registers.  dQ is computed apart, not by atomics from the
//   dK/dV kernel: every gradient is the same bit for bit from run to run.
// Under the causal mask the longest CTAs go first: the dK/dV kernel's early
// keys (blockIdx order), the query kernels' late rows (blockIdx reversed).
// A warp whose 16 rows see no key of a tile (the diagonal's) skips its
// products there.
//
// Fragments.  m16n8k8 TF32: for lane = 4g + t, A (16x8) a0 = (g, t),
// a1 = (g+8, t), a2 = (g, t+4), a3 = (g+8, t+4); B (8x8) b0 = (t, g),
// b1 = (t+4, g); C (16x8) c0 = (g, 2t), c1 = (g, 2t+1), c2 = (g+8, 2t),
// c3 = (g+8, 2t+1).  The accumulator of an 8-column n-tile holds columns 2t
// and 2t+1, where an A fragment wants t and t+4; a contraction may take its
// k index in any order that both operands share, so an accumulator n-tile
// is the A fragment of its 8 columns with k = t at column 2t and k = t+4 at
// column 2t+1, and the B operand is read at rows 2t and 2t+1 (mma_xb).
// Shared-memory rows are DT + 4 floats apart (4 mod 32 banks): a fragment
// read (g, t) from a row-major tile hits banks 4g + t, and one read (2t, g)
// or (2t+1, g) hits banks 8t + g (+4), so no load conflicts.
//
// Tiles: a head dim d (a multiple of 4) runs on the narrowest tile of
// DT = 32, 64, 96 or 128 columns that holds it; the columns past d are zero
// in shared memory (they change no product) and never stored, rows past Sq
// or Sk load as zeros and are masked out of P.  The loop tile kInner is 64
// rows up to 64 columns and 32 above, so that a dK/dV thread's dK and dV
// (2 x DT/2 f32) stay in registers beside S and dP.  Shared memory at the
// 128-column tile: the resident 64 rows of two operands 2 x 33 KB, the loop
// tile's two 2 x 16.5 KB, the means 1 KB: 100 KB a CTA, two CTAs an SM.
// The kernels allocate nothing.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (tensorflowonspark_torch/ops/cuda_build.py does it).

#include "hopper_pipeline.cuh"

namespace {

constexpr int kThreads = 128;  // four warps
constexpr int kCtaRows = 64;   // the rows a CTA holds: 16 a warp
constexpr int kWarpRows = 16;
// CTAs an SM the walks are built for (shared memory holds two at the
// 128-column tile).  Declared, so that ptxas sizes registers to it: given
// only the thread count, it capped some instantiations at 64 or 128
// registers and spilled inside the walks' loops.
constexpr int kMinCtas = 2;
// the scratch's rows per batch*head: flash_attn_bwd.cu's (Sq rounded up to
// 128, ops/attention.py:bwd_scratch_rows), so one allocation serves both
constexpr int kScratchAlign = 128;
constexpr int kCenterCols = 32;     // columns a CTA of the center kernel sums
constexpr int kCenterThreads = 256;  // eight warps, each over every 8th row

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
  static constexpr int kPitch = DT + 4;  // floats a shared-memory row
  // the resident rows, the loop tile's, its Delta and lse2 (the dK/dV
  // kernel), the head's mean key and value
  static constexpr int kSmemBytes =
      (2 * kCtaRows + 2 * kInner) * kPitch * 4 + 2 * kInner * 4 + 2 * DT * 4;
  static_assert(kSmemBytes <= 232448, "a CTA has 227 KB of shared memory");
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
  int H, Sq, Sk, D, sq_rows;
  // batch, sequence and head strides (elements) of q, k, v, dout, dq, dk, dv
  int64_t st[21];
  int causal, kv_offset;
  float scale, scale_log2;
};

// hi = x with its low 13 mantissa bits cleared, lo = tf32(x - hi) rounded
// to nearest (flash_attn_fwd_tf32.cu: tf32_hi, tf32_lo), as .tf32 bits.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  const uint32_t h = __float_as_uint(x) & 0xffffe000u;
  hi = h;
  lo = (__float_as_uint(x - __uint_as_float(h)) + 0x1000u) & 0xffffe000u;
}

// c += a b: a 16x8 (row-major fragment), b 8x8 (column-major), c 16x8, TF32
// operands, f32 accumulators.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b as 3xTF32: a_lo b_hi, a_hi b_lo, then a_hi b_hi.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], const float (&b)[2]) {
  uint32_t bh0, bl0, bh1, bl1;
  split_tf32(b[0], bh0, bl0);
  split_tf32(b[1], bh1, bl1);
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
}

__device__ __forceinline__ void split_a(const float (&a)[4], uint32_t (&ah)[4],
                                        uint32_t (&al)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) split_tf32(a[e], ah[e], al[e]);
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
}

// acc[N/8][4] (16 rows x N) += A (16 x K: rows r0.. of sA) * B^T, B^T the N
// rows of sB (n along the rows, k along the columns): S = Q K^T,
// dP = dO V^T, S^T = K Q^T, dP^T = V dO^T.  Rows are P floats apart.
template <int K, int N, int P>
__device__ __forceinline__ void mma_abt(float (&acc)[N / 8][4], const float* sA, int r0,
                                        const float* sB, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk) {
    const float* a_row = sA + (r0 + g) * P + kk * 8 + t;
    const float a[4] = {a_row[0], a_row[8 * P], a_row[4], a_row[8 * P + 4]};
    uint32_t ah[4], al[4];
    split_a(a, ah, al);
#pragma unroll
    for (int n = 0; n < N / 8; ++n) {
      const float* b_row = sB + (n * 8 + g) * P + kk * 8 + t;
      const float b[2] = {b_row[0], b_row[4]};
      mma_3xtf32(acc[n], ah, al, b);
    }
  }
}

// acc[N/8][4] (16 rows x N) += X * B, X the 16 x K matrix held in the
// accumulator layout x[K/8][4] (P or dS), B the K rows of sB (k along the
// rows, n along the columns): dV = P^T dO, dK = dS^T Q, dQ = dS K.  The
// accumulator n-tile kk is the A fragment of k-slice kk with k = t at column
// 2t and k = t+4 at column 2t+1, so B is read at rows 2t and 2t+1.
template <int K, int N, int P>
__device__ __forceinline__ void mma_xb(float (&acc)[N / 8][4], const float (&x)[K / 8][4],
                                       const float* sB, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk) {
    const float a[4] = {x[kk][0], x[kk][2], x[kk][1], x[kk][3]};
    uint32_t ah[4], al[4];
    split_a(a, ah, al);
    const float* b_row = sB + (kk * 8 + 2 * t) * P + g;
#pragma unroll
    for (int n = 0; n < N / 8; ++n) {
      const float b[2] = {b_row[n * 8], b_row[P + n * 8]};
      mma_3xtf32(acc[n], ah, al, b);
    }
  }
}

// Rows r0 .. r0+ROWS-1 of one head's [S, D] slice (row stride `rs`
// elements) into shared memory rows of P floats, less `sub` (DT floats in
// shared memory, the head's mean) where it is given: zero past S and past
// D.
template <int ROWS, int DT, int P>
__device__ __forceinline__ void load_rows(float* dst, const float* src, int64_t rs, int r0,
                                          int S, int D, const float* sub = nullptr) {
  constexpr int kChunks = DT / 4;
  for (int i = threadIdx.x; i < ROWS * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < S && c < D) {
      x = *reinterpret_cast<const float4*>(src + static_cast<int64_t>(r0 + r) * rs + c);
      if (sub != nullptr) {
        const float4 m = *reinterpret_cast<const float4*>(sub + c);
        x = make_float4(x.x - m.x, x.y - m.y, x.z - m.z, x.w - m.w);
      }
    }
    *reinterpret_cast<float4*>(dst + r * P + c) = x;
  }
}

// The head's mean key and value (D floats each) from the scratch into
// shared memory, DT floats each, zero past D.
template <int DT>
__device__ __forceinline__ void load_means(float* sMk, float* sMv, const float* mean, int D) {
  for (int c = threadIdx.x; c < DT; c += kThreads) {
    sMk[c] = c < D ? mean[c] : 0.f;
    sMv[c] = c < D ? mean[D + c] : 0.f;
  }
}

// ---------------------------------------------------------------------------
// The pre-pass: the head's mean key and value, one CTA per (batch*head, 32
// columns); warp w sums the rows w, w + 8, ... of its lane's column, and the
// eight partial sums are added in warp order (the same bits every run).
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

// The 16 x DT accumulator acc (rows r0.. of the warp) times `mul`, stored
// to rows below S of one head's slice (row stride rs), its columns below D
// only (D is a multiple of 4, so a pair is stored whole or not at all).
template <int DT>
__device__ __forceinline__ void store_rows(float* dst, int64_t rs, const float (&acc)[DT / 8][4],
                                           float mul, int r0, int S, int D, int g, int t) {
#pragma unroll
  for (int n = 0; n < DT / 8; ++n) {
    const int c = n * 8 + 2 * t;
    if (c >= D) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + g + 8 * half;
      if (r < S)
        *reinterpret_cast<float2*>(dst + static_cast<int64_t>(r) * rs + c) =
            make_float2(acc[n][2 * half] * mul, acc[n][2 * half + 1] * mul);
    }
  }
}

// ---------------------------------------------------------------------------
// dK and dV: one CTA per (batch*head, 64 keys).
// ---------------------------------------------------------------------------
template <int DT>
__global__ void __launch_bounds__(kThreads, kMinCtas)
    flash_bwd_tf32_dkdv_kernel(const Tf32BwdParams p) {
  using Tile = Tf32BwdTile<DT>;
  constexpr int BQ = Tile::kInner, P = Tile::kPitch;
  extern __shared__ __align__(16) uint8_t smem[];
  float* sK = reinterpret_cast<float*>(smem);
  float* sV = sK + kCtaRows * P;
  float* sQ = sV + kCtaRows * P;
  float* sdO = sQ + BQ * P;
  float* sLse2 = sdO + BQ * P;
  float* sDelta = sLse2 + BQ;
  float* sMk = sDelta + BQ;
  float* sMv = sMk + DT;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int j0 = blockIdx.y * kCtaRows;  // early keys first: the longest walks
  const int64_t* st = p.st;
  load_means<DT>(sMk, sMv, p.mean + static_cast<int64_t>(bh) * 2 * p.D, p.D);
  __syncthreads();
  // K' and V': the head's keys and values less their means
  load_rows<kCtaRows, DT, P>(sK, p.k + b * st[3] + h * st[5], st[4], j0, p.Sk, p.D, sMk);
  load_rows<kCtaRows, DT, P>(sV, p.v + b * st[6] + h * st[8], st[7], j0, p.Sk, p.D, sMv);
  const float* q = p.q + b * st[0] + h * st[2];
  const float* dout = p.dout + b * st[9] + h * st[11];
  const float* lse2 = p.lse2 + static_cast<int64_t>(bh) * p.sq_rows;
  const float* delta = p.delta + static_cast<int64_t>(bh) * p.sq_rows;

  float dk[DT / 8][4], dv[DT / 8][4];
  zero(dk);
  zero(dv);

  // the first query row that sees key j0 (causal: kv_offset + j0 <= i); a
  // key block no query sees walks nothing and writes zeros
  const int first = p.causal ? max(0, p.kv_offset + j0) : 0;
  const int stop = first < p.Sq ? p.Sq : 0;
  const int kr0 = warp * kWarpRows;  // the warp's keys in the block
  const int jw0 = j0 + kr0;
  for (int i0 = first / BQ * BQ; i0 < stop; i0 += BQ) {
    __syncthreads();  // the previous tile's readers are done
    load_rows<BQ, DT, P>(sQ, q, st[1], i0, p.Sq, p.D);
    load_rows<BQ, DT, P>(sdO, dout, st[10], i0, p.Sq, p.D);
    for (int r = threadIdx.x; r < BQ; r += kThreads) {
      const bool in = i0 + r < p.Sq;
      sLse2[r] = in ? lse2[i0 + r] : __int_as_float(0x7f800000);
      sDelta[r] = in ? delta[i0 + r] : 0.f;
    }
    __syncthreads();
    // no live pair of the warp's keys in this tile: its last row does not
    // see the warp's first key (or the warp has no key)
    if (jw0 >= p.Sk || (p.causal && p.kv_offset + jw0 > min(i0 + BQ, p.Sq) - 1)) continue;

    // S'^T = K' Q^T (the warp's 16 keys x BQ queries), then P^T in place
    float s[BQ / 8][4];
    zero(s);
    mma_abt<DT, BQ, P>(s, sK, kr0, sQ, g, t);
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = jw0 + g + 8 * (e >> 1);
        const int il = n * 8 + 2 * t + (e & 1);
        const int i = i0 + il;
        const bool keep = j < p.Sk && i < p.Sq && (!p.causal || p.kv_offset + j <= i);
        // a fully masked row has lse2 = +inf: exp2(-inf) = 0
        s[n][e] = keep ? ex2(fmaf(s[n][e], p.scale_log2, -sLse2[il])) : 0.f;
      }
    }
    // dP'^T = V' dO^T
    float dp[BQ / 8][4];
    zero(dp);
    mma_abt<DT, BQ, P>(dp, sV, kr0, sdO, g, t);
    // dV += P^T dO
    mma_xb<BQ, DT, P>(dv, s, sdO, g, t);
    // dS^T = P^T o (dP'^T - Delta), then dK += dS^T Q
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] *= dp[n][e] - sDelta[n * 8 + 2 * t + (e & 1)];
    mma_xb<BQ, DT, P>(dk, s, sQ, g, t);
  }
  store_rows<DT>(p.dk + b * st[15] + h * st[17], st[16], dk, p.scale, jw0, p.Sk, p.D, g, t);
  store_rows<DT>(p.dv + b * st[18] + h * st[20], st[19], dv, 1.f, jw0, p.Sk, p.D, g, t);
}

// ---------------------------------------------------------------------------
// The query-side walk, one CTA per (batch*head, 64 query rows), the longest
// first: it walks the key tiles up to the last key its rows may see and
// recomputes S', P and dP'.  kDelta: the Delta walk, Delta = sum_j P o dP'
// - g_lse and lse' * log2(e) (lse' = lse - scale q.m_k) into the scratch;
// else the dQ walk, dQ = scale (sum_j dS_ij K'_j + m_k sum_j dS_ij), dS =
// P o (dP' - Delta).
// ---------------------------------------------------------------------------
template <int DT, bool kDelta>
__device__ __forceinline__ void query_pass(const Tf32BwdParams& p) {
  using Tile = Tf32BwdTile<DT>;
  constexpr int BK = Tile::kInner, P = Tile::kPitch;
  extern __shared__ __align__(16) uint8_t smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  float* sdO = sQ + kCtaRows * P;
  float* sK = sdO + kCtaRows * P;
  float* sV = sK + BK * P;
  float* sMk = sV + BK * P + 2 * BK;
  float* sMv = sMk + DT;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int i0 = (gridDim.y - 1 - blockIdx.y) * kCtaRows;  // longest first
  const int64_t* st = p.st;
  load_means<DT>(sMk, sMv, p.mean + static_cast<int64_t>(bh) * 2 * p.D, p.D);
  load_rows<kCtaRows, DT, P>(sQ, p.q + b * st[0] + h * st[2], st[1], i0, p.Sq, p.D);
  load_rows<kCtaRows, DT, P>(sdO, p.dout + b * st[9] + h * st[11], st[10], i0, p.Sq, p.D);
  const float* k = p.k + b * st[3] + h * st[5];
  const float* v = p.v + b * st[6] + h * st[8];
  __syncthreads();  // Q, dO and the means loaded

  const int wr0 = warp * kWarpRows;  // the warp's query rows in the CTA
  const int qw0 = i0 + wr0;
  // the thread's two rows, qw0 + g and qw0 + g + 8: lse' * log2(e) (+inf on
  // a fully masked row or past Sq) and Delta
  float lse2[2], delta[2] = {0.f, 0.f};
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = qw0 + g + 8 * half;
    if constexpr (kDelta) {
      // q_i . m_k in f32: the four threads of the row group take every
      // fourth column
      const float* q_row = sQ + (wr0 + g + 8 * half) * P;
      float qm = 0.f;
#pragma unroll
      for (int c = t; c < DT; c += 4) qm = fmaf(q_row[c], sMk[c], qm);
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
  float dq[kDelta ? 1 : DT / 8][4];
  zero(dq);
  float ds_sum[2] = {0.f, 0.f};  // the dQ walk: this thread's share of sum_j dS_ij

  // the keys the CTA's last row may see, and those the warp's last row may
  // (causal: kv_offset + j <= i)
  int keys = p.Sk, mine = qw0 < p.Sq ? p.Sk : 0;
  if (p.causal) {
    keys = max(0, min(p.Sk, min(i0 + kCtaRows, p.Sq) - p.kv_offset));
    mine = max(0, min(mine, min(qw0 + kWarpRows, p.Sq) - p.kv_offset));
  }
  for (int j0 = 0; j0 < keys; j0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    load_rows<BK, DT, P>(sK, k, st[4], j0, p.Sk, p.D, sMk);
    load_rows<BK, DT, P>(sV, v, st[7], j0, p.Sk, p.D, sMv);
    __syncthreads();
    if (j0 >= mine) continue;  // no key of this tile is visible to the warp's rows

    // S' = Q K'^T (the warp's 16 queries x BK keys), then P in place
    float s[BK / 8][4];
    zero(s);
    mma_abt<DT, BK, P>(s, sQ, wr0, sK, g, t);
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = qw0 + g + 8 * (e >> 1);
        const int j = j0 + n * 8 + 2 * t + (e & 1);
        const bool keep = j < p.Sk && i < p.Sq && (!p.causal || p.kv_offset + j <= i);
        s[n][e] = keep ? ex2(fmaf(s[n][e], p.scale_log2, -lse2[e >> 1])) : 0.f;
      }
    }
    // dP' = dO V'^T
    float dp[BK / 8][4];
    zero(dp);
    mma_abt<DT, BK, P>(dp, sdO, wr0, sV, g, t);
    if constexpr (kDelta) {
      // this thread's share of the rows' sum_j P o dP, in f32
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) delta[e >> 1] = fmaf(s[n][e], dp[n][e], delta[e >> 1]);
    } else {
      // dS = P o (dP' - Delta); dQ += dS K'
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] *= dp[n][e] - delta[e >> 1];
          ds_sum[e >> 1] += s[n][e];
        }
      mma_xb<BK, DT, P>(dq, s, sK, g, t);
    }
  }
  if constexpr (kDelta) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      // the four threads of a row group hold the row's columns
      float sum = delta[half];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const int i = qw0 + g + 8 * half;
      if (t == 0 && i < p.Sq) {
        const int64_t at = static_cast<int64_t>(bh) * p.sq_rows + i;
        const int64_t row = (static_cast<int64_t>(b) * p.Sq + i) * p.H + h;
        p.delta[at] = sum - (p.g_lse != nullptr ? p.g_lse[row] : 0.f);
        p.lse2[at] = lse2[half];
      }
    }
  } else {
    // dQ += m_k sum_j dS_ij, the four threads of a row group holding the
    // row's sum between them
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      ds_sum[half] += __shfl_xor_sync(0xffffffffu, ds_sum[half], 1);
      ds_sum[half] += __shfl_xor_sync(0xffffffffu, ds_sum[half], 2);
    }
#pragma unroll
    for (int n = 0; n < DT / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dq[n][e] = fmaf(ds_sum[e >> 1], sMk[n * 8 + 2 * t + (e & 1)], dq[n][e]);
    store_rows<DT>(p.dq + b * st[12] + h * st[14], st[13], dq, p.scale, qw0, p.Sq, p.D, g, t);
  }
}

template <int DT>
__global__ void __launch_bounds__(kThreads, kMinCtas)
    flash_bwd_tf32_delta_kernel(const Tf32BwdParams p) {
  query_pass<DT, true>(p);
}

template <int DT>
__global__ void __launch_bounds__(kThreads, kMinCtas)
    flash_bwd_tf32_dq_kernel(const Tf32BwdParams p) {
  query_pass<DT, false>(p);
}

template <int DT>
cudaError_t launch_bwd(const Tf32BwdParams& p, int BH, cudaStream_t stream) {
  constexpr int smem = Tf32BwdTile<DT>::kSmemBytes;
  auto* delta_kernel = flash_bwd_tf32_delta_kernel<DT>;
  auto* dkdv_kernel = flash_bwd_tf32_dkdv_kernel<DT>;
  auto* dq_kernel = flash_bwd_tf32_dq_kernel<DT>;
  const void* kernels[3] = {reinterpret_cast<const void*>(delta_kernel),
                            reinterpret_cast<const void*>(dkdv_kernel),
                            reinterpret_cast<const void*>(dq_kernel)};
  for (const void* kernel : kernels) {
    const cudaError_t err = configure_once(kernel, smem, 0, kThreads);
    if (err != cudaSuccess) return err;
  }
  const dim3 query_grid(BH, (p.Sq + kCtaRows - 1) / kCtaRows);
  flash_bwd_tf32_center_kernel<<<dim3(BH, (p.D + kCenterCols - 1) / kCenterCols),
                                 kCenterThreads, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (p.Sq > 0) {
    delta_kernel<<<query_grid, kThreads, smem, stream>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (p.Sk > 0) {
    dkdv_kernel<<<dim3(BH, (p.Sk + kCtaRows - 1) / kCtaRows), kThreads, smem, stream>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (p.Sq > 0) {
    dq_kernel<<<query_grid, kThreads, smem, stream>>>(p);
    err = cudaGetLastError();
  }
  return err;
}

cudaError_t launch_bwd_tile(const Tf32BwdParams& p, int BH, cudaStream_t s) {
  if (p.D <= 32) return launch_bwd<32>(p, BH, s);
  if (p.D <= 64) return launch_bwd<64>(p, BH, s);
  if (p.D <= 96) return launch_bwd<96>(p, BH, s);
  return launch_bwd<128>(p, BH, s);
}

}  // namespace

// dq, dk, dv of attention in f32 (see the top of this file).  `strides`
// holds the batch, sequence and head strides (elements) of q, k, v, dout,
// dq, dk and dv, 21 in all; every head dim stride is 1, every other stride
// a multiple of 4 and every base 16-byte aligned.  lse and g_lse (may be
// null) are contiguous [B, Sq, H].  `scratch` holds 2 * B * H *
// (scratch_rows(Sq) + D) floats (Delta, lse2, then the heads' mean keys and
// values), 16-byte aligned.  Returns cudaGetLastError() of
// the launches (0 on success), or cudaErrorInvalidValue for an input it
// does not take.  Launches on `stream`, does not synchronise, and allocates
// nothing.
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
  p.delta = static_cast<float*>(scratch);
  p.lse2 = p.delta + static_cast<int64_t>(B) * H * p.sq_rows;
  p.mean = p.lse2 + static_cast<int64_t>(B) * H * p.sq_rows;
  p.H = H;
  p.Sq = Sq;
  p.Sk = Sk;
  p.D = D;
  for (int i = 0; i < 21; ++i) p.st[i] = strides[i];
  p.causal = causal;
  p.kv_offset = kv_offset;
  p.scale = sm_scale;
  p.scale_log2 = sm_scale * kLog2e;
  return static_cast<int>(launch_bwd_tile(p, B * H, static_cast<cudaStream_t>(stream)));
}

// Dynamic shared memory of one CTA of the three walks (the same) on the
// tile of D columns (32, 64, 96 or 128); else 0.
extern "C" int tos_flash_attn_bwd_tf32_smem_bytes(int D) {
  return D == 32 ? Tf32BwdTile<32>::kSmemBytes
         : D == 64 ? Tf32BwdTile<64>::kSmemBytes
         : D == 96 ? Tf32BwdTile<96>::kSmemBytes
         : D == 128 ? Tf32BwdTile<128>::kSmemBytes
                    : 0;
}
