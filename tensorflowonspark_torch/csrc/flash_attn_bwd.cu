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
// with every product on the tensor cores (mma.sync m16n8k16, 16-bit
// operands, f32 accumulators) and P and dS rounded to the input type only
// as the A operand of the products that consume them.  Delta is the f32
// sum of P o dP, not FA2's rowsum(dO o O) over the stored O: O is stored in
// bf16, and that rounding (2^-9 of |dO||O|) breaks sum_j dS_ij = 0, which
// dQ needs where the keys share a large common component, as in a trained
// LM's layers (PERF.md, the attention backward's findings).
//
// Three kernels, queued by one call of tos_flash_attn_bwd:
// - flash_bwd_delta_kernel: one CTA per (query tile of 64 rows,
//   batch*head), four warps of 16 query rows; it walks the key tiles up to
//   the last one its rows may see, recomputes S, P (from the saved lse) and
//   dP, and writes Delta and lse * log2(e) (+inf on a fully masked row, so
//   that exp2 gives P = 0 there), f32 [B*H, Sq] each, into the caller's
//   scratch.
// - flash_bwd_dkdv_kernel: one CTA per (key tile of 64 rows, batch*head),
//   four warps of 16 key rows.  K and V stay in shared memory; the CTA walks
//   the query tiles (kInner rows) from the first one the causal mask and
//   kv_offset let see its keys, recomputes S^T = K Q^T and P^T, and
//   accumulates dV and dK in registers.  A key tile no query sees writes
//   zeros.
// - flash_bwd_dq_kernel: the delta kernel's walk again, accumulating dQ in
//   registers.  dQ is computed apart, not by f32 atomics from the dK/dV
//   kernel: no f32 scratch of dQ, no cast pass and no zeroing, and every
//   gradient is the same bit for bit from run to run.
// So S and dP are computed three times: nine products over the live pairs
// where the function needs five.
//
// Bound at the LM's training shape (B=8, S=2048, H=8, D=128, causal, bf16):
// the function's five products over the live pairs are 10*B*H*D*S(S+1)/2 =
// 172 GFLOP, 0.174 ms at 989 TFLOP/s, against about 235 MB of q, k, v, dO,
// lse, dq, dk, dv (0.07 ms at 3.35 TB/s): bound by the tensor cores.
// This design runs nine products at mma.sync's rate (below wgmma's), reads
// every query tile once per key tile and every key tile once per query tile
// from device memory (L2 serves most), and overlaps loads with products only
// across the CTAs resident on an SM: a right kernel first, its speed (wgmma,
// a TMA ring, warp specialisation, Delta folded into a pass) is later work.
//
// Tiles: a head dim d (a multiple of 8) runs on the narrowest tile of
// DT = 32, 64, 96 or 128 columns that holds it; the columns past d are
// zero in shared memory (they change no product) and never stored.  Rows
// past Sq or Sk load as zeros and are masked out of P.  Shared-memory rows
// are DT + 8 elements apart, so the 8 rows an ldmatrix reads fall in 8
// different 16-byte bank groups.  Loads are 16-byte vectors through the
// caller's batch, sequence and head strides (16-byte aligned rows,
// checked by the wrapper, ops/attention.py:_kernel_operand).  The kernels
// allocate nothing.

#include "hopper_pipeline.cuh"

namespace {

constexpr int kBwdThreads = 128;  // four warps
constexpr int kBwdRows = 64;      // the rows a CTA holds: 16 a warp

// The loop tile at DT columns: query rows a step of the dK/dV kernel, key
// rows a step of the delta and dQ kernels (ops/attention.py:bwd_inner_rows).  32 at
// the wide tiles keeps a thread's dK and dV (2 x DT/2 f32) beside S and dP.
template <int DT>
struct BwdTile {
  static constexpr int kInner = DT <= 64 ? 64 : 32;
  static constexpr int kPitch = DT + 8;  // shared-memory row, elements
  static constexpr int kSmemBytes = 2 * (kBwdRows + kInner) * kPitch * 2 + 2 * kInner * 4;
};

struct BwdParams {
  const uint16_t* q;
  const uint16_t* k;
  const uint16_t* v;
  const uint16_t* dout;
  const float* lse;
  const float* g_lse;  // may be null
  uint16_t* dq;
  uint16_t* dk;
  uint16_t* dv;
  float* delta;  // [B*H, Sq]
  float* lse2;   // [B*H, Sq], lse * log2(e) or +inf
  int B, Sq, Sk, H, D;
  // batch, sequence and head strides (elements) of q, k, v, dout, dq, dk, dv
  int64_t st[21];
  int causal, kv_offset;
  float scale, scale_log2;
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// c += a b: a 16x16 (row-major fragment), b 16x8 (column-major), c 16x8 f32.
template <bool kBf16>
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  if constexpr (kBf16) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// Two f32 rounded to the input type, `lo` in the low half.
template <bool kBf16>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (kBf16) {
    __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&x);
  } else {
    __half2 x = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&x);
  }
}

// Fragments out of shared memory (row-major, `pitch` bytes a row), for a
// lane = 4g + t of the warp:
// the A fragment of the 16x16 block at (row r0, column c0);
__device__ __forceinline__ void load_a(uint32_t (&a)[4], uint32_t base, int pitch, int r0,
                                       int c0, int lane) {
  const int r = r0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int c = c0 + (lane >> 4) * 8;
  ldsm_x4(a, base + r * pitch + c * 2);
}
// the B fragments of two n-tiles (n0, n0 + 8) over the k-slice k0..k0+15
// of a matrix stored with n along the rows (B^T row-major: K for Q K^T):
// b[0], b[1] of tile n0, b[2], b[3] of tile n0 + 8;
__device__ __forceinline__ void load_b_nrows(uint32_t (&b)[4], uint32_t base, int pitch,
                                             int n0, int k0, int lane) {
  const int n = n0 + (lane & 7) + (lane >> 4) * 8;
  const int c = k0 + ((lane >> 3) & 1) * 8;
  ldsm_x4(b, base + n * pitch + c * 2);
}
// the same two n-tiles of a matrix stored with k along the rows (B
// row-major: dO for P^T dO), through ldmatrix's transpose.
__device__ __forceinline__ void load_b_krows(uint32_t (&b)[4], uint32_t base, int pitch,
                                             int k0, int n0, int lane) {
  const int r = k0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int c = n0 + (lane >> 4) * 8;
  ldsm_x4_trans(b, base + r * pitch + c * 2);
}

// acc[N/8][4] (16 rows x N) += A (16 x K, rows r0.. of sA) * B where B^T is
// the N rows of sB (n along the rows): S = Q K^T and dP = dO V^T.
template <bool kBf16, int K, int N>
__device__ __forceinline__ void mma_abt(float (&acc)[N / 8][4], uint32_t sA, int r0,
                                        uint32_t sB, int pitch, int lane) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    uint32_t a[4];
    load_a(a, sA, pitch, r0, kk * 16, lane);
#pragma unroll
    for (int n = 0; n < N / 16; ++n) {
      uint32_t b[4];
      load_b_nrows(b, sB, pitch, n * 16, kk * 16, lane);
      mma16816<kBf16>(acc[2 * n], a, b[0], b[1]);
      mma16816<kBf16>(acc[2 * n + 1], a, b[2], b[3]);
    }
  }
}

// acc[N/8][4] (16 rows x N) += X * B, X the 16 x K matrix of the
// accumulator-layout registers x[K/8][4] rounded to the input type (P or
// dS, as the A operand), B the K rows of sB (k along the rows): dV = P^T dO,
// dK = dS^T Q, dQ = dS K.
template <bool kBf16, int K, int N>
__device__ __forceinline__ void mma_xb(float (&acc)[N / 8][4], const float (&x)[K / 8][4],
                                       uint32_t sB, int pitch, int lane) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    // the accumulator's n-tiles 2kk and 2kk+1 are the A fragment of k-slice kk
    uint32_t a[4];
    a[0] = pack2<kBf16>(x[2 * kk][0], x[2 * kk][1]);
    a[1] = pack2<kBf16>(x[2 * kk][2], x[2 * kk][3]);
    a[2] = pack2<kBf16>(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    a[3] = pack2<kBf16>(x[2 * kk + 1][2], x[2 * kk + 1][3]);
#pragma unroll
    for (int n = 0; n < N / 16; ++n) {
      uint32_t b[4];
      load_b_krows(b, sB, pitch, kk * 16, n * 16, lane);
      mma16816<kBf16>(acc[2 * n], a, b[0], b[1]);
      mma16816<kBf16>(acc[2 * n + 1], a, b[2], b[3]);
    }
  }
}

// Rows r0 .. r0+ROWS-1 of one head's [S, D] slice (row stride `rs`
// elements) into shared memory rows of DT + 8 elements: zero past S and
// past D.
template <int ROWS, int DT>
__device__ __forceinline__ void load_rows(uint16_t* dst, const uint16_t* src, int64_t rs,
                                          int r0, int S, int D) {
  constexpr int kChunks = DT / 8;
  for (int i = threadIdx.x; i < ROWS * kChunks; i += kBwdThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < S && c < D)
      x = *reinterpret_cast<const uint4*>(src + static_cast<int64_t>(r0 + r) * rs + c);
    *reinterpret_cast<uint4*>(dst + r * (DT + 8) + c) = x;
  }
}

// The 16 x DT accumulator acc (rows r0.. of the warp) times `mul`, stored
// in the input type to rows below S of one head's slice (row stride rs),
// its columns below D only.
template <bool kBf16, int DT>
__device__ __forceinline__ void store_rows(uint16_t* dst, int64_t rs, const float (&acc)[DT / 8][4],
                                           float mul, int r0, int S, int D, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < DT / 8; ++n) {
    const int c = n * 8 + 2 * t;
    if (c >= D) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + g + 8 * half;
      if (r < S)
        *reinterpret_cast<uint32_t*>(dst + static_cast<int64_t>(r) * rs + c) =
            pack2<kBf16>(acc[n][2 * half] * mul, acc[n][2 * half + 1] * mul);
    }
  }
}

// ---------------------------------------------------------------------------
// dK and dV: one CTA per (64 key rows, batch*head).
// ---------------------------------------------------------------------------
template <int DT, bool kBf16>
__global__ void __launch_bounds__(kBwdThreads) flash_bwd_dkdv_kernel(const BwdParams p) {
  using Tile = BwdTile<DT>;
  constexpr int BQ = Tile::kInner, P = Tile::kPitch;
  extern __shared__ __align__(16) uint8_t smem[];
  uint16_t* sK = reinterpret_cast<uint16_t*>(smem);
  uint16_t* sV = sK + kBwdRows * P;
  uint16_t* sQ = sV + kBwdRows * P;
  uint16_t* sdO = sQ + BQ * P;
  float* sLse2 = reinterpret_cast<float*>(sdO + BQ * P);
  float* sDelta = sLse2 + BQ;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int j0 = blockIdx.x * kBwdRows;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int64_t* st = p.st;
  load_rows<kBwdRows, DT>(sK, p.k + b * st[3] + h * st[5], st[4], j0, p.Sk, p.D);
  load_rows<kBwdRows, DT>(sV, p.v + b * st[6] + h * st[8], st[7], j0, p.Sk, p.D);
  const uint16_t* q = p.q + b * st[0] + h * st[2];
  const uint16_t* dout = p.dout + b * st[9] + h * st[11];
  const float* lse2 = p.lse2 + static_cast<int64_t>(bh) * p.Sq;
  const float* delta = p.delta + static_cast<int64_t>(bh) * p.Sq;

  float dk[DT / 8][4], dv[DT / 8][4];
#pragma unroll
  for (int n = 0; n < DT / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  // the first query row that sees key j0 (causal: kv_offset + j0 <= i); a
  // tile no query sees walks nothing and writes zeros
  const int first = p.causal ? max(0, p.kv_offset + j0) : 0;
  const int stop = first < p.Sq ? p.Sq : 0;
  const int kr0 = warp * 16;  // the warp's key rows in the tile
  const uint32_t aK = smem_u32(sK), aV = smem_u32(sV), aQ = smem_u32(sQ),
                 adO = smem_u32(sdO);
  for (int i0 = first / BQ * BQ; i0 < stop; i0 += BQ) {
    __syncthreads();  // the previous tile's readers are done
    load_rows<BQ, DT>(sQ, q, st[1], i0, p.Sq, p.D);
    load_rows<BQ, DT>(sdO, dout, st[10], i0, p.Sq, p.D);
    for (int r = threadIdx.x; r < BQ; r += kBwdThreads) {
      const bool in = i0 + r < p.Sq;
      sLse2[r] = in ? lse2[i0 + r] : __int_as_float(0x7f800000);
      sDelta[r] = in ? delta[i0 + r] : 0.f;
    }
    __syncthreads();

    // S^T = K Q^T (the warp's 16 keys x BQ queries), then P^T in place
    float s[BQ / 8][4];
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    mma_abt<kBf16, DT, BQ>(s, aK, kr0, aQ, P * 2, lane);
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = j0 + kr0 + g + 8 * (e >> 1);
        const int il = n * 8 + 2 * t + (e & 1);
        const int i = i0 + il;
        const bool keep = j < p.Sk && i < p.Sq && (!p.causal || p.kv_offset + j <= i);
        // a fully masked row has lse2 = +inf: exp2(-inf) = 0
        s[n][e] = keep ? ex2(fmaf(s[n][e], p.scale_log2, -sLse2[il])) : 0.f;
      }
    }
    // dP^T = V dO^T
    float dp[BQ / 8][4];
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[n][e] = 0.f;
    mma_abt<kBf16, DT, BQ>(dp, aV, kr0, adO, P * 2, lane);
    // dV += P^T dO
    mma_xb<kBf16, BQ, DT>(dv, s, adO, P * 2, lane);
    // dS^T = P^T o (dP^T - Delta), then dK += dS^T Q
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] *= dp[n][e] - sDelta[n * 8 + 2 * t + (e & 1)];
    mma_xb<kBf16, BQ, DT>(dk, s, aQ, P * 2, lane);
  }
  store_rows<kBf16, DT>(p.dk + b * st[15] + h * st[17], st[16], dk, p.scale, j0 + kr0, p.Sk,
                        p.D, lane);
  store_rows<kBf16, DT>(p.dv + b * st[18] + h * st[20], st[19], dv, 1.f, j0 + kr0, p.Sk, p.D,
                        lane);
}

// ---------------------------------------------------------------------------
// The query-side pass, one CTA per (64 query rows, batch*head): it walks the
// key tiles up to the last key its rows may see and recomputes S, P and dP.
// kDelta: the Delta pass, Delta = sum_j P o dP - g_lse and lse * log2(e)
// into the scratch; else the dQ pass, dQ = scale * sum_j P o (dP - Delta) K.
// ---------------------------------------------------------------------------
template <int DT, bool kBf16, bool kDelta>
__device__ __forceinline__ void query_pass(const BwdParams& p) {
  using Tile = BwdTile<DT>;
  constexpr int BK = Tile::kInner, P = Tile::kPitch;
  extern __shared__ __align__(16) uint8_t smem[];
  uint16_t* sQ = reinterpret_cast<uint16_t*>(smem);
  uint16_t* sdO = sQ + kBwdRows * P;
  uint16_t* sK = sdO + kBwdRows * P;
  uint16_t* sV = sK + BK * P;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int i0 = blockIdx.x * kBwdRows;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int64_t* st = p.st;
  load_rows<kBwdRows, DT>(sQ, p.q + b * st[0] + h * st[2], st[1], i0, p.Sq, p.D);
  load_rows<kBwdRows, DT>(sdO, p.dout + b * st[9] + h * st[11], st[10], i0, p.Sq, p.D);
  const uint16_t* k = p.k + b * st[3] + h * st[5];
  const uint16_t* v = p.v + b * st[6] + h * st[8];

  const int wr0 = warp * 16;  // the warp's query rows in the tile
  // the thread's two rows, wr0 + g and wr0 + g + 8: lse * log2(e) (+inf on
  // a fully masked row or past Sq) and Delta
  float lse2[2], delta[2] = {0.f, 0.f};
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = i0 + wr0 + g + 8 * half;
    if constexpr (kDelta) {
      const float l = i < p.Sq ? p.lse[(static_cast<int64_t>(b) * p.Sq + i) * p.H + h] : kNegInf;
      lse2[half] = l > kHalfNegInf ? l * kLog2e : __int_as_float(0x7f800000);
    } else {
      const int64_t at = static_cast<int64_t>(bh) * p.Sq + i;
      lse2[half] = i < p.Sq ? p.lse2[at] : __int_as_float(0x7f800000);
      delta[half] = i < p.Sq ? p.delta[at] : 0.f;
    }
  }
  float dq[kDelta ? 1 : DT / 8][4];
#pragma unroll
  for (int n = 0; n < (kDelta ? 1 : DT / 8); ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;

  // the keys the CTA's last row may see (causal: kv_offset + j <= i)
  int keys = p.Sk;
  if (p.causal) keys = max(0, min(p.Sk, min(i0 + kBwdRows, p.Sq) - p.kv_offset));
  const uint32_t aQ = smem_u32(sQ), adO = smem_u32(sdO), aK = smem_u32(sK),
                 aV = smem_u32(sV);
  for (int j0 = 0; j0 < keys; j0 += BK) {
    __syncthreads();  // the previous tile's readers are done (and Q, dO loaded)
    load_rows<BK, DT>(sK, k, st[4], j0, p.Sk, p.D);
    load_rows<BK, DT>(sV, v, st[7], j0, p.Sk, p.D);
    __syncthreads();

    // S = Q K^T (the warp's 16 queries x BK keys), then P in place
    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    mma_abt<kBf16, DT, BK>(s, aQ, wr0, aK, P * 2, lane);
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + wr0 + g + 8 * (e >> 1);
        const int j = j0 + n * 8 + 2 * t + (e & 1);
        const bool keep = j < p.Sk && i < p.Sq && (!p.causal || p.kv_offset + j <= i);
        s[n][e] = keep ? ex2(fmaf(s[n][e], p.scale_log2, -lse2[e >> 1])) : 0.f;
      }
    }
    // dP = dO V^T
    float dp[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[n][e] = 0.f;
    mma_abt<kBf16, DT, BK>(dp, adO, wr0, aV, P * 2, lane);
    if constexpr (kDelta) {
      // this thread's share of the rows' sum_j P o dP, in f32
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) delta[e >> 1] = fmaf(s[n][e], dp[n][e], delta[e >> 1]);
    } else {
      // dS = P o (dP - Delta); dQ += dS K
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] *= dp[n][e] - delta[e >> 1];
      mma_xb<kBf16, BK, DT>(dq, s, aK, P * 2, lane);
    }
  }
  if constexpr (kDelta) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      // the four threads of a row group hold the row's columns
      float sum = delta[half];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const int i = i0 + wr0 + g + 8 * half;
      if (t == 0 && i < p.Sq) {
        const int64_t at = static_cast<int64_t>(bh) * p.Sq + i;
        const int64_t row = (static_cast<int64_t>(b) * p.Sq + i) * p.H + h;
        p.delta[at] = sum - (p.g_lse != nullptr ? p.g_lse[row] : 0.f);
        p.lse2[at] = lse2[half];
      }
    }
  } else {
    store_rows<kBf16, DT>(p.dq + b * st[12] + h * st[14], st[13], dq, p.scale, i0 + wr0, p.Sq,
                          p.D, lane);
  }
}

template <int DT, bool kBf16>
__global__ void __launch_bounds__(kBwdThreads) flash_bwd_delta_kernel(const BwdParams p) {
  query_pass<DT, kBf16, true>(p);
}

template <int DT, bool kBf16>
__global__ void __launch_bounds__(kBwdThreads) flash_bwd_dq_kernel(const BwdParams p) {
  query_pass<DT, kBf16, false>(p);
}

template <int DT, bool kBf16>
cudaError_t launch_bwd(const BwdParams& p, cudaStream_t stream) {
  constexpr int smem = BwdTile<DT>::kSmemBytes;
  const void* kernels[3] = {reinterpret_cast<const void*>(&flash_bwd_delta_kernel<DT, kBf16>),
                            reinterpret_cast<const void*>(&flash_bwd_dkdv_kernel<DT, kBf16>),
                            reinterpret_cast<const void*>(&flash_bwd_dq_kernel<DT, kBf16>)};
  for (const void* kernel : kernels) {
    const cudaError_t err = configure_once(kernel, smem, 0, kBwdThreads);
    if (err != cudaSuccess) return err;
  }
  const unsigned bh = static_cast<unsigned>(p.B * p.H);
  const dim3 query_grid((p.Sq + kBwdRows - 1) / kBwdRows, bh);
  cudaError_t err = cudaSuccess;
  if (p.Sq > 0) {
    flash_bwd_delta_kernel<DT, kBf16><<<query_grid, kBwdThreads, smem, stream>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (p.Sk > 0) {
    flash_bwd_dkdv_kernel<DT, kBf16>
        <<<dim3((p.Sk + kBwdRows - 1) / kBwdRows, bh), kBwdThreads, smem, stream>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (p.Sq > 0) {
    flash_bwd_dq_kernel<DT, kBf16><<<query_grid, kBwdThreads, smem, stream>>>(p);
    err = cudaGetLastError();
  }
  return err;
}

template <bool kBf16>
cudaError_t launch_bwd_tile(const BwdParams& p, cudaStream_t stream) {
  if (p.D <= 32) return launch_bwd<32, kBf16>(p, stream);
  if (p.D <= 64) return launch_bwd<64, kBf16>(p, stream);
  if (p.D <= 96) return launch_bwd<96, kBf16>(p, stream);
  return launch_bwd<128, kBf16>(p, stream);
}

}  // namespace

// dq, dk, dv of attention (see the top of this file).  `strides` holds the
// batch, sequence and head strides (elements) of q, k, v, dout, dq, dk and
// dv, 21 in all; every head dim stride is 1.  lse and g_lse (may be null)
// are contiguous [B, Sq, H].  `scratch` holds 2*B*H*Sq floats.  dtype: 0
// bf16, 1 fp16.  Returns cudaGetLastError() of the launches (0 on success).
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
  BwdParams p;
  p.q = static_cast<const uint16_t*>(q);
  p.k = static_cast<const uint16_t*>(k);
  p.v = static_cast<const uint16_t*>(v);
  p.dout = static_cast<const uint16_t*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.g_lse = static_cast<const float*>(g_lse);
  p.dq = static_cast<uint16_t*>(dq);
  p.dk = static_cast<uint16_t*>(dk);
  p.dv = static_cast<uint16_t*>(dv);
  p.delta = static_cast<float*>(scratch);
  p.lse2 = p.delta + static_cast<int64_t>(B) * H * Sq;
  p.B = B;
  p.Sq = Sq;
  p.Sk = Sk;
  p.H = H;
  p.D = D;
  for (int i = 0; i < 21; ++i) p.st[i] = strides[i];
  p.causal = causal;
  p.kv_offset = kv_offset;
  p.scale = sm_scale;
  p.scale_log2 = sm_scale * kLog2e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 0 ? launch_bwd_tile<true>(p, s) : launch_bwd_tile<false>(p, s);
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
