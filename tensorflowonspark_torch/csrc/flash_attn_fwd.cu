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
// What the design does about it: both products run on the tensor cores
// (mma.sync m16n8k16, bf16/fp16 in, f32 accumulate); the [S, S] logits never
// leave registers; K and V are read from device memory once per 64-row query
// block; query blocks of the causal diagonal start first (they are the
// longest).  This is the simple, correct first version: 64x64 tiles, four
// warps of 16 query rows each, K/V tiles staged through shared memory with
// plain 16-byte loads and no overlap of copy and compute.  wgmma, TMA and a
// pipelined producer/consumer split are the next steps towards the bound.
//
// The TPU kernel's sequential k axis of the grid (with m/l/acc carried in
// VMEM scratch from one grid step to the next) is the loop over key blocks
// inside one thread block here; the grid is (B*H, query blocks).  There is no
// head-major transpose and no padding of D: the kernel reads the [B,S,H,D]
// strides it is given and masks the ragged tails itself.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (tensorflowonspark_torch/ops/cuda_build.py does it).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kWarps = 4;  // each warp owns 16 query rows of the block
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;
constexpr float kHalfNegInf = -5e29f;  // "masked" threshold, as NEG_INF / 2

template <bool kBf16>
__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  if constexpr (kBf16) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

// Elements d, d+1 of row `row` (0 past the last row).
__device__ __forceinline__ uint32_t load_pair(const uint16_t* base, int row,
                                              int rows, int64_t row_stride,
                                              int d) {
  if (row >= rows) return 0u;
  return *reinterpret_cast<const uint32_t*>(base + row * row_stride + d);
}

template <int D, bool kBf16>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                 const uint16_t* __restrict__ v, uint16_t* __restrict__ o,
                 float* __restrict__ lse, int H, int Sq, int Sk,
                 int64_t q_sb, int64_t q_ss, int64_t q_sh,
                 int64_t k_sb, int64_t k_ss, int64_t k_sh,
                 int64_t v_sb, int64_t v_ss, int64_t v_sh,
                 int64_t o_sb, int64_t o_ss, int64_t o_sh,
                 int causal, int kv_offset, float sm_scale) {
  static_assert(D % 16 == 0, "D must be a multiple of 16");
  constexpr int kStride = D + 8;  // smem row pitch: 16-byte rows, no bank conflicts
  constexpr int kDSteps = D / 16;         // k-steps of Q K^T
  constexpr int kDTiles = D / 8;          // n-tiles of P V
  constexpr int kKTiles = kBlockK / 8;    // n-tiles of Q K^T
  constexpr int kVecPerRow = D / 8;       // 16-byte vectors per K/V row
  __shared__ __align__(16) uint16_t ks[kBlockK * kStride];
  __shared__ __align__(16) uint16_t vs[kBlockK * kStride];

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int qb = gridDim.y - 1 - blockIdx.y;  // longest causal blocks first
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // row within the mma tile
  const int t = lane & 3;   // column pair within the mma tile
  const int q0 = qb * kBlockQ;
  const int r0 = q0 + warp * 16 + g;  // this thread's rows: r0 and r0 + 8

  const uint16_t* qbase = q + b * q_sb + h * q_sh;
  const uint16_t* kbase = k + b * k_sb + h * k_sh;
  const uint16_t* vbase = v + b * v_sb + h * v_sh;

  // Q stays in registers, as mma A fragments, for the whole key loop.
  uint32_t qf[kDSteps][4];
#pragma unroll
  for (int s = 0; s < kDSteps; ++s) {
    const int d = s * 16 + 2 * t;
    qf[s][0] = load_pair(qbase, r0, Sq, q_ss, d);
    qf[s][1] = load_pair(qbase, r0 + 8, Sq, q_ss, d);
    qf[s][2] = load_pair(qbase, r0, Sq, q_ss, d + 8);
    qf[s][3] = load_pair(qbase, r0 + 8, Sq, q_ss, d + 8);
  }

  float acc[kDTiles][4];
#pragma unroll
  for (int i = 0; i < kDTiles; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums

  // Keys past the last one any row of this block may see are never loaded.
  int kend = Sk;
  if (causal) {
    const int qlast = min(q0 + kBlockQ, Sq) - 1;
    kend = min(Sk, max(0, qlast - kv_offset + 1));
  }
  const int nkb = (kend + kBlockK - 1) / kBlockK;

  for (int kb = 0; kb < nkb; ++kb) {
    const int k0 = kb * kBlockK;
    __syncthreads();  // every warp is done with the previous tile
    for (int i = tid; i < kBlockK * kVecPerRow; i += kThreads) {
      const int row = i / kVecPerRow;
      const int c = (i % kVecPerRow) * 8;
      const int key = k0 + row;
      uint4 kv4 = make_uint4(0u, 0u, 0u, 0u);
      uint4 vv4 = make_uint4(0u, 0u, 0u, 0u);
      if (key < Sk) {  // zero past the tail: 0 * garbage could be NaN
        kv4 = *reinterpret_cast<const uint4*>(kbase + key * k_ss + c);
        vv4 = *reinterpret_cast<const uint4*>(vbase + key * v_ss + c);
      }
      *reinterpret_cast<uint4*>(&ks[row * kStride + c]) = kv4;
      *reinterpret_cast<uint4*>(&vs[row * kStride + c]) = vv4;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys.
    float s[kKTiles][4];
#pragma unroll
    for (int nt = 0; nt < kKTiles; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const uint16_t* krow = &ks[(nt * 8 + g) * kStride + 2 * t];
#pragma unroll
      for (int st = 0; st < kDSteps; ++st) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(krow + st * 16);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(krow + st * 16 + 8);
        mma16816<kBf16>(s[nt], qf[st], b0, b1);
      }
    }

    // Scale, mask, and the block's row maxima.
    float mblk[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < kKTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + ((e >> 1) << 3);
        const int j = k0 + nt * 8 + 2 * t + (e & 1);
        const bool live = j < Sk && (!causal || kv_offset + j <= row);
        const float x = live ? s[nt][e] * sm_scale : kNegInf;
        s[nt][e] = x;
        mblk[e >> 1] = fmaxf(mblk[e >> 1], x);
      }
    }
    float msafe[2];
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      // the four threads of a row group hold the row's 64 columns
      mblk[i] = fmaxf(mblk[i], __shfl_xor_sync(0xffffffffu, mblk[i], 1));
      mblk[i] = fmaxf(mblk[i], __shfl_xor_sync(0xffffffffu, mblk[i], 2));
      const float mnew = fmaxf(m[i], mblk[i]);
      msafe[i] = fmaxf(mnew, kHalfNegInf);
      alpha[i] = m[i] <= kHalfNegInf ? 0.f : expf(m[i] - msafe[i]);
      m[i] = mnew;
    }
    float lsum[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < kKTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[nt][e];
        const float p = x <= kHalfNegInf ? 0.f : expf(x - msafe[e >> 1]);
        s[nt][e] = p;
        lsum[e >> 1] += p;
      }
    }
    l[0] = l[0] * alpha[0] + lsum[0];
    l[1] = l[1] * alpha[1] + lsum[1];
#pragma unroll
    for (int dt = 0; dt < kDTiles; ++dt) {
      acc[dt][0] *= alpha[0];
      acc[dt][1] *= alpha[0];
      acc[dt][2] *= alpha[1];
      acc[dt][3] *= alpha[1];
    }

    // O += P V: the S accumulator layout is the A fragment layout of P.
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      const uint32_t a[4] = {
          pack2<kBf16>(s[2 * kk][0], s[2 * kk][1]),
          pack2<kBf16>(s[2 * kk][2], s[2 * kk][3]),
          pack2<kBf16>(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack2<kBf16>(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const uint16_t* vcol = &vs[(kk * 16 + 2 * t) * kStride + g];
#pragma unroll
      for (int dt = 0; dt < kDTiles; ++dt) {
        const uint16_t* p = vcol + dt * 8;
        const uint32_t b0 = uint32_t(p[0]) | (uint32_t(p[kStride]) << 16);
        const uint32_t b1 =
            uint32_t(p[8 * kStride]) | (uint32_t(p[9 * kStride]) << 16);
        mma16816<kBf16>(acc[dt], a, b0, b1);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int row = r0 + 8 * i;
    if (row >= Sq) continue;
    const float lsafe = fmaxf(l[i], 1e-30f);
    const float inv = 1.f / lsafe;
    uint16_t* orow = o + b * o_sb + row * o_ss + h * o_sh + 2 * t;
#pragma unroll
    for (int dt = 0; dt < kDTiles; ++dt) {
      *reinterpret_cast<uint32_t*>(orow + dt * 8) =
          pack2<kBf16>(acc[dt][2 * i] * inv, acc[dt][2 * i + 1] * inv);
    }
    if (t == 0) {
      lse[(static_cast<int64_t>(b) * Sq + row) * H + h] =
          l[i] > 0.f ? m[i] + logf(lsafe) : kNegInf;
    }
  }
}

template <int D, bool kBf16>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int Sq, int Sk, int H,
                   const int64_t* st, int causal, int kv_offset,
                   float sm_scale, cudaStream_t stream) {
  const dim3 grid(B * H, (Sq + kBlockQ - 1) / kBlockQ);
  flash_fwd_kernel<D, kBf16><<<grid, kThreads, 0, stream>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<uint16_t*>(o), lse, H, Sq,
      Sk, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11], causal, kv_offset, sm_scale);
  return cudaGetLastError();
}

}  // namespace

// C entry point, loaded with ctypes.  `strides` holds 12 element strides:
// (batch, seq, head) for q, k, v and o, in that order; the head_dim stride
// is 1.  dtype: 0 = bf16, 1 = fp16.  Returns cudaGetLastError() after the
// launch (0 on success).  Launches on `stream`, does not synchronise, and
// allocates nothing.
extern "C" int tos_flash_attn_fwd(const void* q, const void* k, const void* v,
                                  void* o, void* lse, int B, int Sq, int Sk,
                                  int H, int D, const int64_t* strides,
                                  int causal, int kv_offset, float sm_scale,
                                  int dtype, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0) return 0;  // nothing to launch
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  const bool bf16 = dtype == 0;
  cudaError_t err;
  if (D == 64) {
    err = bf16 ? launch<64, true>(q, k, v, o, l, B, Sq, Sk, H, strides, causal,
                                  kv_offset, sm_scale, s)
               : launch<64, false>(q, k, v, o, l, B, Sq, Sk, H, strides,
                                   causal, kv_offset, sm_scale, s);
  } else if (D == 128) {
    err = bf16 ? launch<128, true>(q, k, v, o, l, B, Sq, Sk, H, strides,
                                   causal, kv_offset, sm_scale, s)
               : launch<128, false>(q, k, v, o, l, B, Sq, Sk, H, strides,
                                    causal, kv_offset, sm_scale, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
