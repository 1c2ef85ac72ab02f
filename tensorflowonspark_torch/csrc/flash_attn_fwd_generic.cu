// Flash-attention forward for f32 inputs with any head dim D <= 256, on
// CUDA cores: online softmax over key blocks, returning the output O and
// the row log-sum-exp.
//
// Replaces, for the inputs the tensor-core kernels do not take, the TPU
// kernel tensorflowonspark_tpu/ops/attention.py:_flash_fwd_kernel (launched
// by _flash_fwd_pallas through pl.pallas_call), which takes any float type
// and any D (it pads D to 128 lanes and computes in f32).
// ops/attention.py sends here only f32 with 128 < D <= 256: bf16/fp16 at
// any D <= 256 go to the wgmma kernel (flash_attn_fwd.cu) and f32 with
// D <= 128 to the 3xTF32 wgmma kernel (flash_attn_fwd_tf32.cu).  The
// contract is the other kernels':
//   q [B,Sq,H,D], k/v [B,Sk,H,D] in f32, with unit stride along D ->
//   O [B,Sq,H,D] and lse [B,Sq,H] in f32;
//   key j sits at global position kpos = kv_offset + j; the causal mask keeps
//   kpos <= qpos, the tail mask keeps j < Sk; a row with every position
//   masked gives O = 0 and lse = NEG_INF (-1e30), never NaN;
//   key blocks wholly in the causal future of a CTA's rows are not loaded.
// All arithmetic is f32 FMA on CUDA cores (no TF32), as the JAX package's
// f32 path computes.
//
// Bound at B=4, S=2048, H=4, D=256, causal: the two products cost
// 4*B*H*D * (S*(S+1)/2) = 34.4 GFLOP, 0.514 ms at the card's 66.9 TFLOP/s
// of f32 FMA, against 134 MB of q/k/v/O/lse traffic, 0.040 ms at 3.35 TB/s:
// bound by the f32 operations.
//
// Design (simple and right first; making it fast is later work): one CTA
// per (batch*head, 64 query rows), 256 threads = 8 warps, 8 query rows per
// warp.
// - Q's 64 rows are staged once in shared memory, D rounded up to a
//   multiple of 4 with zeros.  K and V tiles of 32 keys are staged per block
//   (rows padded by 4 floats so that the per-lane 16-byte reads of K
//   rows fall in distinct banks).
// - S = Q K^T: lane j of a warp owns key j of the tile and accumulates its 8
//   rows' dot products, reading its K row as float4 and the Q rows as
//   float4 broadcasts.
// - Online softmax per row across the warp (shuffle max and sum), with f32
//   expf and the NEG_INF guards of chunk_attention.
// - O += P V: lane c owns head-dim columns c, c+32, ... (8 of them); P's
//   entries for key j come from lane j by shuffle, V's row j from shared
//   memory, one FMA per (row, column).
// - Epilogue: O / l, lse = m + log l (NEG_INF where l = 0).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (tensorflowonspark_torch/ops/cuda_build.py does it).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;            // query rows per CTA
constexpr int kBlockK = 32;            // keys per staged tile: one per lane
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kBlockQ / kWarps;  // query rows per warp
constexpr int kMaxD = 256;
constexpr int kCols = kMaxD / 32;      // head-dim columns per lane in P V
constexpr float kNegInf = -1e30f;
constexpr float kHalfNegInf = -5e29f;  // "masked" threshold, as NEG_INF / 2
constexpr unsigned kFull = 0xffffffffu;

struct Strides {
  int64_t q[3], k[3], v[3], o[3];  // (batch, seq, head), in elements
};

// Round D up to a multiple of 4 (the float4 step of Q K^T); K/V rows add 4
// more floats of padding.
__host__ __device__ __forceinline__ int round4(int d) { return (d + 3) & ~3; }

// Stage rows [row0, row0 + nrows) of x (one head) into smem with row
// stride ld, zero past nvalid rows and past column D.
__device__ __forceinline__ void stage(float* smem, int ld, const float* x,
                                      int64_t row_stride, int row0, int nrows,
                                      int nvalid, int D, int Dr) {
  for (int idx = threadIdx.x; idx < nrows * Dr; idx += kThreads) {
    const int r = idx / Dr, d = idx - r * Dr;
    const int row = row0 + r;
    float val = 0.f;
    if (row < nvalid && d < D) val = x[row * row_stride + d];
    smem[r * ld + d] = val;
  }
}

__global__ void __launch_bounds__(kThreads)
flash_fwd_generic_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         float* __restrict__ lse, int H, int Sq, int Sk, int D,
                         Strides st, int causal, int kv_offset, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int Dr = round4(D);
  const int ldk = Dr + 4;
  float* qs = smem;                       // [kBlockQ][Dr]
  float* ks = qs + kBlockQ * Dr;          // [kBlockK][ldk]
  float* vs = ks + kBlockK * ldk;         // [kBlockK][ldk]

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.y * kBlockQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* qh = q + b * st.q[0] + h * st.q[2];
  const float* kh = k + b * st.k[0] + h * st.k[2];
  const float* vh = v + b * st.v[0] + h * st.v[2];

  // Keys any row of this CTA can see: the causal mask keeps
  // kv_offset + j <= qpos, so j <= qmax - kv_offset.
  int kend = Sk;
  if (causal) {
    const int qmax = min(q0 + kBlockQ, Sq) - 1;
    kend = max(0, min(Sk, qmax - kv_offset + 1));
  }

  stage(qs, Dr, qh, st.q[1], q0, kBlockQ, Sq, D, Dr);

  float acc[kRows][kCols];
  float m[kRows], l[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
  }
  const int row_base = warp * kRows;  // this warp's rows within the CTA

  for (int k0 = 0; k0 < kend; k0 += kBlockK) {
    __syncthreads();  // the previous tile's readers are done
    stage(ks, ldk, kh, st.k[1], k0, kBlockK, kend, D, Dr);
    stage(vs, ldk, vh, st.v[1], k0, kBlockK, kend, D, Dr);
    __syncthreads();

    // S = Q K^T for this lane's key and the warp's rows.
    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.f;
    const float* krow = ks + lane * ldk;
    for (int d = 0; d < Dr; d += 4) {
      const float4 kv4 = *reinterpret_cast<const float4*>(krow + d);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 q4 =
            *reinterpret_cast<const float4*>(qs + (row_base + r) * Dr + d);
        s[r] = fmaf(q4.x, kv4.x, s[r]);
        s[r] = fmaf(q4.y, kv4.y, s[r]);
        s[r] = fmaf(q4.z, kv4.z, s[r]);
        s[r] = fmaf(q4.w, kv4.w, s[r]);
      }
    }

    // Mask, then the online softmax per row across the warp.
    const int j = k0 + lane;
    float p[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qpos = q0 + row_base + r;
      const bool keep = j < kend && (!causal || kv_offset + j <= qpos);
      const float x = keep ? s[r] * scale : kNegInf;
      float mx = x;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      const float m_new = fmaxf(m[r], mx);
      // no key of this row visible so far: p and alpha stay 0
      const bool live = m_new > kHalfNegInf;
      p[r] = (live && keep) ? expf(x - m_new) : 0.f;
      const float alpha =
          (live && m[r] > kHalfNegInf) ? expf(m[r] - m_new) : 0.f;
      float ps = p[r];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        ps += __shfl_xor_sync(kFull, ps, off);
      l[r] = l[r] * alpha + ps;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] *= alpha;
    }

    // O += P V: key jj's probabilities come from lane jj.
    const int nk = min(kBlockK, kend - k0);
    for (int jj = 0; jj < nk; ++jj) {
      float vv[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int d = lane + 32 * c;
        vv[c] = d < Dr ? vs[jj * ldk + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float pj = __shfl_sync(kFull, p[r], jj);
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[r][c] = fmaf(pj, vv[c], acc[r][c]);
      }
    }
  }

  // Epilogue: O = acc / l in the input type; lse = m + log l.
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qpos = q0 + row_base + r;
    if (qpos >= Sq) break;
    const bool any = l[r] > 0.f;
    const float inv = any ? 1.f / l[r] : 0.f;
    float* orow = o + b * st.o[0] + qpos * st.o[1] + h * st.o[2];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = lane + 32 * c;
      if (d < D) orow[d] = any ? acc[r][c] * inv : 0.f;
    }
    if (lane == 0)
      lse[(static_cast<int64_t>(b) * Sq + qpos) * H + h] =
          any ? m[r] + logf(l[r]) : kNegInf;
  }
}

int smem_bytes(int D) {
  const int Dr = round4(D);
  return static_cast<int>(sizeof(float)) * (kBlockQ * Dr + 2 * kBlockK * (Dr + 4));
}

cudaError_t launch(const float* q, const float* k, const float* v, float* o,
                   float* lse, int B, int Sq, int Sk, int H, int D,
                   const Strides& st, int causal, int kv_offset, float scale,
                   cudaStream_t stream) {
  auto kernel = flash_fwd_generic_kernel;
  const int smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  // batch*head on x (up to 2^31 - 1), query tiles on y (up to 65,535)
  const int tiles = (Sq + kBlockQ - 1) / kBlockQ;
  if (tiles > 65535) return cudaErrorInvalidValue;
  const dim3 grid(B * H, tiles);
  kernel<<<grid, kThreads, smem, stream>>>(q, k, v, o, lse, H, Sq, Sk, D, st,
                                           causal, kv_offset, scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o f32.  strides: 12 int64 (batch, seq, head) of q, k, v, o in
// elements; D has unit stride.  Returns a cudaError_t code.
extern "C" int tos_flash_attn_fwd_generic(const void* q, const void* k,
                                          const void* v, void* o, void* lse,
                                          int B, int Sq, int Sk, int H, int D,
                                          const int64_t* strides, int causal,
                                          int kv_offset, float sm_scale,
                                          void* stream) {
  if (D <= 0 || D > kMaxD) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || H <= 0 || Sq <= 0) return 0;  // nothing to launch
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
    st.o[i] = strides[9 + i];
  }
  return static_cast<int>(launch(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), B, Sq, Sk, H, D, st, causal, kv_offset,
      sm_scale, static_cast<cudaStream_t>(stream)));
}

// Dynamic shared memory of one CTA for head dim D (<= 256), else 0.
extern "C" int tos_flash_attn_fwd_generic_smem_bytes(int D) {
  return D > 0 && D <= kMaxD ? smem_bytes(D) : 0;
}
