// Hopper (sm_90a) building blocks shared by the attention kernels
// flash_attn_fwd.cu (bf16/fp16 on wgmma) and flash_attn_fwd_tf32.cu (f32 as
// 3xTF32 on wgmma): mbarriers, TMA tile loads, wgmma descriptors, fences and
// accumulator operand lists, the pipelined wgmma wait of the wide routes,
// the masked online-softmax step of a key block, and the host-side
// tensor-map encoder
// (cuTensorMapEncodeTiled through cudaGetDriverEntryPoint, so the libraries
// do not link libcuda).

#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: libcuda is not linked
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kHalfNegInf = -5e29f;  // "masked" threshold, as NEG_INF / 2
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the phase of parity `parity` has completed.  A wait of more
// than about 4 s of SM clock can only be a broken pipeline: trap, so the
// launch fails with an error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  constexpr long long kWatchdogCycles = 1ll << 33;
  long long start = 0;
  for (int spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (spins == 0) {
      start = clock64();
    } else if (clock64() - start > kWatchdogCycles) {
      __trap();
    }
  }
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3), "r"(bar) : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map))
               : "memory");
}

// wgmma shared-memory descriptor for a 128-byte-swizzled operand (layout
// type 1 in bits 62-63).  K-major: LBO unused (16), SBO = 1024, the stride
// between 8-row groups.  MN-major: LBO = stride between 128-byte-wide boxes,
// SBO = 1024, the stride between groups of 8 rows along K.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Wait until at most N committed wgmma groups are still in flight: the wide
// routes keep one Q K^T chunk's group running while the stage of the one
// before it is released.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator accesses between a wgmma
// and its wait.
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One key block of the online softmax on S in the wgmma accumulator layout
// (per warp w of the warpgroup and lane = 4g + t, d[4n + e] holds row
// 16w + g + 8*(e >> 1), column 8n + 2t + (e & 1); r0 is the thread's first
// row): keys j past Sk or, causal, with kv_offset + j past the row are
// masked to kNegInf, only on blocks that straddle the diagonal of the rows
// from q_first on or the Sk tail; then the running max m (of the raw
// logits), the accumulator and the row sums l (this thread's share) are
// rescaled, and S is overwritten by P = exp2(S * scale_log2 - m_safe *
// scale_log2).  Every exp is guarded, so a row with every position masked
// keeps l = 0 and O = 0.
template <int BK, int NACC>
__device__ __forceinline__ void online_softmax_block(
    float (&sc)[BK / 2], float (&acc)[NACC], float (&m)[2], float (&l)[2],
    int k0, int q_first, int r0, int t, int Sk, int causal, int kv_offset,
    float scale_log2) {
  if (k0 + BK > Sk || (causal && kv_offset + k0 + BK - 1 > q_first)) {
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + ((e >> 1) << 3);
        const int j = k0 + n * 8 + 2 * t + (e & 1);
        if (!(j < Sk && (!causal || kv_offset + j <= row)))
          sc[4 * n + e] = kNegInf;
      }
    }
  }
  // exp2 with the scale folded in
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * n + e]);
  }
  float alpha[2];
  float mscaled[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    // the four threads of a row group hold the row's BK columns
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
  for (int n = 0; n < BK / 8; ++n) {
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
  for (int n = 0; n < NACC / 4; ++n) {
    acc[4 * n + 0] *= alpha[0];
    acc[4 * n + 1] *= alpha[0];
    acc[4 * n + 2] *= alpha[1];
    acc[4 * n + 3] *= alpha[1];
  }
}

// ---------------------------------------------------------------------------
// Host side.
// ---------------------------------------------------------------------------

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                   void*, const cuuint64_t*, const cuuint64_t*,
                                   const cuuint32_t*, const cuuint32_t*,
                                   CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// Rank-4 map with 128-byte swizzle, elements out of bounds zero-filled.
// `dims` innermost first, `strides` the byte strides of dims 1..3 (a
// dimension of size 1 is never stepped over: pass any legal stride).
inline bool encode_map_4d(CUtensorMap* map, CUtensorMapDataType type,
                          const void* ptr, const cuuint64_t (&dims)[4],
                          const cuuint64_t (&strides)[3],
                          const cuuint32_t (&box)[4]) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, type, 4, const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// Inline-asm operands of a wgmma accumulator `d`: TOS_ACCn lists d[0..n-1]
// as "+f" operands, TOS_Rn the matching "%0, ..., %n-1".
#define TOS_ACC8(i)                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define TOS_ACC16 TOS_ACC8(0), TOS_ACC8(8)
#define TOS_ACC32 TOS_ACC16, TOS_ACC8(16), TOS_ACC8(24)
#define TOS_ACC64 TOS_ACC32, TOS_ACC8(32), TOS_ACC8(40), TOS_ACC8(48), TOS_ACC8(56)
#define TOS_ACC128                                                           \
  TOS_ACC64, TOS_ACC8(64), TOS_ACC8(72), TOS_ACC8(80), TOS_ACC8(88),          \
      TOS_ACC8(96), TOS_ACC8(104), TOS_ACC8(112), TOS_ACC8(120)
#define TOS_R16 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define TOS_R32                                                              \
  TOS_R16                                                                    \
  ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31"
#define TOS_R64                                                              \
  TOS_R32                                                                    \
  ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, " \
  "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "   \
  "%60, %61, %62, %63"
#define TOS_R128                                                               \
  TOS_R64                                                                      \
  ", %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, "   \
  "%78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, " \
  "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, "    \
  "%106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "   \
  "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
