// Hopper (sm_90a) building blocks shared by the attention kernels
// flash_attn_fwd.cu (bf16/fp16 on wgmma), flash_attn_fwd_tf32.cu (f32 as
// 3xTF32 on wgmma) and flash_attn_bwd.cu (the gradient, bf16/fp16 on
// wgmma): mbarriers, TMA tile loads, wgmma descriptors, fences and
// accumulator operand lists, the pipelined wgmma wait of the wide routes,
// the masked online-softmax step of a key block, the wide routes' split-KV
// combine kernel, and on the host the tensor-map encoder
// (cuTensorMapEncodeTiled through cudaGetDriverEntryPoint, so the libraries
// do not link libcuda, on the calling thread's bound context) and the
// once-per-instantiation launch setup.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: libcuda is not linked
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <utility>
#include <vector>

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

// wgmma shared-memory descriptor for a swizzled operand: `layout` in bits
// 62-63 is 1 for the 128-byte swizzle (rows of 128 bytes) and 2 for the
// 64-byte one (rows of 64 bytes).  K-major: LBO unused (16), SBO = the
// stride between 8-row groups (8 rows: 1024 or 512 bytes).  MN-major: LBO =
// the stride between swizzle-wide boxes along MN, SBO = the stride between
// groups of 8 rows along K.
constexpr uint32_t kSwizzle128 = 1, kSwizzle64 = 2;
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo,
                                              uint32_t layout = kSwizzle128) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) |
         (static_cast<uint64_t>(layout) << 62);
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
// Split-KV combine of the wide routes.  A call whose grid would leave most of
// the card idle (ops/attention.py:_wide_splits) cuts each query tile's key
// blocks into ranges (tile_ranges), one CTA each; in a tile of more than one
// range every range writes its O normalised over its own keys (f32, o_part
// [splits, B, Sq, H, D]) and its lse (lse_part [splits, B, Sq, H]), and this
// kernel merges them as ops/attention.py:merge_attention merges two chunks:
// lse = log sum_s exp(lse_s), O = sum_s exp(lse_s - lse) O_s, stored in the
// output type through O's strides (the rows of a tile of one range were
// written directly: the launch starts at the first row of a tile of more).  A row whose every range is
// NEG_INF (every key it may see masked) gives O = 0 and lse = NEG_INF
// exactly.  One thread per four columns of a row (D is a multiple of 4), so
// the reads of the ranges' O are spread over the whole card; the row's few
// lse values are read by each of its threads (from cache).
// ---------------------------------------------------------------------------
constexpr int kMaxSplits = 16;  // key ranges of one call at most

// Key blocks (of BK keys) the query rows before q_end may see: all of Sk,
// or, causal, those up to the last row's position.
__host__ __device__ __forceinline__ int reach_blocks(int q_end, int Sq, int Sk,
                                                     int causal, int kv_offset, int BK) {
  int keys = Sk;
  if (causal) {
    const int q = q_end < Sq ? q_end : Sq;
    keys = q - kv_offset < 0 ? 0 : q - kv_offset;
    keys = keys < Sk ? keys : Sk;
  }
  return (keys + BK - 1) / BK;
}

// The key ranges of the query tile of `rows` rows from q0 over `splits`:
// `per` blocks each, per = ceil(the longest tile's blocks / splits), over the
// tile's own `blocks`; `count` of them (at least 1).  A tile of one range
// writes O directly; a tile of more writes range k to o_part slot k.
struct TileRanges {
  int per, blocks, count;
};
__host__ __device__ __forceinline__ TileRanges tile_ranges(int q0, int rows, int Sq,
                                                           int Sk, int causal,
                                                           int kv_offset, int BK,
                                                           int splits) {
  const int longest = reach_blocks(Sq, Sq, Sk, causal, kv_offset, BK);
  const int per_min = (longest + splits - 1) / splits;
  const int per = per_min > 1 ? per_min : 1;
  const int blocks = reach_blocks(q0 + rows, Sq, Sk, causal, kv_offset, BK);
  const int count = (blocks + per - 1) / per;
  return {per, blocks, count > 1 ? count : 1};
}

// The first query row of the tiles of more than one range: a tile's blocks
// grow with its rows, so those tiles are the last ones.
inline int first_split_row(int rows, int Sq, int Sk, int causal, int kv_offset, int BK,
                           int splits) {
  int q0 = (Sq + rows - 1) / rows * rows;
  while (q0 > 0 &&
         tile_ranges(q0 - rows, rows, Sq, Sk, causal, kv_offset, BK, splits).count > 1)
    q0 -= rows;
  return q0;
}
constexpr int kOutBf16 = 0, kOutFp16 = 1, kOutF32 = 2;  // the combine's O type
constexpr int kCombineThreads = 256;

template <int kKind>
__device__ __forceinline__ void store4(void* o, int64_t at, float4 x) {
  if constexpr (kKind == kOutF32) {
    *reinterpret_cast<float4*>(static_cast<float*>(o) + at) = x;
  } else {
    uint2 v;
    if constexpr (kKind == kOutBf16) {
      __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
      __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
      v.x = *reinterpret_cast<uint32_t*>(&lo);
      v.y = *reinterpret_cast<uint32_t*>(&hi);
    } else {
      __half2 lo = __floats2half2_rn(x.x, x.y);
      __half2 hi = __floats2half2_rn(x.z, x.w);
      v.x = *reinterpret_cast<uint32_t*>(&lo);
      v.y = *reinterpret_cast<uint32_t*>(&hi);
    }
    *reinterpret_cast<uint2*>(static_cast<uint16_t*>(o) + at) = v;
  }
}

template <int kKind>
__global__ void __launch_bounds__(kCombineThreads)
combine_splits_kernel(const float* __restrict__ o_part,
                      const float* __restrict__ lse_part, void* __restrict__ o,
                      float* __restrict__ lse, int B, int Sq, int Sk, int H, int D,
                      int splits, int causal, int kv_offset, int tile_rows, int BK,
                      int row0, int64_t o_sb, int64_t o_ss, int64_t o_sh) {
  // this launch covers the rows from row0 on of every batch and head
  const int64_t span = static_cast<int64_t>(Sq - row0) * H;
  const int quads = D / 4;
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * kCombineThreads + threadIdx.x;
  if (idx >= B * span * quads) return;
  const int64_t local = idx / quads;
  const int col = static_cast<int>(idx % quads) * 4;
  const int b = static_cast<int>(local / span);
  const int row = row0 + static_cast<int>((local % span) / H);
  const int h = static_cast<int>(local % H);
  const int64_t rows = static_cast<int64_t>(B) * Sq * H;
  const int64_t r = (static_cast<int64_t>(b) * Sq + row) * H + h;  // as lse is laid out
  const int ranges = tile_ranges(row / tile_rows * tile_rows, tile_rows, Sq, Sk, causal,
                                 kv_offset, BK, splits).count;
  if (ranges == 1) return;  // written directly
  float mx = kNegInf;
  for (int s = 0; s < ranges; ++s) mx = fmaxf(mx, lse_part[s * rows + r]);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  float total = kNegInf;
  if (mx > kHalfNegInf) {
    float sum = 0.f;  // a NEG_INF range gives exp(...) = 0
    for (int s = 0; s < ranges; ++s) sum += expf(lse_part[s * rows + r] - mx);
    total = mx + logf(sum);
    for (int s = 0; s < ranges; ++s) {
      const float w = expf(lse_part[s * rows + r] - total);
      const float4 x = *reinterpret_cast<const float4*>(o_part + (s * rows + r) * D + col);
      acc.x += w * x.x;
      acc.y += w * x.y;
      acc.z += w * x.z;
      acc.w += w * x.w;
    }
  }
  if (col == 0) lse[r] = total;
  store4<kKind>(o, b * o_sb + row * o_ss + h * o_sh + col, acc);
}

// Grid of the combine over `rows` rows of D columns.
inline unsigned combine_blocks(int64_t rows, int D) {
  return static_cast<unsigned>((rows * (D / 4) + kCombineThreads - 1) / kCombineThreads);
}

// The combine, on `stream`, over the rows of the tiles of more than one
// range (ranges over `splits`, tiles of `tile_rows` rows, key blocks of BK).
template <int kKind>
cudaError_t launch_combine(const float* o_part, const float* lse_part, void* o,
                           float* lse, int B, int Sq, int Sk, int H, int D, int splits,
                           int causal, int kv_offset, int tile_rows, int BK,
                           const int64_t* st, cudaStream_t stream) {
  const int row0 = first_split_row(tile_rows, Sq, Sk, causal, kv_offset, BK, splits);
  if (row0 >= Sq) return cudaSuccess;  // every tile wrote O directly
  const int64_t rows = static_cast<int64_t>(B) * (Sq - row0) * H;
  combine_splits_kernel<kKind><<<combine_blocks(rows, D), kCombineThreads, 0, stream>>>(
      o_part, lse_part, o, lse, B, Sq, Sk, H, D, splits, causal, kv_offset, tile_rows, BK,
      row0, st[9], st[10], st[11]);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Host side.
// ---------------------------------------------------------------------------

// Launch setup of a kernel instantiation, done once per instantiation and
// device (not on every call): the dynamic shared memory it asks for, and,
// where it moves registers with setmaxnreg (min_regs > 0), that the launch
// reserves at least min_regs registers for its `threads` threads (the
// consumers' registers are only there if the launch reserves them).
inline cudaError_t configure_once(const void* kernel, int smem, int min_regs,
                                  int threads) {
  static std::mutex mu;
  static std::vector<std::pair<const void*, int>> done;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  for (const auto& e : done)
    if (e.first == kernel && e.second == dev) return cudaSuccess;
  if (min_regs > 0) {
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return err;
    if (attr.numRegs * threads < min_regs) return cudaErrorInvalidConfiguration;
  }
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  done.emplace_back(kernel, dev);
  return cudaSuccess;
}

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

// Makes the current device's primary context current on the calling
// thread, once per thread and device.  cuTensorMapEncodeTiled is a driver
// call and fails without a current context, and a thread that has so far
// made only runtime calls that need none (a fresh thread, such as
// autograd's device thread, whose tensors come from the caching allocator)
// has none: cudaSetDevice binds it.
inline bool bind_context() {
  thread_local int bound = -1;  // the device whose context this thread bound
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return false;
  if (dev != bound) {
    if (cudaSetDevice(dev) != cudaSuccess) return false;
    bound = dev;
  }
  return true;
}

// Rank-4 map with a 128-byte (or `swizzle`) swizzle, elements out of bounds
// zero-filled.  `dims` innermost first, `strides` the byte strides of dims
// 1..3 (a dimension of size 1 is never stepped over: pass any legal
// stride).
inline bool encode_map_4d(CUtensorMap* map, CUtensorMapDataType type,
                          const void* ptr, const cuuint64_t (&dims)[4],
                          const cuuint64_t (&strides)[3],
                          const cuuint32_t (&box)[4],
                          CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  if (!bind_context()) return false;
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, type, 4, const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
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
#define TOS_ACC48 TOS_ACC32, TOS_ACC8(32), TOS_ACC8(40)
#define TOS_ACC96 TOS_ACC64, TOS_ACC8(64), TOS_ACC8(72), TOS_ACC8(80), TOS_ACC8(88)
#define TOS_ACC128                                                           \
  TOS_ACC64, TOS_ACC8(64), TOS_ACC8(72), TOS_ACC8(80), TOS_ACC8(88),          \
      TOS_ACC8(96), TOS_ACC8(104), TOS_ACC8(112), TOS_ACC8(120)
#define TOS_R16 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define TOS_R32                                                              \
  TOS_R16                                                                    \
  ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31"
#define TOS_R48                                                              \
  TOS_R32                                                                    \
  ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, " \
  "%46, %47"
#define TOS_R64                                                              \
  TOS_R32                                                                    \
  ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, " \
  "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "   \
  "%60, %61, %62, %63"
#define TOS_R96                                                                \
  TOS_R64                                                                      \
  ", %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, "   \
  "%78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, " \
  "%93, %94, %95"
#define TOS_R128                                                               \
  TOS_R64                                                                      \
  ", %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, "   \
  "%78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, " \
  "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, "    \
  "%106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "   \
  "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
