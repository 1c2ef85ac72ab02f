// The 16-bit (bf16/fp16) wgmma products and tensor maps shared by the
// attention forward (flash_attn_fwd.cu) and backward (flash_attn_bwd.cu):
// the SS product of two K-major operands in shared memory, the RS product
// of an A operand in registers with an MN-major B in shared memory, the
// rounding of two f32 values into one A register, and on the host the
// tensor map of a [B, S, H, D] operand read through its strides.

#pragma once

#include "hopper_pipeline.cuh"

namespace {

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
  static_assert(N == 64 || N == 128, "the SS products are m64n64 or m64n128");
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
#define TOS_RS_N192(TY)                                                       \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"                  \
               "wgmma.mma_async.sync.aligned.m64n192k16.f32." TY "." TY      \
               " {" TOS_R96 "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n" \
               : TOS_ACC96                                                    \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))
#define TOS_RS_N128(TY)                                                      \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                  \
               "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY     \
               " {" TOS_R64 "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n" \
               : TOS_ACC64                                                   \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))
#define TOS_RS_N96(TY)                                                       \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"                  \
               "wgmma.mma_async.sync.aligned.m64n96k16.f32." TY "." TY      \
               " {" TOS_R48 "}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n" \
               : TOS_ACC48                                                   \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))
#define TOS_RS_N64(TY)                                                       \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                  \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY      \
               " {" TOS_R32 "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n" \
               : TOS_ACC32                                                   \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))
#define TOS_RS_N32(TY)                                                       \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"                  \
               "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY      \
               " {" TOS_R16 "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n" \
               : TOS_ACC16                                                   \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

template <int N, bool kBf16>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  static_assert(N == 32 || N == 64 || N == 96 || N == 128 || N == 192 || N == 256,
                "the RS products are m64n32, n64, n96, n128, n192 or n256");
  if constexpr (N == 256) {
    if constexpr (kBf16) {
      TOS_RS_N256("bf16");
    } else {
      TOS_RS_N256("f16");
    }
  } else if constexpr (N == 192) {
    if constexpr (kBf16) {
      TOS_RS_N192("bf16");
    } else {
      TOS_RS_N192("f16");
    }
  } else if constexpr (N == 128) {
    if constexpr (kBf16) {
      TOS_RS_N128("bf16");
    } else {
      TOS_RS_N128("f16");
    }
  } else if constexpr (N == 96) {
    if constexpr (kBf16) {
      TOS_RS_N96("bf16");
    } else {
      TOS_RS_N96("f16");
    }
  } else if constexpr (N == 64) {
    if constexpr (kBf16) {
      TOS_RS_N64("bf16");
    } else {
      TOS_RS_N64("f16");
    }
  } else {
    if constexpr (kBf16) {
      TOS_RS_N32("bf16");
    } else {
      TOS_RS_N32("f16");
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

// Map of a [B, S, H, D] operand read through its element strides
// (batch, seq, head): dims (D, S, H, B), box (cols, rows, 1, 1) with the
// 128-byte swizzle at 64 columns and the 64-byte one at 32, elements out of
// bounds (rows past S, columns past D) zero-filled.  A dimension of size 1
// is never stepped over, so its stride is set to a legal 16 bytes.
inline bool encode_map(CUtensorMap* map, const void* ptr, bool bf16, int B, int S,
                       int H, int D, const int64_t* st, int rows, int cols = 64) {
  const int s = S > 0 ? S : 1;  // Sk = 0: nothing is loaded, the map stays legal
  auto bytes = [](int64_t stride, int n) -> cuuint64_t {
    return n == 1 ? 16 : static_cast<cuuint64_t>(stride) * 2;
  };
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {bytes(st[1], s), bytes(st[2], H), bytes(st[0], B)};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(cols), static_cast<cuuint32_t>(rows),
                             1, 1};
  return encode_map_4d(map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                 : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
                       ptr, dims, strides, box,
                       cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B);
}

}  // namespace
