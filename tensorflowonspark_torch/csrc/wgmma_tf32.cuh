// The .tf32 wgmma products and helpers shared by the f32 attention forward
// (flash_attn_fwd_tf32.cu) and backward (flash_attn_bwd_tf32.cu): the split
// of an f32 value into the TF32 parts of a 3xTF32 product, the SS product
// of two K-major operands in shared memory, the RS product of an A operand
// in registers with a K-major B in shared memory (a .tf32 wgmma reads its
// shared-memory operands only K-major: there is no transpose bit), and on
// the host the tensor map of an f32 operand read through its strides.

#pragma once

#include "hopper_pipeline.cuh"

namespace {

// x with its low 13 mantissa bits cleared: what a .tf32 operand reads.
__device__ __forceinline__ float tf32_hi(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xffffe000u);
}
// x rounded to TF32, to nearest (ties away from zero), as an f32 bit pattern.
__device__ __forceinline__ float tf32_round(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}
__device__ __forceinline__ float tf32_lo(float x) {
  return tf32_round(x - tf32_hi(x));
}

// S (64 x 32, f32) (+)= A (64 x 8, smem K-major) * B^T (32 x 8, smem
// K-major), tf32; scale_d = 0 overwrites S.
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32"
               " {" TOS_R16 "}, %16, %17, p, 1, 1;\n}\n"
               : TOS_ACC16 : "l"(da), "l"(db), "r"(scale_d));
}

// O (64 x N, f32) (+)= A (64 x 8, registers) * B (8 x N, smem K-major),
// tf32; scale_d = 0 overwrites O.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d = 1) {
  static_assert(N == 32 || N == 64 || N == 96 || N == 128 || N == 256,
                "the RS products are m64n32, n64, n96, n128 or n256, k8");
  if constexpr (N == 256) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32"
                 " {" TOS_R128 "}, {%128, %129, %130, %131}, %132, p, 1, 1;\n}\n"
                 : TOS_ACC128
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  } else if constexpr (N == 128) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32"
                 " {" TOS_R64 "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
                 : TOS_ACC64
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  } else if constexpr (N == 96) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32"
                 " {" TOS_R48 "}, {%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
                 : TOS_ACC48
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  } else if constexpr (N == 64) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32"
                 " {" TOS_R32 "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
                 : TOS_ACC32
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  } else {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32"
                 " {" TOS_R16 "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
                 : TOS_ACC16
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
}

// Map of an f32 tensor with dims (d0, d1, d2, d3), innermost first, element
// strides s1..s3, box (32, rows, 1, 1) with the 128-byte swizzle.  A
// dimension of size 1 is never stepped over, so its stride is set to a
// legal 16 bytes; a zero-length one is declared 1 (nothing is loaded from
// it).  Elements out of bounds are zero-filled.
inline bool encode_f32(CUtensorMap* map, const void* ptr, int64_t d0, int64_t d1,
                       int64_t d2, int64_t d3, int64_t s1, int64_t s2, int64_t s3,
                       int rows) {
  auto bytes = [](int64_t stride, int64_t n) -> cuuint64_t {
    return n <= 1 ? 16 : static_cast<cuuint64_t>(stride) * 4;
  };
  auto dim = [](int64_t n) -> cuuint64_t { return n > 0 ? n : 1; };
  const cuuint64_t dims[4] = {dim(d0), dim(d1), dim(d2), dim(d3)};
  const cuuint64_t strides[3] = {bytes(s1, d1), bytes(s2, d2), bytes(s3, d3)};
  const cuuint32_t box[4] = {32, static_cast<cuuint32_t>(rows), 1, 1};
  return encode_map_4d(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, ptr, dims, strides,
                       box);
}

}  // namespace
