// What the tensor-core kernels share (mha_tc.cu, mha_tc_bwd.cu, mha_tf32.cu, mha_tf32_bwd.cu,
// mha_bld_tf32.cu, mha_whole_tf32_bwd.cu): 16-byte cp.async staging of bf16 or fp32 rows into padded
// shared-memory rows, ldmatrix fragment loads, the m16n8k16 bf16 product with
// fp32 accumulation, the approximate exponent and the bf16 packing of two
// accumulator values into one fragment register; for fp32 operands the TF32
// split, the m16n8k8 TF32 product and the store of a warp's accumulator rows.
// Each source includes it after attention_common.cuh and keeps its own copy
// (internal linkage).

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTcPad = 8;  // bf16 elements of padding per staged row: 16 bytes
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or 16 zero bytes when src_bytes is 0.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
// 4 bytes global -> shared, or 4 zero bytes when src_bytes is 0.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c (16 x 8, fp32) += a (16 x 16, bf16, row-major) . b (16 x 8, bf16, column-major)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two floats rounded to bf16, the first in the low half: one fragment register.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A thread's share of staging ROWS rows of DH bf16 elements into rows of pitch
// DH + kTcPad: the block's threads cover THREADS / (DH / 8) rows a pass, 16
// bytes a thread, and this thread copies its piece of each pass. dst and src
// are its piece of the first pass (row `row`), pass_stride the elements between
// passes in src; rows from `valid` on are zeroed and their source is not read.
// The addresses are the caller's, computed once, so a pass is one copy and one
// compare.
template <int DH, int ROWS, int THREADS>
__device__ __forceinline__ void stage_rows(uint32_t dst, const bf16* src, int64_t pass_stride,
                                           int row, int valid) {
  constexpr int PASS = THREADS / (DH / 8), PITCH = DH + kTcPad;
  static_assert(ROWS % PASS == 0, "the threads must tile the rows");
#pragma unroll
  for (int j = 0; j < ROWS / PASS; ++j)
    cp_async16(dst + j * PASS * PITCH * (int)sizeof(bf16), src + j * pass_stride,
               row + j * PASS < valid ? 16 : 0);
}

// The A fragment (16 rows x 16 columns from column k0) of the 16 rows from
// `row0` of a staged tile.
__device__ __forceinline__ void load_a_fragment(uint32_t (&a)[4], const bf16* tile, int pitch,
                                                int row0, int k0, int lane) {
  ldmatrix_x4(a, smem_u32(tile + (row0 + (lane / 8 % 2) * 8 + lane % 8) * pitch + k0 +
                          (lane / 16) * 8));
}

// fp32 operands on the tensor cores (mha_tf32.cu, mha_tf32_bwd.cu): split-TF32 products.

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from zero,
// the low 13 bits zero so that it reads back as a float: the bits
// cvt.rna.tf32.f32 gives for every finite x, in two integer operations where
// the cvt instruction is lowered to three with its NaN and infinity checks
// (measured: the split kernel 23-30% faster; PERF.md).
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = big + small: big = tf32(x), small = tf32(x - big); big + small holds x to
// about 2^-22 of |x|.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

// c (16 x 8, fp32) += a (16 x 8, tf32, row-major) . b (8 x 8, tf32, column-major)
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a . b at close to fp32 accuracy from the split parts (3xTF32): the two
// cross terms first, the product of the big parts last, as CUTLASS's fast-fp32
// operator orders them; the small . small term is below fp32's last bit.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&a_big)[4],
                                           const uint32_t (&a_small)[4], uint32_t b_big0,
                                           uint32_t b_big1, uint32_t b_small0, uint32_t b_small1) {
  mma_tf32(c, a_small, b_big0, b_big1);
  mma_tf32(c, a_big, b_small0, b_small1);
  mma_tf32(c, a_big, b_big0, b_big1);
}

// A warp's 16 x DH fp32 accumulator (m16n8k8 C fragments, columns 8d .. 8d + 7
// in acc[d]) to rows first + g and first + g + 8 of out, those before L: a
// thread holds columns 8d + 2t and 8d + 2t + 1, one float2 each; out points at
// row `first`.
template <int DH>
__device__ __forceinline__ void store_rows(const float (&acc)[DH / 8][4], float* out,
                                           int64_t row_stride, int first, int L, int g, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (first + g + 8 * r >= L) continue;
    float* row = out + (int64_t)(g + 8 * r) * row_stride + 2 * t;
#pragma unroll
    for (int d = 0; d < DH / 8; ++d)
      *reinterpret_cast<float2*>(row + d * 8) = make_float2(acc[d][2 * r], acc[d][2 * r + 1]);
  }
}

// A thread's share of staging ROWS rows of DH fp32 elements into rows of
// PITCH floats, 16 bytes (4 floats) a copy: stage_rows's contract for fp32.
template <int DH, int ROWS, int THREADS, int PITCH>
__device__ __forceinline__ void stage_rows_f32(uint32_t dst, const float* src, int64_t pass_stride,
                                               int row, int valid) {
  constexpr int PASS = THREADS / (DH / 4);
  static_assert(ROWS % PASS == 0, "the threads must tile the rows");
  static_assert(PITCH % 4 == 0, "staged rows must start on 16 bytes");
#pragma unroll
  for (int j = 0; j < ROWS / PASS; ++j)
    cp_async16(dst + j * PASS * PITCH * (int)sizeof(float), src + j * pass_stride,
               row + j * PASS < valid ? 16 : 0);
}

}  // namespace
