// What the tensor-core kernels share (mha_tc.cu, mha_tc_bwd.cu, mha_tf32.cu, mha_tf32_bwd.cu,
// mha_bld_tf32.cu, mha_whole_tf32_bwd.cu, mha_probe.cu): 16-byte cp.async staging of bf16 or fp32 rows into padded
// shared-memory rows, ldmatrix fragment loads, the m16n8k16 bf16 product with
// fp32 accumulation, the approximate exponent and the bf16 packing of two
// accumulator values into one fragment register; for fp32 operands the TF32
// split, the m16n8k8 TF32 product and the store of a warp's accumulator rows;
// and the KV-block bodies of mha_tc.cu and mha_tf32.cu as functions, for the
// probes (mha_probe.cu).
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

// One warp's 16 query rows against one block of 64 staged keys: the body of the
// KV loops of mha_tc.cu (bf16) and mha_tf32.cu (split-TF32), operation for
// operation, with the row pitches, the key limit and the softmax as parameters
// (the probes of mha_probe.cu run them; the two shipped kernels keep their own
// copies). kst and vst point at the block's first key row (for several heads in
// a row, at the head's first column); kv0 is that key's index, keys the first
// index that is masked (L, or the end of a KV part), wrow the warp's first query
// row (read only under the causal mask). With the softmax: the running max m (in
// score units) and sum of rows g and g + 8, alpha on the accumulator o, p =
// exp2(s c - m c) with c = scale_log2. Without it (nosoftmax): p = s scale, masked
// entries 0, and o only accumulates.

template <int DH, int PITCH, bool SOFTMAX>
__device__ __forceinline__ void attend_block_bf16(const bf16* kst, const bf16* vst,
                                                  const uint32_t (&qf)[DH / 16][4],
                                                  float (&o)[DH / 8][4], float (&m)[2],
                                                  float (&sum)[2], int kv0, int keys, int wrow,
                                                  int causal, float scale_log2, float scale,
                                                  int lane) {
  constexpr int BN = 64;
  const int g = lane / 4, t = lane % 4;
  // S = Q K^T: 16 rows x 64 keys, eight n-tiles of 8 keys
  float s[BN / 8][4];
#pragma unroll
  for (int nt = 0; nt < BN / 8; ++nt) {
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DH / 32; ++kk) {
      uint32_t kb[4];
      ldmatrix_x4(kb, smem_u32(kst + (nt * 8 + lane % 8) * PITCH + kk * 32 + (lane / 8) * 8));
      mma_bf16(s[nt], qf[2 * kk], kb[0], kb[1]);
      mma_bf16(s[nt], qf[2 * kk + 1], kb[2], kb[3]);
    }
  }
  // the mask, only in a block that holds keys past the limit or above the diagonal
  if (kv0 + BN > keys || (causal && kv0 + BN - 1 > wrow)) {
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kv0 + nt * 8 + 2 * t + (e & 1);
        const int row = wrow + g + (e >> 1) * 8;
        if (key >= keys || (causal && key > row)) s[nt][e] = SOFTMAX ? kNegInf : 0.f;
      }
  }
  if constexpr (SOFTMAX) {
    // the running max, four partial maxima a row so that the chains are short
    float mx4[2][4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      mx4[e >> 1][e & 1] = fmaxf(s[0][e], s[1][e]);
      mx4[e >> 1][2 + (e & 1)] = fmaxf(s[2][e], s[3][e]);
    }
#pragma unroll
    for (int nt = 4; nt < BN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float& slot = mx4[e >> 1][2 * (nt / 2 % 2) + (e & 1)];
        slot = fmaxf(slot, s[nt][e]);
      }
    }
    float alpha[2], mc[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = fmaxf(fmaxf(fmaxf(mx4[r][0], mx4[r][1]), fmaxf(mx4[r][2], mx4[r][3])), m[r]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      alpha[r] = fast_exp2((m[r] - mx) * scale_log2);
      m[r] = mx;
      mc[r] = mx * scale_log2;
    }
    // p = exp2(s c - m c): one multiply-add and one exponent an element; four
    // partial sums a row
    float part4[2][4];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = fast_exp2(fmaf(s[nt][e], scale_log2, -mc[e >> 1]));
        float& slot = part4[e >> 1][2 * (nt % 2) + (e & 1)];
        slot = nt < 2 ? p : slot + p;
        s[nt][e] = p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
      sum[r] = sum[r] * alpha[r] + ((part4[r][0] + part4[r][1]) + (part4[r][2] + part4[r][3]));
#pragma unroll
    for (int dt = 0; dt < DH / 8; ++dt) {
      o[dt][0] *= alpha[0];
      o[dt][1] *= alpha[0];
      o[dt][2] *= alpha[1];
      o[dt][3] *= alpha[1];
    }
  } else {
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] *= scale;
  }
  // O += P V, P rounded to bf16 straight from the score fragments
#pragma unroll
  for (int j = 0; j < BN / 16; ++j) {
    const uint32_t pa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]), pack_bf16(s[2 * j][2], s[2 * j][3]),
                            pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                            pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
    for (int dp = 0; dp < DH / 16; ++dp) {
      uint32_t vb[4];
      ldmatrix_x4_trans(vb, smem_u32(vst + (j * 16 + (lane / 8 % 2) * 8 + lane % 8) * PITCH +
                                     dp * 16 + (lane / 16) * 8));
      mma_bf16(o[2 * dp], pa, vb[0], vb[1]);
      mma_bf16(o[2 * dp + 1], pa, vb[2], vb[3]);
    }
  }
}

// The same in fp32 on split-TF32 products (mha_tf32.cu's KV loop body): K rows
// of pitch KP, V rows of pitch VP floats; the warp's Q rows as fp32 in A
// fragment order (step kk's logical dims t and t + 4 are dims 8 kk + 2t and
// 8 kk + 2t + 1), split at each use; each block's P V in an accumulator of its
// own, added to O once.
template <int DH, int KP, int VP, bool SOFTMAX>
__device__ __forceinline__ void attend_block_tf32(const float* kst, const float* vst,
                                                  const float (&qf)[DH / 8][4],
                                                  float (&o)[DH / 8][4], float (&m)[2],
                                                  float (&sum)[2], int kv0, int keys, int wrow,
                                                  int causal, float scale_log2, float scale,
                                                  int lane) {
  constexpr int BN = 64;
  const int g = lane / 4, t = lane % 4;
  // S = Q K^T, the cross terms in an accumulator of their own
  float s[BN / 8][4], sx[BN / 8][4];
#pragma unroll
  for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = sx[nt][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DH / 8; ++kk) {
    uint32_t qb[4], qs[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) split_tf32(qf[kk][e], qb[e], qs[e]);
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      const float2 kf = *reinterpret_cast<const float2*>(kst + (nt * 8 + g) * KP + kk * 8 + 2 * t);
      uint32_t kb0, ks0, kb1, ks1;
      split_tf32(kf.x, kb0, ks0);
      split_tf32(kf.y, kb1, ks1);
      mma_tf32(sx[nt], qs, kb0, kb1);
      mma_tf32(sx[nt], qb, ks0, ks1);
      mma_tf32(s[nt], qb, kb0, kb1);
    }
  }
#pragma unroll
  for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] += sx[nt][e];

  if (kv0 + BN > keys || (causal && kv0 + BN - 1 > wrow)) {
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kv0 + nt * 8 + 2 * t + (e & 1);
        const int row = wrow + g + (e >> 1) * 8;
        if (key >= keys || (causal && key > row)) s[nt][e] = SOFTMAX ? kNegInf : 0.f;
      }
  }
  float alpha[2] = {1.f, 1.f};
  if constexpr (SOFTMAX) {
    float mx4[2][4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      mx4[e >> 1][e & 1] = fmaxf(s[0][e], s[1][e]);
      mx4[e >> 1][2 + (e & 1)] = fmaxf(s[2][e], s[3][e]);
    }
#pragma unroll
    for (int nt = 4; nt < BN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float& slot = mx4[e >> 1][2 * (nt / 2 % 2) + (e & 1)];
        slot = fmaxf(slot, s[nt][e]);
      }
    }
    float mc[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = fmaxf(fmaxf(fmaxf(mx4[r][0], mx4[r][1]), fmaxf(mx4[r][2], mx4[r][3])), m[r]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      alpha[r] = fast_exp2((m[r] - mx) * scale_log2);
      m[r] = mx;
      mc[r] = mx * scale_log2;
    }
    float part4[2][4];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = fast_exp2(fmaf(s[nt][e], scale_log2, -mc[e >> 1]));
        float& slot = part4[e >> 1][2 * (nt % 2) + (e & 1)];
        slot = nt < 2 ? p : slot + p;
        s[nt][e] = p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
      sum[r] = sum[r] * alpha[r] + ((part4[r][0] + part4[r][1]) + (part4[r][2] + part4[r][3]));
  } else {
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] *= scale;
  }
  float pv[DH / 8][4];
#pragma unroll
  for (int dt = 0; dt < DH / 8; ++dt) pv[dt][0] = pv[dt][1] = pv[dt][2] = pv[dt][3] = 0.f;
  // P V over eight steps of 8 keys; step j's logical keys t and t + 4 are keys
  // 8 j + 2t and 8 j + 2t + 1; n-tiles 2 dp and 2 dp + 1 take the even and the
  // odd columns of the group of 16 from column 16 dp
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    uint32_t pb[4], ps[4];
    split_tf32(s[j][0], pb[0], ps[0]);
    split_tf32(s[j][2], pb[1], ps[1]);
    split_tf32(s[j][1], pb[2], ps[2]);
    split_tf32(s[j][3], pb[3], ps[3]);
    const float* v0 = vst + (j * 8 + 2 * t) * VP + 2 * g;
#pragma unroll
    for (int dp = 0; dp < DH / 16; ++dp) {
      const float2 x0 = *reinterpret_cast<const float2*>(v0 + dp * 16);
      const float2 x1 = *reinterpret_cast<const float2*>(v0 + VP + dp * 16);
      uint32_t eb0, es0, eb1, es1, ob0, os0, ob1, os1;
      split_tf32(x0.x, eb0, es0);
      split_tf32(x1.x, eb1, es1);
      split_tf32(x0.y, ob0, os0);
      split_tf32(x1.y, ob1, os1);
      mma_3xtf32(pv[2 * dp], pb, ps, eb0, eb1, es0, es1);
      mma_3xtf32(pv[2 * dp + 1], pb, ps, ob0, ob1, os0, os1);
    }
  }
#pragma unroll
  for (int dt = 0; dt < DH / 8; ++dt) {
    if constexpr (SOFTMAX) {
      o[dt][0] = fmaf(o[dt][0], alpha[0], pv[dt][0]);
      o[dt][1] = fmaf(o[dt][1], alpha[0], pv[dt][1]);
      o[dt][2] = fmaf(o[dt][2], alpha[1], pv[dt][2]);
      o[dt][3] = fmaf(o[dt][3], alpha[1], pv[dt][3]);
    } else {
      o[dt][0] += pv[dt][0];
      o[dt][1] += pv[dt][1];
      o[dt][2] += pv[dt][2];
      o[dt][3] += pv[dt][3];
    }
  }
}

}  // namespace
