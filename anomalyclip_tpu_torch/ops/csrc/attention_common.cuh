// What the attention kernels share (mha.cu, mha_bwd.cu, mha_long.cu): the block
// shape, the conversions between the operand type and fp32, the warp
// reductions, the strided operand, and the opt-in to more than 48 KB of dynamic
// shared memory. Each source includes it and keeps its own copy (internal
// linkage), so the sources still compile one nvcc call each.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerBlock = 64;  // query rows per block of the forward kernels
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// P (and in the backward dS) is cast to the operand type before the products
// that follow, as the TPU kernels do: a no-op in fp32, a bf16 rounding in bf16.
__device__ __forceinline__ float round_like(float x, float) { return x; }
__device__ __forceinline__ float round_like(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(x));
}

// An operand element of type T as it is staged in shared memory: as fp32
// (S = float) or as it is (S = T).
template <typename S, typename T> __device__ __forceinline__ S stage(T x) { return x; }
template <> __device__ __forceinline__ float stage<float, __nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// A staged K row of type S: dh elements and one 32-bit word of padding, so that
// the 32 lanes of a warp, reading 32 keys at one column, hit 32 banks.
template <typename S> __host__ __device__ constexpr int padded(int dh) {
  return dh + 4 / (int)sizeof(S);
}

// Two neighbouring elements of a staged row (c even) as floats.
__device__ __forceinline__ float2 load2(const float* p) { return make_float2(p[0], p[1]); }
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// The score of one query row (in registers) against a staged K row.
template <typename S, int DH>
__device__ __forceinline__ float dot_row(const float* qr, const S* kr) {
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < DH; c += 2) {
    const float2 kk = load2(kr + c);
    s = fmaf(qr[c], kk.x, s);
    s = fmaf(qr[c + 1], kk.y, s);
  }
  return s;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

struct Operand {
  const void* ptr;  // element (batch 0, row 0, column 0) of head 0
  int64_t batch_stride;
  int64_t row_stride;  // columns are contiguous; head h starts at column h * DH
};

// Allow dynamic shared memory up to the card's opt-in limit, once per kernel.
template <typename Kernel>
cudaError_t allow_optin_smem(Kernel kernel, bool* done) {
  if (*done) return cudaSuccess;
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err == cudaSuccess) *done = true;
  return err;
}

}  // namespace
