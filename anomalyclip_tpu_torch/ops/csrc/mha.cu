// Whole-row multi-head attention for Hopper (sm_90a), fp32 and bf16.
//
// Two C entries, one kernel:
//
//   acl_mha_qkv_fwd  replaces _mha_qkv_kernel / fused_mha_qkv
//                    (anomalyclip_tpu/ops/pallas/attention.py:423-466): attention
//                    from one packed (B, L, 3D) qkv, lane order q|k|v, heads split
//                    inside the kernel, optional causal mask. Serves the CLIP image
//                    tower (L=197, 12 heads, dh 64) and the causal text tower
//                    (L=77, 8 heads, dh 64).
//   acl_mha_bld_fwd  replaces _mha_bld_kernel / fused_mha_bld
//                    (attention.py:88-96, 386): the same function from separate
//                    (B, L, D) q, k, v. Serves the temporal model's axial attention
//                    (L=32 and L=16, 8 heads, dh 32), where k and v are the two
//                    halves of one (B, L, 2D) projection.
//
// Both read the head slices of their operands in place through element strides:
// no split, transpose or copy of q, k or v is made before the launch.
//
// What it computes is _attend_head (attention.py:68-85): fp32 scores, scaled, the
// causal entries set to -1e30, a row-max-subtracted fp32 exponent, P cast to the
// operand type before the P.V product (a no-op in fp32, a bf16 rounding in bf16),
// fp32 accumulation, and the normalising divide done on the output row.
//
// Design. One block per (batch entry, head, 64-query-row tile), 8 warps. The block
// stages that head's K and V for the whole sequence in dynamic shared memory as
// fp32 (at L=197, dh=64: 101 KB, above the 48 KB static limit, hence the
// cudaFuncSetAttribute below). Each warp then owns one query row at a time: the
// row of q sits in registers, lane j computes the scores of keys j, j+32, ...,
// the max and the sum are warp shuffles, the exponent row goes to the warp's
// slice of shared memory, and in the P.V product lane t owns output columns
// t, t+32. K rows are padded to dh+1 floats so that the 32 lanes of a warp,
// reading 32 different keys at the same column, hit 32 different banks.
//
// What bounds it on the card. At the image tower's shape the two products are
// 2 * 2 * L^2 * dh = 9.9 MFLOP per (batch, head), about 30 GFLOP a layer at 256
// frames, done here on the fp32 CUDA cores, not the tensor cores. Every
// multiply-add reads one operand from shared memory (the other is in a
// register), so shared-memory bandwidth, not the FMA rate or device memory,
// is the limit: device memory sees each K and V tile once per query tile
// (4 times at L=197), about 1.2 GB a layer in fp32. Moving the products onto
// wgmma with bf16 tiles and keeping P in registers is later work; this version
// is the simple one whose results are checked against the plain PyTorch
// formulation.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerBlock = 64;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// P is cast to v's type before the P.V product, as the TPU kernel does.
__device__ __forceinline__ float round_like(float x, float) { return x; }
__device__ __forceinline__ float round_like(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(x));
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
  const void* ptr;   // element (batch 0, row 0, column 0) of head 0
  int64_t batch_stride;
  int64_t row_stride;  // columns are contiguous; head h starts at column h * DH
};

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
mha_fwd_kernel(Operand q, Operand k, Operand v, T* __restrict__ out, int L, int H,
               int causal, float scale) {
  extern __shared__ float smem[];
  float* ks = smem;                      // L x (DH + 1)
  float* vs = ks + L * (DH + 1);         // L x DH
  float* ps = vs + L * DH;               // kWarps x L   exponent rows
  float* qs = ps + kWarps * L;           // kWarps x DH  query rows

  const int b = blockIdx.x;  // x: the one grid dimension not capped at 65535
  const int h = blockIdx.y;
  const int tile = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  const T* kp = static_cast<const T*>(k.ptr) + b * k.batch_stride + h * DH;
  const T* vp = static_cast<const T*>(v.ptr) + b * v.batch_stride + h * DH;
  const T* qp = static_cast<const T*>(q.ptr) + b * q.batch_stride + h * DH;
  T* op = out + (int64_t)b * L * H * DH + h * DH;

  for (int i = threadIdx.x; i < L * DH; i += kThreads) {
    const int r = i / DH, c = i % DH;
    ks[r * (DH + 1) + c] = to_float(kp[r * k.row_stride + c]);
    vs[r * DH + c] = to_float(vp[r * v.row_stride + c]);
  }
  __syncthreads();

  float* prow = ps + warp * L;
  float* qrow = qs + warp * DH;
  const int row_end = min(L, (tile + 1) * kRowsPerBlock);
  for (int row = tile * kRowsPerBlock + warp; row < row_end; row += kWarps) {
    for (int c = lane; c < DH; c += 32) qrow[c] = to_float(qp[row * q.row_stride + c]);
    __syncwarp();
    float qr[DH];
#pragma unroll
    for (int c = 0; c < DH; ++c) qr[c] = qrow[c];

    float m = kNegInf;
    for (int j = lane; j < L; j += 32) {
      float s = 0.f;
      const float* kr = ks + j * (DH + 1);
#pragma unroll
      for (int c = 0; c < DH; ++c) s = fmaf(qr[c], kr[c], s);
      s *= scale;
      if (causal && j > row) s = kNegInf;
      prow[j] = s;
      m = fmaxf(m, s);
    }
    m = warp_max(m);

    float denom = 0.f;
    for (int j = lane; j < L; j += 32) {
      const float e = expf(prow[j] - m);
      denom += e;
      prow[j] = round_like(e, T());
    }
    denom = warp_sum(denom);
    __syncwarp();

    float acc[DH / 32];
#pragma unroll
    for (int t = 0; t < DH / 32; ++t) acc[t] = 0.f;
    for (int j = 0; j < L; ++j) {
      const float p = prow[j];
#pragma unroll
      for (int t = 0; t < DH / 32; ++t) acc[t] = fmaf(p, vs[j * DH + lane + 32 * t], acc[t]);
    }
#pragma unroll
    for (int t = 0; t < DH / 32; ++t)
      op[(int64_t)row * H * DH + lane + 32 * t] = from_float<T>(acc[t] / denom);
    __syncwarp();
  }
}

size_t smem_bytes(int L, int dh) {
  return sizeof(float) * ((size_t)L * (dh + 1) + (size_t)L * dh + (size_t)kWarps * L +
                          (size_t)kWarps * dh);
}

template <typename T, int DH>
cudaError_t launch_typed(Operand q, Operand k, Operand v, void* out, int B, int L, int H,
                         int causal, float scale, cudaStream_t stream) {
  static bool attribute_set = false;
  const size_t smem = smem_bytes(L, DH);
  if (!attribute_set) {
    // allow dynamic shared memory up to the card's opt-in limit, once
    int device = 0, optin = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(mha_fwd_kernel<T, DH>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) return err;
    attribute_set = true;
  }
  dim3 grid(B, H, (L + kRowsPerBlock - 1) / kRowsPerBlock);
  mha_fwd_kernel<T, DH><<<grid, kThreads, smem, stream>>>(
      q, k, v, static_cast<T*>(out), L, H, causal, scale);
  return cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16. dh: 32 or 64.
cudaError_t launch(int dtype, Operand q, Operand k, Operand v, void* out, int B, int L,
                   int H, int dh, int causal, float scale, cudaStream_t stream) {
  if (dtype == 0 && dh == 32)
    return launch_typed<float, 32>(q, k, v, out, B, L, H, causal, scale, stream);
  if (dtype == 0 && dh == 64)
    return launch_typed<float, 64>(q, k, v, out, B, L, H, causal, scale, stream);
  if (dtype == 1 && dh == 32)
    return launch_typed<__nv_bfloat16, 32>(q, k, v, out, B, L, H, causal, scale, stream);
  if (dtype == 1 && dh == 64)
    return launch_typed<__nv_bfloat16, 64>(q, k, v, out, B, L, H, causal, scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Shared-memory bytes one block needs, so the caller can refuse a shape early.
size_t acl_mha_smem_bytes(int L, int dh) { return smem_bytes(L, dh); }

// K1. qkv: (B, L, 3D) with element strides (batch_stride, row_stride, 1);
// out: contiguous (B, L, D), D = H * dh.
int acl_mha_qkv_fwd(int dtype, const void* qkv, int batch_stride, int row_stride, void* out,
                    int B, int L, int H, int dh, int causal, float scale, void* stream) {
  const int D = H * dh;
  const size_t esize = dtype == 0 ? 4 : 2;
  const char* base = static_cast<const char*>(qkv);
  Operand q{base, batch_stride, row_stride};
  Operand k{base + esize * D, batch_stride, row_stride};
  Operand v{base + esize * 2 * D, batch_stride, row_stride};
  return (int)launch(dtype, q, k, v, out, B, L, H, dh, causal, scale,
                     static_cast<cudaStream_t>(stream));
}

// K2. q, k, v: (B, L, D) each with its own element strides (last stride 1);
// out: contiguous (B, L, D).
int acl_mha_bld_fwd(int dtype, const void* q, int q_bs, int q_rs, const void* k, int k_bs,
                    int k_rs, const void* v, int v_bs, int v_rs, void* out, int B, int L,
                    int H, int dh, int causal, float scale, void* stream) {
  Operand qo{q, q_bs, q_rs};
  Operand ko{k, k_bs, k_rs};
  Operand vo{v, v_bs, v_rs};
  return (int)launch(dtype, qo, ko, vo, out, B, L, H, dh, causal, scale,
                     static_cast<cudaStream_t>(stream));
}

}  // extern "C"
