// Whole-head multi-head attention backward for Hopper (sm_90a), fp32 and bf16.
//
// Two C entries, one kernel:
//
//   acl_mha_qkv_bwd  replaces _mha_qkv_bwd_kernel / _mha_qkv_bwd_impl
//                    (anomalyclip_tpu/ops/pallas/attention.py:291-311, 362-382):
//                    the gradient of fused_mha_qkv, read from the packed
//                    (B, L, 3D) qkv and written as one packed (B, L, 3D) dqkv.
//                    Serves the CoOp gradient through the causal text tower
//                    (L=77, 8 heads, dh 64).
//   acl_mha_bld_bwd  replaces _mha_bld_bwd_kernel / _mha_bld_bwd_impl
//                    (attention.py:273-288, 340-358): dq, dk, dv of fused_mha_bld
//                    from separate (B, L, D) q, k, v. Serves the temporal model's
//                    axial attention (L=32 and L=16, 8 heads, dh 32), where k and
//                    v are the two halves of one (B, L, 2D) projection.
//
// What it computes is _mha_bwd_head (attention.py:244-270), per (batch, head):
// S = Q K^T * scale with the causal entries at -1e30, P = softmax(S) normalised
// in fp32 (e / sum, unlike the forward, which divides at the end), dP = G V^T,
// delta = rowsum(P o dP), dS = P o (dP - delta) * scale rounded to the operand
// type, then dQ = dS K, dK = dS^T Q and dV = round(P)^T G, each accumulated in
// fp32 and stored in the operand type. Scores and P are recomputed from q and k;
// nothing but q, k, v is saved by the forward.
//
// Design. One block owns a whole (batch entry, head), 8 warps. dK and dV sum
// over every query row, so a split of the head over query tiles, as the
// forward makes, would need a reduction across blocks: atomics, whose order
// (and so whose fp32 result) changes from run to run. At the sequence lengths of
// this model (L <= 77) one block holds the whole head instead: Q, K, V and G as
// fp32 in dynamic shared memory, rows padded to dh+1 floats, and P and dS as
// L x L fp32 tiles (L=77, dh=64: 80 KB + 47 KB; L=32, dh=32: 25 KB). First pass:
// a warp per query row builds the row of P, dP, delta and dS, lane j owning keys
// j, j+32, ..., with the row's max and sums as warp shuffles. After one
// __syncthreads, each thread owns output elements (row r, column c), lanes on
// neighbouring columns: dQ rows reduce over keys, dK and dV rows over queries,
// every read of the L x L tiles a broadcast. Every sum stays inside the block,
// in a fixed order, with no atomics.
//
// What bounds it on the card. The four products are 4 * L^2 * dh multiply-adds
// per (batch, head) (about 1.5 M at the text shape), each reading one operand
// from shared memory, on the fp32 CUDA cores: shared-memory bandwidth is the
// limit, not device memory (each operand is read once and each gradient written
// once). At L=77 the text backward is only 14 x 8 = 112 blocks for 132 SMs, one
// block per SM at 125 KB each; at L=32 and L=16 it is thousands of small blocks.
// Tensor cores, occupancy and splitting the text heads are later work; this
// version is the simple one checked against the plain PyTorch formulation.
// Shared memory grows as L^2: at dh=64 a head fits up to about L=117, so an
// unfrozen ViT (L=197) is refused by the wrapper, not launched.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// The helpers below repeat mha.cu's: each source compiles on its own, and the
// package ships the .cu files alone.
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// dS and P are cast to the operand type before the second-stage products, as
// the TPU kernel does: a no-op in fp32, a bf16 rounding in bf16.
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
  const void* ptr;  // element (batch 0, row 0, column 0) of head 0
  int64_t batch_stride;
  int64_t row_stride;  // columns are contiguous; head h starts at column h * DH
};

struct Output {
  void* ptr;
  int64_t batch_stride;
  int64_t row_stride;
};

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
mha_bwd_kernel(Operand q, Operand k, Operand v, Operand g, Output dq, Output dk, Output dv,
               int L, int causal, float scale) {
  extern __shared__ float smem[];
  constexpr int P = DH + 1;  // padded row of the staged operands
  float* qs = smem;          // L x P
  float* ks = qs + L * P;    // L x P
  float* vs = ks + L * P;    // L x P
  float* gs = vs + L * P;    // L x P
  float* ps = gs + L * P;    // L x L   P, then P rounded to the operand type
  float* ds = ps + L * L;    // L x L   dP, then dS rounded to the operand type

  const int b = blockIdx.x;  // x: the one grid dimension not capped at 65535
  const int h = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  const T* qp = static_cast<const T*>(q.ptr) + b * q.batch_stride + h * DH;
  const T* kp = static_cast<const T*>(k.ptr) + b * k.batch_stride + h * DH;
  const T* vp = static_cast<const T*>(v.ptr) + b * v.batch_stride + h * DH;
  const T* gp = static_cast<const T*>(g.ptr) + b * g.batch_stride + h * DH;
  for (int i = threadIdx.x; i < L * DH; i += kThreads) {
    const int r = i / DH, c = i % DH;
    qs[r * P + c] = to_float(qp[r * q.row_stride + c]);
    ks[r * P + c] = to_float(kp[r * k.row_stride + c]);
    vs[r * P + c] = to_float(vp[r * v.row_stride + c]);
    gs[r * P + c] = to_float(gp[r * g.row_stride + c]);
  }
  __syncthreads();

  // pass 1: a warp per query row -> rows of P (rounded) and dS (rounded)
  for (int row = warp; row < L; row += kWarps) {
    float* prow = ps + row * L;
    float* drow = ds + row * L;
    const int kend = causal ? row + 1 : L;  // keys past kend are masked: P = 0
    float reg[DH];  // the query row, then the gradient row
#pragma unroll
    for (int c = 0; c < DH; ++c) reg[c] = qs[row * P + c];
    float m = kNegInf;
    for (int j = lane; j < L; j += 32) {
      float s = kNegInf;
      if (j < kend) {
        float acc = 0.f;
        const float* kr = ks + j * P;
#pragma unroll
        for (int c = 0; c < DH; ++c) acc = fmaf(reg[c], kr[c], acc);
        s = acc * scale;
      }
      prow[j] = s;
      m = fmaxf(m, s);
    }
    m = warp_max(m);
    float denom = 0.f;
    for (int j = lane; j < L; j += 32) {
      const float e = expf(prow[j] - m);
      prow[j] = e;
      denom += e;
    }
    denom = warp_sum(denom);

#pragma unroll
    for (int c = 0; c < DH; ++c) reg[c] = gs[row * P + c];
    float delta = 0.f;
    for (int j = lane; j < L; j += 32) {
      const float p = prow[j] / denom;
      float dp = 0.f;
      if (j < kend) {
        const float* vr = vs + j * P;
#pragma unroll
        for (int c = 0; c < DH; ++c) dp = fmaf(reg[c], vr[c], dp);
      }
      prow[j] = p;
      drow[j] = dp;
      delta += p * dp;
    }
    delta = warp_sum(delta);
    for (int j = lane; j < L; j += 32) {
      const float p = prow[j];
      drow[j] = round_like(p * (drow[j] - delta) * scale, T());
      prow[j] = round_like(p, T());
    }
  }
  __syncthreads();

  // pass 2: each thread owns (row r, column c) of dQ, dK and dV
  T* dqp = static_cast<T*>(dq.ptr) + b * dq.batch_stride + h * DH;
  T* dkp = static_cast<T*>(dk.ptr) + b * dk.batch_stride + h * DH;
  T* dvp = static_cast<T*>(dv.ptr) + b * dv.batch_stride + h * DH;
  for (int i = threadIdx.x; i < L * DH; i += kThreads) {
    const int r = i / DH, c = i % DH;
    float acc = 0.f;
    const int kend = causal ? r + 1 : L;
    for (int j = 0; j < kend; ++j) acc = fmaf(ds[r * L + j], ks[j * P + c], acc);
    dqp[r * dq.row_stride + c] = from_float<T>(acc);

    const int qbegin = causal ? r : 0;  // query rows that see key r
    acc = 0.f;
    for (int t = qbegin; t < L; ++t) acc = fmaf(ds[t * L + r], qs[t * P + c], acc);
    dkp[r * dk.row_stride + c] = from_float<T>(acc);

    acc = 0.f;
    for (int t = qbegin; t < L; ++t) acc = fmaf(ps[t * L + r], gs[t * P + c], acc);
    dvp[r * dv.row_stride + c] = from_float<T>(acc);
  }
}

size_t smem_bytes(int L, int dh) {
  return sizeof(float) * (4 * (size_t)L * (dh + 1) + 2 * (size_t)L * L);
}

template <typename T, int DH>
cudaError_t launch_typed(Operand q, Operand k, Operand v, Operand g, Output dq, Output dk,
                         Output dv, int B, int L, int H, int causal, float scale,
                         cudaStream_t stream) {
  static bool attribute_set = false;
  if (!attribute_set) {
    // allow dynamic shared memory up to the card's opt-in limit, once
    int device = 0, optin = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(mha_bwd_kernel<T, DH>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) return err;
    attribute_set = true;
  }
  dim3 grid(B, H);
  mha_bwd_kernel<T, DH><<<grid, kThreads, smem_bytes(L, DH), stream>>>(
      q, k, v, g, dq, dk, dv, L, causal, scale);
  return cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16. dh: 32 or 64.
cudaError_t launch(int dtype, Operand q, Operand k, Operand v, Operand g, Output dq, Output dk,
                   Output dv, int B, int L, int H, int dh, int causal, float scale,
                   cudaStream_t stream) {
  if (dtype == 0 && dh == 32)
    return launch_typed<float, 32>(q, k, v, g, dq, dk, dv, B, L, H, causal, scale, stream);
  if (dtype == 0 && dh == 64)
    return launch_typed<float, 64>(q, k, v, g, dq, dk, dv, B, L, H, causal, scale, stream);
  if (dtype == 1 && dh == 32)
    return launch_typed<__nv_bfloat16, 32>(q, k, v, g, dq, dk, dv, B, L, H, causal, scale,
                                           stream);
  if (dtype == 1 && dh == 64)
    return launch_typed<__nv_bfloat16, 64>(q, k, v, g, dq, dk, dv, B, L, H, causal, scale,
                                           stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Shared-memory bytes one block needs, so the caller can refuse a shape early.
size_t acl_mha_bwd_smem_bytes(int L, int dh) { return smem_bytes(L, dh); }

// K3. qkv: (B, L, 3D) with element strides (batch_stride, row_stride, 1);
// g: contiguous (B, L, D); dqkv: contiguous (B, L, 3D), D = H * dh.
int acl_mha_qkv_bwd(int dtype, const void* qkv, int batch_stride, int row_stride,
                    const void* g, void* dqkv, int B, int L, int H, int dh, int causal,
                    float scale, void* stream) {
  const int D = H * dh;
  const size_t esize = dtype == 0 ? 4 : 2;
  const char* in = static_cast<const char*>(qkv);
  char* out = static_cast<char*>(dqkv);
  Operand q{in, batch_stride, row_stride};
  Operand k{in + esize * D, batch_stride, row_stride};
  Operand v{in + esize * 2 * D, batch_stride, row_stride};
  Operand go{g, (int64_t)L * D, D};
  Output dq{out, (int64_t)L * 3 * D, 3 * D};
  Output dk{out + esize * D, (int64_t)L * 3 * D, 3 * D};
  Output dv{out + esize * 2 * D, (int64_t)L * 3 * D, 3 * D};
  return (int)launch(dtype, q, k, v, go, dq, dk, dv, B, L, H, dh, causal, scale,
                     static_cast<cudaStream_t>(stream));
}

// K4. q, k, v, g: (B, L, D) each with its own element strides (last stride 1);
// dq, dk, dv: contiguous (B, L, D).
int acl_mha_bld_bwd(int dtype, const void* q, int q_bs, int q_rs, const void* k, int k_bs,
                    int k_rs, const void* v, int v_bs, int v_rs, const void* g, int g_bs,
                    int g_rs, void* dq, void* dk, void* dv, int B, int L, int H, int dh,
                    int causal, float scale, void* stream) {
  const int D = H * dh;
  Operand qo{q, q_bs, q_rs};
  Operand ko{k, k_bs, k_rs};
  Operand vo{v, v_bs, v_rs};
  Operand go{g, g_bs, g_rs};
  Output dqo{dq, (int64_t)L * D, D};
  Output dko{dk, (int64_t)L * D, D};
  Output dvo{dv, (int64_t)L * D, D};
  return (int)launch(dtype, qo, ko, vo, go, dqo, dko, dvo, B, L, H, dh, causal, scale,
                     static_cast<cudaStream_t>(stream));
}

}  // extern "C"
