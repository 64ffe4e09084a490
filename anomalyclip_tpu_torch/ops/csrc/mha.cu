// Whole-row multi-head attention for Hopper (sm_90a) on the CUDA cores, fp32 and
// bf16.
//
// Which kernel serves which operands: in bf16 at head dim 64 fused_mha_qkv and
// fused_mha_qtile launch the tensor-core kernel of mha_tc.cu (every CLIP tower
// in bf16), and in fp32 at head dim 64 fused_mha_qkv launches the split-TF32
// kernel of mha_tf32.cu (every CLIP tower through the mha rung in fp32); the
// wrappers (ops/attention.py) choose before the launch. This kernel serves the
// rest: fused_mha_bld and fused_attention's whole-block branch in either type,
// fused_mha_qtile in fp32, and fused_mha_qkv at head dims 8, 16 and 32.
//
// Three C entries, one kernel:
//
//   acl_mha_qkv_fwd    replaces _mha_qkv_kernel / fused_mha_qkv
//                      (anomalyclip_tpu/ops/pallas/attention.py:423-466): attention
//                      from one packed (B, L, 3D) qkv, lane order q|k|v, heads split
//                      inside the kernel, optional causal mask. Its path shapes
//                      (the CLIP towers, dh 64) take mha_tc.cu in bf16 and
//                      mha_tf32.cu in fp32; here the head dims 8, 16 and 32.
//   acl_mha_bld_fwd    replaces _mha_bld_kernel / fused_mha_bld
//                      (attention.py:88-96, 386): the same function from separate
//                      (B, L, D) q, k, v. Serves the temporal model's axial attention
//                      (L=32 and L=16, 8 heads, dh 32), where k and v are the two
//                      halves of one (B, L, 2D) projection, and fused_attention's
//                      whole-block branch (attention.py:1089-1093) with the heads
//                      folded into the batch.
//   acl_mha_qtile_fwd  replaces _mha_qtile_kernel / fused_mha_qtile
//                      (attention.py:525-532, 604, 626): non-causal attention of q
//                      (B, L, D) against a packed k|v (B, L, 2D): fp32 shapes whose
//                      K and V fit (L <= 420 at dh 64), and bf16 below head dim 64.
//                      (The ViT-L/14@336px tower in bf16, the entry's one path
//                      shape, takes mha_tc.cu.)
//
// All read the head slices of their operands in place through element strides:
// no split, transpose or copy of q, k or v is made before the launch.
//
// What it computes is _attend_head (attention.py:68-85): fp32 scores, scaled, the
// causal entries set to -1e30, a row-max-subtracted fp32 exponent, P cast to the
// operand type before the P.V product (a no-op in fp32, a bf16 rounding in bf16),
// fp32 accumulation, and the normalising divide done on the output row.
//
// Design. One block per (batch entry, head, 64-query-row tile), 8 warps. The block
// stages that head's K and V for the whole sequence in dynamic shared memory, so
// each block computes complete softmax rows and needs no rescaling (what the TPU
// kernels do with their resident K|V block). Each warp then owns one query row at
// a time: the row of q sits in registers, lane j computes the scores of keys j,
// j+32, ..., the max and the sum are warp shuffles, the exponent row goes to the
// warp's slice of shared memory, and in the P.V product lane t owns output
// columns t, t+32 (at head dims 16 and 8, which the temporal model has at emb 128
// with 8 heads and at emb 32 with 4, the upper lanes own none). K rows are padded
// by one 32-bit word so that the 32 lanes of a warp, reading 32 different keys at
// the same column, hit 32 different banks.
//
// The staging type S is the one difference between the entries. K1 and K2 stage
// K and V as fp32 (at L=197, dh=64: 101 KB, above the 48 KB static limit, hence
// the opt-in below); that fits L <= 420 at dh 64 in the 227 KB a block may have.
// K6 stages them in the operand type: in bf16 at L=577, dh 64 that is 150 KB plus
// 18 KB of fp32 exponent rows, which fits where fp32 staging (311 KB) does not.
// In fp32 the two are one instantiation; an fp32 shape too long for it takes the
// flash kernel (mha_long.cu) instead.
//
// What bounds it on the card. At the image tower's shape the two products are
// 2 * 2 * L^2 * dh = 9.9 MFLOP per (batch, head), about 30 GFLOP a layer at 256
// frames, done here on the fp32 CUDA cores, not the tensor cores. Every
// multiply-add reads one operand from shared memory (the other is in a
// register), so shared-memory bandwidth (and in bf16 staging the conversions to
// fp32), not the FMA rate or device memory, is the limit: device memory sees each
// K and V tile once per query tile (4 times at L=197), about 1.2 GB a layer in
// fp32. For bf16 the products moved onto the tensor cores, with P kept in
// registers and K and V in blocks, in mha_tc.cu (39.9 -> 1.7 ms at (256, 577,
// 1024), 2.94 -> 0.25 ms at (256, 197, 2304), NVIDIA H100 80GB HBM3, 700 W;
// PERF.md), and for fp32 at head dim 64 onto them as split-TF32 products in
// mha_tf32.cu; this version stays the simple one for the rest, whose results are
// checked against the plain PyTorch formulation.

#include <type_traits>

#include "attention_common.cuh"

namespace {

template <typename T, typename S, int DH>
__global__ void __launch_bounds__(kThreads)
mha_fwd_kernel(Operand q, Operand k, Operand v, T* __restrict__ out, int L, int H,
               int causal, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int KP = padded<S>(DH);
  S* ks = reinterpret_cast<S*>(smem);                 // L x KP
  S* vs = ks + L * KP;                                // L x DH
  float* ps = reinterpret_cast<float*>(vs + L * DH);  // kWarps x L   exponent rows
  float* qs = ps + kWarps * L;                        // kWarps x DH  query rows

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
    ks[r * KP + c] = stage<S>(kp[r * k.row_stride + c]);
    vs[r * DH + c] = stage<S>(vp[r * v.row_stride + c]);
  }
  __syncthreads();

  float* prow = ps + warp * L;
  float* qrow = qs + warp * DH;
  const int row_end = min(L, (tile + 1) * kRowsPerBlock);  // the last tile may be ragged
  for (int row = tile * kRowsPerBlock + warp; row < row_end; row += kWarps) {
    for (int c = lane; c < DH; c += 32) qrow[c] = to_float(qp[row * q.row_stride + c]);
    __syncwarp();
    float qr[DH];
#pragma unroll
    for (int c = 0; c < DH; ++c) qr[c] = qrow[c];

    float m = kNegInf;
    for (int j = lane; j < L; j += 32) {
      float s = dot_row<S, DH>(qr, ks + j * KP) * scale;
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

    constexpr int COLS = (DH + 31) / 32;  // output columns a lane owns
    // a constant where DH is a multiple of 32: every lane owns COLS columns
    const bool owns = DH % 32 == 0 || lane < DH;
    float acc[COLS];
#pragma unroll
    for (int t = 0; t < COLS; ++t) acc[t] = 0.f;
    for (int j = 0; j < L; ++j) {
      const float p = prow[j];
#pragma unroll
      for (int t = 0; t < COLS; ++t)
        if (owns) acc[t] = fmaf(p, to_float(vs[j * DH + lane + 32 * t]), acc[t]);
    }
#pragma unroll
    for (int t = 0; t < COLS; ++t)
      if (owns) op[(int64_t)row * H * DH + lane + 32 * t] = from_float<T>(acc[t] / denom);
    __syncwarp();
  }
}

template <typename S>
size_t smem_bytes(int L, int dh) {
  return sizeof(S) * ((size_t)L * padded<S>(dh) + (size_t)L * dh) +
         sizeof(float) * ((size_t)kWarps * L + (size_t)kWarps * dh);
}

template <typename T, typename S, int DH>
cudaError_t launch_typed(Operand q, Operand k, Operand v, void* out, int B, int L, int H,
                         int causal, float scale, cudaStream_t stream) {
  static bool attribute_set = false;
  cudaError_t err = allow_optin_smem(mha_fwd_kernel<T, S, DH>, &attribute_set);
  if (err != cudaSuccess) return err;
  dim3 grid(B, H, (L + kRowsPerBlock - 1) / kRowsPerBlock);
  mha_fwd_kernel<T, S, DH><<<grid, kThreads, smem_bytes<S>(L, DH), stream>>>(
      q, k, v, static_cast<T*>(out), L, H, causal, scale);
  return cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16. dh: 4, 8, 16, 32 or 64 (4: the golden tiny
// fixture's temporal model, which the wrappers admit for acl_mha_bld_fwd only). K and
// V are staged as fp32 (kStageFp32) or in the operand type.
template <bool kStageFp32>
cudaError_t launch(int dtype, Operand q, Operand k, Operand v, void* out, int B, int L,
                   int H, int dh, int causal, float scale, cudaStream_t stream) {
  using BF = __nv_bfloat16;
  using SB = std::conditional_t<kStageFp32, float, BF>;
  if (dtype == 0 && dh == 4)
    return launch_typed<float, float, 4>(q, k, v, out, B, L, H, causal, scale, stream);
  if (dtype == 1 && dh == 4)
    return launch_typed<BF, SB, 4>(q, k, v, out, B, L, H, causal, scale, stream);
  if (dtype == 0 && dh == 8)
    return launch_typed<float, float, 8>(q, k, v, out, B, L, H, causal, scale, stream);
  if (dtype == 1 && dh == 8)
    return launch_typed<BF, SB, 8>(q, k, v, out, B, L, H, causal, scale, stream);
  if (dtype == 0 && dh == 16)
    return launch_typed<float, float, 16>(q, k, v, out, B, L, H, causal, scale, stream);
  if (dtype == 1 && dh == 16)
    return launch_typed<BF, SB, 16>(q, k, v, out, B, L, H, causal, scale, stream);
  if (dtype == 0 && dh == 32)
    return launch_typed<float, float, 32>(q, k, v, out, B, L, H, causal, scale, stream);
  if (dtype == 0 && dh == 64)
    return launch_typed<float, float, 64>(q, k, v, out, B, L, H, causal, scale, stream);
  if (dtype == 1 && dh == 32)
    return launch_typed<BF, SB, 32>(q, k, v, out, B, L, H, causal, scale, stream);
  if (dtype == 1 && dh == 64)
    return launch_typed<BF, SB, 64>(q, k, v, out, B, L, H, causal, scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Shared-memory bytes one block needs, so the caller can refuse a shape early:
// K1 and K2 stage as fp32, K6 in the operand type (dtype: 0 = float32,
// 1 = bfloat16).
size_t acl_mha_smem_bytes(int L, int dh) { return smem_bytes<float>(L, dh); }

size_t acl_mha_qtile_smem_bytes(int L, int dh, int dtype) {
  return dtype == 0 ? smem_bytes<float>(L, dh) : smem_bytes<__nv_bfloat16>(L, dh);
}

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
  return (int)launch<true>(dtype, q, k, v, out, B, L, H, dh, causal, scale,
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
  return (int)launch<true>(dtype, qo, ko, vo, out, B, L, H, dh, causal, scale,
                           static_cast<cudaStream_t>(stream));
}

// K6. q: (B, L, D) and kv: (B, L, 2D), lane order k|v, each with element strides
// (batch_stride, row_stride, 1); out: contiguous (B, L, D). Non-causal.
int acl_mha_qtile_fwd(int dtype, const void* q, int q_bs, int q_rs, const void* kv, int kv_bs,
                      int kv_rs, void* out, int B, int L, int H, int dh, float scale,
                      void* stream) {
  const size_t esize = dtype == 0 ? 4 : 2;
  Operand qo{q, q_bs, q_rs};
  Operand ko{kv, kv_bs, kv_rs};
  Operand vo{static_cast<const char*>(kv) + esize * H * dh, kv_bs, kv_rs};
  return (int)launch<false>(dtype, qo, ko, vo, out, B, L, H, dh, /*causal=*/0, scale,
                            static_cast<cudaStream_t>(stream));
}

}  // extern "C"
