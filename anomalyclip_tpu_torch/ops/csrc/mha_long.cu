// Attention over long sequences for Hopper (sm_90a), fp32 and bf16, forward only.
//
// One C entry, one kernel:
//
//   acl_flash_fwd  replaces _flash_kernel / flash_attention_heads
//                  (anomalyclip_tpu/ops/pallas/attention.py:800-854, 885, 1056):
//                  KV-blocked online-softmax attention over per-head (N, L, dh) q,
//                  k, v, read in place through element strides, with the
//                  log-sum-exp per row written on request. At head dim 64 the
//                  wrapper launches a tensor-core kernel instead: in fp32 the
//                  split-TF32 kernel of mha_tf32.cu (the ViT-L/14@336px tower in
//                  fp32, N = 256 x 16, L=577, where fused_attention,
//                  attention.py:1121-1135, routes it), in bf16 the kernel of
//                  mha_tc.cu (the bf16 core rung past L=789). This kernel serves
//                  the head dims 8, 16 and 32 in both types, with the causal
//                  mask too: what that router sends to the XLA formulation
//                  (:1135), a causal shape too long for the whole-row kernel.
//
// What it computes is what _flash_kernel computes, block by block: per KV block
// of kBlockKV keys, m_new = max(m, rowmax(s)), alpha = exp(m - m_new), p =
// exp(s - m_new) cast to the operand type before the P.V product (the sum takes
// p unrounded), acc = acc * alpha + p.V, l = l * alpha + rowsum(p); one divide at
// the end; lse = m + log(l). Keys past L are masked to -1e30 and the V rows past
// L are zeroed, since 0 * garbage in the padding would still poison acc. Under
// the causal mask the keys above the diagonal are at -1e30 as well, and the KV
// loop ends at the tile's last row: a KV block starts at a multiple of 128 and a
// q tile at a multiple of 64, so in every block the loop visits each row of the
// tile sees the block's first key, and no row meets a block it is masked out of
// before it has a real maximum.
//
// Design: one block per (n, 64-query-row tile), 8 warps. The tile's q rows are
// staged once as fp32; each KV block is staged in the operand type, K rows padded
// by one 32-bit word; a warp owns query rows warp, warp + 8, ... and keeps each
// row's running max, sum and fp32 accumulator in shared memory between KV blocks;
// in the P.V product lane t owns output columns t, t+32 (below head dim 32 the
// upper lanes own none).
// Shared memory is independent of L: at dh 32 in fp32 54,272 B; at dh 64 in bf16
// it would be 70,656 B, the admission limit the wrapper still applies to the
// tensor-core kernels that serve head dim 64.
//
// What bounds it: 2 * 2 * L^2 * dh FLOP per (n) on the fp32 CUDA cores with one
// shared-memory operand per multiply-add; device memory sees K and V once per
// query tile (10 times at L=577). At the tower's per-head shape (4096, 577, 64),
// which has moved to the tensor-core kernels, it took 31.2 ms in fp32 against
// sdpa's 12.4 and 31.0 ms in bf16 against sdpa's 1.2 (NVIDIA H100 80GB HBM3,
// 700 W; PERF.md).

#include "attention_common.cuh"

namespace {

constexpr int kBlockKV = 128;  // keys per KV block

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(Operand q, Operand k, Operand v, T* __restrict__ out,
                 float* __restrict__ lse, int L, int causal, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int KP = padded<T>(DH);
  T* ks = reinterpret_cast<T*>(smem);                   // kBlockKV x KP
  T* vs = ks + kBlockKV * KP;                           // kBlockKV x DH
  float* ps = reinterpret_cast<float*>(vs + kBlockKV * DH);  // kWarps x kBlockKV
  float* qs = ps + kWarps * kBlockKV;                   // kRowsPerBlock x DH, fp32
  float* accs = qs + kRowsPerBlock * DH;                // kRowsPerBlock x DH, fp32
  float* ms = accs + kRowsPerBlock * DH;                // running max per row
  float* ls = ms + kRowsPerBlock;                       // running sum per row

  const int n = blockIdx.x;  // x: the one grid dimension not capped at 65535
  const int row0 = blockIdx.y * kRowsPerBlock;
  const int rows = min(kRowsPerBlock, L - row0);  // the last tile is ragged
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  const T* qp = static_cast<const T*>(q.ptr) + n * q.batch_stride;
  const T* kp = static_cast<const T*>(k.ptr) + n * k.batch_stride;
  const T* vp = static_cast<const T*>(v.ptr) + n * v.batch_stride;

  for (int i = threadIdx.x; i < kRowsPerBlock * DH; i += kThreads) {
    const int r = i / DH, c = i % DH;
    qs[i] = r < rows ? to_float(qp[(row0 + r) * q.row_stride + c]) : 0.f;
    accs[i] = 0.f;
  }
  for (int i = threadIdx.x; i < kRowsPerBlock; i += kThreads) {
    ms[i] = kNegInf;
    ls[i] = 0.f;
  }

  constexpr int COLS = (DH + 31) / 32;  // output columns a lane owns
  // a constant where DH is a multiple of 32: every lane owns COLS columns
  const bool owns = DH % 32 == 0 || lane < DH;
  const int kv_end = causal ? min(L, row0 + rows) : L;  // the blocks past it are all masked
  float* prow = ps + warp * kBlockKV;
  for (int kv0 = 0; kv0 < kv_end; kv0 += kBlockKV) {
    const int nkv = min(kBlockKV, L - kv0);
    __syncthreads();  // every warp is done with the previous block
    for (int i = threadIdx.x; i < kBlockKV * DH; i += kThreads) {
      const int r = i / DH, c = i % DH;
      const bool live = r < nkv;
      ks[r * KP + c] = live ? kp[(kv0 + r) * k.row_stride + c] : from_float<T>(0.f);
      vs[r * DH + c] = live ? vp[(kv0 + r) * v.row_stride + c] : from_float<T>(0.f);
    }
    __syncthreads();

    for (int r = warp; r < rows; r += kWarps) {
      float qr[DH];
#pragma unroll
      for (int c = 0; c < DH; ++c) qr[c] = qs[r * DH + c];

      float blk_max = kNegInf;
#pragma unroll
      for (int j = lane; j < kBlockKV; j += 32) {
        const bool live = j < nkv && !(causal && kv0 + j > row0 + r);
        const float s = live ? dot_row<T, DH>(qr, ks + j * KP) * scale : kNegInf;
        prow[j] = s;
        blk_max = fmaxf(blk_max, s);
      }
      blk_max = warp_max(blk_max);
      const float m_old = ms[r];
      const float m_new = fmaxf(m_old, blk_max);
      const float alpha = expf(m_old - m_new);

      float psum = 0.f;
#pragma unroll
      for (int j = lane; j < kBlockKV; j += 32) {
        const float p = expf(prow[j] - m_new);  // 0 at the masked keys
        psum += p;
        prow[j] = round_like(p, T());
      }
      psum = warp_sum(psum);
      __syncwarp();

      float acc[COLS];
#pragma unroll
      for (int t = 0; t < COLS; ++t) acc[t] = owns ? accs[r * DH + lane + 32 * t] * alpha : 0.f;
      for (int j = 0; j < nkv; ++j) {
        const float p = prow[j];
#pragma unroll
        for (int t = 0; t < COLS; ++t)
          if (owns) acc[t] = fmaf(p, to_float(vs[j * DH + lane + 32 * t]), acc[t]);
      }
#pragma unroll
      for (int t = 0; t < COLS; ++t)
        if (owns) accs[r * DH + lane + 32 * t] = acc[t];
      __syncwarp();  // all lanes have read ms[r] and prow before they change
      if (lane == 0) {
        ms[r] = m_new;
        ls[r] = ls[r] * alpha + psum;
      }
      __syncwarp();
    }
  }

  T* op = out + ((int64_t)n * L + row0) * DH;
  for (int r = warp; r < rows; r += kWarps) {
    const float denom = ls[r];
#pragma unroll
    for (int t = 0; t < COLS; ++t)
      if (owns)
        op[(int64_t)r * DH + lane + 32 * t] = from_float<T>(accs[r * DH + lane + 32 * t] / denom);
    if (lse != nullptr && lane == 0) lse[(int64_t)n * L + row0 + r] = ms[r] + logf(denom);
  }
}

template <typename T>
size_t flash_smem_bytes(int dh) {
  return sizeof(T) * ((size_t)kBlockKV * padded<T>(dh) + (size_t)kBlockKV * dh) +
         sizeof(float) * ((size_t)kWarps * kBlockKV + 2 * (size_t)kRowsPerBlock * dh +
                          2 * (size_t)kRowsPerBlock);
}

template <typename T, int DH>
cudaError_t launch_flash(Operand q, Operand k, Operand v, void* out, float* lse, int N, int L,
                         int causal, float scale, cudaStream_t stream) {
  static bool attribute_set = false;
  cudaError_t err = allow_optin_smem(flash_fwd_kernel<T, DH>, &attribute_set);
  if (err != cudaSuccess) return err;
  dim3 grid(N, (L + kRowsPerBlock - 1) / kRowsPerBlock);
  flash_fwd_kernel<T, DH><<<grid, kThreads, flash_smem_bytes<T>(DH), stream>>>(
      q, k, v, static_cast<T*>(out), lse, L, causal, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared-memory bytes one block needs, so the caller can refuse a shape early.
// dtype: 0 = float32, 1 = bfloat16.
size_t acl_flash_smem_bytes(int dh, int dtype) {
  return dtype == 0 ? flash_smem_bytes<float>(dh) : flash_smem_bytes<__nv_bfloat16>(dh);
}

// K8. q, k, v: (N, L, dh) each with its own element strides (last stride 1);
// out: contiguous (N, L, dh); lse: contiguous (N, L) fp32, or null. dh: 8, 16 or
// 32 (head dim 64 is mha_tc.cu's in bf16 and mha_tf32.cu's in fp32).
int acl_flash_fwd(int dtype, const void* q, int q_bs, int q_rs, const void* k, int k_bs,
                  int k_rs, const void* v, int v_bs, int v_rs, void* out, void* lse, int N,
                  int L, int dh, int causal, float scale, void* stream) {
  Operand qo{q, q_bs, q_rs};
  Operand ko{k, k_bs, k_rs};
  Operand vo{v, v_bs, v_rs};
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using BF = __nv_bfloat16;
#define ACL_FLASH_CASE(CODE, T, DH) \
  if (dtype == CODE && dh == DH)    \
    return (int)launch_flash<T, DH>(qo, ko, vo, out, l, N, L, causal, scale, s);
  ACL_FLASH_CASE(0, float, 8)
  ACL_FLASH_CASE(0, float, 16)
  ACL_FLASH_CASE(0, float, 32)
  ACL_FLASH_CASE(1, BF, 8)
  ACL_FLASH_CASE(1, BF, 16)
  ACL_FLASH_CASE(1, BF, 32)
#undef ACL_FLASH_CASE
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
