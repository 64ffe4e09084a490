// Whole-head multi-head attention backward for Hopper (sm_90a), fp32 operands at
// head dim 64 and at most 112 rows, its products split-TF32 (3xTF32) on the
// tensor cores: the CoOp gradient through the causal text tower.
//
// Two C entries, one kernel, which replace in fp32 at head dim 64 with
// L <= 112 what mha_bwd.cu computes on the CUDA cores (bf16, the smaller head
// dims and 112 < L <= 117 stay there, longer heads go to the KV-blocked pair;
// the wrappers choose before the launch, ops/attention.py:
// mha_whole_tf32_eligible):
//
//   acl_mha_qkv_whole_tf32_bwd  replaces _mha_qkv_bwd_kernel / _mha_qkv_bwd_impl
//                               (anomalyclip_tpu/ops/pallas/attention.py:291-311,
//                               call :372): the gradient of fused_mha_qkv, read
//                               from the packed (B, L, 3D) qkv and written as one
//                               packed (B, L, 3D) dqkv. The text tower's CoOp
//                               gradient, (14, 77, 1536) with 8 heads, causal.
//   acl_mha_bld_whole_tf32_bwd  replaces _mha_bld_bwd_kernel / _mha_bld_bwd_impl
//                               (:273-288, call :351) at head dim 64 from separate
//                               (B, L, D) q, k, v, each read in place through
//                               (batch, row) element strides; also
//                               fused_attention's backward (:1171-1181) with the
//                               heads folded into the batch.
//
// What it computes is _mha_bwd_head (:244-270), as mha_bwd.cu and
// mha_bld_tf32.cu's backward compute it: S = Q K^T (scaled by `scale` in the
// exponent), keys past L and (causal) above the diagonal at -1e30, P = e / sum
// (normalised before the products), dP = G V^T, delta = rowsum(P o dP), dS =
// P o (dP - delta) * scale, dQ = dS K, dK = dS^T Q, dV = P^T G. Scores and P are
// recomputed from q and k: nothing but q, k, v is saved by the forward. Every
// product is formed from the operands' TF32 parts, big = tf32(x) and small =
// tf32(x - big), as small.big + big.small + big.big (tensor_core.cuh's
// split_tf32 and mma_3xtf32; TF32 itself stays off); the cross terms of S and dP
// sum in accumulators of their own, added once, as mha_bld_tf32.cu orders them.
// Its emulation is mha_bld_bwd_tf32x3_reference.
//
// What bounds it on the card. At the text tower's shape, (14, 77, 512) per
// tensor with 8 heads, the seven tensors (q, k, v, g in; dq, dk, dv out) are
// 15.4 MB: 0.0046 ms at 3.35 TB/s; the five products are 10 L^2 dh = 42 MFLOP
// (half under the mask), 0.0003 ms at the 165 TFLOP/s of an fp32-accurate
// product. The bytes bound it. mha_bwd.cu took 0.060 ms of device time a launch
// there (13x the bound): every multiply-add on the CUDA cores reading one
// operand from shared memory, one output element a thread with a serial sum
// over 77 keys. What this design does about that: every product on the tensor
// cores, every operand byte read from device memory once in 16-byte cp.async
// pieces, every output written once, and no multiply-add reading shared memory
// from the CUDA cores.
//
// Design (mha_bld_tf32.cu's backward with the warps of one block sharing a head
// instead of each owning one).
// - One block per (batch entry, head), on the first grid axis (B H < 2^31):
//   112 blocks at the text tower's shape, 168 at ViT-L/14's (14, 77, 2304) with
//   12 heads. R = L rounded up to 16 rows, R / 16 warps a block (5 at L = 77).
// - Staging. The block stages Q and K, then V and G, of its head into shared
//   tiles of R rows at a pitch of 64 + 4 floats (cp.async, rows from L on
//   zero-filled): with 4-byte loads that pitch serves a tile both as an operand
//   of a product over the head dims (S, dP: bank 4r + t) and as the B operand of
//   one over rows or keys (dQ, dK, dV: bank 8t + g) without bank conflicts
//   (mha_tf32_bwd.cu's finding). S is formed while V and G land.
// - Pass 1: warp w owns query rows 16w .. 16w + 15 (one m16n8k8 m-tile) against
//   every 8-key n-tile up to R (causal: up to the tile's diagonal). It forms S,
//   its row max and sum across the quad, P = e / sum, and writes P once to an
//   R x (R + 4) tile; then dP, delta (reading its own P back), dS into a second
//   such tile, and dQ = dS K with the accumulators as A fragments (relabelling
//   the step's index t as key 2t and t + 4 as key 2t + 1, so no shuffle).
//   P leaves the registers before dP is formed: the live accumulators are one
//   product's 14 n-tiles and their cross terms, not two products'.
// - Pass 2, after one __syncthreads: warp w owns keys 16w .. 16w + 15 and forms
//   dK = dS^T Q and dV = P^T G over the queries (causal: from 16w on), 8 a step,
//   reading its A fragments transposed from the two tiles (a pitch of 4 mod 16
//   puts a warp's reads on 32 distinct banks).
// - No atomics: every output is written once, every sum in a fixed order, so
//   two launches give the same bits.
// - Ragged L: rows past L have Q = G = 0, so dS = 0 and their P meets G = 0: they
//   add nothing to dK and dV, and they are never stored; 8-key n-tiles wholly
//   past L are not formed (their entries are masked to 0 in the tiles).
// - Shared memory: 4 R (64 + 4) + 2 R (R + 4) floats, 140,800 B at L = 77; the
//   card's 232,448 B a block admit R = 112 (225,792 B), R = 128 needs 274,432.
//   One block an SM: at the text tower's 112 blocks most of an SM's warp slots
//   stay empty, and ViT-L/14's 168 blocks take a second wave on 132 SMs
//   (PERF.md weighs the alternatives).

#include "attention_common.cuh"
#include "tensor_core.cuh"

namespace {

constexpr int kDh = 64;               // the one head dim
constexpr int kPad = 4;               // floats of padding per staged row and tile row
constexpr int kPitch = kDh + kPad;    // floats a staged operand row
constexpr int kMaxL = 112;            // rows and keys a block holds
constexpr int kMaxTiles = kMaxL / 8;  // 8-key n-tiles of a row of scores
constexpr int kMaxWarps = kMaxL / 16;

struct Output {
  float* ptr;  // element (batch 0, row 0, column 0) of head 0
  int64_t batch_stride;
  int64_t row_stride;
};

// Rows of the tiles at length L: L rounded up to a whole m-tile.
__host__ __device__ constexpr int tile_rows(int L) { return (L + 15) / 16 * 16; }

size_t smem_bytes(int L) {
  const size_t r = tile_rows(L);
  return sizeof(float) * (4 * r * kPitch + 2 * r * (r + kPad));
}

bool admitted(int L) { return L >= 1 && L <= kMaxL; }

// The block's share of staging R rows of the head's 64 columns from src (row
// stride row_stride) into rows of kPitch floats at dst, 16 bytes a copy: rows
// from L on are zero-filled and their source is not read.
__device__ __forceinline__ void stage_head(float* dst, const float* src, int64_t row_stride, int R,
                                           int L, int tid, int threads) {
  constexpr int PIECES = kDh / 4;
  for (int i = tid; i < R * PIECES; i += threads) {
    const int r = i / PIECES, c = i % PIECES * 4;
    const bool in = r < L;
    cp_async16(smem_u32(dst + r * kPitch + c), src + (in ? r * row_stride + c : 0), in ? 16 : 0);
  }
}

__device__ __forceinline__ const float* head_ptr(const Operand& t, int b, int h) {
  return static_cast<const float*>(t.ptr) + b * t.batch_stride + h * kDh;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// c[n] (16 x 8) = the warp's 16 rows of `rows` (from row0) . x[8n .. 8n + 7]^T
// over the 64 columns for n < live, 0 for the others: S or dP. Both operands
// are read at dims t and t + 4 of their rows and split as they are loaded; the
// cross terms sum apart and are added once.
__device__ __forceinline__ void dim_products(float (&c)[kMaxTiles][4], const float* rows, int row0,
                                             const float* x, int live, int g, int t) {
  float cx[kMaxTiles][4];
#pragma unroll
  for (int n = 0; n < kMaxTiles; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] = cx[n][e] = 0.f;
  const float* a = rows + (row0 + g) * kPitch + t;
  const float* b = x + g * kPitch + t;
#pragma unroll
  for (int kk = 0; kk < kDh / 8; ++kk) {
    uint32_t ab[4], as[4];
    split_tf32(a[kk * 8], ab[0], as[0]);                   // (row g, dim t)
    split_tf32(a[8 * kPitch + kk * 8], ab[1], as[1]);      // (row g + 8, dim t)
    split_tf32(a[kk * 8 + 4], ab[2], as[2]);               // (row g, dim t + 4)
    split_tf32(a[8 * kPitch + kk * 8 + 4], ab[3], as[3]);  // (row g + 8, dim t + 4)
#pragma unroll
    for (int n = 0; n < kMaxTiles; ++n) {
      if (n >= live) break;
      uint32_t b0, s0, b1, s1;
      split_tf32(b[n * 8 * kPitch + kk * 8], b0, s0);
      split_tf32(b[n * 8 * kPitch + kk * 8 + 4], b1, s1);
      mma_tf32(cx[n], as, b0, b1);
      mma_tf32(cx[n], ab, s0, s1);
      mma_tf32(c[n], ab, b0, b1);
    }
  }
#pragma unroll
  for (int n = 0; n < kMaxTiles; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] += cx[n][e];
}

// acc[d] (16 x 8, columns 8d .. 8d + 7) += a (16 x 8 logical) . x rows k0 + 2t
// and k0 + 2t + 1 (the step's logical t and t + 4), column 8d + g: the second
// kind of product (dQ, dK, dV), summed over 8 rows of x. ab and as are the A
// fragment's split parts.
__device__ __forceinline__ void row_products(float (&acc)[kDh / 8][4], const uint32_t (&ab)[4],
                                             const uint32_t (&as)[4], const float* x, int k0,
                                             int g, int t) {
  const float* b = x + (k0 + 2 * t) * kPitch + g;
#pragma unroll
  for (int d = 0; d < kDh / 8; ++d) {
    uint32_t b0, s0, b1, s1;
    split_tf32(b[d * 8], b0, s0);
    split_tf32(b[kPitch + d * 8], b1, s1);
    mma_3xtf32(acc[d], ab, as, b0, b1, s0, s1);
  }
}

// The split parts of an A fragment from its four elements in register order:
// (row g, column t), (row g + 8, column t), (row g, column t + 4), (row g + 8,
// column t + 4).
__device__ __forceinline__ void split_fragment(uint32_t (&ab)[4], uint32_t (&as)[4], float a0,
                                               float a1, float a2, float a3) {
  split_tf32(a0, ab[0], as[0]);
  split_tf32(a1, ab[1], as[1]);
  split_tf32(a2, ab[2], as[2]);
  split_tf32(a3, ab[3], as[3]);
}

__global__ void __launch_bounds__(kMaxWarps * 32)
mha_whole_tf32_bwd_kernel(Operand q, Operand k, Operand v, Operand go, Output dq, Output dk,
                          Output dv, int L, int H, int causal, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int g = lane / 4, t = lane % 4;  // the fragment's row and column pair
  const float scale_log2 = scale * kLog2e;
  const int R = tile_rows(L), TP = R + kPad;
  float* qs = smem;  // R x kPitch each
  float* ks = qs + R * kPitch;
  float* vs = ks + R * kPitch;
  float* gs = vs + R * kPitch;
  float* pt = gs + R * kPitch;  // R x TP: P, rows by query, columns by key
  float* dt = pt + R * TP;      // R x TP: dS

  stage_head(qs, head_ptr(q, b, h), q.row_stride, R, L, threadIdx.x, blockDim.x);
  stage_head(ks, head_ptr(k, b, h), k.row_stride, R, L, threadIdx.x, blockDim.x);
  cp_async_commit();
  stage_head(vs, head_ptr(v, b, h), v.row_stride, R, L, threadIdx.x, blockDim.x);
  stage_head(gs, head_ptr(go, b, h), go.row_stride, R, L, threadIdx.x, blockDim.x);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  // pass 1: the warp's 16 query rows; n-tiles of P and dS it writes (causal:
  // up to its diagonal), and those with a key before L, which it forms
  const int row0 = warp * 16;
  const int tiles = causal ? (row0 + 16) / 8 : R / 8;
  const int live = min(tiles, (L + 7) / 8);
  float* prow = pt + (row0 + g) * TP + 2 * t;  // (row g, keys 2t, 2t + 1) of n-tile 0
  float* drow = dt + (row0 + g) * TP + 2 * t;
  {
    float s[kMaxTiles][4];
    dim_products(s, qs, row0, ks, live, g, t);
    float sum[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float m = kNegInf;
#pragma unroll
      for (int n = 0; n < kMaxTiles; ++n) {
        if (n >= tiles) break;
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          const int key = n * 8 + 2 * t + (e & 1), row = row0 + g + 8 * r;
          if (key >= L || (causal && key > row)) s[n][e] = kNegInf;
          m = fmaxf(m, s[n][e]);
        }
      }
      const float mc = quad_max(m) * scale_log2;
      float total = 0.f;
#pragma unroll
      for (int n = 0; n < kMaxTiles; ++n) {
        if (n >= tiles) break;
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          s[n][e] = fast_exp2(fmaf(s[n][e], scale_log2, -mc));  // 0 at the masked keys
          total += s[n][e];
        }
      }
      sum[r] = quad_sum(total);
    }
    // P = e / sum, written once to the P tile
#pragma unroll
    for (int n = 0; n < kMaxTiles; ++n) {
      if (n >= tiles) break;
      *reinterpret_cast<float2*>(prow + n * 8) = make_float2(s[n][0] / sum[0], s[n][1] / sum[0]);
      *reinterpret_cast<float2*>(prow + 8 * TP + n * 8) =
          make_float2(s[n][2] / sum[1], s[n][3] / sum[1]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // V and G have landed

  float dp[kMaxTiles][4];
  dim_products(dp, gs, row0, vs, live, g, t);
  // delta = rowsum(P o dP), P read back from the thread's own entries
  float delta[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < kMaxTiles; ++n) {
    if (n >= tiles) break;
    const float2 p0 = *reinterpret_cast<const float2*>(prow + n * 8);
    const float2 p1 = *reinterpret_cast<const float2*>(prow + 8 * TP + n * 8);
    delta[0] = fmaf(p0.x, dp[n][0], delta[0]);
    delta[0] = fmaf(p0.y, dp[n][1], delta[0]);
    delta[1] = fmaf(p1.x, dp[n][2], delta[1]);
    delta[1] = fmaf(p1.y, dp[n][3], delta[1]);
  }
  delta[0] = quad_sum(delta[0]);
  delta[1] = quad_sum(delta[1]);

  float acc[kDh / 8][4];
#pragma unroll
  for (int d = 0; d < kDh / 8; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
#pragma unroll
  for (int n = 0; n < kMaxTiles; ++n) {
    if (n >= tiles) break;
    // dS = P o (dP - delta) * scale, to the dS tile and kept as the A fragment
    const float2 p0 = *reinterpret_cast<const float2*>(prow + n * 8);
    const float2 p1 = *reinterpret_cast<const float2*>(prow + 8 * TP + n * 8);
    dp[n][0] = p0.x * (dp[n][0] - delta[0]) * scale;
    dp[n][1] = p0.y * (dp[n][1] - delta[0]) * scale;
    dp[n][2] = p1.x * (dp[n][2] - delta[1]) * scale;
    dp[n][3] = p1.y * (dp[n][3] - delta[1]) * scale;
    *reinterpret_cast<float2*>(drow + n * 8) = make_float2(dp[n][0], dp[n][1]);
    *reinterpret_cast<float2*>(drow + 8 * TP + n * 8) = make_float2(dp[n][2], dp[n][3]);
    if (n >= live) continue;
    // dQ += dS K over the n-tile's 8 keys: the accumulator as it lies is the A
    // fragment, (c0, c2, c1, c3)
    uint32_t ab[4], as[4];
    split_fragment(ab, as, dp[n][0], dp[n][2], dp[n][1], dp[n][3]);
    row_products(acc, ab, as, ks, n * 8, g, t);
  }
  store_rows<kDh>(acc, dq.ptr + b * dq.batch_stride + h * kDh + row0 * dq.row_stride,
                  dq.row_stride, row0, L, g, t);
  __syncthreads();  // every warp's P and dS are in the tiles

  // pass 2: the warp's 16 keys; dK = dS^T Q and dV = P^T G over the queries
  // that see them, 8 a step: step j's logical queries t and t + 4 are queries
  // j + 2t and j + 2t + 1, read from the tiles' rows transposed
  const int key0 = warp * 16;
  if (key0 >= L) return;
  float dka[kDh / 8][4], dva[kDh / 8][4];
#pragma unroll
  for (int d = 0; d < kDh / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[d][e] = dva[d][e] = 0.f;
  for (int j = causal ? key0 : 0; j < L; j += 8) {
    const int at = (j + 2 * t) * TP + key0 + g;
    uint32_t ab[4], as[4];
    // (key g, query 2t), (key g + 8, query 2t), (key g, query 2t + 1), (key g + 8, query 2t + 1)
    split_fragment(ab, as, dt[at], dt[at + 8], dt[at + TP], dt[at + TP + 8]);
    row_products(dka, ab, as, qs, j, g, t);
    split_fragment(ab, as, pt[at], pt[at + 8], pt[at + TP], pt[at + TP + 8]);
    row_products(dva, ab, as, gs, j, g, t);
  }
  store_rows<kDh>(dka, dk.ptr + b * dk.batch_stride + h * kDh + key0 * dk.row_stride,
                  dk.row_stride, key0, L, g, t);
  store_rows<kDh>(dva, dv.ptr + b * dv.batch_stride + h * kDh + key0 * dv.row_stride,
                  dv.row_stride, key0, L, g, t);
}

bool attribute_set = false;

cudaError_t launch(Operand q, Operand k, Operand v, Operand g, Output dq, Output dk, Output dv,
                   int B, int L, int H, int dh, int causal, float scale, cudaStream_t stream) {
  const int64_t blocks = (int64_t)B * H;
  if (dh != kDh || !admitted(L) || B <= 0 || H <= 0 || blocks > 2147483647LL)
    return cudaErrorInvalidValue;
  cudaError_t err = allow_optin_smem(mha_whole_tf32_bwd_kernel, &attribute_set);
  if (err != cudaSuccess) return err;
  mha_whole_tf32_bwd_kernel<<<(unsigned)blocks, tile_rows(L) / 16 * 32, smem_bytes(L), stream>>>(
      q, k, v, g, dq, dk, dv, L, H, causal, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared-memory bytes one block needs at length L (dynamic).
size_t acl_mha_whole_tf32_smem_bytes(int L) { return smem_bytes(L); }

// Blocks of the kernel one SM holds at length L (registers and shared memory);
// -1 on an error or a length that is not admitted.
int acl_mha_whole_tf32_blocks_per_sm(int L) {
  if (!admitted(L)) return -1;
  int blocks = 0;
  cudaError_t err = allow_optin_smem(mha_whole_tf32_bwd_kernel, &attribute_set);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, mha_whole_tf32_bwd_kernel,
                                                        tile_rows(L) / 16 * 32, smem_bytes(L));
  return err == cudaSuccess ? blocks : -1;
}

// K3 in fp32 at head dim 64. qkv: (B, L, 3D) fp32 with element strides
// (batch_stride, row_stride, 1), 16-byte aligned; g: contiguous (B, L, D);
// dqkv: contiguous (B, L, 3D), D = H * dh.
int acl_mha_qkv_whole_tf32_bwd(const void* qkv, int64_t batch_stride, int64_t row_stride,
                               const void* g, void* dqkv, int B, int L, int H, int dh, int causal,
                               float scale, void* stream) {
  const int64_t D = (int64_t)H * dh;
  const float* in = static_cast<const float*>(qkv);
  float* out = static_cast<float*>(dqkv);
  const Operand q{in, batch_stride, row_stride}, k{in + D, batch_stride, row_stride},
      v{in + 2 * D, batch_stride, row_stride}, go{g, L * D, D};
  const Output dq{out, L * 3 * D, 3 * D}, dk{out + D, L * 3 * D, 3 * D},
      dv{out + 2 * D, L * 3 * D, 3 * D};
  return (int)launch(q, k, v, go, dq, dk, dv, B, L, H, dh, causal, scale,
                     static_cast<cudaStream_t>(stream));
}

// K4 (and K5's backward, heads folded) in fp32 at head dim 64. q, k, v, g:
// (B, L, D) fp32, each with element strides (batch, row, 1), 16-byte aligned;
// dq, dk, dv: contiguous (B, L, D).
int acl_mha_bld_whole_tf32_bwd(const void* q, int64_t q_bs, int64_t q_rs, const void* k,
                               int64_t k_bs, int64_t k_rs, const void* v, int64_t v_bs,
                               int64_t v_rs, const void* g, int64_t g_bs, int64_t g_rs, void* dq,
                               void* dk, void* dv, int B, int L, int H, int dh, int causal,
                               float scale, void* stream) {
  const int64_t D = (int64_t)H * dh;
  const Operand qo{q, q_bs, q_rs}, ko{k, k_bs, k_rs}, vo{v, v_bs, v_rs}, go{g, g_bs, g_rs};
  const Output dqo{static_cast<float*>(dq), L * D, D}, dko{static_cast<float*>(dk), L * D, D},
      dvo{static_cast<float*>(dv), L * D, D};
  return (int)launch(qo, ko, vo, go, dqo, dko, dvo, B, L, H, dh, causal, scale,
                     static_cast<cudaStream_t>(stream));
}

}  // extern "C"
