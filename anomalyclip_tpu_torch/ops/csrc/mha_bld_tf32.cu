// Whole-head multi-head attention, forward and backward, for Hopper (sm_90a),
// fp32 operands at head dim 16 or 32 and at most 32 rows, its products
// split-TF32 (3xTF32) on the tensor cores: the temporal model's axial attention.
//
// Two C entries, two kernels, which replace in fp32 at head dims 16 and 32 with
// L <= 32 what mha.cu and mha_bwd.cu compute on the CUDA cores (every other
// shape, bf16 and fused_attention's whole-block branch stay there; the wrappers
// choose before the launch, ops/attention.py: mha_bld_tf32_eligible):
//
//   acl_mha_bld_tf32_fwd  replaces _mha_bld_kernel / fused_mha_bld
//                         (anomalyclip_tpu/ops/pallas/attention.py:88-96, call
//                         :199): _attend_head (:68-85) over separate (B, L, D)
//                         q, k, v.
//   acl_mha_bld_tf32_bwd  replaces _mha_bld_bwd_kernel / _mha_bld_bwd_impl
//                         (:273-288, call :351): _mha_bwd_head (:244-270), dq,
//                         dk and dv of the same.
//
// The temporal model (models/temporal.py:129-136) attends along segments (L=32)
// and along frames (L=16), 8 heads of 32 at emb 256 (16 at bench_eval's emb
// 128), q from one projection and k, v the two halves of another: every
// operand is read in place through (batch, row) element strides and must be
// readable in 16-byte pieces (base address and strides), which the wrapper
// checks; head h starts at column h * dh. The outputs are contiguous (B, L, D).
//
// What it computes. Forward: S = Q K^T (scaled by `scale` in the exponent),
// keys past L and (causal) above the diagonal at -1e30, m = the row max, e =
// exp(S scale - m scale), the row sum of e, O = (e V) / sum: the divide on the
// output row, as mha.cu. Backward: S as above, P = e / sum (normalised before
// the products, as _mha_bwd_head and mha_bwd.cu), dP = G V^T, delta = rowsum(P o
// dP), dS = P o (dP - delta) * scale, dQ = dS K, dK = dS^T Q, dV = P^T G; scores
// and P are recomputed from q and k, nothing but q, k, v is saved by the
// forward. Nothing is rounded (fp32 has nothing to round to). Every product is
// formed from the operands' TF32 parts, big = tf32(x) and small = tf32(x - big),
// as small.big + big.small + big.big: three mma.sync.aligned.m16n8k8 TF32
// products a fragment pair (tensor_core.cuh's split_tf32 and mma_3xtf32; TF32
// itself stays off). The cross terms of S and dP sum in accumulators of their
// own, added once, as mha_tf32.cu and mha_tf32_bwd.cu order them. The exponent
// is ex2.approx of (s c - m c), c = scale log2(e). The emulations of this
// arithmetic are mha_bld_tf32x3_reference and mha_bld_bwd_tf32x3_reference.
//
// What bounds it on the card. At the training shapes, (1024, 32, 256) and
// (2048, 16, 256) with 8 heads, the forward moves 4 tensors of 33.5 MB once
// (0.040 ms at 3.35 TB/s) for 4 L^2 dh = 0.27 GFLOP (0.0016 ms at the 165
// TFLOP/s of an fp32-accurate product), the backward 7 tensors (0.070 ms) for
// 10 L^2 dh: the bytes bound both, by 25x and more. What the design does about
// that: every operand byte is read once, in 16-byte cp.async pieces that a warp
// issues all at once, and no multiply-add reads shared memory from the CUDA
// cores (mha.cu's and mha_bwd.cu's did: 3.9-6.3x their bound by device time).
// Measured at the training shapes: K2 1.35-1.38x its bound, K4 1.23-1.77x
// (NVIDIA H100 80GB HBM3, 700 W; PERF.md). At the scoring shapes, (64, 32, 256)
// and (128, 16, 256), the work is 512 and 1024 heads: 4-13 microseconds of
// device time, below the host's enqueue.
//
// Design.
// - One warp owns one whole (batch entry, head): at L <= 32 its scores are two
//   16-row m16n8k8 tiles by four 8-key tiles, its softmax rows complete, so the
//   forward needs no online rescaling and the backward no reduction across
//   warps (no atomics: every output is written once, a fixed order of sums, two
//   launches give the same bits). A block is 4 warps on 4 consecutive (batch,
//   head) pairs; blocks = ceil(B H / 4) on the first grid axis (B up to 2^31 / H).
//   Warps never wait on each other: each stages its own tiles and syncs itself.
// - Forward. K and V of the head go to the warp's shared tiles (K rows padded
//   to dh + 8 floats and V rows to dh + 4, so that the 8-byte fragment loads of
//   a half-warp hit distinct banks, as mha_tf32.cu's); Q goes straight from
//   device memory into A fragments. S leaves the accumulators as P.V's A
//   fragments with no shuffle, by relabelling the step's index (key 2t and 2t +
//   1 as t and t + 4), and P.V's output columns are relabelled the same way
//   (even and odd columns of a 16-column group), so a thread ends holding four
//   neighbouring output columns: one float4 store a row and group.
// - Backward. Q, K, V and G go to the warp's shared tiles at dh + 4 floats a
//   row: with 4-byte loads that pitch serves a tile both as the A or B operand
//   of a product over the head dims (S, dP) and as the B operand of one over
//   rows or keys (dQ, dK, dV) without bank conflicts (mha_tf32_bwd.cu's
//   finding). Per 16-row m-tile S and dP are built, P and dS formed in
//   registers, dQ = dS K taken from the accumulators as A fragments, and P and
//   dS written once to two R x (R + 4) tiles of the warp (R = L rounded up to
//   16); then per 16-key m-tile dK = dS^T Q and dV = P^T G read their A
//   fragments transposed from those tiles (row 2t of a pitch of 4 mod 8 puts a
//   warp's reads on 32 distinct banks).
// - Ragged L: rows and keys past L are zero-filled on load (cp.async with no
//   source bytes), keys past L masked to -1e30 in S, 8-key tiles wholly past L
//   skipped; a row past L has dS = 0 and G = 0, so it adds nothing to dK and dV,
//   and it is never stored.
// - Shared memory: the forward's tiles are static, 38,912 B a block at dh 32
//   (22,528 at dh 16), independent of L; the backward's are dynamic, R rows of
//   each of the four operands and the two tiles: 110,592 B a block at L=32, dh
//   32, and 47,104 at L=16 (acl_mha_bld_tf32_bwd_smem_bytes).

#include "attention_common.cuh"
#include "tensor_core.cuh"

namespace {

constexpr int kBldWarps = 4;    // warps a block, each owning one (batch entry, head)
constexpr int kBldMaxL = 32;    // rows and keys a warp holds
constexpr int kBldKPad = 8;     // forward: floats of padding per staged K row
constexpr int kBldVPad = 4;     // forward: floats of padding per staged V row
constexpr int kBldPad = 4;      // backward: floats of padding per staged row and tile row

// Rows of the backward's tiles at length L: L rounded up to a whole m-tile.
__host__ __device__ constexpr int tile_rows(int L) { return (L + 15) / 16 * 16; }

template <int DH>
__host__ __device__ constexpr int fwd_warp_floats() {
  return kBldMaxL * (DH + kBldKPad) + kBldMaxL * (DH + kBldVPad);
}

size_t bwd_smem_bytes(int L, int dh) {
  const size_t r = tile_rows(L);
  return sizeof(float) * kBldWarps * (4 * r * (dh + kBldPad) + 2 * r * (r + kBldPad));
}

// The warp's share of staging `rows` rows of DH floats from src (row stride
// row_stride) into rows of PITCH floats at dst, 16 bytes a copy: rows from L on
// are zero-filled and their source is not read.
template <int DH, int PITCH>
__device__ __forceinline__ void stage_warp(float* dst, const float* src, int64_t row_stride,
                                           int rows, int L, int lane) {
  constexpr int PIECES = DH / 4;
  for (int i = lane; i < rows * PIECES; i += 32) {
    const int r = i / PIECES, c = i % PIECES * 4;
    const bool in = r < L;
    cp_async16(smem_u32(dst + r * PITCH + c), src + (in ? r * row_stride + c : 0), in ? 16 : 0);
  }
}

__device__ __forceinline__ const float* head_ptr(const Operand& t, int b, int h, int dh) {
  return static_cast<const float*>(t.ptr) + b * t.batch_stride + h * dh;
}

// the max and the sum of a row across the quad that holds it
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// S (16 rows from row0 x 32 keys, four 8-key n-tiles) of a warp, its keys
// past L and (causal) above the diagonal at -1e30, in raw score units; n-tiles
// wholly past L are not formed (their entries are masked).
__device__ __forceinline__ void mask_scores(float (&s)[4][4], int row0, int L, int causal, int g,
                                            int t) {
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = nt * 8 + 2 * t + (e & 1), row = row0 + g + (e >> 1) * 8;
      if (key >= L || (causal && key > row)) s[nt][e] = kNegInf;
    }
}

// e = exp(s scale - m scale) with the row max m, in place, and the row sums
// (rows g and g + 8), each across the quad.
__device__ __forceinline__ void exponent_rows(float (&s)[4][4], float (&sum)[2], float scale_log2) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float m = kNegInf;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) m = fmaxf(m, fmaxf(s[nt][2 * r], s[nt][2 * r + 1]));
    const float mc = quad_max(m) * scale_log2;
    float total = 0.f;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 2 * r; e < 2 * r + 2; ++e) {
        s[nt][e] = fast_exp2(fmaf(s[nt][e], scale_log2, -mc));  // 0 at the masked keys
        total += s[nt][e];
      }
    sum[r] = quad_sum(total);
  }
}

template <int DH>
__global__ void __launch_bounds__(kBldWarps * 32)
mha_bld_tf32_fwd_kernel(Operand q, Operand k, Operand v, float* __restrict__ out, int pairs, int L,
                        int H, int causal, float scale) {
  constexpr int KP = DH + kBldKPad, VP = DH + kBldVPad;
  static_assert(DH % 16 == 0, "output columns in groups of 16");
  __shared__ __align__(16) float tiles[kBldWarps][fwd_warp_floats<DH>()];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int pair = blockIdx.x * kBldWarps + warp;
  if (pair >= pairs) return;  // warps never wait on each other
  const int b = pair / H, h = pair % H;
  const int g = lane / 4, t = lane % 4;  // the fragment's row and column pair
  const float scale_log2 = scale * kLog2e;
  float* ks = tiles[warp];           // kBldMaxL x KP
  float* vs = ks + kBldMaxL * KP;    // kBldMaxL x VP
  const int keys = (L + 7) / 8 * 8;  // whole 8-key n-tiles, zero past L

  stage_warp<DH, KP>(ks, head_ptr(k, b, h, DH), k.row_stride, keys, L, lane);
  stage_warp<DH, VP>(vs, head_ptr(v, b, h, DH), v.row_stride, keys, L, lane);
  cp_async_commit();

  // the warp's Q rows in A fragment order, straight from device memory while
  // K and V land: step kk's logical dims t and t + 4 are dims 8 kk + 2t and
  // 8 kk + 2t + 1, rows past L zero
  const float* qp = head_ptr(q, b, h, DH);
  float qf[2][DH / 8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int r0 = mt * 16 + g, r1 = r0 + 8;
    const float* p0 = qp + r0 * q.row_stride + 2 * t;
    const float* p1 = qp + r1 * q.row_stride + 2 * t;
#pragma unroll
    for (int kk = 0; kk < DH / 8; ++kk) {
      const float2 x0 = r0 < L ? *reinterpret_cast<const float2*>(p0 + kk * 8) : make_float2(0.f, 0.f);
      const float2 x1 = r1 < L ? *reinterpret_cast<const float2*>(p1 + kk * 8) : make_float2(0.f, 0.f);
      qf[mt][kk][0] = x0.x;  // (row g, dim 2t)
      qf[mt][kk][1] = x1.x;  // (row g + 8, dim 2t)
      qf[mt][kk][2] = x0.y;  // (row g, dim 2t + 1)
      qf[mt][kk][3] = x1.y;  // (row g + 8, dim 2t + 1)
    }
  }
  cp_async_wait<0>();
  __syncwarp();

  float* op = out + ((int64_t)b * L) * H * DH + h * DH;
  const int64_t out_row = (int64_t)H * DH;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int row0 = mt * 16;
    if (row0 >= L) break;
    // S = Q K^T, each K element split as it is loaded; the cross terms in an
    // accumulator of their own, added once
    float s[4][4], sx[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = sx[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DH / 8; ++kk) {
      uint32_t qb[4], qs[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(qf[mt][kk][e], qb[e], qs[e]);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        if (nt * 8 >= L) break;
        const float2 kf = *reinterpret_cast<const float2*>(ks + (nt * 8 + g) * KP + kk * 8 + 2 * t);
        uint32_t kb0, ks0, kb1, ks1;
        split_tf32(kf.x, kb0, ks0);
        split_tf32(kf.y, kb1, ks1);
        mma_tf32(sx[nt], qs, kb0, kb1);
        mma_tf32(sx[nt], qb, ks0, ks1);
        mma_tf32(s[nt], qb, kb0, kb1);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] += sx[nt][e];
    mask_scores(s, row0, L, causal, g, t);
    float sum[2];
    exponent_rows(s, sum, scale_log2);

    // e V over four steps of 8 keys; step j's logical keys t and t + 4 are
    // keys 8 j + 2t and 8 j + 2t + 1, so its A fragment is the n-tile j as it
    // lies, (c0, c2, c1, c3); n-tiles 2 dp and 2 dp + 1 take the even and the
    // odd columns of the group of 16 from column 16 dp
    float o[DH / 8][4];
#pragma unroll
    for (int d = 0; d < DH / 8; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j * 8 >= L) break;
      uint32_t pb[4], ps[4];
      split_tf32(s[j][0], pb[0], ps[0]);  // (row g, key 2t)
      split_tf32(s[j][2], pb[1], ps[1]);  // (row g + 8, key 2t)
      split_tf32(s[j][1], pb[2], ps[2]);  // (row g, key 2t + 1)
      split_tf32(s[j][3], pb[3], ps[3]);  // (row g + 8, key 2t + 1)
      const float* v0 = vs + (j * 8 + 2 * t) * VP + 2 * g;  // key 2t, columns 2g and 2g + 1
#pragma unroll
      for (int dp = 0; dp < DH / 16; ++dp) {
        const float2 x0 = *reinterpret_cast<const float2*>(v0 + dp * 16);
        const float2 x1 = *reinterpret_cast<const float2*>(v0 + VP + dp * 16);  // key 2t + 1
        uint32_t eb0, es0, eb1, es1, ob0, os0, ob1, os1;
        split_tf32(x0.x, eb0, es0);
        split_tf32(x1.x, eb1, es1);
        split_tf32(x0.y, ob0, os0);
        split_tf32(x1.y, ob1, os1);
        mma_3xtf32(o[2 * dp], pb, ps, eb0, eb1, es0, es1);
        mma_3xtf32(o[2 * dp + 1], pb, ps, ob0, ob1, os0, os1);
      }
    }
    // one divide an element on the output row; a thread holds columns
    // 16 dp + 4t .. + 3 of rows g and g + 8: one float4 each
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + g + 8 * r;
      if (row >= L) continue;
      float* orow = op + row * out_row + 4 * t;
#pragma unroll
      for (int dp = 0; dp < DH / 16; ++dp)
        *reinterpret_cast<float4*>(orow + dp * 16) =
            make_float4(o[2 * dp][2 * r] / sum[r], o[2 * dp + 1][2 * r] / sum[r],
                        o[2 * dp][2 * r + 1] / sum[r], o[2 * dp + 1][2 * r + 1] / sum[r]);
    }
  }
}

// c[n] (16 x 8) = the warp's 16 rows of `rows` (from row0) . x[8n .. 8n + 7]^T
// over the DH columns, for the n-tiles before L: S or dP. Both operands are read
// at dims t and t + 4 of their rows and split as they are loaded; the cross
// terms sum apart and are added once (mha_tf32_bwd.cu: dim_products).
template <int DH>
__device__ __forceinline__ void dim_products(float (&c)[4][4], const float* rows, int row0,
                                             const float* x, int L, int g, int t) {
  constexpr int PITCH = DH + kBldPad;
  float cx[4][4];
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] = cx[n][e] = 0.f;
  const float* a = rows + (row0 + g) * PITCH + t;
  const float* b = x + g * PITCH + t;
#pragma unroll
  for (int kk = 0; kk < DH / 8; ++kk) {
    uint32_t ab[4], as[4];
    split_tf32(a[kk * 8], ab[0], as[0]);                  // (row g, dim t)
    split_tf32(a[8 * PITCH + kk * 8], ab[1], as[1]);      // (row g + 8, dim t)
    split_tf32(a[kk * 8 + 4], ab[2], as[2]);              // (row g, dim t + 4)
    split_tf32(a[8 * PITCH + kk * 8 + 4], ab[3], as[3]);  // (row g + 8, dim t + 4)
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      if (n * 8 >= L) break;
      uint32_t b0, s0, b1, s1;
      split_tf32(b[n * 8 * PITCH + kk * 8], b0, s0);
      split_tf32(b[n * 8 * PITCH + kk * 8 + 4], b1, s1);
      mma_tf32(cx[n], as, b0, b1);
      mma_tf32(cx[n], ab, s0, s1);
      mma_tf32(c[n], ab, b0, b1);
    }
  }
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] += cx[n][e];
}

// acc[d] (16 x 8, columns 8d .. 8d + 7) += a (16 x 8 logical) . x rows k0 + 2t
// and k0 + 2t + 1 (the step's logical t and t + 4), column 8d + g: the second
// kind of product (dQ, dK, dV), summed over 8 rows of x. ab and as are the A
// fragment's split parts.
template <int DH>
__device__ __forceinline__ void row_products(float (&acc)[DH / 8][4], const uint32_t (&ab)[4],
                                             const uint32_t (&as)[4], const float* x, int k0,
                                             int g, int t) {
  constexpr int PITCH = DH + kBldPad;
  const float* b = x + (k0 + 2 * t) * PITCH + g;
#pragma unroll
  for (int d = 0; d < DH / 8; ++d) {
    uint32_t b0, s0, b1, s1;
    split_tf32(b[d * 8], b0, s0);
    split_tf32(b[PITCH + d * 8], b1, s1);
    mma_3xtf32(acc[d], ab, as, b0, b1, s0, s1);
  }
}

template <int DH>
__global__ void __launch_bounds__(kBldWarps * 32)
mha_bld_tf32_bwd_kernel(Operand q, Operand k, Operand v, Operand go, float* __restrict__ dq,
                        float* __restrict__ dk, float* __restrict__ dv, int pairs, int L, int H,
                        int causal, float scale) {
  constexpr int PITCH = DH + kBldPad;
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int pair = blockIdx.x * kBldWarps + warp;
  if (pair >= pairs) return;  // warps never wait on each other
  const int b = pair / H, h = pair % H;
  const int g = lane / 4, t = lane % 4;
  const float scale_log2 = scale * kLog2e;
  const int R = tile_rows(L), TP = R + kBldPad;
  float* qs = smem + warp * (4 * R * PITCH + 2 * R * TP);  // R x PITCH each
  float* ks = qs + R * PITCH;
  float* vs = ks + R * PITCH;
  float* gs = vs + R * PITCH;
  float* pt = gs + R * PITCH;  // R x TP: P, rows by query, columns by key
  float* dt = pt + R * TP;     // R x TP: dS

  stage_warp<DH, PITCH>(qs, head_ptr(q, b, h, DH), q.row_stride, R, L, lane);
  stage_warp<DH, PITCH>(ks, head_ptr(k, b, h, DH), k.row_stride, R, L, lane);
  stage_warp<DH, PITCH>(vs, head_ptr(v, b, h, DH), v.row_stride, R, L, lane);
  stage_warp<DH, PITCH>(gs, head_ptr(go, b, h, DH), go.row_stride, R, L, lane);
  cp_async_commit();
  cp_async_wait<0>();
  __syncwarp();

  const int64_t row = (int64_t)H * DH;  // the outputs' row stride
  const int64_t first = (int64_t)b * L * row + h * DH;
  // per 16-row m-tile: S, dP, P and dS, then dQ = dS K from the accumulators;
  // P and dS go to the warp's tiles for dK and dV
  for (int row0 = 0; row0 < R; row0 += 16) {
    float s[4][4], dp[4][4];
    dim_products<DH>(s, qs, row0, ks, L, g, t);
    dim_products<DH>(dp, gs, row0, vs, L, g, t);
    mask_scores(s, row0, L, causal, g, t);
    float sum[2];
    exponent_rows(s, sum, scale_log2);
    // P = e / sum; delta = rowsum(P o dP); dS = P o (dP - delta) * scale
    float delta[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] /= sum[e >> 1];
        delta[e >> 1] = fmaf(s[nt][e], dp[nt][e], delta[e >> 1]);
      }
    delta[0] = quad_sum(delta[0]);
    delta[1] = quad_sum(delta[1]);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[nt][e] = s[nt][e] * (dp[nt][e] - delta[e >> 1]) * scale;

    float acc[DH / 8][4];
#pragma unroll
    for (int d = 0; d < DH / 8; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      if (nt * 8 >= R) break;
      // P and dS to the tiles: (row g, keys 2t, 2t + 1) and (row g + 8, ...)
      float* prow = pt + (row0 + g) * TP + nt * 8 + 2 * t;
      float* drow = dt + (row0 + g) * TP + nt * 8 + 2 * t;
      *reinterpret_cast<float2*>(prow) = make_float2(s[nt][0], s[nt][1]);
      *reinterpret_cast<float2*>(prow + 8 * TP) = make_float2(s[nt][2], s[nt][3]);
      *reinterpret_cast<float2*>(drow) = make_float2(dp[nt][0], dp[nt][1]);
      *reinterpret_cast<float2*>(drow + 8 * TP) = make_float2(dp[nt][2], dp[nt][3]);
      if (nt * 8 >= L) continue;
      // dQ += dS K over the n-tile's 8 keys: the accumulator as it lies is the
      // A fragment, (c0, c2, c1, c3)
      uint32_t ab[4], as[4];
      split_tf32(dp[nt][0], ab[0], as[0]);  // (row g, key 2t)
      split_tf32(dp[nt][2], ab[1], as[1]);  // (row g + 8, key 2t)
      split_tf32(dp[nt][1], ab[2], as[2]);  // (row g, key 2t + 1)
      split_tf32(dp[nt][3], ab[3], as[3]);  // (row g + 8, key 2t + 1)
      row_products<DH>(acc, ab, as, ks, nt * 8, g, t);
    }
    store_rows<DH>(acc, dq + first + row0 * row, row, row0, L, g, t);
  }
  __syncwarp();

  // per 16-key m-tile: dK = dS^T Q and dV = P^T G over the queries, 8 a step;
  // step j's logical queries t and t + 4 are queries 8 j + 2t and 8 j + 2t + 1,
  // read from the tiles' rows transposed
  for (int key0 = 0; key0 < L; key0 += 16) {
    float dka[DH / 8][4], dva[DH / 8][4];
#pragma unroll
    for (int d = 0; d < DH / 8; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) dka[d][e] = dva[d][e] = 0.f;
    for (int j = 0; j < L; j += 8) {
      const int at = (j + 2 * t) * TP + key0 + g;
      uint32_t ab[4], as[4];
      split_tf32(dt[at], ab[0], as[0]);               // (key g, query 2t)
      split_tf32(dt[at + 8], ab[1], as[1]);           // (key g + 8, query 2t)
      split_tf32(dt[at + TP], ab[2], as[2]);          // (key g, query 2t + 1)
      split_tf32(dt[at + TP + 8], ab[3], as[3]);      // (key g + 8, query 2t + 1)
      row_products<DH>(dka, ab, as, qs, j, g, t);
      split_tf32(pt[at], ab[0], as[0]);
      split_tf32(pt[at + 8], ab[1], as[1]);
      split_tf32(pt[at + TP], ab[2], as[2]);
      split_tf32(pt[at + TP + 8], ab[3], as[3]);
      row_products<DH>(dva, ab, as, gs, j, g, t);
    }
    store_rows<DH>(dka, dk + first + key0 * row, row, key0, L, g, t);
    store_rows<DH>(dva, dv + first + key0 * row, row, key0, L, g, t);
  }
}

// One block per kBldWarps (batch, head) pairs on the first grid axis.
bool grid_of(int B, int H, unsigned* blocks, int* pairs) {
  const int64_t n = (int64_t)B * H;
  if (B <= 0 || H <= 0 || n > 2147483647LL) return false;
  *pairs = (int)n;
  *blocks = (unsigned)((n + kBldWarps - 1) / kBldWarps);
  return true;
}

template <int DH>
cudaError_t launch_bwd(Operand q, Operand k, Operand v, Operand g, float* dq, float* dk,
                       float* dv, int B, int L, int H, int causal, float scale,
                       cudaStream_t stream) {
  static bool attribute_set = false;
  cudaError_t err = allow_optin_smem(mha_bld_tf32_bwd_kernel<DH>, &attribute_set);
  if (err != cudaSuccess) return err;
  unsigned blocks;
  int pairs;
  if (!grid_of(B, H, &blocks, &pairs)) return cudaErrorInvalidValue;
  mha_bld_tf32_bwd_kernel<DH><<<blocks, kBldWarps * 32, bwd_smem_bytes(L, DH), stream>>>(
      q, k, v, g, dq, dk, dv, pairs, L, H, causal, scale);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_fwd(Operand q, Operand k, Operand v, float* out, int B, int L, int H,
                       int causal, float scale, cudaStream_t stream) {
  unsigned blocks;
  int pairs;
  if (!grid_of(B, H, &blocks, &pairs)) return cudaErrorInvalidValue;
  mha_bld_tf32_fwd_kernel<DH><<<blocks, kBldWarps * 32, 0, stream>>>(q, k, v, out, pairs, L, H,
                                                                        causal, scale);
  return cudaGetLastError();
}

bool admitted(int L, int dh) { return L >= 1 && L <= kBldMaxL && (dh == 16 || dh == 32); }

}  // namespace

extern "C" {

// Shared-memory bytes one block needs: the forward's static tiles (independent
// of L), the backward's dynamic ones.
size_t acl_mha_bld_tf32_smem_bytes(int L, int dh, int backward) {
  if (backward) return bwd_smem_bytes(L, dh);
  return sizeof(float) * kBldWarps * (dh == 16 ? fwd_warp_floats<16>() : fwd_warp_floats<32>());
}

// Blocks of a kernel one SM holds (registers and shared memory); -1 on an
// error or a shape that is not admitted.
int acl_mha_bld_tf32_blocks_per_sm(int L, int dh, int backward) {
  if (!admitted(L, dh)) return -1;
  int blocks = 0;
  cudaError_t err;
  if (backward) {
    static bool set16 = false, set32 = false;
    err = dh == 16 ? allow_optin_smem(mha_bld_tf32_bwd_kernel<16>, &set16)
                   : allow_optin_smem(mha_bld_tf32_bwd_kernel<32>, &set32);
    if (err == cudaSuccess)
      err = dh == 16 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                           &blocks, mha_bld_tf32_bwd_kernel<16>, kBldWarps * 32, bwd_smem_bytes(L, 16))
                     : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                           &blocks, mha_bld_tf32_bwd_kernel<32>, kBldWarps * 32, bwd_smem_bytes(L, 32));
  } else {
    err = dh == 16 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                         &blocks, mha_bld_tf32_fwd_kernel<16>, kBldWarps * 32, 0)
                   : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                         &blocks, mha_bld_tf32_fwd_kernel<32>, kBldWarps * 32, 0);
  }
  return err == cudaSuccess ? blocks : -1;
}

// K2 in fp32. q, k, v: (B, L, D) fp32, each with element strides (batch, row,
// 1), 16-byte aligned; out: contiguous (B, L, D), D = H * dh.
int acl_mha_bld_tf32_fwd(const void* q, int64_t q_bs, int64_t q_rs, const void* k, int64_t k_bs,
                         int64_t k_rs, const void* v, int64_t v_bs, int64_t v_rs, void* out, int B,
                         int L, int H, int dh, int causal, float scale, void* stream) {
  if (!admitted(L, dh)) return (int)cudaErrorInvalidValue;
  const Operand qo{q, q_bs, q_rs}, ko{k, k_bs, k_rs}, vo{v, v_bs, v_rs};
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(dh == 16 ? launch_fwd<16>(qo, ko, vo, o, B, L, H, causal, scale, s)
                        : launch_fwd<32>(qo, ko, vo, o, B, L, H, causal, scale, s));
}

// K4 in fp32. q, k, v, g: (B, L, D) fp32, each with element strides (batch,
// row, 1), 16-byte aligned; dq, dk, dv: contiguous (B, L, D).
int acl_mha_bld_tf32_bwd(const void* q, int64_t q_bs, int64_t q_rs, const void* k, int64_t k_bs,
                         int64_t k_rs, const void* v, int64_t v_bs, int64_t v_rs, const void* g,
                         int64_t g_bs, int64_t g_rs, void* dq, void* dk, void* dv, int B, int L,
                         int H, int dh, int causal, float scale, void* stream) {
  if (!admitted(L, dh)) return (int)cudaErrorInvalidValue;
  const Operand qo{q, q_bs, q_rs}, ko{k, k_bs, k_rs}, vo{v, v_bs, v_rs}, go{g, g_bs, g_rs};
  float *dqo = static_cast<float*>(dq), *dko = static_cast<float*>(dk), *dvo = static_cast<float*>(dv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(dh == 16 ? launch_bwd<16>(qo, ko, vo, go, dqo, dko, dvo, B, L, H, causal, scale, s)
                        : launch_bwd<32>(qo, ko, vo, go, dqo, dko, dvo, B, L, H, causal, scale, s));
}

}  // extern "C"
