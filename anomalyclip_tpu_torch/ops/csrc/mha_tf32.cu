// Tensor-core multi-head attention for Hopper (sm_90a), fp32 operands, head dim
// 64: the fp32 kernel behind fused_mha_qkv, flash_attention_heads and
// fused_mha_qtile, its products split-TF32 (3xTF32) on the tensor cores.
//
// Three C entries, one kernel:
//
//   acl_mha_qkv_tf32_fwd  replaces _mha_qkv_kernel / fused_mha_qkv
//                         (anomalyclip_tpu/ops/pallas/attention.py:423-437, 466):
//                         one packed (B, L, 3D) qkv, lane order q|k|v, heads split
//                         inside, optional causal mask. The CLIP image towers
//                         (L=197, 257, 50) and the causal text towers (L=77) in
//                         fp32.
//   acl_flash_tf32_fwd    replaces _flash_kernel / flash_attention_heads
//                         (attention.py:800-854, 1056): q, k, v and the output
//                         through (batch, head, row) element strides, the per-row
//                         fp32 log-sum-exp on request, optional causal mask. The
//                         ViT-L/14@336px tower in fp32 through the core rung
//                         (fused_attention hands it the (B, H, L, dh) views of the
//                         packed qkv as they are, and takes the output in the
//                         (B, L, H, dh) layout the out projection reads), and that
//                         tower's fp32 gradient, whose K9 and K10 read the lse.
//
// Every operand and the output must be readable in 16-byte pieces (base address
// and every stride but the last), which the wrappers check. bf16 operands and the
// smaller head dims stay on the kernels of mha_tc.cu, mha.cu and mha_long.cu; the
// wrappers choose before the launch (ops/attention.py: mha_tf32_eligible).
//
// What it computes is _flash_kernel's arithmetic, which is _attend_head's
// function (attention.py:68-85): fp32 scores scaled by 1/sqrt(dh), causal
// entries and keys past L at -1e30 and the V rows past L zeroed; per block of 64
// keys the running row max m, alpha = exp(m_old - m_new) on the accumulator and
// the row sum, p = exp(s - m_new) summed in fp32; P is not rounded before P.V
// (fp32 has nothing to round to); one divide at the end, lse = m + log(l). The
// plain versions it is held against are the fp32 ones (mha_qkv_reference,
// flash_attention_reference, mha_qtile_reference).
//
// Products. TF32 is off in this port (no allow_tf32 flag is set anywhere), and
// this kernel does not turn it on: each fp32 operand x is split into big =
// tf32(x) and small = tf32(x - big) (cvt.rna's rounding: to nearest, ties away
// from zero), and each product a.b is small(a).big(b) + big(a).small(b) +
// big(a).big(b), three mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 a
// fragment pair, the cross terms first. That is how
// scaled_dot_product_attention's memory-efficient kernel computes fp32 too, and
// it keeps fp32 accuracy where plain TF32 does not (a CPU emulation: 3.6e-7 to
// 1.1e-6 from a float64 reference, plain TF32 2.4e-4 to 1.7e-3). The tensor
// cores round their fp32 sums toward zero at the accumulator's magnitude, so
// the order of the sums matters: the cross terms of Q.K^T sum in an accumulator
// of their own, and each KV block's P.V in one of its own, each added once
// (measured: 1.9e-6 from the fp32 plain version at (4096, 577, 64), where one
// accumulator for everything read 9.3e-6 against the limit of 1e-5; PERF.md).
//
// What bounds it on the card. At (4096, 577, 64), the ViT-L/14@336px tower's
// per-head shape, the two products are 4 L^2 dh N = 349 GFLOP, executed three
// times over on the TF32 pipe: 2.12 ms at 495 TFLOP/s (165 TFLOP/s of fp32
// products), against 0.72 ms for the 2.4 GB of operands and output at 3.35
// TB/s; at (256, 197, 2304), 12 heads, 0.19 ms either way; K6 at (64, 400,
// 1024), 16 heads, 0.25 ms of operations. The products bound it; PERF.md has
// the measured times beside sdpa's.
//
// Design. mha_tc.cu's block and pipeline with fp32 fragments:
// - A block is one (batch entry, head, q tile of 64 rows): 4 warps, each owning
//   16 query rows, the q tiles of a head next to each other in the grid so that
//   its K and V stay in L2. A warp's Q rows come straight from device memory into
//   registers as fp32, rows past L as zeros, and are split at each use: kept
//   split they would take 64 registers, and the two extra accumulators take 64
//   (243 a thread with them, no spills: 2 blocks an SM); a warp whose rows all
//   lie past L computes nothing.
// - K and V come in blocks of 64 keys through 16-byte cp.async into two stages:
//   the next block loads under the current block's products. K rows are padded
//   to 64 + 8 floats and V rows to 64 + 4, so that each 8-byte fragment load of
//   a half-warp hits 32 distinct banks (bank 8g + 2t for K, 8t + 2g for V, with
//   g = lane / 4 and t = lane % 4). Shared memory does not depend on L: 71,680 B
//   a block.
// - The fragments take every operand in 8-byte pieces by relabelling the sum's
//   index, which the products do not see. The m16n8k8 TF32 A fragment holds
//   columns t and t + 4 of rows g and g + 8, B rows t and t + 4 of column g; the
//   accumulator holds columns 2t and 2t + 1 (PTX ISA, the .tf32 m16n8k8
//   fragment figures). In Q.K^T the step's logical dim t is dim 2t and t + 4 is
//   2t + 1, so a thread reads q[g][2t, 2t+1] and k[key g][2t, 2t+1] as pairs.
//   In P.V the logical key t is key 2t and t + 4 is key 2t + 1: the S
//   accumulator (c0, c1, c2, c3) is, split, the A fragment (c0, c2, c1, c3) with
//   no shuffle, and V is read at rows 2t and 2t + 1. Its output columns are
//   relabelled too: of two n-tiles, the first takes the even columns of a
//   16-column group and the second the odd ones, so one 8-byte load of a V row
//   gives both n-tiles' B element, and a thread ends holding four neighbouring
//   output columns, stored as one float4.
// - K and V fragments are split as they are loaded, not once at staging: split
//   copies would double the staged bytes. The split is two integer operations
//   for each rounding (to_tf32), where cvt.rna.tf32.f32 is lowered to three: the
//   kernel 23-30% faster for the same bits.
// - The exponent is ex2.approx.ftz of (s c - m c), c = scale log2(e), one
//   multiply-add and one MUFU operation an element as in mha_tc.cu: its relative
//   error is about 2^-22, which the fp32 limits (1e-5 of the output) leave room
//   for; max and sum run in four partial chains a row and two quad shuffles.
// - Under the causal mask the KV loop ends at the tile's last row and a warp
//   skips the blocks wholly above its diagonal; keys past L and above the
//   diagonal are masked only in the blocks that hold them.

#include "attention_common.cuh"
#include "tensor_core.cuh"

namespace {

constexpr int kTfWarps = 4;    // warps per block, each owning 16 query rows
constexpr int kTfKV = 64;      // keys per KV block
constexpr int kTfStages = 2;   // KV blocks in flight
constexpr int kTfKPad = 8;     // floats of padding per staged K row
constexpr int kTfVPad = 4;     // floats of padding per staged V row
constexpr int kTfMinBlocks = 2;  // blocks an SM is compiled to hold

// Element (b, h, row, 0) of an operand or the output is at
// ptr + b * batch + h * head + row * row; columns are contiguous.
struct Heads {
  const float* ptr;
  int64_t batch, head, row;
};

template <int DH>
__global__ void __launch_bounds__(kTfWarps * 32, kTfMinBlocks)
mha_tf32_kernel(Heads q, Heads k, Heads v, Heads out, float* __restrict__ lse, int L, int H,
                int tiles, int causal, float scale) {
  constexpr int BM = 16 * kTfWarps, BN = kTfKV, THREADS = kTfWarps * 32;
  constexpr int KP = DH + kTfKPad, VP = DH + kTfVPad;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ks = reinterpret_cast<float*>(smem);  // kTfStages x BN x KP
  float* vs = ks + kTfStages * BN * KP;        // kTfStages x BN x VP

  const int tile = blockIdx.x % tiles;
  const int h = (blockIdx.x / tiles) % H;
  const int b = blockIdx.x / (tiles * H);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // the fragment's row and column pair
  const float scale_log2 = scale * kLog2e;

  const float* qp = q.ptr + b * q.batch + h * q.head;
  const float* kp = k.ptr + b * k.batch + h * k.head;
  const float* vp = v.ptr + b * v.batch + h * v.head;

  const int q0 = tile * BM;
  const int kv_end = causal ? min(L, q0 + BM) : L;
  const int blocks = (kv_end + BN - 1) / BN;

  // this thread's piece of a staging pass: row lr of the pass, 4 floats at lc
  constexpr int PASS = THREADS / (DH / 4);
  const int lr = threadIdx.x / (DH / 4), lc = threadIdx.x % (DH / 4) * 4;
  const float* kptr = kp + lr * k.row + lc;  // its piece of the KV block to load next
  const float* vptr = vp + lr * v.row + lc;
  const int64_t kpass = PASS * k.row, vpass = PASS * v.row;
  const int64_t kblock = BN * k.row, vblock = BN * v.row;
  const uint32_t kdst = smem_u32(ks + lr * KP + lc), vdst = smem_u32(vs + lr * VP + lc);
  constexpr uint32_t kStageBytes = BN * KP * sizeof(float), vStageBytes = BN * VP * sizeof(float);

  stage_rows_f32<DH, BN, THREADS, KP>(kdst, kptr, kpass, lr, L);
  stage_rows_f32<DH, BN, THREADS, VP>(vdst, vptr, vpass, lr, L);
  cp_async_commit();

  const int wrow = q0 + warp * 16;  // the warp's first query row
  const bool active = wrow < L;     // a warp whose rows all lie past L computes nothing

  // the warp's Q rows in A fragment order, as fp32 (split at each use: 32
  // registers, where both parts would take 64): step kk's logical dims t and
  // t + 4 are dims 8 kk + 2t and 8 kk + 2t + 1
  float qf[DH / 8][4];
  {
    const float* r0 = qp + (int64_t)(wrow + g) * q.row + 2 * t;
    const float* r1 = r0 + 8 * q.row;
    const bool in0 = wrow + g < L, in1 = wrow + g + 8 < L;
#pragma unroll
    for (int kk = 0; kk < DH / 8; ++kk) {
      const float2 x0 = in0 ? *reinterpret_cast<const float2*>(r0 + kk * 8) : make_float2(0.f, 0.f);
      const float2 x1 = in1 ? *reinterpret_cast<const float2*>(r1 + kk * 8) : make_float2(0.f, 0.f);
      qf[kk][0] = x0.x;  // (row g, dim 2t)
      qf[kk][1] = x1.x;  // (row g + 8, dim 2t)
      qf[kk][2] = x0.y;  // (row g, dim 2t + 1)
      qf[kk][3] = x1.y;  // (row g + 8, dim 2t + 1)
    }
  }

  float o[DH / 8][4];
#pragma unroll
  for (int i = 0; i < DH / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, sum[2] = {0.f, 0.f};  // rows g and g + 8; m in score units

  for (int blk = 0; blk < blocks; ++blk) {
    const int kv0 = blk * BN;
    cp_async_wait<0>();
    __syncthreads();  // block blk has landed, and every warp is done with block blk - 1
    if (blk + 1 < blocks) {
      const int stage = (blk + 1) % kTfStages;
      kptr += kblock;
      vptr += vblock;
      stage_rows_f32<DH, BN, THREADS, KP>(kdst + stage * kStageBytes, kptr, kpass, lr, L - kv0 - BN);
      stage_rows_f32<DH, BN, THREADS, VP>(vdst + stage * vStageBytes, vptr, vpass, lr, L - kv0 - BN);
      cp_async_commit();
    }
    // under the causal mask a block wholly above the warp's diagonal adds nothing
    if (!active || (causal && kv0 > wrow + 15)) continue;

    const float* kst = ks + (blk % kTfStages) * BN * KP;
    const float* vst = vs + (blk % kTfStages) * BN * VP;

    // S = Q K^T: 16 rows x 64 keys, eight n-tiles of 8 keys, each K element
    // split as it is loaded. The cross terms sum in their own accumulator,
    // added to the big parts' product once: the tensor cores' fp32 sums round
    // toward zero at the accumulator's magnitude, and the small terms' sums
    // would otherwise round at the scores' (measured: 1.9e-6 from the fp32
    // plain version at (4096, 577, 64) against 3.1e-6; PERF.md)
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

    // the mask, only in a block that holds keys past L or above the diagonal
    if (kv0 + BN > L || (causal && kv0 + BN - 1 > wrow)) {
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = kv0 + nt * 8 + 2 * t + (e & 1);
          const int row = wrow + g + (e >> 1) * 8;
          if (key >= L || (causal && key > row)) s[nt][e] = kNegInf;
        }
    }

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
    // p = exp2(s c - m c), c = scale log2(e); four partial sums a row
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
    // the block's P V in an accumulator of its own, added to O once: at the
    // block's magnitude, not the sum's over every block before it, the tensor
    // cores' sums lose less (measured: 3.1e-6 from the fp32 plain version at
    // (4096, 577, 64) against 9.3e-6; PERF.md)
    float pv[DH / 8][4];
#pragma unroll
    for (int dt = 0; dt < DH / 8; ++dt) pv[dt][0] = pv[dt][1] = pv[dt][2] = pv[dt][3] = 0.f;

    // P V over eight steps of 8 keys; step j's logical keys t and t + 4 are
    // keys 8 j + 2t and 8 j + 2t + 1, so its A fragment is the S n-tile j as it
    // lies, (c0, c2, c1, c3); n-tiles 2 dp and 2 dp + 1 take the even and the odd
    // columns of the group of 16 from column 16 dp
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      uint32_t pb[4], ps[4];
      split_tf32(s[j][0], pb[0], ps[0]);  // (row g, key 2t)
      split_tf32(s[j][2], pb[1], ps[1]);  // (row g + 8, key 2t)
      split_tf32(s[j][1], pb[2], ps[2]);  // (row g, key 2t + 1)
      split_tf32(s[j][3], pb[3], ps[3]);  // (row g + 8, key 2t + 1)
      const float* v0 = vst + (j * 8 + 2 * t) * VP + 2 * g;  // key 2t, columns 2g and 2g + 1
#pragma unroll
      for (int dp = 0; dp < DH / 16; ++dp) {
        const float2 x0 = *reinterpret_cast<const float2*>(v0 + dp * 16);
        const float2 x1 = *reinterpret_cast<const float2*>(v0 + VP + dp * 16);  // key 2t + 1
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
      o[dt][0] = fmaf(o[dt][0], alpha[0], pv[dt][0]);
      o[dt][1] = fmaf(o[dt][1], alpha[0], pv[dt][1]);
      o[dt][2] = fmaf(o[dt][2], alpha[1], pv[dt][2]);
      o[dt][3] = fmaf(o[dt][3], alpha[1], pv[dt][3]);
    }
  }

  if (!active) return;
  // the row sums across the quad, one divide an element, and the log-sum-exp;
  // a thread holds columns 16 dp + 4t .. + 3 of rows g and g + 8: one float4 each
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
  }
  float* op = const_cast<float*>(out.ptr) + b * out.batch + h * out.head;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wrow + g + 8 * r;
    if (row >= L) continue;
    float* orow = op + (int64_t)row * out.row + 4 * t;
#pragma unroll
    for (int dp = 0; dp < DH / 16; ++dp)
      *reinterpret_cast<float4*>(orow + dp * 16) =
          make_float4(o[2 * dp][2 * r] / sum[r], o[2 * dp + 1][2 * r] / sum[r],
                      o[2 * dp][2 * r + 1] / sum[r], o[2 * dp + 1][2 * r + 1] / sum[r]);
    if (lse != nullptr && t == 0)
      lse[((int64_t)b * H + h) * L + row] = m[r] * scale + logf(sum[r]);
  }
}

size_t tf32_smem_bytes(int dh) {
  return sizeof(float) * (size_t)kTfStages * kTfKV * ((dh + kTfKPad) + (dh + kTfVPad));
}

// dh: 64. lse: (B, H, L) contiguous fp32, or null.
cudaError_t launch(Heads q, Heads k, Heads v, Heads out, float* lse, int B, int H, int L, int dh,
                   int causal, float scale, cudaStream_t stream) {
  if (dh != 64) return cudaErrorInvalidValue;
  static bool attribute_set = false;
  cudaError_t err = allow_optin_smem(mha_tf32_kernel<64>, &attribute_set);
  if (err != cudaSuccess) return err;
  const int tiles = (L + 16 * kTfWarps - 1) / (16 * kTfWarps);
  const int64_t blocks = (int64_t)tiles * H * B;
  if (blocks <= 0 || blocks > 2147483647LL) return cudaErrorInvalidValue;
  mha_tf32_kernel<64><<<(unsigned)blocks, kTfWarps * 32, tf32_smem_bytes(64), stream>>>(
      q, k, v, out, lse, L, H, tiles, causal, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared-memory bytes one block needs: independent of L.
size_t acl_mha_tf32_smem_bytes(int dh) { return tf32_smem_bytes(dh); }

// Blocks of the kernel one SM holds (registers and shared memory); -1 on an
// error or a head dim that is not instantiated.
int acl_mha_tf32_blocks_per_sm(int dh) {
  if (dh != 64) return -1;
  static bool attribute_set = false;
  if (allow_optin_smem(mha_tf32_kernel<64>, &attribute_set) != cudaSuccess) return -1;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, mha_tf32_kernel<64>, kTfWarps * 32,
                                                    tf32_smem_bytes(64)) != cudaSuccess)
    return -1;
  return blocks;
}

// K1 in fp32. qkv: (B, L, 3D) fp32 with element strides (batch_stride,
// row_stride, 1), 16-byte aligned; out: contiguous (B, L, D), D = H * dh.
int acl_mha_qkv_tf32_fwd(const void* qkv, int64_t batch_stride, int64_t row_stride, void* out,
                         int B, int L, int H, int dh, int causal, float scale, void* stream) {
  const float* base = static_cast<const float*>(qkv);
  const int64_t D = (int64_t)H * dh;
  Heads q{base, batch_stride, dh, row_stride};
  Heads k{base + D, batch_stride, dh, row_stride};
  Heads v{base + 2 * D, batch_stride, dh, row_stride};
  Heads o{static_cast<const float*>(out), L * D, dh, D};
  return (int)launch(q, k, v, o, nullptr, B, H, L, dh, causal, scale,
                     static_cast<cudaStream_t>(stream));
}

// K8 in fp32. ptrs: q, k, v, out, each (B, H, L, dh) with its (batch, head, row)
// element strides in strides[3 i .. 3 i + 2], 16-byte aligned (per-head (N, L,
// dh) tensors are B = N, H = 1); lse: contiguous (B, H, L) fp32, or null.
int acl_flash_tf32_fwd(const void* const* ptrs, const int64_t* strides, void* lse, int B, int H,
                       int L, int dh, int causal, float scale, void* stream) {
  Heads t[4];
  for (int i = 0; i < 4; ++i)
    t[i] = Heads{static_cast<const float*>(ptrs[i]), strides[3 * i], strides[3 * i + 1],
                 strides[3 * i + 2]};
  return (int)launch(t[0], t[1], t[2], t[3], static_cast<float*>(lse), B, H, L, dh, causal, scale,
                     static_cast<cudaStream_t>(stream));
}

// K6 in fp32. q: (B, L, D) and kv: (B, L, 2D), lane order k|v, each with element
// strides (batch_stride, row_stride, 1), 16-byte aligned; out: contiguous
// (B, L, D), D = H * dh. Non-causal.
int acl_mha_qtile_tf32_fwd(const void* q, int64_t q_bs, int64_t q_rs, const void* kv, int64_t kv_bs,
                           int64_t kv_rs, void* out, int B, int L, int H, int dh, float scale,
                           void* stream) {
  const float* kvp = static_cast<const float*>(kv);
  const int64_t D = (int64_t)H * dh;
  Heads qh{static_cast<const float*>(q), q_bs, dh, q_rs};
  Heads kh{kvp, kv_bs, dh, kv_rs};
  Heads vh{kvp + D, kv_bs, dh, kv_rs};
  Heads o{static_cast<const float*>(out), L * D, dh, D};
  return (int)launch(qh, kh, vh, o, nullptr, B, H, L, dh, /*causal=*/0, scale,
                     static_cast<cudaStream_t>(stream));
}

}  // extern "C"
