// Tensor-core KV-blocked attention backward for Hopper (sm_90a), bf16 operands,
// head dim 64, with an optional causal mask: the bf16 kernels behind every caller
// of the KV-blocked backward pair.
//
// Two C entries, two kernels, which replace in bf16 at head dim 64 what
// mha_blocked_bwd.cu computes on the CUDA cores (fp32 and the smaller head dims
// stay there; the wrapper chooses before the launch):
//
//   acl_blocked_dq_tc   the dq pass: _flash_dq_kernel
//                       (anomalyclip_tpu/ops/pallas/attention.py:904-940) when
//                       the row statistics are given, and the dq half of
//                       _mha_qtile_bwd_kernel (:646-708) when it rebuilds them;
//   acl_blocked_dkv_tc  the dk, dv pass: _flash_dkv_kernel (:943-993) and the
//                       dk|dv half of _mha_qtile_bwd_kernel.
//
// Every operand is read in place through (batch, head, row) element strides and
// every gradient written straight into its packed layout, as in
// mha_blocked_bwd.cu; here each must also be readable in 16-byte pieces (base
// address and strides), which the wrapper checks.
//
// What it computes, per (batch, head): S = Q K^T * scale in fp32, keys past L
// (and, under the mask, above the diagonal) at -1e30; P = exp(S - lse) in fp32;
// dP = G V^T; dS = P o (dP - delta) * scale rounded to bf16; P rounded to bf16
// for dV; dQ = dS K, dK = dS^T Q, dV = P^T G, every product summed in fp32 and
// stored in bf16. The row statistics are two, the log-sum-exp and delta:
//
//   given      lse is the forward's, delta = rowsum(g o out) from the rounded
//              output: the flash backward (_flash_bwd_impl :1013-1016);
//   recompute  the dq kernel first sweeps the KV blocks with an online max m,
//              sum l and the running sum of exp(S - m) o dP, so that delta =
//              rowsum(P o dP) with P normalised in fp32, as _mha_qtile_bwd_kernel
//              and _mha_bwd_head (:244-270) have it. It hands the dkv kernel
//              lse = m + log(l) and delta through device memory: exp(S - lse) is
//              exp(S - m) / l to fp32 rounding, and one statistic less spares
//              the dkv pass a reciprocal per column of every tile.
//
// What bounds it on the card. The five products are 10 L^2 dh FLOP per (batch,
// head); this design does nine (S and dP are rebuilt by the dkv pass, and once
// more by the statistics sweep), now on the tensor cores. At q, g (32, 577,
// 1024) with kv (32, 577, 2048), 16 heads, that is 0.11 ms at 989 TFLOP/s for
// the five and 0.20 ms for the nine, against 0.05 ms for the bytes. Measured
// (NVIDIA H100 80GB HBM3, 700 W): 1.0 ms there, 0.36 ms for the dq pass and 0.43
// ms for the dkv pass with given statistics at (512, 577, 64), against 12.4, 3.9
// and 5.5 ms for the CUDA-core pair and 0.7-0.8 ms for the forward and backward
// of scaled_dot_product_attention; 200-250 TFLOP/s of the executed products.
// What holds it there is what holds mha_tc.cu: a warp issues one HMMA in six to
// eight instructions (per 64 x 64 tile the dkv kernel runs 128 HMMA, 72 LDSM, 32
// MUFU.EX2 and the index and rounding arithmetic; scripts/bench_mha_tc.py --sass
// prints the mix), and nothing saturates. The rest is wgmma's, a deeper
// pipeline's, and a design that shares S and dP between the passes.
//
// Design, shared by both kernels with mha_tc.cu.
// - Every product is mma.sync.aligned.m16n8k16 (bf16 x bf16 -> fp32) with
//   ldmatrix fragments; a block is 4 warps, a warp owns 16 rows of its tile.
// - Streamed tiles come in 64 rows through 16-byte cp.async into two stages,
//   bf16, rows padded to dh + 8; a thread's copy addresses are computed once.
// - P and dS never touch shared memory: the fp32 accumulator fragments of S and
//   dP for 16 columns are, after the exponent and the rounding to bf16, the A
//   fragment of the product that follows. The exponent is one multiply-add and
//   one ex2.approx: exp2(s c - lse log2(e)) with c = scale log2(e).
// - No atomics, every output written once, a fixed order of sums: two runs give
//   the same bits. Outputs go back through the warp's own (spent) resident rows
//   in shared memory, so they are written in 16-byte rows.
//
//   dq   one block per (batch, head, 64-row q tile). Q and G fragments are
//        loaded once and stay in registers; K and V blocks of 64 keys stream.
//        Per 16 keys: the S and dP fragments, dS in registers, and dS K with K
//        read through ldmatrix.trans. In recompute mode the statistics sweep
//        runs over the same blocks first (row max by two shuffles among the
//        four lanes of a row, the sums as per-lane partials until the end) and
//        the two sweeps share one pipeline: the last block of the first sweep
//        loads under it the first block of the second.
//   dkv  one block per (batch, head, 64-key KV block). It computes the
//        transposed tiles, S^T = K Q^T and dP^T = V G^T, with the block's K and
//        V fragments resident in registers and the q/g tiles, with their lse
//        and delta, streamed; P^T and dS^T in bf16 are the A fragments of P^T G
//        and dS^T Q, and G and Q their B operands through ldmatrix.trans. The
//        row statistics run along the fragment's columns: a thread reads the 16
//        it needs per tile from shared memory. dk and dv stay in registers until
//        the end.
// - Ragged edges and the mask. Rows and keys past L are zero-filled on load. In
//   the dq pass keys past L are masked in the block that holds them; in the dkv
//   pass rows past L are masked in the tile that holds them (zero q and g are
//   not enough: exp(0 - lse) is not 0), while the block's own keys past L only
//   feed rows of dk and dv that are never written. Chunks of 16 columns that lie
//   wholly past L, or wholly under the mask, are skipped, and a warp whose 16
//   rows all lie past L computes nothing. Under the mask the dq pass ends at its
//   tile's diagonal block and the dkv pass starts at its block's own q tile:
//   tiles and blocks are both 64 wide and aligned, so every row of a visited
//   tile sees the first key of every visited block and the online max never
//   meets a block it is wholly masked out of.
// - Shared memory is independent of L: 55,296 B a block of the dq kernel (the q
//   and g tiles, two stages of K and V) and 56,320 B of the dkv kernel (the K and
//   V block, two stages of q, g and the statistics). Both are compiled for three
//   blocks an SM (168 registers a thread): the dkv kernel holds 96 registers of
//   resident fragments and accumulators before its tile's work.

#include "attention_common.cuh"
#include "tensor_core.cuh"

namespace {

constexpr int kBwdWarps = 4;         // warps per block, each owning 16 rows of its tile
constexpr int kBwdThreads = kBwdWarps * 32;
constexpr int kBwdTile = 64;         // q rows per tile and keys per KV block
constexpr int kBwdStages = 2;        // streamed tiles in flight
constexpr int kBwdBlocksPerSm = 3;   // what the kernels are compiled for
constexpr float kLn2 = 0.6931471805599453f;
static_assert(kBwdTile == 16 * kBwdWarps, "a warp owns 16 rows of the tile");

struct Strided {
  void* ptr;  // element (batch 0, head 0, row 0, column 0); columns are contiguous
  int64_t batch_stride;
  int64_t head_stride;
  int64_t row_stride;
};

__device__ __forceinline__ bf16* head_base(const Strided& t, int b, int h) {
  return static_cast<bf16*>(t.ptr) + b * t.batch_stride + h * t.head_stride;
}

// The accumulator fragments of two neighbouring 8-column tiles, rounded to bf16:
// the A fragment of the product over those 16 columns.
__device__ __forceinline__ void as_a_fragment(uint32_t (&a)[4], const float (&lo)[4],
                                              const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// c (16 x 8) += a (16 x DH) . rows[n0 .. n0 + 7]^T: the staged rows are the B
// operand as they lie (k along a row), read with plain ldmatrix.
template <int DH>
__device__ __forceinline__ void mma_rows(float (&c)[4], const uint32_t (&a)[DH / 16][4],
                                         const bf16* rows, int n0, int lane) {
  constexpr int PITCH = DH + kTcPad;
#pragma unroll
  for (int kk = 0; kk < DH / 32; ++kk) {
    uint32_t b[4];
    ldmatrix_x4(b, smem_u32(rows + (n0 + lane % 8) * PITCH + kk * 32 + (lane / 8) * 8));
    mma_bf16(c, a[2 * kk], b[0], b[1]);
    mma_bf16(c, a[2 * kk + 1], b[2], b[3]);
  }
}

// acc (16 x DH) += a (16 x 16) . rows[k0 .. k0 + 15]: the staged rows are the B
// operand transposed (n along a row), read with ldmatrix.trans.
template <int DH>
__device__ __forceinline__ void mma_columns(float (&acc)[DH / 8][4], const uint32_t (&a)[4],
                                            const bf16* rows, int k0, int lane) {
  constexpr int PITCH = DH + kTcPad;
#pragma unroll
  for (int dp = 0; dp < DH / 16; ++dp) {
    uint32_t b[4];
    ldmatrix_x4_trans(b, smem_u32(rows + (k0 + (lane / 8 % 2) * 8 + lane % 8) * PITCH + dp * 16 +
                                  (lane / 16) * 8));
    mma_bf16(acc[2 * dp], a, b[0], b[1]);
    mma_bf16(acc[2 * dp + 1], a, b[2], b[3]);
  }
}

// A warp's 16 x DH accumulator through its own 16 spent rows of shared memory
// to 16-byte stores: row r goes to out + r * row_stride where first + r < L.
template <int DH>
__device__ __forceinline__ void store_tile(const float (&acc)[DH / 8][4], bf16* spent, bf16* out,
                                           int64_t row_stride, int first, int L, int lane) {
  constexpr int PITCH = DH + kTcPad;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int dt = 0; dt < DH / 8; ++dt) {
    *reinterpret_cast<__nv_bfloat162*>(spent + g * PITCH + dt * 8 + 2 * t) =
        __floats2bfloat162_rn(acc[dt][0], acc[dt][1]);
    *reinterpret_cast<__nv_bfloat162*>(spent + (g + 8) * PITCH + dt * 8 + 2 * t) =
        __floats2bfloat162_rn(acc[dt][2], acc[dt][3]);
  }
  __syncwarp();
  for (int i = lane; i < 16 * (DH / 8); i += 32) {
    const int r = i / (DH / 8), c = i % (DH / 8);
    if (first + r < L)
      *reinterpret_cast<uint4*>(out + r * row_stride + c * 8) =
          *reinterpret_cast<const uint4*>(spent + r * PITCH + c * 8);
  }
}

template <int DH>
__global__ void __launch_bounds__(kBwdThreads, kBwdBlocksPerSm)
blocked_dq_tc_kernel(Strided q, Strided k, Strided v, Strided g, Strided dq,
                     float* __restrict__ lse, float* __restrict__ delta, int recompute, int L, int H,
                     int tiles, int causal, float scale, float scale_log2) {
  constexpr int BM = kBwdTile, BN = kBwdTile, PITCH = DH + kTcPad, THREADS = kBwdThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);  // BM x PITCH; later the dq tile
  bf16* gs = qs + BM * PITCH;                // BM x PITCH
  bf16* ks = gs + BM * PITCH;                // kBwdStages x BN x PITCH
  bf16* vs = ks + kBwdStages * BN * PITCH;   // kBwdStages x BN x PITCH

  const int tile = blockIdx.x % tiles;
  const int h = (blockIdx.x / tiles) % H;
  const int b = blockIdx.x / (tiles * H);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, t = lane % 4;  // the fragment's row and column pair

  const int q0 = tile * BM;
  const int kv_end = causal ? min(L, q0 + BM) : L;  // the blocks past it are all masked
  const int blocks = (kv_end + BN - 1) / BN;

  // this thread's piece of a staging pass: row lr of the pass, 8 elements at lc
  constexpr int PASS = THREADS / (DH / 8);
  const int lr = threadIdx.x / (DH / 8), lc = threadIdx.x % (DH / 8) * 8;
  const bf16* kptr = head_base(k, b, h) + lr * k.row_stride + lc;  // its piece of KV block 0
  const bf16* vptr = head_base(v, b, h) + lr * v.row_stride + lc;
  const int64_t kpass = PASS * k.row_stride, vpass = PASS * v.row_stride;
  const int64_t kblock = BN * k.row_stride, vblock = BN * v.row_stride;
  const uint32_t kdst = smem_u32(ks + lr * PITCH + lc), vdst = smem_u32(vs + lr * PITCH + lc);
  constexpr uint32_t kStageBytes = BN * PITCH * sizeof(bf16);

  int staged = 0;  // KV blocks staged so far, over both sweeps: the i-th sits in stage i % 2
  auto stage_kv = [&](int blk) {
    const uint32_t stage = staged % kBwdStages * kStageBytes;
    stage_rows<DH, BN, THREADS>(kdst + stage, kptr + blk * kblock, kpass, lr, L - blk * BN);
    stage_rows<DH, BN, THREADS>(vdst + stage, vptr + blk * vblock, vpass, lr, L - blk * BN);
    cp_async_commit();
    ++staged;
  };
  stage_rows<DH, BM, THREADS>(smem_u32(qs + lr * PITCH + lc),
                              head_base(q, b, h) + (q0 + lr) * q.row_stride + lc,
                              PASS * q.row_stride, lr, L - q0);
  stage_rows<DH, BM, THREADS>(smem_u32(gs + lr * PITCH + lc),
                              head_base(g, b, h) + (q0 + lr) * g.row_stride + lc,
                              PASS * g.row_stride, lr, L - q0);
  stage_kv(0);

  const int wrow = q0 + warp * 16;  // the warp's first query row
  const bool active = wrow < L;     // a warp whose rows all lie past L computes nothing
  const int64_t first = ((int64_t)b * H + h) * L;  // of this head's statistics
  uint32_t qf[DH / 16][4], gf[DH / 16][4];
  int done = 0;  // KV blocks consumed so far, over both sweeps
  // block `done` has landed and every warp is done with the one before it; the
  // next one loads under this one's products
  auto next_block = [&](int following) {
    cp_async_wait<0>();
    __syncthreads();
    if (following >= 0) stage_kv(following);
    if (done == 0) {
#pragma unroll
      for (int kq = 0; kq < DH / 16; ++kq) {
        load_a_fragment(qf[kq], qs, PITCH, warp * 16, kq * 16, lane);
        load_a_fragment(gf[kq], gs, PITCH, warp * 16, kq * 16, lane);
      }
    }
    return (done++) % kBwdStages * BN * PITCH;  // the block's offset in ks and vs
  };
  // whether the block at kv0 holds a key this warp must mask
  auto needs_mask = [&](int kv0) { return kv0 + BN > L || (causal && kv0 + BN - 1 > wrow); };
  auto masked = [&](int key, int row) { return key >= L || (causal && key > row); };

  // rows gid and gid + 8: -lse log2(e), so that p = exp2(s c + nlse2), and delta
  float nlse2[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f};
  if (recompute) {
    // the statistics sweep: online max (in score units), sum and sum of
    // exp(S - m) o dP per row
    float m[2] = {kNegInf, kNegInf}, sum[2] = {0.f, 0.f}, dsum[2] = {0.f, 0.f};
    for (int blk = 0; blk < blocks; ++blk) {
      const int kv0 = blk * BN;
      const int at = next_block(blk + 1 < blocks ? blk + 1 : 0);  // then the second sweep's first
      if (!active) continue;
      const bf16* kst = ks + at;
      const bf16* vst = vs + at;
      float s[BN / 8][4];
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
        mma_rows<DH>(s[nt], qf, kst, nt * 8, lane);
      }
      if (needs_mask(kv0)) {
#pragma unroll
        for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (masked(kv0 + nt * 8 + 2 * t + (e & 1), wrow + gid + (e >> 1) * 8)) s[nt][e] = kNegInf;
      }
      float alpha[2], mc[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx[4];  // four partial maxima a row so that the chains are short
#pragma unroll
        for (int c = 0; c < 4; ++c)
          mx[c] = fmaxf(fmaxf(s[c][2 * r], s[c][2 * r + 1]), fmaxf(s[c + 4][2 * r], s[c + 4][2 * r + 1]));
        float top = fmaxf(fmaxf(fmaxf(mx[0], mx[1]), fmaxf(mx[2], mx[3])), m[r]);
        top = fmaxf(top, __shfl_xor_sync(0xffffffffu, top, 1));
        top = fmaxf(top, __shfl_xor_sync(0xffffffffu, top, 2));
        alpha[r] = fast_exp2((m[r] - top) * scale_log2);
        m[r] = top;
        mc[r] = top * scale_log2;
        sum[r] *= alpha[r];
        dsum[r] *= alpha[r];
      }
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
        float dp[4] = {0.f, 0.f, 0.f, 0.f};
        mma_rows<DH>(dp, gf, vst, nt * 8, lane);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = fast_exp2(fmaf(s[nt][e], scale_log2, -mc[e >> 1]));  // 0 at the masked keys
          sum[e >> 1] += p;
          dsum[e >> 1] = fmaf(p, dp[e], dsum[e >> 1]);
        }
      }
    }
    if (active) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
        dsum[r] += __shfl_xor_sync(0xffffffffu, dsum[r], 1);
        dsum[r] += __shfl_xor_sync(0xffffffffu, dsum[r], 2);
        nlse2[r] = -(m[r] * scale_log2 + log2f(sum[r]));
        dl[r] = dsum[r] / sum[r];
        const int row = wrow + gid + r * 8;
        if (t == 0 && row < L) {  // for the dkv kernel that follows on the stream
          lse[first + row] = -nlse2[r] * kLn2;
          delta[first + row] = dl[r];
        }
      }
    }
  } else if (active) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = wrow + gid + r * 8;
      if (row < L) {
        nlse2[r] = -lse[first + row] * kLog2e;
        dl[r] = delta[first + row];
      }
    }
  }

  // the gradient sweep: dq[r][c] += sum_j dS[r][j] K[j][c], 16 keys at a time
  const float dls[2] = {dl[0] * scale, dl[1] * scale};
  float acc[DH / 8][4];
#pragma unroll
  for (int i = 0; i < DH / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  for (int blk = 0; blk < blocks; ++blk) {
    const int kv0 = blk * BN;
    const int at = next_block(blk + 1 < blocks ? blk + 1 : -1);
    if (!active) continue;
    const bf16* kst = ks + at;
    const bf16* vst = vs + at;
    const bool mask = needs_mask(kv0);
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) {
      // the chunks from here on lie past L, or wholly above the warp's diagonal
      if (kv0 + j * 16 >= L || (causal && kv0 + j * 16 > wrow + 15)) break;
      float s[2][4], dp[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
        dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
        mma_rows<DH>(s[n], qf, kst, j * 16 + n * 8, lane);
        mma_rows<DH>(dp[n], gf, vst, j * 16 + n * 8, lane);
      }
      if (mask) {  // only in a block that holds such keys: p is 0 there
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (masked(kv0 + j * 16 + n * 8 + 2 * t + (e & 1), wrow + gid + (e >> 1) * 8))
              s[n][e] = kNegInf;
      }
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = fast_exp2(fmaf(s[n][e], scale_log2, nlse2[e >> 1]));
          s[n][e] = p * fmaf(dp[n][e], scale, -dls[e >> 1]);  // dS = P o (dP - delta) * scale
        }
      uint32_t dsa[4];
      as_a_fragment(dsa, s[0], s[1]);
      mma_columns<DH>(acc, dsa, kst, j * 16, lane);
    }
  }

  if (!active) return;
  store_tile<DH>(acc, qs + warp * 16 * PITCH, head_base(dq, b, h) + wrow * dq.row_stride,
                 dq.row_stride, wrow, L, lane);
}

template <int DH>
__global__ void __launch_bounds__(kBwdThreads, kBwdBlocksPerSm)
blocked_dkv_tc_kernel(Strided q, Strided k, Strided v, Strided g, Strided dk, Strided dv,
                      const float* __restrict__ lse, const float* __restrict__ delta, int L, int H,
                      int tiles, int causal, float scale, float scale_log2) {
  constexpr int BM = kBwdTile, BN = kBwdTile, PITCH = DH + kTcPad, THREADS = kBwdThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);  // BN x PITCH; later the dk block
  bf16* vs = ks + BN * PITCH;                // BN x PITCH; later the dv block
  bf16* qs = vs + BN * PITCH;                // kBwdStages x BM x PITCH
  bf16* gs = qs + kBwdStages * BM * PITCH;   // kBwdStages x BM x PITCH
  float* lses = reinterpret_cast<float*>(gs + kBwdStages * BM * PITCH);  // kBwdStages x BM
  float* deltas = lses + kBwdStages * BM;                                // kBwdStages x BM

  const int block = blockIdx.x % tiles;  // KV blocks and q tiles are as many
  const int h = (blockIdx.x / tiles) % H;
  const int b = blockIdx.x / (tiles * H);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, t = lane % 4;  // the fragment's row and column pair

  const int kv0 = block * BN;
  const int wkey = kv0 + warp * 16;  // the warp's first key
  const bool active = wkey < L;      // a warp whose keys all lie past L computes nothing
  // under the causal mask the q tiles before the block's own see none of its keys
  const int tile0 = causal ? block : 0;
  const int64_t first = ((int64_t)b * H + h) * L;  // of this head's statistics

  constexpr int PASS = THREADS / (DH / 8);
  const int lr = threadIdx.x / (DH / 8), lc = threadIdx.x % (DH / 8) * 8;
  const bf16* qptr = head_base(q, b, h) + lr * q.row_stride + lc;  // its piece of q tile 0
  const bf16* gptr = head_base(g, b, h) + lr * g.row_stride + lc;
  const int64_t qpass = PASS * q.row_stride, gpass = PASS * g.row_stride;
  const int64_t qtile = BM * q.row_stride, gtile = BM * g.row_stride;
  const uint32_t qdst = smem_u32(qs + lr * PITCH + lc), gdst = smem_u32(gs + lr * PITCH + lc);
  constexpr uint32_t kStageBytes = BM * PITCH * sizeof(bf16);

  auto stage_tile = [&](int tile) {
    const int stage = (tile - tile0) % kBwdStages, row0 = tile * BM;
    stage_rows<DH, BM, THREADS>(qdst + stage * kStageBytes, qptr + tile * qtile, qpass, lr, L - row0);
    stage_rows<DH, BM, THREADS>(gdst + stage * kStageBytes, gptr + tile * gtile, gpass, lr, L - row0);
    if (threadIdx.x < BM) {  // the tile's statistics, 0 in the rows past L
      const int row = row0 + threadIdx.x, live = row < L ? 4 : 0;
      const int64_t at = first + min(row, L - 1);
      cp_async4(smem_u32(lses + stage * BM + threadIdx.x), lse + at, live);
      cp_async4(smem_u32(deltas + stage * BM + threadIdx.x), delta + at, live);
    }
    cp_async_commit();
  };
  stage_rows<DH, BN, THREADS>(smem_u32(ks + lr * PITCH + lc),
                              head_base(k, b, h) + (kv0 + lr) * k.row_stride + lc,
                              PASS * k.row_stride, lr, L - kv0);
  stage_rows<DH, BN, THREADS>(smem_u32(vs + lr * PITCH + lc),
                              head_base(v, b, h) + (kv0 + lr) * v.row_stride + lc,
                              PASS * v.row_stride, lr, L - kv0);
  stage_tile(tile0);

  // dk[j][c] += sum_r dS[r][j] q[r][c], dv[j][c] += sum_r P[r][j] g[r][c]
  uint32_t kf[DH / 16][4], vf[DH / 16][4];
  float acc_k[DH / 8][4], acc_v[DH / 8][4];
#pragma unroll
  for (int i = 0; i < DH / 8; ++i) {
    acc_k[i][0] = acc_k[i][1] = acc_k[i][2] = acc_k[i][3] = 0.f;
    acc_v[i][0] = acc_v[i][1] = acc_v[i][2] = acc_v[i][3] = 0.f;
  }

  for (int tile = tile0; tile < tiles; ++tile) {
    const int row0 = tile * BM;
    cp_async_wait<0>();
    __syncthreads();  // tile `tile` has landed, and every warp is done with the one before it
    if (tile + 1 < tiles) stage_tile(tile + 1);
    if (tile == tile0) {
#pragma unroll
      for (int kq = 0; kq < DH / 16; ++kq) {
        load_a_fragment(kf[kq], ks, PITCH, warp * 16, kq * 16, lane);
        load_a_fragment(vf[kq], vs, PITCH, warp * 16, kq * 16, lane);
      }
    }
    if (!active) continue;
    const int stage = (tile - tile0) % kBwdStages;
    const bf16* qst = qs + stage * BM * PITCH;
    const bf16* gst = gs + stage * BM * PITCH;
    const float* lse_t = lses + stage * BM;
    const float* delta_t = deltas + stage * BM;
    // the tile holds rows past L, or (the block's own tile) rows under the mask
    const bool mask = row0 + BM > L || (causal && tile == block);
#pragma unroll
    for (int j = 0; j < BM / 16; ++j) {
      if (row0 + j * 16 >= L) break;  // the chunks from here on lie past L
      // every row of the chunk lies before the warp's first key: all masked
      if (causal && row0 + j * 16 + 15 < wkey) continue;
      // the transposed tiles: 16 keys x 16 query rows of S^T and dP^T
      float s[2][4], dp[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
        dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
        mma_rows<DH>(s[n], kf, qst, j * 16 + n * 8, lane);
        mma_rows<DH>(dp[n], vf, gst, j * 16 + n * 8, lane);
      }
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        // the statistics of the fragment's two columns: query rows col and col + 1
        const int col = j * 16 + n * 8 + 2 * t;
        const float2 ls = *reinterpret_cast<const float2*>(lse_t + col);
        const float2 ds = *reinterpret_cast<const float2*>(delta_t + col);
        const float nl[2] = {-ls.x * kLog2e, -ls.y * kLog2e};
        const float dls[2] = {ds.x * scale, ds.y * scale};
        if (mask) {  // only in a tile that holds such rows: p is 0 there
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = row0 + col + (e & 1), key = wkey + gid + (e >> 1) * 8;
            if (row >= L || (causal && key > row)) s[n][e] = kNegInf;
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = fast_exp2(fmaf(s[n][e], scale_log2, nl[e & 1]));
          s[n][e] = p;                                            // P^T
          dp[n][e] = p * fmaf(dp[n][e], scale, -dls[e & 1]);      // dS^T = P o (dP - delta) * scale
        }
      }
      uint32_t pa[4], dsa[4];
      as_a_fragment(pa, s[0], s[1]);
      as_a_fragment(dsa, dp[0], dp[1]);
      mma_columns<DH>(acc_v, pa, gst, j * 16, lane);
      mma_columns<DH>(acc_k, dsa, qst, j * 16, lane);
    }
  }

  if (!active) return;
  store_tile<DH>(acc_k, ks + warp * 16 * PITCH, head_base(dk, b, h) + wkey * dk.row_stride,
                 dk.row_stride, wkey, L, lane);
  store_tile<DH>(acc_v, vs + warp * 16 * PITCH, head_base(dv, b, h) + wkey * dv.row_stride,
                 dv.row_stride, wkey, L, lane);
}

// pass: 0 = the dq kernel, 1 = the dkv kernel
size_t tc_bwd_smem_bytes(int dh, int pass) {
  const size_t tiles = sizeof(bf16) * (size_t)(dh + kTcPad) * (2 + 2 * kBwdStages) * kBwdTile;
  return pass == 0 ? tiles : tiles + sizeof(float) * 2 * kBwdStages * kBwdTile;
}

// n tensors from their pointers and n x (batch, head, row) element strides
void gather(Strided* out, void* const* ptrs, const int64_t* strides, int n) {
  for (int i = 0; i < n; ++i)
    out[i] = Strided{ptrs[i], strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
}

// The launch grid: one block per (batch, head, tile), the tiles of a head next
// to each other so that what they stream stays in L2; 0 where it does not fit.
unsigned grid_blocks(int B, int H, int L) {
  const int64_t blocks = (int64_t)((L + kBwdTile - 1) / kBwdTile) * H * B;
  return blocks <= 0 || blocks > 2147483647LL ? 0u : (unsigned)blocks;
}

}  // namespace

extern "C" {

// Shared-memory bytes one block needs (independent of L). pass: 0 = the dq
// kernel, 1 = the dkv kernel.
size_t acl_blocked_bwd_tc_smem_bytes(int dh, int pass) { return tc_bwd_smem_bytes(dh, pass); }

// Blocks of the kernel one SM holds (registers and shared memory); -1 on an
// error or a head dim that is not instantiated.
int acl_blocked_bwd_tc_blocks_per_sm(int dh, int pass) {
  if (dh != 64 || (pass != 0 && pass != 1)) return -1;
  static bool attribute_set[2] = {false, false};
  int blocks = 0;
  cudaError_t err;
  if (pass == 0) {
    err = allow_optin_smem(blocked_dq_tc_kernel<64>, &attribute_set[0]);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, blocked_dq_tc_kernel<64>,
                                                          kBwdThreads, tc_bwd_smem_bytes(64, 0));
  } else {
    err = allow_optin_smem(blocked_dkv_tc_kernel<64>, &attribute_set[1]);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, blocked_dkv_tc_kernel<64>,
                                                          kBwdThreads, tc_bwd_smem_bytes(64, 1));
  }
  return err == cudaSuccess ? blocks : -1;
}

// The dq pass in bf16. ptrs: q, k, v, g, dq, each (B, H, L, dh) through its
// (batch, head, row) element strides in ``strides`` (last stride 1), each
// readable in 16-byte pieces. lse, delta: contiguous (B, H, L) fp32. recompute
// = 0: they are read (lse the forward's log-sum-exp); recompute = 1: they are
// written, for the dkv pass. dh: 64.
int acl_blocked_dq_tc(void* const* ptrs, const int64_t* strides, void* lse, void* delta,
                      int recompute, int B, int H, int L, int dh, int causal, float scale,
                      void* stream) {
  if (dh != 64) return (int)cudaErrorInvalidValue;
  Strided t[5];
  gather(t, ptrs, strides, 5);
  static bool attribute_set = false;
  cudaError_t err = allow_optin_smem(blocked_dq_tc_kernel<64>, &attribute_set);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = grid_blocks(B, H, L);
  if (blocks == 0) return (int)cudaErrorInvalidValue;
  blocked_dq_tc_kernel<64><<<blocks, kBwdThreads, tc_bwd_smem_bytes(64, 0),
                             static_cast<cudaStream_t>(stream)>>>(
      t[0], t[1], t[2], t[3], t[4], static_cast<float*>(lse), static_cast<float*>(delta), recompute,
      L, H, (L + kBwdTile - 1) / kBwdTile, causal, scale, scale * kLog2e);
  return (int)cudaGetLastError();
}

// The dk, dv pass in bf16. ptrs: q, k, v, g, dk, dv, as above; lse and delta are
// read.
int acl_blocked_dkv_tc(void* const* ptrs, const int64_t* strides, const void* lse,
                       const void* delta, int B, int H, int L, int dh, int causal, float scale,
                       void* stream) {
  if (dh != 64) return (int)cudaErrorInvalidValue;
  Strided t[6];
  gather(t, ptrs, strides, 6);
  static bool attribute_set = false;
  cudaError_t err = allow_optin_smem(blocked_dkv_tc_kernel<64>, &attribute_set);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = grid_blocks(B, H, L);
  if (blocks == 0) return (int)cudaErrorInvalidValue;
  blocked_dkv_tc_kernel<64><<<blocks, kBwdThreads, tc_bwd_smem_bytes(64, 1),
                              static_cast<cudaStream_t>(stream)>>>(
      t[0], t[1], t[2], t[3], t[4], t[5], static_cast<const float*>(lse),
      static_cast<const float*>(delta), L, H, (L + kBwdTile - 1) / kBwdTile, causal, scale,
      scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // extern "C"
