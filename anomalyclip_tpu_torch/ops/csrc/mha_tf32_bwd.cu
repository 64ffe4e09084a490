// Tensor-core KV-blocked attention backward for Hopper (sm_90a), fp32 operands,
// head dim 64, with an optional causal mask, its products split-TF32 (3xTF32):
// the fp32 kernels behind every caller of the KV-blocked backward pair.
//
// Two C entries, two kernels, which replace in fp32 at head dim 64 what
// mha_blocked_bwd.cu computes on the CUDA cores (bf16 at head dim 64 goes to
// mha_tc_bwd.cu, the smaller head dims stay on the CUDA cores; the wrapper
// chooses before the launch, ops/attention.py: mha_tf32_eligible):
//
//   acl_blocked_dq_tf32   the dq pass: _flash_dq_kernel
//                         (anomalyclip_tpu/ops/pallas/attention.py:904-940, call
//                         :1021) when the row statistics are given, and the dq
//                         half of _mha_qtile_bwd_kernel (:646-708, call :753)
//                         when it rebuilds them;
//   acl_blocked_dkv_tf32  the dk, dv pass: _flash_dkv_kernel (:943-993, call
//                         :1037) and the dk|dv half of _mha_qtile_bwd_kernel.
//
// The long shapes of _mha_qkv_bwd_kernel (:291), _mha_bld_bwd_kernel (:273) and
// _fused_attention_bwd (:1171) come here too, past the whole-head kernel of
// mha_bwd.cu. Every operand is read in place through (batch, head, row) element
// strides and every gradient written straight into its packed layout, as in the
// other two pairs; each must be readable in 16-byte pieces (base address and
// strides), which the wrapper checks.
//
// What it computes, per (batch, head), is mha_blocked_bwd.cu's function in fp32:
// S = Q K^T * scale, keys past L (and, under the mask, above the diagonal) at
// -1e30; P = exp(S - lse); dP = G V^T; dS = P o (dP - delta) * scale, with
// nothing rounded (fp32 has nothing to round to); dQ = dS K, dK = dS^T Q, dV =
// P^T G. The row statistics are mha_tc_bwd.cu's two:
//
//   given      lse is the forward's, delta = rowsum(g o out): the flash backward
//              (_flash_bwd_impl :1013-1016);
//   recompute  the dq kernel first sweeps the KV blocks with an online max m, sum
//              l and the running sum of exp(S - m) o dP, so that delta =
//              rowsum(P o dP) with P normalised in fp32 (_mha_qtile_bwd_kernel,
//              _mha_bwd_head :244-270), and hands the dkv kernel lse = m + log(l)
//              and delta through device memory.
//
// Products. Each of the five products is formed from the operands' TF32 parts,
// big = tf32(x) and small = tf32(x - big), as small.big + big.small + big.big:
// three mma.sync.aligned.m16n8k8 TF32 products a fragment pair (mha_tf32.cu's
// split; TF32 itself stays off, and no allow_tf32 flag is touched). The plain
// versions it is held against are the fp32 ones (attention_bwd_reference,
// flash_dq_reference, flash_dkv_reference, mha_qtile_bwd_reference); the
// emulation of its arithmetic is blocked_bwd_tf32x3_reference.
//
// What bounds it on the card. The five products are 10 L^2 dh FLOP per (batch,
// head); this design does nine (S and dP are rebuilt by the dkv pass, and once
// more by the statistics sweep), each three times over on the TF32 pipe: the
// bound of an fp32-accurate product is 495 / 3 = 165 TFLOP/s. At (512, 577, 64)
// the dq pass's six L^2 dh are 0.40 ms there and the dkv pass's eight 0.53 ms,
// against 0.05 ms for the bytes; the operations bound it. What the design does
// about that: every product is on the tensor cores, the split is two integer
// operations per rounding (to_tf32), and every tile is split as it is loaded,
// not staged twice.
//
// Design, shared by both kernels with mha_tc_bwd.cu: one block per (batch,
// head, 64-row q tile) for dq and per (batch, head, 64-key KV block) for dk and
// dv, 4 warps each owning 16 rows (or keys) of it; the streamed tiles in two
// stages through 16-byte cp.async; no atomics, every output written once, a
// fixed order of sums, so that two launches give the same bits.
//
// - Fragment roles. The m16n8k8 TF32 A fragment holds columns t and t + 4 of
//   rows g and g + 8, B rows t and t + 4 of column g, the accumulator columns 2t
//   and 2t + 1 (g = lane / 4, t = lane % 4). Two kinds of product follow each
//   other. The first sums over the head dims (S = Q K^T, dP = G V^T in the dq
//   pass; S^T = K Q^T, dP^T = V G^T in the dkv pass): A and B both read rows of
//   staged tiles at dims t and t + 4. The second sums over the keys or the rows
//   (dQ = dS K; dK = dS^T Q, dV = P^T G): its A fragment is the first product's
//   accumulator as it lies, (c0, c2, c1, c3), by relabelling the step's index t
//   as key 2t and t + 4 as key 2t + 1, and its B element is read at rows 2t and
//   2t + 1 of a staged tile, column g. So K (dq pass) and Q and G (dkv pass) are
//   read in both roles. Finding: with 4-byte loads one pitch serves every role.
//   Rows of 64 + 4 floats put row r at bank 4r mod 32, so (row g, dim t) reads
//   hit 4g + t and (row 2t, dim g) reads 8t + g: 32 distinct banks for a warp in
//   each role. The forward's 8-byte loads (mha_tf32.cu) need a pitch of 8 mod 32
//   for the first role and 4 mod 16 for the second, which no one pitch is, so a
//   tile read both ways would need two copies or take two-way conflicts in one
//   role; here it is staged once and read with twice the load instructions.
// - Registers. mha_tc_bwd.cu keeps the resident tile's fragments in registers;
//   as fp32 and split they would take 128 registers beside the accumulators.
//   Here the resident tiles (Q and G in the dq pass, K and V in the dkv pass)
//   stay in shared memory, like the streamed ones, and every operand is split
//   at each use. S and dP are formed 32 keys (or rows) at a time, so that one
//   split of a resident fragment serves four products; that takes the dkv
//   kernel to 255 registers, with no spills.
// - The order of the sums. The tensor cores round their fp32 sums toward zero
//   at the accumulator's magnitude. The cross terms of S and dP sum in
//   accumulators of their own, added once; each KV block's contribution to dq
//   and each q tile's to dk and dv sums in an accumulator of its own, added to
//   the total once in fp32 (dq sums over 10 KV blocks at L=577 and 18 at
//   L=1100, dk and dv over as many q tiles).
// - The exponent is one multiply-add and one ex2.approx: exp2(s c - lse log2(e))
//   with c = scale log2(e), as in mha_tc_bwd.cu.
// - Ragged edges and the mask, as in mha_tc_bwd.cu: rows and keys past L are
//   zero-filled on load; exp(0 - lse) is not 0, so in the dq pass keys past L
//   and in the dkv pass rows past L are masked in the tiles that hold them, P
//   and dS 0 there. Chunks of 32 keys (or rows) wholly past L or wholly under
//   the mask are skipped; a warp whose rows (or keys) all lie past L computes
//   nothing; under the mask the dq pass ends at its tile's diagonal block and
//   the dkv pass starts at its block's own q tile.
// - Shared memory is independent of L: 104,448 B a block of the dq kernel (the
//   q and g tiles, two stages of K and V) and 105,472 B of the dkv kernel (the K
//   and V block, two stages of q, g and their statistics): two blocks an SM,
//   which is what both are compiled for (at most 255 registers a thread).

#include "attention_common.cuh"
#include "tensor_core.cuh"

namespace {

constexpr int kTbWarps = 4;        // warps per block, each owning 16 rows of its tile
constexpr int kTbThreads = kTbWarps * 32;
constexpr int kTbTile = 64;        // q rows per tile and keys per KV block
constexpr int kTbStages = 2;       // streamed tiles in flight
constexpr int kTbPad = 4;          // floats of padding per staged row
constexpr int kTbChunk = 32;       // keys (dq) or rows (dkv) of S and dP formed at once
constexpr int kTbBlocksPerSm = 2;  // what the kernels are compiled for
constexpr float kLn2 = 0.6931471805599453f;
static_assert(kTbTile == 16 * kTbWarps, "a warp owns 16 rows of the tile");
static_assert(kTbTile % kTbChunk == 0 && kTbChunk % 8 == 0, "chunks of whole 8-column tiles");

struct Strided {
  void* ptr;  // element (batch 0, head 0, row 0, column 0); columns are contiguous
  int64_t batch_stride;
  int64_t head_stride;
  int64_t row_stride;
};

__device__ __forceinline__ float* head_base(const Strided& t, int b, int h) {
  return static_cast<float*>(t.ptr) + b * t.batch_stride + h * t.head_stride;
}

// c[n] (16 x 8) = the warp's 16 rows of `rows` (from row0) . x[n0 + 8n .. + 7]^T,
// summed over the DH columns: the first kind of product (S, dP and their
// transposes). Both operands are read at dims t and t + 4 of their rows and
// split as they are loaded; the cross terms sum apart and are added once.
template <int DH, int NT>
__device__ __forceinline__ void dim_products(float (&c)[NT][4], const float* rows, int row0,
                                             const float* x, int n0, int g, int t) {
  constexpr int PITCH = DH + kTbPad;
  float cx[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] = cx[n][e] = 0.f;
  const float* a = rows + (row0 + g) * PITCH + t;
  const float* b = x + (n0 + g) * PITCH + t;
#pragma unroll
  for (int kk = 0; kk < DH / 8; ++kk) {
    uint32_t ab[4], as[4];
    split_tf32(a[kk * 8], ab[0], as[0]);                  // (row g, dim t)
    split_tf32(a[8 * PITCH + kk * 8], ab[1], as[1]);      // (row g + 8, dim t)
    split_tf32(a[kk * 8 + 4], ab[2], as[2]);              // (row g, dim t + 4)
    split_tf32(a[8 * PITCH + kk * 8 + 4], ab[3], as[3]);  // (row g + 8, dim t + 4)
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      uint32_t b0, s0, b1, s1;
      split_tf32(b[n * 8 * PITCH + kk * 8], b0, s0);
      split_tf32(b[n * 8 * PITCH + kk * 8 + 4], b1, s1);
      mma_tf32(cx[n], as, b0, b1);
      mma_tf32(cx[n], ab, s0, s1);
      mma_tf32(c[n], ab, b0, b1);
    }
  }
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] += cx[n][e];
}

// acc[d] (16 x 8, columns 8d .. 8d + 7) += p (16 x 8) . x[k0 .. k0 + 7][...]: the
// second kind of product (dQ, dK, dV), summed over 8 rows of x. p is an
// accumulator of the first kind as it lies: its columns 2t and 2t + 1 are the
// step's logical t and t + 4, so x is read at rows k0 + 2t and k0 + 2t + 1.
template <int DH>
__device__ __forceinline__ void row_products(float (&acc)[DH / 8][4], const float (&p)[4],
                                             const float* x, int k0, int g, int t) {
  constexpr int PITCH = DH + kTbPad;
  uint32_t ab[4], as[4];
  split_tf32(p[0], ab[0], as[0]);  // (row g, key 2t)
  split_tf32(p[2], ab[1], as[1]);  // (row g + 8, key 2t)
  split_tf32(p[1], ab[2], as[2]);  // (row g, key 2t + 1)
  split_tf32(p[3], ab[3], as[3]);  // (row g + 8, key 2t + 1)
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
__device__ __forceinline__ void zero(float (&acc)[DH / 8][4]) {
#pragma unroll
  for (int d = 0; d < DH / 8; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
}

template <int DH>
__device__ __forceinline__ void add_into(float (&acc)[DH / 8][4], const float (&part)[DH / 8][4]) {
#pragma unroll
  for (int d = 0; d < DH / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] += part[d][e];
}

template <int DH>
__global__ void __launch_bounds__(kTbThreads, kTbBlocksPerSm)
blocked_dq_tf32_kernel(Strided q, Strided k, Strided v, Strided g, Strided dq,
                       float* __restrict__ lse, float* __restrict__ delta, int recompute, int L,
                       int H, int tiles, int causal, float scale, float scale_log2) {
  constexpr int BM = kTbTile, BN = kTbTile, PITCH = DH + kTbPad, THREADS = kTbThreads;
  constexpr int NT = kTbChunk / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);  // BM x PITCH
  float* gs = qs + BM * PITCH;                 // BM x PITCH
  float* ks = gs + BM * PITCH;                 // kTbStages x BN x PITCH
  float* vs = ks + kTbStages * BN * PITCH;     // kTbStages x BN x PITCH

  const int tile = blockIdx.x % tiles;
  const int h = (blockIdx.x / tiles) % H;
  const int b = blockIdx.x / (tiles * H);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, t = lane % 4;  // the fragment's row and column pair

  const int q0 = tile * BM;
  const int kv_end = causal ? min(L, q0 + BM) : L;  // the blocks past it are all masked
  const int blocks = (kv_end + BN - 1) / BN;

  // this thread's piece of a staging pass: row lr of the pass, 4 floats at lc
  constexpr int PASS = THREADS / (DH / 4);
  const int lr = threadIdx.x / (DH / 4), lc = threadIdx.x % (DH / 4) * 4;
  const float* kptr = head_base(k, b, h) + lr * k.row_stride + lc;  // its piece of KV block 0
  const float* vptr = head_base(v, b, h) + lr * v.row_stride + lc;
  const int64_t kpass = PASS * k.row_stride, vpass = PASS * v.row_stride;
  const int64_t kblock = BN * k.row_stride, vblock = BN * v.row_stride;
  const uint32_t kdst = smem_u32(ks + lr * PITCH + lc), vdst = smem_u32(vs + lr * PITCH + lc);
  constexpr uint32_t kStageBytes = BN * PITCH * sizeof(float);

  int staged = 0;  // KV blocks staged so far, over both sweeps: the i-th sits in stage i % 2
  auto stage_kv = [&](int blk) {
    const uint32_t stage = staged % kTbStages * kStageBytes;
    stage_rows_f32<DH, BN, THREADS, PITCH>(kdst + stage, kptr + blk * kblock, kpass, lr, L - blk * BN);
    stage_rows_f32<DH, BN, THREADS, PITCH>(vdst + stage, vptr + blk * vblock, vpass, lr, L - blk * BN);
    cp_async_commit();
    ++staged;
  };
  stage_rows_f32<DH, BM, THREADS, PITCH>(smem_u32(qs + lr * PITCH + lc),
                                         head_base(q, b, h) + (q0 + lr) * q.row_stride + lc,
                                         PASS * q.row_stride, lr, L - q0);
  stage_rows_f32<DH, BM, THREADS, PITCH>(smem_u32(gs + lr * PITCH + lc),
                                         head_base(g, b, h) + (q0 + lr) * g.row_stride + lc,
                                         PASS * g.row_stride, lr, L - q0);
  stage_kv(0);

  const int wrow = q0 + warp * 16;  // the warp's first query row
  const bool active = wrow < L;     // a warp whose rows all lie past L computes nothing
  const int64_t first = ((int64_t)b * H + h) * L;  // of this head's statistics
  int done = 0;  // KV blocks consumed so far, over both sweeps
  // block `done` has landed and every warp is done with the one before it; the
  // next one loads under this one's products
  auto next_block = [&](int following) {
    cp_async_wait<0>();
    __syncthreads();
    if (following >= 0) stage_kv(following);
    return (done++) % kTbStages * BN * PITCH;  // the block's offset in ks and vs
  };
  // the chunk of keys from key0 lies wholly past L or wholly above the warp's diagonal
  auto skipped = [&](int key0) { return key0 >= L || (causal && key0 > wrow + 15); };
  // S and dP of the chunk of keys from key0 (j-th of the block at `at`), masked
  auto scores = [&](float (&s)[NT][4], float (&dp)[NT][4], int at, int key0, int j) {
    dim_products<DH, NT>(s, qs, warp * 16, ks + at, j * kTbChunk, gid, t);
    dim_products<DH, NT>(dp, gs, warp * 16, vs + at, j * kTbChunk, gid, t);
    if (key0 + kTbChunk > L || (causal && key0 + kTbChunk - 1 > wrow)) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key0 + n * 8 + 2 * t + (e & 1), row = wrow + gid + (e >> 1) * 8;
          if (key >= L || (causal && key > row)) s[n][e] = kNegInf;
        }
    }
  };

  // rows gid and gid + 8: -lse log2(e), so that p = exp2(s c + nlse2), and delta
  float nlse2[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f};
  if (recompute) {
    // the statistics sweep: online max (in score units), sum and sum of
    // exp(S - m) o dP per row, a chunk at a time
    float m[2] = {kNegInf, kNegInf}, sum[2] = {0.f, 0.f}, dsum[2] = {0.f, 0.f};
    for (int blk = 0; blk < blocks; ++blk) {
      const int at = next_block(blk + 1 < blocks ? blk + 1 : 0);  // then the second sweep's first
      if (!active) continue;
#pragma unroll 1
      for (int j = 0; j < BN / kTbChunk; ++j) {
        const int key0 = blk * BN + j * kTbChunk;
        if (skipped(key0)) break;
        float s[NT][4], dp[NT][4];
        scores(s, dp, at, key0, j);
        float mc[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float top = m[r];
#pragma unroll
          for (int n = 0; n < NT; ++n) top = fmaxf(top, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
          top = fmaxf(top, __shfl_xor_sync(0xffffffffu, top, 1));
          top = fmaxf(top, __shfl_xor_sync(0xffffffffu, top, 2));
          const float alpha = fast_exp2((m[r] - top) * scale_log2);
          m[r] = top;
          mc[r] = top * scale_log2;
          sum[r] *= alpha;
          dsum[r] *= alpha;
        }
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = fast_exp2(fmaf(s[n][e], scale_log2, -mc[e >> 1]));  // 0 at the masked keys
            sum[e >> 1] += p;
            dsum[e >> 1] = fmaf(p, dp[n][e], dsum[e >> 1]);
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

  // the gradient sweep: dq[r][c] += sum_j dS[r][j] K[j][c], each block's share
  // in an accumulator of its own, added to the total once
  const float dls[2] = {dl[0] * scale, dl[1] * scale};
  float acc[DH / 8][4];
  zero<DH>(acc);
  for (int blk = 0; blk < blocks; ++blk) {
    const int at = next_block(blk + 1 < blocks ? blk + 1 : -1);
    if (!active) continue;
    float part[DH / 8][4];
    zero<DH>(part);
#pragma unroll 1
    for (int j = 0; j < BN / kTbChunk; ++j) {
      const int key0 = blk * BN + j * kTbChunk;
      if (skipped(key0)) break;
      float s[NT][4], dp[NT][4];
      scores(s, dp, at, key0, j);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = fast_exp2(fmaf(s[n][e], scale_log2, nlse2[e >> 1]));  // 0 where masked
          s[n][e] = p * fmaf(dp[n][e], scale, -dls[e >> 1]);  // dS = P o (dP - delta) * scale
        }
#pragma unroll
      for (int n = 0; n < NT; ++n) row_products<DH>(part, s[n], ks + at, j * kTbChunk + n * 8, gid, t);
    }
    add_into<DH>(acc, part);
  }

  if (!active) return;
  store_rows<DH>(acc, head_base(dq, b, h) + wrow * dq.row_stride, dq.row_stride, wrow, L, gid, t);
}

template <int DH>
__global__ void __launch_bounds__(kTbThreads, kTbBlocksPerSm)
blocked_dkv_tf32_kernel(Strided q, Strided k, Strided v, Strided g, Strided dk, Strided dv,
                        const float* __restrict__ lse, const float* __restrict__ delta, int L,
                        int H, int tiles, int causal, float scale, float scale_log2) {
  constexpr int BM = kTbTile, BN = kTbTile, PITCH = DH + kTbPad, THREADS = kTbThreads;
  constexpr int NT = kTbChunk / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ks = reinterpret_cast<float*>(smem);          // BN x PITCH
  float* vs = ks + BN * PITCH;                         // BN x PITCH
  float* qs = vs + BN * PITCH;                         // kTbStages x BM x PITCH
  float* gs = qs + kTbStages * BM * PITCH;             // kTbStages x BM x PITCH
  float* lses = gs + kTbStages * BM * PITCH;           // kTbStages x BM
  float* deltas = lses + kTbStages * BM;               // kTbStages x BM

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

  constexpr int PASS = THREADS / (DH / 4);
  const int lr = threadIdx.x / (DH / 4), lc = threadIdx.x % (DH / 4) * 4;
  const float* qptr = head_base(q, b, h) + lr * q.row_stride + lc;  // its piece of q tile 0
  const float* gptr = head_base(g, b, h) + lr * g.row_stride + lc;
  const int64_t qpass = PASS * q.row_stride, gpass = PASS * g.row_stride;
  const int64_t qtile = BM * q.row_stride, gtile = BM * g.row_stride;
  const uint32_t qdst = smem_u32(qs + lr * PITCH + lc), gdst = smem_u32(gs + lr * PITCH + lc);
  constexpr uint32_t kStageBytes = BM * PITCH * sizeof(float);

  auto stage_tile = [&](int tile) {
    const int stage = (tile - tile0) % kTbStages, row0 = tile * BM;
    stage_rows_f32<DH, BM, THREADS, PITCH>(qdst + stage * kStageBytes, qptr + tile * qtile, qpass, lr,
                                           L - row0);
    stage_rows_f32<DH, BM, THREADS, PITCH>(gdst + stage * kStageBytes, gptr + tile * gtile, gpass, lr,
                                           L - row0);
    if (threadIdx.x < BM) {  // the tile's statistics, 0 in the rows past L
      const int row = row0 + threadIdx.x, live = row < L ? 4 : 0;
      const int64_t at = first + min(row, L - 1);
      cp_async4(smem_u32(lses + stage * BM + threadIdx.x), lse + at, live);
      cp_async4(smem_u32(deltas + stage * BM + threadIdx.x), delta + at, live);
    }
    cp_async_commit();
  };
  stage_rows_f32<DH, BN, THREADS, PITCH>(smem_u32(ks + lr * PITCH + lc),
                                         head_base(k, b, h) + (kv0 + lr) * k.row_stride + lc,
                                         PASS * k.row_stride, lr, L - kv0);
  stage_rows_f32<DH, BN, THREADS, PITCH>(smem_u32(vs + lr * PITCH + lc),
                                         head_base(v, b, h) + (kv0 + lr) * v.row_stride + lc,
                                         PASS * v.row_stride, lr, L - kv0);
  stage_tile(tile0);

  // dk[j][c] += sum_r dS[r][j] q[r][c], dv[j][c] += sum_r P[r][j] g[r][c], each
  // q tile's share in accumulators of its own, added to the totals once
  float acc_k[DH / 8][4], acc_v[DH / 8][4];
  zero<DH>(acc_k);
  zero<DH>(acc_v);
  for (int tile = tile0; tile < tiles; ++tile) {
    const int row0 = tile * BM;
    cp_async_wait<0>();
    __syncthreads();  // tile `tile` has landed, and every warp is done with the one before it
    if (tile + 1 < tiles) stage_tile(tile + 1);
    if (!active) continue;
    const int stage = (tile - tile0) % kTbStages;
    const float* qst = qs + stage * BM * PITCH;
    const float* gst = gs + stage * BM * PITCH;
    const float* lse_t = lses + stage * BM;
    const float* delta_t = deltas + stage * BM;
    // the tile holds rows past L, or (the block's own tile) rows under the mask
    const bool mask = row0 + BM > L || (causal && tile == block);
    float part_k[DH / 8][4], part_v[DH / 8][4];
    zero<DH>(part_k);
    zero<DH>(part_v);
#pragma unroll 1
    for (int j = 0; j < BM / kTbChunk; ++j) {
      const int r0 = row0 + j * kTbChunk;
      if (r0 >= L) break;  // the chunks from here on lie past L
      // every row of the chunk lies before the warp's first key: all masked
      if (causal && r0 + kTbChunk - 1 < wkey) continue;
      // the transposed tiles: 16 keys x kTbChunk query rows of S^T and dP^T
      float s[NT][4], dp[NT][4];
      dim_products<DH, NT>(s, ks, warp * 16, qst, j * kTbChunk, gid, t);
      dim_products<DH, NT>(dp, vs, warp * 16, gst, j * kTbChunk, gid, t);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        // the statistics of the fragment's two columns: query rows col and col + 1
        const int col = j * kTbChunk + n * 8 + 2 * t;
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
          s[n][e] = p;                                         // P^T
          dp[n][e] = p * fmaf(dp[n][e], scale, -dls[e & 1]);   // dS^T = P o (dP - delta) * scale
        }
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        row_products<DH>(part_v, s[n], gst, j * kTbChunk + n * 8, gid, t);
        row_products<DH>(part_k, dp[n], qst, j * kTbChunk + n * 8, gid, t);
      }
    }
    add_into<DH>(acc_k, part_k);
    add_into<DH>(acc_v, part_v);
  }

  if (!active) return;
  store_rows<DH>(acc_k, head_base(dk, b, h) + wkey * dk.row_stride, dk.row_stride, wkey, L, gid, t);
  store_rows<DH>(acc_v, head_base(dv, b, h) + wkey * dv.row_stride, dv.row_stride, wkey, L, gid, t);
}

// pass: 0 = the dq kernel, 1 = the dkv kernel
size_t tf32_bwd_smem_bytes(int dh, int pass) {
  const size_t tiles = sizeof(float) * (size_t)(dh + kTbPad) * (2 + 2 * kTbStages) * kTbTile;
  return pass == 0 ? tiles : tiles + sizeof(float) * 2 * kTbStages * kTbTile;
}

// n tensors from their pointers and n x (batch, head, row) element strides
void gather(Strided* out, void* const* ptrs, const int64_t* strides, int n) {
  for (int i = 0; i < n; ++i)
    out[i] = Strided{ptrs[i], strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
}

// The launch grid: one block per (batch, head, tile), the tiles of a head next
// to each other so that what they stream stays in L2; 0 where it does not fit.
unsigned grid_blocks(int B, int H, int L) {
  const int64_t blocks = (int64_t)((L + kTbTile - 1) / kTbTile) * H * B;
  return blocks <= 0 || blocks > 2147483647LL ? 0u : (unsigned)blocks;
}

}  // namespace

extern "C" {

// Shared-memory bytes one block needs (independent of L). pass: 0 = the dq
// kernel, 1 = the dkv kernel.
size_t acl_blocked_bwd_tf32_smem_bytes(int dh, int pass) { return tf32_bwd_smem_bytes(dh, pass); }

// Blocks of the kernel one SM holds (registers and shared memory); -1 on an
// error or a head dim that is not instantiated.
int acl_blocked_bwd_tf32_blocks_per_sm(int dh, int pass) {
  if (dh != 64 || (pass != 0 && pass != 1)) return -1;
  static bool attribute_set[2] = {false, false};
  int blocks = 0;
  cudaError_t err;
  if (pass == 0) {
    err = allow_optin_smem(blocked_dq_tf32_kernel<64>, &attribute_set[0]);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, blocked_dq_tf32_kernel<64>,
                                                          kTbThreads, tf32_bwd_smem_bytes(64, 0));
  } else {
    err = allow_optin_smem(blocked_dkv_tf32_kernel<64>, &attribute_set[1]);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, blocked_dkv_tf32_kernel<64>,
                                                          kTbThreads, tf32_bwd_smem_bytes(64, 1));
  }
  return err == cudaSuccess ? blocks : -1;
}

// The dq pass in fp32. ptrs: q, k, v, g, dq, each (B, H, L, dh) through its
// (batch, head, row) element strides in ``strides`` (last stride 1), each
// readable in 16-byte pieces. lse, delta: contiguous (B, H, L) fp32. recompute
// = 0: they are read (lse the forward's log-sum-exp); recompute = 1: they are
// written, for the dkv pass. dh: 64.
int acl_blocked_dq_tf32(void* const* ptrs, const int64_t* strides, void* lse, void* delta,
                        int recompute, int B, int H, int L, int dh, int causal, float scale,
                        void* stream) {
  if (dh != 64) return (int)cudaErrorInvalidValue;
  Strided t[5];
  gather(t, ptrs, strides, 5);
  static bool attribute_set = false;
  cudaError_t err = allow_optin_smem(blocked_dq_tf32_kernel<64>, &attribute_set);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = grid_blocks(B, H, L);
  if (blocks == 0) return (int)cudaErrorInvalidValue;
  blocked_dq_tf32_kernel<64><<<blocks, kTbThreads, tf32_bwd_smem_bytes(64, 0),
                               static_cast<cudaStream_t>(stream)>>>(
      t[0], t[1], t[2], t[3], t[4], static_cast<float*>(lse), static_cast<float*>(delta), recompute,
      L, H, (L + kTbTile - 1) / kTbTile, causal, scale, scale * kLog2e);
  return (int)cudaGetLastError();
}

// The dk, dv pass in fp32. ptrs: q, k, v, g, dk, dv, as above; lse and delta are
// read.
int acl_blocked_dkv_tf32(void* const* ptrs, const int64_t* strides, const void* lse,
                         const void* delta, int B, int H, int L, int dh, int causal, float scale,
                         void* stream) {
  if (dh != 64) return (int)cudaErrorInvalidValue;
  Strided t[6];
  gather(t, ptrs, strides, 6);
  static bool attribute_set = false;
  cudaError_t err = allow_optin_smem(blocked_dkv_tf32_kernel<64>, &attribute_set);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = grid_blocks(B, H, L);
  if (blocks == 0) return (int)cudaErrorInvalidValue;
  blocked_dkv_tf32_kernel<64><<<blocks, kTbThreads, tf32_bwd_smem_bytes(64, 1),
                                static_cast<cudaStream_t>(stream)>>>(
      t[0], t[1], t[2], t[3], t[4], t[5], static_cast<const float*>(lse),
      static_cast<const float*>(delta), L, H, (L + kTbTile - 1) / kTbTile, causal, scale,
      scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // extern "C"
