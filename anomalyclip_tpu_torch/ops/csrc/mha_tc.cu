// Tensor-core multi-head attention for Hopper (sm_90a), bf16 operands, head dim
// 64: the bf16 kernel behind fused_mha_qkv, fused_mha_qtile and
// flash_attention_heads.
//
// Three C entries, one kernel in two instantiations (the operands' layout is a
// template parameter, so K1's and K6's code does not carry K8's head strides and
// log-sum-exp):
//
//   acl_mha_qkv_tc_fwd    replaces _mha_qkv_kernel / fused_mha_qkv
//                         (anomalyclip_tpu/ops/pallas/attention.py:423-466): one
//                         packed (B, L, 3D) qkv, lane order q|k|v, optional causal
//                         mask. The CLIP image towers (L=197, 257, 50) and the
//                         causal text towers (L=77) in bf16.
//   acl_mha_qtile_tc_fwd  replaces _mha_qtile_kernel / fused_mha_qtile
//                         (attention.py:525-532, 626): non-causal q (B, L, D)
//                         against a packed k|v (B, L, 2D). The ViT-L/14@336px
//                         tower in bf16 (B=256, L=577, 16 heads).
//   acl_flash_tc_fwd      replaces _flash_kernel / flash_attention_heads
//                         (attention.py:800-854, 885): q, k, v and the output
//                         through (batch, head, row) element strides, the per-row
//                         fp32 log-sum-exp on request, optional causal mask. The
//                         bf16 core rung past L=789 (fused_attention hands it the
//                         (B, H, L, dh) views of the packed qkv as they are and
//                         takes the output in the (B, L, H, dh) layout the out
//                         projection reads), whose K9 and K10 read the lse.
//
// All read the head slices of their operands in place through element strides:
// no split, transpose or copy is made before the launch, and every operand must
// be readable in 16-byte pieces (base address, batch, head and row strides),
// which the wrappers check. fp32 operands and the smaller head dims stay on the
// kernels of mha_tf32.cu, mha.cu and mha_long.cu; the wrappers choose before the
// launch (ops/attention.py: mha_tc_eligible).
//
// What it computes is _attend_head (attention.py:68-85) with the KV-blocked
// arithmetic of _flash_kernel (:800-854): fp32 scores scaled by 1/sqrt(dh),
// causal entries and keys past L at -1e30, per block of 64 keys the running row
// max m, alpha = exp(m_old - m_new) on the accumulator and the row sum, p =
// exp(s - m_new) summed in fp32 and rounded to bf16 before P.V, fp32
// accumulation, one reciprocal at the end; K8's lse = m + log(l) in natural-log
// units of the scaled scores (m is kept in unscaled score units, so the entry
// hands the kernel the scale itself beside scale log2(e)). The plain versions
// beside the wrappers (ops/attention.py: attention_blocked_reference and
// flash_attention_reference at MHA_TC_BLOCK_KV keys) round at the same places.
//
// What bounds it on the card. At (256, 577, 1024), 16 heads, the two products
// are 349 GFLOP against 1.2 GB of operands and output: 0.35 ms at 989 TFLOP/s,
// 0.36 ms at 3.35 TB/s, and every block's K and V come from the L2 cache after
// the head's first q tile. Measured (NVIDIA H100 80GB HBM3, 700 W): 1.65 ms
// there, 212 TFLOP/s, against 1.15 ms for scaled_dot_product_attention and
// 39.9 ms for the CUDA-core kernel; 0.25 ms at (256, 197, 2304), 12 heads. K8
// at (4096, 577, 64) is the same work: 1.64 ms against sdpa's 1.27 and
// mha_long.cu's 31.0 (its instance has 28 B of spills where K1's and K6's has
// 20, and a KV loop two instructions longer). What
// holds it there is neither bound but the code around the products: per 64-key
// block a warp runs 64 HMMA, 32 LDSM (16 KB of shared memory for 16 query
// rows), 34 MUFU.EX2 and some 270 other SASS operations (the KV loop is 504
// operations with the hundred of a ragged block's mask; scripts/bench_mha_tc.py
// --sass prints the mix); with sixteen warps an SM the tensor pipe, the
// shared-memory pipe and the dispatch slots are each between a third and two
// thirds busy, and none saturates. Two 16-row tiles a warp halve
// the LDSM per product but need some 250 registers, so 8 warps an SM: tried,
// faster only at (256, 577, 1024) and slower at every smaller shape, not kept.
// Blocks of 8 warps (q tiles of 128 rows) were measured too: within 2-7% at
// (256, 577, 1024) and 3-40% behind at every other tower's shape (PERF.md), so
// the block is 4 warps and no parameter. The rest is wgmma's (no fragment loads
// at all) and a deeper pipeline's.
//
// Design.
// - Both products are mma.sync.aligned.m16n8k16 (bf16 x bf16 -> fp32) with
//   ldmatrix fragments. mma.sync, not wgmma: a warp owns 16 query rows and needs
//   no shared-memory layout contract beyond padded rows; wgmma's descriptors and
//   128-byte swizzle are the way to the rest of the tensor-core rate, at a much
//   higher price in code, and were left for a kernel that has been measured.
// - P never leaves registers: the fp32 accumulator fragments of Q.K^T for 16 keys
//   are, exponentiated and rounded to bf16, the A fragment of P.V. Row max and
//   row sum are two shuffles among the four lanes that share a row. The
//   exponent is one multiply-add and one ex2 an element, exp2(s c - m c) with
//   c = scale log2(e), and max and sum run in four partial chains a row.
// - K and V come in blocks of 64 keys through 16-byte cp.async into two stages:
//   the next block loads under the current block's products. Rows are padded to
//   dh + 8 elements, so the eight 16-byte rows of an ldmatrix tile fall in eight
//   different bank groups. Shared memory is independent of L: 46,080 B a block,
//   and the kernel is compiled to 128 registers a thread, so four blocks of 4
//   warps share an SM. A thread's
//   copy addresses are computed once, before the loop: a block of K and V costs
//   it eight copies and as many compares (computed per copy, they doubled the
//   loop's length and made the kernel 1.3x slower).
// - A block is one (batch entry, head, q tile of 64 rows), the q tiles of
//   a head next to each other in the grid so that its K and V stay in L2. Rows
//   and keys past L are zero-filled on load and masked; a warp whose 16 rows all
//   lie past L computes nothing; under the causal mask the KV loop ends at the
//   tile's last row and a warp skips the blocks wholly above its diagonal.
// - The output tile goes back through the warp's own (spent) Q rows in shared
//   memory, so it is written in 16-byte rows: K1's and K6's contiguous (B, L, D),
//   K8's through its strides. K8's lse is written by one lane of each row's quad.

#include "attention_common.cuh"
#include "tensor_core.cuh"

namespace {

constexpr int kTcWarps = 4;   // warps per block, each owning 16 query rows
constexpr int kTcKV = 64;     // keys per KV block
constexpr int kTcStages = 2;  // KV blocks in flight

// The operands and the output of K1 and K6: q, k, v (B, L, *) with head h at
// column h * DH of each row, the output contiguous (B, L, H * DH); no lse.
struct Packed {
  Operand q, k, v;
  bf16* out;
};

// The operands and the output of K8: element (b, h, row, 0) of each at ptr + b *
// batch + h * head + row * row, columns contiguous; the (B, H, L) fp32
// log-sum-exp when lse is not null, which takes the scale as it is.
struct Heads {
  const bf16* ptr;
  int64_t batch, head, row;
};
struct Strided {
  Heads q, k, v, out;
  float* lse;
  float scale;
};

// A block's head in each operand, and their row strides.
struct Place {
  const bf16 *q, *k, *v;
  int64_t q_row, k_row, v_row;
};

template <int DH>
__device__ __forceinline__ Place place(const Packed& io, int b, int h) {
  return {static_cast<const bf16*>(io.q.ptr) + b * io.q.batch_stride + h * DH,
          static_cast<const bf16*>(io.k.ptr) + b * io.k.batch_stride + h * DH,
          static_cast<const bf16*>(io.v.ptr) + b * io.v.batch_stride + h * DH,
          io.q.row_stride, io.k.row_stride, io.v.row_stride};
}

template <int DH>
__device__ __forceinline__ Place place(const Strided& io, int b, int h) {
  return {io.q.ptr + b * io.q.batch + h * io.q.head, io.k.ptr + b * io.k.batch + h * io.k.head,
          io.v.ptr + b * io.v.batch + h * io.v.head, io.q.row, io.k.row, io.v.row};
}

// A block's head in the output and its row stride, asked for where the tile
// is written, after the KV loop.
template <int DH>
__device__ __forceinline__ bf16* out_head(const Packed& io, int b, int h, int L, int H,
                                          int64_t& row) {
  row = (int64_t)H * DH;
  return io.out + (int64_t)b * L * H * DH + h * DH;
}

template <int DH>
__device__ __forceinline__ bf16* out_head(const Strided& io, int b, int h, int, int, int64_t& row) {
  row = io.out.row;
  return const_cast<bf16*>(io.out.ptr) + b * io.out.batch + h * io.out.head;
}

// Row `row`'s log-sum-exp from its running max m (score units) and sum: K8 only.
__device__ __forceinline__ void write_lse(const Packed&, int, int, int, int, int, float, float) {}
__device__ __forceinline__ void write_lse(const Strided& io, int b, int h, int H, int L, int row,
                                          float m, float sum) {
  if (io.lse != nullptr) io.lse[((int64_t)b * H + h) * L + row] = m * io.scale + logf(sum);
}

// One block: kTcWarps warps, each owning one tile of 16 query rows; compiled to
// 128 registers a thread, so that sixteen warps share an SM. IO: Packed (K1, K6)
// or Strided (K8).
template <int DH, typename IO>
__global__ void __launch_bounds__(kTcWarps * 32, 16 / kTcWarps)
mha_tc_kernel(IO io, int L, int H, int tiles, int causal, float scale_log2) {
  constexpr int BM = 16 * kTcWarps, BN = kTcKV, PITCH = DH + kTcPad, THREADS = kTcWarps * 32;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);  // BM x PITCH; later the output tile
  bf16* ks = qs + BM * PITCH;                // kTcStages x BN x PITCH
  bf16* vs = ks + kTcStages * BN * PITCH;    // kTcStages x BN x PITCH

  const int tile = blockIdx.x % tiles;
  const int h = (blockIdx.x / tiles) % H;
  const int b = blockIdx.x / (tiles * H);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // the fragment's row and column pair

  const Place at = place<DH>(io, b, h);

  const int q0 = tile * BM;
  const int kv_end = causal ? min(L, q0 + BM) : L;
  const int blocks = (kv_end + BN - 1) / BN;

  // this thread's piece of a staging pass: row lr of the pass, 8 elements at lc
  constexpr int PASS = THREADS / (DH / 8);
  const int lr = threadIdx.x / (DH / 8), lc = threadIdx.x % (DH / 8) * 8;
  const bf16* kptr = at.k + lr * at.k_row + lc;  // its piece of the KV block to load next
  const bf16* vptr = at.v + lr * at.v_row + lc;
  const int64_t kpass = PASS * at.k_row, vpass = PASS * at.v_row;
  const int64_t kblock = BN * at.k_row, vblock = BN * at.v_row;
  const uint32_t kdst = smem_u32(ks + lr * PITCH + lc), vdst = smem_u32(vs + lr * PITCH + lc);
  constexpr uint32_t kStageBytes = BN * PITCH * sizeof(bf16);

  stage_rows<DH, BM, THREADS>(smem_u32(qs + lr * PITCH + lc), at.q + (q0 + lr) * at.q_row + lc,
                              PASS * at.q_row, lr, L - q0);
  stage_rows<DH, BN, THREADS>(kdst, kptr, kpass, lr, L);
  stage_rows<DH, BN, THREADS>(vdst, vptr, vpass, lr, L);
  cp_async_commit();

  const int wrow = q0 + warp * 16;  // the warp's first query row
  const bool active = wrow < L;     // a warp whose rows all lie past L computes nothing
  uint32_t qf[DH / 16][4];
  float o[DH / 8][4];
#pragma unroll
  for (int i = 0; i < DH / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, sum[2] = {0.f, 0.f};  // rows g and g + 8; m in score units

  for (int blk = 0; blk < blocks; ++blk) {
    const int kv0 = blk * BN;
    cp_async_wait<0>();
    __syncthreads();  // block blk has landed, and every warp is done with block blk - 1
    if (blk + 1 < blocks) {
      const uint32_t stage = (blk + 1) % kTcStages * kStageBytes;
      kptr += kblock;
      vptr += vblock;
      stage_rows<DH, BN, THREADS>(kdst + stage, kptr, kpass, lr, L - kv0 - BN);
      stage_rows<DH, BN, THREADS>(vdst + stage, vptr, vpass, lr, L - kv0 - BN);
      cp_async_commit();
    }
    if (blk == 0) {
#pragma unroll
      for (int kq = 0; kq < DH / 16; ++kq)
        ldmatrix_x4(qf[kq], smem_u32(qs + (warp * 16 + (lane / 8 % 2) * 8 + lane % 8) * PITCH +
                                     kq * 16 + (lane / 16) * 8));
    }
    // under the causal mask a block wholly above the warp's diagonal adds nothing
    if (!active || (causal && kv0 > wrow + 15)) continue;

    const bf16* kst = ks + (blk % kTcStages) * BN * PITCH;
    const bf16* vst = vs + (blk % kTcStages) * BN * PITCH;

    // S = Q K^T: 16 rows x 64 keys, eight n-tiles of 8 keys
    float s[BN / 8][4];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DH / 32; ++kk) {
        uint32_t kb[4];
        ldmatrix_x4(kb, smem_u32(kst + (nt * 8 + lane % 8) * PITCH + kk * 32 + (lane / 8) * 8));
        mma_bf16(s[nt], qf[2 * kk], kb[0], kb[1]);
        mma_bf16(s[nt], qf[2 * kk + 1], kb[2], kb[3]);
      }
    }

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
    // p = exp2(s c - m c), c = scale log2(e): one multiply-add and one exponent
    // an element; four partial sums a row
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
#pragma unroll
    for (int dt = 0; dt < DH / 8; ++dt) {
      o[dt][0] *= alpha[0];
      o[dt][1] *= alpha[0];
      o[dt][2] *= alpha[1];
      o[dt][3] *= alpha[1];
    }

    // O += P V, P rounded to bf16 straight from the score fragments
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) {
      const uint32_t pa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]), pack_bf16(s[2 * j][2], s[2 * j][3]),
                              pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                              pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
      for (int dp = 0; dp < DH / 16; ++dp) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, smem_u32(vst + (j * 16 + (lane / 8 % 2) * 8 + lane % 8) * PITCH +
                                       dp * 16 + (lane / 16) * 8));
        mma_bf16(o[2 * dp], pa, vb[0], vb[1]);
        mma_bf16(o[2 * dp + 1], pa, vb[2], vb[3]);
      }
    }
  }

  if (!active) return;
  // the reciprocal of the row sum (and K8's lse), then the tile through the
  // warp's own (spent) Q rows to 16-byte stores
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
    inv[r] = 1.f / sum[r];
    const int row = wrow + g + 8 * r;
    if (t == 0 && row < L) write_lse(io, b, h, H, L, row, m[r], sum[r]);
  }
  bf16* tile_out = qs + warp * 16 * PITCH;
#pragma unroll
  for (int dt = 0; dt < DH / 8; ++dt) {
    *reinterpret_cast<__nv_bfloat162*>(tile_out + g * PITCH + dt * 8 + 2 * t) =
        __floats2bfloat162_rn(o[dt][0] * inv[0], o[dt][1] * inv[0]);
    *reinterpret_cast<__nv_bfloat162*>(tile_out + (g + 8) * PITCH + dt * 8 + 2 * t) =
        __floats2bfloat162_rn(o[dt][2] * inv[1], o[dt][3] * inv[1]);
  }
  __syncwarp();
  int64_t out_row;
  bf16* op = out_head<DH>(io, b, h, L, H, out_row);
  for (int i = lane; i < 16 * (DH / 8); i += 32) {
    const int r = i / (DH / 8), c = i % (DH / 8);
    if (wrow + r < L)
      *reinterpret_cast<uint4*>(op + (wrow + r) * out_row + c * 8) =
          *reinterpret_cast<const uint4*>(tile_out + r * PITCH + c * 8);
  }
}

size_t tc_smem_bytes(int dh) {
  return sizeof(bf16) * (size_t)(dh + kTcPad) * (16 * kTcWarps + 2 * kTcStages * kTcKV);
}

// dh: 64. IO: Packed or Strided; each instantiation opts in to its shared
// memory once.
template <typename IO>
cudaError_t launch(const IO& io, int B, int L, int H, int dh, int causal, float scale,
                   cudaStream_t stream) {
  if (dh != 64) return cudaErrorInvalidValue;
  static bool attribute_set = false;
  cudaError_t err = allow_optin_smem(mha_tc_kernel<64, IO>, &attribute_set);
  if (err != cudaSuccess) return err;
  const int tiles = (L + 16 * kTcWarps - 1) / (16 * kTcWarps);
  const int64_t blocks = (int64_t)tiles * H * B;
  if (blocks <= 0 || blocks > 2147483647LL) return cudaErrorInvalidValue;
  mha_tc_kernel<64, IO><<<(unsigned)blocks, kTcWarps * 32, tc_smem_bytes(64), stream>>>(
      io, L, H, tiles, causal, scale * kLog2e);
  return cudaGetLastError();
}

template <typename IO>
int blocks_per_sm() {
  static bool attribute_set = false;
  if (allow_optin_smem(mha_tc_kernel<64, IO>, &attribute_set) != cudaSuccess) return -1;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, mha_tc_kernel<64, IO>, kTcWarps * 32,
                                                    tc_smem_bytes(64)) != cudaSuccess)
    return -1;
  return blocks;
}

}  // namespace

extern "C" {

// Shared-memory bytes one block needs: independent of L.
size_t acl_mha_tc_smem_bytes(int dh) { return tc_smem_bytes(dh); }

// Blocks of the kernel one SM holds (registers and shared memory): the
// instantiation of K1 and K6 (strided 0) or of K8 (strided 1); -1 on an error or
// a head dim that is not instantiated.
int acl_mha_tc_blocks_per_sm(int dh, int strided) {
  if (dh != 64) return -1;
  return strided ? blocks_per_sm<Strided>() : blocks_per_sm<Packed>();
}

// K1 in bf16. qkv: (B, L, 3D) bf16 with element strides (batch_stride,
// row_stride, 1), 16-byte aligned; out: contiguous (B, L, D), D = H * dh.
int acl_mha_qkv_tc_fwd(const void* qkv, int64_t batch_stride, int64_t row_stride, void* out,
                       int B, int L, int H, int dh, int causal, float scale, void* stream) {
  const bf16* base = static_cast<const bf16*>(qkv);
  const int D = H * dh;
  const Packed io{{base, batch_stride, row_stride}, {base + D, batch_stride, row_stride},
                  {base + 2 * D, batch_stride, row_stride}, static_cast<bf16*>(out)};
  return (int)launch(io, B, L, H, dh, causal, scale, static_cast<cudaStream_t>(stream));
}

// K6 in bf16. q: (B, L, D) and kv: (B, L, 2D), lane order k|v, each with element
// strides (batch_stride, row_stride, 1), 16-byte aligned; out: contiguous
// (B, L, D). Non-causal.
int acl_mha_qtile_tc_fwd(const void* q, int64_t q_bs, int64_t q_rs, const void* kv, int64_t kv_bs,
                         int64_t kv_rs, void* out, int B, int L, int H, int dh, float scale,
                         void* stream) {
  const Packed io{{q, q_bs, q_rs}, {kv, kv_bs, kv_rs},
                  {static_cast<const bf16*>(kv) + H * dh, kv_bs, kv_rs}, static_cast<bf16*>(out)};
  return (int)launch(io, B, L, H, dh, /*causal=*/0, scale, static_cast<cudaStream_t>(stream));
}

// K8 in bf16. ptrs: q, k, v, out, each (B, H, L, dh) with its (batch, head, row)
// element strides in strides[3 i .. 3 i + 2], 16-byte aligned (per-head (N, L,
// dh) tensors are B = N, H = 1); lse: contiguous (B, H, L) fp32, or null.
int acl_flash_tc_fwd(const void* const* ptrs, const int64_t* strides, void* lse, int B, int H,
                     int L, int dh, int causal, float scale, void* stream) {
  Heads t[4];
  for (int i = 0; i < 4; ++i)
    t[i] = Heads{static_cast<const bf16*>(ptrs[i]), strides[3 * i], strides[3 * i + 1],
                 strides[3 * i + 2]};
  const Strided io{t[0], t[1], t[2], t[3], static_cast<float*>(lse), scale};
  return (int)launch(io, B, L, H, dh, causal, scale, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
