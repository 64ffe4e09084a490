// The attention probes for Hopper (sm_90a), fp32 and bf16, head dim 64, forward
// only, on the tensor cores: the counterparts of the kernels that the JAX
// package's measurement scripts launch themselves (scripts/probe_qkv_gb.py:51,
// scripts/probe_qtile_vmem.py:34, scripts/bench_attn_l14.py:83, 150, 179, 201,
// 238, 279). They are instruments, on no model's path: each runs the arithmetic
// of the kernels K1 and K6 launch at head dim 64 (mha_tc.cu in bf16, mha_tf32.cu
// in fp32) with what those kernels fix made free, so that a script can measure
// what a q tile, a grouping, a residency, a pair of heads or the softmax costs
// in the kernels the paths run.
//
// Two kernels, each in bf16 (mma.sync.aligned.m16n8k16 with ldmatrix fragments,
// P rounded to bf16 in registers as the A fragment of P.V, the exponent exp2
// with the scale folded in) and in fp32 (split-TF32 m16n8k8, three products a
// fragment pair, the cross terms in an accumulator of their own): one KV block
// of 64 keys is the body of mha_tc.cu's or mha_tf32.cu's KV loop, operation for
// operation (tensor_core.cuh: attend_block_bf16, attend_block_tf32).
//
//   probe_tile_kernel   one block per (batch entry, head, q tile of `rows`
//                       rows), any rows >= 1. The block's rows are cut into
//                       16-row mma tiles; its WARPS warps (4, 8 or 16) take the
//                       tiles in rounds, warp w tile r WARPS + w in round r.
//                       Rows past the block (the last tile of a block) and past
//                       L (the last block of a head: 577 is prime) are read as
//                       zeros and not written. K and V of the head either
//                       RESIDENT: staged once a block by 16-byte cp.async, L
//                       rounded up to 64 rows (zeros past L), so that a longer q
//                       tile reuses them more (the TPU's q-tile form; its shared
//                       memory grows with L), or streamed: in 64-key blocks
//                       through two cp.async stages, mha_tc.cu's form, again for
//                       each round (shared memory independent of L). The softmax
//                       compiles out (SOFTMAX false: out = ((q k^T) scale, cast to
//                       the operand type) v with fp32 accumulation). Causal is a
//                       runtime flag: a round's KV loop ends at its last row and
//                       a warp skips the blocks wholly above its diagonal. At 64
//                       rows, 4 warps, streamed, it is mha_tc.cu's and
//                       mha_tf32.cu's kernel: the same blocks, warps, fragments
//                       and sums, so the same bits. Entries:
//                         acl_probe_qkv_fwd        packed (B, L, 3D) qkv, optional
//                                                  causal mask (probe_qkv_gb.py:51);
//                         acl_probe_qtile_fwd      q (B, L, D) and a packed k|v
//                                                  (B, L, 2D) (probe_qtile_vmem.py:34,
//                                                  bench_attn_l14.py:83, 201);
//                         acl_probe_bld_fwd        separate q, k, v; at rows = L,
//                                                  "whole" (bench_attn_l14.py:179);
//                         acl_probe_nosoftmax_fwd  the qtile layout without the
//                                                  softmax (bench_attn_l14.py:262-279).
//
//   probe_parts_kernel  the same function with K and V of the block's 1 or 2
//                       neighbouring heads (HPB) staged one KV part of
//                       ceil(L / parts) keys at a time ("twopass",
//                       bench_attn_l14.py:105-150; "pair", :228-238: the pair's
//                       128 contiguous columns of a K or V row staged together,
//                       half the warps on each head). The warps sweep the
//                       resident part in 64-key steps, the last step of each part
//                       short, so bf16 rounds P against the running max of each
//                       step; each row's fp32 max, sum and accumulator carry
//                       across the parts, in registers where each warp keeps one
//                       tile for the whole sweep, in shared memory (36 floats a
//                       lane a tile) where it keeps several. Entry:
//                       acl_mha_parts_fwd.
//
// What the TPU's axes became: the q-tile length lq is the rows per block; the
// batch group gb is the warps per block, each holding one 16-row tile at a time
// (the rows a program holds at once); vmem_limit_bytes is the dynamic shared
// memory a block may ask for, which the caller checks before the launch (a
// configuration past it is the card's form of a VMEM overflow).
//
// Shared memory a block: bf16 keeps each warp's 16 query rows (later its output
// rows) in rows of 72 elements, fp32 reads Q straight into registers; K and V
// rows of 72 bf16 elements, or 72 and 68 floats (136 and 132 for a pair; 136
// elements in bf16). At the shipped tiling that is mha_tc.cu's 46,080 B and
// mha_tf32.cu's 71,680 B; resident at L=577 193,536 B in bf16 and 358,400 B in
// fp32, which does not fit the card's 232,448.
//
// What bounds them is what bounds mha_tc.cu and mha_tf32.cu (their notes): the
// code around the products, not the tensor cores or the memory; a tiling moves
// the share of staging, fragment loads and the exponent path in it.

#include <type_traits>

#include "attention_common.cuh"
#include "tensor_core.cuh"

namespace {

constexpr int kProbeDH = 64;
constexpr int kProbeKV = 64;      // keys per KV block and per step of a sweep
constexpr int kProbeStages = 2;   // streamed KV blocks in flight
constexpr int kStateFloats = kProbeDH / 8 * 4 + 4;  // a lane's accumulator, max and sum of a tile

__host__ __device__ constexpr int round_up(int x, int to) { return (x + to - 1) / to * to; }

template <typename T> constexpr bool kIsBf16 = std::is_same<T, bf16>::value;

// Staged row pitches in elements for rows of WIDTH columns: bf16 K and V rows
// padded by 16 bytes (mha_tc.cu), fp32 K rows by 8 floats and V rows by 4
// (mha_tf32.cu), so that each fragment load meets distinct banks.
template <typename T, int WIDTH> struct Pitch;
template <int WIDTH> struct Pitch<bf16, WIDTH> {
  static constexpr int K = WIDTH + kTcPad, V = WIDTH + kTcPad;
};
template <int WIDTH> struct Pitch<float, WIDTH> {
  static constexpr int K = WIDTH + 8, V = WIDTH + 4;
};

// A warp's Q rows as the products take them: bf16 A fragments, or fp32 rows in
// the split-TF32 A fragment order.
template <typename T> struct QFrag;
template <> struct QFrag<bf16> { uint32_t r[kProbeDH / 16][4]; };
template <> struct QFrag<float> { float r[kProbeDH / 8][4]; };

// Blocks an SM is compiled to hold: 128 registers a thread in bf16 (mha_tc.cu's
// sixteen warps an SM), up to 255 in fp32 (mha_tf32.cu's two blocks of 4 warps).
template <typename T> __host__ __device__ constexpr int min_blocks(int warps) {
  return kIsBf16<T> ? 16 / warps : (warps >= 8 ? 1 : 8 / warps);
}

// bf16: a warp's 16 query rows from src (`valid` of them; zeros after) into its
// staging rows qw by cp.async; the caller commits and waits.
__device__ __forceinline__ void stage_q(bf16* qw, const bf16* src, int64_t row_stride, int valid,
                                        int lane) {
  constexpr int PIECES = kProbeDH / 8, QP = kProbeDH + kTcPad;
  for (int i = lane; i < 16 * PIECES; i += 32) {
    const int r = i / PIECES, c = i % PIECES * 8;
    cp_async16(smem_u32(qw + r * QP + c), src + r * row_stride + c, r < valid ? 16 : 0);
  }
}
__device__ __forceinline__ void stage_q(float*, const float*, int64_t, int, int) {}

// The warp's Q fragments: bf16 by ldmatrix from its staged rows (landed); fp32
// straight from device memory (mha_tf32.cu's load: dims 2t and 2t + 1 of rows g
// and g + 8, zeros past `valid`).
__device__ __forceinline__ void load_q(QFrag<bf16>& qf, const bf16* qw, const bf16*, int64_t, int,
                                       int lane) {
  constexpr int QP = kProbeDH + kTcPad;
#pragma unroll
  for (int kq = 0; kq < kProbeDH / 16; ++kq)
    ldmatrix_x4(qf.r[kq], smem_u32(qw + ((lane / 8 % 2) * 8 + lane % 8) * QP + kq * 16 +
                                   (lane / 16) * 8));
}
__device__ __forceinline__ void load_q(QFrag<float>& qf, const float*, const float* src,
                                       int64_t row_stride, int valid, int lane) {
  const int g = lane / 4, t = lane % 4;
  const float* r0 = src + (int64_t)g * row_stride + 2 * t;
  const float* r1 = r0 + 8 * row_stride;
  const bool in0 = g < valid, in1 = g + 8 < valid;
#pragma unroll
  for (int kk = 0; kk < kProbeDH / 8; ++kk) {
    const float2 x0 = in0 ? *reinterpret_cast<const float2*>(r0 + kk * 8) : make_float2(0.f, 0.f);
    const float2 x1 = in1 ? *reinterpret_cast<const float2*>(r1 + kk * 8) : make_float2(0.f, 0.f);
    qf.r[kk][0] = x0.x;
    qf.r[kk][1] = x1.x;
    qf.r[kk][2] = x0.y;
    qf.r[kk][3] = x1.y;
  }
}

// One KV block for either type: K rows at kst (pitch KP), V rows at vst (VP).
template <int KP, int VP, bool SOFTMAX>
__device__ __forceinline__ void attend(const bf16* kst, const bf16* vst, const QFrag<bf16>& qf,
                                       float (&o)[kProbeDH / 8][4], float (&m)[2], float (&sum)[2],
                                       int kv0, int keys, int wrow, int causal, float scale_log2,
                                       float scale, int lane) {
  static_assert(KP == VP, "bf16 K and V rows share a pitch");
  attend_block_bf16<kProbeDH, KP, SOFTMAX>(kst, vst, qf.r, o, m, sum, kv0, keys, wrow, causal,
                                           scale_log2, scale, lane);
}
template <int KP, int VP, bool SOFTMAX>
__device__ __forceinline__ void attend(const float* kst, const float* vst, const QFrag<float>& qf,
                                       float (&o)[kProbeDH / 8][4], float (&m)[2], float (&sum)[2],
                                       int kv0, int keys, int wrow, int causal, float scale_log2,
                                       float scale, int lane) {
  attend_block_tf32<kProbeDH, KP, VP, SOFTMAX>(kst, vst, qf.r, o, m, sum, kv0, keys, wrow, causal,
                                               scale_log2, scale, lane);
}

// A warp's 16 output rows (`valid` of them) to dst: the row sums across the
// quad and the normalisation with the softmax. bf16 as mha_tc.cu writes them
// (a reciprocal, then through the warp's spent Q rows to 16-byte stores), fp32
// as mha_tf32.cu (a divide an element, one float4 per 16-column group).
template <bool SOFTMAX>
__device__ __forceinline__ void write_rows(float (&o)[kProbeDH / 8][4], float (&sum)[2], bf16* qw,
                                           bf16* dst, int64_t row_stride, int valid, int lane) {
  constexpr int DH = kProbeDH, QP = DH + kTcPad;
  const int g = lane / 4, t = lane % 4;
  float inv[2] = {1.f, 1.f};
  if constexpr (SOFTMAX) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      inv[r] = 1.f / sum[r];
    }
  }
#pragma unroll
  for (int dt = 0; dt < DH / 8; ++dt) {
    if constexpr (SOFTMAX) {
      *reinterpret_cast<__nv_bfloat162*>(qw + g * QP + dt * 8 + 2 * t) =
          __floats2bfloat162_rn(o[dt][0] * inv[0], o[dt][1] * inv[0]);
      *reinterpret_cast<__nv_bfloat162*>(qw + (g + 8) * QP + dt * 8 + 2 * t) =
          __floats2bfloat162_rn(o[dt][2] * inv[1], o[dt][3] * inv[1]);
    } else {
      *reinterpret_cast<__nv_bfloat162*>(qw + g * QP + dt * 8 + 2 * t) =
          __floats2bfloat162_rn(o[dt][0], o[dt][1]);
      *reinterpret_cast<__nv_bfloat162*>(qw + (g + 8) * QP + dt * 8 + 2 * t) =
          __floats2bfloat162_rn(o[dt][2], o[dt][3]);
    }
  }
  __syncwarp();
  for (int i = lane; i < 16 * (DH / 8); i += 32) {
    const int r = i / (DH / 8), c = i % (DH / 8);
    if (r < valid)
      *reinterpret_cast<uint4*>(dst + r * row_stride + c * 8) =
          *reinterpret_cast<const uint4*>(qw + r * QP + c * 8);
  }
  __syncwarp();  // every lane has read its rows before they are staged again
}
template <bool SOFTMAX>
__device__ __forceinline__ void write_rows(float (&o)[kProbeDH / 8][4], float (&sum)[2], float*,
                                           float* dst, int64_t row_stride, int valid, int lane) {
  constexpr int DH = kProbeDH;
  const int g = lane / 4, t = lane % 4;
  if constexpr (SOFTMAX) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (g + 8 * r >= valid) continue;
    float* orow = dst + (int64_t)(g + 8 * r) * row_stride + 4 * t;
#pragma unroll
    for (int dp = 0; dp < DH / 16; ++dp) {
      if constexpr (SOFTMAX)
        *reinterpret_cast<float4*>(orow + dp * 16) =
            make_float4(o[2 * dp][2 * r] / sum[r], o[2 * dp + 1][2 * r] / sum[r],
                        o[2 * dp][2 * r + 1] / sum[r], o[2 * dp + 1][2 * r + 1] / sum[r]);
      else
        *reinterpret_cast<float4*>(orow + dp * 16) =
            make_float4(o[2 * dp][2 * r], o[2 * dp + 1][2 * r], o[2 * dp][2 * r + 1],
                        o[2 * dp + 1][2 * r + 1]);
    }
  }
}

// A thread's share of staging one streamed KV block (tensor_core.cuh's contract).
template <int ROWS, int THREADS, int PITCH>
__device__ __forceinline__ void stage_block(uint32_t dst, const bf16* src, int64_t pass_stride,
                                            int row, int valid) {
  static_assert(PITCH == kProbeDH + kTcPad, "bf16 rows are staged at mha_tc.cu's pitch");
  stage_rows<kProbeDH, ROWS, THREADS>(dst, src, pass_stride, row, valid);
}
template <int ROWS, int THREADS, int PITCH>
__device__ __forceinline__ void stage_block(uint32_t dst, const float* src, int64_t pass_stride,
                                            int row, int valid) {
  stage_rows_f32<kProbeDH, ROWS, THREADS, PITCH>(dst, src, pass_stride, row, valid);
}

__device__ __forceinline__ void clear_state(float (&o)[kProbeDH / 8][4], float (&m)[2], float (&sum)[2]) {
#pragma unroll
  for (int i = 0; i < kProbeDH / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  m[0] = m[1] = kNegInf;
  sum[0] = sum[1] = 0.f;
}

// ---------------------------------------------------------------------------
// probe_tile_kernel
// ---------------------------------------------------------------------------

template <typename T, int WARPS, bool SOFTMAX, bool RESIDENT>
__global__ void __launch_bounds__(WARPS * 32, min_blocks<T>(WARPS))
probe_tile_kernel(Operand q, Operand k, Operand v, void* __restrict__ out_, int L, int H, int rows,
                  int tiles, int causal, float scale, float scale_log2) {
  constexpr int DH = kProbeDH, BN = kProbeKV, THREADS = WARPS * 32;
  constexpr int KP = Pitch<T, DH>::K, VP = Pitch<T, DH>::V;
  constexpr int QROWS = kIsBf16<T> ? WARPS * 16 : 0;  // each warp's q rows, later its output rows
  constexpr int EL = 16 / (int)sizeof(T), PIECES = DH / EL, PASS = THREADS / PIECES;
  extern __shared__ __align__(16) unsigned char smem[];
  const int kv_rows = RESIDENT ? round_up(L, BN) : kProbeStages * BN;
  T* qs = reinterpret_cast<T*>(smem);  // QROWS x KP
  T* ks = qs + QROWS * KP;             // kv_rows x KP
  T* vs = ks + kv_rows * KP;           // kv_rows x VP

  const int tile = blockIdx.x % tiles;
  const int h = (blockIdx.x / tiles) % H;
  const int b = blockIdx.x / (tiles * H);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  const T* qp = static_cast<const T*>(q.ptr) + b * q.batch_stride + h * DH;
  const T* kp = static_cast<const T*>(k.ptr) + b * k.batch_stride + h * DH;
  const T* vp = static_cast<const T*>(v.ptr) + b * v.batch_stride + h * DH;
  T* op = static_cast<T*>(out_) + (int64_t)b * L * H * DH + h * DH;
  const int64_t out_row = (int64_t)H * DH;

  const int r0 = tile * rows, r_end = min(L, r0 + rows);
  const int rounds = ((r_end - r0 + 15) / 16 + WARPS - 1) / WARPS;
  // this thread's piece of a staging pass: row lr of the pass, 16 bytes at lc
  const int lr = threadIdx.x / PIECES, lc = threadIdx.x % PIECES * EL;
  T* qw = qs + warp * 16 * KP;

  if constexpr (RESIDENT) {
    for (int r = lr; r < kv_rows; r += PASS) {
      cp_async16(smem_u32(ks + r * KP + lc), kp + r * k.row_stride + lc, r < L ? 16 : 0);
      cp_async16(smem_u32(vs + r * VP + lc), vp + r * v.row_stride + lc, r < L ? 16 : 0);
    }
    cp_async_commit();
  }

  for (int round = 0; round < rounds; ++round) {
    const int wrow = r0 + (round * WARPS + warp) * 16;  // the warp's first query row
    const int valid = min(16, r_end - wrow);            // its rows in the block
    const bool active = valid > 0;  // a warp past the block's rows computes nothing
    const int last = min(r_end, r0 + (round + 1) * WARPS * 16);  // past the round's last row
    const int kv_end = causal ? min(L, last) : L;
    const int blocks = (kv_end + BN - 1) / BN;

    QFrag<T> qf;
    float o[DH / 8][4], m[2], sum[2];
    clear_state(o, m, sum);
    stage_q(qw, qp + (int64_t)wrow * q.row_stride, q.row_stride, valid, lane);

    if constexpr (RESIDENT) {
      cp_async_commit();
      cp_async_wait<0>();
      if (round == 0) __syncthreads();  // K and V have landed for every warp
      else __syncwarp();                // the warp's own Q rows have
      load_q(qf, qw, qp + (int64_t)wrow * q.row_stride, q.row_stride, valid, lane);
      if (active) {
        for (int blk = 0; blk < blocks; ++blk) {
          const int kv0 = blk * BN;
          if (causal && kv0 > wrow + 15) break;  // the rest lie above the warp's diagonal
          attend<KP, VP, SOFTMAX>(ks + kv0 * KP, vs + kv0 * VP, qf, o, m, sum, kv0, L, wrow, causal,
                                  scale_log2, scale, lane);
        }
      }
    } else {
      const T* kptr = kp + lr * k.row_stride + lc;  // this thread's piece of the block to load next
      const T* vptr = vp + lr * v.row_stride + lc;
      const int64_t kpass = PASS * k.row_stride, vpass = PASS * v.row_stride;
      const int64_t kblock = BN * k.row_stride, vblock = BN * v.row_stride;
      const uint32_t kdst = smem_u32(ks + lr * KP + lc), vdst = smem_u32(vs + lr * VP + lc);
      constexpr uint32_t kStageBytes = BN * KP * sizeof(T), vStageBytes = BN * VP * sizeof(T);
      stage_block<BN, THREADS, KP>(kdst, kptr, kpass, lr, L);
      stage_block<BN, THREADS, VP>(vdst, vptr, vpass, lr, L);
      cp_async_commit();
      if constexpr (!kIsBf16<T>) load_q(qf, qw, qp + (int64_t)wrow * q.row_stride, q.row_stride, valid, lane);
      for (int blk = 0; blk < blocks; ++blk) {
        const int kv0 = blk * BN;
        cp_async_wait<0>();
        __syncthreads();  // block blk has landed, and every warp is done with block blk - 1
        if (blk + 1 < blocks) {
          const int stage = (blk + 1) % kProbeStages;
          kptr += kblock;
          vptr += vblock;
          stage_block<BN, THREADS, KP>(kdst + stage * kStageBytes, kptr, kpass, lr, L - kv0 - BN);
          stage_block<BN, THREADS, VP>(vdst + stage * vStageBytes, vptr, vpass, lr, L - kv0 - BN);
          cp_async_commit();
        }
        if constexpr (kIsBf16<T>)
          if (blk == 0) load_q(qf, qw, nullptr, 0, 0, lane);
        // under the causal mask a block wholly above the warp's diagonal adds nothing
        if (!active || (causal && kv0 > wrow + 15)) continue;
        const int st = blk % kProbeStages;
        attend<KP, VP, SOFTMAX>(ks + st * BN * KP, vs + st * BN * VP, qf, o, m, sum, kv0, L, wrow,
                                causal, scale_log2, scale, lane);
      }
    }

    if (active) write_rows<SOFTMAX>(o, sum, qw, op + (int64_t)wrow * out_row, out_row, valid, lane);
    if constexpr (!RESIDENT)
      if (round + 1 < rounds) __syncthreads();  // the stages are free for the next round
  }
}

size_t tile_smem(int dtype, int L, int resident, int warps) {
  const size_t kv_rows = resident ? (size_t)round_up(L, kProbeKV) : (size_t)kProbeStages * kProbeKV;
  if (dtype == 0)
    return sizeof(float) * kv_rows * (Pitch<float, kProbeDH>::K + Pitch<float, kProbeDH>::V);
  return sizeof(bf16) * ((size_t)warps * 16 + 2 * kv_rows) * Pitch<bf16, kProbeDH>::K;
}

using TileKernel = void (*)(Operand, Operand, Operand, void*, int, int, int, int, int, float, float);
using PartsKernel = void (*)(Operand, Operand, Operand, void*, int, int, int, int, int, float);

template <typename Kernel>
struct Entry {
  Kernel kernel;
  bool optin;  // the opt-in to more than 48 KB of shared memory is set
};

template <typename T, bool SOFTMAX, bool RESIDENT>
Entry<TileKernel>* tile_entry_typed(int warps) {
  static Entry<TileKernel> entries[3] = {
      {probe_tile_kernel<T, 4, SOFTMAX, RESIDENT>, false},
      {probe_tile_kernel<T, 8, SOFTMAX, RESIDENT>, false},
      {probe_tile_kernel<T, 16, SOFTMAX, RESIDENT>, false},
  };
  switch (warps) {
    case 4: return &entries[0];
    case 8: return &entries[1];
    case 16: return &entries[2];
  }
  return nullptr;
}

template <typename T>
Entry<TileKernel>* tile_entry_of(int softmax, int resident, int warps) {
  if (softmax)
    return resident ? tile_entry_typed<T, true, true>(warps) : tile_entry_typed<T, true, false>(warps);
  return resident ? tile_entry_typed<T, false, true>(warps) : tile_entry_typed<T, false, false>(warps);
}

// dtype: 0 = float32, 1 = bfloat16. Null for what is not instantiated.
Entry<TileKernel>* tile_entry(int dtype, int dh, int softmax, int resident, int warps) {
  if (dh != kProbeDH) return nullptr;
  if (dtype == 0) return tile_entry_of<float>(softmax, resident, warps);
  if (dtype == 1) return tile_entry_of<bf16>(softmax, resident, warps);
  return nullptr;
}

cudaError_t launch_tile(int dtype, int resident, int softmax, int rows, int warps, Operand q,
                        Operand k, Operand v, void* out, int B, int L, int H, int dh, int causal,
                        float scale, void* stream) {
  Entry<TileKernel>* entry = tile_entry(dtype, dh, softmax, resident, warps);
  if (entry == nullptr || rows < 1 || L < 1) return cudaErrorInvalidValue;
  cudaError_t err = allow_optin_smem(entry->kernel, &entry->optin);
  if (err != cudaSuccess) return err;
  const int tiles = (L + rows - 1) / rows;
  const int64_t blocks = (int64_t)tiles * H * B;
  if (blocks <= 0 || blocks > 2147483647LL) return cudaErrorInvalidValue;
  const TileKernel kernel = entry->kernel;
  kernel<<<(unsigned)blocks, warps * 32, tile_smem(dtype, L, resident, warps),
           static_cast<cudaStream_t>(stream)>>>(q, k, v, out, L, H, rows, tiles, causal, scale,
                                                scale * kLog2e);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// probe_parts_kernel
// ---------------------------------------------------------------------------

// The tiles one warp keeps at a time: its head's 16-row tiles over its warps.
__host__ __device__ constexpr int tiles_per_warp(int rows, int warps, int hpb) {
  return ((rows + 15) / 16 + warps / hpb - 1) / (warps / hpb);
}

template <typename T, int WARPS, int HPB>
__global__ void __launch_bounds__(WARPS * 32, min_blocks<T>(WARPS))
probe_parts_kernel(Operand q, Operand k, Operand v, void* __restrict__ out_, int L, int H, int rows,
                   int tiles, int part, float scale_log2) {
  constexpr int DH = kProbeDH, BN = kProbeKV, THREADS = WARPS * 32;
  constexpr int WIDTH = HPB * DH;    // columns of the block's heads: contiguous
  constexpr int PER_HEAD = WARPS / HPB;
  constexpr int KP = Pitch<T, WIDTH>::K, VP = Pitch<T, WIDTH>::V, QP = Pitch<T, DH>::K;
  constexpr int QROWS = kIsBf16<T> ? WARPS * 16 : 0;
  constexpr int EL = 16 / (int)sizeof(T), PIECES = WIDTH / EL;
  extern __shared__ __align__(16) unsigned char smem[];
  const int part_rows = round_up(part, BN);
  T* qs = reinterpret_cast<T*>(smem);                            // QROWS x QP
  T* ks = qs + QROWS * QP;                                       // part_rows x KP
  T* vs = ks + part_rows * KP;                                   // part_rows x VP
  float* state = reinterpret_cast<float*>(vs + part_rows * VP);  // tiles kept apart

  const int groups = H / HPB;
  const int tile = blockIdx.x % tiles;
  const int h0 = (blockIdx.x / tiles) % groups * HPB;  // the block's first head
  const int b = blockIdx.x / (tiles * groups);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int hh = warp / PER_HEAD;  // which of the block's heads this warp serves
  const int wl = warp % PER_HEAD;

  const T* kp = static_cast<const T*>(k.ptr) + b * k.batch_stride + h0 * DH;
  const T* vp = static_cast<const T*>(v.ptr) + b * v.batch_stride + h0 * DH;
  const T* qp = static_cast<const T*>(q.ptr) + b * q.batch_stride + (h0 + hh) * DH;
  T* op = static_cast<T*>(out_) + (int64_t)b * L * H * DH + (h0 + hh) * DH;
  const int64_t out_row = (int64_t)H * DH;

  const int r0 = tile * rows, r_end = min(L, r0 + rows);
  const int ntiles = (r_end - r0 + 15) / 16;  // the 16-row tiles of each head
  const int slots = tiles_per_warp(rows, WARPS, HPB);
  const bool kept_apart = slots > 1;  // a warp sweeps several tiles: their state in shared memory
  T* qw = qs + warp * 16 * QP;
  const T* khead = ks + hh * DH;
  const T* vhead = vs + hh * DH;

  QFrag<T> qf;
  float o[DH / 8][4], m[2], sum[2];
  clear_state(o, m, sum);

  for (int kv0 = 0; kv0 < L; kv0 += part) {
    const int nkv = min(part, L - kv0);  // keys past L are never read
    const bool first = kv0 == 0, final = kv0 + part >= L;
    __syncthreads();  // every warp is done with the previous part
    for (int i = threadIdx.x; i < part_rows * PIECES; i += THREADS) {
      const int r = i / PIECES, c = i % PIECES * EL;
      const int bytes = r < nkv ? 16 : 0;
      cp_async16(smem_u32(ks + r * KP + c), kp + (int64_t)(kv0 + r) * k.row_stride + c, bytes);
      cp_async16(smem_u32(vs + r * VP + c), vp + (int64_t)(kv0 + r) * v.row_stride + c, bytes);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    for (int j = 0; j < slots; ++j) {
      const int wt = wl + j * PER_HEAD;
      if (wt >= ntiles) break;
      const int wrow = r0 + wt * 16;
      const int valid = min(16, r_end - wrow);
      const T* qsrc = qp + (int64_t)wrow * q.row_stride;
      if (first || kept_apart) {
        stage_q(qw, qsrc, q.row_stride, valid, lane);
        cp_async_commit();
        cp_async_wait<0>();
        __syncwarp();
        load_q(qf, qw, qsrc, q.row_stride, valid, lane);
      }
      float* st = state + (int64_t)((warp * slots + j) * kStateFloats) * 32 + lane;
      if (kept_apart) {
        if (first) {
          clear_state(o, m, sum);
        } else {
#pragma unroll
          for (int dt = 0; dt < DH / 8; ++dt)
#pragma unroll
            for (int e = 0; e < 4; ++e) o[dt][e] = st[(dt * 4 + e) * 32];
          m[0] = st[(DH / 2) * 32];
          m[1] = st[(DH / 2 + 1) * 32];
          sum[0] = st[(DH / 2 + 2) * 32];
          sum[1] = st[(DH / 2 + 3) * 32];
        }
      }
      for (int s0 = 0; s0 < nkv; s0 += BN)
        attend<KP, VP, true>(khead + s0 * KP, vhead + s0 * VP, qf, o, m, sum, s0, nkv, 0, 0,
                             scale_log2, 0.f, lane);
      if (final) {
        write_rows<true>(o, sum, qw, op + (int64_t)wrow * out_row, out_row, valid, lane);
      } else if (kept_apart) {
#pragma unroll
        for (int dt = 0; dt < DH / 8; ++dt)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[(dt * 4 + e) * 32] = o[dt][e];
        st[(DH / 2) * 32] = m[0];
        st[(DH / 2 + 1) * 32] = m[1];
        st[(DH / 2 + 2) * 32] = sum[0];
        st[(DH / 2 + 3) * 32] = sum[1];
      }
    }
  }
}

size_t parts_smem(int rows, int part, int dh, int dtype, int warps, int hpb) {
  const size_t width = (size_t)hpb * dh, part_rows = (size_t)round_up(part, kProbeKV);
  const int slots = tiles_per_warp(rows, warps, hpb);
  const size_t state = slots > 1 ? sizeof(float) * warps * slots * kStateFloats * 32 : 0;
  if (dtype == 0) return sizeof(float) * part_rows * ((width + 8) + (width + 4)) + state;
  return sizeof(bf16) * ((size_t)warps * 16 * (dh + kTcPad) + 2 * part_rows * (width + kTcPad)) +
         state;
}

template <typename T, int HPB>
Entry<PartsKernel>* parts_entry_typed(int warps) {
  static Entry<PartsKernel> entries[3] = {
      {probe_parts_kernel<T, 4, HPB>, false},
      {probe_parts_kernel<T, 8, HPB>, false},
      {probe_parts_kernel<T, 16, HPB>, false},
  };
  switch (warps) {
    case 4: return &entries[0];
    case 8: return &entries[1];
    case 16: return &entries[2];
  }
  return nullptr;
}

Entry<PartsKernel>* parts_entry(int dtype, int dh, int hpb, int warps) {
  if (dh != kProbeDH || (hpb != 1 && hpb != 2)) return nullptr;
  if (dtype == 0)
    return hpb == 1 ? parts_entry_typed<float, 1>(warps) : parts_entry_typed<float, 2>(warps);
  if (dtype == 1)
    return hpb == 1 ? parts_entry_typed<bf16, 1>(warps) : parts_entry_typed<bf16, 2>(warps);
  return nullptr;
}

template <typename Kernel>
cudaError_t blocks_per_sm(Entry<Kernel>* entry, int warps, size_t smem, int* blocks) {
  if (entry == nullptr) return cudaErrorInvalidValue;
  cudaError_t err = allow_optin_smem(entry->kernel, &entry->optin);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, entry->kernel, warps * 32, smem);
}

}  // namespace

extern "C" {

// Shared-memory bytes one block of probe_tile_kernel needs: bf16 each warp's 16
// query rows, then K and V (resident: L rounded up to 64 rows; streamed: two
// stages of 64), all in rows of 72 elements; fp32 K and V rows of 72 and 68
// floats. 0 for a head dim that is not instantiated.
size_t acl_probe_smem_bytes(int dtype, int L, int dh, int resident, int warps) {
  return dh == kProbeDH ? tile_smem(dtype, L, resident, warps) : 0;
}

// Blocks of probe_tile_kernel that one SM holds at a time, given their shared
// memory; negative: -cudaError.
int acl_probe_blocks_per_sm(int dtype, int dh, int resident, int softmax, int warps,
                            size_t smem_bytes) {
  int blocks = 0;
  cudaError_t err =
      blocks_per_sm(tile_entry(dtype, dh, softmax, resident, warps), warps, smem_bytes, &blocks);
  return err == cudaSuccess ? blocks : -(int)err;
}

// qkv: (B, L, 3D) with element strides (batch_stride, row_stride, 1), 16-byte
// aligned; out: contiguous (B, L, D), D = H * dh.
int acl_probe_qkv_fwd(int dtype, int resident, int rows, int warps, const void* qkv,
                      int64_t batch_stride, int64_t row_stride, void* out, int B, int L, int H,
                      int dh, int causal, float scale, void* stream) {
  const int D = H * dh;
  const size_t esize = dtype == 0 ? 4 : 2;
  const char* base = static_cast<const char*>(qkv);
  Operand q{base, batch_stride, row_stride};
  Operand k{base + esize * D, batch_stride, row_stride};
  Operand v{base + esize * 2 * D, batch_stride, row_stride};
  return (int)launch_tile(dtype, resident, 1, rows, warps, q, k, v, out, B, L, H, dh, causal, scale,
                          stream);
}

// q: (B, L, D) and kv: (B, L, 2D), lane order k|v; out: contiguous (B, L, D).
int acl_probe_qtile_fwd(int dtype, int resident, int rows, int warps, const void* q, int64_t q_bs,
                        int64_t q_rs, const void* kv, int64_t kv_bs, int64_t kv_rs, void* out,
                        int B, int L, int H, int dh, float scale, void* stream) {
  const size_t esize = dtype == 0 ? 4 : 2;
  Operand qo{q, q_bs, q_rs};
  Operand ko{kv, kv_bs, kv_rs};
  Operand vo{static_cast<const char*>(kv) + esize * H * dh, kv_bs, kv_rs};
  return (int)launch_tile(dtype, resident, 1, rows, warps, qo, ko, vo, out, B, L, H, dh, 0, scale,
                          stream);
}

// The same layout with the softmax compiled out: out = ((q k^T) scale, cast to
// the operand type) v.
int acl_probe_nosoftmax_fwd(int dtype, int resident, int rows, int warps, const void* q,
                            int64_t q_bs, int64_t q_rs, const void* kv, int64_t kv_bs,
                            int64_t kv_rs, void* out, int B, int L, int H, int dh, float scale,
                            void* stream) {
  const size_t esize = dtype == 0 ? 4 : 2;
  Operand qo{q, q_bs, q_rs};
  Operand ko{kv, kv_bs, kv_rs};
  Operand vo{static_cast<const char*>(kv) + esize * H * dh, kv_bs, kv_rs};
  return (int)launch_tile(dtype, resident, 0, rows, warps, qo, ko, vo, out, B, L, H, dh, 0, scale,
                          stream);
}

// q, k, v: (B, L, D) each with its own element strides; out: contiguous (B, L, D).
int acl_probe_bld_fwd(int dtype, int resident, int rows, int warps, const void* q, int64_t q_bs,
                      int64_t q_rs, const void* k, int64_t k_bs, int64_t k_rs, const void* v,
                      int64_t v_bs, int64_t v_rs, void* out, int B, int L, int H, int dh,
                      int causal, float scale, void* stream) {
  Operand qo{q, q_bs, q_rs};
  Operand ko{k, k_bs, k_rs};
  Operand vo{v, v_bs, v_rs};
  return (int)launch_tile(dtype, resident, 1, rows, warps, qo, ko, vo, out, B, L, H, dh, causal,
                          scale, stream);
}

// Shared-memory bytes one block of probe_parts_kernel needs: bf16 each warp's 16
// query rows; one KV part of the block's heads, rounded up to 64 rows; and, where
// a warp keeps more than one tile, each tile's fp32 accumulator, max and sum.
size_t acl_parts_smem_bytes(int rows, int part, int dh, int dtype, int warps, int heads_per_block) {
  if (dh != kProbeDH || (heads_per_block != 1 && heads_per_block != 2) || warps < heads_per_block)
    return 0;
  return parts_smem(rows, part, dh, dtype, warps, heads_per_block);
}

int acl_parts_blocks_per_sm(int dtype, int dh, int heads_per_block, int warps, size_t smem_bytes) {
  int blocks = 0;
  cudaError_t err =
      blocks_per_sm(parts_entry(dtype, dh, heads_per_block, warps), warps, smem_bytes, &blocks);
  return err == cudaSuccess ? blocks : -(int)err;
}

// q, k, v: (B, L, D) each with its own element strides (k and v may be the two
// halves of one packed projection), every row 16-byte aligned (the caller checks
// it); out: contiguous (B, L, D). Non-causal.
int acl_mha_parts_fwd(int dtype, int heads_per_block, int rows, int warps, int part,
                      const void* q, int64_t q_bs, int64_t q_rs, const void* k, int64_t k_bs,
                      int64_t k_rs, const void* v, int64_t v_bs, int64_t v_rs, void* out, int B,
                      int L, int H, int dh, float scale, void* stream) {
  Entry<PartsKernel>* entry = parts_entry(dtype, dh, heads_per_block, warps);
  if (entry == nullptr || rows < 1 || part < 1 || L < 1 || H % heads_per_block)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_optin_smem(entry->kernel, &entry->optin);
  if (err != cudaSuccess) return (int)err;
  Operand qo{q, q_bs, q_rs};
  Operand ko{k, k_bs, k_rs};
  Operand vo{v, v_bs, v_rs};
  const int tiles = (L + rows - 1) / rows;
  const int64_t blocks = (int64_t)tiles * (H / heads_per_block) * B;
  if (blocks <= 0 || blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  const PartsKernel kernel = entry->kernel;
  kernel<<<(unsigned)blocks, warps * 32, parts_smem(rows, part, dh, dtype, warps, heads_per_block),
           static_cast<cudaStream_t>(stream)>>>(qo, ko, vo, out, L, H, rows, tiles, part,
                                                scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // extern "C"
