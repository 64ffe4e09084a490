// KV-blocked attention backward for Hopper (sm_90a) on the CUDA cores, fp32 and
// bf16, with an optional causal mask.
//
// Two C entries, two kernels, which together replace three TPU kernels of
// anomalyclip_tpu/ops/pallas/attention.py and widen two ported ones:
//
//   acl_blocked_dq   the dq pass: _flash_dq_kernel (:904-940, call :1021) when the
//                    row statistics are given, and the dq half of
//                    _mha_qtile_bwd_kernel (:646-708, call :753) when it rebuilds
//                    them itself;
//   acl_blocked_dkv  the dk, dv pass: _flash_dkv_kernel (:943-993, call :1037) and
//                    the dk|dv half of _mha_qtile_bwd_kernel.
//
// The whole-head backward of mha_bwd.cu holds L x L tiles of P and dS in shared
// memory and stops near L=117 at dh 64; the entries that own it (the packed qkv
// backward, the (B, L, D) backward, fused_attention's backward) send longer
// shapes here with their own strides, as the TPU package's whole-block backward
// takes L=197.
//
// Every operand is read in place through (batch, head, row) element strides, so
// one pair of kernels serves q (B, L, D) with a packed k|v (B, L, 2D), a packed
// q|k|v (B, L, 3D), separate (B, L, D) tensors, per-head (N, L, dh) and
// (B, H, L, Dh) views, and the gradients are written straight into their packed
// layouts: no split, transpose or copy on either side of the launch.
//
// What it computes, per (batch, head): S = Q K^T * scale, keys past L (and, under
// the causal mask, above the diagonal) at -1e30, so that P and dS are 0 there;
// P = exp(S - m) / l; dP = G V^T; dS = P o (dP - delta) * scale rounded to the
// operand type; dQ = dS K, dK = dS^T Q, dV = round(P)^T G, every product summed in
// fp32 and stored in the operand type. The row statistics (m, l, delta) arrive in
// one of two ways, which is where the two TPU backwards differ in bf16:
//
//   given      m is the forward's log-sum-exp, l is 1, delta = rowsum(g o out) from
//              the rounded output: the flash backward (_flash_bwd_impl :1013-1016);
//   recompute  the dq kernel first sweeps the KV blocks with an online max and sum
//              and the running sum of exp(S - m) o dP, so that m is the row max, l
//              the row sum and delta = rowsum(P o dP) with P normalised in fp32,
//              as _mha_qtile_bwd_kernel and _mha_bwd_head (:244-270) have them; it
//              writes the three to device memory for the dkv kernel that follows
//              it on the stream.
//
// Design. The TPU's q-tiled backward keeps the whole k|v block, the dk|dv block
// and an fp32 accumulator of the same size resident while it sweeps the q tiles
// in grid order; per head at L=577 that is 440 KB, and blocks on this card run in
// no order. So both TPU designs become the same two passes here, each writing
// its outputs once, with no atomics and a fixed summation order:
//
//   dq   one block per (batch, head, 64-row q tile): q and g rows staged once as
//        fp32, the KV blocks of 64 keys streamed through shared memory, dq in
//        registers (a thread owns one column of 8 rows at dh 32);
//   dkv  one block per (batch, head, 64-key KV block): K and V staged once, the
//        q/g tiles and their row statistics streamed, dk and dv in registers (a
//        thread owns one column of 8 keys at dh 32). Rows past L in the last q
//        tile are staged as zeros and their P and dS forced to 0.
//
// Under the causal mask the dq pass stops at the KV block of its tile's last row
// and the dkv pass starts at the q tile of its block's first key: q tiles and KV
// blocks are both 64 wide and aligned, so every row of a visited tile sees the
// first key of every visited block, and the online max of the statistics sweep
// never meets a block it is wholly masked out of.
//
// Both build the 64 x 64 tile of P and dS the same way (score_tile): a lane owns
// one key, holds its K row (then its V row) in registers, and walks 16 query rows
// reading q (then g) as 16-byte broadcasts, four multiply-adds per shared-memory
// load; the tile goes to shared memory, and the second-stage products read it
// back as 16-byte broadcasts against one staged operand per four multiply-adds.
//
// What bounds it: the five products are 10 * L^2 * dh FLOP per (batch, head), done
// on the fp32 CUDA cores; this design does nine (S and dP are rebuilt by the dkv
// pass, and once more by the statistics sweep), and shared-memory bandwidth, not
// device memory, is the limit: device memory sees K and V once per q tile and q, g
// once per KV block (10 times each at L=577). This pair serves fp32 and bf16 at
// head dims 8, 16 and 32. At head dim 64 the wrappers launch a tensor-core pair
// instead, which computes the same function with the same two passes: in bf16
// that of mha_tc_bwd.cu, in fp32 that of mha_tf32_bwd.cu, whose split-TF32
// products keep fp32 accuracy (TF32 itself stays off). Sharing S and dP between
// the passes is later work.

#include "attention_common.cuh"

namespace {

constexpr int kBwdKV = 64;                                    // keys per KV block
constexpr int kTileWarpRows = kRowsPerBlock / (kWarps / 2);   // 16 rows per warp in score_tile
constexpr int kNoDiag = 1 << 30;                              // score_tile's diag without a mask
static_assert(kBwdKV == kRowsPerBlock, "the causal block ranges take q tiles and KV blocks aligned");

struct Strided {
  void* ptr;  // element (batch 0, head 0, row 0, column 0); columns are contiguous
  int64_t batch_stride;
  int64_t head_stride;
  int64_t row_stride;
};

template <typename T>
__device__ __forceinline__ T* head_base(const Strided& t, int b, int h) {
  return static_cast<T*>(t.ptr) + b * t.batch_stride + h * t.head_stride;
}

// Shared memory of either kernel: fp32 q and g rows, the P (or score) and dS (or
// dP) tiles, the tile's row statistics, then one KV block in the operand type,
// both K and V padded (both are read one row per lane).
template <typename T, int DH>
struct Smem {
  static constexpr int KP = padded<T>(DH);
  float* qs;      // kRowsPerBlock x DH
  float* gs;      // kRowsPerBlock x DH
  float* ps;      // kRowsPerBlock x kBwdKV
  float* dss;     // kRowsPerBlock x kBwdKV
  float* ms;      // kRowsPerBlock
  float* ls;      // kRowsPerBlock
  float* deltas;  // kRowsPerBlock
  T* ks;          // kBwdKV x KP
  T* vs;          // kBwdKV x KP
  __device__ explicit Smem(unsigned char* base) {
    qs = reinterpret_cast<float*>(base);
    gs = qs + kRowsPerBlock * DH;
    ps = gs + kRowsPerBlock * DH;
    dss = ps + kRowsPerBlock * kBwdKV;
    ms = dss + kRowsPerBlock * kBwdKV;
    ls = ms + kRowsPerBlock;
    deltas = ls + kRowsPerBlock;
    ks = reinterpret_cast<T*>(deltas + kRowsPerBlock);
    vs = ks + kBwdKV * KP;
  }
};

template <typename T>
size_t smem_bytes(int dh) {
  return sizeof(float) * (2 * (size_t)kRowsPerBlock * dh + 2 * (size_t)kRowsPerBlock * kBwdKV +
                          3 * (size_t)kRowsPerBlock) +
         sizeof(T) * 2 * (size_t)kBwdKV * padded<T>(dh);
}

// One KV block into shared memory, rows past L as zeros.
template <typename T, int DH>
__device__ __forceinline__ void stage_kv(const Smem<T, DH>& sm, const T* kp, int64_t k_rs,
                                         const T* vp, int64_t v_rs, int kv0, int nkv) {
  constexpr int KP = Smem<T, DH>::KP;
  for (int i = threadIdx.x; i < kBwdKV * DH; i += kThreads) {
    const int r = i / DH, c = i % DH;
    const bool live = r < nkv;
    sm.ks[r * KP + c] = live ? kp[(kv0 + r) * k_rs + c] : from_float<T>(0.f);
    sm.vs[r * KP + c] = live ? vp[(kv0 + r) * v_rs + c] : from_float<T>(0.f);
  }
}

// One tile of q and g rows into shared memory as fp32, rows past L as zeros.
template <typename T, int DH>
__device__ __forceinline__ void stage_qg(const Smem<T, DH>& sm, const T* qp, int64_t q_rs,
                                         const T* gp, int64_t g_rs, int row0, int rows) {
  for (int i = threadIdx.x; i < kRowsPerBlock * DH; i += kThreads) {
    const int r = i / DH, c = i % DH;
    const bool live = r < rows;
    sm.qs[i] = live ? to_float(qp[(row0 + r) * q_rs + c]) : 0.f;
    sm.gs[i] = live ? to_float(gp[(row0 + r) * g_rs + c]) : 0.f;
  }
}

// The tile's row statistics from device memory; l == nullptr means l = 1.
template <typename T, int DH>
__device__ __forceinline__ void stage_stats(const Smem<T, DH>& sm, const float* m, const float* l,
                                            const float* delta, int64_t first, int rows) {
  for (int i = threadIdx.x; i < kRowsPerBlock; i += kThreads) {
    const bool live = i < rows;
    sm.ms[i] = live ? m[first + i] : 0.f;
    sm.ls[i] = live && l != nullptr ? l[first + i] : 1.f;
    sm.deltas[i] = live ? delta[first + i] : 0.f;
  }
}

template <typename T, int DH>
__device__ __forceinline__ void load_row(float* reg, const T* row) {
#pragma unroll
  for (int c = 0; c < DH; c += 2) {
    const float2 x = load2(row + c);
    reg[c] = x.x;
    reg[c + 1] = x.y;
  }
}

// A row of fp32 in shared memory, the same for every lane (16-byte broadcasts),
// against a row held in registers.
template <int DH>
__device__ __forceinline__ float dot_bcast(const float* row, const float* reg) {
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < DH; c += 4) {
    const float4 x = *reinterpret_cast<const float4*>(row + c);
    s = fmaf(x.x, reg[c], s);
    s = fmaf(x.y, reg[c + 1], s);
    s = fmaf(x.z, reg[c + 2], s);
    s = fmaf(x.w, reg[c + 3], s);
  }
  return s;
}

// The 64 x 64 tile of the staged q/g rows against the staged KV block. Warp w
// owns keys (w & 1) * 32 + lane and rows (w >> 1) * 16 .. + 15.
//   RAW:  ps = scaled scores with the keys past L at -1e30, dss = dP;
//   else: ps = P rounded to the operand type, dss = dS rounded to the operand
//         type, both 0 in the rows past L and at the keys past L.
// ``diag``: the tile's first row minus the block's first key under the causal
// mask (key j is masked for row r where j > r + diag), else a value no key
// exceeds.
template <typename T, int DH, bool RAW>
__device__ __forceinline__ void score_tile(const Smem<T, DH>& sm, int rows, int nkv, int diag,
                                           float scale) {
  constexpr int KP = Smem<T, DH>::KP;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int j = (warp & 1) * 32 + lane;
  const int r0 = (warp >> 1) * kTileWarpRows;
  const bool key_live = j < nkv;
  float reg[DH];
  float s[kTileWarpRows];
  load_row<T, DH>(reg, sm.ks + j * KP);
#pragma unroll
  for (int e = 0; e < kTileWarpRows; ++e) s[e] = dot_bcast<DH>(sm.qs + (r0 + e) * DH, reg) * scale;
  load_row<T, DH>(reg, sm.vs + j * KP);
#pragma unroll
  for (int e = 0; e < kTileWarpRows; ++e) {
    const int r = r0 + e;
    const float dp = dot_bcast<DH>(sm.gs + r * DH, reg);
    const bool seen = key_live && j <= r + diag;
    if (RAW) {
      sm.ps[r * kBwdKV + j] = seen ? s[e] : kNegInf;
      sm.dss[r * kBwdKV + j] = dp;
    } else {
      const float p = (seen && r < rows) ? expf(s[e] - sm.ms[r]) / sm.ls[r] : 0.f;
      sm.ps[r * kBwdKV + j] = round_like(p, T());
      sm.dss[r * kBwdKV + j] = round_like(p * (dp - sm.deltas[r]) * scale, T());
    }
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads, 2)
blocked_dq_kernel(Strided q, Strided k, Strided v, Strided g, Strided dq, float* m, float* l,
                  float* delta, int recompute, int L, int H, int causal, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem<T, DH> sm(smem);
  constexpr int KP = Smem<T, DH>::KP;
  constexpr int RPT = kRowsPerBlock * DH / kThreads;  // rows a thread owns, at one column

  const int b = blockIdx.x;  // x: the one grid dimension not capped at 65535
  const int h = blockIdx.y;
  const int row0 = blockIdx.z * kRowsPerBlock;
  const int rows = min(kRowsPerBlock, L - row0);  // the last tile is ragged
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const T* kp = head_base<const T>(k, b, h);
  const T* vp = head_base<const T>(v, b, h);
  const int64_t first = ((int64_t)b * H + h) * L + row0;  // of this tile's statistics
  const int kv_end = causal ? min(L, row0 + rows) : L;    // the blocks past it are all masked

  stage_qg<T, DH>(sm, head_base<const T>(q, b, h), q.row_stride, head_base<const T>(g, b, h),
                  g.row_stride, row0, rows);

  if (recompute) {
    // the statistics sweep: online max, sum and sum of exp(S - m) o dP per row
    for (int i = threadIdx.x; i < kRowsPerBlock; i += kThreads) {
      sm.ms[i] = kNegInf;
      sm.ls[i] = 0.f;
      sm.deltas[i] = 0.f;
    }
    for (int kv0 = 0; kv0 < kv_end; kv0 += kBwdKV) {
      const int nkv = min(kBwdKV, L - kv0);
      __syncthreads();  // every warp is done with the previous block
      stage_kv<T, DH>(sm, kp, k.row_stride, vp, v.row_stride, kv0, nkv);
      __syncthreads();
      score_tile<T, DH, true>(sm, rows, nkv, causal ? row0 - kv0 : kNoDiag, scale);
      __syncthreads();
      for (int r = warp; r < kRowsPerBlock; r += kWarps) {
        const float s0 = sm.ps[r * kBwdKV + lane], s1 = sm.ps[r * kBwdKV + lane + 32];
        const float d0 = sm.dss[r * kBwdKV + lane], d1 = sm.dss[r * kBwdKV + lane + 32];
        const float m_old = sm.ms[r];
        const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
        const float alpha = expf(m_old - m_new);
        const float e0 = expf(s0 - m_new), e1 = expf(s1 - m_new);  // 0 at the masked keys
        const float sum = warp_sum(e0 + e1);
        const float dsum = warp_sum(e0 * d0 + e1 * d1);
        __syncwarp();  // all lanes have read ms[r] before it changes
        if (lane == 0) {
          sm.ms[r] = m_new;
          sm.ls[r] = sm.ls[r] * alpha + sum;
          sm.deltas[r] = sm.deltas[r] * alpha + dsum;
        }
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kRowsPerBlock; i += kThreads) {
      const float d = sm.deltas[i] / sm.ls[i];
      sm.deltas[i] = d;
      if (i < rows) {
        m[first + i] = sm.ms[i];
        l[first + i] = sm.ls[i];
        delta[first + i] = d;
      }
    }
  } else {
    stage_stats<T, DH>(sm, m, l, delta, first, rows);
  }

  // the gradient sweep: dq[r][c] += sum_j dS[r][j] K[j][c]
  const int c = threadIdx.x % DH;
  const int rg = (threadIdx.x / DH) * RPT;
  float acc[RPT];
#pragma unroll
  for (int e = 0; e < RPT; ++e) acc[e] = 0.f;
  for (int kv0 = 0; kv0 < kv_end; kv0 += kBwdKV) {
    const int nkv = min(kBwdKV, L - kv0);
    __syncthreads();
    stage_kv<T, DH>(sm, kp, k.row_stride, vp, v.row_stride, kv0, nkv);
    __syncthreads();
    score_tile<T, DH, false>(sm, rows, nkv, causal ? row0 - kv0 : kNoDiag, scale);
    __syncthreads();
    for (int j0 = 0; j0 < kBwdKV; j0 += 4) {
      float kk[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) kk[u] = to_float(sm.ks[(j0 + u) * KP + c]);
#pragma unroll
      for (int e = 0; e < RPT; ++e) {
        const float4 d = *reinterpret_cast<const float4*>(sm.dss + (rg + e) * kBwdKV + j0);
        acc[e] = fmaf(d.x, kk[0], acc[e]);
        acc[e] = fmaf(d.y, kk[1], acc[e]);
        acc[e] = fmaf(d.z, kk[2], acc[e]);
        acc[e] = fmaf(d.w, kk[3], acc[e]);
      }
    }
  }
  T* dqp = head_base<T>(dq, b, h);
#pragma unroll
  for (int e = 0; e < RPT; ++e) {
    const int r = rg + e;
    if (r < rows) dqp[(row0 + r) * dq.row_stride + c] = from_float<T>(acc[e]);
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads, 2)
blocked_dkv_kernel(Strided q, Strided k, Strided v, Strided g, Strided dk, Strided dv,
                   const float* m, const float* l, const float* delta, int L, int H, int causal,
                   float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem<T, DH> sm(smem);
  constexpr int KPT = kBwdKV * DH / kThreads;  // keys a thread owns, at one column

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int kv0 = blockIdx.z * kBwdKV;
  const int nkv = min(kBwdKV, L - kv0);  // the last block is ragged
  const T* qp = head_base<const T>(q, b, h);
  const T* gp = head_base<const T>(g, b, h);
  const int64_t first = ((int64_t)b * H + h) * L;  // of this head's statistics

  stage_kv<T, DH>(sm, head_base<const T>(k, b, h), k.row_stride, head_base<const T>(v, b, h),
                  v.row_stride, kv0, nkv);

  // dk[j][c] += sum_r dS[r][j] q[r][c], dv[j][c] += sum_r P[r][j] g[r][c]
  const int c = threadIdx.x % DH;
  const int jg = (threadIdx.x / DH) * KPT;
  float acc_k[KPT], acc_v[KPT];
#pragma unroll
  for (int e = 0; e < KPT; ++e) acc_k[e] = acc_v[e] = 0.f;
  // under the causal mask the q tiles before the block's own see none of its keys
  for (int row0 = causal ? kv0 : 0; row0 < L; row0 += kRowsPerBlock) {
    const int rows = min(kRowsPerBlock, L - row0);
    __syncthreads();  // every warp is done with the previous tile
    stage_qg<T, DH>(sm, qp, q.row_stride, gp, g.row_stride, row0, rows);
    stage_stats<T, DH>(sm, m, l, delta, first + row0, rows);
    __syncthreads();
    score_tile<T, DH, false>(sm, rows, nkv, causal ? row0 - kv0 : kNoDiag, scale);
    __syncthreads();
    for (int r = 0; r < rows; ++r) {
      const float qv = sm.qs[r * DH + c];
      const float gv = sm.gs[r * DH + c];
      if constexpr (KPT % 4 == 0) {
#pragma unroll
        for (int e = 0; e < KPT; e += 4) {
          const float4 d = *reinterpret_cast<const float4*>(sm.dss + r * kBwdKV + jg + e);
          const float4 p = *reinterpret_cast<const float4*>(sm.ps + r * kBwdKV + jg + e);
          acc_k[e] = fmaf(d.x, qv, acc_k[e]);
          acc_k[e + 1] = fmaf(d.y, qv, acc_k[e + 1]);
          acc_k[e + 2] = fmaf(d.z, qv, acc_k[e + 2]);
          acc_k[e + 3] = fmaf(d.w, qv, acc_k[e + 3]);
          acc_v[e] = fmaf(p.x, gv, acc_v[e]);
          acc_v[e + 1] = fmaf(p.y, gv, acc_v[e + 1]);
          acc_v[e + 2] = fmaf(p.z, gv, acc_v[e + 2]);
          acc_v[e + 3] = fmaf(p.w, gv, acc_v[e + 3]);
        }
      } else {  // head dim 8: two keys a thread
#pragma unroll
        for (int e = 0; e < KPT; ++e) {
          acc_k[e] = fmaf(sm.dss[r * kBwdKV + jg + e], qv, acc_k[e]);
          acc_v[e] = fmaf(sm.ps[r * kBwdKV + jg + e], gv, acc_v[e]);
        }
      }
    }
  }
  T* dkp = head_base<T>(dk, b, h);
  T* dvp = head_base<T>(dv, b, h);
#pragma unroll
  for (int e = 0; e < KPT; ++e) {
    const int j = jg + e;
    if (j < nkv) {
      dkp[(kv0 + j) * dk.row_stride + c] = from_float<T>(acc_k[e]);
      dvp[(kv0 + j) * dv.row_stride + c] = from_float<T>(acc_v[e]);
    }
  }
}

template <typename T, int DH>
cudaError_t launch_dq(const Strided* t, float* m, float* l, float* delta, int recompute, int B,
                      int H, int L, int causal, float scale, cudaStream_t stream) {
  static bool attribute_set = false;
  cudaError_t err = allow_optin_smem(blocked_dq_kernel<T, DH>, &attribute_set);
  if (err != cudaSuccess) return err;
  dim3 grid(B, H, (L + kRowsPerBlock - 1) / kRowsPerBlock);
  blocked_dq_kernel<T, DH><<<grid, kThreads, smem_bytes<T>(DH), stream>>>(
      t[0], t[1], t[2], t[3], t[4], m, l, delta, recompute, L, H, causal, scale);
  return cudaGetLastError();
}

template <typename T, int DH>
cudaError_t launch_dkv(const Strided* t, const float* m, const float* l, const float* delta, int B,
                       int H, int L, int causal, float scale, cudaStream_t stream) {
  static bool attribute_set = false;
  cudaError_t err = allow_optin_smem(blocked_dkv_kernel<T, DH>, &attribute_set);
  if (err != cudaSuccess) return err;
  dim3 grid(B, H, (L + kBwdKV - 1) / kBwdKV);
  blocked_dkv_kernel<T, DH><<<grid, kThreads, smem_bytes<T>(DH), stream>>>(
      t[0], t[1], t[2], t[3], t[4], t[5], m, l, delta, L, H, causal, scale);
  return cudaGetLastError();
}

// n tensors from their pointers and n x (batch, head, row) element strides
void gather(Strided* out, void* const* ptrs, const int64_t* strides, int n) {
  for (int i = 0; i < n; ++i)
    out[i] = Strided{ptrs[i], strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
}

}  // namespace

extern "C" {

// Shared-memory bytes one block of either kernel needs (independent of L), so
// the caller can refuse a shape early. dtype: 0 = float32, 1 = bfloat16.
size_t acl_blocked_bwd_smem_bytes(int dh, int dtype) {
  return dtype == 0 ? smem_bytes<float>(dh) : smem_bytes<__nv_bfloat16>(dh);
}

// The dq pass. ptrs: q, k, v, g, dq, each (B, H, L, dh) through its (batch,
// head, row) element strides in ``strides`` (last stride 1). m, l, delta:
// contiguous (B, H, L) fp32. recompute = 0: they are read, and l may be null
// (then 1: m is a log-sum-exp); recompute = 1: they are written, for the dkv pass.
// dh: 8, 16 or 32 (head dim 64 is mha_tc_bwd.cu's in bf16 and
// mha_tf32_bwd.cu's in fp32).
int acl_blocked_dq(int dtype, void* const* ptrs, const int64_t* strides, void* m, void* l,
                   void* delta, int recompute, int B, int H, int L, int dh, int causal,
                   float scale, void* stream) {
  Strided t[5];
  gather(t, ptrs, strides, 5);
  float* mf = static_cast<float*>(m);
  float* lf = static_cast<float*>(l);
  float* df = static_cast<float*>(delta);
  if (recompute && lf == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using BF = __nv_bfloat16;
#define ACL_DQ_CASE(CODE, T, DH)  \
  if (dtype == CODE && dh == DH) \
    return (int)launch_dq<T, DH>(t, mf, lf, df, recompute, B, H, L, causal, scale, s);
  ACL_DQ_CASE(0, float, 8)
  ACL_DQ_CASE(0, float, 16)
  ACL_DQ_CASE(0, float, 32)
  ACL_DQ_CASE(1, BF, 8)
  ACL_DQ_CASE(1, BF, 16)
  ACL_DQ_CASE(1, BF, 32)
#undef ACL_DQ_CASE
  return (int)cudaErrorInvalidValue;
}

// The dk, dv pass. ptrs: q, k, v, g, dk, dv, as above; m, l (or null), delta are
// read.
int acl_blocked_dkv(int dtype, void* const* ptrs, const int64_t* strides, const void* m,
                    const void* l, const void* delta, int B, int H, int L, int dh, int causal,
                    float scale, void* stream) {
  Strided t[6];
  gather(t, ptrs, strides, 6);
  const float* mf = static_cast<const float*>(m);
  const float* lf = static_cast<const float*>(l);
  const float* df = static_cast<const float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using BF = __nv_bfloat16;
#define ACL_DKV_CASE(CODE, T, DH) \
  if (dtype == CODE && dh == DH) \
    return (int)launch_dkv<T, DH>(t, mf, lf, df, B, H, L, causal, scale, s);
  ACL_DKV_CASE(0, float, 8)
  ACL_DKV_CASE(0, float, 16)
  ACL_DKV_CASE(0, float, 32)
  ACL_DKV_CASE(1, BF, 8)
  ACL_DKV_CASE(1, BF, 16)
  ACL_DKV_CASE(1, BF, 32)
#undef ACL_DKV_CASE
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
