// The attention probes for Hopper (sm_90a), fp32 and bf16, forward only: the
// counterparts of the kernels that the JAX package's measurement scripts launch
// themselves (scripts/probe_qkv_gb.py:51, scripts/probe_qtile_vmem.py:34,
// scripts/bench_attn_l14.py:83, 150, 179, 201, 238, 279). They are instruments:
// each answers where the whole-row kernel of mha.cu spends its time at the
// ViT-L/14@336px shape (32 x 577 x 1024, 16 heads of 64), and none is on a
// model's path.
//
// Two kernels, head dim 64:
//
//   probe_kernel   mha.cu's whole-row kernel (one block per batch entry, head
//                  and q tile; K and V of the head resident in shared memory;
//                  a warp owns one query row at a time) with what that kernel
//                  fixes made free: the query rows per block (a launch
//                  parameter), the warps per block (4, 8 or 16) and the type K
//                  and V are staged in (fp32 or the operand's), and with the
//                  softmax compiled out on request. Entries:
//                    acl_probe_qkv_fwd    packed (B, L, 3D) qkv, optional causal
//                                         mask: _mha_qkv_kernel under other
//                                         groupings (probe_qkv_gb.py:51);
//                    acl_probe_qtile_fwd  q (B, L, D) and packed k|v (B, L, 2D):
//                                         _mha_qtile_kernel under other q-tile
//                                         lengths and groupings
//                                         (probe_qtile_vmem.py:34,
//                                         bench_attn_l14.py:83, 201);
//                    acl_probe_bld_fwd    separate q, k, v: _mha_bld_kernel
//                                         without q tiling (bench_attn_l14.py:179);
//                    acl_probe_nosoftmax_fwd  ((q k^T) scale, cast to the operand
//                                         type) v with fp32 accumulation and no
//                                         max, exponent, sum or divide
//                                         (bench_attn_l14.py:262-279): the cost of
//                                         staging and of the two products alone.
//                  What the TPU's axes become: the q-tile length lq is the rows
//                  per block; the batch group gb, which on the TPU sets how many
//                  query rows a program works on against its resident K|V, is
//                  the warps per block, each holding one row and its L-long fp32
//                  exponent row; vmem_limit_bytes is the dynamic shared memory a
//                  block may ask for, which the caller checks before the launch.
//
//   parts_kernel   the same function with K and V staged one KV part at a time
//                  and each row's fp32 max, sum and accumulator carried across
//                  the parts in shared memory (bench_attn_l14.py:105-150,
//                  "twopass": two parts of ceil(L/2) keys, so half the resident
//                  K|V and two blocks on an SM instead of one), for one head per
//                  block or, as "pair" (bench_attn_l14.py:228-238), two
//                  neighbouring heads per block with half the warps on each:
//                  the pair's 128 contiguous columns of a K or V row are then
//                  read as whole 16-byte vectors. Per part: m_new = max(m,
//                  rowmax(s)), alpha = exp(m - m_new), p = exp(s - m_new) cast to
//                  the operand type before the P.V product (the sum takes p
//                  unrounded), acc = acc * alpha + p.V, l = l * alpha +
//                  rowsum(p); one divide at the end. Keys past L are never
//                  read. Entry: acl_mha_parts_fwd.
//
// What bounds them is what bounds mha.cu: the products run on the fp32 CUDA
// cores with one shared-memory operand per multiply-add, two orders of magnitude
// above the tensor-core bound; the probes exist to split that time into staging,
// products and the exponent path before the kernel is redesigned.

#include "attention_common.cuh"

namespace {

constexpr int kProbeDH = 64;

// ---------------------------------------------------------------------------
// probe_kernel
// ---------------------------------------------------------------------------

template <typename T, typename S, int DH, int WARPS, bool SOFTMAX>
__global__ void __launch_bounds__(WARPS * 32)
probe_kernel(Operand q, Operand k, Operand v, void* __restrict__ out_, int L, int H, int rows,
             int causal, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int KP = padded<S>(DH);
  constexpr int THREADS = WARPS * 32;
  S* ks = reinterpret_cast<S*>(smem);                 // L x KP
  S* vs = ks + L * KP;                                // L x DH
  float* ps = reinterpret_cast<float*>(vs + L * DH);  // WARPS x L   exponent rows
  float* qs = ps + WARPS * L;                         // WARPS x DH  query rows

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int tile = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  const T* kp = static_cast<const T*>(k.ptr) + b * k.batch_stride + h * DH;
  const T* vp = static_cast<const T*>(v.ptr) + b * v.batch_stride + h * DH;
  const T* qp = static_cast<const T*>(q.ptr) + b * q.batch_stride + h * DH;
  T* op = static_cast<T*>(out_) + (int64_t)b * L * H * DH + h * DH;

  for (int i = threadIdx.x; i < L * DH; i += THREADS) {
    const int r = i / DH, c = i % DH;
    ks[r * KP + c] = stage<S>(kp[r * k.row_stride + c]);
    vs[r * DH + c] = stage<S>(vp[r * v.row_stride + c]);
  }
  __syncthreads();

  float* prow = ps + warp * L;
  float* qrow = qs + warp * DH;
  const int row_end = min(L, (tile + 1) * rows);  // the last tile may be ragged
  for (int row = tile * rows + warp; row < row_end; row += WARPS) {
    for (int c = lane; c < DH; c += 32) qrow[c] = to_float(qp[row * q.row_stride + c]);
    __syncwarp();
    float qr[DH];
#pragma unroll
    for (int c = 0; c < DH; ++c) qr[c] = qrow[c];

    float denom = 1.f;
    if (SOFTMAX) {
      float m = kNegInf;
      for (int j = lane; j < L; j += 32) {
        float s = dot_row<S, DH>(qr, ks + j * KP) * scale;
        if (causal && j > row) s = kNegInf;
        prow[j] = s;
        m = fmaxf(m, s);
      }
      m = warp_max(m);
      denom = 0.f;
      for (int j = lane; j < L; j += 32) {
        const float e = expf(prow[j] - m);
        denom += e;
        prow[j] = round_like(e, T());
      }
      denom = warp_sum(denom);
    } else {
      // the scaled scores themselves, cast to the operand type
      for (int j = lane; j < L; j += 32)
        prow[j] = round_like(dot_row<S, DH>(qr, ks + j * KP) * scale, T());
    }
    __syncwarp();

    float acc[DH / 32];
#pragma unroll
    for (int t = 0; t < DH / 32; ++t) acc[t] = 0.f;
    for (int j = 0; j < L; ++j) {
      const float p = prow[j];
#pragma unroll
      for (int t = 0; t < DH / 32; ++t)
        acc[t] = fmaf(p, to_float(vs[j * DH + lane + 32 * t]), acc[t]);
    }
#pragma unroll
    for (int t = 0; t < DH / 32; ++t)
      op[(int64_t)row * H * DH + lane + 32 * t] = from_float<T>(acc[t] / denom);
    __syncwarp();
  }
}

size_t probe_smem(int L, int dh, int stage_itemsize, int warps) {
  const size_t pad = 4 / stage_itemsize;
  return (size_t)stage_itemsize * ((size_t)L * (dh + pad) + (size_t)L * dh) +
         sizeof(float) * ((size_t)warps * L + (size_t)warps * dh);
}

using ProbeKernel = void (*)(Operand, Operand, Operand, void*, int, int, int, int, float);

struct ProbeEntry {
  ProbeKernel kernel;
  bool optin;  // the opt-in to more than 48 KB of shared memory is set
};

template <typename T, typename S, bool SOFTMAX>
ProbeEntry* probe_entry_typed(int warps) {
  static ProbeEntry entries[3] = {
      {probe_kernel<T, S, kProbeDH, 4, SOFTMAX>, false},
      {probe_kernel<T, S, kProbeDH, 8, SOFTMAX>, false},
      {probe_kernel<T, S, kProbeDH, 16, SOFTMAX>, false},
  };
  switch (warps) {
    case 4: return &entries[0];
    case 8: return &entries[1];
    case 16: return &entries[2];
  }
  return nullptr;
}

// dtype: 0 = float32, 1 = bfloat16. K and V are staged as fp32 or in the operand
// type (one and the same in fp32). Null for what is not instantiated.
ProbeEntry* probe_entry(int dtype, int dh, int stage_fp32, int softmax, int warps) {
  using BF = __nv_bfloat16;
  if (dh != kProbeDH) return nullptr;
  if (dtype == 0)
    return softmax ? probe_entry_typed<float, float, true>(warps)
                   : probe_entry_typed<float, float, false>(warps);
  if (dtype == 1 && stage_fp32)
    return softmax ? probe_entry_typed<BF, float, true>(warps)
                   : probe_entry_typed<BF, float, false>(warps);
  if (dtype == 1)
    return softmax ? probe_entry_typed<BF, BF, true>(warps)
                   : probe_entry_typed<BF, BF, false>(warps);
  return nullptr;
}

int stage_itemsize(int dtype, int stage_fp32) { return (dtype == 0 || stage_fp32) ? 4 : 2; }

cudaError_t launch_probe(int dtype, int stage_fp32, int softmax, int rows, int warps, Operand q,
                         Operand k, Operand v, void* out, int B, int L, int H, int dh, int causal,
                         float scale, void* stream) {
  ProbeEntry* entry = probe_entry(dtype, dh, stage_fp32, softmax, warps);
  if (entry == nullptr || rows < 1) return cudaErrorInvalidValue;
  cudaError_t err = allow_optin_smem(entry->kernel, &entry->optin);
  if (err != cudaSuccess) return err;
  dim3 grid(B, H, (L + rows - 1) / rows);
  const size_t smem = probe_smem(L, dh, stage_itemsize(dtype, stage_fp32), warps);
  const ProbeKernel kernel = entry->kernel;
  kernel<<<grid, warps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, out, L, H, rows, causal, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// parts_kernel
// ---------------------------------------------------------------------------

// Copy `nrows` rows of WIDTH contiguous operand elements from device memory
// (row r at src + r * row_stride, 16-byte aligned) into shared memory as 32-bit
// words, row r at dst + r * dst_words: one 16-byte load per thread and step.
template <typename T, int WIDTH>
__device__ __forceinline__ void stage_rows(const T* src, int64_t row_stride, int nrows,
                                           uint32_t* dst, int dst_words, int threads) {
  constexpr int VECS = WIDTH * (int)sizeof(T) / 16;  // 16-byte vectors per row
  for (int i = threadIdx.x; i < nrows * VECS; i += threads) {
    const int r = i / VECS, c = i % VECS;
    const uint4 x = *reinterpret_cast<const uint4*>(
        reinterpret_cast<const char*>(src + r * row_stride) + 16 * c);
    uint32_t* d = dst + r * dst_words + 4 * c;
    d[0] = x.x;
    d[1] = x.y;
    d[2] = x.z;
    d[3] = x.w;
  }
}

template <typename T, int DH, int WARPS, int HPB>
__global__ void __launch_bounds__(WARPS * 32)
parts_kernel(Operand q, Operand k, Operand v, void* __restrict__ out_, int L, int H, int rows,
             int part, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int THREADS = WARPS * 32;
  constexpr int WIDTH = HPB * DH;            // columns of the block's heads: contiguous
  constexpr int KP = padded<T>(WIDTH);       // a staged K row: the heads' columns and one word
  constexpr int PER_HEAD = WARPS / HPB;      // warps on each head
  T* ks = reinterpret_cast<T*>(smem);                   // part x KP
  T* vs = ks + part * KP;                               // part x WIDTH
  float* ps = reinterpret_cast<float*>(vs + part * WIDTH);  // WARPS x part   exponent rows
  float* qs = ps + WARPS * part;                        // WARPS x DH     query rows
  float* accs = qs + WARPS * DH;                        // rows x WIDTH   accumulators
  float* ms = accs + rows * WIDTH;                      // rows x HPB     running max
  float* ls = ms + rows * HPB;                          // rows x HPB     running sum

  const int b = blockIdx.x;
  const int h0 = blockIdx.y * HPB;  // the block's first head
  const int row0 = blockIdx.z * rows;
  const int nrows = min(rows, L - row0);  // the last tile may be ragged
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int hh = warp / PER_HEAD;   // which of the block's heads this warp serves
  const int wl = warp % PER_HEAD;

  const T* kp = static_cast<const T*>(k.ptr) + b * k.batch_stride + h0 * DH;
  const T* vp = static_cast<const T*>(v.ptr) + b * v.batch_stride + h0 * DH;
  const T* qp = static_cast<const T*>(q.ptr) + b * q.batch_stride + (h0 + hh) * DH;
  T* op = static_cast<T*>(out_) + (int64_t)b * L * H * DH + (h0 + hh) * DH;

  for (int i = threadIdx.x; i < rows * WIDTH; i += THREADS) accs[i] = 0.f;
  for (int i = threadIdx.x; i < rows * HPB; i += THREADS) {
    ms[i] = kNegInf;
    ls[i] = 0.f;
  }

  float* prow = ps + warp * part;
  float* qrow = qs + warp * DH;
  const T* khead = ks + hh * DH;
  const T* vhead = vs + hh * DH;
  for (int kv0 = 0; kv0 < L; kv0 += part) {
    const int nkv = min(part, L - kv0);  // keys past L are never read
    __syncthreads();  // every warp is done with the previous part
    stage_rows<T, WIDTH>(kp + kv0 * k.row_stride, k.row_stride, nkv,
                         reinterpret_cast<uint32_t*>(ks), KP * (int)sizeof(T) / 4, THREADS);
    stage_rows<T, WIDTH>(vp + kv0 * v.row_stride, v.row_stride, nkv,
                         reinterpret_cast<uint32_t*>(vs), WIDTH * (int)sizeof(T) / 4, THREADS);
    __syncthreads();

    for (int r = wl; r < nrows; r += PER_HEAD) {
      for (int c = lane; c < DH; c += 32)
        qrow[c] = to_float(qp[(row0 + r) * q.row_stride + c]);
      __syncwarp();
      float qr[DH];
#pragma unroll
      for (int c = 0; c < DH; ++c) qr[c] = qrow[c];

      float part_max = kNegInf;
      for (int j = lane; j < nkv; j += 32) {
        const float s = dot_row<T, DH>(qr, khead + j * KP) * scale;
        prow[j] = s;
        part_max = fmaxf(part_max, s);
      }
      part_max = warp_max(part_max);
      const int state = r * HPB + hh;
      const float m_old = ms[state];
      const float m_new = fmaxf(m_old, part_max);
      const float alpha = expf(m_old - m_new);

      float psum = 0.f;
      for (int j = lane; j < nkv; j += 32) {
        const float p = expf(prow[j] - m_new);
        psum += p;
        prow[j] = round_like(p, T());
      }
      psum = warp_sum(psum);
      __syncwarp();

      float* arow = accs + r * WIDTH + hh * DH;
      float acc[DH / 32];
#pragma unroll
      for (int t = 0; t < DH / 32; ++t) acc[t] = arow[lane + 32 * t] * alpha;
      for (int j = 0; j < nkv; ++j) {
        const float p = prow[j];
#pragma unroll
        for (int t = 0; t < DH / 32; ++t)
          acc[t] = fmaf(p, to_float(vhead[j * WIDTH + lane + 32 * t]), acc[t]);
      }
#pragma unroll
      for (int t = 0; t < DH / 32; ++t) arow[lane + 32 * t] = acc[t];
      __syncwarp();  // all lanes have read ms, prow and qrow before they change
      if (lane == 0) {
        ms[state] = m_new;
        ls[state] = ls[state] * alpha + psum;
      }
      __syncwarp();
    }
  }

  // a row's state is written and read by one warp only: no block barrier
  for (int r = wl; r < nrows; r += PER_HEAD) {
    const float denom = ls[r * HPB + hh];
    const float* arow = accs + r * WIDTH + hh * DH;
#pragma unroll
    for (int t = 0; t < DH / 32; ++t)
      op[(int64_t)(row0 + r) * H * DH + lane + 32 * t] = from_float<T>(arow[lane + 32 * t] / denom);
  }
}

size_t parts_smem(int rows, int part, int dh, int itemsize, int warps, int hpb) {
  const size_t width = (size_t)hpb * dh;
  return (size_t)itemsize * part * (2 * width + 4 / itemsize) +
         sizeof(float) * ((size_t)warps * part + (size_t)warps * dh + (size_t)rows * width +
                          2 * (size_t)rows * hpb);
}

template <typename T, int HPB>
ProbeEntry* parts_entry_typed(int warps) {
  static ProbeEntry entries[3] = {
      {parts_kernel<T, kProbeDH, 4, HPB>, false},
      {parts_kernel<T, kProbeDH, 8, HPB>, false},
      {parts_kernel<T, kProbeDH, 16, HPB>, false},
  };
  switch (warps) {
    case 4: return &entries[0];
    case 8: return &entries[1];
    case 16: return &entries[2];
  }
  return nullptr;
}

ProbeEntry* parts_entry(int dtype, int dh, int hpb, int warps) {
  using BF = __nv_bfloat16;
  if (dh != kProbeDH || (hpb != 1 && hpb != 2)) return nullptr;
  if (dtype == 0)
    return hpb == 1 ? parts_entry_typed<float, 1>(warps) : parts_entry_typed<float, 2>(warps);
  if (dtype == 1)
    return hpb == 1 ? parts_entry_typed<BF, 1>(warps) : parts_entry_typed<BF, 2>(warps);
  return nullptr;
}

cudaError_t blocks_per_sm(ProbeEntry* entry, int warps, size_t smem, int* blocks) {
  if (entry == nullptr) return cudaErrorInvalidValue;
  cudaError_t err = allow_optin_smem(entry->kernel, &entry->optin);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, entry->kernel, warps * 32, smem);
}

}  // namespace

extern "C" {

// Shared-memory bytes one block of probe_kernel needs: K (padded by one 32-bit
// word) and V of the head staged in stage_itemsize-byte elements, an fp32
// exponent row and query row per warp.
size_t acl_probe_smem_bytes(int L, int dh, int stage_itemsize, int warps) {
  return probe_smem(L, dh, stage_itemsize, warps);
}

// Blocks of probe_kernel that one SM holds at a time, given their shared
// memory; negative: -cudaError.
int acl_probe_blocks_per_sm(int dtype, int dh, int stage_fp32, int softmax, int warps,
                            size_t smem_bytes) {
  int blocks = 0;
  cudaError_t err = blocks_per_sm(probe_entry(dtype, dh, stage_fp32, softmax, warps), warps,
                                  smem_bytes, &blocks);
  return err == cudaSuccess ? blocks : -(int)err;
}

// qkv: (B, L, 3D) with element strides (batch_stride, row_stride, 1); out:
// contiguous (B, L, D), D = H * dh.
int acl_probe_qkv_fwd(int dtype, int stage_fp32, int rows, int warps, const void* qkv,
                      int64_t batch_stride, int64_t row_stride, void* out, int B, int L, int H,
                      int dh, int causal, float scale, void* stream) {
  const int D = H * dh;
  const size_t esize = dtype == 0 ? 4 : 2;
  const char* base = static_cast<const char*>(qkv);
  Operand q{base, batch_stride, row_stride};
  Operand k{base + esize * D, batch_stride, row_stride};
  Operand v{base + esize * 2 * D, batch_stride, row_stride};
  return (int)launch_probe(dtype, stage_fp32, 1, rows, warps, q, k, v, out, B, L, H, dh, causal,
                           scale, stream);
}

// q: (B, L, D) and kv: (B, L, 2D), lane order k|v; out: contiguous (B, L, D).
int acl_probe_qtile_fwd(int dtype, int stage_fp32, int rows, int warps, const void* q,
                        int64_t q_bs, int64_t q_rs, const void* kv, int64_t kv_bs, int64_t kv_rs,
                        void* out, int B, int L, int H, int dh, float scale, void* stream) {
  const size_t esize = dtype == 0 ? 4 : 2;
  Operand qo{q, q_bs, q_rs};
  Operand ko{kv, kv_bs, kv_rs};
  Operand vo{static_cast<const char*>(kv) + esize * H * dh, kv_bs, kv_rs};
  return (int)launch_probe(dtype, stage_fp32, 1, rows, warps, qo, ko, vo, out, B, L, H, dh, 0,
                           scale, stream);
}

// The same layout with the softmax compiled out: out = ((q k^T) scale, cast to
// the operand type) v.
int acl_probe_nosoftmax_fwd(int dtype, int stage_fp32, int rows, int warps, const void* q,
                            int64_t q_bs, int64_t q_rs, const void* kv, int64_t kv_bs,
                            int64_t kv_rs, void* out, int B, int L, int H, int dh, float scale,
                            void* stream) {
  const size_t esize = dtype == 0 ? 4 : 2;
  Operand qo{q, q_bs, q_rs};
  Operand ko{kv, kv_bs, kv_rs};
  Operand vo{static_cast<const char*>(kv) + esize * H * dh, kv_bs, kv_rs};
  return (int)launch_probe(dtype, stage_fp32, 0, rows, warps, qo, ko, vo, out, B, L, H, dh, 0,
                           scale, stream);
}

// q, k, v: (B, L, D) each with its own element strides; out: contiguous (B, L, D).
int acl_probe_bld_fwd(int dtype, int stage_fp32, int rows, int warps, const void* q, int64_t q_bs,
                      int64_t q_rs, const void* k, int64_t k_bs, int64_t k_rs, const void* v,
                      int64_t v_bs, int64_t v_rs, void* out, int B, int L, int H, int dh,
                      int causal, float scale, void* stream) {
  Operand qo{q, q_bs, q_rs};
  Operand ko{k, k_bs, k_rs};
  Operand vo{v, v_bs, v_rs};
  return (int)launch_probe(dtype, stage_fp32, 1, rows, warps, qo, ko, vo, out, B, L, H, dh,
                           causal, scale, stream);
}

// Shared-memory bytes one block of parts_kernel needs: one KV part of the
// block's heads in the operand type (K rows padded by one 32-bit word), an fp32
// exponent row and query row per warp, and the fp32 accumulator, max and sum of
// every row and head of the tile.
size_t acl_parts_smem_bytes(int rows, int part, int dh, int dtype, int warps, int heads_per_block) {
  return parts_smem(rows, part, dh, dtype == 0 ? 4 : 2, warps, heads_per_block);
}

int acl_parts_blocks_per_sm(int dtype, int dh, int heads_per_block, int warps, size_t smem_bytes) {
  int blocks = 0;
  cudaError_t err =
      blocks_per_sm(parts_entry(dtype, dh, heads_per_block, warps), warps, smem_bytes, &blocks);
  return err == cudaSuccess ? blocks : -(int)err;
}

// q, k, v: (B, L, D) each with its own element strides (k and v may be the two
// halves of one packed projection); out: contiguous (B, L, D). Non-causal. Every
// k and v row of a block's heads must start at a 16-byte boundary (the caller
// checks it).
int acl_mha_parts_fwd(int dtype, int heads_per_block, int rows, int warps, int part,
                      const void* q, int64_t q_bs, int64_t q_rs, const void* k, int64_t k_bs,
                      int64_t k_rs, const void* v, int64_t v_bs, int64_t v_rs, void* out, int B,
                      int L, int H, int dh, float scale, void* stream) {
  ProbeEntry* entry = parts_entry(dtype, dh, heads_per_block, warps);
  if (entry == nullptr || rows < 1 || part < 1 || H % heads_per_block)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_optin_smem(entry->kernel, &entry->optin);
  if (err != cudaSuccess) return (int)err;
  Operand qo{q, q_bs, q_rs};
  Operand ko{k, k_bs, k_rs};
  Operand vo{v, v_bs, v_rs};
  dim3 grid(B, H / heads_per_block, (L + rows - 1) / rows);
  const size_t smem = parts_smem(rows, part, dh, dtype == 0 ? 4 : 2, warps, heads_per_block);
  const ProbeKernel kernel = entry->kernel;
  kernel<<<grid, warps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      qo, ko, vo, out, L, H, rows, part, scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
