"""Fused multi-head attention: the CUDA kernels of the main path and their plain
PyTorch versions.

Five entries, the counterparts of the JAX package's Pallas kernels
(anomalyclip_tpu/ops/pallas/attention.py):

- ``fused_mha_qkv``: attention from one packed (B, L, 3D) qkv projection, lane
  order q|k|v (``_mha_qkv_kernel``, :423-466). CLIP's image and text towers.
  Its gradient is ``_mha_qkv_bwd_kernel`` (:291-311, 362-382): a packed dqkv.
- ``fused_mha_bld``: the same from separate (B, L, D) q, k, v (``_mha_bld_kernel``,
  :88-96, 386). The temporal model's axial attention. Its gradient is
  ``_mha_bld_bwd_kernel`` (:273-288, 340-358): dq, dk, dv.
- ``fused_mha_qtile``: non-causal q (B, L, D) against a packed k|v (B, L, 2D)
  (``_mha_qtile_kernel``, :525-532, 626). The ViT-L/14@336px tower in bf16.
- ``flash_attention_heads``: KV-blocked online softmax over per-head (N, L, dh)
  (``_flash_kernel``, :800-854, 1056), optionally with the log-sum-exp.
- ``fused_attention``: per-head (B, H, L, Dh) (``_attn_kernel``, :1089-1093,
  1152), routed as ``_fused_attention_impl`` routes (:1121-1135). The
  ViT-L/14@336px tower in fp32 enters here and goes on to the flash kernel.

The forwards compute the function of ``_attend_head`` (:68-85): fp32 scores, a
row-max-subtracted fp32 softmax, masked entries at ``NEG_INF``. The backwards
compute the exact softmax VJP of ``_mha_bwd_head`` (:244-270), scores recomputed
from q and k. Each entry is a ``torch.autograd.Function``: on a CUDA tensor each
direction launches its kernel (ops/csrc/*.cu, built by ops/build.py) or raises;
on a CPU tensor both run the plain versions. The last three entries serve
inference only: on the kernel path their backward raises, since the backward
kernels (K7, K9, K10) are not ported yet; their plain versions are
differentiable as they are.
``attention_impl("reference")`` makes the wrappers run the plain versions on the
card too, so that tests and the chip smoke run can hold the kernels against
them. The choice is read when the forward runs and kept for its backward, which
autograd runs on another thread.

Which kernel fits a shape is a matter of shared memory. The formulas of what a
block of each kernel needs live here (K1, K2 and K6 share one whole-row kernel
and one formula, with K and V staged as fp32 or in the operand type), one source of truth for the wrappers'
checks and for the dispatch ladder (models/clip/model.py: ``attention_rung``);
the library reports its own (``acl_*_smem_bytes``), and the chip smoke run holds
the two against each other.
"""

from __future__ import annotations

import contextlib
import contextvars
import ctypes
import functools
import math

import torch

from anomalyclip_tpu_torch.ops.build import load_library

NEG_INF = -1e30

# kernel launches per entry since the last reset_launch_counts(), each counted
# where its kernel launches: "fused_attention" counts its whole-block kernel;
# its flash branch launches K8, which counts under "flash_attention_heads".
launch_counts = {
    "fused_mha_qkv": 0, "fused_mha_bld": 0, "mha_qkv_bwd": 0, "mha_bld_bwd": 0,
    "fused_mha_qtile": 0, "flash_attention_heads": 0, "fused_attention": 0,
}

_IMPL = contextvars.ContextVar("attention_impl", default="kernel")


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


@contextlib.contextmanager
def attention_impl(impl: str):
    """Scoped choice of what the wrappers run on a CUDA tensor: "kernel" (the
    default) or "reference" (the plain PyTorch version)."""
    if impl not in ("kernel", "reference"):
        raise ValueError(f"attention_impl must be 'kernel' or 'reference', not {impl!r}")
    token = _IMPL.set(impl)
    try:
        yield
    finally:
        _IMPL.reset(token)


# ---------------------------------------------------------------------------
# Plain versions: einsum and an fp32 softmax, as _xla_attention (attention.py:1096),
# rounded as _attend_head (:68-85) and _mha_bwd_head (:244-270) round
# ---------------------------------------------------------------------------


def _masked_scores(q, k, causal: bool) -> torch.Tensor:
    """fp32 q k^T / sqrt(dh) over (B, H, L, Dh), causal entries at NEG_INF."""
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (1.0 / math.sqrt(q.shape[-1]))
    if causal:
        l = q.shape[2]
        mask = torch.ones((l, l), dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~mask, NEG_INF)
    return scores


def attention_reference(q, k, v, causal: bool = False) -> torch.Tensor:
    """softmax(q k^T / sqrt(dh)) v over (B, H, L, Dh). Scores, row max and
    exponent are fp32; the unnormalised exponent is cast to v's type and summed
    against v in fp32; the divide is done on the output. In fp32 this is
    ``_xla_attention``; in bf16 it rounds where the kernels round."""
    scores = _masked_scores(q, k, causal)
    e = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    out = torch.einsum("bhqk,bhkd->bhqd", e.to(v.dtype).float(), v.float())
    return (out / e.sum(dim=-1, keepdim=True)).to(q.dtype)


def attention_bwd_reference(q, k, v, g, causal: bool = False) -> tuple:
    """(dq, dk, dv) of ``attention_reference`` for the output gradient g, all
    (B, H, L, Dh): the explicit softmax VJP, with P recomputed and *normalised*
    in fp32, dS = P o (dP - rowsum(P o dP)) * scale cast to q's type and P cast
    to v's type before the second-stage products, every product accumulated in
    fp32, as ``_mha_bwd_head`` rounds (a no-op in fp32)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = _masked_scores(q, k, causal)
    e = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    g = g.to(q.dtype).float()
    dp = torch.einsum("bhqd,bhkd->bhqk", g, v.float())
    delta = (p * dp).sum(dim=-1, keepdim=True)
    ds = (p * (dp - delta) * scale).to(q.dtype).float()
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float())
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(v.dtype).float(), g)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def _split_heads(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, l, d = t.shape
    return t.reshape(b, l, num_heads, d // num_heads).transpose(1, 2)


def _merge_heads(t: torch.Tensor) -> torch.Tensor:
    b, h, l, dh = t.shape
    return t.transpose(1, 2).reshape(b, l, h * dh)


def _unpack_qkv(qkv: torch.Tensor) -> tuple:
    d = qkv.shape[-1] // 3
    return qkv[..., :d], qkv[..., d : 2 * d], qkv[..., 2 * d :]


def mha_bld_reference(q, k, v, num_heads: int, causal: bool = False) -> torch.Tensor:
    heads = [_split_heads(t, num_heads) for t in (q, k, v)]
    return _merge_heads(attention_reference(*heads, causal))


def mha_qkv_reference(qkv, num_heads: int, causal: bool = False) -> torch.Tensor:
    return mha_bld_reference(*_unpack_qkv(qkv), num_heads, causal)


def mha_bld_bwd_reference(q, k, v, g, num_heads: int, causal: bool = False) -> tuple:
    """(dq, dk, dv), each (B, L, D), of ``mha_bld_reference`` for its output
    gradient g (B, L, D)."""
    heads = [_split_heads(t, num_heads) for t in (q, k, v, g)]
    return tuple(_merge_heads(t) for t in attention_bwd_reference(*heads, causal))


def mha_qkv_bwd_reference(qkv, g, num_heads: int, causal: bool = False) -> torch.Tensor:
    """The packed (B, L, 3D) gradient of ``mha_qkv_reference`` for its output
    gradient g (B, L, D)."""
    return torch.cat(mha_bld_bwd_reference(*_unpack_qkv(qkv), g, num_heads, causal), dim=-1)


def mha_qtile_reference(q, kv, num_heads: int) -> torch.Tensor:
    """``_mha_qtile_kernel`` (:525-532): non-causal attention of q (B, L, D)
    against the packed k|v (B, L, 2D), rounded as ``_attend_head`` rounds."""
    d = q.shape[-1]
    return mha_bld_reference(q, kv[..., :d], kv[..., d:], num_heads)


def fused_attention_reference(q, k, v, causal: bool = False) -> torch.Tensor:
    """``fused_attention``'s whole-block kernel (:1089-1093) over (B, H, L, Dh)."""
    return attention_reference(q, k, v, causal)


# keys per KV block of the flash kernel (mha_long.cu: kBlockKV)
FLASH_BLOCK_KV = 128


def flash_attention_reference(q, k, v, save_lse: bool = False):
    """``_flash_kernel`` (:800-854) over per-head (N, L, dh): per KV block of
    ``FLASH_BLOCK_KV`` keys the running max, the rescale alpha = exp(m_old -
    m_new), p = exp(s - m_new) cast to v's type before the P.V product and
    summed unrounded, one divide at the end. The block size decides where bf16
    rounds: it is the CUDA kernel's (the Pallas kernel's is 512). -> out, or
    (out, lse) with lse = m + log(sum) as a plain (N, L) fp32 tensor."""
    n, l, dh = q.shape
    scale = 1.0 / math.sqrt(dh)
    qf = q.float()
    m = torch.full((n, l, 1), NEG_INF, dtype=torch.float32, device=q.device)
    denom = torch.zeros((n, l, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((n, l, dh), dtype=torch.float32, device=q.device)
    for start in range(0, l, FLASH_BLOCK_KV):
        kb, vb = k[:, start : start + FLASH_BLOCK_KV], v[:, start : start + FLASH_BLOCK_KV]
        s = torch.einsum("nqd,nkd->nqk", qf, kb.float()) * scale
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        acc = acc * alpha + torch.einsum("nqk,nkd->nqd", p.to(v.dtype).float(), vb.float())
        denom = denom * alpha + p.sum(dim=-1, keepdim=True)
        m = m_new
    out = (acc / denom).to(q.dtype)
    if save_lse:
        return out, (m + torch.log(denom)).squeeze(-1)
    return out


# ---------------------------------------------------------------------------
# Shared memory per block of each kernel, in bytes: the same formulas as the
# kernels' own smem_bytes (mha.cu, mha_bwd.cu, mha_long.cu)
# ---------------------------------------------------------------------------

_KERNEL_WARPS = 8
_KERNEL_ROWS = 64  # query rows per block of the forward kernels
# what an H100 gives one block (cudaDevAttrMaxSharedMemoryPerBlockOptin); the
# limit the dispatch takes for tensors on the CPU, so that a CPU run takes the
# card's rungs
H100_SMEM_OPTIN = 232_448


def mha_smem_bytes(l: int, dh: int, itemsize: int = 4) -> int:
    """The whole-row kernel (mha.cu): K (padded by one 32-bit word) and V of the
    head staged in ``itemsize``-byte elements, the warps' fp32 exponent rows and
    query rows. K1 and K2 stage as fp32 (the default); K6 in the operand type."""
    kv = itemsize * (l * (dh + 4 // itemsize) + l * dh)
    return kv + 4 * _KERNEL_WARPS * (l + dh)


def mha_bwd_smem_bytes(l: int, dh: int) -> int:
    """K3 and K4 (mha_bwd.cu): Q, K, V, G padded, P and dS as L x L, all fp32."""
    return 4 * (4 * l * (dh + 1) + 2 * l * l)


def flash_smem_bytes(dh: int, itemsize: int) -> int:
    """K8 (mha_long.cu): one KV block in the operand type (K padded), the warps'
    fp32 exponent rows, the fp32 q tile and accumulators, the running max and
    sum per row. Independent of L."""
    kv = itemsize * (FLASH_BLOCK_KV * (dh + 4 // itemsize) + FLASH_BLOCK_KV * dh)
    return kv + 4 * (_KERNEL_WARPS * FLASH_BLOCK_KV + 2 * _KERNEL_ROWS * dh + 2 * _KERNEL_ROWS)


@functools.lru_cache(maxsize=None)
def _card_smem_optin(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).shared_memory_per_block_optin


def smem_limit(device: torch.device) -> int:
    """Shared memory one block may have on ``device``'s card; the H100's for a
    CPU device."""
    if device.type != "cuda":
        return H100_SMEM_OPTIN
    return _card_smem_optin(torch.cuda.current_device() if device.index is None else device.index)


# ---------------------------------------------------------------------------
# Kernel launches: CUDA tensors only; each checks what its kernel takes and
# raises on anything else, and counts its launches
# ---------------------------------------------------------------------------

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64)
_INT_MAX = 2**31 - 1


def _use_reference(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"fused attention takes CPU or CUDA tensors, not {t.device}")
    return _IMPL.get() == "reference"


def _check_kernel_shape(name: str, t: torch.Tensor, d: int, num_heads: int, smem_need) -> int:
    """Raise, with the shape, on what the CUDA kernel does not take -> head dim.
    ``smem_need(dh)`` is the shared memory one block needs at this shape."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: the kernel takes CUDA tensors, not {t.device}")
    if t.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: dtype {t.dtype} not supported (float32, bfloat16)")
    if d % num_heads or d // num_heads not in _HEAD_DIMS:
        raise ValueError(
            f"{name}: shape {tuple(t.shape)} with {num_heads} heads gives head dim "
            f"{d / num_heads:g}; the kernel takes {_HEAD_DIMS}"
        )
    dh = d // num_heads
    need, have = smem_need(dh), smem_limit(t.device)
    if need > have:
        raise ValueError(
            f"{name}: shape {tuple(t.shape)} needs {need} B of shared memory per block, "
            f"the card gives {have}"
        )
    return dh


def _strides(name: str, t: torch.Tensor, shape) -> tuple:
    if t.stride(-1) != 1:
        raise ValueError(f"{name}: shape {tuple(shape)}: the last dimension must be contiguous")
    bs, rs = t.stride(0), t.stride(1)
    if t.shape[0] * bs > _INT_MAX or t.shape[1] * rs > _INT_MAX:
        raise ValueError(f"{name}: shape {tuple(shape)} has strides beyond 32-bit indexing")
    return bs, rs


def _check_bld(name: str, q, k, v) -> None:
    if k.shape != q.shape or v.shape != q.shape or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"{name}: q, k, v must agree: {tuple(q.shape)} {q.dtype}, "
            f"{tuple(k.shape)} {k.dtype}, {tuple(v.shape)} {v.dtype}"
        )
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"{name}: q, k, v must be on one device")


def _raise_on_error(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with cudaError {err}")


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def mha_qkv_fwd_kernel(qkv: torch.Tensor, num_heads: int, causal: bool) -> torch.Tensor:
    """K1: launch ``acl_mha_qkv_fwd`` -> (B, L, D)."""
    b, l, d3 = qkv.shape
    d = d3 // 3
    dh = _check_kernel_shape(
        "fused_mha_qkv", qkv, d, num_heads, lambda dh: mha_smem_bytes(l, dh)
    )
    bs, rs = _strides("fused_mha_qkv", qkv, qkv.shape)
    out = torch.empty((b, l, d), dtype=qkv.dtype, device=qkv.device)
    err = load_library().acl_mha_qkv_fwd(
        _DTYPE_CODES[qkv.dtype], ctypes.c_void_p(qkv.data_ptr()), bs, rs,
        ctypes.c_void_p(out.data_ptr()), b, l, num_heads, dh, int(causal),
        1.0 / math.sqrt(dh), _stream(qkv),
    )
    _raise_on_error("fused_mha_qkv", err)
    launch_counts["fused_mha_qkv"] += 1
    return out


def _launch_mha_bld(name: str, q, k, v, num_heads: int, causal: bool) -> torch.Tensor:
    """Launch ``acl_mha_bld_fwd`` for entry ``name`` -> (B, L, D); k and v are
    read in place. Counts nothing."""
    _check_bld(name, q, k, v)
    b, l, d = q.shape
    dh = _check_kernel_shape(name, q, d, num_heads, lambda dh: mha_smem_bytes(l, dh))
    strides = [_strides(name, t, q.shape) for t in (q, k, v)]
    out = torch.empty((b, l, d), dtype=q.dtype, device=q.device)
    ptr = ctypes.c_void_p
    err = load_library().acl_mha_bld_fwd(
        _DTYPE_CODES[q.dtype],
        ptr(q.data_ptr()), *strides[0],
        ptr(k.data_ptr()), *strides[1],
        ptr(v.data_ptr()), *strides[2],
        ptr(out.data_ptr()), b, l, num_heads, dh, int(causal), 1.0 / math.sqrt(dh),
        _stream(q),
    )
    _raise_on_error(name, err)
    return out


def mha_bld_fwd_kernel(q, k, v, num_heads: int, causal: bool) -> torch.Tensor:
    """K2: launch ``acl_mha_bld_fwd`` -> (B, L, D); k and v are read in place."""
    out = _launch_mha_bld("fused_mha_bld", q, k, v, num_heads, causal)
    launch_counts["fused_mha_bld"] += 1
    return out


def mha_qkv_bwd_kernel(qkv, g, num_heads: int, causal: bool) -> torch.Tensor:
    """K3: launch ``acl_mha_qkv_bwd`` -> the packed (B, L, 3D) dqkv."""
    b, l, d3 = qkv.shape
    d = d3 // 3
    dh = _check_kernel_shape(
        "mha_qkv_bwd", qkv, d, num_heads, lambda dh: mha_bwd_smem_bytes(l, dh)
    )
    bs, rs = _strides("mha_qkv_bwd", qkv, qkv.shape)
    if g.shape != (b, l, d) or g.device != qkv.device:
        raise ValueError(f"mha_qkv_bwd: gradient {tuple(g.shape)} for qkv {tuple(qkv.shape)}")
    g = g.to(qkv.dtype).contiguous()
    dqkv = torch.empty((b, l, d3), dtype=qkv.dtype, device=qkv.device)
    ptr = ctypes.c_void_p
    err = load_library().acl_mha_qkv_bwd(
        _DTYPE_CODES[qkv.dtype], ptr(qkv.data_ptr()), bs, rs, ptr(g.data_ptr()),
        ptr(dqkv.data_ptr()), b, l, num_heads, dh, int(causal), 1.0 / math.sqrt(dh),
        _stream(qkv),
    )
    _raise_on_error("mha_qkv_bwd", err)
    launch_counts["mha_qkv_bwd"] += 1
    return dqkv


def mha_bld_bwd_kernel(q, k, v, g, num_heads: int, causal: bool) -> tuple:
    """K4: launch ``acl_mha_bld_bwd`` -> (dq, dk, dv), each (B, L, D)."""
    _check_bld("mha_bld_bwd", q, k, v)
    b, l, d = q.shape
    dh = _check_kernel_shape(
        "mha_bld_bwd", q, d, num_heads, lambda dh: mha_bwd_smem_bytes(l, dh)
    )
    if g.shape != q.shape or g.device != q.device:
        raise ValueError(f"mha_bld_bwd: gradient {tuple(g.shape)} for q {tuple(q.shape)}")
    g = g.to(q.dtype).contiguous()
    strides = [_strides("mha_bld_bwd", t, q.shape) for t in (q, k, v, g)]
    dq, dk, dv = (torch.empty((b, l, d), dtype=q.dtype, device=q.device) for _ in range(3))
    ptr = ctypes.c_void_p
    err = load_library().acl_mha_bld_bwd(
        _DTYPE_CODES[q.dtype],
        ptr(q.data_ptr()), *strides[0],
        ptr(k.data_ptr()), *strides[1],
        ptr(v.data_ptr()), *strides[2],
        ptr(g.data_ptr()), *strides[3],
        ptr(dq.data_ptr()), ptr(dk.data_ptr()), ptr(dv.data_ptr()),
        b, l, num_heads, dh, int(causal), 1.0 / math.sqrt(dh), _stream(q),
    )
    _raise_on_error("mha_bld_bwd", err)
    launch_counts["mha_bld_bwd"] += 1
    return dq, dk, dv


def mha_qtile_fwd_kernel(q, kv, num_heads: int) -> torch.Tensor:
    """K6: launch ``acl_mha_qtile_fwd`` (K1's kernel with K and V staged in the
    operand type) -> (B, L, D); q and the two halves of kv are read in place."""
    b, l, d = q.shape
    if kv.shape != (b, l, 2 * d) or kv.dtype != q.dtype or kv.device != q.device:
        raise ValueError(
            f"fused_mha_qtile: kv {tuple(kv.shape)} {kv.dtype} for q {tuple(q.shape)} {q.dtype}"
        )
    itemsize = q.element_size()
    dh = _check_kernel_shape(
        "fused_mha_qtile", q, d, num_heads, lambda dh: mha_smem_bytes(l, dh, itemsize)
    )
    q_strides = _strides("fused_mha_qtile", q, q.shape)
    kv_strides = _strides("fused_mha_qtile", kv, kv.shape)
    out = torch.empty((b, l, d), dtype=q.dtype, device=q.device)
    ptr = ctypes.c_void_p
    err = load_library().acl_mha_qtile_fwd(
        _DTYPE_CODES[q.dtype], ptr(q.data_ptr()), *q_strides, ptr(kv.data_ptr()), *kv_strides,
        ptr(out.data_ptr()), b, l, num_heads, dh, 1.0 / math.sqrt(dh), _stream(q),
    )
    _raise_on_error("fused_mha_qtile", err)
    launch_counts["fused_mha_qtile"] += 1
    return out


def flash_fwd_kernel(q, k, v, save_lse: bool):
    """K8: launch ``acl_flash_fwd`` over (N, L, dh) -> out (N, L, dh), or (out,
    lse) with the (N, L) fp32 log-sum-exp; q, k, v are read in place."""
    _check_bld("flash_attention_heads", q, k, v)
    n, l, dh = q.shape
    itemsize = q.element_size()
    _check_kernel_shape(
        "flash_attention_heads", q, dh, 1, lambda dh: flash_smem_bytes(dh, itemsize)
    )
    strides = [_strides("flash_attention_heads", t, q.shape) for t in (q, k, v)]
    out = torch.empty((n, l, dh), dtype=q.dtype, device=q.device)
    lse = torch.empty((n, l), dtype=torch.float32, device=q.device) if save_lse else None
    ptr = ctypes.c_void_p
    err = load_library().acl_flash_fwd(
        _DTYPE_CODES[q.dtype],
        ptr(q.data_ptr()), *strides[0],
        ptr(k.data_ptr()), *strides[1],
        ptr(v.data_ptr()), *strides[2],
        ptr(out.data_ptr()), ptr(lse.data_ptr() if save_lse else None),
        n, l, dh, 1.0 / math.sqrt(dh), _stream(q),
    )
    _raise_on_error("flash_attention_heads", err)
    launch_counts["flash_attention_heads"] += 1
    return (out, lse) if save_lse else out


def fused_attention_fwd_kernel(q, k, v, causal: bool) -> torch.Tensor:
    """K5's whole-block branch: K2's kernel (``acl_mha_bld_fwd``) with the heads
    folded into the batch, one head per entry -> (B, H, L, Dh)."""
    b, h, l, dh = q.shape
    folded = [t.reshape(b * h, l, dh) for t in (q, k, v)]
    out = _launch_mha_bld("fused_attention", *folded, 1, causal)
    launch_counts["fused_attention"] += 1
    return out.reshape(b, h, l, dh)


# ---------------------------------------------------------------------------
# Autograd entries
# ---------------------------------------------------------------------------


class _MhaQkv(torch.autograd.Function):
    """K1 forward, K3 backward; saves only qkv, as ``_mha_qkv_fwd`` (:479-480)."""

    @staticmethod
    def forward(ctx, qkv, num_heads, causal):
        ctx.reference = _use_reference(qkv)  # the caller's choice, kept for backward
        ctx.num_heads, ctx.causal = num_heads, causal
        ctx.save_for_backward(qkv)
        if ctx.reference:
            return mha_qkv_reference(qkv, num_heads, causal)
        return mha_qkv_fwd_kernel(qkv, num_heads, causal)

    @staticmethod
    def backward(ctx, g):
        (qkv,) = ctx.saved_tensors
        if ctx.reference:
            dqkv = mha_qkv_bwd_reference(qkv, g, ctx.num_heads, ctx.causal)
        else:
            dqkv = mha_qkv_bwd_kernel(qkv, g, ctx.num_heads, ctx.causal)
        return dqkv, None, None


class _MhaBld(torch.autograd.Function):
    """K2 forward, K4 backward; saves q, k, v, as ``_mha_bld_fwd`` (:400-401).
    When k and v are views of one tensor, autograd adds dk and dv into its
    gradient."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads, causal):
        ctx.reference = _use_reference(q)  # the caller's choice, kept for backward
        ctx.num_heads, ctx.causal = num_heads, causal
        ctx.save_for_backward(q, k, v)
        if ctx.reference:
            return mha_bld_reference(q, k, v, num_heads, causal)
        return mha_bld_fwd_kernel(q, k, v, num_heads, causal)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        if ctx.reference:
            grads = mha_bld_bwd_reference(q, k, v, g, ctx.num_heads, ctx.causal)
        else:
            grads = mha_bld_bwd_kernel(q, k, v, g, ctx.num_heads, ctx.causal)
        return (*grads, None, None)


def fused_mha_qkv(qkv: torch.Tensor, num_heads: int, causal: bool = False) -> torch.Tensor:
    """Attention over a packed (B, L, 3D) qkv (lane order q|k|v, the layout of
    ``x @ qkv_w``) -> (B, L, D). Heads are split inside the kernels; the
    gradient is one packed (B, L, 3D) tensor."""
    return _MhaQkv.apply(qkv, num_heads, causal)


def fused_mha_bld(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int, causal: bool = False
) -> torch.Tensor:
    """Attention over (B, L, D) q, k, v -> (B, L, D). k and v may be views, e.g.
    the two halves of one (B, L, 2D) projection: the kernels read them in place."""
    return _MhaBld.apply(q, k, v, num_heads, causal)


class _ForwardOnly(torch.autograd.Function):
    """A forward kernel whose backward kernel is not ported yet: the gradient
    raises instead of flowing silently past a ctypes launch."""

    @staticmethod
    def forward(ctx, launch, missing, *tensors):
        ctx.missing = missing
        return launch(*tensors)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            f"{ctx.missing} is not ported yet: the kernel path of this entry is "
            "forward-only (its plain version under attention_impl('reference') "
            "is differentiable)"
        )


def fused_mha_qtile(q: torch.Tensor, kv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Non-causal attention of q (B, L, D) against the packed k|v (B, L, 2D) ->
    (B, L, D), K and V of each head resident in the kernel's shared memory.
    Forward-only on the card (its backward, K7, is not ported yet)."""
    if _use_reference(q):
        return mha_qtile_reference(q, kv, num_heads)
    return _ForwardOnly.apply(
        lambda q_, kv_: mha_qtile_fwd_kernel(q_, kv_, num_heads),
        "K7 (the q-tiled backward, _mha_qtile_bwd_kernel)", q, kv,
    )


def flash_attention_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, save_lse: bool = False):
    """Attention over per-head (N, L, dh) q, k, v with KV-blocked online softmax
    (shared memory independent of L) -> out (N, L, dh), or (out, lse) with the
    (N, L) fp32 log-sum-exp. Non-causal. Forward-only on the card (its
    backward, K9 and K10, is not ported yet)."""
    if _use_reference(q):
        return flash_attention_reference(q, k, v, save_lse)
    return _ForwardOnly.apply(
        lambda *t: flash_fwd_kernel(*t, save_lse),
        "K9 and K10 (the flash backward, _flash_dq_kernel and _flash_dkv_kernel)", q, k, v,
    )


def fused_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False
) -> torch.Tensor:
    """Attention over per-head (B, H, L, Dh) -> (B, H, L, Dh), routed as
    ``_fused_attention_impl`` (:1121-1135) routes, with the card's limits:

    - the whole-block kernel (K2's, heads folded into the batch) where its
      shared memory fits the card;
    - else, for non-causal shapes, ``flash_attention_heads`` (K8);
    - else the plain version on the CPU; on the card it raises: no kernel takes
      a causal shape past the whole-block kernel, and no supported model has one.

    Forward-only on the card (the whole-block backward, K4 with the heads
    folded, is not joined to it yet)."""
    b, h, l, dh = q.shape
    if mha_smem_bytes(l, dh) <= smem_limit(q.device):
        if _use_reference(q):
            return fused_attention_reference(q, k, v, causal)
        return _ForwardOnly.apply(
            lambda *t: fused_attention_fwd_kernel(*t, causal),
            "fused_attention's backward (K4 with the heads folded)", q, k, v,
        )
    if not causal:
        out = flash_attention_heads(*(t.reshape(b * h, l, dh) for t in (q, k, v)))
        return out.reshape(b, h, l, dh)
    if _use_reference(q):
        return fused_attention_reference(q, k, v, causal)
    raise ValueError(
        f"fused_attention: causal shape {tuple(q.shape)} needs {mha_smem_bytes(l, dh)} B of "
        f"shared memory per block for the whole-block kernel, the card gives "
        f"{smem_limit(q.device)}, and the flash kernel is non-causal"
    )
