"""Fused multi-head attention: the CUDA kernels of the main path and their plain
PyTorch versions, forward and backward.

Two entries, the counterparts of the JAX package's Pallas kernels
(anomalyclip_tpu/ops/pallas/attention.py):

- ``fused_mha_qkv``: attention from one packed (B, L, 3D) qkv projection, lane
  order q|k|v (``_mha_qkv_kernel``, :423-466). CLIP's image and text towers.
  Its gradient is ``_mha_qkv_bwd_kernel`` (:291-311, 362-382): a packed dqkv.
- ``fused_mha_bld``: the same from separate (B, L, D) q, k, v (``_mha_bld_kernel``,
  :88-96, 386). The temporal model's axial attention. Its gradient is
  ``_mha_bld_bwd_kernel`` (:273-288, 340-358): dq, dk, dv.

The forwards compute the function of ``_attend_head`` (:68-85): fp32 scores, a
row-max-subtracted fp32 softmax, masked entries at ``NEG_INF``. The backwards
compute the exact softmax VJP of ``_mha_bwd_head`` (:244-270), scores recomputed
from q and k. Each entry is a ``torch.autograd.Function``: on a CUDA tensor each
direction launches its kernel (ops/csrc/mha.cu, ops/csrc/mha_bwd.cu, built by
ops/build.py) or raises; on a CPU tensor both run the plain versions.
``attention_impl("reference")`` makes the wrappers run the plain versions on the
card too, so that tests and the chip smoke run can hold the kernels against
them. The choice is read when the forward runs and kept for its backward, which
autograd runs on another thread.
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

# kernel launches per entry since the last reset_launch_counts()
launch_counts = {"fused_mha_qkv": 0, "fused_mha_bld": 0, "mha_qkv_bwd": 0, "mha_bld_bwd": 0}

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


@functools.lru_cache(maxsize=None)
def _smem_bytes(entry: str, l: int, dh: int, device_index: int) -> tuple:
    """(shared memory one block of ``entry``'s kernel needs at (L, dh), what the
    card gives a block)."""
    need = getattr(load_library(), entry)(l, dh)
    have = torch.cuda.get_device_properties(device_index).shared_memory_per_block_optin
    return need, have


def _check_kernel_shape(
    name: str, t: torch.Tensor, l: int, d: int, num_heads: int, smem_entry: str
) -> int:
    """Raise, with the shape, on what the CUDA kernel does not take -> head dim."""
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
    need, have = _smem_bytes(smem_entry, l, dh, t.device.index)
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
    dh = _check_kernel_shape("fused_mha_qkv", qkv, l, d, num_heads, "acl_mha_smem_bytes")
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


def mha_bld_fwd_kernel(q, k, v, num_heads: int, causal: bool) -> torch.Tensor:
    """K2: launch ``acl_mha_bld_fwd`` -> (B, L, D); k and v are read in place."""
    _check_bld("fused_mha_bld", q, k, v)
    b, l, d = q.shape
    dh = _check_kernel_shape("fused_mha_bld", q, l, d, num_heads, "acl_mha_smem_bytes")
    strides = [_strides("fused_mha_bld", t, q.shape) for t in (q, k, v)]
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
    _raise_on_error("fused_mha_bld", err)
    launch_counts["fused_mha_bld"] += 1
    return out


def mha_qkv_bwd_kernel(qkv, g, num_heads: int, causal: bool) -> torch.Tensor:
    """K3: launch ``acl_mha_qkv_bwd`` -> the packed (B, L, 3D) dqkv."""
    b, l, d3 = qkv.shape
    d = d3 // 3
    dh = _check_kernel_shape("mha_qkv_bwd", qkv, l, d, num_heads, "acl_mha_bwd_smem_bytes")
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
    dh = _check_kernel_shape("mha_bld_bwd", q, l, d, num_heads, "acl_mha_bwd_smem_bytes")
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
