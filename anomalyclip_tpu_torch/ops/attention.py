"""Fused multi-head attention: the CUDA kernels of the main path and their plain
PyTorch versions.

Two entries, the counterparts of the JAX package's Pallas kernels
(anomalyclip_tpu/ops/pallas/attention.py):

- ``fused_mha_qkv``: attention from one packed (B, L, 3D) qkv projection, lane
  order q|k|v (``_mha_qkv_kernel``, :423-466). CLIP's image and text towers.
- ``fused_mha_bld``: the same from separate (B, L, D) q, k, v (``_mha_bld_kernel``,
  :88-96, 386). The temporal model's axial attention.

Both compute the function of ``_attend_head`` (:68-85): fp32 scores, a
row-max-subtracted fp32 softmax, masked entries at ``NEG_INF``. On a CUDA tensor
each wrapper launches its kernel (ops/csrc/mha.cu, built by ops/build.py) or
raises; on a CPU tensor it runs the plain version. ``attention_impl("reference")``
makes the wrappers run the plain version on the card too, so that tests and the
chip smoke run can hold the kernels against it.
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
launch_counts = {"fused_mha_qkv": 0, "fused_mha_bld": 0}

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
# rounded as _attend_head (:68-85) rounds
# ---------------------------------------------------------------------------


def attention_reference(q, k, v, causal: bool = False) -> torch.Tensor:
    """softmax(q k^T / sqrt(dh)) v over (B, H, L, Dh). Scores, row max and
    exponent are fp32; the unnormalised exponent is cast to v's type and summed
    against v in fp32; the divide is done on the output. In fp32 this is
    ``_xla_attention``; in bf16 it rounds where the kernels round."""
    dh = q.shape[-1]
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (1.0 / math.sqrt(dh))
    if causal:
        l = q.shape[2]
        mask = torch.ones((l, l), dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~mask, NEG_INF)
    e = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    out = torch.einsum("bhqk,bhkd->bhqd", e.to(v.dtype).float(), v.float())
    return (out / e.sum(dim=-1, keepdim=True)).to(q.dtype)


def mha_bld_reference(q, k, v, num_heads: int, causal: bool = False) -> torch.Tensor:
    b, l, d = q.shape

    def split(t):
        return t.reshape(b, l, num_heads, d // num_heads).transpose(1, 2)

    out = attention_reference(split(q), split(k), split(v), causal)
    return out.transpose(1, 2).reshape(b, l, d)


def mha_qkv_reference(qkv, num_heads: int, causal: bool = False) -> torch.Tensor:
    d = qkv.shape[-1] // 3
    return mha_bld_reference(
        qkv[..., :d], qkv[..., d : 2 * d], qkv[..., 2 * d :], num_heads, causal
    )


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64)
_INT_MAX = 2**31 - 1


def _use_reference(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"fused attention takes CPU or CUDA tensors, not {t.device}")
    if _IMPL.get() == "reference":
        return True
    if t.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError(
            "the CUDA attention kernels have no backward yet (the TPU backward "
            "kernels are still to port); call them under torch.no_grad()"
        )
    return False


@functools.lru_cache(maxsize=None)
def _smem_bytes(l: int, dh: int, device_index: int) -> tuple:
    """(shared memory one block needs at (L, dh), what the card gives a block)."""
    need = load_library().acl_mha_smem_bytes(l, dh)
    have = torch.cuda.get_device_properties(device_index).shared_memory_per_block_optin
    return need, have


def _check_kernel_shape(name: str, t: torch.Tensor, l: int, d: int, num_heads: int) -> int:
    """Raise, with the shape, on what the CUDA kernel does not take -> head dim."""
    if t.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: dtype {t.dtype} not supported (float32, bfloat16)")
    if d % num_heads or d // num_heads not in _HEAD_DIMS:
        raise ValueError(
            f"{name}: shape {tuple(t.shape)} with {num_heads} heads gives head dim "
            f"{d / num_heads:g}; the kernel takes {_HEAD_DIMS}"
        )
    dh = d // num_heads
    need, have = _smem_bytes(l, dh, t.device.index)
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


def _raise_on_error(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with cudaError {err}")


def fused_mha_qkv(qkv: torch.Tensor, num_heads: int, causal: bool = False) -> torch.Tensor:
    """Attention over a packed (B, L, 3D) qkv (lane order q|k|v, the layout of
    ``x @ qkv_w``) -> (B, L, D). Heads are split inside the kernel."""
    if _use_reference(qkv):
        return mha_qkv_reference(qkv, num_heads, causal)
    b, l, d3 = qkv.shape
    d = d3 // 3
    dh = _check_kernel_shape("fused_mha_qkv", qkv, l, d, num_heads)
    bs, rs = _strides("fused_mha_qkv", qkv, qkv.shape)
    out = torch.empty((b, l, d), dtype=qkv.dtype, device=qkv.device)
    err = load_library().acl_mha_qkv_fwd(
        _DTYPE_CODES[qkv.dtype], ctypes.c_void_p(qkv.data_ptr()), bs, rs,
        ctypes.c_void_p(out.data_ptr()), b, l, num_heads, dh, int(causal),
        1.0 / math.sqrt(dh), ctypes.c_void_p(torch.cuda.current_stream(qkv.device).cuda_stream),
    )
    _raise_on_error("fused_mha_qkv", err)
    launch_counts["fused_mha_qkv"] += 1
    return out


def fused_mha_bld(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int, causal: bool = False
) -> torch.Tensor:
    """Attention over (B, L, D) q, k, v -> (B, L, D). k and v may be views, e.g.
    the two halves of one (B, L, 2D) projection: the kernel reads them in place."""
    if _use_reference(q):
        return mha_bld_reference(q, k, v, num_heads, causal)
    b, l, d = q.shape
    if k.shape != q.shape or v.shape != q.shape or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"fused_mha_bld: q, k, v must agree: {tuple(q.shape)} {q.dtype}, "
            f"{tuple(k.shape)} {k.dtype}, {tuple(v.shape)} {v.dtype}"
        )
    if k.device != q.device or v.device != q.device:
        raise ValueError("fused_mha_bld: q, k, v must be on one device")
    dh = _check_kernel_shape("fused_mha_bld", q, l, d, num_heads)
    strides = [_strides("fused_mha_bld", t, q.shape) for t in (q, k, v)]
    out = torch.empty((b, l, d), dtype=q.dtype, device=q.device)
    ptr = ctypes.c_void_p
    err = load_library().acl_mha_bld_fwd(
        _DTYPE_CODES[q.dtype],
        ptr(q.data_ptr()), *strides[0],
        ptr(k.data_ptr()), *strides[1],
        ptr(v.data_ptr()), *strides[2],
        ptr(out.data_ptr()), b, l, num_heads, dh, int(causal), 1.0 / math.sqrt(dh),
        ptr(torch.cuda.current_stream(q.device).cuda_stream),
    )
    _raise_on_error("fused_mha_bld", err)
    launch_counts["fused_mha_bld"] += 1
    return out
