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
  (``_mha_qtile_kernel``, :525-532, 626). The ViT-L/14@336px tower in bf16. Its
  gradient is ``_mha_qtile_bwd_kernel`` (:646-708): dq and a packed dk|dv.
- ``flash_attention_heads``: KV-blocked online softmax over per-head (N, L, dh)
  (``_flash_kernel``, :800-854, 1056), optionally with the log-sum-exp. Its
  gradient is ``_flash_dq_kernel`` and ``_flash_dkv_kernel`` (:904-993), with P
  rebuilt from the saved log-sum-exp.
- ``fused_attention``: per-head (B, H, L, Dh) (``_attn_kernel``, :1089-1093,
  1152), routed as ``_fused_attention_impl`` routes (:1121-1135). The
  ViT-L/14@336px tower in fp32 enters here and goes on to the flash kernel. Its
  gradient is the whole-block backward with the heads folded (:1171-1181).

The forwards compute the function of ``_attend_head`` (:68-85): fp32 scores, a
row-max-subtracted fp32 softmax, masked entries at ``NEG_INF``. The backwards
compute the exact softmax VJP of ``_mha_bwd_head`` (:244-270), scores recomputed
from q and k. Each entry is a ``torch.autograd.Function``: on a CUDA tensor each
direction launches its kernel (ops/csrc/*.cu, built by ops/build.py) or raises;
on a CPU tensor both run the plain versions.
``attention_impl("reference")`` makes the wrappers run the plain versions on the
card too, so that tests and the chip smoke run can hold the kernels against
them. The choice is read when the forward runs and kept for its backward, which
autograd runs on another thread.

Which kernel fits a shape is a matter of shared memory. The formulas of what a
block of each kernel needs live here (K1, K2 and K6 share one whole-row kernel
and one formula, with K and V staged as fp32 or in the operand type), one
source of truth for the wrappers' checks, for the dispatch ladder
(models/clip/model.py: ``attention_rung``) and
for the backward's routing (``attention_bwd_route``: the whole-head kernel of
mha_bwd.cu where its L x L tiles fit, the KV-blocked pair of mha_blocked_bwd.cu
past it); the library reports its own (``acl_*_smem_bytes``), and the chip smoke
run holds the two against each other.

The kernels that the measurement scripts launch themselves (other tilings of
the whole-row kernel, KV parts, head pairs, no softmax) are in
ops/attention_probes.py.
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
# where its kernel launches: "fused_attention" counts its whole-block kernel in
# either direction; its flash branch launches K8, which counts under
# "flash_attention_heads", and that entry's backward under "flash_dq" and
# "flash_dkv". A backward entry counts once whichever kernel its route takes.
launch_counts = {
    "fused_mha_qkv": 0, "fused_mha_bld": 0, "mha_qkv_bwd": 0, "mha_bld_bwd": 0,
    "fused_mha_qtile": 0, "flash_attention_heads": 0, "fused_attention": 0,
    "mha_qtile_bwd": 0, "flash_dq": 0, "flash_dkv": 0,
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


def mha_qtile_bwd_reference(q, kv, g, num_heads: int) -> tuple:
    """(dq (B, L, D), dkv (B, L, 2D)) of ``mha_qtile_reference`` for its output
    gradient g, rounded as ``_mha_qtile_bwd_kernel`` (:646-708) rounds: P
    normalised in fp32, delta = rowsum(P o dP), dS cast to q's type and P to v's
    before the second-stage products (``attention_bwd_reference``)."""
    d = q.shape[-1]
    dq, dk, dv = mha_bld_bwd_reference(q, kv[..., :d], kv[..., d:], g, num_heads)
    return dq, torch.cat([dk, dv], dim=-1)


def fused_attention_reference(q, k, v, causal: bool = False) -> torch.Tensor:
    """``fused_attention``'s whole-block kernel (:1089-1093) over (B, H, L, Dh)."""
    return attention_reference(q, k, v, causal)


# keys per KV block of the flash kernel (mha_long.cu: kBlockKV)
FLASH_BLOCK_KV = 128


def flash_attention_reference(q, k, v, save_lse: bool = False, block: int = FLASH_BLOCK_KV):
    """``_flash_kernel`` (:800-854) over per-head (N, L, dh): per KV block of
    ``block`` keys (K8's ``FLASH_BLOCK_KV``) the running max, the rescale alpha = exp(m_old -
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
    for start in range(0, l, block):
        kb, vb = k[:, start : start + block], v[:, start : start + block]
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


def flash_delta(g, out) -> torch.Tensor:
    """rowsum(g o out) in fp32, (N, L): the flash backward's delta, one
    elementwise pass outside the kernels, as ``_flash_bwd_impl`` (:1013-1016)."""
    return (g.float() * out.float()).sum(dim=-1)


def _flash_p_and_ds(q, k, v, g, lse, delta) -> tuple:
    """fp32 (P, dS, g) of the flash backward from the (N, L) fp32 log-sum-exp and
    delta: P = exp(s - lse), not renormalised; dS = P o (dP - delta) * scale,
    rounded to q's type."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    g = g.to(q.dtype).float()
    scores = torch.einsum("nqd,nkd->nqk", q.float(), k.float()) * scale
    p = torch.exp(scores - lse.unsqueeze(-1))
    dp = torch.einsum("nqd,nkd->nqk", g, v.float())
    return p, (p * (dp - delta.unsqueeze(-1)) * scale).to(q.dtype).float(), g


def flash_dq_reference(q, k, v, g, lse, delta) -> torch.Tensor:
    """``_flash_dq_kernel`` (:904-940) over per-head (N, L, dh): dq = dS K, dS
    cast to q's type first, summed in fp32."""
    _, ds, _ = _flash_p_and_ds(q, k, v, g, lse, delta)
    return torch.einsum("nqk,nkd->nqd", ds, k.float()).to(q.dtype)


def flash_dkv_reference(q, k, v, g, lse, delta) -> tuple:
    """``_flash_dkv_kernel`` (:943-993): dk = dS^T q and dv = P^T g, dS cast to
    q's type and P to v's type first, summed in fp32."""
    p, ds, g = _flash_p_and_ds(q, k, v, g, lse, delta)
    dk = torch.einsum("nqk,nqd->nkd", ds, q.float())
    dv = torch.einsum("nqk,nqd->nkd", p.to(v.dtype).float(), g)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_reference(q, k, v, g, lse, out) -> tuple:
    """(dq, dk, dv) of ``flash_attention_reference`` as ``_flash_bwd`` (:1076-1078)
    computes them: g cast to q's type first, delta = rowsum(g o out) in fp32
    from the *rounded* output, then the dq pass and the dk, dv pass. In bf16
    this differs from ``attention_bwd_reference``, which takes delta from
    P o dP."""
    g = g.to(q.dtype)
    delta = flash_delta(g, out)
    return (flash_dq_reference(q, k, v, g, lse, delta), *flash_dkv_reference(q, k, v, g, lse, delta))


# ---------------------------------------------------------------------------
# Shared memory per block of each kernel, in bytes: the same formulas as the
# kernels' own smem_bytes (mha.cu, mha_bwd.cu, mha_long.cu, mha_blocked_bwd.cu)
# ---------------------------------------------------------------------------

_KERNEL_WARPS = 8
_KERNEL_ROWS = 64  # query rows per block of the forward kernels
# what an H100 gives one block (cudaDevAttrMaxSharedMemoryPerBlockOptin); the
# limit the dispatch takes for tensors on the CPU, so that a CPU run takes the
# card's rungs
H100_SMEM_OPTIN = 232_448


def mha_smem_bytes(l: int, dh: int, itemsize: int = 4, warps: int = _KERNEL_WARPS) -> int:
    """The whole-row kernel (mha.cu): K (padded by one 32-bit word) and V of the
    head staged in ``itemsize``-byte elements, the warps' fp32 exponent rows and
    query rows. K1 and K2 stage as fp32 (the default); K6 in the operand type.
    ``warps`` other than the kernels' eight: the probes (ops/attention_probes.py)."""
    kv = itemsize * (l * (dh + 4 // itemsize) + l * dh)
    return kv + 4 * warps * (l + dh)


def mha_bwd_smem_bytes(l: int, dh: int) -> int:
    """K3 and K4 (mha_bwd.cu): Q, K, V, G padded, P and dS as L x L, all fp32."""
    return 4 * (4 * l * (dh + 1) + 2 * l * l)


def flash_smem_bytes(dh: int, itemsize: int) -> int:
    """K8 (mha_long.cu): one KV block in the operand type (K padded), the warps'
    fp32 exponent rows, the fp32 q tile and accumulators, the running max and
    sum per row. Independent of L."""
    kv = itemsize * (FLASH_BLOCK_KV * (dh + 4 // itemsize) + FLASH_BLOCK_KV * dh)
    return kv + 4 * (_KERNEL_WARPS * FLASH_BLOCK_KV + 2 * _KERNEL_ROWS * dh + 2 * _KERNEL_ROWS)


# keys per KV block of the blocked backward kernels (mha_blocked_bwd.cu: kBwdKV)
BWD_BLOCK_KV = 64


def blocked_bwd_smem_bytes(dh: int, itemsize: int) -> int:
    """K7, K9, K10 and the long shapes of K3, K4 and K5's backward
    (mha_blocked_bwd.cu), either kernel: fp32 q and g rows, the P and dS tiles,
    the tile's row statistics, one KV block in the operand type with K and V
    both padded. Independent of L."""
    tiles = 2 * _KERNEL_ROWS * dh + 2 * _KERNEL_ROWS * BWD_BLOCK_KV + 3 * _KERNEL_ROWS
    return 4 * tiles + itemsize * 2 * BWD_BLOCK_KV * (dh + 4 // itemsize)


def attention_bwd_route(
    l: int, dh: int, itemsize: int, causal: bool, smem: int = H100_SMEM_OPTIN
) -> str:
    """Which kernel the whole-block backward entries (K3, K4, and K5's backward)
    launch at sequence length ``l`` and head dim ``dh``, given ``smem`` bytes of
    shared memory a block: "whole" (mha_bwd.cu) where its L x L tiles fit,
    "blocked" (mha_blocked_bwd.cu, with the row statistics recomputed) for
    non-causal shapes past it. A causal shape past it raises, as the forward
    does: no supported model has one (the causal text towers are L=77). A pure
    function of the shape, so a CPU test holds it."""
    if mha_bwd_smem_bytes(l, dh) <= smem:
        return "whole"
    if not causal and blocked_bwd_smem_bytes(dh, itemsize) <= smem:
        return "blocked"
    blocked = (
        "the KV-blocked backward is non-causal" if causal
        else f"the KV-blocked backward needs {blocked_bwd_smem_bytes(dh, itemsize)} B"
    )
    raise ValueError(
        f"attention backward: {'causal ' if causal else ''}shape (L={l}, dh={dh}) needs "
        f"{mha_bwd_smem_bytes(l, dh)} B of shared memory per block for the whole-block "
        f"kernel, the card gives {smem}, and {blocked}"
    )


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
# the whole-row forward (mha.cu) and the whole-head backward (mha_bwd.cu) also
# take 16: the temporal model at emb 128 with 8 heads
_WHOLE_HEAD_DIMS = (16, 32, 64)
_INT_MAX = 2**31 - 1


def _use_reference(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"fused attention takes CPU or CUDA tensors, not {t.device}")
    return _IMPL.get() == "reference"


def _check_kernel_shape(
    name: str, t: torch.Tensor, d: int, num_heads: int, smem_need, head_dims=_HEAD_DIMS
) -> int:
    """Raise, with the shape, on what the CUDA kernel does not take -> head dim.
    ``smem_need(dh)`` is the shared memory one block needs at this shape."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: the kernel takes CUDA tensors, not {t.device}")
    if t.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: dtype {t.dtype} not supported (float32, bfloat16)")
    if d % num_heads or d // num_heads not in head_dims:
        raise ValueError(
            f"{name}: shape {tuple(t.shape)} with {num_heads} heads gives head dim "
            f"{d / num_heads:g}; the kernel takes {head_dims}"
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
        "fused_mha_qkv", qkv, d, num_heads, lambda dh: mha_smem_bytes(l, dh), _WHOLE_HEAD_DIMS
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
    dh = _check_kernel_shape(
        name, q, d, num_heads, lambda dh: mha_smem_bytes(l, dh), _WHOLE_HEAD_DIMS
    )
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


def _heads_view(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, L, H*dh) -> its (B, H, L, dh) view, no copy (``t`` may itself be a
    column slice of a packed projection)."""
    return t.unflatten(-1, (num_heads, t.shape[-1] // num_heads)).transpose(1, 2)


def _blocked_args(name: str, tensors) -> tuple:
    """(B, H, L, dh) views -> the pointer and (batch, head, row) stride arrays
    ``acl_blocked_dq`` and ``acl_blocked_dkv`` take."""
    ptrs, strides = [], []
    for t in tensors:
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: shape {tuple(t.shape)}: the last dimension must be contiguous")
        ptrs.append(t.data_ptr())
        strides.extend(t.stride()[:3])
    return (ctypes.c_void_p * len(ptrs))(*ptrs), (ctypes.c_int64 * len(strides))(*strides)


def _check_blocked(name: str, q, k, v, g) -> None:
    """Raise on what the KV-blocked backward kernels do not take."""
    _check_bld(name, q, k, v)
    b, h, l, dh = q.shape
    itemsize = q.element_size()
    _check_kernel_shape(name, q, dh, 1, lambda dh: blocked_bwd_smem_bytes(dh, itemsize))
    if g.shape != q.shape or g.dtype != q.dtype or g.device != q.device:
        raise ValueError(
            f"{name}: gradient {tuple(g.shape)} {g.dtype} for q {tuple(q.shape)} {q.dtype}"
        )
    if h > 65535 or l > _INT_MAX:
        raise ValueError(f"{name}: shape {tuple(q.shape)} is beyond the launch grid")


def _launch_blocked_dq(name: str, q, k, v, g, dq, m, l, delta, recompute: bool) -> None:
    """Launch ``acl_blocked_dq`` over (B, H, L, dh) views for entry ``name``; the
    (B, H, L) fp32 statistics m, l, delta are written when ``recompute``, else
    read (l may be None: then 1). Counts nothing."""
    b, h, seq, dh = q.shape
    ptrs, strides = _blocked_args(name, (q, k, v, g, dq))
    ptr = ctypes.c_void_p
    err = load_library().acl_blocked_dq(
        _DTYPE_CODES[q.dtype], ptrs, strides, ptr(m.data_ptr()),
        ptr(None if l is None else l.data_ptr()), ptr(delta.data_ptr()), int(recompute),
        b, h, seq, dh, 1.0 / math.sqrt(dh), _stream(q),
    )
    _raise_on_error(name, err)


def _launch_blocked_dkv(name: str, q, k, v, g, dk, dv, m, l, delta) -> None:
    """Launch ``acl_blocked_dkv`` over (B, H, L, dh) views for entry ``name``,
    reading the statistics. Counts nothing."""
    b, h, seq, dh = q.shape
    ptrs, strides = _blocked_args(name, (q, k, v, g, dk, dv))
    ptr = ctypes.c_void_p
    err = load_library().acl_blocked_dkv(
        _DTYPE_CODES[q.dtype], ptrs, strides, ptr(m.data_ptr()),
        ptr(None if l is None else l.data_ptr()), ptr(delta.data_ptr()),
        b, h, seq, dh, 1.0 / math.sqrt(dh), _stream(q),
    )
    _raise_on_error(name, err)


def _blocked_bwd_recompute(name: str, q, k, v, g, dq, dk, dv) -> None:
    """The KV-blocked backward with the row statistics rebuilt by the dq pass
    (row max, row sum, delta = rowsum(P o dP): the whole-block backwards'
    rounding) and handed to the dkv pass, all over (B, H, L, dh) views; the
    gradients are written into dq, dk, dv. Counts nothing."""
    _check_blocked(name, q, k, v, g)
    b, h, l, _ = q.shape
    m, row_sum, delta = torch.empty((3, b, h, l), dtype=torch.float32, device=q.device)
    _launch_blocked_dq(name, q, k, v, g, dq, m, row_sum, delta, recompute=True)
    _launch_blocked_dkv(name, q, k, v, g, dk, dv, m, row_sum, delta)


def _bwd_route(name: str, t: torch.Tensor, l: int, d: int, num_heads: int, causal: bool) -> str:
    """``attention_bwd_route`` for a kernel launch, after the dtype and head-dim
    checks every backward kernel shares."""
    _check_kernel_shape(name, t, d, num_heads, lambda dh: 0, _WHOLE_HEAD_DIMS)
    return attention_bwd_route(l, d // num_heads, t.element_size(), causal, smem_limit(t.device))


def mha_qkv_bwd_kernel(qkv, g, num_heads: int, causal: bool) -> torch.Tensor:
    """K3: the packed (B, L, 3D) dqkv, from ``acl_mha_qkv_bwd`` where the
    whole-head kernel's shared memory fits, else from the KV-blocked pair."""
    b, l, d3 = qkv.shape
    d = d3 // 3
    route = _bwd_route("mha_qkv_bwd", qkv, l, d, num_heads, causal)
    if g.shape != (b, l, d) or g.device != qkv.device:
        raise ValueError(f"mha_qkv_bwd: gradient {tuple(g.shape)} for qkv {tuple(qkv.shape)}")
    g = g.to(qkv.dtype).contiguous()
    dqkv = torch.empty((b, l, d3), dtype=qkv.dtype, device=qkv.device)
    if route == "blocked":
        views = [_heads_view(t, num_heads) for t in (*_unpack_qkv(qkv), g, *_unpack_qkv(dqkv))]
        _blocked_bwd_recompute("mha_qkv_bwd", *views)
    else:
        dh = d // num_heads
        bs, rs = _strides("mha_qkv_bwd", qkv, qkv.shape)
        ptr = ctypes.c_void_p
        err = load_library().acl_mha_qkv_bwd(
            _DTYPE_CODES[qkv.dtype], ptr(qkv.data_ptr()), bs, rs, ptr(g.data_ptr()),
            ptr(dqkv.data_ptr()), b, l, num_heads, dh, int(causal), 1.0 / math.sqrt(dh),
            _stream(qkv),
        )
        _raise_on_error("mha_qkv_bwd", err)
    launch_counts["mha_qkv_bwd"] += 1
    return dqkv


def _launch_mha_bld_bwd(name: str, q, k, v, g, num_heads: int, causal: bool) -> tuple:
    """(dq, dk, dv), each (B, L, D), for entry ``name``: ``acl_mha_bld_bwd``
    where the whole-head kernel's shared memory fits, else the KV-blocked pair;
    q, k, v are read in place. Counts nothing."""
    _check_bld(name, q, k, v)
    b, l, d = q.shape
    route = _bwd_route(name, q, l, d, num_heads, causal)
    if g.shape != q.shape or g.device != q.device:
        raise ValueError(f"{name}: gradient {tuple(g.shape)} for q {tuple(q.shape)}")
    g = g.to(q.dtype).contiguous()
    dq, dk, dv = (torch.empty((b, l, d), dtype=q.dtype, device=q.device) for _ in range(3))
    if route == "blocked":
        _blocked_bwd_recompute(name, *(_heads_view(t, num_heads) for t in (q, k, v, g, dq, dk, dv)))
        return dq, dk, dv
    dh = d // num_heads
    strides = [_strides(name, t, q.shape) for t in (q, k, v, g)]
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
    _raise_on_error(name, err)
    return dq, dk, dv


def mha_bld_bwd_kernel(q, k, v, g, num_heads: int, causal: bool) -> tuple:
    """K4: (dq, dk, dv), each (B, L, D)."""
    grads = _launch_mha_bld_bwd("mha_bld_bwd", q, k, v, g, num_heads, causal)
    launch_counts["mha_bld_bwd"] += 1
    return grads


def fused_attention_bwd_kernel(q, k, v, g, causal: bool) -> tuple:
    """K5's whole-block backward over (B, H, L, Dh): K4's kernel with the heads
    folded into the batch (``_fused_attention_bwd``, :1171-1181) where its
    shared memory fits, else the KV-blocked pair on the four-dimensional views
    as they are."""
    b, h, l, dh = q.shape
    route = _bwd_route("fused_attention", q, l, dh, 1, causal)
    if route == "blocked":
        g = g.to(q.dtype).contiguous()
        grads = tuple(torch.empty((b, h, l, dh), dtype=q.dtype, device=q.device) for _ in range(3))
        _blocked_bwd_recompute("fused_attention", q, k, v, g, *grads)
    else:
        folded = [t.reshape(b * h, l, dh) for t in (q, k, v, g)]
        grads = _launch_mha_bld_bwd("fused_attention", *folded, 1, causal)
        grads = tuple(t.reshape(b, h, l, dh) for t in grads)
    launch_counts["fused_attention"] += 1
    return grads


def mha_qtile_bwd_kernel(q, kv, g, num_heads: int) -> tuple:
    """K7: launch the KV-blocked pair with the row statistics recomputed ->
    (dq (B, L, D), dkv (B, L, 2D)); q and the two halves of kv are read in
    place and the two halves of dkv written in place."""
    b, l, d = q.shape
    if kv.shape != (b, l, 2 * d) or kv.dtype != q.dtype or kv.device != q.device:
        raise ValueError(
            f"mha_qtile_bwd: kv {tuple(kv.shape)} {kv.dtype} for q {tuple(q.shape)} {q.dtype}"
        )
    _check_kernel_shape("mha_qtile_bwd", q, d, num_heads, lambda dh: 0)
    if g.shape != q.shape or g.device != q.device:
        raise ValueError(f"mha_qtile_bwd: gradient {tuple(g.shape)} for q {tuple(q.shape)}")
    g = g.to(q.dtype).contiguous()
    dq = torch.empty((b, l, d), dtype=q.dtype, device=q.device)
    dkv = torch.empty((b, l, 2 * d), dtype=q.dtype, device=q.device)
    tensors = (q, kv[..., :d], kv[..., d:], g, dq, dkv[..., :d], dkv[..., d:])
    _blocked_bwd_recompute("mha_qtile_bwd", *(_heads_view(t, num_heads) for t in tensors))
    launch_counts["mha_qtile_bwd"] += 1
    return dq, dkv


def _flash_bwd_views(q, k, v, g, lse, delta) -> tuple:
    """The (N, 1, L, dh) views and (N, 1, L) statistics the blocked kernels take."""
    n, l, dh = q.shape
    if lse.shape != (n, l) or delta.shape != (n, l):
        raise ValueError(
            f"flash backward: lse {tuple(lse.shape)} and delta {tuple(delta.shape)} for q {tuple(q.shape)}"
        )
    views = [t.unsqueeze(1) for t in (q, k, v, g.to(q.dtype).contiguous())]
    return views, lse.float().contiguous(), delta.float().contiguous()


def flash_dq_kernel(q, k, v, g, lse, delta) -> torch.Tensor:
    """K9: launch ``acl_blocked_dq`` with the given statistics over per-head
    (N, L, dh) -> dq (N, L, dh)."""
    views, lse, delta = _flash_bwd_views(q, k, v, g, lse, delta)
    _check_blocked("flash_dq", *views)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch_blocked_dq("flash_dq", *views, dq.unsqueeze(1), lse, None, delta, recompute=False)
    launch_counts["flash_dq"] += 1
    return dq


def flash_dkv_kernel(q, k, v, g, lse, delta) -> tuple:
    """K10: launch ``acl_blocked_dkv`` with the given statistics over per-head
    (N, L, dh) -> (dk, dv), each (N, L, dh)."""
    views, lse, delta = _flash_bwd_views(q, k, v, g, lse, delta)
    _check_blocked("flash_dkv", *views)
    dk, dv = (torch.empty(q.shape, dtype=q.dtype, device=q.device) for _ in range(2))
    _launch_blocked_dkv("flash_dkv", *views, dk.unsqueeze(1), dv.unsqueeze(1), lse, None, delta)
    launch_counts["flash_dkv"] += 1
    return dk, dv


def flash_bwd_kernel(q, k, v, g, lse, out) -> tuple:
    """K9 and K10: (dq, dk, dv) over per-head (N, L, dh) from the forward's
    saved log-sum-exp and output."""
    g = g.to(q.dtype).contiguous()
    delta = flash_delta(g, out)
    dq = flash_dq_kernel(q, k, v, g, lse, delta)
    return (dq, *flash_dkv_kernel(q, k, v, g, lse, delta))


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
        "fused_mha_qtile", q, d, num_heads, lambda dh: mha_smem_bytes(l, dh, itemsize),
        _WHOLE_HEAD_DIMS,
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


class _MhaQtile(torch.autograd.Function):
    """K6 forward, K7 backward; saves q and kv, as ``_mha_qtile_fwd`` (:642-643):
    the backward rebuilds the softmax rows from them."""

    @staticmethod
    def forward(ctx, q, kv, num_heads):
        ctx.reference = _use_reference(q)  # the caller's choice, kept for backward
        ctx.num_heads = num_heads
        ctx.save_for_backward(q, kv)
        if ctx.reference:
            return mha_qtile_reference(q, kv, num_heads)
        return mha_qtile_fwd_kernel(q, kv, num_heads)

    @staticmethod
    def backward(ctx, g):
        q, kv = ctx.saved_tensors
        if ctx.reference:
            dq, dkv = mha_qtile_bwd_reference(q, kv, g, ctx.num_heads)
        else:
            dq, dkv = mha_qtile_bwd_kernel(q, kv, g, ctx.num_heads)
        return dq, dkv, None


class _FlashHeads(torch.autograd.Function):
    """K8 forward, K9 and K10 backward. When a gradient is needed the forward
    runs with the log-sum-exp and saves q, k, v, lse and the output, as
    ``_flash_fwd`` (:1071-1073). -> (out, lse); lse is None when neither the
    caller nor the backward needs it."""

    @staticmethod
    def forward(ctx, q, k, v, save_lse):
        ctx.reference = _use_reference(q)  # the caller's choice, kept for backward
        needs_grad = any(ctx.needs_input_grad[:3])
        forward = flash_attention_reference if ctx.reference else flash_fwd_kernel
        if not (save_lse or needs_grad):
            return forward(q, k, v, False), None
        out, lse = forward(q, k, v, True)
        if needs_grad:
            ctx.save_for_backward(q, k, v, lse, out)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, g, _):
        q, k, v, lse, out = ctx.saved_tensors
        if ctx.reference:
            grads = flash_attention_bwd_reference(q, k, v, g, lse, out)
        else:
            grads = flash_bwd_kernel(q, k, v, g, lse, out)
        return (*grads, None)


class _FusedAttention(torch.autograd.Function):
    """K5's whole-block forward (K2's kernel, heads folded) and its backward
    (K4's kernel, heads folded, or the KV-blocked pair); saves q, k, v, as
    ``_fused_attention_fwd`` (:1167-1168)."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.reference = _use_reference(q)  # the caller's choice, kept for backward
        ctx.causal = causal
        ctx.save_for_backward(q, k, v)
        if ctx.reference:
            return fused_attention_reference(q, k, v, causal)
        return fused_attention_fwd_kernel(q, k, v, causal)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        if ctx.reference:
            grads = attention_bwd_reference(q, k, v, g, ctx.causal)
        else:
            grads = fused_attention_bwd_kernel(q, k, v, g, ctx.causal)
        return (*grads, None)


def fused_mha_qtile(q: torch.Tensor, kv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Non-causal attention of q (B, L, D) against the packed k|v (B, L, 2D) ->
    (B, L, D), K and V of each head resident in the kernel's shared memory. The
    gradient is dq and one packed (B, L, 2D) dk|dv."""
    return _MhaQtile.apply(q, kv, num_heads)


def flash_attention_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, save_lse: bool = False):
    """Attention over per-head (N, L, dh) q, k, v with KV-blocked online softmax
    (shared memory independent of L) -> out (N, L, dh), or (out, lse) with the
    (N, L) fp32 log-sum-exp. Non-causal. Differentiable in q, k, v (not through
    lse): the backward rebuilds P from the saved log-sum-exp."""
    out, lse = _FlashHeads.apply(q, k, v, save_lse)
    return (out, lse) if save_lse else out


def fused_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False
) -> torch.Tensor:
    """Attention over per-head (B, H, L, Dh) -> (B, H, L, Dh), routed as
    ``_fused_attention_impl`` (:1121-1135) routes, with the card's limits:

    - the whole-block kernel (K2's, heads folded into the batch) where its
      shared memory fits the card; its backward is ``attention_bwd_route``'s;
    - else, for non-causal shapes, ``flash_attention_heads`` (K8, and K9 and
      K10 in the backward);
    - else the plain version on the CPU; on the card it raises: no kernel takes
      a causal shape past the whole-block kernel, and no supported model has one."""
    b, h, l, dh = q.shape
    if mha_smem_bytes(l, dh) <= smem_limit(q.device):
        return _FusedAttention.apply(q, k, v, causal)
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
