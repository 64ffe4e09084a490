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
  (``_flash_kernel``, :800-854, 1056), optionally with the log-sum-exp, and here
  with an optional causal mask. Its gradient is ``_flash_dq_kernel`` and
  ``_flash_dkv_kernel`` (:904-993), with P rebuilt from the saved log-sum-exp.
- ``fused_attention``: per-head (B, H, L, Dh) (``_attn_kernel``, :1089-1093,
  1152), routed as ``_fused_attention_impl`` routes (:1121-1135). The
  ViT-L/14@336px tower in fp32 enters here and goes on to the flash kernel, as
  does a causal shape too long for the whole-block kernel, which the reference
  sends to its XLA formulation (:1135); that branch hands the kernels the
  four-dimensional views as they are. Its gradient is the whole-block backward
  with the heads folded (:1171-1181).

The forwards compute the function of ``_attend_head`` (:68-85): fp32 scores, a
row-max-subtracted fp32 softmax, masked entries at ``NEG_INF``. The backwards
compute the exact softmax VJP of ``_mha_bwd_head`` (:244-270), scores recomputed
from q and k. Each entry is a ``torch.library.custom_op`` (namespace
"anomalyclip", ``REGISTERED_OPS``) with a fake implementation, so that
``torch.export`` records it in a graph (export.py), and its backward registered
through ``register_autograd``: on a CUDA tensor each direction launches its
kernel (ops/csrc/*.cu, built by ops/build.py) or raises; on a CPU tensor both
run the plain versions.
``attention_impl("reference")`` makes the wrappers run the plain versions on the
card too, so that tests and the chip smoke run can hold the kernels against
them; outside any such scope the environment variable ``ANOMALYCLIP_ATTN_IMPL``
(``kernel`` | ``reference``) chooses. The choice is read when the forward runs
and kept for its backward, which autograd runs on another thread.

Which kernel serves which operands. ``fused_mha_qkv``, ``fused_mha_qtile`` and
``flash_attention_heads`` launch one of several kernels, chosen by the wrapper
from the operand type and the head dim before the launch:

- K1: ``acl_mha_qkv_tc_fwd`` (mha_tc.cu) in bf16 at head dim 64,
  ``acl_mha_qkv_tf32_fwd`` (mha_tf32.cu) in fp32 at head dim 64,
  ``acl_mha_qkv_fwd`` (mha.cu) at head dims 8, 16, 32;
- K6: ``acl_mha_qtile_tc_fwd``, ``acl_mha_qtile_tf32_fwd``, ``acl_mha_qtile_fwd``
  (mha.cu), in the same order;
- K8: ``acl_flash_tc_fwd``, ``acl_flash_tf32_fwd``, ``acl_flash_fwd``
  (mha_long.cu), in the same order.

- K2: ``acl_mha_bld_tf32_fwd`` (mha_bld_tf32.cu) in fp32 at head dims 16 and
  32 with L <= 32 (the temporal model's axial attention), ``acl_mha_bld_fwd``
  (mha.cu) everything else; its backward K4 ``acl_mha_bld_tf32_bwd`` at the
  same shapes, ``acl_mha_bld_bwd`` (mha_bwd.cu) or the KV-blocked pair past
  them (``mha_bld_tf32_eligible``).
- K3, K4 and K5's backward (heads folded) in fp32 at head dim 64 with
  L <= 112: the split-TF32 whole-head kernel of mha_whole_tf32_bwd.cu
  (``acl_mha_qkv_whole_tf32_bwd`` for the packed qkv,
  ``acl_mha_bld_whole_tf32_bwd`` for separate operands;
  ``mha_whole_tf32_eligible``), the text tower's CoOp gradient; bf16, the
  smaller head dims and 112 < L <= 117 keep mha_bwd.cu.
- K5's whole-block forward: at head dim 64 K8's tensor-core entries
  (``acl_flash_tc_fwd`` in bf16, ``acl_flash_tf32_fwd`` in fp32) on the
  (B, H, L, Dh) views in place, without the log-sum-exp; at head dims 8, 16
  and 32 K2's ``acl_mha_bld_fwd`` (mha.cu) with the heads folded.

mha_tc.cu is the tensor-core kernel (``mma.sync`` products, P in registers, K
and V in blocks of ``MHA_TC_BLOCK_KV`` keys with online softmax: every CLIP
tower in bf16, and the bf16 core rung); mha_tf32.cu the same design with each
fp32 product formed as three TF32 ``mma.sync`` products of the operands' big
and small parts, which keeps fp32 accuracy (TF32 itself stays off, and no
``allow_tf32`` flag is touched). Both read their operands in 16-byte pieces, or
the wrapper raises. The whole-row CUDA-core kernel of mha.cu also serves
``fused_mha_bld`` and, at the smaller head dims, ``fused_attention``'s
whole-block branch in either type, and the KV-blocked CUDA-core kernel of
mha_long.cu the smaller head dims of ``flash_attention_heads``.
The KV-blocked backward pair is two kernels in the same way: every caller of
it (K7, K9, K10, and K3, K4 and K5's backward past the whole-head kernel)
launches, in bf16 at head dim 64, the tensor-core pair of mha_tc_bwd.cu, in
fp32 at head dim 64 the split-TF32 pair of mha_tf32_bwd.cu (each product three
TF32 ``mma.sync`` products of the operands' parts, as mha_tf32.cu forms them),
both with the same demand on their operands, and at head dims 8, 16 and 32 the
CUDA-core pair of mha_blocked_bwd.cu. All three compute one function, so the
plain backwards have one form; ``blocked_bwd_tf32x3_reference`` emulates the
split-TF32 pair's arithmetic for the tests and the chip smoke run.
``route_counts`` says which kernels a run took. K1's and K6's plain versions have the
two forms to match (``block=None``: whole rows; ``block``: KV-blocked), because
in bf16 a plain version must round P where its kernel rounds it; the entries'
reference branch runs the form of the kernel the operands would launch
(``reference_block``), and so does K5's whole-block branch. K8's plain
version is KV-blocked at the block of the kernel its operands launch
(``flash_reference_block``: the tensor-core kernel's 64 keys in bf16 at head
dim 64, mha_long.cu's 128 otherwise).

Which kernel fits a shape is a matter of shared memory and of what is
instantiated: fp32 and bf16, head dims 8, 16, 32 and 64, causal or not, at any
length, so that every shape of the supported models, the reference's tiny test
model (head dim 8) included, has a kernel in both directions. The formulas of
what a block of each kernel needs live here (K1, K2 and K6 share the whole-row
formula, with K and V staged as fp32 or in the operand type, and go on
admitting shapes by it in bf16 too, where the tensor-core kernel's own need no
longer depends on L: the ladder, the scripts and the launch counts are written
to those limits); the library reports its own (``acl_*_smem_bytes``), and the
chip smoke run holds the two against each other. ``kernel_refusal`` is the one
statement of what a kernel takes: ``mha_kernel_eligible`` (the counterpart of
the JAX package's ``mha_eligible``, which the dispatch ladder
(models/clip/model.py: ``attention_rung``) and ``fused_attention`` ask to route
between kernels) and ``attention_bwd_route`` (the whole-head kernel of
mha_bwd.cu where its L x L tiles fit, a KV-blocked pair past it) are derived from it, and the wrappers raise its sentence. A wrapper on
a CUDA tensor launches or raises: no route computes the plain version on the
card unless the caller chose it, and no failure is ever caught to choose a
route.

The kernels that the measurement scripts launch themselves (the tensor-core
kernels' arithmetic at other tilings and residencies, KV parts, head pairs, no
softmax) are in ops/attention_probes.py.
"""

from __future__ import annotations

import contextlib
import contextvars
import ctypes
import functools
import math
import os
import types

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

# beside them, which kernels the launches took since the last
# reset_launch_counts(): "mha_tc" counts the launches of fused_mha_qkv,
# fused_mha_qtile and flash_attention_heads that took the tensor-core kernel
# (mha_tc.cu) rather than a CUDA-core one (mha.cu, mha_long.cu);
# "blocked_bwd_tc" the backward entries' launches (K7, K9, K10, the KV-blocked
# route of K3, K4 and K5's backward) that took the tensor-core pair
# (mha_tc_bwd.cu) rather than the CUDA-core one (mha_blocked_bwd.cu), one for
# each count of ``launch_counts``; "mha_tf32" the launches of the same three
# forward entries that took the split-TF32 tensor-core kernel (mha_tf32.cu);
# "blocked_bwd_tf32" the backward entries' launches that took the split-TF32
# pair (mha_tf32_bwd.cu), counted as "blocked_bwd_tc" is; "bld_tf32" the
# launches of fused_mha_bld (K2) that took the split-TF32 whole-head kernel
# (mha_bld_tf32.cu), and "bld_bwd_tf32" those of its backward (K4);
# "whole_bwd_tf32" the launches of K3, K4 and K5's backward that took the
# split-TF32 whole-head kernel at head dim 64 (mha_whole_tf32_bwd.cu). K5's
# whole-block forward at head dim 64 counts under "mha_tc" or "mha_tf32"
route_counts = {"mha_tc": 0, "blocked_bwd_tc": 0, "mha_tf32": 0, "blocked_bwd_tf32": 0,
                "bld_tf32": 0, "bld_bwd_tf32": 0, "whole_bwd_tf32": 0}

IMPL_ENV = "ANOMALYCLIP_ATTN_IMPL"
_IMPLS = ("kernel", "reference")
_IMPL = contextvars.ContextVar("attention_impl", default=None)  # None: no scope open


def reset_launch_counts() -> None:
    for counts in (launch_counts, route_counts):
        for name in counts:
            counts[name] = 0


@contextlib.contextmanager
def attention_impl(impl: str):
    """Scoped choice of what the wrappers run on a CUDA tensor: "kernel" (the
    default) or "reference" (the plain PyTorch version). It wins over the
    environment variable ``ANOMALYCLIP_ATTN_IMPL``, which holds the same two
    words and is read where no scope is open."""
    if impl not in _IMPLS:
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
    """fp32 q k^T / sqrt(dh) over (..., L, Dh), causal entries at NEG_INF."""
    scores = torch.einsum("...qd,...kd->...qk", q.float(), k.float()) * (1.0 / math.sqrt(q.shape[-1]))
    if causal:
        l = q.shape[-2]
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


def mha_bld_reference(q, k, v, num_heads: int, causal: bool = False, block=None) -> torch.Tensor:
    """Attention over (B, L, D) q, k, v: whole rows (``attention_reference``), or
    with ``block`` keys per KV block and online softmax
    (``attention_blocked_reference``), which is where the tensor-core kernel
    rounds in bf16."""
    heads = [_split_heads(t, num_heads) for t in (q, k, v)]
    if block is None:
        return _merge_heads(attention_reference(*heads, causal))
    return _merge_heads(attention_blocked_reference(*heads, causal, block))


def mha_qkv_reference(qkv, num_heads: int, causal: bool = False, block=None) -> torch.Tensor:
    return mha_bld_reference(*_unpack_qkv(qkv), num_heads, causal, block)


def mha_bld_bwd_reference(q, k, v, g, num_heads: int, causal: bool = False) -> tuple:
    """(dq, dk, dv), each (B, L, D), of ``mha_bld_reference`` for its output
    gradient g (B, L, D)."""
    heads = [_split_heads(t, num_heads) for t in (q, k, v, g)]
    return tuple(_merge_heads(t) for t in attention_bwd_reference(*heads, causal))


def mha_qkv_bwd_reference(qkv, g, num_heads: int, causal: bool = False) -> torch.Tensor:
    """The packed (B, L, 3D) gradient of ``mha_qkv_reference`` for its output
    gradient g (B, L, D)."""
    return torch.cat(mha_bld_bwd_reference(*_unpack_qkv(qkv), g, num_heads, causal), dim=-1)


def mha_qtile_reference(q, kv, num_heads: int, block=None) -> torch.Tensor:
    """``_mha_qtile_kernel`` (:525-532): non-causal attention of q (B, L, D)
    against the packed k|v (B, L, 2D), rounded as ``_attend_head`` rounds, or,
    given ``block``, per KV block as the tensor-core kernel rounds."""
    d = q.shape[-1]
    return mha_bld_reference(q, kv[..., :d], kv[..., d:], num_heads, False, block)


def mha_qtile_bwd_reference(q, kv, g, num_heads: int) -> tuple:
    """(dq (B, L, D), dkv (B, L, 2D)) of ``mha_qtile_reference`` for its output
    gradient g, rounded as ``_mha_qtile_bwd_kernel`` (:646-708) rounds: P
    normalised in fp32, delta = rowsum(P o dP), dS cast to q's type and P to v's
    before the second-stage products (``attention_bwd_reference``)."""
    d = q.shape[-1]
    dq, dk, dv = mha_bld_bwd_reference(q, kv[..., :d], kv[..., d:], g, num_heads)
    return dq, torch.cat([dk, dv], dim=-1)


def fused_attention_reference(q, k, v, causal: bool = False, block=None) -> torch.Tensor:
    """``fused_attention``'s whole-block kernel (:1089-1093) over (B, H, L, Dh):
    whole rows, or with ``block`` keys per KV block and online softmax
    (``attention_blocked_reference``), where the tensor-core kernel that the
    branch launches in bf16 at head dim 64 rounds (``reference_block``)."""
    if block is None:
        return attention_reference(q, k, v, causal)
    return attention_blocked_reference(q, k, v, causal, block)


# keys per KV block of the flash kernel (mha_long.cu: kBlockKV)
FLASH_BLOCK_KV = 128


def flash_reference_block(dtype: torch.dtype, dh: int) -> int:
    """The ``block`` of ``flash_attention_reference`` that rounds like the
    kernel K8 launches for this operand type and head dim: the tensor-core
    kernel's ``MHA_TC_BLOCK_KV`` in bf16 at head dim 64, mha_long.cu's
    ``FLASH_BLOCK_KV`` otherwise (in fp32 nothing rounds, and the block orders
    the sums only). Read at each call, so that a caller may set either."""
    return MHA_TC_BLOCK_KV if mha_tc_eligible(dtype, dh) else FLASH_BLOCK_KV


def flash_attention_reference(q, k, v, save_lse: bool = False, block=None, causal: bool = False):
    """``_flash_kernel`` (:800-854) over per-head (N, L, dh): per KV block of
    ``block`` keys the running max, the rescale alpha = exp(m_old - m_new), p =
    exp(s - m_new) cast to v's type before the P.V product and summed
    unrounded, one divide at the end. The block size decides where bf16 rounds:
    ``None`` is the block of the CUDA kernel these operands launch
    (``flash_reference_block``; the Pallas kernel's is 512). ``causal`` sets the
    entries above the diagonal to NEG_INF before the max. -> out, or (out, lse)
    with lse = m + log(sum) as a plain (N, L) fp32 tensor."""
    if block is None:
        block = flash_reference_block(q.dtype, q.shape[-1])
    acc, denom, m = _online_softmax(q, k, v, causal, block)
    out = (acc / denom).to(q.dtype)
    if save_lse:
        return out, (m + torch.log(denom)).squeeze(-1)
    return out


def _online_softmax(q, k, v, causal: bool, block: int, product=torch.einsum) -> tuple:
    """The KV-blocked sweep over (..., L, dh) q, k, v -> fp32 (accumulator
    (..., L, dh), sum (..., L, 1), max (..., L, 1)): per block of ``block`` keys
    the running max, alpha = exp(m_old - m_new) on the accumulator and the sum, p
    = exp(s - m_new) summed unrounded and cast to v's type before P.V; causal
    entries at NEG_INF before the max. ``product(spec, a, b)`` forms the two
    products (fp32 einsum; the split-TF32 emulation for ``tf32x3_reference``)."""
    l = q.shape[-2]
    return online_softmax_steps(q, k, v, causal, [(s, min(s + block, l)) for s in range(0, l, block)],
                                product)


def online_softmax_steps(q, k, v, causal: bool, steps: list, product=torch.einsum) -> tuple:
    """``_online_softmax`` over the KV steps (start, end) given, in order: the
    probes' KV parts (ops/attention_probes.py) restart their 64-key steps at each
    part."""
    l, dh = q.shape[-2:]
    scale = 1.0 / math.sqrt(dh)
    qf = q.float()
    m = torch.full((*q.shape[:-1], 1), NEG_INF, dtype=torch.float32, device=q.device)
    denom = torch.zeros_like(m)
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    rows = torch.arange(l, device=q.device)[:, None]
    for start, end in steps:
        kb, vb = k[..., start:end, :], v[..., start:end, :]
        s = product("...qd,...kd->...qk", qf, kb.float()) * scale
        if causal:
            keys = torch.arange(start, end, device=q.device)[None, :]
            s = s.masked_fill(keys > rows, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        acc = acc * alpha + product("...qk,...kd->...qd", p.to(v.dtype).float(), vb.float())
        denom = denom * alpha + p.sum(dim=-1, keepdim=True)
        m = m_new
    return acc, denom, m


# keys per KV block of the tensor-core kernel (mha_tc.cu: kTcKV)
MHA_TC_BLOCK_KV = 64


def attention_blocked_reference(
    q, k, v, causal: bool = False, block: int = MHA_TC_BLOCK_KV
) -> torch.Tensor:
    """``attention_reference``'s function over (B, H, L, Dh) with the arithmetic
    of ``flash_attention_reference`` (``_online_softmax``) and the causal mask,
    one divide at the end. In fp32 it is the whole-row function to the rounding
    of the sums' order; in bf16 it rounds p against each block's running max, as
    the tensor-core kernel does."""
    acc, denom, _ = _online_softmax(q, k, v, causal, block)
    return (acc / denom).to(q.dtype)


# keys per KV block of the split-TF32 kernel (mha_tf32.cu: kTfKV)
MHA_TF32_BLOCK_KV = 64


def tf32_split(x: torch.Tensor) -> tuple:
    """fp32 x -> (big, small), both TF32 values held as fp32: big = x rounded to
    10 mantissa bits, to nearest with ties away from zero (``cvt.rna.tf32.f32``,
    on the bits (b + 0x1000) & ~0x1FFF), small = x - big rounded the same way.
    For the tests and the chip smoke run: nothing on the main path calls it."""
    def rna(t):
        return ((t.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)

    big = rna(x.float())
    return big, rna(x.float() - big)


def _tf32_product(passes: int):
    """einsum over TF32 parts: with 3 passes small.big + big.small + big.big,
    the kernel's products in its order; with 1 pass big.big alone (plain TF32)."""
    def product(spec, a, b):
        (a_big, a_small), (b_big, b_small) = tf32_split(a), tf32_split(b)
        big = torch.einsum(spec, a_big, b_big)
        if passes == 1:
            return big
        return (torch.einsum(spec, a_small, b_big) + torch.einsum(spec, a_big, b_small)) + big

    return product


def tf32x3_reference(q, k, v, causal: bool = False, save_lse: bool = False, passes: int = 3):
    """What the split-TF32 kernel (mha_tf32.cu) computes over fp32 (..., L, dh)
    q, k, v: ``flash_attention_reference``'s KV-blocked arithmetic at
    ``MHA_TF32_BLOCK_KV`` keys with each product formed from the operands' TF32
    parts (``tf32_split``) -> out, or (out, lse). ``passes=1`` is plain TF32,
    which the fp32 limits reject. For the tests and the chip smoke run."""
    acc, denom, m = _online_softmax(q, k, v, causal, MHA_TF32_BLOCK_KV, _tf32_product(passes))
    out = acc / denom
    return (out, (m + torch.log(denom)).squeeze(-1)) if save_lse else out


def mha_qkv_tf32x3_reference(qkv, num_heads: int, causal: bool = False, passes: int = 3):
    """``tf32x3_reference`` over a packed (B, L, 3D) qkv -> (B, L, D)."""
    heads = [_split_heads(t, num_heads) for t in _unpack_qkv(qkv)]
    return _merge_heads(tf32x3_reference(*heads, causal, passes=passes))


def mha_qtile_tf32x3_reference(q, kv, num_heads: int, passes: int = 3):
    """``tf32x3_reference`` of q (B, L, D) against the packed k|v (B, L, 2D),
    non-causal -> (B, L, D)."""
    d = q.shape[-1]
    heads = [_split_heads(t, num_heads) for t in (q, kv[..., :d], kv[..., d:])]
    return _merge_heads(tf32x3_reference(*heads, passes=passes))


def blocked_bwd_tf32x3_reference(q, k, v, g, lse=None, delta=None, causal: bool = False,
                                 passes: int = 3) -> tuple:
    """What the split-TF32 backward pair (mha_tf32_bwd.cu) computes over fp32
    (..., L, dh) q, k, v and the output gradient g -> (dq, dk, dv): the five
    products formed from the operands' TF32 parts (``_tf32_product``), every
    sum in fp32, P and dS not rounded. With ``lse`` and ``delta`` ((..., L)
    fp32) the statistics are the given ones (the flash backward); without,
    the dq pass's sweep rebuilds them: lse = m + log(l), delta = rowsum(P o dP)
    with P normalised. ``passes=1`` is plain TF32, which the fp32 limits
    reject. For the tests and the chip smoke run: nothing on the main path
    calls it."""
    product = _tf32_product(passes)
    scale = 1.0 / math.sqrt(q.shape[-1])
    q, k, v, g = (t.float() for t in (q, k, v, g))
    s = product("...qd,...kd->...qk", q, k) * scale
    if causal:
        l = q.shape[-2]
        s = s.masked_fill(~torch.ones((l, l), dtype=torch.bool, device=q.device).tril(), NEG_INF)
    dp = product("...qd,...kd->...qk", g, v)
    if lse is None:
        m = s.amax(dim=-1, keepdim=True)
        e = torch.exp(s - m)
        total = e.sum(dim=-1, keepdim=True)
        lse, delta = (m + torch.log(total)).squeeze(-1), (e / total * dp).sum(dim=-1)
    p = torch.exp(s - lse.float().unsqueeze(-1))
    ds = p * (dp - delta.float().unsqueeze(-1)) * scale
    return (product("...qk,...kd->...qd", ds, k), product("...qk,...qd->...kd", ds, q),
            product("...qk,...qd->...kd", p, g))


def mha_qtile_bwd_tf32x3_reference(q, kv, g, num_heads: int, passes: int = 3) -> tuple:
    """``blocked_bwd_tf32x3_reference`` of K7: q, g (B, L, D) and the packed
    k|v (B, L, 2D) -> (dq (B, L, D), dkv (B, L, 2D))."""
    d = q.shape[-1]
    heads = [_split_heads(t, num_heads) for t in (q, kv[..., :d], kv[..., d:], g)]
    dq, dk, dv = (_merge_heads(t) for t in blocked_bwd_tf32x3_reference(*heads, passes=passes))
    return dq, torch.cat([dk, dv], dim=-1)


def mha_qkv_bwd_tf32x3_reference(qkv, g, num_heads: int, causal: bool = False,
                                 passes: int = 3) -> torch.Tensor:
    """``blocked_bwd_tf32x3_reference`` of K3's blocked route: the packed
    (B, L, 3D) dqkv for the output gradient g (B, L, D)."""
    heads = [_split_heads(t, num_heads) for t in (*_unpack_qkv(qkv), g)]
    grads = blocked_bwd_tf32x3_reference(*heads, causal=causal, passes=passes)
    return torch.cat([_merge_heads(t) for t in grads], dim=-1)


def mha_bld_tf32x3_reference(q, k, v, num_heads: int, causal: bool = False,
                             passes: int = 3) -> torch.Tensor:
    """What the split-TF32 whole-head forward (mha_bld_tf32.cu, K2 in fp32 at L
    <= 32) computes over fp32 (B, L, D) q, k, v -> (B, L, D): whole softmax rows
    (one KV block of L keys in ``_online_softmax``), the products formed from the
    operands' TF32 parts (``_tf32_product``), the divide on the output row.
    ``passes=1`` is plain TF32, which the fp32 limits reject. For the tests and
    the chip smoke run: nothing on the main path calls it."""
    heads = [_split_heads(t.float(), num_heads) for t in (q, k, v)]
    acc, denom, _ = _online_softmax(*heads, causal, q.shape[1], _tf32_product(passes))
    return _merge_heads(acc / denom)


def mha_bld_bwd_tf32x3_reference(q, k, v, g, num_heads: int, causal: bool = False,
                                 passes: int = 3) -> tuple:
    """What the split-TF32 whole-head backwards compute over fp32 (B, L, D) q,
    k, v and the output gradient g -> (dq, dk, dv), each (B, L, D): K4 in fp32
    at head dims 16 and 32 with L <= 32 (mha_bld_tf32.cu), and K3, K4 and K5's
    backward in fp32 at head dim 64 with L <= 112 (mha_whole_tf32_bwd.cu; K3's
    packed qkv unpacked, K5's heads folded into the batch with one head):
    ``_mha_bwd_head``'s function, P normalised as e / sum, delta = rowsum(P o
    dP), dS = P o (dP - delta) * scale, the five products formed from the
    operands' TF32 parts, the cross terms first, as both kernels order them.
    ``passes=1`` is plain TF32. For the tests and the chip smoke run: nothing
    on the main path calls it."""
    product = _tf32_product(passes)
    q, k, v, g = (_split_heads(t.float(), num_heads) for t in (q, k, v, g))
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = product("...qd,...kd->...qk", q, k) * scale
    if causal:
        l = q.shape[-2]
        s = s.masked_fill(~torch.ones((l, l), dtype=torch.bool, device=q.device).tril(), NEG_INF)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    dp = product("...qd,...kd->...qk", g, v)
    ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True)) * scale
    grads = (product("...qk,...kd->...qd", ds, k), product("...qk,...qd->...kd", ds, q),
             product("...qk,...qd->...kd", p, g))
    return tuple(_merge_heads(t) for t in grads)


def flash_delta(g, out) -> torch.Tensor:
    """rowsum(g o out) in fp32, (N, L): the flash backward's delta, one
    elementwise pass outside the kernels, as ``_flash_bwd_impl`` (:1013-1016)."""
    return (g.float() * out.float()).sum(dim=-1)


def _flash_p_and_ds(q, k, v, g, lse, delta, causal: bool = False) -> tuple:
    """fp32 (P, dS, g) of the flash backward from the (N, L) fp32 log-sum-exp and
    delta: P = exp(s - lse), not renormalised, 0 above the diagonal when
    ``causal``; dS = P o (dP - delta) * scale, rounded to q's type. Per-head
    (N, L, dh) operands, or the (B, H, L, dh) views with (B, H, L) statistics
    that ``fused_attention`` hands over."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    g = g.to(q.dtype).float()
    p = torch.exp(_masked_scores(q, k, causal) - lse.unsqueeze(-1))
    dp = torch.einsum("...qd,...kd->...qk", g, v.float())
    return p, (p * (dp - delta.unsqueeze(-1)) * scale).to(q.dtype).float(), g


def flash_dq_reference(q, k, v, g, lse, delta, causal: bool = False) -> torch.Tensor:
    """``_flash_dq_kernel`` (:904-940) over per-head (N, L, dh): dq = dS K, dS
    cast to q's type first, summed in fp32."""
    _, ds, _ = _flash_p_and_ds(q, k, v, g, lse, delta, causal)
    return torch.einsum("...qk,...kd->...qd", ds, k.float()).to(q.dtype)


def flash_dkv_reference(q, k, v, g, lse, delta, causal: bool = False) -> tuple:
    """``_flash_dkv_kernel`` (:943-993): dk = dS^T q and dv = P^T g, dS cast to
    q's type and P to v's type first, summed in fp32."""
    p, ds, g = _flash_p_and_ds(q, k, v, g, lse, delta, causal)
    dk = torch.einsum("...qk,...qd->...kd", ds, q.float())
    dv = torch.einsum("...qk,...qd->...kd", p.to(v.dtype).float(), g)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_reference(q, k, v, g, lse, out, causal: bool = False) -> tuple:
    """(dq, dk, dv) of ``flash_attention_reference`` as ``_flash_bwd`` (:1076-1078)
    computes them: g cast to q's type first, delta = rowsum(g o out) in fp32
    from the *rounded* output, then the dq pass and the dk, dv pass. In bf16
    this differs from ``attention_bwd_reference``, which takes delta from
    P o dP."""
    g = g.to(q.dtype)
    delta = flash_delta(g, out)
    return (flash_dq_reference(q, k, v, g, lse, delta, causal),
            *flash_dkv_reference(q, k, v, g, lse, delta, causal))


# ---------------------------------------------------------------------------
# Shared memory per block of each kernel, in bytes: the same formulas as the
# kernels' own smem_bytes (mha.cu, mha_bwd.cu, mha_long.cu, mha_blocked_bwd.cu,
# mha_tc.cu, mha_tc_bwd.cu)
# ---------------------------------------------------------------------------

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the head dims the CUDA-core kernels are instantiated for, every one of them:
# 64 and 32 are the CLIP towers and the temporal model, 16 and 8 the temporal
# model at emb 128 with 8 heads and at emb 32 with 4 (the reference's tiny model)
_HEAD_DIMS = (8, 16, 32, 64)
# K2's and K4's whole-head CUDA-core kernels (acl_mha_bld_fwd of mha.cu,
# acl_mha_bld_bwd of mha_bwd.cu) take head dim 4 besides: the temporal model of
# the golden tiny fixture (tests/golden/tiny_state.npz: emb 32 over 8 heads).
# The head dims each entry's kernels take, where they are not _HEAD_DIMS
BLD_HEAD_DIMS = (4,) + _HEAD_DIMS
_ENTRY_HEAD_DIMS = {"fused_mha_bld": BLD_HEAD_DIMS, "mha_bld_bwd": BLD_HEAD_DIMS}
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


# keys per KV block of the blocked backward kernels (mha_blocked_bwd.cu: kBwdKV)
BWD_BLOCK_KV = 64


def blocked_bwd_smem_bytes(dh: int, itemsize: int) -> int:
    """K7, K9, K10 and the long shapes of K3, K4 and K5's backward
    (mha_blocked_bwd.cu), either kernel: fp32 q and g rows, the P and dS tiles,
    the tile's row statistics, one KV block in the operand type with K and V
    both padded. Independent of L."""
    tiles = 2 * _KERNEL_ROWS * dh + 2 * _KERNEL_ROWS * BWD_BLOCK_KV + 3 * _KERNEL_ROWS
    return 4 * tiles + itemsize * 2 * BWD_BLOCK_KV * (dh + 4 // itemsize)


MHA_TC_HEAD_DIM = 64  # the one head dim the tensor-core kernel is instantiated for
_MHA_TC_ROWS = 64  # query rows per block: 4 warps of 16 rows (mha_tc.cu: kTcWarps)
_MHA_TC_STAGES = 2  # KV blocks in flight
_MHA_TC_PAD = 8  # bf16 elements of padding per staged row


def mha_tc_smem_bytes(dh: int = MHA_TC_HEAD_DIM) -> int:
    """The tensor-core kernel (mha_tc.cu): the q tile and two stages of one KV
    block each of K and V, bf16 rows padded by 16 bytes. Independent of L."""
    return 2 * (dh + _MHA_TC_PAD) * (_MHA_TC_ROWS + 2 * _MHA_TC_STAGES * MHA_TC_BLOCK_KV)


def mha_tc_eligible(dtype: torch.dtype, dh: int) -> bool:
    """Whether K1, K6 and K8 launch the tensor-core kernel (mha_tc.cu) for this
    operand type and head dim, or a CUDA-core kernel (mha.cu for K1 and K6,
    mha_long.cu for K8; in fp32 at head dim 64 the split-TF32 kernel of
    mha_tf32.cu), and whether the KV-blocked backward is the tensor-core pair of
    mha_tc_bwd.cu or another (in fp32 at head dim 64 the split-TF32 pair of
    mha_tf32_bwd.cu, otherwise the CUDA-core pair of mha_blocked_bwd.cu). It also decides
    which plain version rounds like the kernel: for K1 and K6 the KV-blocked
    one, for K8 the one at the tensor-core kernel's KV block, where this says
    yes."""
    return dtype == torch.bfloat16 and dh == MHA_TC_HEAD_DIM


MHA_TF32_HEAD_DIM = 64  # the one head dim the split-TF32 kernel is instantiated for
_MHA_TF32_PADS = (8, 4)  # floats of padding per staged K row and V row (mha_tf32.cu)


def mha_tf32_smem_bytes(dh: int = MHA_TF32_HEAD_DIM) -> int:
    """The split-TF32 kernel (mha_tf32.cu): two stages of one KV block each of K
    and V, fp32 rows padded by 8 and 4 floats; the q tile lives in registers.
    Independent of L."""
    k_pad, v_pad = _MHA_TF32_PADS
    return 4 * _MHA_TC_STAGES * MHA_TF32_BLOCK_KV * ((dh + k_pad) + (dh + v_pad))


def mha_tf32_eligible(dtype: torch.dtype, dh: int) -> bool:
    """Whether K1, K6 and K8 launch the split-TF32 tensor-core kernel
    (mha_tf32.cu) for this operand type and head dim, or the CUDA-core kernels
    of mha.cu and mha_long.cu (in bf16 at head dim 64 the kernel of
    mha_tc.cu); and whether the KV-blocked backward is the split-TF32 pair of
    mha_tf32_bwd.cu or another (the tensor-core pair of mha_tc_bwd.cu in bf16
    at head dim 64, the CUDA-core pair of mha_blocked_bwd.cu otherwise)."""
    return dtype == torch.float32 and dh == MHA_TF32_HEAD_DIM


BLD_TF32_HEAD_DIMS = (16, 32)  # the head dims the split-TF32 whole-head kernels take
BLD_TF32_MAX_L = 32  # the rows and keys one warp of them holds
_BLD_TF32_WARPS = 4  # warps a block, each owning one (batch entry, head) (mha_bld_tf32.cu)
_BLD_TF32_PADS = (8, 4, 4)  # floats of padding: the forward's K and V rows, the backward's rows


def mha_bld_tf32_smem_bytes(l: int, dh: int, backward: bool) -> int:
    """The split-TF32 whole-head kernels (mha_bld_tf32.cu), a block of four
    warps: the forward's static K and V tiles of 32 rows (independent of L);
    the backward's q, k, v and g tiles and its P and dS tiles, each of L
    rounded up to 16 rows."""
    k_pad, v_pad, pad = _BLD_TF32_PADS
    if not backward:
        return 4 * _BLD_TF32_WARPS * BLD_TF32_MAX_L * ((dh + k_pad) + (dh + v_pad))
    rows = -(-l // 16) * 16
    return 4 * _BLD_TF32_WARPS * (4 * rows * (dh + pad) + 2 * rows * (rows + pad))


WHOLE_TF32_HEAD_DIM = 64  # the one head dim the split-TF32 whole-head backward takes
_WHOLE_TF32_PAD = 4  # floats of padding per staged row and tile row (mha_whole_tf32_bwd.cu)


def mha_whole_tf32_smem_bytes(l: int) -> int:
    """The split-TF32 whole-head backward at head dim 64 (mha_whole_tf32_bwd.cu),
    one block a head: the q, k, v and g tiles and the P and dS tiles, each of L
    rounded up to 16 rows, rows padded by 4 floats."""
    rows = -(-l // 16) * 16
    pad = _WHOLE_TF32_PAD
    return 4 * (4 * rows * (WHOLE_TF32_HEAD_DIM + pad) + 2 * rows * (rows + pad))


# the longest head it takes: the last multiple of 16 rows whose tiles fit an
# H100's block (112: 225,792 B; 128 would need 274,432)
WHOLE_TF32_MAX_L = max(r for r in range(16, 257, 16) if mha_whole_tf32_smem_bytes(r) <= H100_SMEM_OPTIN)


def mha_whole_tf32_eligible(dtype: torch.dtype, dh: int, l: int) -> bool:
    """Whether K3 (``mha_qkv_bwd``), K4 (``mha_bld_bwd``) and K5's backward
    (heads folded) launch the split-TF32 whole-head kernel of
    mha_whole_tf32_bwd.cu for this operand type, head dim and length, or the
    kernels ``attention_bwd_route`` names (mha_bwd.cu, the KV-blocked pair; K4
    at head dims 16 and 32 first asks ``mha_bld_tf32_eligible``): fp32 at head
    dim 64 with 1 <= L <= ``WHOLE_TF32_MAX_L``, the text tower's CoOp
    gradient. A pure function of the shape."""
    return dtype == torch.float32 and dh == WHOLE_TF32_HEAD_DIM and 1 <= l <= WHOLE_TF32_MAX_L


def mha_bld_tf32_eligible(dtype: torch.dtype, dh: int, l: int) -> bool:
    """Whether K2 (``fused_mha_bld``) and its backward K4 launch the split-TF32
    whole-head kernels of mha_bld_tf32.cu for this operand type, head dim and
    length, or the CUDA-core kernels of mha.cu and mha_bwd.cu (the KV-blocked
    pair past the whole-head backward): fp32 at head dim 16 or 32 with
    1 <= L <= 32, the temporal model's axial attention."""
    return dtype == torch.float32 and dh in BLD_TF32_HEAD_DIMS and 1 <= l <= BLD_TF32_MAX_L


BWD_TC_PASSES = {"dq": 0, "dkv": 1}  # the library's codes for the pair's two kernels


def blocked_bwd_tc_smem_bytes(dh: int = MHA_TC_HEAD_DIM, kernel: str = "dkv") -> int:
    """The tensor-core backward pair (mha_tc_bwd.cu), bf16 rows padded by 16
    bytes: the dq kernel holds the q and g tiles and two stages of one KV block
    each of K and V; the dkv kernel the K and V block, two stages of one q and
    one g tile, and with each stage the tile's fp32 log-sum-exp and delta.
    Independent of L."""
    tiles = 2 * (dh + _MHA_TC_PAD) * (2 + 2 * _MHA_TC_STAGES) * BWD_BLOCK_KV
    return tiles + (4 * 2 * _MHA_TC_STAGES * BWD_BLOCK_KV if BWD_TC_PASSES[kernel] else 0)


_BWD_TF32_PAD = 4  # floats of padding per staged row of the split-TF32 pair (mha_tf32_bwd.cu)


def blocked_bwd_tf32_smem_bytes(dh: int = MHA_TF32_HEAD_DIM, kernel: str = "dkv") -> int:
    """The split-TF32 backward pair (mha_tf32_bwd.cu), fp32 rows padded by 4
    floats: the dq kernel holds the q and g tiles and two stages of one KV block
    each of K and V; the dkv kernel the K and V block, two stages of one q and
    one g tile, and with each stage the tile's fp32 log-sum-exp and delta.
    Independent of L."""
    tiles = 4 * (dh + _BWD_TF32_PAD) * (2 + 2 * _MHA_TC_STAGES) * BWD_BLOCK_KV
    return tiles + (4 * 2 * _MHA_TC_STAGES * BWD_BLOCK_KV if BWD_TC_PASSES[kernel] else 0)


def kernel_refusal(dtype: torch.dtype, d: int, num_heads: int, smem_need, smem: int,
                   head_dims: tuple = _HEAD_DIMS):
    """Why a kernel whose block needs ``smem_need(dh)`` bytes of shared memory
    and that is instantiated at ``head_dims`` does not take ``num_heads`` heads
    over ``d`` columns of ``dtype`` on a card that gives a block ``smem`` bytes:
    the rest of a sentence, or None where it does. The one statement of the
    card's limits (an operand type and a head dim that are instantiated, the
    block's shared memory): the eligibility functions ask whether it is None,
    the wrappers raise it."""
    if dtype not in _DTYPE_CODES:
        return f"has dtype {dtype}; the kernels take float32 and bfloat16"
    if d % num_heads or d // num_heads not in head_dims:
        return (f"with {num_heads} heads gives head dim {d / num_heads:g}; the kernels take "
                f"{head_dims}")
    need = smem_need(d // num_heads)
    if need > smem:
        return f"needs {need} B of shared memory per block, the card gives {smem}"
    return None


def mha_kernel_eligible(
    l: int, d: int, num_heads: int, dtype: torch.dtype, smem: int = H100_SMEM_OPTIN,
    staged_itemsize: int = 4,
) -> bool:
    """Whether the whole-row forward kernels (K1, K2, K5's whole-block branch;
    K6 with ``staged_itemsize`` the operand's) take this shape on the card: the
    counterpart of the JAX package's ``mha_eligible`` (attention.py:178-187) with
    the card's limits in place of the TPU's (``kernel_refusal``), the head's K
    and V within ``smem`` bytes. A pure function of the shape: the dispatch
    ladder and ``fused_attention`` ask it before the call, to choose between
    this kernel and the KV-blocked one."""
    return kernel_refusal(
        dtype, d, num_heads, lambda dh: mha_smem_bytes(l, dh, staged_itemsize), smem
    ) is None


def attention_bwd_route(l: int, dh: int, itemsize: int, smem: int = H100_SMEM_OPTIN):
    """Which kernel the whole-block backward entries (K3, K4, and K5's backward)
    launch at sequence length ``l`` and head dim ``dh``, causal or not, given
    ``smem`` bytes of shared memory a block: "whole" (mha_bwd.cu) where its
    L x L tiles fit, "blocked" (the KV-blocked pair the operands take, with the
    row statistics recomputed; admitted by mha_blocked_bwd.cu's shared memory
    whichever pair serves it) past it, None where a card gives a block too
    little for either (the wrapper then raises). A pure function of the shape, so a CPU test
    holds it."""
    if mha_bwd_smem_bytes(l, dh) <= smem:
        return "whole"
    if blocked_bwd_smem_bytes(dh, itemsize) <= smem:
        return "blocked"
    return None


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

_INT_MAX = 2**31 - 1


def current_impl() -> str:
    """What the wrappers run on a CUDA tensor now: the innermost open
    ``attention_impl`` scope, else ``ANOMALYCLIP_ATTN_IMPL``, else "kernel"."""
    impl = _IMPL.get()
    if impl is None:
        impl = os.environ.get(IMPL_ENV, "kernel")
        if impl not in _IMPLS:
            raise ValueError(f"{IMPL_ENV} must be 'kernel' or 'reference', not {impl!r}")
    return impl


def _use_reference(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"fused attention takes CPU or CUDA tensors, not {t.device}")
    return current_impl() == "reference"


def _check_kernel_shape(name: str, t: torch.Tensor, d: int, num_heads: int, smem_need) -> int:
    """Raise, with the shape, on what the CUDA kernel of entry ``name`` does not
    take (``kernel_refusal`` at the entry's head dims) -> head dim.
    ``smem_need(dh)`` is the shared memory one block needs at this shape."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: the kernel takes CUDA tensors, not {t.device}")
    refusal = kernel_refusal(t.dtype, d, num_heads, smem_need, smem_limit(t.device),
                             _ENTRY_HEAD_DIMS.get(name, _HEAD_DIMS))
    if refusal is not None:
        raise ValueError(f"{name}: shape {tuple(t.shape)} {refusal}")
    return d // num_heads


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


def _in_16_byte_pieces(t: torch.Tensor) -> bool:
    """Whether a tensor-core kernel can read t in 16-byte pieces: its base
    address and every stride but the last are multiples of 16 bytes."""
    return t.data_ptr() % 16 == 0 and all(s * t.element_size() % 16 == 0 for s in t.stride()[:-1])


def _check_16_byte_pieces(name: str, *operands: torch.Tensor) -> None:
    """Raise on an operand a tensor-core kernel cannot read in 16-byte pieces."""
    for t in operands:
        if not _in_16_byte_pieces(t):
            raise ValueError(
                f"{name}: the tensor-core kernel reads {str(t.dtype).split('.')[-1]} operands "
                f"in 16-byte pieces; "
                f"shape {tuple(t.shape)} with strides {tuple(t.stride())} at offset "
                f"{t.storage_offset()} is not aligned to them"
            )


def _check_tc(name: str, out: torch.Tensor, num_heads: int, *operands: torch.Tensor,
              smem_need=mha_tc_smem_bytes) -> None:
    """Raise on what a tensor-core kernel (mha_tc.cu; mha_tf32.cu with its
    ``smem_need``) does not take: an operand that cannot be read in 16-byte
    pieces (base address, batch and row strides), a grid or a card too small
    for it. ``out`` is (B, L, D) with ``num_heads`` heads, or (B, H, L, dh)
    with ``num_heads`` 1."""
    _check_16_byte_pieces(name, *operands)
    entries, l = out.shape[:-2].numel(), out.shape[-2]
    if entries * num_heads * -(-l // _MHA_TC_ROWS) > _INT_MAX:
        raise ValueError(f"{name}: shape {tuple(out.shape)} is beyond the launch grid")
    need, have = smem_need(out.shape[-1] // num_heads), smem_limit(out.device)
    if need > have:
        raise ValueError(f"{name}: the tensor-core kernel needs {need} B of shared memory "
                         f"per block, the card gives {have}")


def mha_qkv_fwd_kernel(qkv: torch.Tensor, num_heads: int, causal: bool) -> torch.Tensor:
    """K1: launch ``acl_mha_qkv_tc_fwd`` (bf16 at head dim 64),
    ``acl_mha_qkv_tf32_fwd`` (fp32 at head dim 64) or ``acl_mha_qkv_fwd``
    (everything else) -> (B, L, D)."""
    b, l, d3 = qkv.shape
    d = d3 // 3
    dh = _check_kernel_shape("fused_mha_qkv", qkv, d, num_heads, lambda dh: mha_smem_bytes(l, dh))
    bs, rs = _strides("fused_mha_qkv", qkv, qkv.shape)
    out = torch.empty((b, l, d), dtype=qkv.dtype, device=qkv.device)
    ptr = ctypes.c_void_p
    tensor_cores, tf32 = mha_tc_eligible(qkv.dtype, dh), mha_tf32_eligible(qkv.dtype, dh)
    args = (ptr(qkv.data_ptr()), bs, rs, ptr(out.data_ptr()), b, l, num_heads, dh, int(causal),
            1.0 / math.sqrt(dh), _stream(qkv))
    if tensor_cores:
        _check_tc("fused_mha_qkv", out, num_heads, qkv)
        err = load_library().acl_mha_qkv_tc_fwd(*args)
    elif tf32:
        _check_tc("fused_mha_qkv", out, num_heads, qkv, smem_need=mha_tf32_smem_bytes)
        err = load_library().acl_mha_qkv_tf32_fwd(*args)
    else:
        err = load_library().acl_mha_qkv_fwd(_DTYPE_CODES[qkv.dtype], *args)
    _raise_on_error("fused_mha_qkv", err)
    launch_counts["fused_mha_qkv"] += 1
    route_counts["mha_tc"] += tensor_cores
    route_counts["mha_tf32"] += tf32
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


# the shared memory a block of each split-TF32 whole-head kernel needs at
# (L, dh): K2's forward and K4's backward of mha_bld_tf32.cu, the head-dim-64
# backward of mha_whole_tf32_bwd.cu
_WHOLE_HEAD_SMEM = {
    "bld_fwd": lambda l, dh: mha_bld_tf32_smem_bytes(l, dh, False),
    "bld_bwd": lambda l, dh: mha_bld_tf32_smem_bytes(l, dh, True),
    "whole_bwd": lambda l, dh: mha_whole_tf32_smem_bytes(l),
}


@functools.lru_cache(maxsize=256)
def _bld_tf32_plan(name: str, operands: tuple, num_heads: int, kernel: str) -> tuple:
    """What the split-TF32 whole-head entries owe their operands that depends
    only on their shapes, strides, dtypes and devices, given as one (shape,
    stride, dtype, device) per operand (q first), so that a repeated call pays
    for it once; raises, with the shape, on what they do not take -> (head
    dim, scale, the operands' (batch, row) element strides, flat). ``kernel``
    names the kernel's shared memory (``_WHOLE_HEAD_SMEM``)."""
    shape, _, dtype, device = operands[0]
    for other, _, other_dtype, other_device in operands[1:]:
        if other != shape or other_dtype != dtype:
            raise ValueError(f"{name}: operands must agree: " + ", ".join(
                f"{tuple(s)} {dt}" for s, _, dt, _ in operands))
        if other_device != device:
            raise ValueError(f"{name}: operands must be on one device")
    b, l, d = shape
    dh = _check_kernel_shape(name, types.SimpleNamespace(shape=shape, dtype=dtype, device=device), d,
                             num_heads, lambda dh: _WHOLE_HEAD_SMEM[kernel](l, dh))
    strides = []
    for _, stride, _, _ in operands:
        if stride[-1] != 1:
            raise ValueError(f"{name}: shape {tuple(shape)}: the last dimension must be contiguous")
        if stride[0] % 4 or stride[1] % 4:
            raise ValueError(f"{name}: the split-TF32 kernel reads float32 operands in 16-byte "
                             f"pieces; shape {tuple(shape)} with strides {tuple(stride)} is not "
                             f"aligned to them")
        strides.extend(stride[:2])
    if b * num_heads > _INT_MAX:
        raise ValueError(f"{name}: shape {tuple(shape)} is beyond the launch grid")
    return dh, 1.0 / math.sqrt(dh), tuple(strides)


def _bld_tf32_args(name: str, operands: tuple, num_heads: int, kernel: str) -> tuple:
    """``_bld_tf32_plan`` of the operands, and each base address in 16-byte
    pieces (the one check a call repeats) -> the plan."""
    plan = _bld_tf32_plan(name, tuple([(t.shape, t.stride(), t.dtype, t.device) for t in operands]),
                          num_heads, kernel)
    if any([t.data_ptr() % 16 for t in operands]):
        _check_16_byte_pieces(name, *operands)
    return plan


def mha_bld_fwd_kernel(q, k, v, num_heads: int, causal: bool) -> torch.Tensor:
    """K2: launch ``acl_mha_bld_tf32_fwd`` (fp32 at head dims 16 and 32 with L <=
    32: ``mha_bld_tf32_eligible``) or ``acl_mha_bld_fwd`` (everything else) ->
    (B, L, D); k and v are read in place."""
    b, l, d = q.shape
    if d % num_heads == 0 and mha_bld_tf32_eligible(q.dtype, d // num_heads, l):
        dh, scale, strides = _bld_tf32_args("fused_mha_bld", (q, k, v), num_heads, "bld_fwd")
        out = torch.empty((b, l, d), dtype=q.dtype, device=q.device)
        err = load_library().acl_mha_bld_tf32_fwd(
            q.data_ptr(), *strides[0:2], k.data_ptr(), *strides[2:4], v.data_ptr(), *strides[4:6],
            out.data_ptr(), b, l, num_heads, dh, int(causal), scale, _stream(q),
        )
        _raise_on_error("fused_mha_bld", err)
        route_counts["bld_tf32"] += 1
    else:
        out = _launch_mha_bld("fused_mha_bld", q, k, v, num_heads, causal)
    launch_counts["fused_mha_bld"] += 1
    return out


def _heads_view(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, L, H*dh) -> its (B, H, L, dh) view, no copy (``t`` may itself be a
    column slice of a packed projection)."""
    return t.unflatten(-1, (num_heads, t.shape[-1] // num_heads)).transpose(1, 2)


def _blocked_args(name: str, tensors) -> tuple:
    """(B, H, L, dh) views -> the pointer and (batch, head, row) stride arrays
    the entries of either KV-blocked backward pair take."""
    ptrs, strides = [], []
    for t in tensors:
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: shape {tuple(t.shape)}: the last dimension must be contiguous")
        ptrs.append(t.data_ptr())
        strides.extend(t.stride()[:3])
    return (ctypes.c_void_p * len(ptrs))(*ptrs), (ctypes.c_int64 * len(strides))(*strides)


def _blocked_pair(dtype: torch.dtype, dh: int) -> str:
    """Which KV-blocked backward pair these operands launch: "tc" (mha_tc_bwd.cu,
    bf16 at head dim 64), "tf32" (mha_tf32_bwd.cu, fp32 at head dim 64) or
    "cuda" (mha_blocked_bwd.cu, the smaller head dims)."""
    if mha_tc_eligible(dtype, dh):
        return "tc"
    return "tf32" if mha_tf32_eligible(dtype, dh) else "cuda"


def _count_pair(pair: str) -> None:
    """One launch of a backward entry on ``pair``: the tensor-core pairs have a
    route count each, the CUDA-core pair none."""
    if pair != "cuda":
        route_counts[f"blocked_bwd_{pair}"] += 1


def _check_blocked(name: str, q, k, v, g) -> str:
    """Raise on what the KV-blocked backward kernels do not take -> the pair
    these operands launch (``_blocked_pair``)."""
    _check_bld(name, q, k, v)
    b, h, l, dh = q.shape
    itemsize = q.element_size()
    pair = _blocked_pair(q.dtype, dh)
    need = {"tc": blocked_bwd_tc_smem_bytes, "tf32": blocked_bwd_tf32_smem_bytes}.get(
        pair, lambda dh: blocked_bwd_smem_bytes(dh, itemsize))
    _check_kernel_shape(name, q, dh, 1, need)
    if g.shape != q.shape or g.dtype != q.dtype or g.device != q.device:
        raise ValueError(
            f"{name}: gradient {tuple(g.shape)} {g.dtype} for q {tuple(q.shape)} {q.dtype}"
        )
    # the CUDA-core pair has the heads on a grid axis of 65535; the tensor-core
    # pairs one block per (batch, head, tile) on the first
    if l > _INT_MAX or (h > 65535 if pair == "cuda" else b * h * -(-l // BWD_BLOCK_KV) > _INT_MAX):
        raise ValueError(f"{name}: shape {tuple(q.shape)} is beyond the launch grid")
    return pair


def _tensor_core_entry(name: str, kernel: str, pair: str, l, *operands):
    """The library entry of a tensor-core pair's ``kernel`` ("dq" or "dkv"),
    after the checks its operands owe it: the log-sum-exp alone as the row
    statistic, every operand in 16-byte pieces."""
    if l is not None:
        raise ValueError(f"{name}: the tensor-core pair takes the log-sum-exp, not m and l")
    _check_16_byte_pieces(name, *operands)
    return getattr(load_library(), f"acl_blocked_{kernel}_{pair}")


def _launch_blocked_dq(name: str, q, k, v, g, dq, m, l, delta, recompute: bool, causal: bool) -> None:
    """Launch the dq pass over (B, H, L, dh) views for entry ``name``, after
    ``_check_blocked``. ``acl_blocked_dq`` (mha_blocked_bwd.cu): the (B, H, L)
    fp32 statistics m, l, delta are written when ``recompute``, else read (l may
    be None: then 1). ``acl_blocked_dq_tc`` (mha_tc_bwd.cu, bf16 at head dim
    64) and ``acl_blocked_dq_tf32`` (mha_tf32_bwd.cu, fp32 at head dim 64): l
    is None and m is the log-sum-exp, written with delta when ``recompute``,
    else read. Counts nothing."""
    b, h, seq, dh = q.shape
    ptrs, strides = _blocked_args(name, (q, k, v, g, dq))
    ptr = ctypes.c_void_p
    pair = _blocked_pair(q.dtype, dh)
    if pair != "cuda":
        err = _tensor_core_entry(name, "dq", pair, l, q, k, v, g, dq)(
            ptrs, strides, ptr(m.data_ptr()), ptr(delta.data_ptr()), int(recompute),
            b, h, seq, dh, int(causal), 1.0 / math.sqrt(dh), _stream(q),
        )
    else:
        err = load_library().acl_blocked_dq(
            _DTYPE_CODES[q.dtype], ptrs, strides, ptr(m.data_ptr()),
            ptr(None if l is None else l.data_ptr()), ptr(delta.data_ptr()), int(recompute),
            b, h, seq, dh, int(causal), 1.0 / math.sqrt(dh), _stream(q),
        )
    _raise_on_error(name, err)


def _launch_blocked_dkv(name: str, q, k, v, g, dk, dv, m, l, delta, causal: bool) -> None:
    """Launch the dk, dv pass over (B, H, L, dh) views for entry ``name``, after
    ``_check_blocked``, reading the statistics as the dq pass of the same pair
    takes them: ``acl_blocked_dkv``, or ``acl_blocked_dkv_tc`` in bf16 and
    ``acl_blocked_dkv_tf32`` in fp32 at head dim 64. Counts nothing."""
    b, h, seq, dh = q.shape
    ptrs, strides = _blocked_args(name, (q, k, v, g, dk, dv))
    ptr = ctypes.c_void_p
    pair = _blocked_pair(q.dtype, dh)
    if pair != "cuda":
        err = _tensor_core_entry(name, "dkv", pair, l, q, k, v, g, dk, dv)(
            ptrs, strides, ptr(m.data_ptr()), ptr(delta.data_ptr()),
            b, h, seq, dh, int(causal), 1.0 / math.sqrt(dh), _stream(q),
        )
    else:
        err = load_library().acl_blocked_dkv(
            _DTYPE_CODES[q.dtype], ptrs, strides, ptr(m.data_ptr()),
            ptr(None if l is None else l.data_ptr()), ptr(delta.data_ptr()),
            b, h, seq, dh, int(causal), 1.0 / math.sqrt(dh), _stream(q),
        )
    _raise_on_error(name, err)


def _blocked_bwd_recompute(name: str, q, k, v, g, dq, dk, dv, causal: bool = False) -> str:
    """The KV-blocked backward with the row statistics rebuilt by the dq pass
    (delta = rowsum(P o dP) with P normalised in fp32: the whole-block
    backwards' rounding) and handed to the dkv pass, all over (B, H, L, dh)
    views; the gradients are written into dq, dk, dv. The CUDA-core pair hands
    over the row max, the row sum and delta; the tensor-core pairs (bf16 and
    split-TF32) the log-sum-exp and delta. Counts nothing -> the pair it took
    (``_blocked_pair``)."""
    pair = _check_blocked(name, q, k, v, g)
    b, h, l, _ = q.shape
    stats = torch.empty((3 if pair == "cuda" else 2, b, h, l), dtype=torch.float32, device=q.device)
    m, row_sum, delta = stats[0], (stats[1] if pair == "cuda" else None), stats[-1]
    _launch_blocked_dq(name, q, k, v, g, dq, m, row_sum, delta, True, causal)
    _launch_blocked_dkv(name, q, k, v, g, dk, dv, m, row_sum, delta, causal)
    return pair


def _bwd_route(name: str, t: torch.Tensor, l: int, d: int, num_heads: int) -> str:
    """``attention_bwd_route`` for a kernel launch, after the dtype and head-dim
    checks every backward kernel shares (the entry's whole-head kernel's head
    dims; the KV-blocked pair takes ``_HEAD_DIMS``); raises where it has no
    kernel."""
    dh = _check_kernel_shape(name, t, d, num_heads, lambda dh: 0)
    route = attention_bwd_route(l, dh, t.element_size(), smem_limit(t.device))
    if route == "blocked" and dh not in _HEAD_DIMS:
        raise ValueError(f"{name}: shape {tuple(t.shape)} needs the KV-blocked backward, which takes "
                         f"head dims {_HEAD_DIMS}, not {dh}")
    if route is None:
        raise ValueError(
            f"{name}: shape {tuple(t.shape)} needs {mha_bwd_smem_bytes(l, dh)} B of shared memory "
            f"per block for the whole-head backward or {blocked_bwd_smem_bytes(dh, t.element_size())} "
            f"B for the KV-blocked one, the card gives {smem_limit(t.device)}"
        )
    return route


def _launch_qkv_whole_tf32(qkv, g, num_heads: int, causal: bool) -> torch.Tensor:
    """K3 on ``acl_mha_qkv_whole_tf32_bwd`` (mha_whole_tf32_bwd.cu), after the
    checks it owes its operands: the packed dqkv. Counts the route only."""
    b, l, d3 = qkv.shape
    dh = _check_kernel_shape("mha_qkv_bwd", qkv, d3 // 3, num_heads,
                             lambda dh: mha_whole_tf32_smem_bytes(l))
    bs, rs = _strides("mha_qkv_bwd", qkv, qkv.shape)
    _check_16_byte_pieces("mha_qkv_bwd", qkv, g)
    if b * num_heads > _INT_MAX:
        raise ValueError(f"mha_qkv_bwd: shape {tuple(qkv.shape)} is beyond the launch grid")
    dqkv = torch.empty((b, l, d3), dtype=qkv.dtype, device=qkv.device)
    err = load_library().acl_mha_qkv_whole_tf32_bwd(
        qkv.data_ptr(), bs, rs, g.data_ptr(), dqkv.data_ptr(), b, l, num_heads, dh, int(causal),
        1.0 / math.sqrt(dh), _stream(qkv),
    )
    _raise_on_error("mha_qkv_bwd", err)
    route_counts["whole_bwd_tf32"] += 1
    return dqkv


def mha_qkv_bwd_kernel(qkv, g, num_heads: int, causal: bool) -> torch.Tensor:
    """K3: the packed (B, L, 3D) dqkv, from ``acl_mha_qkv_whole_tf32_bwd`` (fp32
    at head dim 64 with L <= 112: ``mha_whole_tf32_eligible``), else from
    ``acl_mha_qkv_bwd`` where the whole-head kernel's shared memory fits, else
    from the KV-blocked pair."""
    b, l, d3 = qkv.shape
    d = d3 // 3
    if g.shape != (b, l, d) or g.device != qkv.device:
        raise ValueError(f"mha_qkv_bwd: gradient {tuple(g.shape)} for qkv {tuple(qkv.shape)}")
    if d % num_heads == 0 and mha_whole_tf32_eligible(qkv.dtype, d // num_heads, l):
        dqkv = _launch_qkv_whole_tf32(qkv, g.to(qkv.dtype).contiguous(), num_heads, causal)
        launch_counts["mha_qkv_bwd"] += 1
        return dqkv
    route = _bwd_route("mha_qkv_bwd", qkv, l, d, num_heads)
    g = g.to(qkv.dtype).contiguous()
    dqkv = torch.empty((b, l, d3), dtype=qkv.dtype, device=qkv.device)
    if route == "blocked":
        views = [_heads_view(t, num_heads) for t in (*_unpack_qkv(qkv), g, *_unpack_qkv(dqkv))]
        _count_pair(_blocked_bwd_recompute("mha_qkv_bwd", *views, causal))
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
    """(dq, dk, dv), each (B, L, D), for entry ``name``:
    ``acl_mha_bld_whole_tf32_bwd`` in fp32 at head dim 64 with L <= 112
    (``mha_whole_tf32_eligible``), else ``acl_mha_bld_bwd`` where the
    whole-head kernel's shared memory fits, else the KV-blocked pair; q, k, v
    are read in place. Counts no launch, only the route."""
    b, l, d = q.shape
    if d % num_heads == 0 and mha_whole_tf32_eligible(q.dtype, d // num_heads, l):
        g = g.to(q.dtype).contiguous()
        dh, scale, strides = _bld_tf32_args(name, (q, k, v, g), num_heads, "whole_bwd")
        grads = tuple(torch.empty((b, l, d), dtype=q.dtype, device=q.device) for _ in range(3))
        err = load_library().acl_mha_bld_whole_tf32_bwd(
            q.data_ptr(), *strides[0:2], k.data_ptr(), *strides[2:4], v.data_ptr(), *strides[4:6],
            g.data_ptr(), *strides[6:8], *(t.data_ptr() for t in grads),
            b, l, num_heads, dh, int(causal), scale, _stream(q),
        )
        _raise_on_error(name, err)
        route_counts["whole_bwd_tf32"] += 1
        return grads
    _check_bld(name, q, k, v)
    route = _bwd_route(name, q, l, d, num_heads)
    if g.shape != q.shape or g.device != q.device:
        raise ValueError(f"{name}: gradient {tuple(g.shape)} for q {tuple(q.shape)}")
    g = g.to(q.dtype).contiguous()
    dq, dk, dv = (torch.empty((b, l, d), dtype=q.dtype, device=q.device) for _ in range(3))
    if route == "blocked":
        views = [_heads_view(t, num_heads) for t in (q, k, v, g, dq, dk, dv)]
        _count_pair(_blocked_bwd_recompute(name, *views, causal))
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
    """K4: (dq, dk, dv), each (B, L, D), from ``acl_mha_bld_tf32_bwd`` (fp32 at
    head dims 16 and 32 with L <= 32: ``mha_bld_tf32_eligible``), else as
    ``_launch_mha_bld_bwd`` routes; q, k, v are read in place."""
    b, l, d = q.shape
    if d % num_heads == 0 and mha_bld_tf32_eligible(q.dtype, d // num_heads, l):
        g = g.to(q.dtype).contiguous()
        dh, scale, strides = _bld_tf32_args("mha_bld_bwd", (q, k, v, g), num_heads, "bld_bwd")
        grads = tuple(torch.empty((b, l, d), dtype=q.dtype, device=q.device) for _ in range(3))
        err = load_library().acl_mha_bld_tf32_bwd(
            q.data_ptr(), *strides[0:2], k.data_ptr(), *strides[2:4], v.data_ptr(), *strides[4:6],
            g.data_ptr(), *strides[6:8], *(t.data_ptr() for t in grads),
            b, l, num_heads, dh, int(causal), scale, _stream(q),
        )
        _raise_on_error("mha_bld_bwd", err)
        route_counts["bld_bwd_tf32"] += 1
    else:
        grads = _launch_mha_bld_bwd("mha_bld_bwd", q, k, v, g, num_heads, causal)
    launch_counts["mha_bld_bwd"] += 1
    return grads


def fused_attention_bwd_kernel(q, k, v, g, causal: bool) -> tuple:
    """K5's whole-block backward over (B, H, L, Dh): K4's route with the heads
    folded into the batch (``_fused_attention_bwd``, :1171-1181): the
    split-TF32 whole-head kernel in fp32 at head dim 64 with L <= 112, else
    mha_bwd.cu where its shared memory fits, else the KV-blocked pair on the
    four-dimensional views as they are."""
    b, h, l, dh = q.shape
    whole_tf32 = mha_whole_tf32_eligible(q.dtype, dh, l)
    route = "whole" if whole_tf32 else _bwd_route("fused_attention", q, l, dh, 1)
    if route == "blocked":
        g = g.to(q.dtype).contiguous()
        grads = tuple(torch.empty((b, h, l, dh), dtype=q.dtype, device=q.device) for _ in range(3))
        _count_pair(_blocked_bwd_recompute("fused_attention", q, k, v, g, *grads, causal))
    else:
        folded = [t.reshape(b * h, l, dh) for t in (q, k, v, g)]
        grads = _launch_mha_bld_bwd("fused_attention", *folded, 1, causal)
        grads = tuple(t.reshape(b, h, l, dh) for t in grads)
    launch_counts["fused_attention"] += 1
    return grads


def mha_qtile_bwd_kernel(q, kv, g, num_heads: int) -> tuple:
    """K7: launch the KV-blocked pair (the tensor-core one in bf16 and the
    split-TF32 one in fp32 at head dim 64) with the row statistics recomputed ->
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
    _count_pair(_blocked_bwd_recompute("mha_qtile_bwd", *(_heads_view(t, num_heads) for t in tensors)))
    launch_counts["mha_qtile_bwd"] += 1
    return dq, dkv


def _as_heads(t: torch.Tensor) -> torch.Tensor:
    """Per-head (N, L, dh) -> its (N, 1, L, dh) view; (B, H, L, dh) as it is."""
    return t.unsqueeze(1) if t.dim() == 3 else t


def _empty_heads(q: torch.Tensor) -> torch.Tensor:
    """An output of q's shape: (N, L, dh) contiguous, or (B, H, L, dh) laid out
    as (B, L, H, dh), so that folding its heads back into (B, L, H * dh), as the
    core rung does, is a view and not a copy."""
    if q.dim() == 3:
        return torch.empty(q.shape, dtype=q.dtype, device=q.device)
    b, h, l, dh = q.shape
    return torch.empty((b, l, h, dh), dtype=q.dtype, device=q.device).transpose(1, 2)


def _flash_bwd_views(q, k, v, g, lse, delta) -> tuple:
    """The (B, H, L, dh) views and (B, H, L) statistics the blocked kernels take,
    from per-head (N, L, dh) operands (H = 1) or from the (B, H, L, dh) views
    ``fused_attention`` hands over, read in place; g is copied only where a
    kernel could not read it in 16-byte pieces."""
    if lse.shape != q.shape[:-1] or delta.shape != q.shape[:-1]:
        raise ValueError(
            f"flash backward: lse {tuple(lse.shape)} and delta {tuple(delta.shape)} for q {tuple(q.shape)}"
        )
    g = g.to(q.dtype)
    if g.stride(-1) != 1 or not _in_16_byte_pieces(g):
        g = g.contiguous()
    views = [_as_heads(t) for t in (q, k, v, g)]
    stats = (t.float().contiguous().view(views[0].shape[:-1]) for t in (lse, delta))
    return views, *stats


def flash_dq_kernel(q, k, v, g, lse, delta, causal: bool = False) -> torch.Tensor:
    """K9: launch ``acl_blocked_dq`` (``acl_blocked_dq_tc`` in bf16 and
    ``acl_blocked_dq_tf32`` in fp32 at head dim 64) with the given statistics
    over per-head (N, L, dh), or over the (B, H, L, dh) views of
    ``fused_attention`` -> dq of q's shape."""
    views, lse, delta = _flash_bwd_views(q, k, v, g, lse, delta)
    pair = _check_blocked("flash_dq", *views)
    dq = _empty_heads(q)
    _launch_blocked_dq("flash_dq", *views, _as_heads(dq), lse, None, delta, False, causal)
    launch_counts["flash_dq"] += 1
    _count_pair(pair)
    return dq


def flash_dkv_kernel(q, k, v, g, lse, delta, causal: bool = False) -> tuple:
    """K10: launch ``acl_blocked_dkv`` (``acl_blocked_dkv_tc`` in bf16 and
    ``acl_blocked_dkv_tf32`` in fp32 at head dim 64) with the given statistics
    over per-head (N, L, dh), or over the (B, H, L, dh) views of
    ``fused_attention`` -> (dk, dv), each of q's shape."""
    views, lse, delta = _flash_bwd_views(q, k, v, g, lse, delta)
    pair = _check_blocked("flash_dkv", *views)
    dk, dv = _empty_heads(q), _empty_heads(q)
    _launch_blocked_dkv("flash_dkv", *views, _as_heads(dk), _as_heads(dv), lse, None, delta, causal)
    launch_counts["flash_dkv"] += 1
    _count_pair(pair)
    return dk, dv


def flash_bwd_kernel(q, k, v, g, lse, out, causal: bool = False) -> tuple:
    """K9 and K10: (dq, dk, dv) over per-head (N, L, dh), or over the (B, H, L,
    dh) views of ``fused_attention``, from the forward's saved log-sum-exp and
    output."""
    g = g.to(q.dtype)
    delta = flash_delta(g, out)
    dq = flash_dq_kernel(q, k, v, g, lse, delta, causal)
    return (dq, *flash_dkv_kernel(q, k, v, g, lse, delta, causal))


def mha_qtile_fwd_kernel(q, kv, num_heads: int) -> torch.Tensor:
    """K6: launch ``acl_mha_qtile_tc_fwd`` (bf16 at head dim 64),
    ``acl_mha_qtile_tf32_fwd`` (fp32 at head dim 64) or ``acl_mha_qtile_fwd``
    (everything else: the CUDA-core kernel with K and V staged in the operand
    type) -> (B, L, D); q and the two halves of kv are read in place. The
    admission limit is the CUDA-core kernel's whatever kernel launches."""
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
    tensor_cores, tf32 = mha_tc_eligible(q.dtype, dh), mha_tf32_eligible(q.dtype, dh)
    if tensor_cores or tf32:
        _check_tc("fused_mha_qtile", out, num_heads, q, kv,
                  smem_need=mha_tc_smem_bytes if tensor_cores else mha_tf32_smem_bytes)
        lib = load_library()
        entry = lib.acl_mha_qtile_tc_fwd if tensor_cores else lib.acl_mha_qtile_tf32_fwd
        err = entry(
            ptr(q.data_ptr()), *q_strides, ptr(kv.data_ptr()), *kv_strides,
            ptr(out.data_ptr()), b, l, num_heads, dh, 1.0 / math.sqrt(dh), _stream(q),
        )
    else:
        err = load_library().acl_mha_qtile_fwd(
            _DTYPE_CODES[q.dtype], ptr(q.data_ptr()), *q_strides, ptr(kv.data_ptr()),
            *kv_strides, ptr(out.data_ptr()), b, l, num_heads, dh, 1.0 / math.sqrt(dh),
            _stream(q),
        )
    _raise_on_error("fused_mha_qtile", err)
    launch_counts["fused_mha_qtile"] += 1
    route_counts["mha_tc"] += tensor_cores
    route_counts["mha_tf32"] += tf32
    return out


def flash_fwd_kernel(q, k, v, save_lse: bool, causal: bool = False):
    """K8 over per-head (N, L, dh), or over the (B, H, L, dh) views
    ``fused_attention`` hands over -> out of q's shape, or (out, lse) with the
    fp32 log-sum-exp of shape q.shape[:-1]. At head dim 64 bf16 launches
    ``acl_flash_tc_fwd`` and fp32 ``acl_flash_tf32_fwd``, which read q, k, v in
    place through (batch, head, row) strides and write the output in (B, L, H,
    dh) layout (``_empty_heads``); the smaller head dims ``acl_flash_fwd``,
    which takes per-head tensors: four-dimensional views are folded into them.
    The admission limit is mha_long.cu's whatever kernel launches."""
    _check_bld("flash_attention_heads", q, k, v)
    l, dh = q.shape[-2:]
    itemsize = q.element_size()
    _check_kernel_shape(
        "flash_attention_heads", q, dh, 1, lambda dh: flash_smem_bytes(dh, itemsize)
    )
    lse = torch.empty(q.shape[:-1], dtype=torch.float32, device=q.device) if save_lse else None
    lse_ptr = ctypes.c_void_p(lse.data_ptr() if save_lse else None)
    if mha_tc_eligible(q.dtype, dh) or mha_tf32_eligible(q.dtype, dh):
        out = _launch_flash_tc("flash_attention_heads", q, k, v, lse_ptr, causal)
    else:
        folded = [t.reshape(-1, l, dh) for t in (q, k, v)]
        strides = [_strides("flash_attention_heads", t, q.shape) for t in folded]
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        ptr = ctypes.c_void_p
        err = load_library().acl_flash_fwd(
            _DTYPE_CODES[q.dtype],
            ptr(folded[0].data_ptr()), *strides[0],
            ptr(folded[1].data_ptr()), *strides[1],
            ptr(folded[2].data_ptr()), *strides[2],
            ptr(out.data_ptr()), lse_ptr, folded[0].shape[0], l, dh, int(causal), 1.0 / math.sqrt(dh),
            _stream(q),
        )
        _raise_on_error("flash_attention_heads", err)
    launch_counts["flash_attention_heads"] += 1
    return (out, lse) if save_lse else out


def _launch_flash_tc(name: str, q, k, v, lse_ptr, causal: bool) -> torch.Tensor:
    """K8's tensor-core entry for entry ``name`` at head dim 64
    (``acl_flash_tc_fwd`` in bf16, ``acl_flash_tf32_fwd`` in fp32), reading
    per-head (N, L, dh) or (B, H, L, dh) q, k, v in place through (batch, head,
    row) strides and writing the log-sum-exp to ``lse_ptr`` unless it is
    NULL -> the output in ``_empty_heads`` layout. Counts the route only."""
    l, dh = q.shape[-2:]
    tensor_cores = mha_tc_eligible(q.dtype, dh)
    out = _empty_heads(q)
    views = [_as_heads(t) for t in (q, k, v, out)]
    _check_tc(name, views[3], 1, *views[:3],
              smem_need=mha_tc_smem_bytes if tensor_cores else mha_tf32_smem_bytes)
    b, h = views[0].shape[:2]
    lib = load_library()
    entry = lib.acl_flash_tc_fwd if tensor_cores else lib.acl_flash_tf32_fwd
    err = entry(*_blocked_args(name, views), lse_ptr, b, h, l, dh, int(causal), 1.0 / math.sqrt(dh),
                _stream(q))
    _raise_on_error(name, err)
    route_counts["mha_tc" if tensor_cores else "mha_tf32"] += 1
    return out


def fused_attention_fwd_kernel(q, k, v, causal: bool) -> torch.Tensor:
    """K5's whole-block branch -> (B, H, L, Dh): at head dim 64 K8's tensor-core
    entry (``acl_flash_tc_fwd`` in bf16, ``acl_flash_tf32_fwd`` in fp32) on the
    views in place, without the log-sum-exp, its output in the layout that
    folds back into (B, L, H * Dh) without a copy; at the smaller head dims
    K2's kernel (``acl_mha_bld_fwd``) with the heads folded into the batch, one
    head per entry. The admission limit is mha.cu's whatever kernel launches
    (``mha_kernel_eligible``, which ``fused_attention`` asks before the call)."""
    b, h, l, dh = q.shape
    if mha_tc_eligible(q.dtype, dh) or mha_tf32_eligible(q.dtype, dh):
        _check_bld("fused_attention", q, k, v)
        _check_kernel_shape("fused_attention", q, dh, 1, lambda dh: mha_smem_bytes(l, dh))
        out = _launch_flash_tc("fused_attention", q, k, v, ctypes.c_void_p(None), causal)
    else:
        folded = [t.reshape(b * h, l, dh) for t in (q, k, v)]
        out = _launch_mha_bld("fused_attention", *folded, 1, causal).reshape(b, h, l, dh)
    launch_counts["fused_attention"] += 1
    return out


# ---------------------------------------------------------------------------
# The entries: custom operators, each with a fake implementation and autograd
# ---------------------------------------------------------------------------
#
# Each forward is a ``torch.library.custom_op`` of the "anomalyclip" namespace,
# so that ``torch.export`` records it as one node of a graph (export.py). Its
# implementation chooses when it runs: the kernel on a CUDA tensor, the plain
# version on a CPU tensor or under attention_impl("reference"); an exported
# graph therefore launches the kernels on the card and runs the plain versions
# on the CPU. Its fake implementation gives the output's shape, type and
# strides from the operands' alone, as the kernel lays it out. The backwards
# are registered with ``register_autograd``; ``setup_context`` keeps the
# forward's choice of kernel or plain version for the backward, which autograd
# runs on another thread.


def reference_block(dtype: torch.dtype, dh: int):
    """The ``block`` of the plain version that rounds like the kernel K1, K6 and
    K5's whole-block branch launch for this operand type and head dim: the
    tensor-core kernel's KV block, or None (whole rows) for the CUDA-core
    kernels and the split-TF32 ones (in fp32 the block orders the sums only)."""
    return MHA_TC_BLOCK_KV if mha_tc_eligible(dtype, dh) else None


def _heads_out(q: torch.Tensor) -> torch.Tensor:
    """An empty output of q's shape in the layout K5's and K8's kernels write:
    ``_empty_heads`` where the tensor-core entries serve q's type and head dim,
    else contiguous. Fake and real outputs share it, so an exported graph's
    strides do not depend on the device it runs on."""
    if mha_tc_eligible(q.dtype, q.shape[-1]) or mha_tf32_eligible(q.dtype, q.shape[-1]):
        return _empty_heads(q)
    return torch.empty(q.shape, dtype=q.dtype, device=q.device)


def _in_heads_layout(q: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """A plain version's output ``out`` in ``_heads_out``'s layout."""
    laid = _heads_out(q)
    return out if laid.stride() == out.stride() else laid.copy_(out)


@torch.library.custom_op("anomalyclip::fused_mha_qkv", mutates_args=())
def _mha_qkv_op(qkv: torch.Tensor, num_heads: int, causal: bool) -> torch.Tensor:
    """K1, or its plain version."""
    if _use_reference(qkv):
        block = reference_block(qkv.dtype, qkv.shape[-1] // 3 // num_heads)
        return mha_qkv_reference(qkv, num_heads, causal, block)
    return mha_qkv_fwd_kernel(qkv, num_heads, causal)


@_mha_qkv_op.register_fake
def _(qkv, num_heads, causal):
    b, l, d3 = qkv.shape
    return qkv.new_empty((b, l, d3 // 3))


def _mha_qkv_setup(ctx, inputs, output):
    """K3 backward; saves only qkv, as ``_mha_qkv_fwd`` (:479-480)."""
    qkv, ctx.num_heads, ctx.causal = inputs
    ctx.reference = _use_reference(qkv)  # the forward's choice, kept for backward
    ctx.save_for_backward(qkv)


def _mha_qkv_backward(ctx, g):
    (qkv,) = ctx.saved_tensors
    if ctx.reference:
        return mha_qkv_bwd_reference(qkv, g, ctx.num_heads, ctx.causal), None, None
    return mha_qkv_bwd_kernel(qkv, g, ctx.num_heads, ctx.causal), None, None


_mha_qkv_op.register_autograd(_mha_qkv_backward, setup_context=_mha_qkv_setup)


@torch.library.custom_op("anomalyclip::fused_mha_bld", mutates_args=())
def _mha_bld_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
                causal: bool) -> torch.Tensor:
    """K2, or its plain version."""
    if _use_reference(q):
        return mha_bld_reference(q, k, v, num_heads, causal)
    return mha_bld_fwd_kernel(q, k, v, num_heads, causal)


@_mha_bld_op.register_fake
def _(q, k, v, num_heads, causal):
    return q.new_empty(q.shape)


def _mha_bld_setup(ctx, inputs, output):
    """K4 backward; saves q, k, v, as ``_mha_bld_fwd`` (:400-401). When k and v
    are views of one tensor, autograd adds dk and dv into its gradient."""
    q, k, v, ctx.num_heads, ctx.causal = inputs
    ctx.reference = _use_reference(q)
    ctx.save_for_backward(q, k, v)


def _mha_bld_backward(ctx, g):
    q, k, v = ctx.saved_tensors
    if ctx.reference:
        grads = mha_bld_bwd_reference(q, k, v, g, ctx.num_heads, ctx.causal)
    else:
        grads = mha_bld_bwd_kernel(q, k, v, g, ctx.num_heads, ctx.causal)
    return (*grads, None, None)


_mha_bld_op.register_autograd(_mha_bld_backward, setup_context=_mha_bld_setup)


@torch.library.custom_op("anomalyclip::fused_mha_qtile", mutates_args=())
def _mha_qtile_op(q: torch.Tensor, kv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """K6, or its plain version."""
    if _use_reference(q):
        return mha_qtile_reference(q, kv, num_heads, reference_block(q.dtype, q.shape[-1] // num_heads))
    return mha_qtile_fwd_kernel(q, kv, num_heads)


@_mha_qtile_op.register_fake
def _(q, kv, num_heads):
    return q.new_empty(q.shape)


def _mha_qtile_setup(ctx, inputs, output):
    """K7 backward; saves q and kv, as ``_mha_qtile_fwd`` (:642-643): the
    backward rebuilds the softmax rows from them."""
    q, kv, ctx.num_heads = inputs
    ctx.reference = _use_reference(q)
    ctx.save_for_backward(q, kv)


def _mha_qtile_backward(ctx, g):
    q, kv = ctx.saved_tensors
    if ctx.reference:
        dq, dkv = mha_qtile_bwd_reference(q, kv, g, ctx.num_heads)
    else:
        dq, dkv = mha_qtile_bwd_kernel(q, kv, g, ctx.num_heads)
    return dq, dkv, None


_mha_qtile_op.register_autograd(_mha_qtile_backward, setup_context=_mha_qtile_setup)


@torch.library.custom_op("anomalyclip::flash_attention_heads", mutates_args=())
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, with_lse: bool,
              causal: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """K8, or its plain version -> (out, lse); lse is empty (shape (0,)) unless
    ``with_lse``."""
    if _use_reference(q):
        got = flash_attention_reference(q, k, v, with_lse, causal=causal)
        out, lse = got if with_lse else (got, None)
        out = _in_heads_layout(q, out)
    else:
        got = flash_fwd_kernel(q, k, v, with_lse, causal=causal)
        out, lse = got if with_lse else (got, None)
    return out, lse if with_lse else q.new_empty((0,), dtype=torch.float32)


@_flash_op.register_fake
def _(q, k, v, with_lse, causal):
    lse_shape = q.shape[:-1] if with_lse else (0,)
    return _heads_out(q), q.new_empty(lse_shape, dtype=torch.float32)


def _flash_setup(ctx, inputs, output):
    """K9 and K10 backward, from q, k, v, the log-sum-exp and the output, as
    ``_flash_fwd`` (:1071-1073) saves them; the lse is not differentiable."""
    q, k, v, _, ctx.causal = inputs
    ctx.reference = _use_reference(q)
    ctx.save_for_backward(q, k, v, output[1], output[0])
    ctx.mark_non_differentiable(output[1])


def _flash_backward(ctx, g, _):
    q, k, v, lse, out = ctx.saved_tensors
    if ctx.reference:
        grads = flash_attention_bwd_reference(q, k, v, g, lse, out, ctx.causal)
    else:
        grads = flash_bwd_kernel(q, k, v, g, lse, out, ctx.causal)
    return (*grads, None, None)


_flash_op.register_autograd(_flash_backward, setup_context=_flash_setup)


@torch.library.custom_op("anomalyclip::fused_attention", mutates_args=())
def _fused_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool) -> torch.Tensor:
    """K5's whole-block branch, or its plain version (rounded as the kernel
    rounds: ``reference_block``)."""
    if _use_reference(q):
        out = fused_attention_reference(q, k, v, causal, reference_block(q.dtype, q.shape[-1]))
        return _in_heads_layout(q, out)
    return fused_attention_fwd_kernel(q, k, v, causal)


@_fused_attention_op.register_fake
def _(q, k, v, causal):
    return _heads_out(q)


def _fused_attention_setup(ctx, inputs, output):
    """K5's backward (K4's route, heads folded, or the KV-blocked pair); saves
    q, k, v, as ``_fused_attention_fwd`` (:1167-1168)."""
    q, k, v, ctx.causal = inputs
    ctx.reference = _use_reference(q)
    ctx.save_for_backward(q, k, v)


def _fused_attention_backward(ctx, g):
    q, k, v = ctx.saved_tensors
    if ctx.reference:
        grads = attention_bwd_reference(q, k, v, g, ctx.causal)
    else:
        grads = fused_attention_bwd_kernel(q, k, v, g, ctx.causal)
    return (*grads, None)


_fused_attention_op.register_autograd(_fused_attention_backward, setup_context=_fused_attention_setup)

# every registered op by its entry's name (tests/test_torch_export.py runs
# torch.library.opcheck on each)
REGISTERED_OPS = {
    "fused_mha_qkv": _mha_qkv_op,
    "fused_mha_bld": _mha_bld_op,
    "fused_mha_qtile": _mha_qtile_op,
    "flash_attention_heads": _flash_op,
    "fused_attention": _fused_attention_op,
}


def fused_mha_qkv(qkv: torch.Tensor, num_heads: int, causal: bool = False) -> torch.Tensor:
    """Attention over a packed (B, L, 3D) qkv (lane order q|k|v, the layout of
    ``x @ qkv_w``) -> (B, L, D). Heads are split inside the kernels; the
    gradient is one packed (B, L, 3D) tensor."""
    return _mha_qkv_op(qkv, num_heads, causal)


def fused_mha_bld(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int, causal: bool = False
) -> torch.Tensor:
    """Attention over (B, L, D) q, k, v -> (B, L, D). k and v may be views, e.g.
    the two halves of one (B, L, 2D) projection: the kernels read them in place."""
    return _mha_bld_op(q, k, v, num_heads, causal)


def fused_mha_qtile(q: torch.Tensor, kv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Non-causal attention of q (B, L, D) against the packed k|v (B, L, 2D) ->
    (B, L, D), K and V of each head resident in the kernel's shared memory. The
    gradient is dq and one packed (B, L, 2D) dk|dv."""
    return _mha_qtile_op(q, kv, num_heads)


def _flash_heads(q, k, v, save_lse: bool, causal: bool):
    """K8 through its op -> (out, lse or None). The forward computes the
    log-sum-exp when the caller asks for it or a gradient will need it."""
    needs_grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    out, lse = _flash_op(q, k, v, save_lse or needs_grad, causal)
    return out, (lse if save_lse else None)


def flash_attention_heads(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, save_lse: bool = False, causal: bool = False
):
    """Attention over per-head (N, L, dh) q, k, v with KV-blocked online softmax
    (shared memory independent of L) -> out (N, L, dh), or (out, lse) with the
    (N, L) fp32 log-sum-exp. The reference's is non-causal; ``causal`` is for the
    shapes its router sends to the XLA formulation. Differentiable in q, k, v
    (not through lse): the backward rebuilds P from the saved log-sum-exp."""
    if q.dim() != 3:
        raise ValueError(f"flash_attention_heads takes per-head (N, L, dh) tensors, not {tuple(q.shape)}")
    out, lse = _flash_heads(q, k, v, save_lse, causal)
    return (out, lse) if save_lse else out


def fused_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False
) -> torch.Tensor:
    """Attention over per-head (B, H, L, Dh) -> (B, H, L, Dh), routed as
    ``_fused_attention_impl`` (:1121-1135) routes, with the card's limits:

    - the whole-block branch where the whole-row kernel takes the shape
      (``mha_kernel_eligible``): at head dim 64 K8's tensor-core entries on the
      views in place, at the smaller head dims K2's kernel with the heads
      folded into the batch; its backward is K4's route (the split-TF32
      whole-head kernel in fp32 at head dim 64 with L <= 112, else
      ``attention_bwd_route``'s);
    - else the flash kernel (K8, and K9 and K10 in the backward, as
      ``flash_attention_heads``) on the four-dimensional views as they are,
      with the causal mask where asked: the reference's second branch and, for
      a causal shape, the kernel in place of its third (``_xla_attention``,
      :1135, :1195). At head dim 64, in either type, neither direction copies
      the views of the core rung's packed qkv, and the output comes in the
      layout that folds back into (B, L, H * Dh) without a copy.

    The branch is chosen from the shape before any launch; what neither kernel
    takes (an operand type or a head dim that is not instantiated) raises."""
    b, h, l, dh = q.shape
    if mha_kernel_eligible(l, dh, 1, q.dtype, smem_limit(q.device)):
        return _fused_attention_op(q, k, v, causal)
    out, _ = _flash_heads(q, k, v, False, causal)
    return out
