"""The attention probes: the kernels that the measurement scripts launch, each
with its plain PyTorch version, its launch counter and its shared-memory formula.

The JAX package's scripts relaunch its Pallas kernel bodies under other
tilings, and three of them have bodies of their own
(scripts/probe_qkv_gb.py:51, scripts/probe_qtile_vmem.py:34,
scripts/bench_attn_l14.py:83, 150, 179, 201, 238, 279). Their counterparts on
the card are two CUDA kernels (ops/csrc/mha_probe.cu) behind six wrappers:

- ``probe_mha_qkv``: K1's function (``_mha_qkv_kernel``) from a packed
  (B, L, 3D) qkv, optionally causal;
- ``probe_mha_qtile``: K6's function (``_mha_qtile_kernel``) from q (B, L, D)
  and a packed k|v (B, L, 2D);
- ``probe_mha_whole``: K2's function (``_mha_bld_kernel``) from separate q, k, v
  with no q tiling: one block per batch entry and head;
- ``nosoftmax_mha``: ((q k^T) scale, cast to v's type) v, no softmax
  (bench_attn_l14.py:262-274);
- ``twopass_mha``: K6's function with K and V staged one KV part at a time and
  fp32 row state carried across the parts (bench_attn_l14.py:105-147);
- ``pair_mha``: the same for two neighbouring heads a block
  (bench_attn_l14.py:228-234).

What the TPU's axes became. The q-tile length ``lq`` is ``rows``, the query rows
a block works through against its resident K and V. The batch group ``gb``, which
on the TPU sets how many rows a program holds at a time and how much VMEM it
needs, is ``warps`` (4, 8 or 16): a warp owns one query row at a time and holds
its L-long fp32 exponent row in shared memory. ``vmem_limit_bytes`` is
``smem_cap``, the dynamic shared memory a block may ask for: 49,152 B without the
opt-in, 232,448 B with it on an H100. A configuration whose formula exceeds the
cap raises ``ProbeDoesNotFit`` with both sizes before anything is launched (the
card's form of a VMEM overflow), on the CPU too, against the H100's limit.

The probes tile the whole-row CUDA-core body (ops/csrc/mha.cu), which the
production entries run in fp32 and below head dim 64; in bf16 at head dim 64
those launch the tensor-core kernel of ops/csrc/mha_tc.cu instead, so "K6's own
tiling" below is that of the CUDA-core kernel. The probes stay as the
counterparts of the JAX scripts' own kernels.

On a CUDA tensor a wrapper launches its kernel or raises; on a CPU tensor, or
under ``attention_impl("reference")``, it runs its plain version, rounded where
the kernel rounds. The tile probes' plain versions are the production entries'
whole-row ones (tiling does not change the function); ``twopass`` and ``pair`` round P against
the running max of each KV part and have their own, as has ``nosoftmax``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from anomalyclip_tpu_torch.ops import attention as A
from anomalyclip_tpu_torch.ops.build import load_library

# launches per wrapper since the last reset_launch_counts(), each counted where
# its kernel launches and nowhere else
launch_counts = {
    "probe_mha_qkv": 0, "probe_mha_qtile": 0, "probe_mha_whole": 0,
    "nosoftmax_mha": 0, "twopass_mha": 0, "pair_mha": 0,
}

PROBE_HEAD_DIM = 64  # the one head dim mha_probe.cu instantiates
PROBE_WARPS = (4, 8, 16)
SMEM_DEFAULT = 49_152  # what a block gets without the opt-in


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


class ProbeDoesNotFit(ValueError):
    """A probe configuration needs more shared memory per block than it was
    given: the one failure that is a result of a probe."""

    def __init__(self, what: str, need: int, have: int):
        super().__init__(f"{what}: does not fit: needs {need} B of shared memory per block, given {have} B")
        self.need, self.have = need, have


# ---------------------------------------------------------------------------
# Shared memory per block, in bytes: the formulas of mha_probe.cu. That of
# ``probe_kernel`` is the whole-row kernel's, ``attention.mha_smem_bytes``, at the
# probe's staging type and warps.
# ---------------------------------------------------------------------------


def kv_part_length(l: int, parts: int) -> int:
    """Keys per KV part when L keys are cut into ``parts``: ceil(L / parts)."""
    return -(-l // parts)


def parts_smem_bytes(
    rows: int, part: int, dh: int, itemsize: int, warps: int, heads_per_block: int
) -> int:
    """``parts_kernel``: one KV part of the block's heads in the operand type (K
    rows padded by one 32-bit word), an fp32 exponent row and query row per warp,
    and the fp32 accumulator, max and sum of every row and head of the tile."""
    width = heads_per_block * dh
    kv = itemsize * part * (2 * width + 4 // itemsize)
    return kv + 4 * (warps * part + warps * dh + rows * width + 2 * rows * heads_per_block)


def fewest_parts(
    l: int, rows: int, dh: int, itemsize: int, warps: int, heads_per_block: int, smem: int
) -> int:
    """The fewest KV parts whose block fits ``smem`` bytes (1: K and V whole)."""
    for parts in range(1, l + 1):
        part = kv_part_length(l, parts)
        if parts_smem_bytes(rows, part, dh, itemsize, warps, heads_per_block) <= smem:
            return parts
    raise ProbeDoesNotFit(
        f"parts kernel (L={l}, rows={rows}, warps={warps}, heads per block {heads_per_block})",
        parts_smem_bytes(rows, 1, dh, itemsize, warps, heads_per_block), smem,
    )


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def parts_reference(q, kv, num_heads: int, parts: int = 2) -> torch.Tensor:
    """``twopass`` and ``pair``: attention of q (B, L, D) against the packed k|v
    (B, L, 2D) with the keys cut into ``parts`` of ceil(L / parts), the last one
    short: per part the running max, alpha = exp(m_old - m_new), p = exp(s -
    m_new) cast to v's type before the P.V product and summed unrounded, one
    divide at the end (``flash_attention_reference`` at that block length)."""
    b, l, d = q.shape
    dh = d // num_heads
    heads = [
        A._split_heads(t, num_heads).reshape(b * num_heads, l, dh)
        for t in (q, kv[..., :d], kv[..., d:])
    ]
    out = A.flash_attention_reference(*heads, block=kv_part_length(l, parts))
    return A._merge_heads(out.reshape(b, num_heads, l, dh))


def nosoftmax_reference(q, kv, num_heads: int) -> torch.Tensor:
    """((q k^T) / sqrt(dh), cast to v's type) v with fp32 accumulation, over q
    (B, L, D) and the packed k|v (B, L, 2D): no max, exponent, sum or divide."""
    d = q.shape[-1]
    qh, kh, vh = (A._split_heads(t, num_heads) for t in (q, kv[..., :d], kv[..., d:]))
    scores = torch.einsum("bhqd,bhkd->bhqk", qh.float(), kh.float()) * (1.0 / math.sqrt(qh.shape[-1]))
    out = torch.einsum("bhqk,bhkd->bhqd", scores.to(vh.dtype).float(), vh.float())
    return A._merge_heads(out.to(q.dtype))


# ---------------------------------------------------------------------------
# Kernel launches
# ---------------------------------------------------------------------------


def _check(name: str, t: torch.Tensor, d: int, num_heads: int, rows: int, warps: int) -> None:
    """Raise on what mha_probe.cu does not take."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: the kernel takes CUDA tensors, not {t.device}")
    if t.dtype not in A._DTYPE_CODES:
        raise ValueError(f"{name}: dtype {t.dtype} not supported (float32, bfloat16)")
    if d % num_heads or d // num_heads != PROBE_HEAD_DIM:
        raise ValueError(
            f"{name}: shape {tuple(t.shape)} with {num_heads} heads gives head dim "
            f"{d / num_heads:g}; the probes take {PROBE_HEAD_DIM}"
        )
    if warps not in PROBE_WARPS:
        raise ValueError(f"{name}: {warps} warps per block; the probes take {PROBE_WARPS}")
    if rows < 1:
        raise ValueError(f"{name}: {rows} query rows per block")
    if -(-t.shape[1] // rows) > 65535 or num_heads > 65535:
        raise ValueError(f"{name}: shape {tuple(t.shape)} at {rows} rows per block is beyond the launch grid")


def _check_fit(what: str, need: int, device: torch.device, smem_cap) -> None:
    have = A.smem_limit(device) if smem_cap is None else min(smem_cap, A.smem_limit(device))
    if need > have:
        raise ProbeDoesNotFit(what, need, have)


def _check_kv(name: str, q: torch.Tensor, kv: torch.Tensor) -> None:
    b, l, d = q.shape
    if kv.shape != (b, l, 2 * d) or kv.dtype != q.dtype or kv.device != q.device:
        raise ValueError(f"{name}: kv {tuple(kv.shape)} {kv.dtype} for q {tuple(q.shape)} {q.dtype}")


def _check_tile_fit(name: str, t: torch.Tensor, l: int, dh: int, rows: int, warps: int,
                    stage_fp32: bool, smem_cap) -> None:
    """``probe_kernel``'s shared memory at this tiling against the cap."""
    stage = 4 if stage_fp32 else t.element_size()
    _check_fit(
        f"{name} (L={l}, {rows} rows and {warps} warps per block, K and V staged in {stage} B)",
        A.mha_smem_bytes(l, dh, stage, warps), t.device, smem_cap,
    )


def probe_mha_qkv(
    qkv: torch.Tensor, num_heads: int, causal: bool = False, *,
    rows: int = 64, warps: int = 8, stage_fp32: bool = True, smem_cap=None,
) -> torch.Tensor:
    """K1's function over a packed (B, L, 3D) qkv -> (B, L, D), from
    ``probe_kernel`` at ``rows`` query rows and ``warps`` warps per block, K and
    V staged as fp32 (K1's way) or in the operand type."""
    name = "probe_mha_qkv"
    b, l, d3 = qkv.shape
    d = d3 // 3
    _check_tile_fit(name, qkv, l, d // num_heads, rows, warps, stage_fp32, smem_cap)
    if A._use_reference(qkv):
        return A.mha_qkv_reference(qkv, num_heads, causal)
    _check(name, qkv, d, num_heads, rows, warps)
    bs, rs = A._strides(name, qkv, qkv.shape)
    out = torch.empty((b, l, d), dtype=qkv.dtype, device=qkv.device)
    err = load_library().acl_probe_qkv_fwd(
        A._DTYPE_CODES[qkv.dtype], int(stage_fp32), rows, warps, ctypes.c_void_p(qkv.data_ptr()),
        bs, rs, ctypes.c_void_p(out.data_ptr()), b, l, num_heads, PROBE_HEAD_DIM, int(causal),
        1.0 / math.sqrt(PROBE_HEAD_DIM), A._stream(qkv),
    )
    A._raise_on_error(name, err)
    launch_counts[name] += 1
    return out


def _launch_qtile(name: str, entry: str, q, kv, num_heads, rows, warps, stage_fp32):
    """Launch ``probe_kernel`` on the q + packed k|v layout through C entry
    ``entry`` for wrapper ``name`` -> (B, L, D). Counts nothing."""
    b, l, d = q.shape
    _check(name, q, d, num_heads, rows, warps)
    q_strides, kv_strides = A._strides(name, q, q.shape), A._strides(name, kv, kv.shape)
    out = torch.empty((b, l, d), dtype=q.dtype, device=q.device)
    ptr = ctypes.c_void_p
    err = getattr(load_library(), entry)(
        A._DTYPE_CODES[q.dtype], int(stage_fp32), rows, warps, ptr(q.data_ptr()), *q_strides,
        ptr(kv.data_ptr()), *kv_strides, ptr(out.data_ptr()), b, l, num_heads, PROBE_HEAD_DIM,
        1.0 / math.sqrt(PROBE_HEAD_DIM), A._stream(q),
    )
    A._raise_on_error(name, err)
    return out


def probe_mha_qtile(
    q: torch.Tensor, kv: torch.Tensor, num_heads: int, *,
    rows: int = 64, warps: int = 8, stage_fp32: bool = False, smem_cap=None,
) -> torch.Tensor:
    """K6's function, q (B, L, D) against the packed k|v (B, L, 2D) -> (B, L, D),
    from ``probe_kernel``; K and V staged in the operand type (K6's way) or as
    fp32. The defaults are K6's own tiling."""
    _check_kv("probe_mha_qtile", q, kv)
    _check_tile_fit("probe_mha_qtile", q, q.shape[1], q.shape[2] // num_heads, rows, warps,
                    stage_fp32, smem_cap)
    if A._use_reference(q):
        return A.mha_qtile_reference(q, kv, num_heads)
    out = _launch_qtile("probe_mha_qtile", "acl_probe_qtile_fwd", q, kv, num_heads, rows, warps,
                        stage_fp32)
    launch_counts["probe_mha_qtile"] += 1
    return out


def nosoftmax_mha(
    q: torch.Tensor, kv: torch.Tensor, num_heads: int, *,
    rows: int = 64, warps: int = 8, stage_fp32: bool = False, smem_cap=None,
) -> torch.Tensor:
    """``nosoftmax_reference`` from ``probe_kernel`` with the softmax compiled
    out: what staging and the two products cost at a tiling."""
    _check_kv("nosoftmax_mha", q, kv)
    _check_tile_fit("nosoftmax_mha", q, q.shape[1], q.shape[2] // num_heads, rows, warps,
                    stage_fp32, smem_cap)
    if A._use_reference(q):
        return nosoftmax_reference(q, kv, num_heads)
    out = _launch_qtile("nosoftmax_mha", "acl_probe_nosoftmax_fwd", q, kv, num_heads, rows, warps,
                        stage_fp32)
    launch_counts["nosoftmax_mha"] += 1
    return out


def probe_mha_whole(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int, causal: bool = False, *,
    warps: int = 8, stage_fp32: bool = True, smem_cap=None,
) -> torch.Tensor:
    """K2's function over separate (B, L, D) q, k, v -> (B, L, D) with no q
    tiling: ``probe_kernel`` at L rows per block, one block per batch entry and
    head, K and V staged as fp32 (K2's way) unless asked otherwise."""
    name = "probe_mha_whole"
    A._check_bld(name, q, k, v)
    b, l, d = q.shape
    _check_tile_fit(name, q, l, d // num_heads, l, warps, stage_fp32, smem_cap)
    if A._use_reference(q):
        return A.mha_bld_reference(q, k, v, num_heads, causal)
    _check(name, q, d, num_heads, l, warps)
    strides = [A._strides(name, t, q.shape) for t in (q, k, v)]
    out = torch.empty((b, l, d), dtype=q.dtype, device=q.device)
    ptr = ctypes.c_void_p
    err = load_library().acl_probe_bld_fwd(
        A._DTYPE_CODES[q.dtype], int(stage_fp32), l, warps,
        ptr(q.data_ptr()), *strides[0], ptr(k.data_ptr()), *strides[1], ptr(v.data_ptr()), *strides[2],
        ptr(out.data_ptr()), b, l, num_heads, PROBE_HEAD_DIM, int(causal),
        1.0 / math.sqrt(PROBE_HEAD_DIM), A._stream(q),
    )
    A._raise_on_error(name, err)
    launch_counts[name] += 1
    return out


def _check_parts(name: str, q, kv, num_heads, rows, warps, parts, heads_per_block, smem_cap):
    """The shape checks and the shared-memory check of ``parts_kernel``."""
    _check_kv(name, q, kv)
    b, l, d = q.shape
    if num_heads % heads_per_block:
        raise ValueError(f"{name}: {num_heads} heads do not split into groups of {heads_per_block}")
    if parts < 1:
        raise ValueError(f"{name}: {parts} KV parts")
    part = kv_part_length(l, parts)
    _check_fit(
        f"{name} (L={l}, {rows} rows and {warps} warps per block, {parts} KV parts of {part} keys, "
        f"{heads_per_block} head(s) per block)",
        parts_smem_bytes(rows, part, d // num_heads, q.element_size(), warps, heads_per_block),
        q.device, smem_cap,
    )


def _launch_parts(name: str, q, kv, num_heads, rows, warps, parts, heads_per_block):
    """Launch ``parts_kernel`` for wrapper ``name`` -> (B, L, D); k and v are the
    two halves of kv, read in place. Counts nothing."""
    b, l, d = q.shape
    _check(name, q, d, num_heads, rows, warps)
    itemsize = q.element_size()
    part = kv_part_length(l, parts)
    k, v = kv[..., :d], kv[..., d:]
    strides = [A._strides(name, t, t.shape) for t in (q, k, v)]
    # K and V rows are read as 16-byte vectors
    for t, (bs, rs) in zip((k, v), strides[1:]):
        if t.data_ptr() % 16 or (bs * itemsize) % 16 or (rs * itemsize) % 16:
            raise ValueError(
                f"{name}: kv {tuple(kv.shape)} with strides {kv.stride()}: every row of k and v "
                f"must start at a 16-byte boundary"
            )
    out = torch.empty((b, l, d), dtype=q.dtype, device=q.device)
    ptr = ctypes.c_void_p
    err = load_library().acl_mha_parts_fwd(
        A._DTYPE_CODES[q.dtype], heads_per_block, rows, warps, part,
        ptr(q.data_ptr()), *strides[0], ptr(k.data_ptr()), *strides[1], ptr(v.data_ptr()), *strides[2],
        ptr(out.data_ptr()), b, l, num_heads, PROBE_HEAD_DIM, 1.0 / math.sqrt(PROBE_HEAD_DIM),
        A._stream(q),
    )
    A._raise_on_error(name, err)
    return out


def twopass_mha(
    q: torch.Tensor, kv: torch.Tensor, num_heads: int, *,
    parts: int = 2, rows: int = 64, warps: int = 8, smem_cap=None,
) -> torch.Tensor:
    """``parts_reference``: K6's function with K and V staged one of ``parts`` KV
    parts at a time, one head per block."""
    _check_parts("twopass_mha", q, kv, num_heads, rows, warps, parts, 1, smem_cap)
    if A._use_reference(q):
        return parts_reference(q, kv, num_heads, parts)
    out = _launch_parts("twopass_mha", q, kv, num_heads, rows, warps, parts, 1)
    launch_counts["twopass_mha"] += 1
    return out


def pair_parts(q: torch.Tensor, rows: int = 64, warps: int = 8, smem_cap=None) -> int:
    """The KV parts ``pair_mha`` cuts this q's keys into: the fewest whose block,
    holding two heads, fits the shared memory (1 where K and V of both fit
    whole; the H100's limit for a CPU tensor)."""
    limit = A.smem_limit(q.device)
    return fewest_parts(q.shape[1], rows, PROBE_HEAD_DIM, q.element_size(), warps, 2,
                        limit if smem_cap is None else min(smem_cap, limit))


def pair_mha(
    q: torch.Tensor, kv: torch.Tensor, num_heads: int, *,
    rows: int = 64, warps: int = 8, smem_cap=None,
) -> torch.Tensor:
    """``parts_reference`` at ``pair_parts`` KV parts, two neighbouring heads per
    block with half the warps on each: the pair's 128 columns of a K or V row
    are contiguous and staged as whole 16-byte vectors."""
    parts = pair_parts(q, rows, warps, smem_cap)
    _check_parts("pair_mha", q, kv, num_heads, rows, warps, parts, 2, smem_cap)
    if A._use_reference(q):
        return parts_reference(q, kv, num_heads, parts)
    out = _launch_parts("pair_mha", q, kv, num_heads, rows, warps, parts, 2)
    launch_counts["pair_mha"] += 1
    return out


# ---------------------------------------------------------------------------
# Occupancy: what the card says of a configuration (CUDA only)
# ---------------------------------------------------------------------------


def _blocks(name: str, blocks: int) -> int:
    if blocks < 0:
        raise RuntimeError(f"{name}: occupancy query failed with cudaError {-blocks}")
    return blocks


def probe_blocks_per_sm(
    dtype: torch.dtype, l: int, warps: int, stage_fp32: bool, softmax: bool = True
) -> int:
    """Blocks of ``probe_kernel`` one SM holds at a time at this configuration
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    stage = 4 if stage_fp32 else dtype.itemsize
    return _blocks("probe_blocks_per_sm", load_library().acl_probe_blocks_per_sm(
        A._DTYPE_CODES[dtype], PROBE_HEAD_DIM, int(stage_fp32), int(softmax), warps,
        A.mha_smem_bytes(l, PROBE_HEAD_DIM, stage, warps),
    ))


def parts_blocks_per_sm(
    dtype: torch.dtype, rows: int, part: int, warps: int, heads_per_block: int
) -> int:
    """Blocks of ``parts_kernel`` one SM holds at a time at this configuration."""
    return _blocks("parts_blocks_per_sm", load_library().acl_parts_blocks_per_sm(
        A._DTYPE_CODES[dtype], PROBE_HEAD_DIM, heads_per_block, warps,
        parts_smem_bytes(rows, part, PROBE_HEAD_DIM, dtype.itemsize, warps, heads_per_block),
    ))
