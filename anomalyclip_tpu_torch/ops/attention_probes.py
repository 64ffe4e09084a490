"""The attention probes: the kernels that the measurement scripts launch, each
with its plain PyTorch version, its launch counter and its shared-memory formula.

The JAX package's scripts relaunch its Pallas kernel bodies under other
tilings, and three of them have bodies of their own
(scripts/probe_qkv_gb.py:51, scripts/probe_qtile_vmem.py:34,
scripts/bench_attn_l14.py:83, 150, 179, 201, 238, 279). Their counterparts on
the card are two tensor-core kernels (ops/csrc/mha_probe.cu) behind six
wrappers:

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

Both kernels run the arithmetic of the kernels K1 and K6 launch at head dim 64:
bf16 on ``mma.sync`` m16n8k16 as ops/csrc/mha_tc.cu, fp32 on split-TF32
m16n8k8 products as ops/csrc/mha_tf32.cu, one KV block of 64 keys being their KV
loop's body. What the TPU's axes became. The q-tile length ``lq`` is ``rows``,
the query rows of a block (any number; cut into 16-row mma tiles, the last one
masked). The batch group ``gb``, the rows a program holds at a time, is
``warps`` (4, 8 or 16), each holding one 16-row tile at a time. The TPU keeps K
and V of the head in VMEM for every q tile: ``residency="resident"`` stages them
once a block (shared memory growing with L), ``"streamed"`` brings them in
64-key blocks through two stages as mha_tc.cu does (shared memory independent
of L). At ``rows=64, warps=4, residency="streamed"`` (the defaults) the tile
probe is the shipped kernel, ``fused_mha_qtile`` and ``fused_mha_qkv`` to the
bit; every other tiling is a measured departure from it. ``vmem_limit_bytes``
is ``smem_cap``, the dynamic shared memory a block may ask for: 49,152 B
without the opt-in, 232,448 B with it on an H100. A configuration whose formula
exceeds the cap raises ``ProbeDoesNotFit`` with both sizes before anything is
launched (the card's form of a VMEM overflow), on the CPU too, against the
H100's limit.

On a CUDA tensor a wrapper launches its kernel or raises; on a CPU tensor, or
under ``attention_impl("reference")``, it runs its plain version, which rounds
where the kernel rounds: in bf16 p is rounded against the running max of each
64-key step (``attention.attention_blocked_reference``'s arithmetic; the parts
probe's steps restart at each part, the last step of a part short), in fp32
each product is formed from the operands' TF32 parts (``tf32x3_reference``'s).
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
PROBE_KV = 64  # keys a KV block, a streamed stage and a step of a sweep (mha_probe.cu: kProbeKV)
RESIDENCIES = ("streamed", "resident")
SHIPPED = {"rows": 64, "warps": 4, "residency": "streamed"}  # mha_tc.cu's and mha_tf32.cu's block
SMEM_DEFAULT = 49_152  # what a block gets without the opt-in
_STATE_FLOATS = PROBE_HEAD_DIM // 8 * 4 + 4  # a lane's accumulator, max and sum of one tile


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
# Shared memory per block, in bytes: the formulas of mha_probe.cu
# ---------------------------------------------------------------------------


def _round_up(x: int, to: int) -> int:
    return -(-x // to) * to


def _pitches(itemsize: int, width: int) -> tuple:
    """Staged K and V row lengths in elements: bf16 rows padded by 16 bytes,
    fp32 K rows by 8 floats and V rows by 4 (mha_tc.cu, mha_tf32.cu)."""
    return (width + 8, width + 8) if itemsize == 2 else (width + 8, width + 4)


def _q_rows_bytes(itemsize: int, dh: int, warps: int) -> int:
    """bf16: each warp's 16 query rows (later its output rows); fp32 reads Q
    straight into registers."""
    return 2 * warps * 16 * (dh + 8) if itemsize == 2 else 0


def tile_smem_bytes(l: int, dh: int, itemsize: int, warps: int, residency: str) -> int:
    """``probe_tile_kernel``: the warps' query rows in bf16, then K and V of the
    head, resident (L rounded up to 64 rows) or streamed (two stages of 64)."""
    kv_rows = _round_up(l, PROBE_KV) if residency == "resident" else 2 * PROBE_KV
    return _q_rows_bytes(itemsize, dh, warps) + itemsize * kv_rows * sum(_pitches(itemsize, dh))


def kv_part_length(l: int, parts: int) -> int:
    """Keys per KV part when L keys are cut into ``parts``: ceil(L / parts)."""
    return -(-l // parts)


def tiles_per_warp(rows: int, warps: int, heads_per_block: int) -> int:
    """The 16-row tiles of a head one warp of the parts kernel sweeps: one keeps
    its state in registers across the parts, more in shared memory."""
    tiles, per_head = -(-rows // 16), warps // heads_per_block
    return -(-tiles // per_head)


def parts_smem_bytes(
    rows: int, part: int, dh: int, itemsize: int, warps: int, heads_per_block: int
) -> int:
    """``probe_parts_kernel``: the warps' query rows in bf16, one KV part of the
    block's heads (rounded up to 64 rows), and, where a warp sweeps more than one
    tile, each tile's fp32 accumulator, max and sum."""
    slots = tiles_per_warp(rows, warps, heads_per_block)
    state = 4 * warps * slots * _STATE_FLOATS * 32 if slots > 1 else 0
    kv = itemsize * _round_up(part, PROBE_KV) * sum(_pitches(itemsize, heads_per_block * dh))
    return _q_rows_bytes(itemsize, dh, warps) + kv + state


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
# Plain versions, rounded where the kernels round
# ---------------------------------------------------------------------------


def _product(dtype: torch.dtype):
    """The kernels' products: fp32 einsum over bf16 operands; in fp32 the
    split-TF32 products (``attention._tf32_product``)."""
    return A._tf32_product(3) if dtype == torch.float32 else torch.einsum


def tile_steps(l: int) -> list:
    """The tile probe's KV steps: blocks of 64 keys, the last one short."""
    return [(s, min(s + PROBE_KV, l)) for s in range(0, l, PROBE_KV)]


def parts_steps(l: int, parts: int) -> list:
    """The parts probe's KV steps: each part swept in steps of 64 keys from its
    start, the last step of each part short."""
    part = kv_part_length(l, parts)
    return [(s, min(s + PROBE_KV, p0 + part, l))
            for p0 in range(0, l, part) for s in range(p0, min(p0 + part, l), PROBE_KV)]


def sweep_reference(q, k, v, steps: list, causal: bool = False) -> torch.Tensor:
    """The probes' softmax over (..., L, dh) q, k, v with online softmax over
    the KV ``steps`` (start, end) (``attention.online_softmax_steps``), one
    divide at the end. In bf16 with 64-key steps it is
    ``attention_blocked_reference``; in fp32 the products are split-TF32, as in
    ``tf32x3_reference``."""
    acc, denom, _ = A.online_softmax_steps(q, k, v, causal, steps, _product(q.dtype))
    return (acc / denom).to(q.dtype)


def _heads(num_heads: int, *tensors) -> list:
    return [A._split_heads(t, num_heads) for t in tensors]


def tile_reference(q, k, v, num_heads: int, causal: bool = False) -> torch.Tensor:
    """The tile probe's function over (B, L, D) q, k, v -> (B, L, D): the
    kernels' 64-key blocks, whatever the tiling (``probe_mha_qkv``,
    ``probe_mha_qtile``, ``probe_mha_whole``)."""
    return A._merge_heads(sweep_reference(*_heads(num_heads, q, k, v), tile_steps(q.shape[1]), causal))


def parts_reference(q, kv, num_heads: int, parts: int = 2) -> torch.Tensor:
    """``twopass`` and ``pair``: attention of q (B, L, D) against the packed k|v
    (B, L, 2D) with the keys cut into ``parts`` of ceil(L / parts), the last one
    short, each swept in 64-key steps (``parts_steps``)."""
    d = q.shape[-1]
    heads = _heads(num_heads, q, kv[..., :d], kv[..., d:])
    return A._merge_heads(sweep_reference(*heads, parts_steps(q.shape[1], parts)))


def nosoftmax_reference(q, kv, num_heads: int) -> torch.Tensor:
    """((q k^T) / sqrt(dh), cast to v's type) v with fp32 accumulation, over q
    (B, L, D) and the packed k|v (B, L, 2D): no max, exponent, sum or divide;
    in fp32 the two products split-TF32."""
    d = q.shape[-1]
    product = _product(q.dtype)
    qh, kh, vh = _heads(num_heads, q, kv[..., :d], kv[..., d:])
    scores = product("bhqd,bhkd->bhqk", qh.float(), kh.float()) * (1.0 / math.sqrt(qh.shape[-1]))
    out = product("bhqk,bhkd->bhqd", scores.to(vh.dtype).float(), vh.float())
    return A._merge_heads(out.to(q.dtype))


# ---------------------------------------------------------------------------
# Kernel launches
# ---------------------------------------------------------------------------


def _check(name: str, t: torch.Tensor, d: int, num_heads: int, rows: int, warps: int,
           heads_per_block: int = 1) -> None:
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
    blocks = t.shape[0] * (num_heads // heads_per_block) * -(-t.shape[1] // rows)
    if blocks > A._INT_MAX:
        raise ValueError(f"{name}: shape {tuple(t.shape)} at {rows} rows per block is beyond the launch grid")


def _check_rows_aligned(name: str, **operands) -> None:
    """The kernels read every operand row as 16-byte pieces (cp.async)."""
    for what, t in operands.items():
        if not A._in_16_byte_pieces(t):
            raise ValueError(
                f"{name}: {what} {tuple(t.shape)} with strides {t.stride()} at offset "
                f"{t.storage_offset()}: every row must start at a 16-byte boundary"
            )


def _check_residency(name: str, residency: str) -> None:
    if residency not in RESIDENCIES:
        raise ValueError(f"{name}: residency {residency!r} is not one of {RESIDENCIES}")


def _check_fit(what: str, need: int, device: torch.device, smem_cap) -> None:
    have = A.smem_limit(device) if smem_cap is None else min(smem_cap, A.smem_limit(device))
    if need > have:
        raise ProbeDoesNotFit(what, need, have)


def _check_kv(name: str, q: torch.Tensor, kv: torch.Tensor) -> None:
    b, l, d = q.shape
    if kv.shape != (b, l, 2 * d) or kv.dtype != q.dtype or kv.device != q.device:
        raise ValueError(f"{name}: kv {tuple(kv.shape)} {kv.dtype} for q {tuple(q.shape)} {q.dtype}")


def _check_tile_fit(name: str, t: torch.Tensor, l: int, dh: int, rows: int, warps: int,
                    residency: str, smem_cap) -> None:
    """``probe_tile_kernel``'s shared memory at this tiling against the cap."""
    _check_residency(name, residency)
    _check_fit(
        f"{name} (L={l}, {rows} rows and {warps} warps per block, K and V {residency})",
        tile_smem_bytes(l, dh, t.element_size(), warps, residency), t.device, smem_cap,
    )


def _launch_tile(name: str, entry: str, d: int, operands: dict, num_heads, rows, warps, residency,
                 *tail):
    """Launch ``probe_tile_kernel`` through C entry ``entry`` for wrapper
    ``name``: ``operands`` the tensors the entry reads, by name, in its order,
    ``tail`` its arguments after the head dim -> (B, L, D). Counts nothing."""
    t = next(iter(operands.values()))
    b, l = t.shape[:2]
    _check(name, t, d, num_heads, rows, warps)
    _check_rows_aligned(name, **operands)
    out = torch.empty((b, l, d), dtype=t.dtype, device=t.device)
    args = []
    for x in operands.values():
        args += [ctypes.c_void_p(x.data_ptr()), *A._strides(name, x, x.shape)]
    err = getattr(load_library(), entry)(
        A._DTYPE_CODES[t.dtype], int(residency == "resident"), rows, warps, *args,
        ctypes.c_void_p(out.data_ptr()), b, l, num_heads, PROBE_HEAD_DIM, *tail,
        1.0 / math.sqrt(PROBE_HEAD_DIM), A._stream(t),
    )
    A._raise_on_error(name, err)
    return out


def probe_mha_qkv(
    qkv: torch.Tensor, num_heads: int, causal: bool = False, *,
    rows: int = 64, warps: int = 4, residency: str = "streamed", smem_cap=None,
) -> torch.Tensor:
    """K1's function over a packed (B, L, 3D) qkv -> (B, L, D), from
    ``probe_tile_kernel`` at ``rows`` query rows and ``warps`` warps per block,
    K and V ``residency``. The defaults are K1's shipped block."""
    name = "probe_mha_qkv"
    b, l, d3 = qkv.shape
    _check_tile_fit(name, qkv, l, d3 // 3 // num_heads, rows, warps, residency, smem_cap)
    if A._use_reference(qkv):
        return tile_reference(*A._unpack_qkv(qkv), num_heads, causal)
    out = _launch_tile(name, "acl_probe_qkv_fwd", d3 // 3, {"qkv": qkv}, num_heads, rows, warps,
                       residency, int(causal))
    launch_counts[name] += 1
    return out


def probe_mha_qtile(
    q: torch.Tensor, kv: torch.Tensor, num_heads: int, *,
    rows: int = 64, warps: int = 4, residency: str = "streamed", smem_cap=None,
) -> torch.Tensor:
    """K6's function, q (B, L, D) against the packed k|v (B, L, 2D) -> (B, L, D),
    from ``probe_tile_kernel``. The defaults are K6's shipped block."""
    name = "probe_mha_qtile"
    _check_kv(name, q, kv)
    _check_tile_fit(name, q, q.shape[1], q.shape[2] // num_heads, rows, warps, residency, smem_cap)
    if A._use_reference(q):
        d = q.shape[-1]
        return tile_reference(q, kv[..., :d], kv[..., d:], num_heads)
    out = _launch_tile(name, "acl_probe_qtile_fwd", q.shape[-1], {"q": q, "kv": kv}, num_heads, rows,
                       warps, residency)
    launch_counts[name] += 1
    return out


def nosoftmax_mha(
    q: torch.Tensor, kv: torch.Tensor, num_heads: int, *,
    rows: int = 64, warps: int = 4, residency: str = "streamed", smem_cap=None,
) -> torch.Tensor:
    """``nosoftmax_reference`` from ``probe_tile_kernel`` with the softmax
    compiled out: what staging and the two products cost at a tiling."""
    name = "nosoftmax_mha"
    _check_kv(name, q, kv)
    _check_tile_fit(name, q, q.shape[1], q.shape[2] // num_heads, rows, warps, residency, smem_cap)
    if A._use_reference(q):
        return nosoftmax_reference(q, kv, num_heads)
    out = _launch_tile(name, "acl_probe_nosoftmax_fwd", q.shape[-1], {"q": q, "kv": kv}, num_heads,
                       rows, warps, residency)
    launch_counts[name] += 1
    return out


def probe_mha_whole(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int, causal: bool = False, *,
    warps: int = 4, residency: str = "resident", smem_cap=None,
) -> torch.Tensor:
    """K2's function over separate (B, L, D) q, k, v -> (B, L, D) with no q
    tiling: ``probe_tile_kernel`` at L rows per block, one block per batch entry
    and head, K and V of the head resident (the TPU's whole form) unless asked
    otherwise."""
    name = "probe_mha_whole"
    A._check_bld(name, q, k, v)
    b, l, d = q.shape
    _check_tile_fit(name, q, l, d // num_heads, l, warps, residency, smem_cap)
    if A._use_reference(q):
        return tile_reference(q, k, v, num_heads, causal)
    out = _launch_tile(name, "acl_probe_bld_fwd", d, {"q": q, "k": k, "v": v}, num_heads, l, warps,
                       residency, int(causal))
    launch_counts[name] += 1
    return out


def _check_parts(name: str, q, kv, num_heads, rows, warps, parts, heads_per_block, smem_cap):
    """The shape checks and the shared-memory check of ``probe_parts_kernel``."""
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
    """Launch ``probe_parts_kernel`` for wrapper ``name`` -> (B, L, D); k and v
    are the two halves of kv, read in place. Counts nothing."""
    b, l, d = q.shape
    _check(name, q, d, num_heads, rows, warps, heads_per_block)
    k, v = kv[..., :d], kv[..., d:]
    _check_rows_aligned(name, q=q, k=k, v=v)
    strides = [A._strides(name, t, t.shape) for t in (q, k, v)]
    out = torch.empty((b, l, d), dtype=q.dtype, device=q.device)
    ptr = ctypes.c_void_p
    err = load_library().acl_mha_parts_fwd(
        A._DTYPE_CODES[q.dtype], heads_per_block, rows, warps, kv_part_length(l, parts),
        ptr(q.data_ptr()), *strides[0], ptr(k.data_ptr()), *strides[1], ptr(v.data_ptr()), *strides[2],
        ptr(out.data_ptr()), b, l, num_heads, PROBE_HEAD_DIM, 1.0 / math.sqrt(PROBE_HEAD_DIM),
        A._stream(q),
    )
    A._raise_on_error(name, err)
    return out


def twopass_mha(
    q: torch.Tensor, kv: torch.Tensor, num_heads: int, *,
    parts: int = 2, rows: int = 64, warps: int = 4, smem_cap=None,
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
    block with half the warps on each (the defaults: each head at the shipped
    block's 64 rows and 4 warps): the pair's 128 columns of a K or V row are
    contiguous and staged together."""
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
    dtype: torch.dtype, l: int, warps: int, residency: str = "streamed", softmax: bool = True
) -> int:
    """Blocks of ``probe_tile_kernel`` one SM holds at a time at this
    configuration (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    return _blocks("probe_blocks_per_sm", load_library().acl_probe_blocks_per_sm(
        A._DTYPE_CODES[dtype], PROBE_HEAD_DIM, int(residency == "resident"), int(softmax), warps,
        tile_smem_bytes(l, PROBE_HEAD_DIM, dtype.itemsize, warps, residency),
    ))


def parts_blocks_per_sm(
    dtype: torch.dtype, rows: int, part: int, warps: int, heads_per_block: int
) -> int:
    """Blocks of ``probe_parts_kernel`` one SM holds at a time at this configuration."""
    return _blocks("parts_blocks_per_sm", load_library().acl_parts_blocks_per_sm(
        A._DTYPE_CODES[dtype], PROBE_HEAD_DIM, heads_per_block, warps,
        parts_smem_bytes(rows, part, PROBE_HEAD_DIM, dtype.itemsize, warps, heads_per_block),
    ))
