"""Tensor parallelism of the CLIP towers over model groups of ranks: the
counterpart of anomalyclip_tpu/parallel/tp.py.

Ranks form model groups of ``mp`` consecutive ranks; the groups are the data
axis (videos, or rows of a batch, split across them) and the ranks of one
group the model axis. Each rank holds only its shard of a tower, cut on the
host from the host tree and then uploaded, with the Megatron split of the JAX
package's head-aligned variant (tp.py:150-294):

- the qkv projection split on its output dim by whole heads, each rank's
  columns ``[q_S | k_S | v_S]`` for its run of heads S (``qkv_columns``, the
  JAX ``_qkv_head_perm`` chunk when ``mp`` divides the heads), and the MLP
  up-projection on its output dim;
- the attention out-projection and the MLP down-projection split on their
  input dim, each followed by one all-reduce over the group per block; the
  bias after an all-reduce is added once, after it;
- LayerNorms, embeddings and the final projections replicated.

Each rank runs attention on its local heads through ``attention_from_qkv``, so
on the card the image tower's attention is K1 on (B, 197, 3*768/mp) with
12/mp heads. The JAX package sends TP attention to XLA, and falls back to its
GSPMD variant where ``mp`` does not divide the heads; here each rank takes a
contiguous run of whole heads instead (the first ``heads % mp`` ranks one more),
which computes the same function. The partial sums are all-reduced in fp32.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from anomalyclip_tpu_torch.convert import tree_to
from anomalyclip_tpu_torch.models.clip.model import (
    CLIPConfig,
    attention_from_qkv,
    cast_tree,
    layer_norm,
    normalize_frames_on_device,
    patchify,
    quick_gelu,
)
from anomalyclip_tpu_torch.numerics import matmul_precision_for
from anomalyclip_tpu_torch.parallel.mesh import allgather_host, distributed, rank, world_size

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ModelGroup:
    """This rank's place on the (data, model) grid: ``index`` of ``groups``
    model groups of ``size`` ranks, ``member`` within its group. A rank past the
    last whole group is not ``active``: it scores nothing."""

    group: Any
    index: int
    groups: int
    member: int
    size: int
    active: bool = True


# mp -> (the default group the model groups were made in, its ModelGroup)
_MODEL_GROUPS: Dict[int, Tuple[Any, ModelGroup]] = {}


def model_group(mp: int) -> ModelGroup:
    """The model groups of ``mp`` consecutive ranks (JAX ``dp_mp_mesh``: model-
    axis neighbours adjacent). Every rank creates every group, in one order, as
    ``new_group`` requires; ranks past ``world // mp * mp`` join none. Made once
    per process group: a group joined after another was destroyed gets its own.
    Outside a group of processes, one group of one."""
    if not distributed():
        return ModelGroup(group=None, index=0, groups=1, member=0, size=1)
    world_group = dist.group.WORLD
    made = _MODEL_GROUPS.get(mp)
    if made is None or made[0] is not world_group:
        made = _MODEL_GROUPS[mp] = (world_group, _new_model_group(mp))
    return made[1]


def _new_model_group(mp: int) -> ModelGroup:
    world, me = world_size(), rank()
    groups = world // mp
    if groups == 0:
        raise ValueError(f"model_parallel={mp} needs at least {mp} ranks, the group has {world}")
    handles = [dist.new_group(list(range(g * mp, (g + 1) * mp))) for g in range(groups)]
    if me >= groups * mp:
        return ModelGroup(group=None, index=groups, groups=groups, member=0, size=mp, active=False)
    return ModelGroup(group=handles[me // mp], index=me // mp, groups=groups, member=me % mp, size=mp)


def split_range(n: int, parts: int, part: int) -> Tuple[int, int]:
    """The contiguous range of ``n`` items that ``part`` of ``parts`` holds, the
    first ``n % parts`` parts one item more."""
    base, extra = divmod(n, parts)
    lo = part * base + min(part, extra)
    return lo, lo + base + (part < extra)


def qkv_columns(width: int, heads: int, mp: int, member: int) -> np.ndarray:
    """The columns of the packed ``[q | k | v]`` projection that ``member``
    holds: ``[q_S | k_S | v_S]`` for its run S of whole heads."""
    if not 1 <= mp <= heads:
        raise ValueError(f"tensor parallelism needs 1 <= mp <= heads: mp={mp}, heads={heads}")
    dh = width // heads
    h0, h1 = split_range(heads, mp, member)
    return np.concatenate([np.arange(s * width + h0 * dh, s * width + h1 * dh) for s in range(3)])


def shard_block(blk: Params, heads: int, mp: int, member: int) -> Params:
    """One residual block's weights (on the CPU) -> ``member``'s shard: the
    split weights copied out, the replicated ones as they are."""
    width = blk["attn"]["out_w"].shape[0]
    cols = torch.from_numpy(qkv_columns(width, heads, mp, member))
    dh = width // heads
    h0, h1 = split_range(heads, mp, member)
    lo, hi = split_range(blk["mlp"]["fc_w"].shape[1], mp, member)
    attn, mlp = blk["attn"], blk["mlp"]
    return {
        "ln_1": blk["ln_1"],
        "attn": {
            "qkv_w": attn["qkv_w"][:, cols],
            "qkv_b": attn["qkv_b"][cols],
            "out_w": attn["out_w"][h0 * dh : h1 * dh].contiguous(),
            "out_b": attn["out_b"],
        },
        "ln_2": blk["ln_2"],
        "mlp": {
            "fc_w": mlp["fc_w"][:, lo:hi].contiguous(),
            "fc_b": mlp["fc_b"][lo:hi].contiguous(),
            "proj_w": mlp["proj_w"][lo:hi].contiguous(),
            "proj_b": mlp["proj_b"],
        },
    }


def shard_tower(params: Params, cfg: CLIPConfig, tower: str, mp: int, member: int, device) -> Params:
    """``{tower: shard}``: ``member``'s shard of the ViT ``"visual"`` or the
    ``"text"`` tower of a CLIP tree of tensors, cut on the host and then
    uploaded to ``device`` leaf by leaf, so that the device never holds the
    whole tower (JAX tests/test_tensor_parallel.py:156)."""
    if tower == "visual" and cfg.is_resnet:
        raise ValueError("a ModifiedResNet tower has no tensor-parallel sharding")
    heads = cfg.vision_heads if tower == "visual" else cfg.transformer_heads
    host = tree_to(params[tower], "cpu")
    shard = {k: v for k, v in host.items() if k != "blocks"}
    shard["blocks"] = [shard_block(blk, heads, mp, member) for blk in host["blocks"]]
    return {tower: tree_to(shard, device)}


def _all_reduce(partial: torch.Tensor, group) -> torch.Tensor:
    """The sum over the model group of ``partial``, taken in fp32, in the
    partial's dtype."""
    total = partial.float()
    if group is not None:
        dist.all_reduce(total, group=group)
    return total.to(partial.dtype)


def _tp_block(x: torch.Tensor, blk: Params, heads: int, causal: bool, group) -> torch.Tensor:
    """One pre-LN residual block on this rank's heads and hidden units, two
    all-reduces (``_block_apply`` of models/clip/model.py, split)."""
    h = layer_norm(x, blk["ln_1"]["scale"], blk["ln_1"]["bias"])
    qkv = h @ blk["attn"]["qkv_w"] + blk["attn"]["qkv_b"]
    attn = attention_from_qkv(qkv, heads, causal)
    x = x + (_all_reduce(attn @ blk["attn"]["out_w"], group) + blk["attn"]["out_b"])
    h = layer_norm(x, blk["ln_2"]["scale"], blk["ln_2"]["bias"])
    h = quick_gelu(h @ blk["mlp"]["fc_w"] + blk["mlp"]["fc_b"])
    return x + (_all_reduce(h @ blk["mlp"]["proj_w"], group) + blk["mlp"]["proj_b"])


def _local_heads(blk: Params, width: int, heads: int) -> int:
    return blk["attn"]["qkv_w"].shape[1] // 3 // (width // heads)


def tp_transformer(x: torch.Tensor, blocks: list, width: int, heads: int, group,
                   causal: bool = False) -> torch.Tensor:
    """The sharded residual blocks in order, their weights cast to the stream's
    dtype as ``transformer_apply`` casts them."""
    for blk in blocks:
        x = _tp_block(x, cast_tree(blk, x.dtype), _local_heads(blk, width, heads), causal, group)
    return x


def tp_encode_image(shard: Params, cfg: CLIPConfig, images: torch.Tensor,
                    compute_dtype: torch.dtype = torch.float32, group=None) -> torch.Tensor:
    """The ViT visual forward of ``encode_image`` on a shard (``shard_tower``),
    the model group ``group`` holding the other shards: (B, H, W, 3) -> (B,
    embed_dim) on every rank of the group (JAX ``tp_encode_images_aligned``).
    uint8 input is CLIP-normalized on the device first."""
    if images.dtype == torch.uint8:
        images = normalize_frames_on_device(images)
    visual = shard["visual"]
    with matmul_precision_for(compute_dtype):
        x = patchify(images.to(compute_dtype), cfg.vision_patch_size)
        x = x @ visual["patch_embed"].to(compute_dtype)
        cls = visual["class_embedding"].to(compute_dtype).expand(x.shape[0], 1, cfg.vision_width)
        x = torch.cat([cls, x], dim=1)
        x = x + visual["positional_embedding"].to(compute_dtype)
        x = layer_norm(x, visual["ln_pre"]["scale"], visual["ln_pre"]["bias"])
        x = tp_transformer(x, visual["blocks"], cfg.vision_width, cfg.vision_heads, group)
        x = layer_norm(x[:, 0, :], visual["ln_post"]["scale"], visual["ln_post"]["bias"])
        return x @ visual["proj"].to(compute_dtype)


def tp_encode_text(shard: Params, cfg: CLIPConfig, tokens: torch.Tensor,
                   compute_dtype: torch.dtype = torch.float32, group=None) -> torch.Tensor:
    """The text forward of ``encode_text`` on a shard of the text tower, causal
    attention on this rank's heads: (N, 77) token ids -> (N, embed_dim) on
    every rank of the group (JAX ``tp_encode_text``, tp.py:289-294)."""
    text = shard["text"]
    tokens = tokens.long()
    with matmul_precision_for(compute_dtype):
        x = text["token_embedding"][tokens].to(compute_dtype) + text["positional_embedding"].to(compute_dtype)
        x = tp_transformer(x, text["blocks"], cfg.transformer_width, cfg.transformer_heads, group, causal=True)
        x = layer_norm(x, text["ln_final"]["scale"], text["ln_final"]["bias"])
        x = x[torch.arange(x.shape[0], device=x.device), tokens.argmax(dim=-1).to(x.device)]
        return x @ text["text_projection"].to(compute_dtype)


def tp_encode_rows(encode: Callable[[torch.Tensor], torch.Tensor], batch: torch.Tensor,
                   mg: ModelGroup, out_dim: int) -> torch.Tensor:
    """A global batch over the (data, model) grid -> (B, out_dim) fp32 on every
    rank, in row order: model group ``mg.index`` encodes its contiguous block
    of rows through ``encode`` (the groups must divide the batch), and each
    block comes back from its group's first rank (JAX's batch-sharded
    ``in_shardings`` and ``out_shardings``). A rank that is not ``active``
    sends zeros."""
    if batch.shape[0] % mg.groups:
        raise ValueError(f"batch of {batch.shape[0]} rows over {mg.groups} model groups")
    per = batch.shape[0] // mg.groups
    if mg.active:
        block = encode(batch[mg.index * per : (mg.index + 1) * per]).float()
    else:
        block = torch.zeros(per, out_dim)
    parts = allgather_host(block.detach().cpu().numpy())
    return torch.from_numpy(np.concatenate([parts[g * mg.size] for g in range(mg.groups)]))


def tp_image_encoder(clip_params: Params, cfg: CLIPConfig, mp: int, device,
                     compute_dtype: torch.dtype, chunk: Optional[int] = None) -> Callable:
    """-> encode(frozen, frames) -> (N, D): the frame encoder of a rank of a
    model group of ``mp`` (``model_group``), over its shard of the visual
    tower, in ``chunk``-frame calls when N is a multiple of it (as
    ``AnomalyCLIP.encode_frames`` chunks). The ``frozen`` it is given is not
    read: the encoder holds its shard (``encode.shard``)."""
    mg = model_group(mp)
    shard = shard_tower(clip_params, cfg, "visual", mp, mg.member, device)

    def encode(_frozen, frames: torch.Tensor) -> torch.Tensor:
        n = frames.shape[0]
        with torch.no_grad():
            if chunk is not None and n > chunk and n % chunk == 0:
                return torch.cat([tp_encode_image(shard, cfg, c, compute_dtype, mg.group)
                                  for c in frames.split(chunk)])
            return tp_encode_image(shard, cfg, frames, compute_dtype, mg.group)

    encode.tp = True
    encode.shard = shard
    encode.model_group = mg
    return encode
