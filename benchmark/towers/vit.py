"""The CLIP ViT image tower (Radford et al. 2021, ``clip/model.py``):
ViT-B/16 at 224 px, ViT-L/14@336px and any other width, depth, patch and
side a configuration's ``clip`` gives. Its seeded weights, as
``AnomalyCLIP.build`` takes them; its plain reference encoder
(``reference/clip.py``); its forward FLOPs and its attention's least time,
from shapes.
"""

from __future__ import annotations

import torch

from benchmark import weights, work
from benchmark.reference.clip import encode_frames
from benchmark.reference.precision import Products

HEAD_DIM = 64  # CLIP's ViTs: width // 64 heads
REFERENCE_SCORE_BYTES = 1 << 30  # the fp32 attention scores a reference call holds at once


def visual_tree(clip: dict, seed: int, device) -> dict:
    d = weights.Draws()
    width, patch = clip["vision_width"], clip["vision_patch_size"]
    grid = clip["image_resolution"] // patch
    tree = {
        "patch_embed": d.leaf((3 * patch * patch, width), width**-0.5),
        "class_embedding": d.leaf((width,), width**-0.5),
        "positional_embedding": d.leaf((grid * grid + 1, width), width**-0.5),
        "ln_pre": weights.ln(d, width),
        "blocks": weights.blocks(d, clip["vision_layers"], width),
        "ln_post": weights.ln(d, width),
        "proj": d.leaf((width, clip["embed_dim"]), width**-0.5),
    }
    return weights.draw(tree, seed, "visual", device, d)


def tokens(clip: dict) -> int:
    grid = clip["image_resolution"] // clip["vision_patch_size"]
    return grid * grid + 1


def encode(visual: dict, clip: dict, frames: torch.Tensor, prod: Products) -> torch.Tensor:
    """(N, S, S, 3) uint8 RGB on the device -> (N, embed_dim) features by the plain reference."""
    return encode_frames(visual, clip, frames, prod)


def reference_chunk(clip: dict) -> int:
    """Frames a reference call encodes: as many as fit ``REFERENCE_SCORE_BYTES`` of fp32 scores."""
    per_frame = 4 * (clip["vision_width"] // HEAD_DIM) * tokens(clip) ** 2
    return max(1, REFERENCE_SCORE_BYTES // per_frame)


def flops_per_frame(clip: dict) -> float:
    patch, width = clip["vision_patch_size"], clip["vision_width"]
    patches = tokens(clip) - 1
    embed = 2 * patches * 3 * patch * patch * width
    return embed + work.tower_flops(clip["vision_layers"], width, tokens(clip)) + 2 * width * clip["embed_dim"]


def attention_bound_s(clip: dict, frames: int, dtype: str) -> float:
    """The tower's attention over ``frames`` frames: one call a layer."""
    heads = clip["vision_width"] // HEAD_DIM
    return clip["vision_layers"] * work.attention_bound_s("fwd", (frames, heads, tokens(clip), HEAD_DIM), dtype)
