"""CLIP's towers (Radford et al. 2021, ``clip/model.py``) in plain PyTorch:
the ViT image tower from uint8 RGB frames and the causal text tower from prompt
embeddings. Pre-LN residual blocks, LayerNorm in fp32 with eps 1e-5,
QuickGELU, softmax attention; the weights are the benchmark's trees (linear
weights stored (in, out)).
"""

from __future__ import annotations

import torch

from benchmark.reference.precision import Products

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def layer_norm(x: torch.Tensor, p: dict, eps: float = 1e-5) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * p["scale"].float() + p["bias"].float()


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, prod: Products) -> torch.Tensor:
    return prod.mm(x, w) + b.float()


def attention(x: torch.Tensor, p: dict, heads: int, causal: bool, prod: Products) -> torch.Tensor:
    """Multi-head self-attention over (B, L, D) from the packed (D, 3D) projection."""
    b, l, d = x.shape
    qkv = linear(x, p["qkv_w"], p["qkv_b"], prod)
    q, k, v = (t.reshape(b, l, heads, d // heads).transpose(1, 2) for t in qkv.split(d, dim=-1))
    scores = prod.mm(q, k.transpose(-1, -2)) / (d // heads) ** 0.5
    if causal:
        future = torch.ones(l, l, dtype=torch.bool, device=x.device).triu(1)
        scores = scores.masked_fill(future, float("-inf"))
    out = prod.mm(torch.softmax(scores, dim=-1), v)
    return linear(out.transpose(1, 2).reshape(b, l, d), p["out_w"], p["out_b"], prod)


def block(x: torch.Tensor, p: dict, heads: int, causal: bool, prod: Products) -> torch.Tensor:
    x = x + attention(layer_norm(x, p["ln_1"]), p["attn"], heads, causal, prod)
    h = linear(layer_norm(x, p["ln_2"]), p["mlp"]["fc_w"], p["mlp"]["fc_b"], prod)
    h = h * torch.sigmoid(1.702 * h)
    return x + linear(h, p["mlp"]["proj_w"], p["mlp"]["proj_b"], prod)


def encode_frames(visual: dict, clip: dict, frames: torch.Tensor, prod: Products) -> torch.Tensor:
    """(N, S, S, 3) uint8 RGB -> (N, embed_dim) image features."""
    patch, width = clip["vision_patch_size"], clip["vision_width"]
    mean = torch.tensor(CLIP_MEAN, device=frames.device)
    std = torch.tensor(CLIP_STD, device=frames.device)
    x = (frames.float() / 255.0 - mean) / std
    n, s = x.shape[0], x.shape[1]
    g = s // patch
    # each patch flattened channel-major, as a Conv2d kernel's (c, kh, kw)
    x = x.reshape(n, g, patch, g, patch, 3).permute(0, 1, 3, 5, 2, 4).reshape(n, g * g, 3 * patch * patch)
    x = prod.mm(x, visual["patch_embed"])
    cls = visual["class_embedding"].float().expand(n, 1, width)
    x = torch.cat([cls, x], dim=1) + visual["positional_embedding"].float()
    x = layer_norm(x, visual["ln_pre"])
    for p in visual["blocks"]:
        x = block(x, p, width // 64, False, prod)
    return prod.mm(layer_norm(x[:, 0], visual["ln_post"]), visual["proj"])


def text_features(text: dict, clip: dict, token_ids: torch.Tensor, ctx: torch.Tensor,
                  projection: torch.Tensor, prod: Products) -> torch.Tensor:
    """CoOp prompts [SOS, ctx x n_ctx, class name, '.', EOT, pad] through the
    causal text tower -> (n_cls, embed_dim), read at each prompt's EOT (its
    largest id) and projected by the trainable ``projection``. ``ctx`` is
    (n_cls, n_ctx, width), or (n_ctx, width) when shared."""
    n_cls = token_ids.shape[0]
    n_ctx = ctx.shape[-2]
    if ctx.dim() == 2:
        ctx = ctx.expand(n_cls, *ctx.shape)
    emb = text["token_embedding"].float()[token_ids]
    x = torch.cat([emb[:, :1], ctx.float(), emb[:, 1 + n_ctx:]], dim=1)
    x = x + text["positional_embedding"].float()
    for p in text["blocks"]:
        x = block(x, p, clip["transformer_heads"], True, prod)
    x = layer_norm(x, text["ln_final"])
    eot = token_ids.argmax(dim=-1)
    return prod.mm(x[torch.arange(n_cls, device=x.device), eot], projection)
