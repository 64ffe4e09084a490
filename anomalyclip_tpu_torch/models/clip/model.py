"""CLIP ViT, ModifiedResNet and text transformer as plain functions over
dictionaries of tensors.

The counterpart of anomalyclip_tpu/models/clip/model.py; the ModifiedResNet
tower lives in resnet.py and is reached through ``encode_image``, as in the
JAX package. The parameter layout is the JAX package's, with two differences:
each transformer's ``blocks`` is a list with one dictionary per layer instead
of arrays stacked on a leading layer axis, and conv kernels are OIHW instead
of HWIO (convert.py does both). ``qkv_w`` keeps the JAX orientation (D, 3D),
so the hot path is ``x @ w``.

Numerics follow the JAX package: LayerNorm in fp32 returning the input dtype,
QuickGELU, products in ``compute_dtype`` with the block weights cast to the
activation dtype, and attention through the CUDA kernel that
``attention_rung`` picks for the shape (ops/attention.py) on the card.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from anomalyclip_tpu_torch.data.transforms import CLIP_MEAN, CLIP_STD
from anomalyclip_tpu_torch.models.clip.resnet import init_resnet_params, resnet_encode_image
from anomalyclip_tpu_torch.numerics import matmul_precision_for
from anomalyclip_tpu_torch.ops.attention import (
    H100_SMEM_OPTIN,
    fused_attention,
    fused_mha_qkv,
    fused_mha_qtile,
    mha_kernel_eligible,
    smem_limit,
)

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    """Copy of the JAX package's CLIPConfig (model.py:49-123)."""

    embed_dim: int = 512
    image_resolution: int = 224
    # int -> ViT depth; tuple -> ModifiedResNet stage depths
    vision_layers: Any = 12
    vision_width: int = 768
    vision_patch_size: Optional[int] = 16  # None -> ModifiedResNet tower
    context_length: int = 77
    vocab_size: int = 49408
    transformer_width: int = 512
    transformer_heads: int = 8
    transformer_layers: int = 12

    @property
    def is_resnet(self) -> bool:
        return self.vision_patch_size is None

    @property
    def vision_heads(self) -> int:
        if self.is_resnet:
            return self.vision_width * 32 // 64
        return self.vision_width // 64

    @property
    def grid_size(self) -> int:
        return self.image_resolution // self.vision_patch_size

    @staticmethod
    def vit_b16() -> "CLIPConfig":
        return CLIPConfig()

    @staticmethod
    def vit_b32() -> "CLIPConfig":
        return CLIPConfig(vision_patch_size=32)

    @staticmethod
    def vit_l14() -> "CLIPConfig":
        return CLIPConfig(
            embed_dim=768,
            vision_layers=24,
            vision_width=1024,
            vision_patch_size=14,
            transformer_width=768,
            transformer_heads=12,
        )

    @staticmethod
    def vit_l14_336() -> "CLIPConfig":
        return dataclasses.replace(CLIPConfig.vit_l14(), image_resolution=336)

    @staticmethod
    def rn50() -> "CLIPConfig":
        return CLIPConfig(
            embed_dim=1024,
            vision_layers=(3, 4, 6, 3),
            vision_width=64,
            vision_patch_size=None,
        )

    @staticmethod
    def tiny(vocab_size: int = 49408) -> "CLIPConfig":
        """A small stand-in config for tests."""
        return CLIPConfig(
            embed_dim=64,
            image_resolution=32,
            vision_layers=2,
            vision_width=64,
            vision_patch_size=16,
            context_length=77,
            vocab_size=vocab_size,
            transformer_width=64,
            transformer_heads=4,
            transformer_layers=2,
        )


# ---------------------------------------------------------------------------
# Numeric primitives
# ---------------------------------------------------------------------------


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5):
    """LayerNorm over the last axis, computed in fp32, returned in x's dtype."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = y * scale.float() + bias.float()
    return y.to(x.dtype)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def attention_core(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False
) -> torch.Tensor:
    """softmax(q k^T / sqrt(dh)) v over (B, H, L, Dh); fp32 softmax either way."""
    return fused_attention(q, k, v, causal)


# the operand types the kernels take, by the itemsize the ladder is asked with
_ITEMSIZE_DTYPE = {4: torch.float32, 2: torch.bfloat16}


def attention_rung(
    b: int, l: int, d: int, num_heads: int, itemsize: int, causal: bool,
    smem: int = H100_SMEM_OPTIN,
) -> str:
    """The kernel dispatch ladder (the JAX package's ``attention_rung``,
    model.py:242-260), with the card's limits in place of the TPU's: "mha"
    (``fused_mha_qkv``) where its kernel's shared memory fits ``smem`` bytes,
    "qtile" (``fused_mha_qtile``) for non-causal shapes where that kernel's
    fits (the same kernel with K and V staged in the operand type, not fp32),
    "core" (``attention_core``, which routes on to the flash kernel) otherwise.
    Each fit is ``mha_kernel_eligible``: the operand type and the head dim must
    be ones the kernels are instantiated for, as well. A pure function of the
    shape, so the CPU runs the card's rungs."""
    dtype = _ITEMSIZE_DTYPE.get(itemsize)
    if mha_kernel_eligible(l, d, num_heads, dtype, smem):
        return "mha"
    if not causal and mha_kernel_eligible(l, d, num_heads, dtype, smem, itemsize):
        return "qtile"
    return "core"


def _attention_apply_rung(rung: str, qkv: torch.Tensor, num_heads: int, causal: bool):
    """Run the chosen rung over a packed (B, L, 3D) qkv projection. The qtile
    rung hands K6 q and the packed k|v as strided views of ``qkv``, which it
    reads in place (JAX model.py:275-278)."""
    b, l, d3 = qkv.shape
    d = d3 // 3
    if rung == "mha":
        return fused_mha_qkv(qkv, num_heads, causal)
    if rung == "qtile":
        return fused_mha_qtile(qkv[..., :d], qkv[..., d:], num_heads)

    def split_heads(t):
        return t.reshape(b, l, num_heads, d // num_heads).transpose(1, 2)

    q, k, v = (split_heads(t) for t in qkv.split(d, dim=-1))
    out = attention_core(q, k, v, causal)
    return out.transpose(1, 2).reshape(b, l, d)


def attention_from_qkv(qkv: torch.Tensor, num_heads: int, causal: bool = False) -> torch.Tensor:
    """The attention core over a packed (B, L, 3D) qkv projection -> (B, L, D),
    through the same ``attention_rung`` ladder as the fp path, all three rungs
    included (JAX model.py:289-299). For callers that own the projections: the
    int8 serving tower (quant.py)."""
    b, l, d3 = qkv.shape
    rung = attention_rung(b, l, d3 // 3, num_heads, qkv.element_size(), causal, smem_limit(qkv.device))
    return _attention_apply_rung(rung, qkv, num_heads, causal)


def multi_head_attention(
    x: torch.Tensor, attn: Params, num_heads: int, causal: bool = False
) -> torch.Tensor:
    """MHA over (B, L, D): the qkv projection, the rung ``attention_rung`` picks,
    the out projection. The qtile rung projects q and the packed k|v as two
    GEMMs straight from x, as the JAX package does (model.py:227-235)."""
    b, l, d = x.shape
    rung = attention_rung(b, l, d, num_heads, x.element_size(), causal, smem_limit(x.device))
    if rung == "qtile":
        q = x @ attn["qkv_w"][:, :d] + attn["qkv_b"][:d]
        kv = x @ attn["qkv_w"][:, d:] + attn["qkv_b"][d:]
        out = fused_mha_qtile(q, kv, num_heads)
    else:
        qkv = x @ attn["qkv_w"] + attn["qkv_b"]
        out = _attention_apply_rung(rung, qkv, num_heads, causal)
    return out @ attn["out_w"] + attn["out_b"]


def _block_apply(x: torch.Tensor, blk: Params, num_heads: int, causal: bool) -> torch.Tensor:
    """One pre-LN residual attention block."""
    h = layer_norm(x, blk["ln_1"]["scale"], blk["ln_1"]["bias"])
    x = x + multi_head_attention(h, blk["attn"], num_heads, causal)
    h = layer_norm(x, blk["ln_2"]["scale"], blk["ln_2"]["bias"])
    h = quick_gelu(h @ blk["mlp"]["fc_w"] + blk["mlp"]["fc_b"])
    return x + (h @ blk["mlp"]["proj_w"] + blk["mlp"]["proj_b"])


def cast_tree(tree: Any, dtype: torch.dtype) -> Any:
    if isinstance(tree, dict):
        return {k: cast_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [cast_tree(v, dtype) for v in tree]
    return tree.to(dtype)


def transformer_apply(x: torch.Tensor, blocks: list, num_heads: int, causal: bool = False):
    """The residual blocks in order, with their weights cast to the activation
    dtype, so a bf16 stream stays bf16 (LayerNorm still computes in fp32)."""
    for blk in blocks:
        x = _block_apply(x, cast_tree(blk, x.dtype), num_heads, causal)
    return x


# ---------------------------------------------------------------------------
# Encoders
# ---------------------------------------------------------------------------


def patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """(B, H, W, 3) NHWC -> (B, N_patches, 3*patch*patch), channel-major within
    each patch (the order of a flattened torch Conv2d kernel, weight[o, c, kh, kw])."""
    b, h, w, c = images.shape
    gh, gw = h // patch, w // patch
    x = images.reshape(b, gh, patch, gw, patch, c)
    x = x.permute(0, 1, 3, 5, 2, 4)
    return x.reshape(b, gh * gw, c * patch * patch)


def normalize_frames_on_device(images: torch.Tensor) -> torch.Tensor:
    """uint8 RGB (..., H, W, 3) -> CLIP-normalized fp32, with the JAX package's op
    order: (x / 255 - mean) / std."""
    mean = torch.as_tensor(CLIP_MEAN, device=images.device)
    std = torch.as_tensor(CLIP_STD, device=images.device)
    return (images.float() / 255.0 - mean) / std


def encode_image(
    params: Params,
    cfg: CLIPConfig,
    images: torch.Tensor,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Visual forward: (B, H, W, 3) NHWC -> (B, embed_dim), through the ViT or
    the ModifiedResNet (resnet.py) as the config says. uint8 input is
    CLIP-normalized on the device first."""
    if images.dtype == torch.uint8:
        images = normalize_frames_on_device(images)
    with matmul_precision_for(compute_dtype):
        if cfg.is_resnet:
            return resnet_encode_image(params["visual"], images, cfg.vision_heads, compute_dtype)
        visual = params["visual"]
        x = patchify(images.to(compute_dtype), cfg.vision_patch_size)
        x = x @ visual["patch_embed"].to(compute_dtype)
        b = x.shape[0]
        cls = visual["class_embedding"].to(compute_dtype).expand(b, 1, cfg.vision_width)
        x = torch.cat([cls, x], dim=1)
        x = x + visual["positional_embedding"].to(compute_dtype)
        x = layer_norm(x, visual["ln_pre"]["scale"], visual["ln_pre"]["bias"])
        x = transformer_apply(x, visual["blocks"], cfg.vision_heads)
        x = layer_norm(x[:, 0, :], visual["ln_post"]["scale"], visual["ln_post"]["bias"])
        return x @ visual["proj"].to(compute_dtype)


def text_transformer_on_embeddings(
    params: Params,
    cfg: CLIPConfig,
    embeddings: torch.Tensor,
    eot_indices: torch.Tensor,
    text_projection: Optional[torch.Tensor] = None,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Causal text transformer over prompt embeddings (N, context_length, width)
    -> (N, embed_dim), read at each prompt's EOT position. ``text_projection``
    overrides the frozen one (AnomalyCLIP trains its own copy)."""
    with matmul_precision_for(compute_dtype):
        text = params["text"]
        x = embeddings.to(compute_dtype) + text["positional_embedding"].to(compute_dtype)
        x = transformer_apply(x, text["blocks"], cfg.transformer_heads, causal=True)
        x = layer_norm(x, text["ln_final"]["scale"], text["ln_final"]["bias"])
        x = x[torch.arange(x.shape[0], device=x.device), eot_indices.to(x.device)]
        proj = text_projection if text_projection is not None else text["text_projection"]
        return x @ proj.to(compute_dtype)


def encode_text(
    params: Params,
    cfg: CLIPConfig,
    tokens: torch.Tensor,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Text forward from token ids: (N, 77) -> (N, embed_dim)."""
    tokens = tokens.long()
    embeddings = params["text"]["token_embedding"][tokens]
    return text_transformer_on_embeddings(
        params, cfg, embeddings, tokens.argmax(dim=-1), compute_dtype=compute_dtype
    )


def clip_similarity(
    params: Params,
    cfg: CLIPConfig,
    images: torch.Tensor,
    tokens: torch.Tensor,
    compute_dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Contrastive logits (reference model.py:416-430; JAX model.py:461-475)
    -> (logits_per_image (B, N), logits_per_text (N, B))."""
    image_features = encode_image(params, cfg, images, compute_dtype)
    text_features = encode_text(params, cfg, tokens, compute_dtype)
    image_features = image_features / torch.linalg.vector_norm(image_features, dim=1, keepdim=True)
    text_features = text_features / torch.linalg.vector_norm(text_features, dim=1, keepdim=True)
    scale = torch.exp(params["logit_scale"])
    logits_per_image = scale * image_features @ text_features.T
    return logits_per_image, logits_per_image.T


# ---------------------------------------------------------------------------
# Seeded initialization: the distributions of init_clip_params (model.py:483-566)
# ---------------------------------------------------------------------------


def _normal(gen: torch.Generator, shape, std: float) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=torch.float32) * std


def _init_blocks(gen: torch.Generator, layers: int, width: int) -> list:
    proj_std = (width**-0.5) * ((2 * layers) ** -0.5)
    attn_std = width**-0.5
    fc_std = (2 * width) ** -0.5
    blocks = []
    for _ in range(layers):
        blocks.append(
            {
                "ln_1": {"scale": torch.ones(width), "bias": torch.zeros(width)},
                "attn": {
                    "qkv_w": _normal(gen, (width, 3 * width), attn_std),
                    "qkv_b": torch.zeros(3 * width),
                    "out_w": _normal(gen, (width, width), proj_std),
                    "out_b": torch.zeros(width),
                },
                "ln_2": {"scale": torch.ones(width), "bias": torch.zeros(width)},
                "mlp": {
                    "fc_w": _normal(gen, (width, 4 * width), fc_std),
                    "fc_b": torch.zeros(4 * width),
                    "proj_w": _normal(gen, (4 * width, width), proj_std),
                    "proj_b": torch.zeros(width),
                },
            }
        )
    return blocks


def init_clip_params(gen: torch.Generator, cfg: CLIPConfig) -> Params:
    """Random CLIP parameters (on the CPU), ViT or ModifiedResNet as the config
    says, with the reference's init distributions. The numbers differ from the
    JAX init's: only the distributions are shared."""
    width = cfg.vision_width
    scale = width**-0.5
    tw = cfg.transformer_width
    if cfg.is_resnet:
        visual = init_resnet_params(gen, cfg)
    else:
        visual = {
            "patch_embed": _normal(gen, (3 * cfg.vision_patch_size**2, width), scale),
            "class_embedding": _normal(gen, (width,), scale),
            "positional_embedding": _normal(gen, (cfg.grid_size**2 + 1, width), scale),
            "ln_pre": {"scale": torch.ones(width), "bias": torch.zeros(width)},
            "blocks": _init_blocks(gen, cfg.vision_layers, width),
            "ln_post": {"scale": torch.ones(width), "bias": torch.zeros(width)},
            "proj": _normal(gen, (width, cfg.embed_dim), scale),
        }
    text = {
        "token_embedding": _normal(gen, (cfg.vocab_size, tw), 0.02),
        "positional_embedding": _normal(gen, (cfg.context_length, tw), 0.01),
        "blocks": _init_blocks(gen, cfg.transformer_layers, tw),
        "ln_final": {"scale": torch.ones(tw), "bias": torch.zeros(tw)},
        "text_projection": _normal(gen, (tw, cfg.embed_dim), tw**-0.5),
    }
    return {
        "visual": visual,
        "text": text,
        "logit_scale": torch.tensor(math.log(1 / 0.07), dtype=torch.float32),
    }
