"""Int8 (W8A8) serving path for the frozen CLIP ViT tower: the counterpart of
anomalyclip_tpu/models/clip/quant.py.

The tower's six GEMM weight families (patch embed, each block's qkv, out, fc
and proj, the final projection) are quantized to int8 with symmetric
per-output-channel scales, once; each GEMM quantizes its activations per token
(the abs-max of each row) and multiplies int8 by int8 into int32, then applies
both scales in fp32. Everything else (LayerNorms, biases, the residual
stream, the attention core through ``attention_from_qkv``'s ladder, and so
the CUDA kernels) runs in ``compute_dtype`` as on the fp tower. Serving only:
training and the parity paths never come here (train/module.py routes).

The int8 product is ``torch._int_mm``: on the card cuBLASLt's int8 tensor-core
GEMM, a library call where the JAX package has ``lax.dot_general`` (its fused
Pallas W8A8 kernel was deleted; no Pallas kernel computes this product). On
the card it takes only M > 16 rows and K and N that are multiples of 8
(ViT-L/14's patch embed has K = 3 * 14 * 14 = 588; a batch of at most 16
frames gives the final projection M <= 16): ``int8_matmul`` pads K and M with
zeros, which add nothing to an integer product. Quantized weights
are stored (..., out, in), the transpose of the JAX package's (..., in, out):
the product reads ``w_q.t()``, the column-major (in, out) operand the GEMM
takes, so no call copies or transposes a weight. Feature fidelity on released
checkpoints is not measured (none is in the repository); the tests pin the
mechanism against the JAX package.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from anomalyclip_tpu_torch.models.clip.model import (
    CLIPConfig,
    attention_from_qkv,
    layer_norm,
    normalize_frames_on_device,
    patchify,
    quick_gelu,
)
from anomalyclip_tpu_torch.numerics import matmul_precision_for

Params = Dict[str, Any]

INT8_MAX = 127.0
# what torch._int_mm takes on the card: M > 16, K and N multiples of 8
_MIN_ROWS = 17
_K_MULTIPLE = 8


def quantize_weight(w: torch.Tensor) -> Params:
    """Per-output-channel symmetric int8 quantization of an (..., in, out)
    weight -> {"w_q": (..., out, in) int8, "scale": (..., out) fp32}, on w's
    device. Rounds half to even, as ``jnp.rint`` does."""
    w = w.float()
    scale = (w.abs().amax(dim=-2, keepdim=True) / INT8_MAX).clamp_min(1e-12)  # (..., 1, out)
    w_q = torch.clamp(torch.round(w / scale), -INT8_MAX, INT8_MAX).to(torch.int8)
    return {"w_q": w_q.transpose(-1, -2).contiguous(), "scale": scale[..., 0, :]}


def int8_matmul(a: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (N, K) int8 transposed -> (M, N) int32, exact, through
    ``torch._int_mm``; K and M padded with zeros to what the card's GEMM takes
    (every tower's N is a multiple of 8), the padded rows cut off."""
    m, k = a.shape
    pad_k = -k % _K_MULTIPLE
    if pad_k:
        w_q = F.pad(w_q, (0, pad_k))
    if pad_k or m < _MIN_ROWS:
        a = F.pad(a, (0, pad_k, 0, max(_MIN_ROWS - m, 0)))
    return torch._int_mm(a, w_q.t())[:m]


def quantize_rows(x: torch.Tensor) -> tuple:
    """Per-token symmetric int8 quantization of (..., in) activations ->
    (codes (..., in) int8, scales (..., 1) fp32), computed in fp32."""
    xf = x.float()
    x_scale = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12) / INT8_MAX
    return torch.clamp(torch.round(xf / x_scale), -INT8_MAX, INT8_MAX).to(torch.int8), x_scale


def int8_linear(x: torch.Tensor, qlin: Params, bias=None, gelu: bool = False) -> torch.Tensor:
    """y = dequant(quant(x) @ w_q) [+ bias] [-> QuickGELU], activations
    quantized per token: (..., in) in bf16 or fp32 -> (..., out) in x's dtype.
    The scales, the bias and ``gelu`` (the fc GEMM's QuickGELU) apply in fp32
    before the one cast, in the JAX package's order (:66-92)."""
    x_q, x_scale = quantize_rows(x)
    y = int8_matmul(x_q.reshape(-1, x_q.shape[-1]), qlin["w_q"]).reshape(*x_q.shape[:-1], -1)
    y = y.float() * x_scale * qlin["scale"].float()
    if bias is not None:
        y = y + bias.float()
    if gelu:
        y = quick_gelu(y)
    return y.to(x.dtype)


def _f32(tree: Params) -> Params:
    return {k: v.float() for k, v in tree.items()}


def quantize_clip_visual(params: Params) -> Params:
    """The fp ViT tower -> the int8 tower: the same tree with the GEMM weights
    replaced by ``quantize_weight``'s {w_q, scale} nodes and everything else
    fp32, computed once, on the device where the tower lies. The
    ModifiedResNet tower has no int8 path (the module serves it on the fp
    tower)."""
    visual = params["visual"]
    if "patch_embed" not in visual:
        raise ValueError("quantize_clip_visual: the int8 tower is a ViT tower; a ModifiedResNet stays on fp")
    with torch.no_grad():
        return {
            "patch_embed": quantize_weight(visual["patch_embed"]),
            "class_embedding": visual["class_embedding"].float(),
            "positional_embedding": visual["positional_embedding"].float(),
            "ln_pre": _f32(visual["ln_pre"]),
            "blocks": [
                {
                    "ln_1": _f32(blk["ln_1"]),
                    "ln_2": _f32(blk["ln_2"]),
                    "attn": {
                        "qkv": quantize_weight(blk["attn"]["qkv_w"]),
                        "qkv_b": blk["attn"]["qkv_b"].float(),
                        "out": quantize_weight(blk["attn"]["out_w"]),
                        "out_b": blk["attn"]["out_b"].float(),
                    },
                    "mlp": {
                        "fc": quantize_weight(blk["mlp"]["fc_w"]),
                        "fc_b": blk["mlp"]["fc_b"].float(),
                        "proj": quantize_weight(blk["mlp"]["proj_w"]),
                        "proj_b": blk["mlp"]["proj_b"].float(),
                    },
                }
                for blk in visual["blocks"]
            ],
            "ln_post": _f32(visual["ln_post"]),
            "proj": quantize_weight(visual["proj"]),
        }


def _block_apply_q(x: torch.Tensor, blk: Params, num_heads: int) -> torch.Tensor:
    """One pre-LN residual block with int8 projections around the fp
    attention core (every rung of the ladder: attention_from_qkv)."""
    h = layer_norm(x, blk["ln_1"]["scale"], blk["ln_1"]["bias"])
    qkv = int8_linear(h, blk["attn"]["qkv"], blk["attn"]["qkv_b"])
    attn = attention_from_qkv(qkv, num_heads)
    x = x + int8_linear(attn, blk["attn"]["out"], blk["attn"]["out_b"])
    h = layer_norm(x, blk["ln_2"]["scale"], blk["ln_2"]["bias"])
    h = int8_linear(h, blk["mlp"]["fc"], blk["mlp"]["fc_b"], gelu=True)
    return x + int8_linear(h, blk["mlp"]["proj"], blk["mlp"]["proj_b"])


def encode_image_int8(
    qvisual: Params,
    cfg: CLIPConfig,
    images: torch.Tensor,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Visual forward with int8 GEMMs: (B, H, W, 3) NHWC -> (B, embed_dim), layer
    for layer the fp tower's (model.py ``encode_image``); ``compute_dtype``
    governs the non-GEMM compute as there, and uint8 input is CLIP-normalized on
    the device. The int8 weights are never cast to the activation dtype."""
    if images.dtype == torch.uint8:
        images = normalize_frames_on_device(images)
    with torch.no_grad(), matmul_precision_for(compute_dtype):
        x = patchify(images.to(compute_dtype), cfg.vision_patch_size)
        x = int8_linear(x, qvisual["patch_embed"])
        b = x.shape[0]
        cls = qvisual["class_embedding"].to(compute_dtype).expand(b, 1, cfg.vision_width)
        x = torch.cat([cls, x], dim=1)
        x = x + qvisual["positional_embedding"].to(compute_dtype)
        x = layer_norm(x, qvisual["ln_pre"]["scale"], qvisual["ln_pre"]["bias"])
        for blk in qvisual["blocks"]:
            x = _block_apply_q(x, blk, cfg.vision_heads)
        x = layer_norm(x[:, 0, :], qvisual["ln_post"]["scale"], qvisual["ln_post"]["bias"])
        return int8_linear(x, qvisual["proj"])
