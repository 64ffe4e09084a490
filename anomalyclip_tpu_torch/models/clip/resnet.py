"""CLIP's ModifiedResNet visual tower as plain functions over dictionaries of
tensors: the counterpart of anomalyclip_tpu/models/clip/resnet.py.

The reference's tower (src/models/components/clip/model.py:10-171): a 3-conv
stem with an avgpool, four stages of anti-aliased bottlenecks (every conv at
stride 1; a downsampling block pools after conv2 and before its shortcut
conv), and an attention pool whose one query is the mean token. Inference
only, as the image encoder is frozen: BatchNorm applies the checkpoint's
running statistics.

Layout: the conv kernels are OIHW, what ``F.conv2d`` takes (convert.py moves
the JAX package's HWIO kernels there). The activations are NCHW tensors in
``torch.channels_last`` memory, so that they lie in memory as the JAX
package's NHWC arrays do: the (B, H, W, 3) frames become the first
activation by a permuted view, without a copy, and cuDNN runs the convs in
its NHWC kernels. Products and convs run in ``compute_dtype`` inside
``matmul_precision_for`` (encode_image opens it), so an fp32 tower runs its
convs in fp32, not TF32. The attention pool is the JAX package's XLA einsum
with an fp32 softmax (resnet.py:75-96): its query has length 1, and it has no
kernel there or here.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List

import torch
import torch.nn.functional as F

Params = Dict[str, Any]


def _channel(t: torch.Tensor) -> torch.Tensor:
    """A per-channel (C,) tensor broadcast over NCHW."""
    return t.view(1, -1, 1, 1)


def _bn_eval(x: torch.Tensor, bn: Params, eps: float = 1e-5) -> torch.Tensor:
    """BatchNorm2d in eval mode over the channel axis: scale and bias formed in
    fp32, then cast to x's dtype, in the JAX package's order (:30-37)."""
    inv = torch.rsqrt(bn["var"].float() + eps)
    scale_f = bn["scale"].float()
    scale = (scale_f * inv).to(x.dtype)
    bias = (bn["bias"].float() - bn["mean"].float() * scale_f * inv).to(x.dtype)
    return x * _channel(scale) + _channel(bias)


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1, padding: int = 0) -> torch.Tensor:
    return F.conv2d(x, w.to(x.dtype), stride=stride, padding=padding)


def _avgpool(x: torch.Tensor, k: int) -> torch.Tensor:
    """Non-overlapping k x k windows: the sum over each over k^2."""
    if k <= 1:
        return x
    return F.avg_pool2d(x, k)


def _bottleneck(x: torch.Tensor, p: Params, stride: int) -> torch.Tensor:
    """Anti-aliased bottleneck (model.py:10-68): every conv at stride 1; a
    downsampling block pools after conv2 and before the shortcut conv."""
    out = F.relu(_bn_eval(_conv(x, p["conv1_w"]), p["bn1"]))
    out = F.relu(_bn_eval(_conv(out, p["conv2_w"], padding=1), p["bn2"]))
    out = _avgpool(out, stride)
    out = _bn_eval(_conv(out, p["conv3_w"]), p["bn3"])
    if "down_conv_w" in p:
        identity = _bn_eval(_conv(_avgpool(x, stride), p["down_conv_w"]), p["down_bn"])
    else:
        identity = x
    return F.relu(out + identity)


def _attention_pool(x: torch.Tensor, p: Params, num_heads: int) -> torch.Tensor:
    """QKV attention pooling (model.py:71-110): the mean token queries itself
    and every spatial token; separate q, k, v projections; scores and softmax
    in fp32 -> (B, output_dim)."""
    b, c = x.shape[:2]
    tokens = x.flatten(2).transpose(1, 2)  # (B, H*W, C), row-major over (H, W)
    tokens = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1)
    dtype = tokens.dtype
    tokens = tokens + p["positional_embedding"].to(dtype)[None]

    dh = c // num_heads
    q = tokens[:, :1] @ p["q_w"].to(dtype) + p["q_b"].to(dtype)
    k = tokens @ p["k_w"].to(dtype) + p["k_b"].to(dtype)
    v = tokens @ p["v_w"].to(dtype) + p["v_b"].to(dtype)

    def heads(t):
        return t.reshape(b, -1, num_heads, dh).transpose(1, 2)

    q, k, v = heads(q), heads(k), heads(v)
    # products of two operands of ``dtype`` are exact in fp32: this is the
    # JAX package's preferred_element_type=float32
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    weights = torch.softmax(scores * (1.0 / math.sqrt(dh)), dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bhkd->bhqd", weights, v)
    out = out.transpose(1, 2).reshape(b, 1, c)[:, 0]
    return out @ p["c_w"].to(dtype) + p["c_b"].to(dtype)


def resnet_encode_image(
    visual: Params,
    images: torch.Tensor,
    num_heads: int,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """(B, H, W, 3) NHWC -> (B, output_dim) through the ModifiedResNet
    (model.py:159-171: stem, layer1-4, attention pool)."""
    x = images.to(compute_dtype).permute(0, 3, 1, 2)  # NCHW view, channels_last memory
    stem = visual["stem"]
    x = F.relu(_bn_eval(_conv(x, stem["conv1_w"], stride=2, padding=1), stem["bn1"]))
    x = F.relu(_bn_eval(_conv(x, stem["conv2_w"], padding=1), stem["bn2"]))
    x = F.relu(_bn_eval(_conv(x, stem["conv3_w"], padding=1), stem["bn3"]))
    x = _avgpool(x, 2)
    for li, layer_name in enumerate(("layer1", "layer2", "layer3", "layer4")):
        for bi, block in enumerate(visual[layer_name]):
            # layers 2-4 downsample in their first block (model.py:140-147)
            x = _bottleneck(x, block, 2 if (li > 0 and bi == 0) else 1)
    return _attention_pool(x, visual["attnpool"], num_heads)


def init_resnet_params(gen: torch.Generator, cfg) -> Params:
    """Random ModifiedResNet visual parameters (on the CPU), with the JAX
    package's shapes and distributions (:121-196): BN statistics at the
    eval-mode identity (mean 0, var 1), fan-in scaled convs, the attention
    pool at std embed_dim**-0.5. The numbers differ from the JAX init's."""
    width = cfg.vision_width
    embed_dim = width * 32

    def normal(std, shape):
        return torch.randn(shape, generator=gen, dtype=torch.float32) * std

    def conv(cin, cout, k):
        return normal((cin * k * k) ** -0.5, (cout, cin, k, k))

    def bn(c):
        return {"scale": torch.ones(c), "bias": torch.zeros(c), "mean": torch.zeros(c), "var": torch.ones(c)}

    def bottleneck(cin, planes, downsample):
        p = {
            "conv1_w": conv(cin, planes, 1),
            "bn1": bn(planes),
            "conv2_w": conv(planes, planes, 3),
            "bn2": bn(planes),
            "conv3_w": conv(planes, planes * 4, 1),
            "bn3": bn(planes * 4),
        }
        if downsample:
            p["down_conv_w"] = conv(cin, planes * 4, 1)
            p["down_bn"] = bn(planes * 4)
        return p

    visual: Params = {
        "stem": {
            "conv1_w": conv(3, width // 2, 3),
            "bn1": bn(width // 2),
            "conv2_w": conv(width // 2, width // 2, 3),
            "bn2": bn(width // 2),
            "conv3_w": conv(width // 2, width, 3),
            "bn3": bn(width),
        },
    }
    inplanes = width
    for li, blocks in enumerate(cfg.vision_layers, start=1):
        planes = width * (2 ** (li - 1))
        layer: List[Params] = []
        for bi in range(blocks):
            layer.append(bottleneck(inplanes, planes, downsample=(bi == 0)))
            inplanes = planes * 4
        visual[f"layer{li}"] = layer
    spacial = cfg.image_resolution // 32
    pstd = embed_dim**-0.5
    visual["attnpool"] = {
        "positional_embedding": normal(pstd, (spacial**2 + 1, embed_dim)),
        "q_w": normal(pstd, (embed_dim, embed_dim)),
        "q_b": torch.zeros(embed_dim),
        "k_w": normal(pstd, (embed_dim, embed_dim)),
        "k_b": torch.zeros(embed_dim),
        "v_w": normal(pstd, (embed_dim, embed_dim)),
        "v_b": torch.zeros(embed_dim),
        "c_w": normal(pstd, (embed_dim, cfg.embed_dim)),
        "c_b": torch.zeros(cfg.embed_dim),
    }
    return visual
