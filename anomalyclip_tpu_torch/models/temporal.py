"""Axial transformer over the (num_segments x seg_length) temporal grid: the
forward of anomalyclip_tpu/models/temporal.py.

The grid stays channels-last, (B, n, l, d), as in the JAX package. Per depth
level a reversible pair of blocks couples two streams, y1 = x1 + f(x2),
y2 = x2 + g(y1): first f = attention along the segments (L = n) and
g = attention along the frames (L = l), then two channel-LN 3x3 conv
feed-forwards; the streams are averaged at exit, and a LayerNorm + Linear +
sigmoid head gives one score per frame. Attention runs through the fused CUDA
kernel (ops/attention.py: fused_mha_bld), with k and v read in place as the two
halves of one ``to_kv`` projection.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List

import torch
import torch.nn.functional as F

from anomalyclip_tpu_torch.ops.attention import fused_mha_bld

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class TemporalConfig:
    input_size: int
    emb_size: int
    depth: int
    heads: int
    dim_heads: int | None  # None -> emb_size // heads
    num_segments: int = 32
    seg_length: int = 16

    @property
    def head_dim(self) -> int:
        return self.dim_heads if self.dim_heads else self.emb_size // self.heads

    @property
    def hidden(self) -> int:
        return self.head_dim * self.heads


# ---------------------------------------------------------------------------
# Seeded initialization: the distributions of init_temporal_params
# (temporal.py:68-132), torch's nn.Linear / nn.Conv2d bounds. Conv kernels are
# OIHW, the layout F.conv2d takes.
# ---------------------------------------------------------------------------


def _uniform(gen: torch.Generator, shape, bound: float) -> torch.Tensor:
    return (torch.rand(shape, generator=gen, dtype=torch.float32) * 2 - 1) * bound


def _init_axial_attn(gen: torch.Generator, cfg: TemporalConfig) -> Params:
    d, h = cfg.emb_size, cfg.hidden
    return {
        "ln": {"scale": torch.ones(d), "bias": torch.zeros(d)},
        "to_q": _uniform(gen, (d, h), 1 / math.sqrt(d)),
        "to_kv": _uniform(gen, (d, 2 * h), 1 / math.sqrt(d)),
        "to_out_w": _uniform(gen, (h, d), 1 / math.sqrt(h)),
        "to_out_b": _uniform(gen, (d,), 1 / math.sqrt(h)),
    }


def _init_conv_ff(gen: torch.Generator, cfg: TemporalConfig) -> Params:
    d = cfg.emb_size
    b1, b2 = 1 / math.sqrt(d * 9), 1 / math.sqrt(4 * d * 9)
    return {
        "ln_g": torch.ones(d),
        "ln_b": torch.zeros(d),
        "conv1_w": _uniform(gen, (4 * d, d, 3, 3), b1),
        "conv1_b": _uniform(gen, (4 * d,), b1),
        "conv2_w": _uniform(gen, (d, 4 * d, 3, 3), b2),
        "conv2_b": _uniform(gen, (d,), b2),
    }


def init_temporal_params(gen: torch.Generator, cfg: TemporalConfig) -> Params:
    bound_in, bound_emb = 1 / math.sqrt(cfg.input_size), 1 / math.sqrt(cfg.emb_size)
    layers: List[Params] = [
        {
            "attn_n": _init_axial_attn(gen, cfg),
            "attn_l": _init_axial_attn(gen, cfg),
            "ff1": _init_conv_ff(gen, cfg),
            "ff2": _init_conv_ff(gen, cfg),
        }
        for _ in range(cfg.depth)
    ]
    return {
        "projection": {
            "w": _uniform(gen, (cfg.input_size, cfg.emb_size), bound_in),
            "b": _uniform(gen, (cfg.emb_size,), bound_in),
        },
        "pos_n": torch.randn((cfg.num_segments, cfg.emb_size), generator=gen),
        "pos_l": torch.randn((cfg.seg_length, cfg.emb_size), generator=gen),
        "layers": layers,
        "head": {
            "ln": {"scale": torch.ones(cfg.emb_size), "bias": torch.zeros(cfg.emb_size)},
            "w": _uniform(gen, (cfg.emb_size, 1), bound_emb),
            "b": _uniform(gen, (1,), bound_emb),
        },
    }


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _layer_norm(x, scale, bias, eps=1e-5):
    """(x - mean) * rsqrt(var + eps): the eps inside the root."""
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


def _chan_layer_norm(x, g, b, eps=1e-5):
    """The axial package's channel LayerNorm: (x - mean) / (std + eps), with
    std = sqrt(biased var): the eps outside the root."""
    mean = x.mean(dim=-1, keepdim=True)
    std = (x - mean).square().mean(dim=-1, keepdim=True).sqrt()
    return (x - mean) / (std + eps) * g + b


def _self_attention(x: torch.Tensor, p: Params, cfg: TemporalConfig) -> torch.Tensor:
    """Pre-LN multi-head self-attention over (B, T, D), no q/kv bias."""
    hidden = cfg.hidden
    x = _layer_norm(x, p["ln"]["scale"], p["ln"]["bias"])
    q = x @ p["to_q"]
    kv = x @ p["to_kv"]
    out = fused_mha_bld(q, kv[..., :hidden], kv[..., hidden:], cfg.heads)
    return out @ p["to_out_w"] + p["to_out_b"]


def _attn_along_segments(x: torch.Tensor, p: Params, cfg: TemporalConfig) -> torch.Tensor:
    """Attend along the segment axis n, l folded into the batch. x: (B, n, l, d)."""
    b, n, l, d = x.shape
    y = x.transpose(1, 2).reshape(b * l, n, d)
    y = _self_attention(y, p, cfg)
    return y.reshape(b, l, n, d).transpose(1, 2)


def _attn_along_frames(x: torch.Tensor, p: Params, cfg: TemporalConfig) -> torch.Tensor:
    """Attend along the frame axis l, n folded into the batch. x: (B, n, l, d)."""
    b, n, l, d = x.shape
    y = _self_attention(x.reshape(b * n, l, d), p, cfg)
    return y.reshape(b, n, l, d)


def leaky_relu(y: torch.Tensor, positive=None) -> torch.Tensor:
    """LeakyReLU(0.01): y where ``positive`` (by default y >= 0), else 0.01 y.
    ``positive`` lets a comparison of two runs take one run's branches in the
    other (chip_smoke.py phase 4b): the derivative jumps from 1 to 0.01 at 0, so
    two runs that differ by one rounding take different branches wherever y
    lies within that rounding of 0."""
    return torch.where(y >= 0 if positive is None else positive, y, 0.01 * y)


def _conv_ff(x: torch.Tensor, p: Params) -> torch.Tensor:
    """Channel-LN -> 3x3 conv (d -> 4d) -> LeakyReLU(0.01) -> 3x3 conv (4d -> d)
    over the (n, l) grid; "SAME" padding."""
    y = _chan_layer_norm(x, p["ln_g"], p["ln_b"]).permute(0, 3, 1, 2)
    y = F.conv2d(y, p["conv1_w"], p["conv1_b"], padding=1)
    y = leaky_relu(y)
    y = F.conv2d(y, p["conv2_w"], p["conv2_b"], padding=1)
    return y.permute(0, 2, 3, 1)


def _reversible_pair(x1, x2, f, g):
    """RevNet coupling: y1 = x1 + f(x2); y2 = x2 + g(y1)."""
    y1 = x1 + f(x2)
    y2 = x2 + g(y1)
    return y1, y2


def axial_transformer(x: torch.Tensor, params: Params, cfg: TemporalConfig) -> torch.Tensor:
    """(B, n, l, d) -> (B, n, l, d)."""
    x = x + params["pos_n"][None, :, None, :] + params["pos_l"][None, None, :, :]
    x1 = x2 = x
    for layer in params["layers"]:
        x1, x2 = _reversible_pair(
            x1,
            x2,
            lambda t: _attn_along_segments(t, layer["attn_n"], cfg),
            lambda t: _attn_along_frames(t, layer["attn_l"], cfg),
        )
        x1, x2 = _reversible_pair(
            x1, x2, lambda t: _conv_ff(t, layer["ff1"]), lambda t: _conv_ff(t, layer["ff2"])
        )
    return (x1 + x2) * 0.5


def temporal_scores(
    features: torch.Tensor,
    params: Params,
    cfg: TemporalConfig,
    segment_size: int = 1,
    test_mode: bool = False,
) -> torch.Tensor:
    """Project -> axial transformer -> sigmoid head.

    features: (B*n*l, input_size), or in test mode (B*n*s*l, input_size) in
    video-major (n, s, l) order with s = ``segment_size`` independent grids.
    Returns (total_frames, 1) scores in (0, 1)."""
    x = features @ params["projection"]["w"] + params["projection"]["b"]
    n, l, d = cfg.num_segments, cfg.seg_length, cfg.emb_size
    if test_mode:
        # (b n s l) d -> (b s) n l d
        x = x.reshape(-1, n, segment_size, l, d).transpose(1, 2).reshape(-1, n, l, d)
    else:
        x = x.reshape(-1, n, l, d)

    x = axial_transformer(x, params, cfg)

    if test_mode:
        # (b s) n l d -> (b n s l) d
        x = x.reshape(-1, segment_size, n, l, d).transpose(1, 2).reshape(-1, d)
    else:
        x = x.reshape(-1, d)

    x = _layer_norm(x, params["head"]["ln"]["scale"], params["head"]["ln"]["bias"])
    return torch.sigmoid(x @ params["head"]["w"] + params["head"]["b"])
