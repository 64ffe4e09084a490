"""AnomalyCLIP's head in plain PyTorch (Zanella et al., arXiv 2310.02835):
the ncentroid re-centring, the selector's projections onto the abnormal
classes' text directions with the non-affine BatchNorm, the axial temporal
transformer over (num_segments x seg_length) grids and the scoring head, and
the test-time cover of a video by whole grids.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.clip import layer_norm
from benchmark.reference.precision import Products


def direction_logits(image: torch.Tensor, text: torch.Tensor, ncentroid: torch.Tensor,
                     normal_id: int, prod: Products) -> torch.Tensor:
    """Re-centred image features (T, D) projected onto the re-centred, unit
    abnormal-class text directions -> (T, C-1)."""
    abnormal = torch.cat([text[:normal_id], text[normal_id + 1:]]).float() - ncentroid
    abnormal = abnormal / abnormal.norm(dim=-1, keepdim=True)
    return prod.mm(image.float() - ncentroid, abnormal.T)


def batch_norm_eval(logits: torch.Tensor, mean: torch.Tensor, var: torch.Tensor, eps: float = 1e-5):
    return (logits - mean) / torch.sqrt(var + eps)


def _self_attention(x: torch.Tensor, p: dict, heads: int, prod: Products) -> torch.Tensor:
    """Pre-LN attention over (B, L, d) with q and the packed k|v projections, no bias on them."""
    b, l, _ = x.shape
    x = layer_norm(x, p["ln"])
    q = prod.mm(x, p["to_q"])
    kv = prod.mm(x, p["to_kv"])
    hidden = q.shape[-1]
    split = lambda t: t.reshape(b, l, heads, hidden // heads).transpose(1, 2)  # noqa: E731
    q, k, v = split(q), split(kv[..., :hidden]), split(kv[..., hidden:])
    attn = torch.softmax(prod.mm(q, k.transpose(-1, -2)) / math.sqrt(hidden // heads), dim=-1)
    out = prod.mm(attn, v).transpose(1, 2).reshape(b, l, hidden)
    return prod.mm(out, p["to_out_w"]) + p["to_out_b"]


def _conv_ff(x: torch.Tensor, p: dict, prod: Products) -> torch.Tensor:
    """Channel LayerNorm ((x - mean) / (std + eps)), 3x3 conv d -> 4d,
    LeakyReLU(0.01), 3x3 conv 4d -> d over the (n, l) grid."""
    mean = x.mean(dim=-1, keepdim=True)
    std = (x - mean).square().mean(dim=-1, keepdim=True).sqrt()
    y = ((x - mean) / (std + 1e-5) * p["ln_g"] + p["ln_b"]).permute(0, 3, 1, 2)
    y = torch.nn.functional.leaky_relu(prod.conv3x3(y, p["conv1_w"], p["conv1_b"]), 0.01)
    return prod.conv3x3(y, p["conv2_w"], p["conv2_b"]).permute(0, 2, 3, 1)


def temporal_scores(x: torch.Tensor, tp: dict, heads: int, prod: Products) -> torch.Tensor:
    """(G, n, l, input) re-centred features -> (G, n, l) sigmoid scores."""
    x = prod.mm(x, tp["projection"]["w"]) + tp["projection"]["b"]
    x = x + tp["pos_n"][None, :, None, :] + tp["pos_l"][None, None, :, :]
    g, n, l, d = x.shape
    x1 = x2 = x
    for layer in tp["layers"]:
        along_n = _self_attention(x2.transpose(1, 2).reshape(g * l, n, d), layer["attn_n"], heads, prod)
        x1 = x1 + along_n.reshape(g, l, n, d).transpose(1, 2)
        x2 = x2 + _self_attention(x1.reshape(g * n, l, d), layer["attn_l"], heads, prod).reshape(g, n, l, d)
        x1 = x1 + _conv_ff(x2, layer["ff1"], prod)
        x2 = x2 + _conv_ff(x1, layer["ff2"], prod)
    x = layer_norm((x1 + x2) * 0.5, tp["head"]["ln"])
    return torch.sigmoid(prod.mm(x, tp["head"]["w"]) + tp["head"]["b"])[..., 0]


def grid_positions(frames: int, grid: int, model: dict) -> torch.Tensor:
    """The positions in a video's grid-padded frame stream that grid ``grid``
    holds, (n * l,) in its (segment, frame) order. A video of ``frames`` frames
    is covered by s = ceil(frames / (n * l)) whole grids: its stream is padded
    to s * n * l frames by wrapping around to its first frames, and chunk c of
    l frames goes to segment c // s of grid c % s. Position p shows frame
    p % frames; the positions past the last frame are the wrapped ones."""
    n, l = model["num_segments"], model["seg_length"]
    s = -(-frames // (n * l))
    chunks = grid + s * torch.arange(n)
    return (chunks[:, None] * l + torch.arange(l)).reshape(-1)


def score_grids(grids: torch.Tensor, text: torch.Tensor, trainable: dict, bn: tuple, ncentroid: torch.Tensor,
                model: dict, prod: Products) -> tuple:
    """(G, n, l, D) image features of whole grids -> (scores (G, n, l),
    class probabilities (G, n, l, C-1)). Stride 1, one crop."""
    sim = batch_norm_eval(direction_logits(grids, text, ncentroid, model["normal_id"], prod), *bn)
    scores = temporal_scores(grids.float() - ncentroid, trainable["temporal"], model["heads"], prod)
    return scores, torch.softmax(sim, dim=-1) * scores[..., None]


def score_clip(features: torch.Tensor, text: torch.Tensor, trainable: dict, bn: tuple,
               ncentroid: torch.Tensor, model: dict, prod: Products) -> tuple:
    """One video's image features (T, D) -> (scores (T,), class_probs (T, C-1)),
    over every grid that covers it (``grid_positions``), read back at its real frames."""
    n, l = model["num_segments"], model["seg_length"]
    t = features.shape[0]
    s = -(-t // (n * l))
    positions = torch.stack([grid_positions(t, g, model) for g in range(s)]).to(features.device)
    grids = features[positions % t].reshape(s, n, l, -1)
    scores, probs = score_grids(grids, text, trainable, bn, ncentroid, model, prod)
    order = positions.reshape(-1).argsort()[:t]
    return scores.reshape(-1)[order], probs.reshape(s * n * l, -1)[order]
