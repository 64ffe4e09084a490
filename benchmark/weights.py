"""Seeded weights, made on the device from ``--seed`` in a few large draws.

``clip_tree`` lays the CLIP towers out as ``AnomalyCLIP.build`` takes them
(linear weights (in, out), ``blocks`` a list of one dict a layer): the text
tower here, the image tower from the configuration's ``towers/<tower>.py``;
``trainable_tree`` holds the prompt context, the trainable text projection and
the temporal model as the scorer and the optimizer take them. Every leaf is a
view of one buffer of standard-normal draws, scaled to the spread of CLIP's
and the temporal model's own initialisation; LayerNorm scales are drawn about
1 and biases about 0 so that no affine term is an identity the comparison
could not see. The same seed gives the same trees, on the card or the CPU.
"""

from __future__ import annotations

import math
from typing import Callable, List, Tuple

import torch

from benchmark.cells import load_tower

# purposes of the seed's sub-streams, so that a change in one draw leaves the others
STREAMS = {"clip": 1, "head": 2, "frames": 3, "features": 4, "masks": 5, "sample": 6, "visual": 7}


def generator(seed: int, purpose: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed((int(seed) * 1_000_003 + STREAMS[purpose]) % 2**63)


class Draws:
    """Leaves declared by shape and spread, then drawn in one call."""

    def __init__(self):
        self.specs: List[Tuple[tuple, float, float]] = []

    def leaf(self, shape, std: float, mean: float = 0.0) -> Callable[[torch.Tensor], torch.Tensor]:
        index = len(self.specs)
        self.specs.append((tuple(shape), std, mean))
        return lambda leaves: leaves[index]

    def draw(self, gen: torch.Generator, device) -> List[torch.Tensor]:
        sizes = [math.prod(shape) for shape, _, _ in self.specs]
        flat = torch.randn(sum(sizes), generator=gen, device=device)
        leaves = []
        for part, (shape, std, mean) in zip(flat.split(sizes), self.specs):
            leaves.append(part.view(shape).mul_(std).add_(mean))
        return leaves


def ln(d: Draws, width: int) -> dict:
    return {"scale": d.leaf((width,), 0.1, 1.0), "bias": d.leaf((width,), 0.02)}


def blocks(d: Draws, layers: int, width: int) -> list:
    proj_std = width**-0.5 * (2 * layers) ** -0.5
    return [
        {
            "ln_1": ln(d, width),
            "attn": {"qkv_w": d.leaf((width, 3 * width), width**-0.5), "qkv_b": d.leaf((3 * width,), 0.02),
                     "out_w": d.leaf((width, width), proj_std), "out_b": d.leaf((width,), 0.02)},
            "ln_2": ln(d, width),
            "mlp": {"fc_w": d.leaf((width, 4 * width), (2 * width) ** -0.5), "fc_b": d.leaf((4 * width,), 0.02),
                    "proj_w": d.leaf((4 * width, width), proj_std), "proj_b": d.leaf((width,), 0.02)},
        }
        for _ in range(layers)
    ]


def resolve(tree, leaves):
    if isinstance(tree, dict):
        return {k: resolve(v, leaves) for k, v in tree.items()}
    if isinstance(tree, list):
        return [resolve(v, leaves) for v in tree]
    return tree(leaves)


def draw(tree, seed: int, purpose: str, device, d: Draws):
    """The leaves ``d`` declared in ``tree``, drawn in one call."""
    return resolve(tree, d.draw(generator(seed, purpose, device), device))


def clip_tree(cfg: dict, seed: int, device, visual: bool = True) -> dict:
    """The CLIP towers of configuration ``cfg`` (fp32): the text tower, and
    where ``visual`` the image tower its ``tower`` file draws."""
    clip = cfg["clip"]
    d = Draws()
    tw, embed = clip["transformer_width"], clip["embed_dim"]
    text = {
        "token_embedding": d.leaf((clip["vocab_size"], tw), 0.02),
        "positional_embedding": d.leaf((clip["context_length"], tw), 0.01),
        "blocks": blocks(d, clip["transformer_layers"], tw),
        "ln_final": ln(d, tw),
        "text_projection": d.leaf((tw, embed), tw**-0.5),
    }
    out = {"text": draw(text, seed, "clip", device, d)}
    if visual:
        out["visual"] = load_tower(cfg["tower"]).visual_tree(clip, seed, device)
    out["logit_scale"] = torch.tensor(math.log(1 / 0.07), device=device)
    return out


def head_trees(cfg: dict, seed: int, device, text_projection: torch.Tensor) -> tuple:
    """-> (trainable, (bn mean, bn var), ncentroid): the prompt context, a copy
    of the frozen text projection, the temporal model (spreads of torch's
    Linear and Conv2d initialisation, std = bound / sqrt(3)), the selector's
    running statistics and the normality centroid."""
    model, clip = cfg["model"], cfg["clip"]
    n_cls, embed = len(cfg["classnames"]), clip["embed_dim"]
    emb, heads = model["emb_size"], model["heads"]
    hidden = (model["dim_heads"] or emb // heads) * heads
    width_in = embed + (n_cls - 1) * int(model["concat_features"])
    u = lambda fan_in: 1 / math.sqrt(fan_in) / math.sqrt(3)  # noqa: E731
    d = Draws()

    def attn():
        return {"ln": ln(d, emb), "to_q": d.leaf((emb, hidden), u(emb)),
                "to_kv": d.leaf((emb, 2 * hidden), u(emb)),
                "to_out_w": d.leaf((hidden, emb), u(hidden)), "to_out_b": d.leaf((emb,), u(hidden))}

    def ff():
        return {"ln_g": d.leaf((emb,), 0.1, 1.0), "ln_b": d.leaf((emb,), 0.02),
                "conv1_w": d.leaf((4 * emb, emb, 3, 3), u(9 * emb)), "conv1_b": d.leaf((4 * emb,), u(9 * emb)),
                "conv2_w": d.leaf((emb, 4 * emb, 3, 3), u(36 * emb)), "conv2_b": d.leaf((emb,), u(36 * emb))}

    ctx_shape = (model["n_ctx"], clip["transformer_width"])
    tree = {
        "prompt_ctx": d.leaf(ctx_shape if model["shared_context"] else (n_cls, *ctx_shape), 0.02),
        "temporal": {
            "projection": {"w": d.leaf((width_in, emb), u(width_in)), "b": d.leaf((emb,), u(width_in))},
            "pos_n": d.leaf((model["num_segments"], emb), 1.0),
            "pos_l": d.leaf((model["seg_length"], emb), 1.0),
            "layers": [{"attn_n": attn(), "attn_l": attn(), "ff1": ff(), "ff2": ff()}
                       for _ in range(model["depth"])],
            "head": {"ln": ln(d, emb), "w": d.leaf((emb, 1), u(emb)), "b": d.leaf((1,), u(emb))},
        },
        "bn_mean": d.leaf((n_cls - 1,), 0.1),
        "bn_var": d.leaf((n_cls - 1,), 0.2, 1.0),
        "ncentroid": d.leaf((embed,), 0.1),
    }
    drawn = draw(tree, seed, "head", device, d)
    trainable = {"prompt_ctx": drawn["prompt_ctx"], "text_projection": text_projection.float().clone(),
                 "temporal": drawn["temporal"]}
    return trainable, (drawn["bn_mean"], drawn["bn_var"].abs() + 0.05), drawn["ncentroid"]
