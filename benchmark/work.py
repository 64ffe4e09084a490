"""The yardstick's arithmetic: the card's peaks, the model FLOPs that the
inputs need, and the least time of the attention calls, all from shapes.

Work is counted for what the inputs need, whatever implements it: the image
tower over each video's distinct real frames (not the wrapped or padded frames
the program encodes; each tower's file counts its own), the head over the
grids that cover a video (not the grids a bucket pads to). A product of (M, K) by (K, N) is 2 M K N FLOPs;
LayerNorm, activations, softmax and the other elementwise work are not
counted. A backward pass counts the input gradient of every product whose
input needs one and the weight gradient of every trainable weight.
"""

from __future__ import annotations

# NVIDIA H100 SXM, dense: bf16 tensor cores; fp32 as split-TF32, the least time
# for an fp32-accurate product on the tensor cores (495 TFLOP/s of TF32 over the
# three products each takes); HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 495e12 / 3}
PEAK_BYTES_PER_S = 3.35e12
ITEMSIZE = {"bfloat16": 2, "float32": 4}

# FLOPs per (batch entry, head, query, key, column), and tensors of
# B x H x L x dh elements read or written, by kind of attention kernel
ATTENTION_WORK = {"fwd": (4, 4), "bwd": (10, 7)}


def attention_bound_s(kind: str, dims: tuple, dtype: str, causal: bool = False) -> float:
    """The least time of one attention call of ``kind`` over dims = (B, H, L,
    dh): its FLOPs (half when causal) over the peak for its operand type, or
    its bytes over the memory rate, each input read once and each output
    written once, whichever is longer."""
    b, h, l, dh = dims
    per_pair, tensors = ATTENTION_WORK[kind]
    flops = per_pair * b * h * l * l * dh * (0.5 if causal else 1.0)
    nbytes = ITEMSIZE[dtype] * tensors * b * h * l * dh
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S)


def tower_flops(layers: int, width: int, tokens: int, causal: bool = False) -> float:
    """Forward FLOPs of ``layers`` pre-LN blocks over one sequence."""
    linear = 2 * tokens * 12 * width * width
    attention = 4 * tokens * tokens * width * (0.5 if causal else 1.0)
    return layers * (linear + attention)


def text_flops(clip: dict, prompts: int) -> float:
    """Forward FLOPs of the text tower over ``prompts`` prompts."""
    width = clip["transformer_width"]
    tokens = clip["context_length"]
    return prompts * (tower_flops(clip["transformer_layers"], width, tokens, causal=True)
                      + 2 * width * clip["embed_dim"])


def head_flops_per_grid(cfg: dict) -> float:
    """Forward FLOPs of the selector and the temporal model over one (n x l) grid."""
    model, clip = cfg["model"], cfg["clip"]
    n, l, emb, depth = model["num_segments"], model["seg_length"], model["emb_size"], model["depth"]
    hidden = (model["dim_heads"] or emb // model["heads"]) * model["heads"]
    frames, dim, classes = n * l, clip["embed_dim"], len(cfg["classnames"]) - 1
    selector = 2 * frames * dim * classes
    projection = 2 * frames * dim * emb
    attention_projections = 2 * frames * emb * hidden * 4  # q, k, v, out
    attention_products = 4 * hidden * (l * n * n + n * l * l)  # along n, then along l
    convs = 4 * 2 * frames * 9 * emb * 4 * emb  # ff1 and ff2, two 3x3 convs each
    score_head = 2 * frames * emb
    per_depth = 2 * attention_projections + attention_products + convs
    return selector + projection + depth * per_depth + score_head


def clip_grids(frames: int, cfg: dict) -> int:
    """The (n x l) grids that cover a clip of ``frames`` frames."""
    per_grid = cfg["model"]["num_segments"] * cfg["model"]["seg_length"]
    return -(-frames // per_grid)


def train_step_flops(cfg: dict, batch: int) -> float:
    """Forward plus backward FLOPs of one training step from features. The text
    tower's weights are frozen (its backward is the input gradient, as much as
    its forward), the temporal model's are trained (twice its forward), the
    selector's backward reaches the text features (twice its forward)."""
    prompts = len(cfg["classnames"])
    text = text_flops(cfg["clip"], prompts)
    head = batch * head_flops_per_grid(cfg)
    return 2 * text + 3 * head


def temporal_attention_bound_s(cfg: dict, grids: int, kind: str = "fwd") -> float:
    """The temporal model's attention over ``grids`` grids (fp32 under either
    compute type): along the segments, then along the frames, per depth."""
    model = cfg["model"]
    n, l, heads = model["num_segments"], model["seg_length"], model["heads"]
    dh = model["dim_heads"] or model["emb_size"] // heads
    one = (attention_bound_s(kind, (grids * l, heads, n, dh), "float32")
           + attention_bound_s(kind, (grids * n, heads, l, dh), "float32"))
    return model["depth"] * one


def text_attention_bound_s(clip: dict, prompts: int, kind: str, dtype: str) -> float:
    heads = clip["transformer_heads"]
    dims = (prompts, heads, clip["context_length"], clip["transformer_width"] // heads)
    return clip["transformer_layers"] * attention_bound_s(kind, dims, dtype, causal=True)
