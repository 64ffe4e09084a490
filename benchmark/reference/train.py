"""AnomalyCLIP's training step in plain PyTorch: the forward on a batch of CLIP
features (abnormal half first), the selector's BatchNorm on batch statistics
and its MIL top-k and bottom-k segment selection under segment dropout, the
seven UCF-Crime loss terms, and ``torch.optim.AdamW`` on the warmup-cosine
learning rate of the step's epoch.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.anomaly import direction_logits, temporal_scores
from benchmark.reference.clip import text_features
from benchmark.reference.precision import Products

MASK_FILL = 1e6


def lr_at(step: int, cfg: dict) -> float:
    """The learning rate of update ``step`` (from 0): linear warmup from 0 over
    ``warmup_epochs``, then cosine to 0 over the rest of ``total_epoch``, by
    the step's epoch."""
    base = cfg["solver"]["lr"]
    warmup, total = cfg["scheduler"]["warmup_epochs"], cfg["scheduler"]["total_epoch"]
    epoch = step // cfg["epoch_steps"]
    if epoch < warmup:
        return base * epoch / warmup
    progress = min((epoch - warmup) / max(total - warmup, 1), 1.0)
    return base * (math.cos(math.pi * progress) + 1.0) / 2.0


def _select(normed: torch.Tensor, labels: torch.Tensor, keep: torch.Tensor, model: dict,
            largest: bool) -> tuple:
    """MIL selection on (b, n*l, C-1) logits -> (selected (b*k*l, C-1), idx_abn, idx_nor).
    The abnormal half ranks segments by its class's column, the normal half by
    the sum over classes; dropped segments rank last; ties go to the lower index."""
    n, l, normal_id = model["num_segments"], model["seg_length"], model["normal_id"]
    k = model["num_topk"] if largest else model["num_bottomk"]
    b, _, c = normed.shape
    half = b // 2
    seg = normed.detach().reshape(b, n, l, c).sum(dim=2)
    seg = seg.masked_fill(~keep[:, :, None], -MASK_FILL if largest else MASK_FILL)
    cols = torch.where(labels[:half] > normal_id, labels[:half] - 1, labels[:half])
    ranked_abn = seg[:half].gather(2, cols[:, None, None].expand(half, n, 1))[..., 0]
    ranked_nor = seg[half:].sum(dim=2)
    sign = 1.0 if largest else -1.0
    order = lambda s: torch.sort(sign * s, dim=1, descending=True, stable=True).indices[:, :k]  # noqa: E731
    idx_abn, idx_nor = order(ranked_abn), order(ranked_nor)

    def gather(rows, idx):
        segs = rows.reshape(rows.shape[0], n, l, c)
        return segs.gather(1, idx[:, :, None, None].expand(idx.shape[0], k, l, c)).reshape(-1, c)

    return torch.cat([gather(normed[:half], idx_abn), gather(normed[half:], idx_nor)]), idx_abn, idx_nor


def loss(trainable: dict, frozen_text: dict, bn: tuple, features: torch.Tensor, labels: torch.Tensor,
         ncentroid: torch.Tensor, keep: torch.Tensor, cfg: dict, prod: Products) -> tuple:
    """The training forward and loss on (b, n*l, D) features -> (total, new BN (mean, var))."""
    model, lc = cfg["model"], cfg["loss"]
    n, l, normal_id = model["num_segments"], model["seg_length"], model["normal_id"]
    b = labels.shape[0]
    half = b // 2
    text = text_features(frozen_text, cfg["clip"], torch.as_tensor(cfg["prompt_token_ids_padded"],
                         device=features.device), trainable["prompt_ctx"], trainable["text_projection"], prod)
    flat = features.reshape(b * n * l, -1).float()
    raw = direction_logits(flat, text, ncentroid, normal_id, prod)
    mean, var = raw.mean(dim=0), raw.var(dim=0, unbiased=False)
    rows = raw.shape[0]
    new_bn = (0.9 * bn[0] + 0.1 * mean.detach(), 0.9 * bn[1] + 0.1 * var.detach() * rows / (rows - 1))
    normed = (raw - mean) / torch.sqrt(var + 1e-5)
    per_video = normed.reshape(b, n * l, -1)
    topk, idx_top_abn, idx_top_nor = _select(per_video, labels, keep, model, True)
    _, idx_bot_abn, _ = _select(per_video, labels, keep, model, False)
    scores = temporal_scores((flat - ncentroid).reshape(b, n, l, -1), trainable["temporal"],
                             model["heads"], prod).reshape(-1)

    k = model["num_topk"]
    cols = torch.where(labels[:half] > normal_id, labels[:half] - 1, labels[:half])
    ldir_abn = -topk[: half * k * l].gather(1, cols.repeat_interleave(k * l)[:, None]).mean()
    ldir_nor = normed[rows // 2:].amax(dim=1).mean()
    probs = torch.softmax(normed, dim=1) * scores[:, None]
    probs = torch.cat([probs[:, :normal_id], (1.0 - scores)[:, None], probs[:, normal_id:]], dim=1)
    probs = probs.reshape(b, n, l, -1)
    c = probs.shape[-1]

    def nll(p, idx, target):
        picked = p.gather(1, idx[:, :, None, None].expand(idx.shape[0], idx.shape[1], l, c)).reshape(-1, c)
        return -torch.log(picked.clamp_min(1e-12)).gather(1, target[:, None]).mean()

    normal = lambda m: torch.full((m,), normal_id, device=labels.device)  # noqa: E731
    ltop_abn = nll(probs[:half], idx_top_abn, labels[:half].repeat_interleave(k * l))
    lbot_abn = nll(probs[:half], idx_bot_abn, normal(half * model["num_bottomk"] * l))
    ltop_nor = nll(probs[half:], idx_top_nor, normal(half * k * l))
    abn = scores[: scores.shape[0] // 2]
    lsmooth = ((torch.cat([abn[1:], abn[-1:]]) - abn) ** 2).sum()
    total = (lc["lambda_dir_abn"] * ldir_abn + lc["lambda_dir_nor"] * ldir_nor
             + lc["lambda_topk_abn"] * ltop_abn + lc["lambda_bottomk_abn"] * lbot_abn
             + lc["lambda_topk_nor"] * ltop_nor + lc["lambda_smooth"] * lsmooth
             + lc["lambda_sparse"] * abn.mean())
    return total, new_bn


def keep_masks(gen: torch.Generator, batch: int, cfg: dict) -> torch.Tensor:
    """One step's segment keep mask (batch, num_segments): Bernoulli with keep
    probability 1 - dropout. With equal top-k and bottom-k rates one draw serves
    both selections, as the published selector does."""
    model = cfg["model"]
    if model["select_idx_dropout_topk"] != model["select_idx_dropout_bottomk"]:
        raise ValueError("the reference draws one mask: the two dropout rates must be equal")
    shape = (batch, model["num_segments"])
    return torch.rand(shape, generator=gen, device=gen.device) < 1.0 - model["select_idx_dropout_bottomk"]


class Trainer:
    """The reference's trainable leaves, BN state and ``torch.optim.AdamW``."""

    def __init__(self, trainable: dict, bn: tuple, cfg: dict, first_step: int, prod: Products):
        self.cfg, self.prod, self.step_count = cfg, prod, first_step
        self.trainable = _tree_map(lambda t: t.detach().float().clone().requires_grad_(True), trainable)
        self.bn = tuple(t.detach().float().clone() for t in bn)
        self.leaves = _leaves(self.trainable)
        self.optimizer = torch.optim.AdamW(self.leaves, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                                           weight_decay=cfg["optimizer"]["weight_decay"])

    def step(self, frozen_text: dict, features: torch.Tensor, labels: torch.Tensor,
             ncentroid: torch.Tensor, keep: torch.Tensor) -> tuple:
        """One update -> (loss, the gradients the optimizer got, leaf by leaf)."""
        self.optimizer.zero_grad(set_to_none=True)
        with self.prod.scope():
            total, self.bn = loss(self.trainable, frozen_text, self.bn, features, labels, ncentroid, keep,
                                  self.cfg, self.prod)
            total.backward()
        grads = [p.grad.detach().clone() for p in self.leaves]
        for group in self.optimizer.param_groups:
            group["lr"] = lr_at(self.step_count, self.cfg)
        self.optimizer.step()
        self.step_count += 1
        return float(total.detach()), grads


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree) -> list:
    """Leaves in the order of a depth-first walk, dict keys in insertion order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [tree]


def leaf_names(tree, prefix: str = "") -> list:
    if isinstance(tree, dict):
        return [name for k, v in tree.items() for name in leaf_names(v, f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [name for i, v in enumerate(tree) for name in leaf_names(v, f"{prefix}{i}/")]
    return [prefix.rstrip("/")]
