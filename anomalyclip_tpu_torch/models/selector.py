"""Direction scoring, MIL top-k/bottom-k selection and the selector's
non-affine BatchNorm: the counterpart of anomalyclip_tpu/models/selector.py.

Batch convention: the first half of the batch is abnormal videos, the second
half normal. Segment-dropout masks come from a ``torch.Generator``, which cannot
reproduce the JAX PRNG's bits; ``select_topk`` takes the mask as an argument, so
tests feed both packages the same mask.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from anomalyclip_tpu_torch.numerics import full_fp32
from anomalyclip_tpu_torch.parallel.mesh import across_ranks, sum_over_ranks

MASK_FILL = 1e6  # dropped segments rank last (selector.py:29)


class BNState(NamedTuple):
    """Running statistics of the non-affine BatchNorm over the (n_cls-1) logit
    channels. torch semantics: normalization uses the biased batch variance; the
    running variance stores the unbiased estimate; momentum 0.1."""

    mean: torch.Tensor  # (n_cls - 1,)
    var: torch.Tensor  # (n_cls - 1,)

    @staticmethod
    def create(num_channels: int) -> "BNState":
        return BNState(mean=torch.zeros(num_channels), var=torch.ones(num_channels))

    def to(self, device) -> "BNState":
        return BNState(mean=self.mean.to(device), var=self.var.to(device))


@dataclasses.dataclass(frozen=True)
class SelectorConfig:
    normal_id: int
    num_segments: int = 32
    seg_length: int = 16
    select_idx_dropout_topk: float = 0.7
    select_idx_dropout_bottomk: float = 0.7
    num_topk: int = 3
    num_bottomk: int = 3
    bn_momentum: float = 0.1
    bn_eps: float = 1e-5


class TopkSelection(NamedTuple):
    """Training-mode selector outputs."""

    logits: torch.Tensor  # (b*n*l, C-1) batch-normalized direction logits
    logits_topk: torch.Tensor  # (b*k*l, C-1) selected top-k segments (abn, nor)
    logits_bottomk: torch.Tensor  # (b*k*l, C-1) selected bottom-k segments
    idx_topk_abn: torch.Tensor  # (b/2, k)
    idx_topk_nor: torch.Tensor  # (b/2, k)
    idx_bottomk_abn: torch.Tensor  # (b/2, k)


def direction_logits(
    image_features: torch.Tensor,
    text_features: torch.Tensor,
    ncentroid: torch.Tensor,
    normal_id: int,
) -> torch.Tensor:
    """Scalar projection of re-centered image features (T, D) onto the
    re-centered, L2-normalized abnormal-class text directions -> (T, C-1).
    fp32 operands get full fp32 products, as the JAX package's
    Precision.HIGHEST does."""
    text = torch.cat([text_features[:normal_id], text_features[normal_id + 1 :]], dim=0)
    text = text - ncentroid
    text = text / torch.linalg.vector_norm(text, dim=-1, keepdim=True)
    image = image_features - ncentroid
    if image.dtype == torch.float32:
        with full_fp32():
            return image @ text.T.to(image.dtype)
    return image @ text.T.to(image.dtype)


def batch_norm_apply(
    logits: torch.Tensor,
    state: BNState,
    training: bool,
    momentum: float = 0.1,
    eps: float = 1e-5,
    dp: Optional[Tuple[int, int]] = None,
) -> Tuple[torch.Tensor, BNState]:
    """Non-affine BatchNorm1d over channels -> (normed, new state). In training
    mode the batch statistics normalize (and carry the gradient); the running
    state takes their detached values.

    ``dp=(rank, ranks)`` is sync-BN over a data-parallel group: ``logits`` are
    this rank's rows of the global batch, the mean and the biased variance are
    taken over every rank's rows through sums that carry the gradient, and the
    running variance's unbiased count is the global row count (JAX
    selector.py:99-124 on a sharded batch). One rank's rows are the whole
    batch (``across_ranks``)."""
    if training:
        if across_ranks(dp):
            count = logits.shape[0] * dp[1]
            mean = sum_over_ranks(logits.sum(dim=0)) / count
            centered = logits - mean
            var = sum_over_ranks((centered * centered).sum(dim=0)) / count  # biased, normalizes
        else:
            mean = logits.mean(dim=0)
            var = logits.var(dim=0, unbiased=False)  # biased, used for normalization
            count = logits.shape[0]
        unbiased = var.detach() * (count / max(count - 1, 1))
        new_state = BNState(
            mean=(1 - momentum) * state.mean + momentum * mean.detach(),
            var=(1 - momentum) * state.var + momentum * unbiased,
        )
    else:
        mean, var = state.mean, state.var
        new_state = state
    return (logits - mean) * torch.rsqrt(var + eps), new_state


def generate_masks(
    gen: torch.Generator, batch: int, cfg: SelectorConfig
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bernoulli keep masks (batch, num_segments) on the generator's device,
    keep-prob = 1 - dropout. When both dropout rates are equal the top-k mask
    *is* the bottom-k mask, the reference's quirk (selector.py:139-140)."""
    shape = (batch, cfg.num_segments)

    def draw(rate):
        return torch.rand(shape, generator=gen, device=gen.device) < 1.0 - rate

    bottomk_mask = draw(cfg.select_idx_dropout_bottomk)
    if cfg.select_idx_dropout_topk == cfg.select_idx_dropout_bottomk:
        return bottomk_mask, bottomk_mask
    return draw(cfg.select_idx_dropout_topk), bottomk_mask


def _abnormal_class_column(labels: torch.Tensor, normal_id: int) -> torch.Tensor:
    """Dataset labels -> columns of the normal-row-dropped logits."""
    return torch.where(labels > normal_id, labels - 1, labels)


def _segment_scores(logits: torch.Tensor, cfg: SelectorConfig) -> torch.Tensor:
    """(b, n*l, C-1) -> per-segment scores (b, n, C-1), summed within segments."""
    b = logits.shape[0]
    return logits.reshape(b, cfg.num_segments, cfg.seg_length, -1).sum(dim=2)


def _gather_segments(logits: torch.Tensor, idx: torch.Tensor, cfg: SelectorConfig) -> torch.Tensor:
    """Selected segments: (b, n*l, C-1), (b, k) -> (b*k*l, C-1)."""
    b, c = logits.shape[0], logits.shape[-1]
    seg = logits.reshape(b, cfg.num_segments, cfg.seg_length, c)
    index = idx[:, :, None, None].expand(b, idx.shape[1], cfg.seg_length, c)
    return torch.gather(seg, 1, index).reshape(-1, c)


def _top_k_indices(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries per row, ties toward the lower index as
    ``lax.top_k`` breaks them (dropped segments tie at -MASK_FILL): a stable
    descending sort, since ``torch.topk`` promises no order among ties."""
    return torch.sort(scores, dim=1, descending=True, stable=True).indices[:, :k]


def select_topk(
    logits: torch.Tensor,
    labels: torch.Tensor,
    mask: torch.Tensor,
    cfg: SelectorConfig,
    largest: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k (or bottom-k) MIL segment selection.

    The abnormal half ranks segments by the ground-truth class column of the
    per-segment scores, the normal half by the class-summed scores; dropped
    segments (mask False) are pushed to -+MASK_FILL.

    logits: (b, n*l, C-1) batch-normalized, abnormal first; labels: (b,);
    mask: (b, n) bool keep mask.
    Returns (selected logits (b*k*l, C-1), idx_abn (b/2, k), idx_nor (b/2, k))."""
    k = cfg.num_topk if largest else cfg.num_bottomk
    half = logits.shape[0] // 2

    seg_scores = _segment_scores(logits.detach(), cfg)  # ranking only: no gradient
    fill = -MASK_FILL if largest else MASK_FILL
    dropped = seg_scores.masked_fill(~mask[:, :, None], fill)

    acols = _abnormal_class_column(labels[:half], cfg.normal_id)
    index = acols[:, None, None].expand(half, cfg.num_segments, 1)
    a_scores = torch.gather(dropped[:half], 2, index)[..., 0]
    n_scores = dropped[half:].sum(dim=2)

    sign = 1.0 if largest else -1.0
    idx_abn = _top_k_indices(sign * a_scores, k)
    idx_nor = _top_k_indices(sign * n_scores, k)
    selected = torch.cat(
        [
            _gather_segments(logits[:half], idx_abn, cfg),
            _gather_segments(logits[half:], idx_nor, cfg),
        ]
    )
    return selected, idx_abn, idx_nor


def selector_train(
    image_features: torch.Tensor,
    text_features: torch.Tensor,
    labels: torch.Tensor,
    ncentroid: torch.Tensor,
    bn_state: BNState,
    gen: torch.Generator,
    cfg: SelectorConfig,
    dp: Optional[Tuple[int, int]] = None,
) -> Tuple[TopkSelection, BNState]:
    """Training-mode selector. image_features: (b*n*l, D) flattened, abnormal
    half first; labels: (b,). The dropout masks are drawn from ``gen`` and
    moved to the features' device.

    ``dp=(rank, ranks)``: this rank's block of a data-parallel global batch.
    The BatchNorm is sync-BN over the group, and the masks are drawn for the
    global batch, as one process draws them, and sliced to this rank's rows
    (abnormal ``rank*b/2 ...``, normal ``ranks*b/2 + rank*b/2 ...``)."""
    raw = direction_logits(image_features, text_features, ncentroid, cfg.normal_id)
    normed, new_bn = batch_norm_apply(
        raw, bn_state, training=True, momentum=cfg.bn_momentum, eps=cfg.bn_eps, dp=dp
    )
    b = labels.shape[0]
    per_video = normed.reshape(b, cfg.num_segments * cfg.seg_length, -1)

    if across_ranks(dp):
        (me, ranks), half = dp, b // 2
        rows = torch.cat([torch.arange(me * half, (me + 1) * half),
                          torch.arange((ranks + me) * half, (ranks + me + 1) * half)])
        masks = tuple(m[rows.to(m.device)] for m in generate_masks(gen, b * ranks, cfg))
    else:
        masks = generate_masks(gen, b, cfg)
    topk_mask, bottomk_mask = (m.to(normed.device) for m in masks)
    logits_topk, idx_topk_abn, idx_topk_nor = select_topk(
        per_video, labels, topk_mask, cfg, largest=True
    )
    logits_bottomk, idx_bottomk_abn, _ = select_topk(
        per_video, labels, bottomk_mask, cfg, largest=False
    )
    selection = TopkSelection(
        logits=normed,
        logits_topk=logits_topk,
        logits_bottomk=logits_bottomk,
        idx_topk_abn=idx_topk_abn,
        idx_topk_nor=idx_topk_nor,
        idx_bottomk_abn=idx_bottomk_abn,
    )
    return selection, new_bn


def selector_test(
    image_features: torch.Tensor,
    text_features: torch.Tensor,
    ncentroid: torch.Tensor,
    bn_state: BNState,
    cfg: SelectorConfig,
) -> torch.Tensor:
    """Test-mode selector: normalized direction logits with the running
    statistics."""
    raw = direction_logits(image_features, text_features, ncentroid, cfg.normal_id)
    return batch_norm_apply(raw, bn_state, training=False, eps=cfg.bn_eps)[0]
