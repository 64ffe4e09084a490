"""The 7-term AnomalyCLIP training loss: the counterpart of
anomalyclip_tpu/models/losses.py.

Terms (weights from the model configs' ``loss:`` block):
    ldir_abn      -lambda * mean of the top-k abnormal logits at the GT class column
    ldir_nor      lambda * mean over normal frames of the per-frame max logit
    ltopk_abn     NLL of the joint class probs at the GT class, top-k abnormal frames
    lbottomk_abn  NLL at the normal class, bottom-k abnormal frames
    ltopk_nor     NLL at the normal class, top-k normal frames
    lsmooth       lambda * sum (s[t+1] - s[t])^2 over the flattened abnormal scores
    lsparse       lambda * mean of the abnormal scores

Batch convention: abnormal first half, normal second half.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class LossConfig:
    normal_id: int
    num_topk: int = 3
    lambda_dir_abn: float = 1.0
    lambda_dir_nor: float = 1.0
    lambda_topk_abn: float = 1.0
    lambda_bottomk_abn: float = 1.0
    lambda_topk_nor: float = 1.0
    lambda_smooth: float = 8e-4
    lambda_sparse: float = 8e-3
    frames_per_segment: int = 16
    num_segments: int = 32


class LossTerms(NamedTuple):
    total: torch.Tensor
    ldir_abn: torch.Tensor
    ldir_nor: torch.Tensor
    ltopk_abn: torch.Tensor
    lbottomk_abn: torch.Tensor
    ltopk_nor: torch.Tensor
    lsmooth: torch.Tensor
    lsparse: torch.Tensor


def _smoothness(scores: torch.Tensor) -> torch.Tensor:
    """sum (s[t+1] - s[t])^2 over the flat array, the last element paired with
    itself. The flat array runs across video boundaries, as the reference's does."""
    shifted = torch.cat([scores[1:], scores[-1:]])
    return ((shifted - scores) ** 2).sum()


def _nll(log_probs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood."""
    return -torch.gather(log_probs, 1, targets[:, None])[:, 0].mean()


def _safe_log(p: torch.Tensor) -> torch.Tensor:
    """log, clamped at 1e-12: a saturated sigmoid score gives a probability of
    exactly 0 in fp32, whose log would turn the whole update into NaN."""
    return torch.log(torch.clamp_min(p, 1e-12))


def compute_loss(
    similarity: torch.Tensor,
    similarity_topk: torch.Tensor,
    labels: torch.Tensor,
    scores: torch.Tensor,
    idx_topk_abn: torch.Tensor,
    idx_topk_nor: torch.Tensor,
    idx_bottomk_abn: torch.Tensor,
    cfg: LossConfig,
) -> LossTerms:
    """similarity: (b*n*l, C-1) batch-normed direction logits;
    similarity_topk: (b*k*l, C-1), abnormal rows first; labels: (b,) video
    labels; scores: (b*n*l,) sigmoid frame scores; idx_*: (b/2, k) selected
    segment indices."""
    b = labels.shape[0]
    half = b // 2
    n, l, k = cfg.num_segments, cfg.frames_per_segment, cfg.num_topk
    num_classes = similarity.shape[1] + 1

    alabels = labels[:half]
    # label -> column of the normal-row-dropped logits
    acols = torch.where(alabels > cfg.normal_id, alabels - 1, alabels)

    # direction terms (amax, as jnp.max, splits the gradient among ties)
    asim_topk = similarity_topk[: half * k * l]
    picked = torch.gather(asim_topk, 1, acols.repeat_interleave(k * l)[:, None])[:, 0]
    ldir_abn = cfg.lambda_dir_abn * (-picked.mean())
    nsim = similarity[similarity.shape[0] // 2 :]
    ldir_nor = cfg.lambda_dir_nor * nsim.amax(dim=1).mean()

    # joint class probabilities: the normal column is 1 - score, the abnormal
    # columns the class softmax times the score
    softmax_sim = torch.exp(similarity - similarity.amax(dim=1, keepdim=True))
    softmax_sim = softmax_sim / softmax_sim.sum(dim=1, keepdim=True)
    class_probs = softmax_sim * scores[:, None]
    class_probs = torch.cat(
        [class_probs[:, : cfg.normal_id], (1.0 - scores)[:, None], class_probs[:, cfg.normal_id :]],
        dim=1,
    ).reshape(b, n, l, num_classes)
    aprobs, nprobs = class_probs[:half], class_probs[half:]

    def gather_segments(probs, idx):
        index = idx[:, :, None, None].expand(idx.shape[0], idx.shape[1], l, num_classes)
        return torch.gather(probs, 1, index).reshape(-1, num_classes)

    log_topk_abn = _safe_log(gather_segments(aprobs, idx_topk_abn))
    log_bottomk_abn = _safe_log(gather_segments(aprobs, idx_bottomk_abn))
    log_topk_nor = _safe_log(gather_segments(nprobs, idx_topk_nor))

    # targets in the full class space: the column shift is undone
    ltopk_abn = cfg.lambda_topk_abn * _nll(log_topk_abn, alabels.repeat_interleave(k * l))
    normal = torch.full((log_bottomk_abn.shape[0],), cfg.normal_id, device=labels.device)
    lbottomk_abn = cfg.lambda_bottomk_abn * _nll(log_bottomk_abn, normal)
    normal = torch.full((log_topk_nor.shape[0],), cfg.normal_id, device=labels.device)
    ltopk_nor = cfg.lambda_topk_nor * _nll(log_topk_nor, normal)

    # smoothness and sparsity on the abnormal half's scores
    abn_scores = scores[: scores.shape[0] // 2]
    lsmooth = cfg.lambda_smooth * _smoothness(abn_scores)
    lsparse = cfg.lambda_sparse * abn_scores.mean()

    total = ldir_abn + ldir_nor + ltopk_abn + lbottomk_abn + ltopk_nor + lsmooth + lsparse
    return LossTerms(total, ldir_abn, ldir_nor, ltopk_abn, lbottomk_abn, ltopk_nor, lsmooth, lsparse)
