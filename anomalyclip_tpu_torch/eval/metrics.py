"""Evaluation metrics in pure numpy, matching the reference's torchmetrics surface.
A copy of anomalyclip_tpu/eval/metrics.py.

The reference computes these with torchmetrics objects (reference:
anomaly_clip_module.py:86-112, 339-404, 500-692); here they are direct numpy
implementations (validated against scikit-learn in tests/test_metrics.py):

- binary ROC curve / AUC-ROC, PR curve / average precision (frame-level detection)
- per-class one-vs-rest AUROC / AP with the reference's normal-class exclusion and
  zero->nan masking (anomaly recognition, :370-379)
- optimal ROC threshold: argmax(tpr - fpr) (:364-365)
- threshold-gated per-class top-1 / top-5 accuracy (:537-581)
- F1 vs threshold sweep, row-normalized confusion matrix (:621-691)
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def roc_curve(scores: np.ndarray, labels: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(fpr, tpr, thresholds), thresholds descending with a leading sentinel above
    the max score (sklearn/torchmetrics convention)."""
    order = np.argsort(-scores, kind="stable")
    scores_sorted = scores[order]
    labels_sorted = labels[order].astype(np.float64)

    # keep only threshold positions where the score changes
    distinct = np.where(np.diff(scores_sorted))[0]
    idx = np.concatenate([distinct, [len(scores_sorted) - 1]])

    tps = np.cumsum(labels_sorted)[idx]
    fps = (idx + 1) - tps
    thresholds = scores_sorted[idx]

    tps = np.concatenate([[0.0], tps])
    fps = np.concatenate([[0.0], fps])
    thresholds = np.concatenate([[thresholds[0] + 1.0], thresholds])

    p = labels_sorted.sum()
    n = len(labels_sorted) - p
    tpr = tps / p if p > 0 else np.zeros_like(tps)
    fpr = fps / n if n > 0 else np.zeros_like(fps)
    return fpr, tpr, thresholds


# np.trapezoid is numpy>=2; np.trapz is its numpy-1.x name
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


def auroc(scores: np.ndarray, labels: np.ndarray) -> float:
    """AUC-ROC; nan when the labels are single-class (sklearn refuses such
    input outright) — a finite 0.0 would read as a catastrophically bad epoch
    to early stopping / sweeps, where nan is correctly filtered as undefined
    (module.py gates the early-stopping monitor on isfinite)."""
    labels = np.asarray(labels)
    p = int(np.count_nonzero(labels))
    if p == 0 or p == len(labels):
        return float("nan")
    fpr, tpr, _ = roc_curve(scores, labels)
    return float(_trapezoid(tpr, fpr))


def precision_recall_curve(
    scores: np.ndarray, labels: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(precision, recall, thresholds); recall decreasing from 1 to 0, final point
    (P=1, R=0) appended (sklearn convention)."""
    order = np.argsort(-scores, kind="stable")
    scores_sorted = scores[order]
    labels_sorted = labels[order].astype(np.float64)

    distinct = np.where(np.diff(scores_sorted))[0]
    idx = np.concatenate([distinct, [len(scores_sorted) - 1]])

    tps = np.cumsum(labels_sorted)[idx]
    fps = (idx + 1) - tps
    thresholds = scores_sorted[idx]

    denom = tps + fps
    precision = np.divide(tps, denom, out=np.zeros_like(tps), where=denom > 0)
    p = labels_sorted.sum()
    recall = tps / p if p > 0 else np.zeros_like(tps)

    # cut at full recall, then append the (1, 0) endpoint, reversed order
    last = tps.searchsorted(tps[-1]) if p > 0 else len(tps) - 1
    sl = slice(last, None, -1)
    return (
        np.concatenate([precision[sl], [1.0]]),
        np.concatenate([recall[sl], [0.0]]),
        thresholds[sl],
    )


def average_precision(scores: np.ndarray, labels: np.ndarray) -> float:
    """AP = Σ (R_i - R_{i-1}) P_i (sklearn average_precision_score); nan with
    zero positives (undefined, same rationale as auroc)."""
    if not np.count_nonzero(np.asarray(labels)):
        return float("nan")
    precision, recall, _ = precision_recall_curve(scores, labels)
    return float(-np.sum(np.diff(recall) * precision[:-1]))


def per_class_auroc(class_probs: np.ndarray, labels: np.ndarray, num_classes: int) -> np.ndarray:
    """One-vs-rest AUROC per class; 0.0 for classes with no positives or no
    negatives (then nan-masked by the caller, mirroring anomaly_clip_module.py:373-375)."""
    out = np.zeros(num_classes)
    for c in range(num_classes):
        binary = (labels == c).astype(np.int64)
        if 0 < binary.sum() < len(binary):
            out[c] = auroc(class_probs[:, c], binary)
    return out


def per_class_ap(class_probs: np.ndarray, labels: np.ndarray, num_classes: int) -> np.ndarray:
    out = np.zeros(num_classes)
    for c in range(num_classes):
        binary = (labels == c).astype(np.int64)
        if binary.sum() > 0:
            out[c] = average_precision(class_probs[:, c], binary)
    return out


def mean_excluding_normal(values: np.ndarray, normal_id: int) -> float:
    """Drop the normal class, mask exact zeros to nan, nanmean
    (anomaly_clip_module.py:373-379)."""
    rest = np.concatenate([values[:normal_id], values[normal_id + 1 :]]).astype(float)
    rest[rest == 0] = np.nan
    return float(np.nanmean(rest)) if not np.all(np.isnan(rest)) else float("nan")


def optimal_roc_threshold(scores: np.ndarray, labels: np.ndarray) -> float:
    fpr, tpr, thresholds = roc_curve(scores, labels)
    return float(thresholds[int(np.argmax(tpr - fpr))])


def binary_f1(preds: np.ndarray, labels: np.ndarray) -> float:
    tp = float(np.sum((preds == 1) & (labels == 1)))
    fp = float(np.sum((preds == 1) & (labels == 0)))
    fn = float(np.sum((preds == 0) & (labels == 1)))
    denom = 2 * tp + fp + fn
    return 2 * tp / denom if denom > 0 else 0.0


def f1_threshold_sweep(scores: np.ndarray, labels_binary: np.ndarray) -> Dict[float, float]:
    """F1 at thresholds 0.1, 0.2, ..., 1.0 (anomaly_clip_module.py:621-626)."""
    return {
        (i + 1) / 10: binary_f1((scores >= (i + 1) / 10).astype(np.int64), labels_binary)
        for i in range(10)
    }


def confusion_matrix_normalized(
    preds: np.ndarray, labels: np.ndarray, num_classes: int
) -> np.ndarray:
    """Row-normalized (over true class) confusion matrix
    (torchmetrics normalize="true", anomaly_clip_module.py:91-93)."""
    mat = np.zeros((num_classes, num_classes), dtype=np.float64)
    np.add.at(mat, (labels, preds), 1.0)
    row = mat.sum(axis=1, keepdims=True)
    return np.divide(mat, row, out=np.zeros_like(mat), where=row > 0)


def gated_class_predictions(
    abnormal_scores: np.ndarray,
    class_probs_full: np.ndarray,
    normal_id: int,
    threshold: float,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Threshold-gated predictions (anomaly_clip_module.py:537-572).

    Returns (y_pred, top1_preds, top5_preds): frames under the threshold predict
    normal; others argmax/top-5 over the abnormal columns (ids shifted past the
    normal id); top-k lists get the normal id spliced in front when gated.
    """
    without_normal = np.concatenate(
        [class_probs_full[:, :normal_id], class_probs_full[:, normal_id + 1 :]], axis=1
    )
    raw_top1 = np.argmax(without_normal, axis=1)
    shift = np.where(raw_top1 >= normal_id, raw_top1 + 1, raw_top1)
    gated = abnormal_scores < threshold
    y_pred = np.where(gated, normal_id, shift)
    top1 = np.where(gated, normal_id, shift)

    k = min(5, without_normal.shape[1])
    raw_topk = np.argsort(-without_normal, axis=1, kind="stable")[:, :k]
    topk = np.where(raw_topk >= normal_id, raw_topk + 1, raw_topk)
    gated_topk = np.concatenate(
        [np.full((len(topk), 1), normal_id), topk[:, : k - 1]], axis=1
    )
    top5 = np.where(gated[:, None], gated_topk, topk)
    return y_pred, top1, top5


def per_class_topk_accuracy(
    top1: np.ndarray, top5: np.ndarray, labels: np.ndarray, num_classes: int
) -> Tuple[np.ndarray, np.ndarray]:
    """(anomaly_clip_module.py:574-581); classes with no frames get nan."""
    acc1 = np.full(num_classes, np.nan)
    acc5 = np.full(num_classes, np.nan)
    for c in range(num_classes):
        mask = labels == c
        if mask.sum() == 0:
            continue
        acc1[c] = float(np.mean(top1[mask] == c))
        acc5[c] = float(np.mean((top5[mask] == c).any(axis=1)))
    return acc1, acc5


def detection_metrics(
    abnormal_scores: np.ndarray,
    labels: np.ndarray,
    class_probs: np.ndarray,
    normal_id: int,
    num_classes: int,
) -> Dict[str, object]:
    """The epoch-end metric block shared by validation and test
    (anomaly_clip_module.py:339-395): AUC, AP, per-class mAUC/mAP, optimal threshold.

    Args:
        abnormal_scores: (T,) frame scores. labels: (T,) frame class labels.
        class_probs: (T, num_classes-1) joint probs WITHOUT the normal column.
    """
    normal_probs = (1.0 - abnormal_scores)[:, None]
    class_probs_full = np.concatenate(
        [class_probs[:, :normal_id], normal_probs, class_probs[:, normal_id:]], axis=1
    )
    labels_binary = (labels != normal_id).astype(np.int64)

    auc_roc = auroc(abnormal_scores, labels_binary)
    auc_pr = average_precision(abnormal_scores, labels_binary)
    threshold = optimal_roc_threshold(abnormal_scores, labels_binary)

    mc_auroc = per_class_auroc(class_probs_full, labels, num_classes)
    mc_aupr = per_class_ap(class_probs_full, labels, num_classes)

    return {
        "auc_roc": auc_roc,
        "auc_pr": auc_pr,
        "mean_mc_auroc": mean_excluding_normal(mc_auroc, normal_id),
        "mean_mc_aupr": mean_excluding_normal(mc_aupr, normal_id),
        "mc_auroc": mc_auroc.tolist(),
        "mc_aupr": mc_aupr.tolist(),
        "optimal_threshold": threshold,
        "class_probs_full": class_probs_full,
        "labels_binary": labels_binary,
    }
