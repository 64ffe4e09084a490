"""Evaluation artifacts: metrics JSON + PR/ROC/F1/confusion-matrix PNGs. A copy
of anomalyclip_tpu/eval/artifacts.py with ``matplotlib`` (and ``seaborn``)
imported inside the plotting functions: where they do not import,
``write_test_artifacts`` writes ``metrics.json``, logs one warning naming the
PNGs it skipped and returns the same metrics.

Mirror of the reference's test_epoch_end outputs (reference:
anomaly_clip_module.py:594-691): metrics.json, PR.png, ROC.png, F1.png,
confusion_matrix.png, written to the run directory.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from anomalyclip_tpu_torch.eval import metrics as M
from anomalyclip_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

PLOTS = ("PR.png", "ROC.png", "F1.png", "confusion_matrix.png")


def write_metrics_json(save_dir: str | Path, metrics: Dict, epoch: Optional[int] = None) -> Path:
    """metrics_{epoch}.json per-epoch (validation) or metrics.json (test)
    (anomaly_clip_module.py:397-400, 618-619)."""
    save_dir = Path(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    name = "metrics.json" if epoch is None else f"metrics_{epoch}.json"
    path = save_dir / name
    serializable = {
        k: (v.tolist() if isinstance(v, np.ndarray) else v) for k, v in metrics.items()
    }
    with open(path, "w") as fp:
        json.dump(serializable, fp, indent=4, sort_keys=True, default=float)
    return path


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_pr_curve(save_dir, recall, precision, auc_pr: float) -> None:
    plt = _pyplot()
    plt.style.use("ggplot")
    plt.figure()
    plt.ylim(0, 1.1)
    plt.plot(recall, precision, color="red")
    plt.title(f"PR Curve: {auc_pr * 100:.2f}")
    plt.ylabel("Precision")
    plt.xlabel("Recall")
    plt.savefig(Path(save_dir) / "PR.png")
    plt.close()


def plot_roc_curve(save_dir, fpr, tpr, auc_roc: float) -> None:
    plt = _pyplot()
    plt.style.use("ggplot")
    plt.figure()
    plt.ylim(0, 1.1)
    plt.plot(fpr, tpr, color="blue")
    plt.title(f"ROC Curve: {auc_roc * 100:.2f}")
    plt.ylabel("True Positive Rate")
    plt.xlabel("False Positive Rate")
    plt.savefig(Path(save_dir) / "ROC.png")
    plt.close()


def plot_f1_sweep(save_dir, f1_scores: Dict[float, float]) -> None:
    plt = _pyplot()
    xs = sorted(f1_scores)
    ys = [f1_scores[x] for x in xs]
    plt.style.use("ggplot")
    plt.figure()
    plt.plot(xs, ys, color="blue")
    plt.title(f"F1@0.5: {f1_scores[0.5] * 100:.2f}")
    plt.ylabel("F1")
    plt.xlabel("threshold")
    plt.savefig(Path(save_dir) / "F1.png")
    plt.close()


def plot_confusion_matrix(save_dir, confmat: np.ndarray, class_names: List[str]) -> None:
    plt = _pyplot()
    import seaborn as sns

    fig = plt.figure(figsize=(20, 18))
    ax = plt.subplot()
    sns.heatmap(confmat, annot=True, ax=ax, fmt=".2%", cmap="Blues")
    ax.set_xlabel("Predicted", fontsize=20)
    ax.xaxis.set_label_position("bottom")
    plt.xticks(rotation=90)
    ax.xaxis.set_ticklabels(class_names, fontsize=15)
    ax.xaxis.tick_bottom()
    ax.set_ylabel("True", fontsize=20)
    ax.yaxis.set_ticklabels(class_names, fontsize=15)
    plt.yticks(rotation=0)
    plt.savefig(Path(save_dir) / "confusion_matrix.png")
    plt.close(fig)


def write_test_artifacts(
    save_dir: str | Path,
    abnormal_scores: np.ndarray,
    labels: np.ndarray,
    class_probs: np.ndarray,
    normal_id: int,
    num_classes: int,
    class_names: List[str],
    epoch: int = 0,
    write_files: bool = True,
) -> Dict:
    """The full test_epoch_end artifact block (anomaly_clip_module.py:500-691).

    ``write_files=False`` computes and returns the identical metrics dict with
    zero filesystem IO (a process other than host zero). Without ``matplotlib``
    or ``seaborn`` only ``metrics.json`` is written, with one warning."""
    save_dir = Path(save_dir)
    if write_files:
        save_dir.mkdir(parents=True, exist_ok=True)

    det = M.detection_metrics(abnormal_scores, labels, class_probs, normal_id, num_classes)
    class_probs_full = det.pop("class_probs_full")
    labels_binary = det.pop("labels_binary")

    y_pred, top1, top5 = M.gated_class_predictions(
        abnormal_scores, class_probs_full, normal_id, det["optimal_threshold"]
    )
    acc1, acc5 = M.per_class_topk_accuracy(top1, top5, labels, num_classes)

    metrics = {
        "epoch": epoch,
        **{k: det[k] for k in ("auc_roc", "auc_pr", "mean_mc_auroc", "mean_mc_aupr")},
        "mc_auroc": det["mc_auroc"],
        "mc_aupr": det["mc_aupr"],
        "top1_accuracy": np.nan_to_num(acc1).tolist(),
        "top5_accuracy": np.nan_to_num(acc5).tolist(),
        "optimal_threshold": det["optimal_threshold"],
    }
    if not write_files:
        return metrics
    write_metrics_json(save_dir, metrics, epoch=None)

    try:
        _pyplot()
        import seaborn  # noqa: F401
    except ImportError as exc:
        log.warning(f"test artifacts: {', '.join(PLOTS)} not written ({exc}); metrics.json only")
        return metrics

    fpr, tpr, _ = M.roc_curve(abnormal_scores, labels_binary)
    precision, recall, _ = M.precision_recall_curve(abnormal_scores, labels_binary)
    f1_scores = M.f1_threshold_sweep(abnormal_scores, labels_binary)
    confmat = M.confusion_matrix_normalized(y_pred, labels, num_classes)

    plot_pr_curve(save_dir, recall, precision, metrics["auc_pr"])
    plot_roc_curve(save_dir, fpr, tpr, metrics["auc_roc"])
    plot_f1_sweep(save_dir, f1_scores)
    plot_confusion_matrix(save_dir, confmat, class_names)
    return metrics
