"""The port's metrics (anomalyclip_tpu_torch/eval/metrics.py) against the JAX
package's (anomalyclip_tpu/eval/metrics.py), on the CPU: every function on the
same seeded scores, random and with ties, to the bit (nan where the original
gives nan); ``detection_metrics`` against ``tests/golden/metrics.npz`` at the
tolerance of ``tests/test_golden.py``; nan AUC and AP on single-class labels."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest

from anomalyclip_tpu.eval import metrics as jm
from anomalyclip_tpu_torch.eval import metrics as tm

GOLDEN = Path(__file__).resolve().parent / "golden"
NUM_CLASSES, NORMAL_ID = 6, 2


def _data(kind: str, seed: int = 0):
    """-> (scores, labels, class_probs (T, C-1)): ``tied`` rounds the scores to
    a tenth, so most thresholds carry ties."""
    rng = np.random.default_rng(seed)
    t = 500
    labels = rng.integers(0, NUM_CLASSES, size=t)
    scores = np.clip(np.where(labels != NORMAL_ID, 0.6, 0.35) + rng.normal(0, 0.2, t), 0, 1)
    class_probs = rng.random((t, NUM_CLASSES - 1)) * scores[:, None]
    if kind == "tied":
        scores = np.round(scores, 1)
        class_probs = np.round(class_probs, 1)
    return scores, labels, class_probs


def _same(got, want):
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        assert np.asarray(got).dtype == np.asarray(want).dtype


def _calls(scores, labels, class_probs):
    binary = (labels != NORMAL_ID).astype(np.int64)
    full = np.concatenate(
        [class_probs[:, :NORMAL_ID], (1 - scores)[:, None], class_probs[:, NORMAL_ID:]], axis=1
    )
    threshold = 0.5
    return {
        "roc_curve": (scores, binary),
        "auroc": (scores, binary),
        "precision_recall_curve": (scores, binary),
        "average_precision": (scores, binary),
        "per_class_auroc": (full, labels, NUM_CLASSES),
        "per_class_ap": (full, labels, NUM_CLASSES),
        "mean_excluding_normal": (jm.per_class_auroc(full, labels, NUM_CLASSES), NORMAL_ID),
        "optimal_roc_threshold": (scores, binary),
        "binary_f1": ((scores >= threshold).astype(np.int64), binary),
        "f1_threshold_sweep": (scores, binary),
        "confusion_matrix_normalized": (np.argmax(full, axis=1), labels, NUM_CLASSES),
        "gated_class_predictions": (scores, full, NORMAL_ID, threshold),
        "per_class_topk_accuracy": (
            *jm.gated_class_predictions(scores, full, NORMAL_ID, threshold)[1:], labels, NUM_CLASSES
        ),
        "detection_metrics": (scores, labels, class_probs, NORMAL_ID, NUM_CLASSES),
    }


FUNCTIONS = tuple(_calls(*_data("random")))


@pytest.mark.parametrize("kind", ["random", "tied"])
@pytest.mark.parametrize("name", FUNCTIONS)
def test_each_function_equals_the_original(name, kind):
    args = _calls(*_data(kind))[name]
    _same(getattr(tm, name)(*args), getattr(jm, name)(*args))


def test_detection_metrics_match_golden():
    with np.load(GOLDEN / "metrics.npz") as d:
        d = {k: d[k] for k in d.files}
    det = tm.detection_metrics(
        d["scores"], d["labels"], d["class_probs"], int(d["normal_id"]), int(d["num_classes"])
    )
    got = np.asarray([det["auc_roc"], det["auc_pr"], det["mean_mc_auroc"],
                      det["mean_mc_aupr"], det["optimal_threshold"]])
    np.testing.assert_allclose(got, d["expected"], rtol=0, atol=1e-9)
    np.testing.assert_allclose(det["mc_auroc"], d["mc_auroc"], atol=1e-9)
    np.testing.assert_allclose(det["mc_aupr"], d["mc_aupr"], atol=1e-9)


def test_roc_thresholds_keep_the_originals_sentinel():
    """The leading threshold is max + 1 (the original's convention, not
    sklearn's inf)."""
    scores, labels, _ = _data("tied")
    _, _, thresholds = tm.roc_curve(scores, (labels != NORMAL_ID).astype(np.int64))
    assert thresholds[0] == scores.max() + 1.0
    assert np.all(np.diff(thresholds) < 0)


@pytest.mark.parametrize("label", [0, 1])
def test_single_class_labels_give_nan(label):
    scores = np.linspace(0, 1, 16)
    labels = np.full(16, label, dtype=np.int64)
    assert np.isnan(tm.auroc(scores, labels))
    if label == 0:
        assert np.isnan(tm.average_precision(scores, labels))
    # a test set of one class: detection AUC and AP nan, as the original's
    frame_labels = np.full(16, NORMAL_ID if label == 0 else 4)
    probs = np.random.default_rng(1).random((16, NUM_CLASSES - 1))
    det = tm.detection_metrics(scores, frame_labels, probs, NORMAL_ID, NUM_CLASSES)
    assert np.isnan(det["auc_roc"])
    _same(det, jm.detection_metrics(scores, frame_labels, probs, NORMAL_ID, NUM_CLASSES))
