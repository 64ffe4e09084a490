"""The test-video record the port's predictor and evaluator take: a copy of
``TestItem`` from anomalyclip_tpu/data/dataset.py (:42-56), numpy only."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class TestItem(NamedTuple):
    """One test video (feature_dataset.py:373-376)."""

    # not a pytest class (the name triggers collection otherwise)
    __test__ = False

    features: np.ndarray  # (ncrops, n*s*l, D) or frames (1, n*s*l, H, W, 3)
    frame_labels: np.ndarray  # (T,) per-frame class labels (true length)
    video_label: int
    segment_size: int
    path: str
    # file id of score index 0 (frame files are start_frame-based, commonly 1)
    # — the visualizer needs it to show the right JPEG next to each score
    start_frame: int = 0
