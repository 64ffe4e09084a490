"""The training batch the port's train step takes: a copy of ``TrainBatch`` from
anomalyclip_tpu/data/loader.py (:44-48), numpy only."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class TrainBatch(NamedTuple):
    abnormal_features: np.ndarray  # (b/2, n*l, D) or frames
    abnormal_labels: np.ndarray  # (b/2,)
    normal_features: np.ndarray  # (b/2, n*l, D)
    normal_labels: np.ndarray  # (b/2,)
