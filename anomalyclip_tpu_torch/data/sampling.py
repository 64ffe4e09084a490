"""TSN-style test-time temporal sampling, vectorized in numpy: a copy of what the
port uses of anomalyclip_tpu/data/sampling.py (:27-28, 49-73).

The video length is rounded UP to a multiple of
``num_segments * frames_per_segment * stride``; chunk starts tile the padded
length every ``frames_per_segment * stride`` frames, giving
``num_segments * segment_size`` chunks. Out-of-range frames wrap modulo T (the
padding frames are real early-video frames; the evaluator trims scores back to
the true length).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np


def round_up_to_multiple(value: int, multiple: int) -> int:
    return int(math.ceil(value / multiple) * multiple)


def test_start_indices(
    num_frames: int,
    num_segments: int,
    frames_per_segment: int,
    stride: int,
) -> Tuple[np.ndarray, int]:
    """Deterministic covering chunk starts and the resulting segment_size
    (feature_dataset.py:252-259, 373-376)."""
    chunk = frames_per_segment * stride
    padded = round_up_to_multiple(num_frames, num_segments * chunk)
    starts = np.arange(padded // chunk) * chunk
    segment_size = len(starts) // num_segments
    return starts, segment_size


def gather_frame_indices(
    start_indices: np.ndarray,
    frames_per_segment: int,
    stride: int,
    modulo: int,
) -> np.ndarray:
    """Expand chunk starts to flat frame indices with wrap-around
    (feature_dataset.py:359-364): index = (start + i*stride) % modulo."""
    offsets = np.arange(frames_per_segment) * stride
    return ((start_indices[:, None] + offsets[None, :]) % modulo).reshape(-1)
