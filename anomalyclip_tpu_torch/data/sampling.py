"""TSN-style temporal sampling, vectorized in numpy: a copy of
anomalyclip_tpu/data/sampling.py, numpy only. The same ``rng`` makes the same
draws in the same order, so the same seed gives the same frames.

Behavioral spec (reference: src/data/components/feature_dataset.py:17-27, 243-278,
359-364):

Training: the video is divided into ``num_segments`` strides of
``distance_between_indices`` frames; each segment contributes ``frames_per_segment``
consecutive (stride-spaced) frames from a uniformly random start within the
segment. Short videos use the lower-bound distance and wrap modulo T.

Test: the video length is rounded UP to a multiple of
``num_segments * frames_per_segment * stride``; chunk starts tile the padded
length every ``frames_per_segment * stride`` frames, giving
``num_segments * segment_size`` chunks. Out-of-range frames wrap modulo T (the
padding frames are real early-video frames; the evaluator trims scores back to the
true length, anomaly_clip_module.py:479-483).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np


def round_up_to_multiple(value: int, multiple: int) -> int:
    return int(math.ceil(value / multiple) * multiple)


def train_start_indices(
    num_frames: int,
    num_segments: int,
    frames_per_segment: int,
    stride: int,
    rng: np.random.Generator,
) -> np.ndarray:
    """Random per-segment start frames (feature_dataset.py:260-277)."""
    lower_bound = num_segments * frames_per_segment * stride
    if num_frames >= lower_bound:
        distance = (num_frames - frames_per_segment + 1) // num_segments
    else:
        distance = (lower_bound - frames_per_segment + 1) // num_segments
    jitter_range = distance + 1 - frames_per_segment + 1  # exclusive upper bound
    jitter = rng.integers(0, max(jitter_range, 1), size=num_segments)
    return np.arange(num_segments) * distance + jitter


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


def process_feat(feat: np.ndarray, length: int) -> np.ndarray:
    """Mean-pooling feature resampler to a fixed ``length``
    (feature_dataset.py:30-39): split the frame axis into ``length``
    near-equal ranges and average each (ranges can be empty when
    len(feat) < length, in which case the boundary frame is copied).
    Vectorized with np.add.reduceat instead of the reference's Python loop."""
    t = len(feat)
    r = np.linspace(0, t, length + 1, dtype=np.int64)
    counts = r[1:] - r[:-1]
    out = np.empty((length, feat.shape[1]), dtype=np.float32)
    nonempty = counts > 0
    if nonempty.any():
        # reduceat over only the nonempty starts: zero-width ranges between two
        # nonempty ones collapse, so each selected segment sums exactly
        # feat[r[i] : r[i] + counts[i]]
        sums = np.add.reduceat(feat.astype(np.float32), r[:-1][nonempty], axis=0)
        out[nonempty] = sums / counts[nonempty][:, None]
    out[~nonempty] = feat[np.minimum(r[:-1][~nonempty], t - 1)]
    return out
