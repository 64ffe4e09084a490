"""Video datasets: TSN-sampled training items and covering test items.
A copy of anomalyclip_tpu/data/dataset.py, numpy only.

One dataset class serves both the feature path and the raw-frames path through a
pluggable source (reference keeps two near-identical 380-line classes,
feature_dataset.py / video_dataset.py; here the sampling logic is shared and only
array access differs).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Union

import numpy as np

from anomalyclip_tpu_torch.data.records import (
    VideoRecord,
    frame_labels_for,
    parse_annotation_file,
    parse_temporal_annotations,
)
from anomalyclip_tpu_torch.data.sampling import (
    gather_frame_indices,
    test_start_indices,
    train_start_indices,
)
from anomalyclip_tpu_torch.data.sources import FeatureSource, FrameSource

_DECODE_POOL = None


def _shared_decode_pool():
    global _DECODE_POOL
    if _DECODE_POOL is None:
        import os
        from concurrent.futures import ThreadPoolExecutor

        _DECODE_POOL = ThreadPoolExecutor(max_workers=min(32, os.cpu_count() or 1))
    return _DECODE_POOL


class TestItem(NamedTuple):
    """One test video (feature_dataset.py:373-376)."""

    # not a pytest class (the name triggers collection otherwise)
    __test__ = False

    features: np.ndarray  # (ncrops, n*s*l, D) or frames (1, n*s*l, H, W, 3)
    frame_labels: np.ndarray  # (T,) per-frame class labels (true length)
    video_label: int
    segment_size: int
    path: str
    # file id of score index 0 (frame files are start_frame-based, commonly 1;
    # records.py / sources.py:189) — the visualizer needs it to show the right
    # JPEG next to each score
    start_frame: int = 0


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    num_segments: int = 32
    frames_per_segment: int = 16
    stride: int = 1


class VideoDataset:
    def __init__(
        self,
        annotation_file: str,
        root: str,
        normal_id: int,
        sampling: SamplingConfig,
        source: Union[FeatureSource, FrameSource],
        test_mode: bool = False,
        temporal_annotation_file: Optional[str] = None,
        spatial_dir: Optional[str] = None,
    ):
        self.records: List[VideoRecord] = parse_annotation_file(
            annotation_file, root, spatial_dir
        )
        self.normal_id = normal_id
        self.sampling = sampling
        self.source = source
        self.test_mode = test_mode
        self.temporal_annotations: Dict[str, List[int]] = (
            parse_temporal_annotations(temporal_annotation_file) if test_mode else {}
        )
    def _test_pool(self):
        """Shared decode pool for the frames path: a test video is thousands of
        JPEG decodes in one test_item call, and the test loader's prefetch only
        pipelines whole items — without this the eval decodes serially while
        predict/extract_features scale with cores. The pool is process-global
        (one per process, lazily created) so multirun / hparams-search processes
        that build many datamodules never accumulate idle per-dataset pools."""
        if not isinstance(self.source, FrameSource):
            return None
        return _shared_decode_pool()

    def __len__(self) -> int:
        return len(self.records)

    def train_item(self, idx: int, rng: np.random.Generator):
        """-> (features (ncrops, n*l, D) | frames, video_label)"""
        record = self.records[idx]
        video = self.source.load_video(record)
        starts = train_start_indices(
            record.num_frames,
            self.sampling.num_segments,
            self.sampling.frames_per_segment,
            self.sampling.stride,
            rng,
        )
        indices = gather_frame_indices(
            starts,
            self.sampling.frames_per_segment,
            self.sampling.stride,
            self.source.num_frames(video),
        )
        return self.source.gather(video, indices), record.label

    def test_item(self, idx: int) -> TestItem:
        record = self.records[idx]
        video = self.source.load_video(record)
        starts, segment_size = test_start_indices(
            record.num_frames,
            self.sampling.num_segments,
            self.sampling.frames_per_segment,
            self.sampling.stride,
        )
        indices = gather_frame_indices(
            starts,
            self.sampling.frames_per_segment,
            self.sampling.stride,
            self.source.num_frames(video),
        )
        labels = frame_labels_for(
            record, self.temporal_annotations, self.source.num_frames(video), self.normal_id
        )
        return TestItem(
            features=self.source.gather(video, indices, pool=self._test_pool()),
            frame_labels=labels,
            video_label=record.label,
            segment_size=segment_size,
            path=record.feature_path,
            start_frame=record.start_frame,
        )
