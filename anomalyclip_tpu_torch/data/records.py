"""Video metadata: annotation files, temporal test annotations, frame labels.
A copy of anomalyclip_tpu/data/records.py, numpy only.

Behavioral spec from the reference (reference:
src/data/components/feature_dataset.py:42-121, 226-241, 329-345):

- annotation txt rows: ``REL_PATH START_FRAME END_FRAME LABEL [LABEL...]``
  (extra LABEL columns — the reference's multi-label hook, feature_dataset.py:88-95 —
  are ignored: its own pipeline cannot collate list-valued labels, so the first
  label is the operative one there too)
- temporal test annotation rows: ``VIDEO ... s1 e1 [s2 e2 ...]`` -> per-frame labels
  (frame ``i`` is anomalous iff any [s, e] contains ``i + start_frame``)
- optional spatial bbox annotations per abnormal video (VATIC-style columns),
  parsed but not consumed by the training path (mirrors the reference, where
  VideoRecord.tbox is defined yet unused).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class VideoRecord:
    rel_path: str
    start_frame: int
    end_frame: int  # inclusive
    label: int
    root: str
    spatial_annotation: Optional[Path] = None

    @property
    def num_frames(self) -> int:
        return self.end_frame - self.start_frame + 1

    @property
    def frames_dir(self) -> str:
        import os

        return os.path.join(self.root, self.rel_path)

    @property
    def feature_path(self) -> str:
        return self.frames_dir + ".npy"

    @property
    def stem(self) -> str:
        return Path(self.feature_path).stem


def parse_annotation_file(
    path: str | Path,
    root: str,
    spatial_dir: Optional[str] = None,
) -> List[VideoRecord]:
    records: List[VideoRecord] = []
    with open(path) as f:
        for line in f:
            parts = line.strip().split()
            if not parts:
                continue
            spatial = None
            if spatial_dir:
                # <dir>/<second path component, _x264 stripped>.txt when it exists
                name = parts[0].split("/")[1].replace("_x264", "") if "/" in parts[0] else parts[0]
                cand = Path(spatial_dir, name).with_suffix(".txt")
                spatial = cand if cand.is_file() else None
            records.append(
                VideoRecord(
                    rel_path=parts[0],
                    start_frame=int(parts[1]),
                    end_frame=int(parts[2]),
                    label=int(parts[3]),
                    root=root,
                    spatial_annotation=spatial,
                )
            )
    return records


def parse_temporal_annotations(path: Optional[str | Path]) -> Dict[str, List[int]]:
    """stem -> flat [s1, e1, s2, e2, ...] interval list (feature_dataset.py:232-241;
    columns 0 and 1 of each row are the video name and class name)."""
    if not path or not Path(path).is_file():
        return {}
    annotations: Dict[str, List[int]] = {}
    with open(path) as f:
        for line in f:
            parts = line.strip().split()
            if not parts:
                continue
            annotations[Path(parts[0]).stem] = [int(v) for v in parts[2:]]
    return annotations


def frame_labels_for(
    record: VideoRecord,
    annotations: Dict[str, List[int]],
    num_frames: int,
    normal_id: int,
) -> np.ndarray:
    """Per-frame class labels for a test video (feature_dataset.py:329-345)."""
    labels = np.full(num_frames, normal_id, dtype=np.int64)
    intervals = annotations.get(record.stem, [])
    frame_ids = np.arange(num_frames) + record.start_frame
    for start, end in zip(intervals[::2], intervals[1::2]):
        labels[(frame_ids >= start) & (frame_ids <= end)] = record.label
    return labels


def parse_spatial_annotation(
    path: str | Path, start_frame: int, end_frame: int
) -> np.ndarray:
    """VATIC-style bbox rows -> per-row anomaly presence 1-(lost flag), restricted to
    [start_frame, end_frame] (feature_dataset.py:98-121). Exposed for API parity;
    unused by the training path, as in the reference."""
    rows: List[Tuple[int, int]] = []  # (frame, lost)
    with open(path) as f:
        for line in f:
            parts = line.strip().split()
            if len(parts) < 9:
                continue
            frame, lost = int(parts[5]), int(parts[6])
            if start_frame <= frame <= end_frame:
                rows.append((frame, lost))
    return np.array([1 - lost for _, lost in rows], dtype=np.int64)
