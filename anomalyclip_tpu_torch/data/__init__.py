"""The data layer: a copy of anomalyclip_tpu/data, numpy only."""

from anomalyclip_tpu_torch.data.datamodule import AnomalyCLIPDataModule, DataConfig
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

__all__ = [
    "AnomalyCLIPDataModule",
    "DataConfig",
    "VideoRecord",
    "frame_labels_for",
    "parse_annotation_file",
    "parse_temporal_annotations",
    "gather_frame_indices",
    "test_start_indices",
    "train_start_indices",
]
