"""The data module: builds the four datasets and their loaders from a data config.
A copy of anomalyclip_tpu/data/datamodule.py, numpy only.

Mirror of the reference AnomalyCLIPDataModule (reference:
src/data/anomaly_clip_datamodule.py:12-209): train-normal, train-abnormal (with
optional spatial annotations), test, and train-normal-in-test-mode (for the
ncentroid bootstrap pass).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Union

from anomalyclip_tpu_torch.data.dataset import SamplingConfig, VideoDataset
from anomalyclip_tpu_torch.data.loader import DualStreamTrainLoader, SequentialTestLoader
from anomalyclip_tpu_torch.data.sources import FeatureSource, FrameSource


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Keys match configs/data/*.yaml (same names as the reference's yaml)."""

    annotation_file_normal: str
    annotation_file_anomaly: str
    annotation_file_test: str
    annotation_file_temporal_test: Optional[str]
    frames_root: str
    labels_file: str
    normal_id: int
    num_classes: int
    num_segments: int = 32
    seg_length: int = 16
    batch_size: int = 64
    batch_size_test: int = 1
    num_workers: int = 8
    input_size: int = 224
    load_from_features: bool = True
    image_tmpl: str = "{:06d}.jpg"
    stride: int = 1
    ncrops: int = 1
    spatialannotationdir_path: Optional[str] = None
    visualize: bool = False
    # 1 = reference parity (every frame rendered, src/utils/visualizer.py:222-256);
    # >1 renders every k-th frame as a speed knob (each frame is a matplotlib figure)
    visualize_frame_step: int = 1
    fast_decode: bool = False  # cv2 JPEG decode (faster, near-parity preprocessing)

    @staticmethod
    def from_dict(cfg: Dict[str, Any]) -> "DataConfig":
        fields = {f.name for f in dataclasses.fields(DataConfig)}
        return DataConfig(**{k: v for k, v in cfg.items() if k in fields})


class AnomalyCLIPDataModule:
    def __init__(self, cfg: DataConfig, seed: int = 0):
        self.cfg = cfg
        self.seed = seed
        self._setup_done = False

    def _source(self) -> Union[FeatureSource, FrameSource]:
        if self.cfg.load_from_features:
            return FeatureSource(ncrops=self.cfg.ncrops)
        return FrameSource(
            input_size=self.cfg.input_size,
            image_tmpl=self.cfg.image_tmpl,
            ncrops=self.cfg.ncrops,
            fast_decode=self.cfg.fast_decode,
        )

    def setup(self) -> None:
        if self._setup_done:
            return
        cfg = self.cfg
        sampling = SamplingConfig(
            num_segments=cfg.num_segments,
            frames_per_segment=cfg.seg_length,
            stride=cfg.stride,
        )

        def make(annotation_file, test_mode=False, temporal=None, spatial=None):
            return VideoDataset(
                annotation_file=annotation_file,
                root=cfg.frames_root,
                normal_id=cfg.normal_id,
                sampling=sampling,
                source=self._source(),
                test_mode=test_mode,
                temporal_annotation_file=temporal,
                spatial_dir=spatial,
            )

        self.train_data_normal = make(cfg.annotation_file_normal)
        self.train_data_anomaly = make(
            cfg.annotation_file_anomaly, spatial=cfg.spatialannotationdir_path
        )
        self.test_data = make(
            cfg.annotation_file_test,
            test_mode=True,
            temporal=cfg.annotation_file_temporal_test,
        )
        self.train_data_normal_test_mode = make(cfg.annotation_file_normal, test_mode=True)
        self._setup_done = True

    @property
    def num_classes(self) -> int:
        return self.cfg.num_classes

    def train_dataloader(self, shard: tuple = (0, 1)) -> DualStreamTrainLoader:
        """``shard=(process_index, process_count)``: per-rank batch-block
        loading for multi-host training (see DualStreamTrainLoader); the
        caller passes its rank and world size so this module stays
        backend-free."""
        self.setup()
        return DualStreamTrainLoader(
            normal=self.train_data_normal,
            abnormal=self.train_data_anomaly,
            batch_size=self.cfg.batch_size,
            seed=self.seed,
            num_workers=self.cfg.num_workers,
            process_index=shard[0],
            process_count=shard[1],
        )

    def val_dataloader(
        self, limit: Optional[int] = None, shard: tuple = (0, 1)
    ) -> SequentialTestLoader:
        self.setup()
        return SequentialTestLoader(self.test_data, limit=limit, shard=shard)

    def test_dataloader(
        self, limit: Optional[int] = None, shard: tuple = (0, 1)
    ) -> SequentialTestLoader:
        self.setup()
        return SequentialTestLoader(self.test_data, limit=limit, shard=shard)

    def train_dataloader_test_mode(
        self, limit: Optional[int] = None, shard: tuple = (0, 1)
    ) -> SequentialTestLoader:
        """Normal-training videos in test (covering) mode, for the ncentroid
        bootstrap (anomaly_clip_module.py:146, datamodule :185-193)."""
        self.setup()
        return SequentialTestLoader(
            self.train_data_normal_test_mode, limit=limit, shard=shard
        )
