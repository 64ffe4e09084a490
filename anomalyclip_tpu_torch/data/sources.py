"""Per-video array sources: pre-extracted CLIP features (.npy) or raw JPEG frames.
A copy of anomalyclip_tpu/data/sources.py; cv2 and PIL are imported inside the
functions that decode.

Feature source (reference: src/data/components/feature_dataset.py:326-349): one
``<video>.npy`` per video, reshaped to (T, ncrops, D).

Frame source (reference: src/data/components/video_dataset.py:203-206, 330-343 +
src/utils/augmentations.py:21-34): ``{:06d}.jpg`` files per video directory, CLIP
preprocessing = bicubic resize (short side) -> center crop, emitted as NHWC
uint8 (the encoders' layout; the reference's NCHW is a torch convention). The
[0,1]-scale + mean/std normalization happens ON DEVICE inside every encoder
(models/clip/model.py:normalize_frames_on_device, identical fp32 arithmetic to
``normalize_frames`` below), so host RAM and host->device transfer carry 1/4
the float32 bytes — on the 1-crop AND the 10-crop path alike (the group
transform pipeline runs spatial-only for ingest, transforms.py:
get_augmentations(normalize=False)).
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np

from anomalyclip_tpu_torch.data.records import VideoRecord

# single source for the CLIP normalization constants and the subtle resize/crop
# geometry (torchvision long-side truncation, banker's-rounding crop placement):
# data/transforms.py — re-exported here for the preprocess helpers' callers
from anomalyclip_tpu_torch.data.transforms import (  # noqa: F401 (re-export)
    CLIP_MEAN,
    CLIP_STD,
    _center_offset,
    _short_side_size,
)


class FeatureSource:
    """Loads (T, ncrops, D) feature arrays; sampling indexes rows by frame."""

    def __init__(self, ncrops: int = 1):
        self.ncrops = ncrops

    def load_video(self, record: VideoRecord) -> np.ndarray:
        feats = np.load(record.feature_path, allow_pickle=True)
        feats = np.asarray(feats, dtype=np.float32)
        return feats.reshape(-1, self.ncrops, feats.shape[-1])

    def num_frames(self, video: np.ndarray) -> int:
        return video.shape[0]

    def gather(self, video: np.ndarray, frame_indices: np.ndarray, pool=None) -> np.ndarray:
        """-> (ncrops, len(frame_indices), D). ``pool`` accepted for signature
        uniformity with FrameSource.gather; a numpy fancy-index needs none."""
        return video[frame_indices].transpose(1, 0, 2)


def spatial_frame(img, input_size: int = 224) -> np.ndarray:
    """Resize + center-crop one PIL image -> (input_size, input_size, 3) uint8 RGB
    (the spatial half of CLIP preprocessing; combine with normalize_frames).
    Geometry (short-side bicubic resize with long-side truncation, banker's
    center-crop placement) comes from transforms.py's helpers."""
    from PIL import Image

    w, h = img.size
    new_h, new_w = _short_side_size(h, w, input_size)
    img = img.resize((new_w, new_h), Image.BICUBIC)
    left = _center_offset(new_w - input_size)
    top = _center_offset(new_h - input_size)
    img = img.crop((left, top, left + input_size, top + input_size))
    return np.asarray(img.convert("RGB"), dtype=np.uint8)


def normalize_frames(arr: np.ndarray) -> np.ndarray:
    """uint8 RGB frames (..., H, W, 3) -> float32 CLIP-normalized. Exactly the
    arithmetic of preprocess_frame, so uint8-stored frames score bit-identically."""
    return (arr.astype(np.float32) / 255.0 - CLIP_MEAN) / CLIP_STD


def preprocess_frame(img, input_size: int = 224) -> np.ndarray:
    """CLIP preprocessing for one PIL image -> (H, W, 3) float32 NHWC."""
    return normalize_frames(spatial_frame(img, input_size))


def spatial_frame_cv2(path: str, input_size: int = 224) -> np.ndarray:
    """cv2 decode + spatial preprocessing -> (input_size, input_size, 3) uint8
    RGB: ~3-4x faster than PIL and releases the GIL during decode/resize, so the
    loader's worker threads scale. INTER_AREA downscaling approximates PIL's
    antialiased bicubic; enable with ``data.fast_decode=True`` when throughput
    matters more than bit-exact preprocessing parity."""
    import cv2

    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(path)
    h, w = img.shape[:2]
    new_h, new_w = _short_side_size(h, w, input_size)
    interp = cv2.INTER_AREA if new_w < w else cv2.INTER_CUBIC
    img = cv2.resize(img, (new_w, new_h), interpolation=interp)
    top = _center_offset(new_h - input_size)
    left = _center_offset(new_w - input_size)
    img = img[top : top + input_size, left : left + input_size]
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def preprocess_frame_cv2(path: str, input_size: int = 224) -> np.ndarray:
    """cv2 decode + full CLIP preprocessing -> (H, W, 3) float32 (see
    spatial_frame_cv2 for the fast-decode geometry)."""
    return normalize_frames(spatial_frame_cv2(path, input_size))


class FrameSource:
    """Loads and preprocesses JPEG frames on demand.

    ``gather`` receives *frame indices within the record* (0-based, modulo-wrapped)
    and maps them to file ids by adding ``record.start_frame``
    (video_dataset.py:337-339).

    ``ncrops=10`` enables 10-crop evaluation via GroupOverSample
    (data/transforms.py; reference: gtransforms.py:105-138) — the multicrop
    frames path the reference accepts as an argument but never wires up
    (src/utils/augmentations.py:21 ignores ``ncrops``). Crops fold into the
    device batch axis; eval/evaluator.py consumes the (ncrops, T, ...) layout
    natively. ncrops>1 is an eval-path feature, matching the reference's
    feature-path convention (its train forward squeezes the crop axis and
    cannot carry more than one crop: src/models/components/anomaly_clip.py:178).
    """

    def __init__(
        self,
        input_size: int = 224,
        image_tmpl: str = "{:06d}.jpg",
        ncrops: int = 1,
        fast_decode: bool = False,
    ):
        self.input_size = input_size
        self.image_tmpl = image_tmpl
        if ncrops not in (1, 10):
            raise ValueError(f"FrameSource supports ncrops in (1, 10), got {ncrops}")
        self.ncrops = ncrops
        if ncrops != 1:
            from anomalyclip_tpu_torch.data.transforms import get_augmentations

            # spatial-only: crops stay uint8 and are normalized ON DEVICE like
            # every other path (the 10-crop path ships 10x the frames per
            # video, so the 4x byte saving matters most here)
            self._multicrop = get_augmentations(input_size, ncrops, normalize=False)
        self.fast_decode = fast_decode

    def load_video(self, record: VideoRecord) -> VideoRecord:
        # frames are loaded lazily per index; the "video" handle is the record
        return record

    def num_frames(self, video: VideoRecord) -> int:
        return video.num_frames

    def _load_one(self, record: VideoRecord, file_idx: int) -> np.ndarray:
        """One spatially-preprocessed frame, kept uint8: normalization happens
        ON DEVICE inside every encoder (normalize_frames_on_device — identical
        fp32 arithmetic), so the loader holds and ships 1/4 the bytes."""
        path = os.path.join(record.frames_dir, self.image_tmpl.format(file_idx))
        if self.fast_decode:
            return spatial_frame_cv2(path, self.input_size)
        from PIL import Image

        with Image.open(path) as img:
            return spatial_frame(img, self.input_size)

    def _load_raw(self, record: VideoRecord, file_idx: int) -> np.ndarray:
        """Undecorated uint8 RGB frame (multicrop path decodes once, then the
        group pipeline scales/crops/normalizes the whole clip)."""
        path = os.path.join(record.frames_dir, self.image_tmpl.format(file_idx))
        if self.fast_decode:
            import cv2

            img = cv2.imread(path, cv2.IMREAD_COLOR)
            if img is None:
                raise FileNotFoundError(path)
            return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        from PIL import Image

        with Image.open(path) as img:
            return np.asarray(img.convert("RGB"))

    def gather(self, video: VideoRecord, frame_indices: np.ndarray, pool=None) -> np.ndarray:
        """-> (ncrops, len(frame_indices), H, W, 3). ``pool``: an optional
        concurrent.futures Executor to parallelize per-frame decodes (cv2/PIL
        release the GIL during decode, so threads scale with cores)."""
        ids = [int(i) + video.start_frame for i in frame_indices]
        run = pool.map if pool is not None else map
        if self.ncrops == 1:
            return np.stack(list(run(lambda i: self._load_one(video, i), ids)))[None]
        clip = np.stack(list(run(lambda i: self._load_raw(video, i), ids)))
        return self._multicrop(clip)  # uint8: normalization happens on device


def count_frames(frames_dir: str | Path, image_tmpl: str = "{:06d}.jpg") -> int:
    """Consecutive 1-based frame files under a directory (the reference's frame
    id convention, video_dataset.py:203-206)."""
    from pathlib import Path

    d = Path(frames_dir)
    n = 0
    while (d / image_tmpl.format(n + 1)).is_file():
        n += 1
    return n
