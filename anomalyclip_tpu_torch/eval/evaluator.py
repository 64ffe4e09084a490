"""Per-video test-time scoring with grid batching and shape bucketing: the
counterpart of anomalyclip_tpu/eval/evaluator.py (:37-380).

The host lays a video's flat (n, s, l) frame stream out as ``s`` independent
(num_segments x seg_length) grids, pads the grid batch up to a bucket size and
scores it on the device; padded grids are sliced off before the inverse layout.
The numpy halves (bucketing, layout, stride expansion, softmax) and the
chunked encode loop are copies of the JAX package's, in eval/grids.py, which
the exported artifact shares. ``score_grid_batch`` is the
scoring function of a grid batch that ``GridScorer`` runs and export.py
traces. ``evaluate_videos`` scores a whole test loader, the pass of
validation and test; ``eval/metrics.py`` turns its output into AUC and AP.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from anomalyclip_tpu_torch.convert import tree_leaves
from anomalyclip_tpu_torch.data.dataset import TestItem
from anomalyclip_tpu_torch.eval.grids import (
    DEFAULT_BUCKETS,
    encode_frames_chunked,
    pad_to_bucket,
    score_sampled_features,
)
from anomalyclip_tpu_torch.models.anomaly_clip import AnomalyCLIP
from anomalyclip_tpu_torch.models.selector import BNState, selector_test
from anomalyclip_tpu_torch.models.temporal import temporal_scores
from anomalyclip_tpu_torch.numerics import matmul_precision_for

def _require_on(device: torch.device, name: str, tree) -> None:
    """Raise unless every tensor of ``tree`` lies on ``device``, both named."""
    for leaf in tree_leaves(tree):
        if leaf.device.type != device.type or (
            device.index is not None and leaf.device.index != device.index
        ):
            raise ValueError(
                f"GridScorer: device is {device}, but the {name} parameters are on "
                f"{leaf.device}; move them (convert.tree_to) or pass device={str(leaf.device)!r}"
            )


def score_grid_batch(
    model: AnomalyCLIP, text_features, temporal, bn_state: BNState, ncentroid, grids: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The scoring function of a grid batch, given the text features, the
    temporal parameters, the BN state and the ncentroid: grids (G, n, l, D) ->
    (similarity (G*n*l, C-1), scores (G*n*l,)). ``GridScorer`` runs it, and the
    exported score graph is its trace (export.py). It branches on no size, so
    G stays symbolic in a trace."""
    flat = grids.reshape(-1, grids.shape[-1])
    similarity = selector_test(flat, text_features, ncentroid, bn_state, model.selector_cfg)
    features = model._temporal_input(flat, similarity, ncentroid)
    scores = temporal_scores(
        features, temporal, model.temporal_cfg, segment_size=1, test_mode=False
    ).reshape(-1)
    return similarity, scores


class GridScorer:
    """Scores batches of (n, l, D) grids on one device (the card unless the
    caller asks for the CPU). ``update`` swaps in new parameters and computes
    the text features once, from the text tower alone; the constructor calls
    it. The parameters it reads (the text tower, ``trainable``, the BN state)
    must already be on ``device``: a tree on another device raises, with both
    named. The image tower is read, and its device checked, only by
    ``encode_frames_np``, so a scorer of features needs no image tower on the
    device. ``encode`` is the frame encoder (frozen, frames) -> features,
    ``model.encode_frames`` unless the caller hands another (the module's
    int8 serving tower, JAX evaluator.py:141, 207-209). ``score_grids`` runs
    the selector and the temporal model on a bucket-padded grid batch.
    ``encode_calls`` counts the image-tower calls of ``encode_frames_np``, one
    per chunk."""

    def __init__(
        self,
        model: AnomalyCLIP,
        frozen,
        trainable,
        bn_state: BNState,
        ncentroid,
        buckets: Tuple[int, ...] = DEFAULT_BUCKETS,
        device="cuda",
        encode: Optional[Callable[[dict, torch.Tensor], torch.Tensor]] = None,
    ):
        self.model = model
        self.encode = model.encode_frames if encode is None else encode
        self.buckets = buckets
        self.device = torch.device(device)
        self.encode_calls = 0
        self.update(frozen, trainable, bn_state, ncentroid)

    def update(self, frozen, trainable, bn_state: BNState, ncentroid) -> "GridScorer":
        """Swap in new parameters: the text features are computed from the text
        subtree of ``frozen`` and ``trainable``
        (anomalyclip_tpu/eval/evaluator.py:179-202)."""
        text_view = {"clip": {"text": frozen["clip"]["text"]}}
        for name, tree in (("frozen", text_view), ("trainable", trainable),
                           ("bn_state", list(bn_state))):
            _require_on(self.device, name, tree)
        with torch.no_grad():
            self.text_features = self.model.text_features(text_view, trainable)
        self._frozen = frozen
        self._temporal = trainable["temporal"]
        self._bn_state = bn_state
        self._ncentroid = torch.as_tensor(ncentroid, dtype=torch.float32, device=self.device)
        return self

    def _score(self, grids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """grids: (G, n, l, D) -> (similarity (G*n*l, C-1), scores (G*n*l,))"""
        with torch.no_grad(), matmul_precision_for(self.model.cfg.dtype):
            return score_grid_batch(self.model, self.text_features, self._temporal, self._bn_state,
                                    self._ncentroid, grids)

    def encode_frames_np(self, frames: np.ndarray) -> np.ndarray:
        """CLIP-encode raw frames (N, H, W, 3) -> (N, D) in static-shape chunks."""
        _require_on(self.device, "frozen visual", self._frozen["clip"]["visual"])

        def encode(part: torch.Tensor) -> torch.Tensor:
            self.encode_calls += 1
            return self.encode(self._frozen, part)

        return encode_frames_chunked(encode, frames, self.device)

    def score_grids(self, grids: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Pad the grid batch to a bucket, score, trim."""
        grids, g = pad_to_bucket(grids, self.buckets)
        similarity, scores = self._score(torch.from_numpy(grids).to(self.device))
        n_l = grids.shape[1] * grids.shape[2]
        return (
            similarity.cpu().numpy()[: g * n_l],
            scores.cpu().numpy()[: g * n_l],
        )


@dataclasses.dataclass
class VideoScores:
    similarity: np.ndarray  # (T, C-1) frame-rate, trimmed to true length
    scores: np.ndarray  # (T,)
    class_probs: np.ndarray  # (T, C-1) softmax(similarity) * scores
    frame_labels: np.ndarray  # (T,)
    video_label: int
    path: str
    start_frame: int = 0  # file id of score index 0


def score_video(item: TestItem, scorer: GridScorer, model: AnomalyCLIP) -> VideoScores:
    """Score one test video: encode frames if given frames, then the grids."""
    cfg = model.cfg
    feats = item.features  # (ncrops, n*s*l, D) or frames (ncrops, n*s*l, H, W, 3)
    if feats.ndim == 5:
        ncrops, t = feats.shape[:2]
        flat = feats.reshape((-1,) + feats.shape[2:])
        feats = scorer.encode_frames_np(flat).reshape(ncrops, t, -1)

    sim, sc, class_probs = score_sampled_features(
        feats,
        item.segment_size,
        cfg.num_segments,
        cfg.seg_length,
        cfg.stride,
        len(item.frame_labels),
        scorer.score_grids,
    )
    return VideoScores(
        similarity=sim,
        scores=sc,
        class_probs=class_probs,
        frame_labels=np.asarray(item.frame_labels),
        video_label=item.video_label,
        path=item.path,
        start_frame=getattr(item, "start_frame", 0),
    )


def evaluate_videos(
    loader,
    scorer: Optional[GridScorer] = None,
    model: Optional[AnomalyCLIP] = None,
    on_video: Optional[Callable[[VideoScores], None]] = None,
    score_item: Optional[Callable[[TestItem], VideoScores]] = None,
    should_stop: Optional[Callable[[], bool]] = None,
    gather_processes: bool = False,
) -> Dict[str, np.ndarray]:
    """Concatenate per-video outputs over a test loader
    (anomalyclip_tpu/eval/evaluator.py:332-380) -> {"abnormal_scores",
    "labels", "class_probs"}. ``score_item`` replaces ``score_video`` as the
    per-item scorer; ``on_video`` sees every video's scores; ``should_stop`` is
    polled before each video, and a stopped pass returns {} so that partial
    numbers are never reported.

    ``gather_processes=True`` in one process is the whole set, as without it.
    Across processes (``torch.distributed`` initialized with more than one
    rank) the gather of each rank's videos is not ported yet (ROADMAP.md
    section 1, item 8) and raises: one rank's videos are not the whole set."""
    if gather_processes and _world_size() > 1:
        raise NotImplementedError(
            "evaluate_videos(gather_processes=True) across "
            f"{_world_size()} processes: the gather is not ported yet (ROADMAP.md section 1, item 8)"
        )
    if score_item is None:
        score_item = lambda item: score_video(item, scorer, model)  # noqa: E731
    per_video: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
    for item in loader:
        if should_stop is not None and should_stop():
            return {}
        vs = score_item(item)
        if on_video is not None:
            on_video(vs)
        per_video.append((vs.scores, np.asarray(vs.frame_labels), vs.class_probs))
    if not per_video:
        return {}
    return {
        "abnormal_scores": np.concatenate([v[0] for v in per_video]),
        "labels": np.concatenate([v[1] for v in per_video]),
        "class_probs": np.concatenate([v[2] for v in per_video]),
    }


def _world_size() -> int:
    dist = torch.distributed
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
