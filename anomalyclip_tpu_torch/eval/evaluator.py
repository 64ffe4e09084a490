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
import os
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
from anomalyclip_tpu_torch.parallel.mesh import allgather_host, distributed
from anomalyclip_tpu_torch.utils.trace import span

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
    int8 serving tower or the tensor-parallel one, JAX evaluator.py:141,
    207-209). ``score_grids`` runs
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
        """CLIP-encode raw frames (N, H, W, 3) -> (N, D) in static-shape chunks.
        The frozen image tower must be on the scorer's device when the model's
        own encoder reads it; an encoder handed in holds its own tower."""
        if self.encode == self.model.encode_frames:
            _require_on(self.device, "frozen visual", self._frozen["clip"]["visual"])

        def encode(part: torch.Tensor) -> torch.Tensor:
            self.encode_calls += 1
            return self.encode(self._frozen, part)

        return encode_frames_chunked(encode, frames, self.device)

    def score_grids(self, grids: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Pad the grid batch to a bucket, score, trim."""
        grids, g = pad_to_bucket(grids, self.buckets)
        uploaded = torch.from_numpy(grids).to(self.device)
        with span("anomalyclip.model.score"):
            similarity, scores = self._score(uploaded)
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
        with span("anomalyclip.evaluator.encode"):
            ncrops, t = feats.shape[:2]
            flat = feats.reshape((-1,) + feats.shape[2:])
            feats = scorer.encode_frames_np(flat).reshape(ncrops, t, -1)

    with span("anomalyclip.evaluator.grids"):
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
    contribute: bool = True,
) -> Dict[str, np.ndarray]:
    """Concatenate per-video outputs over a test loader
    (anomalyclip_tpu/eval/evaluator.py:332-380) -> {"abnormal_scores",
    "labels", "class_probs"}. ``score_item`` replaces ``score_video`` as the
    per-item scorer; ``on_video`` sees every video's scores; ``should_stop`` is
    polled before each video, and a stopped pass returns {} so that partial
    numbers are never reported.

    ``gather_processes=True`` in a ``torch.distributed`` group: the loader
    yields this rank's stride of the videos (``SequentialTestLoader``'s
    ``shard``, whose ``global_indices`` it must have), and every rank returns
    the whole set in global video order (``gather_outputs``). A rank with
    ``contribute=False`` scores its videos and adds none of them: the ranks of
    a tensor-parallel group after its first score the same videos as it. Outside
    a group it is the whole set, as without it."""
    if score_item is None:
        score_item = lambda item: score_video(item, scorer, model)  # noqa: E731
    gather = gather_processes and distributed()
    indices = list(loader.global_indices()) if gather else None
    per_video: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
    stopped = False
    for item in loader:
        if should_stop is not None and should_stop():
            stopped = True
            break
        vs = score_item(item)
        if on_video is not None:
            on_video(vs)
        per_video.append((vs.scores, np.asarray(vs.frame_labels), vs.class_probs))
    if gather:
        if not contribute:
            per_video, indices = [], []
        return gather_outputs(per_video, indices[: len(per_video)], stopped)
    if stopped or not per_video:
        return {}
    return {
        "abnormal_scores": np.concatenate([v[0] for v in per_video]),
        "labels": np.concatenate([v[1] for v in per_video]),
        "class_probs": np.concatenate([v[2] for v in per_video]),
    }


# frames each rank contributes to one gather round: the payload of a round is
# P x GATHER_CHUNK_FRAMES x (C+2) float32 however long or skewed the shards
# are (JAX evaluator.py:383-387); ANOMALYCLIP_GATHER_CHUNK overrides it, and the
# ranks take the smallest value any of them has
GATHER_CHUNK_FRAMES = 16384


def gather_outputs(
    per_video: List[Tuple[np.ndarray, np.ndarray, np.ndarray]],
    indices: List[int],
    stopped: bool,
) -> Dict[str, np.ndarray]:
    """Every rank's per-video (scores, labels, class_probs) -> the whole set in
    global video order, on every rank (JAX evaluator.py:390-470). Ranks own
    different numbers and lengths of videos, so: (1) the stop flags, video and
    frame counts, class count and chunk size are gathered, and one stopped
    rank makes every rank return {}; (2) the (global index, length) tables;
    (3) each rank's outputs packed into (frames, C+2) float32 rows
    ``[score | label | class_probs]``, gathered in rounds of the ranks' smallest
    chunk size, a rank past its end sending zeros; (4) each rank's videos cut
    back out by its table and put in index order. Labels are small class ids,
    exact in float32, and come back as int64. The gathers move host tensors
    (``mesh.allgather_host``)."""
    local_chunk = int(os.environ.get("ANOMALYCLIP_GATHER_CHUNK", GATHER_CHUNK_FRAMES))
    local_frames = int(sum(len(v[0]) for v in per_video))
    local_c = int(per_video[0][2].shape[1]) if per_video else 0
    meta = allgather_host(np.array([int(stopped), len(per_video), local_frames, local_c, local_chunk], np.int64))
    if bool(meta[:, 0].any()) or int(meta[:, 1].sum()) == 0:
        return {}
    max_videos, max_frames = int(meta[:, 1].max()), int(meta[:, 2].max())
    cols, chunk = int(meta[:, 3].max()) + 2, max(1, int(meta[:, 4].min()))

    table = np.full((max_videos, 2), -1, np.int64)  # (global index, length)
    pack = np.zeros((local_frames, cols), np.float32)
    off = 0
    for k, (sc, lab, pr) in enumerate(per_video):
        table[k] = (indices[k], len(sc))
        pack[off : off + len(sc), 0] = sc
        pack[off : off + len(sc), 1] = lab
        pack[off : off + len(sc), 2:] = pr
        off += len(sc)
    tables = allgather_host(table)  # (P, max_videos, 2)
    frames_of = meta[:, 2]
    packs = [np.empty((int(f), cols), np.float32) for f in frames_of]
    for lo in range(0, max_frames, chunk):
        part = np.zeros((chunk, cols), np.float32)
        mine = pack[lo : lo + chunk]
        part[: len(mine)] = mine
        rounds = allgather_host(part)  # (P, chunk, cols)
        for p, frames in enumerate(frames_of):
            valid = int(min(max(int(frames) - lo, 0), chunk))
            packs[p][lo : lo + valid] = rounds[p, :valid]

    by_index: Dict[int, np.ndarray] = {}
    for p, rows in enumerate(tables):
        off = 0
        for gi, length in rows:
            if gi < 0:
                break
            by_index[int(gi)] = packs[p][off : off + int(length)]
            off += int(length)
    order = sorted(by_index)
    return {
        "abnormal_scores": np.concatenate([by_index[i][:, 0] for i in order]),
        "labels": np.concatenate([by_index[i][:, 1] for i in order]).astype(np.int64),
        "class_probs": np.concatenate([by_index[i][:, 2:] for i in order]),
    }
