"""Score one input video: per-frame anomaly scores and class predictions.

The counterpart of ``score_input`` (anomalyclip_tpu/predict.py:242-286), built
from the model and its state instead of the train module and the YAML config:

    predictor = Predictor(model, frozen, trainable, bn_state, ncentroid, device="cuda")
    video_scores, result = predictor.score_frames(frames_u8)  # (ncrops, T, 224, 224, 3)

Decoding video files and frame directories (cv2, PIL) is not ported yet: the
predictor takes frames already decoded and CLIP-preprocessed to uint8.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from anomalyclip_tpu_torch.data.dataset import TestItem
from anomalyclip_tpu_torch.data.sampling import gather_frame_indices, test_start_indices
from anomalyclip_tpu_torch.eval.evaluator import GridScorer, VideoScores, score_video
from anomalyclip_tpu_torch.models.anomaly_clip import AnomalyCLIP
from anomalyclip_tpu_torch.models.selector import BNState


class Predictor:
    """A model with its state on one device, scoring whole videos."""

    def __init__(
        self,
        model: AnomalyCLIP,
        frozen,
        trainable,
        bn_state: BNState,
        ncentroid,
        device="cuda",
    ):
        self.model = model
        self.scorer = GridScorer(model, frozen, trainable, bn_state, ncentroid, device=device)

    def score_frames(self, raw: np.ndarray) -> Tuple[VideoScores, dict]:
        """Score (ncrops, T_raw, H, W, 3) uint8 frames (or (ncrops, T_raw, D)
        features) -> (VideoScores, predictions dict with score_input's keys;
        ``input``, the file score_input read, is None here).

        The video is covered by whole (num_segments x seg_length) grids, the tail
        wrapping around to early frames, and the ground-truth labels are filled
        with normal_id: unlabeled input must not read as anomalous."""
        cfg = self.model.cfg
        t_raw = raw.shape[1]
        starts, segment_size = test_start_indices(
            t_raw, cfg.num_segments, cfg.seg_length, cfg.stride
        )
        indices = gather_frame_indices(starts, cfg.seg_length, cfg.stride, t_raw)
        normal_fill = int(cfg.normal_id)
        item = TestItem(
            features=raw[:, indices],
            frame_labels=np.full(t_raw, normal_fill, dtype=np.int64),
            video_label=normal_fill,
            segment_size=segment_size,
            path="",
        )
        vs = score_video(item, self.scorer, self.model)

        abnormal_names = [c for i, c in enumerate(self.model.classnames) if i != normal_fill]
        top_col = vs.class_probs.argmax(axis=1)
        result = {
            "input": None,
            "num_frames": int(t_raw),
            "video_anomaly_score": float(vs.scores.max()),
            "frame_scores": np.round(vs.scores, 6).tolist(),
            "frame_top_class": [abnormal_names[int(c)] for c in top_col],
            "frame_top_class_prob": np.round(vs.class_probs.max(axis=1), 6).tolist(),
            "classnames_abnormal": abnormal_names,
            "class_probs_shape": list(vs.class_probs.shape),
        }
        return vs, result
