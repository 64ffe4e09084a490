"""The numpy half of per-video scoring: bucket padding of a grid batch and the
grid layout, crop consensus, stride expansion and softmax around a grid
scorer. Copies of the JAX package's (anomalyclip_tpu/eval/evaluator.py:37-60,
285-330), shared by ``GridScorer`` (eval/evaluator.py) and the exported
``ServingArtifact`` (export.py), which loads without the model's modules.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from anomalyclip_tpu_torch.data.sources import normalize_frames
from anomalyclip_tpu_torch.utils.trace import span

DEFAULT_BUCKETS = (1, 2, 4, 8, 16, 32, 64)

# frames per image-encoder call, the one definition (AnomalyCLIP.ENCODE_CHUNK reads
# it), so that every encoder call sees one static shape
ENCODE_CHUNK = 256


def bucket_size(g: int, buckets: Tuple[int, ...]) -> int:
    for b in buckets:
        if g <= b:
            return b
    top = buckets[-1]
    return ((g + top - 1) // top) * top


def pad_to_bucket(
    grids: np.ndarray, buckets: Tuple[int, ...] = DEFAULT_BUCKETS
) -> Tuple[np.ndarray, int]:
    """Zero-pad the grid batch up to its bucket size -> (padded grids, true g)."""
    g = grids.shape[0]
    gb = bucket_size(g, buckets)
    if gb != g:
        pad = np.zeros((gb - g,) + grids.shape[1:], dtype=grids.dtype)
        grids = np.concatenate([grids, pad], axis=0)
    return grids, g


def score_sampled_features(
    feats: np.ndarray,
    segment_size: int,
    num_segments: int,
    seg_length: int,
    stride: int,
    num_labels: int,
    score_grids: Callable[[np.ndarray], Tuple[np.ndarray, np.ndarray]],
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-side half of per-video scoring: grid layout, crop consensus, stride
    expansion, trim, softmax. ``feats`` is (ncrops, n*s*l, D). Returns
    (similarity (T, C-1), scores (T,), class_probs)."""
    ncrops, t, d = feats.shape
    n, l, s = num_segments, seg_length, segment_size
    if t != n * s * l:
        raise ValueError(f"features of length {t} are not {n}*{s}*{l}")

    # (ncrops, n, s, l, D) -> (ncrops*s, n, l, D): grids in (crop-major, s) order
    grids = (
        feats.reshape(ncrops, n, s, l, d).transpose(0, 2, 1, 3, 4).reshape(ncrops * s, n, l, d)
    )
    similarity, scores = score_grids(grids)

    # invert to the flat (ncrops, n, s, l) frame order
    c_abn = similarity.shape[-1]
    sim = (
        similarity.reshape(ncrops, s, n, l, c_abn)
        .transpose(0, 2, 1, 3, 4)
        .reshape(ncrops, t, c_abn)
    )
    sc = scores.reshape(ncrops, s, n, l).transpose(0, 2, 1, 3).reshape(ncrops, t)
    # multicrop consensus: the mean over crops (the identity for one crop)
    sim = sim.mean(axis=0)
    sc = sc.mean(axis=0)

    # frame-rate expansion by stride, then trim the padding
    sim = np.repeat(sim, stride, axis=0)[:num_labels]
    sc = np.repeat(sc, stride, axis=0)[:num_labels]

    # softmax over classes, joint probs
    e = np.exp(sim - sim.max(axis=1, keepdims=True))
    class_probs = (e / e.sum(axis=1, keepdims=True)) * sc[:, None]
    return sim, sc, class_probs


def encode_frames_chunked(
    encode: Callable[[torch.Tensor], torch.Tensor],
    frames: np.ndarray,
    device,
    chunk: int = ENCODE_CHUNK,
    host_normalize: bool = False,
) -> np.ndarray:
    """CLIP-encode (N, H, W, 3) frames in calls of exactly ``chunk`` frames, the
    last one padded by repeating its first frame -> (N, D) float32. uint8 frames
    go to the device as uint8 and are normalized there, or, with
    ``host_normalize``, on the host (``normalize_frames``, the same fp32
    arithmetic) for an encoder that takes float32 frames only, as the exported
    encode graph does (export.py). bf16 features widen to float32 exactly.
    Each chunk's staging, upload, encode and fetch (the sync) are spans of
    their own (utils/trace.py)."""
    outs = []
    for i in range(0, len(frames), chunk):
        with span("anomalyclip.evaluator.stage"):
            part = frames[i : i + chunk]
            if host_normalize and part.dtype == np.uint8:
                part = normalize_frames(part)
            pad = chunk - len(part)
            if pad:
                part = np.concatenate([part, np.repeat(part[:1], pad, axis=0)])
            part = np.ascontiguousarray(part)
        with span("anomalyclip.evaluator.upload"):
            uploaded = torch.from_numpy(part).to(device)
        with span("anomalyclip.model.encode"):
            out = encode(uploaded)
        with span("anomalyclip.evaluator.fetch"):
            out = out.float().cpu().numpy()
        outs.append(out[: len(out) - pad] if pad else out)
    return np.concatenate(outs)


def prediction_result(path, num_frames: int, scores: np.ndarray, class_probs: np.ndarray,
                      classnames, normal_id: int) -> dict:
    """The output schema of predict and serve (anomalyclip_tpu/predict.py:
    275-285), from one video's scores (T,) and class probabilities (T, C-1)."""
    abnormal_names = [c for i, c in enumerate(classnames) if i != normal_id]
    top_col = class_probs.argmax(axis=1)
    return {
        "input": path,
        "num_frames": int(num_frames),
        "video_anomaly_score": float(scores.max()),
        "frame_scores": np.round(scores, 6).tolist(),
        "frame_top_class": [abnormal_names[int(c)] for c in top_col],
        "frame_top_class_prob": np.round(class_probs.max(axis=1), 6).tolist(),
        "classnames_abnormal": abnormal_names,
        "class_probs_shape": list(class_probs.shape),
    }
