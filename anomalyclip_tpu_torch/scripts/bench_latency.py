"""Single-video serving latency on the card.

    python -m anomalyclip_tpu_torch.scripts.bench_latency [--path features|frames|both]
        [--iters 16] [--device cpu]

The counterpart of the JAX package's scripts/bench_latency.py: how long ONE
video takes from input tensor to per-frame scores, on the graphs the predictor
and the evaluator run (``eval/evaluator.py``):

  features  pre-extracted CLIP features: ``GridScorer._score`` over the video's
            bucket-padded (segment_size, 32, 16, D) grids, the text features
            computed once when the scorer is built, as in serving;
  frames    preprocessed pixels already on the card: ``model.encode_frames``
            (the bf16 ViT-B/16 in calls of 256 frames) and the same scoring.
            Decoding and the host-to-device copy are not in it.

The model is UCF-Crime's (emb 256, depth 1, the shipped 14-class label table,
bf16 compute). Times are medians by CUDA events. ``--device cpu`` runs each path
once at the tiny test width and prints no times.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from anomalyclip_tpu_torch.eval.evaluator import GridScorer
from anomalyclip_tpu_torch.eval.grids import bucket_size
from anomalyclip_tpu_torch.models.clip.model import cast_tree
from anomalyclip_tpu_torch.scripts._bench_models import UCF_LABELS, build_model
from anomalyclip_tpu_torch.scripts._bench_util import announce_device, median_ms


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--path", default="both", choices=["features", "frames", "both"])
    ap.add_argument("--iters", type=int, default=16)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cpu: each path once at the tiny test width, no times")
    args = ap.parse_args(argv)
    on_card = announce_device("bench_latency", args.device, "each path once at the tiny width; no times")
    # configs/model/anomaly_clip_ucfcrime.yaml: the production model size
    model, frozen, trainable, bn_state = build_model(
        args.device, on_card, labels=UCF_LABELS, emb_size=256, depth=1, heads=8, num_segments=32,
        seg_length=16, concat_features=False, normal_id=7, compute_dtype="bfloat16",
    )
    frozen = cast_tree(frozen, torch.bfloat16)
    rng = np.random.default_rng(0)
    d = model.clip_cfg.embed_dim
    n, l = model.cfg.num_segments, model.cfg.seg_length
    ncentroid = rng.standard_normal(d).astype(np.float32)
    scorer = GridScorer(model, frozen, trainable, bn_state, ncentroid, device=args.device)

    def checked(scores, t_frames):
        if scores.shape[0] < t_frames or not bool(torch.isfinite(scores).all()):
            raise AssertionError(f"scores {tuple(scores.shape)} for {t_frames} frames, or not finite")

    if args.path in ("features", "both"):
        print("features path (pre-extracted features, GridScorer._score):", flush=True)
        for s in (1, 2, 4, 8) if on_card else (1,):
            gb = bucket_size(s, scorer.buckets)  # what score_grids runs
            grids = torch.from_numpy(rng.standard_normal((gb, n, l, d)).astype(np.float32))
            grids = grids.to(args.device)
            t_frames = s * n * l
            checked(scorer._score(grids)[1], t_frames)
            if on_card:
                ms = median_ms(lambda: scorer._score(grids), args.iters)
                print(f"  {t_frames:5d} frames (~{t_frames / 30:5.1f} s @30fps, bucket {gb}): "
                      f"{ms:7.2f} ms/video", flush=True)
            else:
                print(f"  {t_frames:5d} frames (bucket {gb}): scored, finite", flush=True)

    if args.path in ("frames", "both"):
        side = model.clip_cfg.image_resolution
        print("frames path (preprocessed pixels: encode_frames + _score):", flush=True)
        for s in (1, 2) if on_card else (1,):
            t_frames = s * n * l
            gb = bucket_size(s, scorer.buckets)
            video = torch.from_numpy(rng.standard_normal((t_frames, side, side, 3)).astype(np.float32))
            video = video.to(device=args.device, dtype=torch.bfloat16)

            def encode_and_score():
                feats = model.encode_frames(frozen, video).float()
                grids = feats.reshape(1, n, s, l, d).transpose(1, 2).reshape(s, n, l, d)
                if gb != s:
                    grids = torch.cat([grids, grids.new_zeros((gb - s, n, l, d))])
                return scorer._score(grids)[1]

            checked(encode_and_score(), t_frames)
            if on_card:
                ms = median_ms(encode_and_score, max(4, args.iters // 4))
                print(f"  {t_frames:5d} frames (~{t_frames / 30:5.1f} s @30fps): {ms:7.2f} ms/video "
                      f"({t_frames / ms * 1e3:,.0f} fps)", flush=True)
            else:
                print(f"  {t_frames:5d} frames: encoded and scored, finite", flush=True)


if __name__ == "__main__":
    main()
