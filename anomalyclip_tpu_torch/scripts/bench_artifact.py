"""What scoring through an exported serving artifact costs, on the card.

    python -m anomalyclip_tpu_torch.scripts.bench_artifact [--iters 16] [--device cpu]

The counterpart of the JAX package's scripts/bench_artifact.py. Deployment can
score from a ``torch.export`` artifact (``export.py``) instead of the model's
code; this times the production score graph two ways on the same inputs, on
the model block of ``bench_latency`` (UCF-Crime: emb 256, depth 1, 8 heads, the
14-class label table, bf16 compute over a bf16 frozen tree):

  native    ``GridScorer._score``, what serve, predict and eval run when they
            load a checkpoint;
  artifact  the score graph after ``export_serving_artifact(...,
            include_encoder=False)`` and ``ServingArtifact.load``, called with
            its leaves passed as arguments, as ``ServingArtifact.score`` calls
            it (closing over them would time another program than production
            runs).

Both launch K2 (``fused_mha_bld``: head dim 32 at L = 32 and 16, the
split-TF32 whole-head kernel of ``mha_bld_tf32.cu``) twice a call. Beyond the
JAX script, the two scores are held equal within ``SCORE_TOL`` at every video
count; a miss exits 1. Times are medians by CUDA events at 1 and 8 videos of
512 frames, each at its bucket size. ``--device cpu`` scores at the tiny CLIP
width with 1 and 2 videos and prints no times.
"""

from __future__ import annotations

import argparse
import sys
import tempfile

import numpy as np
import torch

from anomalyclip_tpu_torch.eval.evaluator import GridScorer
from anomalyclip_tpu_torch.eval.grids import bucket_size
from anomalyclip_tpu_torch.export import ServingArtifact, export_serving_artifact
from anomalyclip_tpu_torch.models.clip.model import cast_tree
from anomalyclip_tpu_torch.scripts._bench_models import UCF_LABELS, build_model
from anomalyclip_tpu_torch.scripts._bench_util import announce_device, median_ms

# fp32 scores of the same graph, traced or not (tests/test_torch_export.py's limit)
SCORE_TOL = 1e-6


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=16)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cpu: 1 and 2 videos at the tiny CLIP width, no times")
    args = ap.parse_args(argv)
    on_card = announce_device("bench_artifact", args.device, "1 and 2 videos at the tiny width; no times")
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
    with tempfile.TemporaryDirectory(prefix="artifact_bench_") as out:
        export_serving_artifact(model, frozen, trainable, bn_state, torch.from_numpy(ncentroid).to(args.device),
                                out, include_encoder=False)
        art = ServingArtifact.load(out, device=args.device)

    def artifact(grids):
        with torch.no_grad(), art._precision():
            return art._score_graph(art._score_leaves, grids)

    results = {}
    for s in (1, 8) if on_card else (1, 2):
        gb = bucket_size(s, scorer.buckets)  # what score_grids runs
        grids = torch.from_numpy(rng.standard_normal((gb, n, l, d)).astype(np.float32)).to(args.device)
        native_scores, artifact_scores = scorer._score(grids)[1], artifact(grids)[1]
        gap = float((native_scores - artifact_scores).abs().max())
        t_frames = s * n * l
        row = {"frames": t_frames, "bucket": gb, "max_abs_diff": gap}
        if gap > SCORE_TOL or not bool(torch.isfinite(native_scores).all()):
            print(f"{t_frames:5d} frames (bucket {gb}): artifact scores differ from native by {gap:.3e} "
                  f"(limit {SCORE_TOL}), or are not finite", file=sys.stderr, flush=True)
            raise SystemExit(1)
        if on_card:
            row["native_ms"] = median_ms(lambda: scorer._score(grids), args.iters)
            row["artifact_ms"] = median_ms(lambda: artifact(grids), args.iters)
            print(f"{t_frames:5d} frames (bucket {gb}): native {row['native_ms']:7.3f} ms, artifact "
                  f"{row['artifact_ms']:7.3f} ms ({row['artifact_ms'] / row['native_ms']:0.3f}x); scores "
                  f"max|diff| {gap:.3e}", flush=True)
        else:
            print(f"{t_frames:5d} frames (bucket {gb}): artifact scores equal native's "
                  f"(max|diff| {gap:.3e})", flush=True)
        results[s] = row
    return results


if __name__ == "__main__":
    main()
