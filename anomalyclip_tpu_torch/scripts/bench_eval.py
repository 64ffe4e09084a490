"""Feature-path evaluation throughput on the card.

    python -m anomalyclip_tpu_torch.scripts.bench_eval [--grids 64] [--iters 32] [--device cpu]

The counterpart of the JAX package's scripts/bench_eval.py: the per-video
scoring path the evaluator runs at test time (``GridScorer._score``: selector,
axial temporal transformer, sigmoid head) over a batch of (32, 16) grids of
512-d features at the script's model size (emb 128, depth 1, six classes). No
ViT: this is the serving number from pre-extracted features. The time is the
median of ``--iters`` calls by CUDA events. ``--device cpu`` runs one call of 2
grids at the tiny test width and prints no times.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from anomalyclip_tpu_torch.eval.evaluator import GridScorer
from anomalyclip_tpu_torch.scripts._bench_models import build_model
from anomalyclip_tpu_torch.scripts._bench_util import announce_device, median_ms


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--grids", type=int, default=64, help="32x16 grids per batch")
    ap.add_argument("--iters", type=int, default=32)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cpu: one call of 2 grids at the tiny test width, no times")
    args = ap.parse_args(argv)
    on_card = announce_device("bench_eval", args.device, "2 grids at the tiny width; no times")
    model, frozen, trainable, bn_state = build_model(
        args.device, on_card, emb_size=128, depth=1, heads=8, num_segments=32, seg_length=16,
        concat_features=False, normal_id=3,
    )
    rng = np.random.default_rng(0)
    d = model.clip_cfg.embed_dim
    ncentroid = rng.standard_normal(d).astype(np.float32)
    scorer = GridScorer(model, frozen, trainable, bn_state, ncentroid, device=args.device)
    g, n, l = (args.grids if on_card else 2), 32, 16
    grids = torch.from_numpy(rng.standard_normal((g, n, l, d)).astype(np.float32)).to(args.device)
    similarity, scores = scorer._score(grids)
    frames = g * n * l
    if scores.shape != (frames,) or similarity.shape != (frames, len(model.classnames) - 1):
        raise AssertionError(f"eval_score: scores {tuple(scores.shape)}, similarity {tuple(similarity.shape)}")
    if not bool(torch.isfinite(scores).all() and torch.isfinite(similarity).all()):
        raise AssertionError("eval_score: non-finite scores")
    if not on_card:
        print(f"eval_score: {g} grids ({frames} frames) scored, finite", flush=True)
        return
    best = median_ms(lambda: scorer._score(grids), args.iters) / 1e3
    print(f"eval_score: {best * 1e3:.2f} ms / {g} grids ({frames} frames) "
          f"-> {frames / best:,.0f} frames/sec/chip, {g / best:,.0f} grids/sec", flush=True)


if __name__ == "__main__":
    main()
