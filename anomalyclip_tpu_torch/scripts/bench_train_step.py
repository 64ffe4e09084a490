"""From-frames training-step throughput on the card.

    python -m anomalyclip_tpu_torch.scripts.bench_train_step [--videos 4] [--iters 4] [--device cpu]

The counterpart of the JAX package's scripts/bench_train_step.py: with
``load_from_features=False`` every training step encodes videos x 32 x 16
frames with the frozen ViT-B/16 (bf16, 256 frames a call, no gradient), then
runs the selector and the temporal model forward and backward and the AdamW
update (``train/module.py: build_train_step``). This times whole steps on the
host clock, each ended by a device synchronise, after one warm step, with the
frames already on the card. ``--device cpu`` takes one step of 2 videos at the
tiny test width and prints no times.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from anomalyclip_tpu_torch.data.loader import TrainBatch
from anomalyclip_tpu_torch.models.clip.model import cast_tree
from anomalyclip_tpu_torch.models.losses import LossConfig
from anomalyclip_tpu_torch.scripts._bench_models import build_model
from anomalyclip_tpu_torch.scripts._bench_util import announce_device
from anomalyclip_tpu_torch.train.module import build_train_step, init_state, zero_metric_sums


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--videos", type=int, default=4, help="videos per step, in two halves")
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cpu: one step of 2 videos at the tiny test width, no times")
    args = ap.parse_args(argv)
    on_card = announce_device("bench_train_step", args.device, "one step of 2 videos at the tiny width; no times")
    model, frozen, trainable, bn_state = build_model(
        args.device, on_card, emb_size=256, depth=1, heads=8, num_segments=32, seg_length=16,
        concat_features=False, normal_id=3, num_topk=3, num_bottomk=3, load_from_features=False,
        compute_dtype="bfloat16",
    )
    frozen = cast_tree(frozen, torch.bfloat16)
    state = init_state(trainable, bn_state, {"lr": 1e-4}, {"weight_decay": 0.2},
                       {"warmup_epochs": 1, "total_epoch": 10}, steps_per_epoch=10)
    train_step = build_train_step(
        model, LossConfig(normal_id=3, num_topk=3, frames_per_segment=16, num_segments=32)
    )
    b = args.videos if on_card else 2
    t, side = 32 * 16, model.clip_cfg.image_resolution
    rng = np.random.default_rng(0)

    def frames(count):
        x = torch.from_numpy(rng.standard_normal((count, t, side, side, 3)).astype(np.float32))
        return x.to(device=args.device, dtype=torch.bfloat16)

    batch = TrainBatch(
        abnormal_features=frames(b // 2),
        abnormal_labels=torch.from_numpy(rng.integers(0, 3, b // 2)).to(args.device),
        normal_features=frames(b - b // 2),
        normal_labels=torch.full((b - b // 2,), 3, device=args.device),
    )
    ncentroid = torch.from_numpy(rng.standard_normal(model.clip_cfg.embed_dim).astype(np.float32))
    ncentroid = ncentroid.to(args.device)
    gen = torch.Generator().manual_seed(0)

    def step():
        nonlocal state
        state, _, terms = train_step(frozen, state, batch, ncentroid, gen, zero_metric_sums(args.device))
        if on_card:
            torch.cuda.synchronize()
        return terms

    start = time.perf_counter()
    terms = step()
    if not bool(torch.isfinite(terms.total)):
        raise AssertionError(f"train_step: loss {terms.total}")
    if not on_card:
        print(f"train_step: one step of {b} videos ({b * t} frames) taken, loss finite", flush=True)
        return
    print(f"# first step: {time.perf_counter() - start:.1f}s", flush=True)
    start = time.perf_counter()
    for _ in range(args.iters):
        step()
    dt = (time.perf_counter() - start) / args.iters
    print(f"train_step: {dt * 1e3:,.1f} ms/step ({b} videos, {b * t} frames) "
          f"-> {b * t / dt:,.0f} frames/sec/chip", flush=True)


if __name__ == "__main__":
    main()
