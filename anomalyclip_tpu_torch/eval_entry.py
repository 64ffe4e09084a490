#!/usr/bin/env python
"""Evaluation entry point of the port: the counterpart of
anomalyclip_tpu/eval_entry.py, with the reference's invocation contract
(reference: src/eval.py:33-89):

    python -m anomalyclip_tpu_torch.eval_entry data=ucfcrime model=anomaly_clip_ucfcrime \\
        model.net.clip_ckpt_path=/path/to/ViT-B-16.pt \\
        ckpt_path=logs/train/runs/ucfcrime/checkpoints/last
    python -m anomalyclip_tpu_torch.eval_entry data=ucfcrime model=anomaly_clip_ucfcrime \\
        ckpt_path=released.ckpt

``ckpt_path`` is a checkpoint directory of the port (an epoch's, or ``last``;
``convert_ckpt`` writes one from a ``.ckpt``) or a reference Lightning ``.ckpt``,
which is converted in place and scored with its own CLIP. The device, and the
ranks a run spawns or joins (``trainer.devices``, ``trainer=ddp``, ``WORLD_SIZE``),
are chosen as in ``train_entry``; the ranks stride the test videos and gather.

Artifact mode validates an exported serving artifact (export.py) against a
labeled benchmark with no model code or checkpoint, the check before an
artifact ships:

    python -m anomalyclip_tpu_torch.eval_entry artifact=<dir> data=ucfcrime [trainer=cpu]
"""

from __future__ import annotations

import os
import sys
from pathlib import Path


def main(argv=None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    from anomalyclip_tpu_torch.train_entry import as_ranks, choose_device

    os.environ.setdefault("PROJECT_ROOT", str(Path(__file__).resolve().parents[1]))

    from anomalyclip_tpu_torch.config import compose, default_config_dir, to_dict

    cfg = compose(default_config_dir(), "eval", argv)

    if cfg.get("artifact"):
        if not cfg.get("data"):
            raise SystemExit(
                "artifact eval needs a data group: python -m anomalyclip_tpu_torch.eval_entry "
                "artifact=<dir> data=..."
            )
        device = choose_device(argv, cfg)
        from anomalyclip_tpu_torch.parallel.mesh import init_distributed
        from anomalyclip_tpu_torch.utils.extras import apply_extras

        init_distributed(device=device)
        apply_extras(cfg)
        return _eval_artifact(to_dict(cfg), device)

    if not cfg.get("data") or not cfg.get("model"):
        raise SystemExit(
            "No data/model configured. Run with explicit groups, e.g.\n"
            "  python -m anomalyclip_tpu_torch.eval_entry data=ucfcrime model=anomaly_clip_ucfcrime "
            "ckpt_path=..."
        )

    device = choose_device(argv, cfg)
    ckpt_path = cfg.get("ckpt_path")
    if not ckpt_path or ckpt_path == "???":
        raise SystemExit("eval_entry requires ckpt_path=...")
    return as_ranks("anomalyclip_tpu_torch.eval_entry:_rank_test", argv, cfg, device,
                    lambda: _test(cfg, device))


def _rank_test(argv) -> dict:
    """A spawned rank's test pass: the config composed from ``argv`` again."""
    from anomalyclip_tpu_torch.config import compose, default_config_dir
    from anomalyclip_tpu_torch.train_entry import choose_device

    cfg = compose(default_config_dir(), "eval", argv)
    return _test(cfg, choose_device(argv, cfg))


def _test(cfg, device: str) -> dict:
    """The test pass of ``cfg``'s checkpoint on ``device`` (this rank's, in a
    group: the ranks stride the videos and gather) -> its metrics."""
    from anomalyclip_tpu_torch.config import to_dict
    from anomalyclip_tpu_torch.train.module import AnomalyCLIPTrainModule
    from anomalyclip_tpu_torch.utils.extras import apply_extras

    apply_extras(cfg)
    module = AnomalyCLIPTrainModule(to_dict(cfg), device=device)
    return module.test(ckpt_path=cfg.get("ckpt_path"))


def _eval_artifact(cfg: dict, device: str) -> dict:
    """The whole test set through the exported graphs alone: each test-sampled
    item scored by the artifact, then the test artifacts of ``module.test``
    (metrics.json and the plots) under ``<output_dir>/artifact_eval``."""
    import numpy as np

    from anomalyclip_tpu_torch.data.datamodule import AnomalyCLIPDataModule, DataConfig
    from anomalyclip_tpu_torch.data.loader import limit_count
    from anomalyclip_tpu_torch.eval.artifacts import write_test_artifacts
    from anomalyclip_tpu_torch.eval.evaluator import VideoScores, evaluate_videos
    from anomalyclip_tpu_torch.export import ServingArtifact
    from anomalyclip_tpu_torch.models.anomaly_clip import read_classnames
    from anomalyclip_tpu_torch.utils.logging import is_host_zero

    art = ServingArtifact.load(cfg["artifact"], device=device)
    datamodule = AnomalyCLIPDataModule(DataConfig.from_dict(dict(cfg["data"])), seed=int(cfg.get("seed") or 0))
    g = art.meta["grid"]
    dm_cfg = datamodule.cfg
    # all three sampling sizes must agree, or the scores misalign in time
    # (stride expands per-chunk scores back to frame rate)
    wanted = (g["num_segments"], g["seg_length"], g["stride"])
    got = (dm_cfg.num_segments, dm_cfg.seg_length, dm_cfg.stride)
    if got != wanted:
        raise SystemExit(
            f"data group samples (num_segments, seg_length, stride)={got} but "
            f"the artifact was exported for {wanted}"
        )

    def score_item(item) -> VideoScores:
        sim, sc, probs = art.score_test_item(item)
        return VideoScores(sim, sc, probs, np.asarray(item.frame_labels), item.video_label,
                           item.path, getattr(item, "start_frame", 0))

    # trainer.limit_test_batches as the checkpoint-backed test reads it
    limit = (cfg.get("trainer") or {}).get("limit_test_batches")
    loader = datamodule.test_dataloader()
    if limit is not None:
        loader = datamodule.test_dataloader(limit=limit_count(len(loader), limit))

    outputs = evaluate_videos(loader, score_item=score_item)
    if not outputs:
        raise SystemExit("artifact eval scored no test videos (empty test set?)")

    save_dir = Path((cfg.get("paths") or {}).get("output_dir") or ".") / "artifact_eval"
    classnames = art.meta.get("classnames") or read_classnames(dm_cfg.labels_file)
    metrics = write_test_artifacts(
        save_dir,
        outputs["abnormal_scores"],
        outputs["labels"],
        outputs["class_probs"],
        int(art.meta["normal_id"]),
        len(classnames),
        classnames,
        write_files=is_host_zero(),
    )
    print(
        f"artifact eval: AUC={metrics['auc_roc']:.4f} AP={metrics['auc_pr']:.4f} "
        f"mAUC={metrics['mean_mc_auroc']:.4f} mAP={metrics['mean_mc_aupr']:.4f} -> {save_dir}"
    )
    return metrics


def cli() -> int:
    """Console-script entry: main() returns a metrics dict, which setuptools
    wrappers pass to sys.exit() — translate to a clean exit status."""
    main()
    return 0


if __name__ == "__main__":
    main()
