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
which is converted in place and scored with its own CLIP. The device is chosen
as in ``train_entry``. Artifact mode (``artifact=<dir>``, an exported serving
artifact) is not ported yet.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path


def main(argv=None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    from anomalyclip_tpu_torch.train_entry import _refuse_multi_process, choose_device

    _refuse_multi_process(argv)

    os.environ.setdefault("PROJECT_ROOT", str(Path(__file__).resolve().parents[1]))

    from anomalyclip_tpu_torch.config import compose, default_config_dir, to_dict

    cfg = compose(default_config_dir(), "eval", argv)

    if cfg.get("artifact"):
        raise NotImplementedError(
            f"artifact={cfg['artifact']}: evaluating an exported serving artifact is not ported "
            "yet (ROADMAP.md section 1, item 6)"
        )

    if not cfg.get("data") or not cfg.get("model"):
        raise SystemExit(
            "No data/model configured. Run with explicit groups, e.g.\n"
            "  python -m anomalyclip_tpu_torch.eval_entry data=ucfcrime model=anomaly_clip_ucfcrime "
            "ckpt_path=..."
        )

    device = choose_device(argv, cfg)

    from anomalyclip_tpu_torch.utils.extras import apply_extras

    apply_extras(cfg)

    ckpt_path = cfg.get("ckpt_path")
    if not ckpt_path or ckpt_path == "???":
        raise SystemExit("eval_entry requires ckpt_path=...")

    from anomalyclip_tpu_torch.train.module import AnomalyCLIPTrainModule

    module = AnomalyCLIPTrainModule(to_dict(cfg), device=device)
    return module.test(ckpt_path=ckpt_path)


def cli() -> int:
    """Console-script entry: main() returns a metrics dict, which setuptools
    wrappers pass to sys.exit() — translate to a clean exit status."""
    main()
    return 0


if __name__ == "__main__":
    main()
