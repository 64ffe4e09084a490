"""The seeded models the end-to-end bench scripts share (bench_eval,
bench_latency, bench_train_step): UCF-Crime-sized AnomalyCLIP over a randomly
initialised CLIP ViT-B/16 on the card, or over the tiny test config on the CPU.
"""

from __future__ import annotations

import tempfile
from pathlib import Path

import torch

from anomalyclip_tpu_torch.convert import tree_to
from anomalyclip_tpu_torch.models.anomaly_clip import AnomalyCLIP, AnomalyCLIPConfig
from anomalyclip_tpu_torch.models.clip.model import CLIPConfig, init_clip_params

SIX_LABELS = "id,name\n0,Abuse\n1,Arson\n2,Fighting\n3,Normal\n4,Robbery\n5,Shooting\n"
UCF_LABELS = Path(__file__).resolve().parents[2] / "anomalyclip_tpu" / "labels" / "ucf_labels.csv"


def build_model(device: str, on_card: bool, labels: str | Path = SIX_LABELS, **net):
    """AnomalyCLIP with ``net`` as its config over seeded CLIP weights: ViT-B/16
    at full width on the card, ``CLIPConfig.tiny()`` on the CPU. ``labels`` is a
    label table's text or the path of one. -> (model, frozen, trainable,
    bn_state), the trees on ``device``."""
    gen = torch.Generator().manual_seed(0)
    clip_cfg = CLIPConfig.vit_b16() if on_card else CLIPConfig.tiny()
    clip_params = init_clip_params(gen, clip_cfg)
    with tempfile.TemporaryDirectory() as tmp:
        if isinstance(labels, str):
            labels_file = Path(tmp) / "labels.csv"
            labels_file.write_text(labels)
        else:
            labels_file = labels
        cfg = AnomalyCLIPConfig(labels_file=str(labels_file), **net)
        model, frozen = AnomalyCLIP.build(cfg, clip_params, clip_cfg)
    trainable, bn_state = model.init_trainable(gen, frozen)
    return model, tree_to(frozen, device), tree_to(trainable, device), bn_state.to(device)
