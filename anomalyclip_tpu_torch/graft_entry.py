"""The flagship test-mode forward as a function and its example arguments: the
counterpart of the JAX package's ``__graft_entry__.entry()``.

- ``entry()``: the full from-frames path of the UCF-Crime model (ViT-B/16
  image encoding -> prompt text features -> selector -> axial temporal
  scoring) on one 512-frame video (32 segments of 16 frames), in bf16, with
  seeded weights, on the card unless ``device="cpu"``;
- ``_build_tiny()``: the same model at the test sizes (the tiny CLIP, 8 x 4
  grids), on the CPU;
- ``dryrun_multichip(n)``: the JAX package's multi-chip training dry run. More
  than one device is not ported yet, and it raises.

    from anomalyclip_tpu_torch import graft_entry
    fn, args = graft_entry.entry()
    similarity, scores = fn(*args)
"""

from __future__ import annotations

import tempfile
from pathlib import Path

import numpy as np
import torch

from anomalyclip_tpu_torch.convert import tree_to
from anomalyclip_tpu_torch.models.anomaly_clip import AnomalyCLIP, AnomalyCLIPConfig
from anomalyclip_tpu_torch.models.clip.model import CLIPConfig, init_clip_params


def _labels_file(names) -> str:
    path = Path(tempfile.mkdtemp()) / "labels.csv"
    path.write_text("id,name\n" + "".join(f"{i},{n}\n" for i, n in enumerate(names)))
    return str(path)


def _build_tiny(num_segments=8, seg_length=4, emb_size=32):
    """The JAX package's tiny test model (``__graft_entry__._build_tiny``) ->
    (model, frozen, trainable, bn_state), on the CPU, from seeded weights."""
    clip_cfg = CLIPConfig.tiny()
    cfg = AnomalyCLIPConfig(
        labels_file=_labels_file(["alpha", "beta", "normal", "omega"]),
        emb_size=emb_size,
        depth=1,
        heads=4,
        num_segments=num_segments,
        seg_length=seg_length,
        concat_features=True,
        normal_id=2,
        num_topk=2,
        num_bottomk=2,
    )
    model, frozen = AnomalyCLIP.build(cfg, init_clip_params(torch.Generator().manual_seed(0), clip_cfg), clip_cfg)
    trainable, bn_state = model.init_trainable(torch.Generator().manual_seed(1), frozen)
    return model, frozen, trainable, bn_state


def scoring_forward(model: AnomalyCLIP, bn_state):
    """-> fn(frozen, trainable, frames, ncentroid) -> (similarity, scores): the
    test-mode forward of one video of ``model``'s grids (segment size 1),
    with ``bn_state`` (the function ``entry`` returns)."""

    def forward(frozen, trainable, frames, ncentroid):
        return model.forward_test(frozen, trainable, bn_state, frames, ncentroid, segment_size=1)

    return forward


def flagship_config():
    """-> (AnomalyCLIPConfig, CLIPConfig) of ``entry``'s model: the JAX entry's."""
    return AnomalyCLIPConfig(
        labels_file=_labels_file(["Abuse", "Arson", "Fighting", "Normal", "Robbery", "Shooting"]),
        emb_size=256,
        depth=1,
        heads=8,
        num_segments=32,
        seg_length=16,
        concat_features=False,
        normal_id=3,
        load_from_features=False,  # the flagship path: the ViT-B/16 encoding inside
        compute_dtype="bfloat16",
    ), CLIPConfig.vit_b16()


def entry(device: str = "cuda"):
    """-> (fn, example_args): the flagship from-frames test forward
    ``fn(frozen, trainable, frames, ncentroid) -> (similarity, scores)``:
    ViT-B/16 at full width, one video of 32 x 16 = 512 frames, bf16 compute,
    temporal emb 256, depth 1, 8 heads, normal class 3 of 6 (``flagship_config``).
    On the card the image and text towers run K1 (the tensor-core kernel in
    bf16) and the temporal model K2 (its split-TF32 kernel: fp32 under either
    dtype)."""
    cfg, clip_cfg = flagship_config()
    gen = torch.Generator().manual_seed(0)
    model, frozen = AnomalyCLIP.build(cfg, init_clip_params(gen, clip_cfg), clip_cfg)
    trainable, bn_state = model.init_trainable(torch.Generator().manual_seed(1), frozen)
    frozen, trainable, bn_state = tree_to(frozen, device), tree_to(trainable, device), bn_state.to(device)
    forward = scoring_forward(model, bn_state)
    rng = np.random.default_rng(0)
    frames = torch.from_numpy(rng.standard_normal((1, 32 * 16, 224, 224, 3), dtype=np.float32))
    ncentroid = torch.from_numpy(rng.standard_normal(clip_cfg.embed_dim).astype(np.float32))
    return forward, (frozen, trainable, frames.to(device, torch.bfloat16), ncentroid.to(device))


def dryrun_multichip(n_devices: int) -> None:
    """The JAX package's data-parallel training step, sharded evaluation and
    tensor-parallel encode over ``n_devices`` chips: not ported."""
    raise NotImplementedError(
        f"dryrun_multichip({n_devices}): more than one device is not ported yet "
        "(ROADMAP.md section 1, item 8)"
    )
