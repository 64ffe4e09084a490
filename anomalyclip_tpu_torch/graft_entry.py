"""The flagship test-mode forward as a function and its example arguments: the
counterpart of the JAX package's ``__graft_entry__.entry()``.

- ``entry()``: the full from-frames path of the UCF-Crime model (ViT-B/16
  image encoding -> prompt text features -> selector -> axial temporal
  scoring) on one 512-frame video (32 segments of 16 frames), in bf16, with
  seeded weights, on the card unless ``device="cpu"``;
- ``_build_tiny()``: the same model at the test sizes (the tiny CLIP, 8 x 4
  grids), on the CPU;
- ``dryrun_multichip(n)``: the JAX package's multi-chip dry run over ``n``
  ranks of ``torch.distributed`` on the cards (over NCCL with a card each,
  over gloo on shared cards when there are fewer), or on the CPU over gloo
  when asked for or when there is no card: one data-parallel training step, the
  sharded evaluation and the tensor-parallel towers at tiny shapes, each held
  against one process. ``python -m anomalyclip_tpu_torch.graft_entry [n]
  [cpu|cuda]`` runs it.

    from anomalyclip_tpu_torch import graft_entry
    fn, args = graft_entry.entry()
    similarity, scores = fn(*args)
"""

from __future__ import annotations

import tempfile
from pathlib import Path

import numpy as np
import torch

from anomalyclip_tpu_torch.convert import tree_leaves, tree_to
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


def dryrun_route(n_devices: int, device=None) -> tuple:
    """-> (device, backend) of ``dryrun_multichip``'s ranks: on the cards
    unless ``device="cpu"`` or torch sees none, over NCCL when there is a card
    for each rank and over gloo on shared cards when there are fewer (as phase
    4k of chip_smoke.py runs its ranks); CPU ranks over gloo."""
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if device is None:
        device = "cuda" if cards else "cpu"
    if torch.device(device).type == "cpu":
        return "cpu", "gloo"
    if not cards:
        raise RuntimeError("dryrun_multichip runs on the card, and torch sees none; pass device='cpu'")
    return "cuda", "nccl" if cards >= n_devices else "gloo"


def dryrun_multichip(n_devices: int, device=None) -> None:
    """The JAX package's ``dryrun_multichip`` (__graft_entry__.py:99-288) over
    ``n_devices`` spawned ranks on the route ``dryrun_route`` picks: the cards
    (shared over gloo when there are fewer than ``n_devices``), or the CPU over
    gloo when asked for or when there is no card, as the JAX package re-execs
    onto a virtual CPU mesh. Each check is held against one process on the same
    inputs; a mismatch raises (and ``python -m`` exits non-zero). Prints
    ``dryrun_multichip(n): ok, loss=...``."""
    from anomalyclip_tpu_torch.train_entry import run_ranks
    from anomalyclip_tpu_torch.utils.logging import get_logger

    device, backend = dryrun_route(n_devices, device)
    cards = torch.cuda.device_count() if device == "cuda" else 0
    route = f"{n_devices} {device} ranks over {backend}" + (f" on {cards} card(s)" if cards else "")
    get_logger("graft_entry").info(f"dryrun_multichip({n_devices}): {route}")
    out = run_ranks("anomalyclip_tpu_torch.graft_entry:_dryrun_rank", [str(n_devices), device], n_devices,
                    device, backend)
    print(
        f"dryrun_multichip({n_devices}): ok, loss={out['loss']:.4f} (one process {out['loss_one']:.4f}), "
        f"sharded eval AUC={out['auc_roc']:.4f} AP={out['auc_pr']:.4f} (== one process), "
        f"tp({out['dp']}x{out['mp']}) image and text encode parity ok, on {route}"
    )


class _StridedVideos:
    """The rank's stride of a list of test items, as ``SequentialTestLoader``
    with ``shard`` yields it."""

    def __init__(self, items, shard):
        self.items, (self.p, self.count) = items, shard

    def global_indices(self):
        return range(self.p, len(self.items), self.count)

    def __iter__(self):
        return (self.items[i] for i in self.global_indices())


def _dryrun_rank(argv) -> dict:
    """One rank of ``dryrun_multichip``; every rank checks, rank 0's numbers
    are returned."""
    from anomalyclip_tpu_torch.data.dataset import TestItem
    from anomalyclip_tpu_torch.data.loader import TrainBatch
    from anomalyclip_tpu_torch.eval.evaluator import GridScorer, evaluate_videos
    from anomalyclip_tpu_torch.eval.metrics import detection_metrics
    from anomalyclip_tpu_torch.models.clip.model import encode_image, encode_text
    from anomalyclip_tpu_torch.models.losses import LossConfig
    from anomalyclip_tpu_torch.parallel.mesh import allgather_host, mean_over_ranks, rank, rank_device, world_size
    from anomalyclip_tpu_torch.parallel.tp import model_group, shard_tower, tp_encode_image, tp_encode_rows, \
        tp_encode_text
    from anomalyclip_tpu_torch.train.module import build_train_step, init_state, prepare_batch, \
        zero_metric_sums

    n_ranks, me = int(argv[0]), rank()
    assert world_size() == n_ranks, (world_size(), n_ranks)
    device = rank_device(argv[1])
    model, frozen, trainable, bn_state = _build_tiny()
    frozen = tree_to(frozen, device)
    n, l, d = 8, 4, model.embedding_dim

    # one data-parallel step: one video a rank in each half
    rng = np.random.default_rng(0)
    half = n_ranks
    feats = [rng.standard_normal((half, n * l, d)).astype(np.float32) for _ in range(2)]
    labels = [np.resize(np.array([0, 1, 3]), half), np.full(half, 2)]
    ncentroid = torch.from_numpy(rng.standard_normal(d).astype(np.float32)).to(device)
    loss_cfg = LossConfig(normal_id=2, num_topk=2, frames_per_segment=l, num_segments=n)
    solver, optimizer_cfg, sched = {"lr": 1e-4}, {"weight_decay": 0.2}, {"warmup_epochs": 0, "total_epoch": 2}

    def step(rows, dp):
        state = init_state(tree_to(trainable, device), bn_state.to(device), solver, optimizer_cfg, sched, 1)
        batch = TrainBatch(feats[0][rows], labels[0][rows], feats[1][rows], labels[1][rows])
        state, _, terms = build_train_step(model, loss_cfg, dp=dp)(
            frozen, state, prepare_batch(batch, device), ncentroid, torch.Generator().manual_seed(0),
            zero_metric_sums(device))
        return state, terms.total

    state, total = step(slice(me, me + 1), (me, n_ranks))
    loss = float(mean_over_ranks(total))
    one, loss_one = step(slice(None), None)
    assert np.isfinite(loss) and abs(loss - float(loss_one)) <= 1e-5 * max(1.0, abs(loss)), (loss, float(loss_one))
    mine = torch.cat([t.detach().reshape(-1).cpu() for t in tree_leaves(state.trainable)]).numpy()
    ones = torch.cat([t.detach().reshape(-1).cpu() for t in tree_leaves(one.trainable)]).numpy()
    # AdamW moves a weight by about lr whatever its gradient's size, so a
    # gradient that is zero up to rounding may move it either way: all within
    # 2 lr, nearly all within rounding (tests/test_golden.py's two tiers)
    gap = np.abs(mine - ones)
    assert gap.max() <= 2 * solver["lr"] and (gap <= 1e-6 + 1e-4 * np.abs(ones)).mean() >= 0.999, gap.max()
    assert (allgather_host(mine) == mine).all(), "the ranks' parameters differ"
    for got, want in zip(state.bn_state, one.bn_state):
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-5, atol=1e-6)

    # the sharded evaluation: each rank scores its stride of the videos, the
    # gather gives every rank the one-process outputs to the bit
    scorer = GridScorer(model, frozen, state.trainable, state.bn_state, ncentroid, device=device)
    items = [
        TestItem(rng.standard_normal((1, n * s * l, d)).astype(np.float32),
                 np.resize(np.array([2, 2, 0, 2, 1, 2, 3, 2]), n * s * l - k), int(k % 3), s, f"video{k}")
        for k, s in enumerate([1, 2, 1, 3, 1][: 2 * n_ranks + 1])
    ]
    gathered = evaluate_videos(_StridedVideos(items, (me, n_ranks)), scorer, model, gather_processes=True)
    alone = evaluate_videos(items, scorer, model)
    for key in alone:
        np.testing.assert_array_equal(gathered[key], alone[key], err_msg=key)
    det = detection_metrics(gathered["abnormal_scores"], gathered["labels"], gathered["class_probs"],
                            normal_id=2, num_classes=4)

    # tensor parallelism over (data, model) groups: a four-head tower, each
    # group encoding its rows of the batch on its ranks' shards
    mp = 2 if n_ranks % 2 == 0 else 1
    mg = model_group(mp)
    clip_cfg = CLIPConfig(embed_dim=64, image_resolution=32, vision_layers=2, vision_width=256,
                          vision_patch_size=16, transformer_width=64, transformer_heads=4, transformer_layers=2)
    clip = init_clip_params(torch.Generator().manual_seed(3), clip_cfg)
    images = torch.from_numpy(rng.standard_normal((2 * n_ranks, 32, 32, 3)).astype(np.float32))
    tokens = torch.from_numpy(rng.integers(1, 1000, size=(2 * mg.groups, clip_cfg.context_length)))
    tokens[:, -1] = clip_cfg.vocab_size - 1  # the EOT, at the argmax
    visual = shard_tower(clip, clip_cfg, "visual", mp, mg.member, device)
    text = shard_tower(clip, clip_cfg, "text", mp, mg.member, device)
    with torch.no_grad():
        got = tp_encode_rows(lambda x: tp_encode_image(visual, clip_cfg, x.to(device), group=mg.group),
                             images, mg, clip_cfg.embed_dim)
        want = encode_image(tree_to(clip, device), clip_cfg, images.to(device)).cpu()
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-4)
        got = tp_encode_rows(lambda x: tp_encode_text(text, clip_cfg, x.to(device), group=mg.group),
                             tokens, mg, clip_cfg.embed_dim)
        want = encode_text(tree_to(clip, device), clip_cfg, tokens.to(device)).cpu()
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-4)
    return {"loss": loss, "loss_one": float(loss_one), "auc_roc": det["auc_roc"], "auc_pr": det["auc_pr"],
            "dp": mg.groups, "mp": mp}


if __name__ == "__main__":
    import sys

    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2, sys.argv[2] if len(sys.argv) > 2 else None)
