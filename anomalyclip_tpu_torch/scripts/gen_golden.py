"""Write the golden parity fixtures with the port, and hold each against a set
already written.

    python -m anomalyclip_tpu_torch.scripts.gen_golden --out DIR
        [--only tokenizer clip_b16 tiny metrics] [--against tests/golden]
        [--clip-file ViT-B-16.pt]
        [--tiny-ckpt released.ckpt | --tiny-state tiny_state.npz] [--device cpu]

The counterpart of the JAX package's scripts/gen_golden.py. It writes the same
five fixtures, under ``--out`` only (never into ``tests/golden/``):

- ``tokenizer.npz``: the port's tokenizer over ``GOLDEN_TEXTS`` and the CoOp
  prompts and class names of the four label tables;
- ``clip_b16.npz``: seeded uint8 frames and two texts through the ViT-B/16
  tower at fp32. The weights are the port's seeded init, or ``--clip-file`` (an
  OpenAI-layout file);
- ``tiny_state.npz``: the trees of a reference Lightning ``.ckpt``
  (``--tiny-ckpt``) through the port's ``convert_ckpt``, the token-embedding
  rows no prompt reads zeroed so that the file compresses;
- ``tiny_pipeline.npz``: from that state, or from ``--tiny-state`` (default
  ``tests/golden/tiny_state.npz``), over the synthetic corpus: the ncentroid,
  the training forward and its loss terms (``train/*``), the evaluation epoch
  and its metrics (``eval/*``), and three AdamW steps at lr 1e-3, warmup 0,
  1000 steps an epoch (``steps/*``);
- ``metrics.npz``: the detection metrics of a seeded score corpus.

Where the JAX writer checks its numbers against the reference's torch code,
this one holds each fixture it writes against the file of the same name in
``--against`` at ``tests/test_golden.py``'s tolerances (``TOL``), and exits 1
on any miss. ``clip_b16``'s inputs are held there; its features only where
the caller of ``gen_clip_b16`` says the weights are those the committed
fixture was written from (the JAX package's PRNGKey(0) init, which the CPU
test carries over), and on the card kernel against plain attention. ``metrics`` is
also held against scikit-learn where it imports, and the script says whether
it did. On the card the tiny pipeline runs on it: K1 in the causal text tower,
K3 in the three steps' prompt gradient. ``--device cpu`` runs everything on
the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

REPO_ROOT = Path(__file__).resolve().parents[2]
GOLDEN_DIR = REPO_ROOT / "tests" / "golden"
LABELS_DIR = REPO_ROOT / "anomalyclip_tpu" / "labels"

# the texts of the tokenizer and text-encoder fixtures (JAX gen_golden.py)
GOLDEN_TEXTS = [
    "a video of fire",
    "an empty street at night",
    "a person stealing a car",
    "X X X X X X X X road accident.",
]
LABEL_SETS = ("ucf", "sht", "xd", "synthetic")
WRITERS = ("tokenizer", "clip_b16", "tiny", "metrics")

# the golden tiny pipeline's overrides: dropout 0 makes the training forward
# deterministic, emb 32 keeps the temporal model's weights small
TINY_OVERRIDES = (
    "model.net.select_idx_dropout_topk=0.0",
    "model.net.select_idx_dropout_bottomk=0.0",
    "model.net.emb_size=32",
    "data.num_workers=0",
)

# (rtol, atol) by fixture value: tests/test_golden.py's (None: exact)
TOL = {
    "tokens": None,
    "features": (1e-4, 1e-4),
    "ncentroid": (1e-5, 1e-5),
    "train": (1e-4, 2e-5),
    "loss_terms": (2e-4, 1e-5),
    "bn": (0.0, 1e-6),
    "eval": (1e-4, 2e-5),
    "eval_metrics": (0.0, 1e-4),
    "step_losses": (5e-4, 1e-5),
    "step_bn": (1e-5, 1e-6),
    "metrics": (0.0, 1e-9),
}
STEP_LR = 1e-3  # the trajectory's lr, and the bound of the trainables' two-tier check
# the CLIP config's fields a flat tiny state holds (convert.state_from_flat reads them)
CLIP_FIELDS = ("embed_dim", "image_resolution", "vision_layers", "vision_width", "vision_patch_size",
               "context_length", "vocab_size", "transformer_width", "transformer_heads", "transformer_layers")


def labels_file(name: str) -> Path:
    return LABELS_DIR / f"{name}_labels.csv"


def coop_prompts(classnames, n_ctx: int = 8) -> List[str]:
    prefix = " ".join(["X"] * n_ctx)
    return [f"{prefix} {name}." for name in classnames]


# ---------------------------------------------------------------------------
# the fixed inputs: copies of tests/helpers/golden_inputs.py
# ---------------------------------------------------------------------------


def abnormal_classes(num_classes: int, normal_id: int) -> List[int]:
    return [c for c in range(num_classes) if c != normal_id]


def train_forward_inputs(num_classes: int, normal_id: int, n: int, l: int, d: int):
    """The training forward's batch: rng(123), 4 abnormal + 4 normal."""
    b = 8
    rng = np.random.default_rng(123)
    feats = rng.standard_normal((b, 1, n * l, d)).astype(np.float32)
    abn = abnormal_classes(num_classes, normal_id)
    labels = np.array([abn[i % len(abn)] for i in range(b // 2)] + [normal_id] * (b // 2), dtype=np.int64)
    return feats, labels


def trajectory_batches(num_classes: int, normal_id: int, n: int, l: int, d: int):
    """The three steps' batches: rng(77), 4 abnormal + 4 normal each."""
    half = 4
    rng = np.random.default_rng(77)
    abn = abnormal_classes(num_classes, normal_id)
    batches = []
    for k in range(3):
        feats = rng.standard_normal((2 * half, n * l, d)).astype(np.float32)
        labels = np.array([abn[(k + i) % len(abn)] for i in range(half)] + [normal_id] * half, dtype=np.int64)
        batches.append((feats, labels))
    return batches


# ---------------------------------------------------------------------------
# holding a written fixture against another
# ---------------------------------------------------------------------------


class Held:
    """The comparisons of one run: each a line of its own, the misses kept."""

    def __init__(self):
        self.misses: List[str] = []
        self.count = 0

    def close(self, what: str, got, want, tol) -> None:
        """``got`` against ``want``: exact where ``tol`` is None, else within
        (rtol, atol) elementwise, as numpy's ``assert_allclose``."""
        self.count += 1
        got, want = np.asarray(got), np.asarray(want)
        try:
            if tol is None:
                np.testing.assert_array_equal(got, want)
            else:
                np.testing.assert_allclose(got, want, rtol=tol[0], atol=tol[1])
        except AssertionError as exc:
            self.misses.append(f"{what}: " + " | ".join(line.strip() for line in str(exc).strip().splitlines()[:6]))

    def require(self, what: str, ok: bool, detail: str = "") -> None:
        self.count += 1
        if not ok:
            self.misses.append(f"{what}: {detail}")

    def trainables(self, what: str, got: Dict[str, np.ndarray], want: Dict[str, np.ndarray]) -> None:
        """tests/test_golden.py's two-tier check of Adam's end weights: every
        element within 2 lr a step, and 99.9% of each leaf's within 5e-5 +
        1e-3 |want| (an element near zero gradient may flip its update's sign
        on an fp32 rounding)."""
        self.require(f"{what} keys", set(got) == set(want), f"{sorted(set(got) ^ set(want))}")
        for key in sorted(set(got) & set(want)):
            diff = np.abs(got[key] - want[key])
            tight = diff <= 5e-5 + 1e-3 * np.abs(want[key])
            self.require(f"{what} {key}", diff.max() < 2 * STEP_LR * 3 and tight.mean() >= 0.999,
                         f"max|diff| {diff.max():.3e}, {1 - tight.mean():.4%} outside the tight bound")


def _load(path: Path) -> Dict[str, np.ndarray]:
    with np.load(path, allow_pickle=False) as data:
        return {k: data[k] for k in data.files}


def _against(against: Optional[Path], name: str) -> Optional[Dict[str, np.ndarray]]:
    if against is None:
        return None
    path = against / name
    if not path.is_file():
        raise FileNotFoundError(f"--against {against}: no {name} to hold the written one against")
    return _load(path)


# ---------------------------------------------------------------------------
# tokenizer.npz
# ---------------------------------------------------------------------------


def gen_tokenizer(out: Path, held: Held, against: Optional[Path]) -> Dict[str, np.ndarray]:
    from anomalyclip_tpu_torch.models.anomaly_clip import read_classnames
    from anomalyclip_tpu_torch.models.clip.tokenizer import tokenize

    fixture = {"texts": np.array(GOLDEN_TEXTS), "texts_ids": tokenize(GOLDEN_TEXTS)}
    for ds in LABEL_SETS:
        classnames = read_classnames(labels_file(ds))
        fixture[f"{ds}_classnames"] = np.array(classnames)
        fixture[f"{ds}_prompt_ids"] = tokenize(coop_prompts(classnames))
        fixture[f"{ds}_name_ids"] = tokenize(list(classnames))
    np.savez_compressed(out / "tokenizer.npz", **fixture)
    want = _against(against, "tokenizer.npz")
    if want is not None:
        held.require("tokenizer.npz keys", set(fixture) == set(want), f"{sorted(set(fixture) ^ set(want))}")
        for key in sorted(set(fixture) & set(want)):
            held.close(f"tokenizer.npz {key}", fixture[key], want[key], TOL["tokens"])
    print(f"tokenizer.npz: {sum(len(v) for k, v in fixture.items() if k.endswith('_ids'))} token rows", flush=True)
    return fixture


# ---------------------------------------------------------------------------
# clip_b16.npz
# ---------------------------------------------------------------------------


def clip_b16_features(params, cfg, image_u8: np.ndarray, text_ids: np.ndarray, device: str):
    """fp32 image and text features of the tower ``params`` on ``device``."""
    from anomalyclip_tpu_torch.models.clip.model import encode_image, encode_text

    with torch.no_grad():
        image = encode_image(params, cfg, torch.from_numpy(image_u8).to(device))
        text = encode_text(params, cfg, torch.from_numpy(text_ids).to(device))
    return image.float().cpu().numpy(), text.float().cpu().numpy()


def gen_clip_b16(out: Path, held: Held, params, cfg, device: str, against: Optional[Path] = None,
                 is_golden: bool = False) -> Dict[str, np.ndarray]:
    """``clip_b16.npz`` from the CLIP tree ``params`` (``cfg``) on ``device``.
    The inputs are held exactly against ``against``'s; the features too, at
    1e-4, where ``is_golden`` says the weights are those it was written from.
    On the card the features are held, besides, against the plain attention's."""
    from anomalyclip_tpu_torch.models.clip.tokenizer import tokenize
    from anomalyclip_tpu_torch.ops.attention import attention_impl

    image_u8 = np.random.default_rng(0).integers(0, 256, size=(2, 224, 224, 3), dtype=np.uint8)
    text_ids = tokenize(GOLDEN_TEXTS[:2])
    image_features, text_features = clip_b16_features(params, cfg, image_u8, text_ids, device)
    fixture = dict(image_u8=image_u8, text_ids=text_ids, image_features=image_features,
                   text_features=text_features)
    np.savez_compressed(out / "clip_b16.npz", **fixture)
    for name, value in (("image_features", image_features), ("text_features", text_features)):
        held.require(f"clip_b16.npz {name}", bool(np.isfinite(value).all()), "not finite")
    want = _against(against, "clip_b16.npz")
    if want is not None:
        for key in ("image_u8", "text_ids"):
            held.close(f"clip_b16.npz {key}", fixture[key], want[key], TOL["tokens"])
        if is_golden:
            for key in ("image_features", "text_features"):
                held.close(f"clip_b16.npz {key}", fixture[key], want[key], TOL["features"])
    if torch.device(device).type == "cuda":
        with attention_impl("reference"):
            plain = clip_b16_features(params, cfg, image_u8, text_ids, device)
        for key, value in zip(("image_features", "text_features"), plain):
            held.close(f"clip_b16 {key}: kernels vs plain attention", fixture[key], value, TOL["features"])
    print(f"clip_b16.npz: features {image_features.shape} and {text_features.shape}"
          f"{' (held against the committed ones)' if is_golden and want is not None else ''}", flush=True)
    return fixture


# ---------------------------------------------------------------------------
# tiny_state.npz + tiny_pipeline.npz
# ---------------------------------------------------------------------------


def synthetic_config(root: Path, *overrides: str) -> dict:
    """The synthetic experiment at ``TINY_OVERRIDES`` and ``overrides``,
    composed by the port with its corpus and logs under ``root``. The paths
    interpolate the environment when the config is composed, so it is set for
    the composition alone and restored after."""
    from anomalyclip_tpu_torch.config import compose, default_config_dir, to_dict

    wanted = {"PROJECT_ROOT": str(REPO_ROOT), "SYNTHETIC_ROOT": str(root / "synthetic"),
              "LOG_DIR": str(root / "logs")}
    saved = {k: os.environ.get(k) for k in wanted}
    os.environ.update(wanted)
    try:
        return to_dict(compose(default_config_dir(), "train", ["experiment=synthetic", *TINY_OVERRIDES,
                                                                *overrides]))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def tiny_state_from_ckpt(ckpt: Path, classnames) -> Dict[str, np.ndarray]:
    """A reference Lightning ``.ckpt`` -> the flat ``tiny_state.npz``: its
    trees in the JAX package's layout (``convert.tree_to_jax``), the BN state,
    the CLIP config's fields; the token-embedding rows that no CoOp prompt of
    ``classnames`` reads zeroed."""
    from anomalyclip_tpu_torch.convert import tree_to_jax
    from anomalyclip_tpu_torch.convert_ckpt import (
        convert_lightning_checkpoint,
        converted_clip_config,
        load_lightning_state_dict,
    )
    from anomalyclip_tpu_torch.models.clip.tokenizer import tokenize
    from anomalyclip_tpu_torch.utils.treeio import flatten_tree

    sd = load_lightning_state_dict(ckpt)
    frozen, trainable, bn_state = convert_lightning_checkpoint(sd)
    clip_cfg = converted_clip_config(sd)
    frozen, trainable = tree_to_jax(frozen), tree_to_jax(trainable)
    emb = frozen["clip"]["text"]["token_embedding"].copy()
    unused = np.ones(emb.shape[0], dtype=bool)
    unused[np.unique(tokenize(coop_prompts(classnames)))] = False
    emb[unused] = 0.0
    frozen["clip"]["text"]["token_embedding"] = emb
    flat = {**flatten_tree(frozen, "frozen"), **flatten_tree(trainable, "trainable"),
            "bn/mean": bn_state.mean.numpy(), "bn/var": bn_state.var.numpy()}
    for name in CLIP_FIELDS:
        flat[f"clip_cfg/{name}"] = np.asarray(getattr(clip_cfg, name))
    return flat


def tiny_pipeline(state_flat: Dict[str, np.ndarray], device: str, root: Path) -> Dict[str, np.ndarray]:
    """``tiny_pipeline.npz`` of the flat tiny state on ``device``, over the
    synthetic corpus the port writes under ``root``."""
    from anomalyclip_tpu_torch import convert
    from anomalyclip_tpu_torch.eval.evaluator import evaluate_videos
    from anomalyclip_tpu_torch.eval.metrics import detection_metrics
    from anomalyclip_tpu_torch.models.losses import compute_loss
    from anomalyclip_tpu_torch.train import module as tmod
    from anomalyclip_tpu_torch.utils.treeio import flatten_tree

    cfg = synthetic_config(root)
    module = tmod.AnomalyCLIPTrainModule(cfg, device=device)  # writes the seeded corpus
    frozen, trainable, bn_state, clip_cfg = convert.state_from_flat(state_flat, device=device)
    state = module.adopt_converted_state(frozen, trainable, bn_state, clip_cfg)
    model, frozen = module.model, module.frozen
    data, net = cfg["data"], cfg["model"]["net"]
    n, l, d = int(net["num_segments"]), int(net["seg_length"]), int(clip_cfg.embed_dim)
    normal_id, num_classes = int(data["normal_id"]), int(data["num_classes"])
    fixture = {}

    # the ncentroid over the normal training videos
    ncentroid = np.asarray(module.compute_ncentroid(), np.float32)
    fixture["ncentroid"] = ncentroid
    ncentroid_t = torch.from_numpy(ncentroid).to(device)

    # the training forward and its seven loss terms
    feats, labels = train_forward_inputs(num_classes, normal_id, n, l, d)
    labels_t = torch.from_numpy(labels).to(device)
    with torch.no_grad():
        fwd, new_bn = model.forward_train(frozen, state.trainable, state.bn_state,
                                          torch.from_numpy(feats[:, 0]).to(device), labels_t, ncentroid_t,
                                          torch.Generator())
        terms = compute_loss(fwd.logits, fwd.logits_topk, labels_t, fwd.scores, fwd.idx_topk_abn,
                             fwd.idx_topk_nor, fwd.idx_bottomk_abn, module.loss_cfg)
    for name in ("logits", "logits_topk", "scores", "idx_topk_abn", "idx_topk_nor", "idx_bottomk_abn"):
        value = getattr(fwd, name).detach().cpu().numpy()
        fixture[f"train/{name}"] = value if value.dtype.kind == "f" else value.astype(np.int32)
    fixture["train/bn_mean"] = new_bn.mean.cpu().numpy()
    fixture["train/bn_var"] = new_bn.var.cpu().numpy()
    fixture["train/loss_terms"] = np.asarray([float(t) for t in terms])

    # the evaluation epoch over the synthetic test set
    module.ncentroid = ncentroid
    ev = evaluate_videos(module.datamodule.test_dataloader(), module._scorer(state), model)
    fixture["eval/abnormal_scores"] = ev["abnormal_scores"]
    fixture["eval/labels"] = ev["labels"]
    fixture["eval/class_probs"] = ev["class_probs"]
    det = detection_metrics(ev["abnormal_scores"], ev["labels"], ev["class_probs"], normal_id, num_classes)
    fixture["eval/metrics"] = np.asarray([det["auc_roc"], det["auc_pr"], det["mean_mc_auroc"],
                                          det["mean_mc_aupr"], det["optimal_threshold"]])

    # three AdamW steps at lr 1e-3, warmup 0, 1000 steps an epoch
    model_cfg = cfg["model"]
    steps = tmod.init_state(state.trainable, state.bn_state, dict(model_cfg["solver"], lr=STEP_LR),
                            dict(model_cfg.get("optimizer") or {}),
                            dict(model_cfg.get("scheduler") or {}, warmup_epochs=0), steps_per_epoch=1000)
    batches = [tmod.TrainBatch(f[:4], y[:4], f[4:], y[4:]) for f, y in trajectory_batches(num_classes, normal_id,
                                                                                           n, l, d)]
    losses = []
    steps, _ = tmod.fit_steps(tmod.build_train_step(model, module.loss_cfg), frozen, steps, batches, ncentroid_t,
                              torch.Generator(), epochs=1, steps_per_epoch=1000,
                              on_step=lambda s, t: losses.append(float(t.total)))
    fixture["steps/losses"] = np.asarray(losses)
    fixture.update(flatten_tree(convert.tree_to_jax(steps.trainable), "steps/after3"))
    fixture["steps/bn_mean"] = steps.bn_state.mean.cpu().numpy()
    fixture["steps/bn_var"] = steps.bn_state.var.cpu().numpy()
    return fixture


def hold_tiny_pipeline(held: Held, fixture: Dict[str, np.ndarray], want: Dict[str, np.ndarray]) -> None:
    """``tiny_pipeline.npz`` against another, at tests/test_golden.py's
    tolerances."""
    name = "tiny_pipeline.npz"
    held.close(f"{name} ncentroid", fixture["ncentroid"], want["ncentroid"], TOL["ncentroid"])
    for key in ("logits", "logits_topk", "scores"):
        held.close(f"{name} train/{key}", fixture[f"train/{key}"], want[f"train/{key}"], TOL["train"])
    for key in ("idx_topk_abn", "idx_topk_nor", "idx_bottomk_abn"):
        held.close(f"{name} train/{key}", fixture[f"train/{key}"], want[f"train/{key}"], TOL["tokens"])
    for key in ("train/bn_mean", "train/bn_var"):
        held.close(f"{name} {key}", fixture[key], want[key], TOL["bn"])
    held.close(f"{name} train/loss_terms", fixture["train/loss_terms"], want["train/loss_terms"],
               TOL["loss_terms"])
    held.close(f"{name} eval/labels", fixture["eval/labels"], want["eval/labels"], TOL["tokens"])
    for key in ("eval/abnormal_scores", "eval/class_probs"):
        held.close(f"{name} {key}", fixture[key], want[key], TOL["eval"])
    held.close(f"{name} eval/metrics", fixture["eval/metrics"], want["eval/metrics"], TOL["eval_metrics"])
    held.close(f"{name} steps/losses", fixture["steps/losses"], want["steps/losses"], TOL["step_losses"])
    after = "steps/after3/"
    held.trainables(f"{name} steps/after3", {k: v for k, v in fixture.items() if k.startswith(after)},
                    {k: v for k, v in want.items() if k.startswith(after)})
    for key in ("steps/bn_mean", "steps/bn_var"):
        held.close(f"{name} {key}", fixture[key], want[key], TOL["step_bn"])


def gen_tiny(out: Path, held: Held, device: str, against: Optional[Path] = None, ckpt: Optional[Path] = None,
             state_file: Optional[Path] = None) -> Dict[str, np.ndarray]:
    """``tiny_state.npz`` from ``ckpt`` (when given) and ``tiny_pipeline.npz``
    from that state or from ``state_file`` (default the committed one)."""
    from anomalyclip_tpu_torch.models.anomaly_clip import read_classnames

    with tempfile.TemporaryDirectory(prefix="gen_golden_tiny_") as tmp:
        root = Path(tmp)
        if ckpt is not None:
            cfg = synthetic_config(root)
            state_flat = tiny_state_from_ckpt(ckpt, read_classnames(cfg["model"]["net"]["labels_file"]))
            np.savez_compressed(out / "tiny_state.npz", **state_flat)
            want = _against(against, "tiny_state.npz")
            if want is not None:
                held.require("tiny_state.npz keys", set(state_flat) == set(want),
                             f"{sorted(set(state_flat) ^ set(want))}")
                for key in sorted(set(state_flat) & set(want)):
                    held.close(f"tiny_state.npz {key}", state_flat[key], want[key], TOL["tokens"])
            print(f"tiny_state.npz: {len(state_flat)} arrays from {ckpt}", flush=True)
        else:
            state_flat = _load(state_file or GOLDEN_DIR / "tiny_state.npz")
        fixture = tiny_pipeline(state_flat, device, root)
    np.savez_compressed(out / "tiny_pipeline.npz", **fixture)
    want = _against(against, "tiny_pipeline.npz")
    if want is not None:
        hold_tiny_pipeline(held, fixture, want)
    print(f"tiny_pipeline.npz: AUC={fixture['eval/metrics'][0]:.4f} losses={fixture['steps/losses'].tolist()}",
          flush=True)
    return fixture


# ---------------------------------------------------------------------------
# metrics.npz
# ---------------------------------------------------------------------------


def metrics_corpus():
    """The seeded score corpus: (scores, labels, class_probs, normal_id, num_classes)."""
    rng = np.random.default_rng(5)
    t, num_classes, normal_id = 4096, 7, 4
    labels = rng.integers(0, num_classes, size=t).astype(np.int64)
    is_abn = labels != normal_id
    # scores correlated with the binary label so that the curves are not degenerate
    scores = np.clip(rng.normal(0.35 + 0.3 * is_abn, 0.25), 0.0, 1.0).astype(np.float32)
    raw = rng.standard_normal((t, num_classes - 1)).astype(np.float32)
    raw[np.arange(t), np.minimum(labels, num_classes - 2)] += 1.0
    e = np.exp(raw - raw.max(axis=1, keepdims=True))
    class_probs = (e / e.sum(axis=1, keepdims=True)) * scores[:, None]
    return scores, labels, class_probs, normal_id, num_classes


def gen_metrics(out: Path, held: Held, against: Optional[Path] = None) -> Dict[str, np.ndarray]:
    from anomalyclip_tpu_torch.eval.metrics import detection_metrics

    scores, labels, class_probs, normal_id, num_classes = metrics_corpus()
    det = detection_metrics(scores, labels, class_probs, normal_id, num_classes)
    fixture = dict(
        scores=scores, labels=labels, class_probs=class_probs, normal_id=np.asarray(normal_id),
        num_classes=np.asarray(num_classes),
        expected=np.asarray([det["auc_roc"], det["auc_pr"], det["mean_mc_auroc"], det["mean_mc_aupr"],
                             det["optimal_threshold"]]),
        mc_auroc=np.asarray(det["mc_auroc"]), mc_aupr=np.asarray(det["mc_aupr"]),
    )
    np.savez_compressed(out / "metrics.npz", **fixture)
    try:
        from sklearn.metrics import average_precision_score, roc_auc_score
    except ImportError:
        print("metrics.npz: scikit-learn does not import here; its check did not run", flush=True)
    else:
        is_abn = labels != normal_id
        per_class = [roc_auc_score(labels == c, det["class_probs_full"][:, c])
                     for c in range(num_classes) if c != normal_id and np.any(labels == c)]
        held.close("metrics.npz auc_roc vs scikit-learn", det["auc_roc"], roc_auc_score(is_abn, scores),
                   (0.0, 1e-10))
        held.close("metrics.npz auc_pr vs scikit-learn", det["auc_pr"], average_precision_score(is_abn, scores),
                   (0.0, 1e-10))
        held.close("metrics.npz mean_mc_auroc vs scikit-learn", det["mean_mc_auroc"], np.mean(per_class),
                   (0.0, 1e-10))
        print("metrics.npz: held against scikit-learn", flush=True)
    want = _against(against, "metrics.npz")
    if want is not None:
        for key in ("scores", "labels", "class_probs", "normal_id", "num_classes"):
            held.close(f"metrics.npz {key}", fixture[key], want[key], TOL["tokens"])
        for key in ("expected", "mc_auroc", "mc_aupr"):
            held.close(f"metrics.npz {key}", fixture[key], want[key], TOL["metrics"])
    print(f"metrics.npz: AUC={det['auc_roc']:.6f} AP={det['auc_pr']:.6f}", flush=True)
    return fixture


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------


def clip_b16_params(clip_file: Optional[Path], device: str):
    """The ViT-B/16 tree from an OpenAI-layout file, else the port's seeded
    init (seed 0) -> (params on ``device``, cfg)."""
    from anomalyclip_tpu_torch.convert import tree_to
    from anomalyclip_tpu_torch.models.clip.model import CLIPConfig, init_clip_params
    from anomalyclip_tpu_torch.models.clip.convert import load_torch_clip_checkpoint

    if clip_file is not None:
        params, cfg = load_torch_clip_checkpoint(clip_file)
    else:
        cfg = CLIPConfig.vit_b16()
        params = init_clip_params(torch.Generator().manual_seed(0), cfg)
    return tree_to(params, device), cfg


def main(argv=None) -> Held:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True, type=Path, help="directory the fixtures are written to")
    ap.add_argument("--only", nargs="*", default=None, choices=WRITERS)
    ap.add_argument("--against", default=GOLDEN_DIR, type=Path,
                    help="directory of the fixtures each written one is held against")
    ap.add_argument("--clip-file", type=Path, default=None,
                    help="ViT-B/16 weights in OpenAI's layout (default: the port's seeded init)")
    source = ap.add_mutually_exclusive_group()
    source.add_argument("--tiny-ckpt", type=Path, default=None,
                        help="reference Lightning .ckpt: writes tiny_state.npz from it")
    source.add_argument("--tiny-state", type=Path, default=None,
                        help="tiny_state.npz the pipeline is computed from (default: the committed one)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"], help="cpu: every writer on the CPU")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("gen_golden: no CUDA device (--device cpu runs every writer on the CPU)")
    if args.out.resolve() == GOLDEN_DIR.resolve():
        raise SystemExit(f"gen_golden: --out is the committed fixtures' directory {GOLDEN_DIR}; write elsewhere "
                         "and hold them against it")
    args.out.mkdir(parents=True, exist_ok=True)
    wanted = args.only or list(WRITERS)
    held = Held()
    if "tokenizer" in wanted:
        gen_tokenizer(args.out, held, args.against)
    if "clip_b16" in wanted:
        params, cfg = clip_b16_params(args.clip_file, args.device)
        gen_clip_b16(args.out, held, params, cfg, args.device, args.against)
    if "tiny" in wanted:
        gen_tiny(args.out, held, args.device, args.against, args.tiny_ckpt, args.tiny_state)
    if "metrics" in wanted:
        gen_metrics(args.out, held, args.against)
    print(f"gen_golden: {held.count} comparisons against {args.against}, {len(held.misses)} missed", flush=True)
    if held.misses:
        for miss in held.misses:
            print(f"  MISS {miss}", file=sys.stderr, flush=True)
        raise SystemExit(1)
    return held


if __name__ == "__main__":
    main()
