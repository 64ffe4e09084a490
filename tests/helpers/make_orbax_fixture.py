"""Write the Orbax checkpoints of ``tests/fixtures/orbax/`` with the JAX package,
and the JSON that describes them.

    JAX_PLATFORMS=cpu python tests/helpers/make_orbax_fixture.py [out_dir]

The fixture is what the port reads on a machine without JAX (``chip_smoke.py``
phase 4l) and what ``tests/test_torch_orbax.py`` holds against the JAX package:

- ``fit/checkpoints/epoch_000/``: one epoch of the synthetic experiment
  (``FIT_OVERRIDES``: ``emb_size`` 16, dropout 0, no warmup) on a seeded CLIP of
  ViT-B/16's text width, written by the JAX ``CheckpointManager`` with its
  optimizer state, and ``fit/ncentroid.npy`` beside it, as a run leaves them;
- ``converted/``: ``anomalyclip_tpu.convert_ckpt.main`` of a reference
  Lightning ``.ckpt`` of the same prompt width (trainable tree and BN state,
  no optimizer state, epoch -1);
- ``fixture.json``: the CLIP's config and seed, the overrides, every leaf's
  dtype, shape and sha256 in both directories, the JAX package's test metrics
  of the fit checkpoint, and its per-epoch losses of one epoch resumed from it.

No ``last`` symlink is written: a reader makes one in a copy. The CLIP keeps
ViT-B/16's text tower width (512, so the prompt context is 512 wide) at one
layer, and a joint embedding of 64 (ViT-B/16's is 512), so that the fit's
text projection and its two moments stay small; the frames are never encoded
(the synthetic set is features).
"""

from __future__ import annotations

import csv
import hashlib
import importlib.util
import json
import os
import shutil
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]

CLIP_SEED = 0
# ViT-B/16's text tower width and heads, at one layer; a 64-wide joint embedding
FIXTURE_CLIP = dict(embed_dim=64, image_resolution=224, vision_layers=1, vision_width=768,
                    vision_patch_size=16, context_length=77, vocab_size=49408,
                    transformer_width=512, transformer_heads=8, transformer_layers=1)
# the temporal model at 16 wide in one head of 16, a head dim the attention
# kernels take (the synthetic experiment's 8 heads would give heads of 2)
FIT_OVERRIDES = ("model.net.emb_size=16", "model.net.heads=1", "model.net.select_idx_dropout_topk=0.0",
                 "model.net.select_idx_dropout_bottomk=0.0", "model.scheduler.warmup_epochs=0",
                 "data.num_workers=0", "model.net.clip_init=pretrained")
METRICS = ("auc_roc", "auc_pr", "mean_mc_auroc", "mean_mc_aupr")
LOSSES = ("train/loss", "train/dir_abn_loss", "train/dir_nor_loss", "train/topk_abn_loss",
          "train/bottomk_abn_loss", "train/topk_nor_loss", "train/smooth_loss", "train/sparse_loss")


def load_by_path(name: str, path: Path):
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def write_clip_file(path: Path) -> Path:
    """The seeded CLIP of ``FIXTURE_CLIP`` in OpenAI's layout, fp16, as
    ``chip_smoke.seeded_clip_state_dict`` draws it."""
    import torch

    from anomalyclip_tpu_torch.models.clip.model import CLIPConfig

    chip_smoke = load_by_path("_orbax_fixture_chip_smoke", ROOT / "chip_smoke.py")
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(chip_smoke.seeded_clip_state_dict(CLIPConfig(**FIXTURE_CLIP), CLIP_SEED), path)
    return path


def config_overrides(clip_file: Path, *extra: str) -> list:
    return ["experiment=synthetic", *FIT_OVERRIDES, f"model.net.clip_ckpt_path={clip_file}", *extra]


def jax_cfg(work: Path, clip_file: Path, *extra: str):
    """The JAX package's composed train config rooted in ``work``."""
    from anomalyclip_tpu.config import compose

    synthetic_run = load_by_path("_orbax_fixture_synthetic_run", ROOT / "tests" / "helpers" / "synthetic_run.py")
    saved = {k: os.environ.get(k) for k in ("PROJECT_ROOT", "SYNTHETIC_ROOT", "LOG_DIR")}
    os.environ.update(PROJECT_ROOT=str(ROOT), SYNTHETIC_ROOT=str(work / "synthetic"), LOG_DIR=str(work / "logs"))
    try:
        return compose(synthetic_run.REPO_ROOT / "configs", "train", config_overrides(clip_file, *extra))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def jax_fit(work: Path, clip_file: Path, epochs: int, ckpt_path=None) -> Path:
    """A JAX fit of ``epochs`` epochs (resumed from ``ckpt_path``) -> its run dir."""
    from anomalyclip_tpu.train.module import AnomalyCLIPTrainModule

    extra = [f"trainer.max_epochs={epochs}"] + ([f"ckpt_path={ckpt_path}"] if ckpt_path else [])
    module = AnomalyCLIPTrainModule(jax_cfg(work, clip_file, *extra))
    module.fit()
    return Path(module.save_dir)


def jax_test_metrics(work: Path, clip_file: Path, ckpt_path: Path) -> dict:
    """The JAX module's test pass on ``ckpt_path`` -> its four metrics."""
    from anomalyclip_tpu.train.module import AnomalyCLIPTrainModule

    module = AnomalyCLIPTrainModule(jax_cfg(work, clip_file))
    metrics = module.test(ckpt_path=str(ckpt_path))
    return {k: float(metrics[k]) for k in METRICS}


def epoch_losses(run_dir: Path) -> dict:
    """{epoch: {loss name: value}} from a run's ``csv/metrics.csv``."""
    rows = list(csv.DictReader(open(run_dir / "csv" / "metrics.csv")))
    return {int(r["step"]): {k: float(r[k]) for k in LOSSES} for r in rows if r.get("train/loss")}


def restored_leaves(path: Path) -> dict:
    """``orbax.checkpoint.StandardCheckpointer().restore(path)`` (what the JAX
    ``CheckpointManager.restore`` reads, before it rebuilds the BN state) ->
    {"/"-joined key path: leaf}, empty nodes as None."""
    import jax
    import orbax.checkpoint as ocp

    tree = ocp.StandardCheckpointer().restore(Path(path).resolve())
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: x is None)
    out = {}
    for keys, leaf in flat:
        name = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in keys)
        out[name] = None if leaf is None else np.asarray(leaf)
    return out


def leaf_record(leaf) -> dict:
    if leaf is None:
        return {"dtype": "None"}
    data = np.ascontiguousarray(leaf)  # at least one dimension, the same bytes
    return {"dtype": str(data.dtype), "shape": list(np.shape(leaf)),
            "sha256": hashlib.sha256(data.tobytes()).hexdigest()}


def write_converted(work: Path, like: Path, out_dir: Path) -> Path:
    """A reference Lightning ``.ckpt`` of ``FIXTURE_CLIP`` with the trainable
    shapes of the checkpoint ``like``, its weights drawn as
    test_torch_entry.py's ``_lightning_state`` draws them, through the JAX
    package's ``convert_ckpt.main`` into ``out_dir``."""
    import torch

    from anomalyclip_tpu.convert_ckpt import main as convert_main
    from anomalyclip_tpu_torch.models.clip.model import CLIPConfig

    entry = load_by_path("_orbax_fixture_entry", ROOT / "tests" / "test_torch_entry.py")
    leaves = restored_leaves(like)
    shapes = {"prompt_ctx": leaves["trainable/prompt_ctx"].shape,
              "input": leaves["trainable/temporal/projection/w"].shape[0],
              "emb": leaves["trainable/temporal/projection/w"].shape[1],
              "output": leaves["trainable/temporal/head/w"].shape[1]}
    work.mkdir(parents=True, exist_ok=True)
    ckpt = work / "released.ckpt"
    torch.save({"state_dict": entry._lightning_state(shapes, CLIPConfig(**FIXTURE_CLIP)), "epoch": 7}, str(ckpt))
    convert_main([str(ckpt), str(out_dir)])
    return out_dir


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    out = Path(argv[0]) if argv else ROOT / "tests" / "fixtures" / "orbax"
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        clip_file = write_clip_file(tmp / "clip.pt")
        run = jax_fit(tmp / "fit", clip_file, epochs=1)
        if out.exists():
            shutil.rmtree(out)
        fit = out / "fit"
        shutil.copytree(run / "checkpoints" / "epoch_000", fit / "checkpoints" / "epoch_000")
        shutil.copy(run / "ncentroid.npy", fit / "ncentroid.npy")
        epoch_dir = fit / "checkpoints" / "epoch_000"
        write_converted(tmp / "convert", epoch_dir, out / "converted")
        metrics = jax_test_metrics(tmp / "test", clip_file, epoch_dir)
        resumed = jax_fit(tmp / "resume", clip_file, epochs=2, ckpt_path=epoch_dir)
        record = {
            "clip": {"config": FIXTURE_CLIP, "seed": CLIP_SEED},
            "overrides": list(FIT_OVERRIDES),
            "leaves": {name: {k: leaf_record(v) for k, v in restored_leaves(path).items()}
                       for name, path in (("fit", epoch_dir), ("converted", out / "converted"))},
            "jax_test_metrics": metrics,
            "jax_resumed_losses": epoch_losses(resumed)[1],
        }
        (out / "fixture.json").write_text(json.dumps(record, indent=1, sort_keys=True) + "\n")
    size = sum(p.stat().st_size for p in out.rglob("*") if p.is_file())
    print(f"wrote {out} ({size:,} bytes)")


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    main()
