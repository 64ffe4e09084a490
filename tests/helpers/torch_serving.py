"""Shared set-up of the serving tests of the port (tests/test_torch_predict.py,
test_torch_serve.py, test_torch_export.py, test_torch_visualizer.py): a
Lightning ``.ckpt`` with a tiny CLIP built here (the pattern of
tests/test_torch_entry.py's ``lightning_ckpt``), the synthetic set it is
scored with, and seeded inputs in the three forms predict takes. Loaded by
path: an installed package named ``tests`` may shadow this repository's."""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
# the eval-side groups every serving CLI composes
GROUPS = ["data=synthetic", "model=anomaly_clip_synthetic", "extras.print_config=False", "data.num_workers=0"]


def load_by_path(name: str, path: Path):
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def write_frames(directory: Path, n: int, rng: np.random.Generator, size=(40, 48)) -> Path:
    """``n`` 1-based JPEG frames of ``size`` (h, w)."""
    from PIL import Image

    directory.mkdir(parents=True)
    for i in range(1, n + 1):
        Image.fromarray(rng.integers(0, 256, size=(*size, 3), dtype=np.uint8)).save(
            directory / f"{i:06d}.jpg", quality=95)
    return directory


def write_video(path: Path, n: int, rng: np.random.Generator) -> Path:
    import cv2

    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), 10, (48, 32))
    assert writer.isOpened()
    for _ in range(n):
        writer.write(rng.integers(0, 256, size=(32, 48, 3), dtype=np.uint8))
    writer.release()
    return path


def serving_setup(tmp: Path, monkeypatch, clip_cfg=None) -> SimpleNamespace:
    """Under ``tmp``: the synthetic set (``SYNTHETIC_ROOT``), a reference
    Lightning checkpoint ``run/checkpoints/released.ckpt`` with a tiny CLIP of
    32-pixel frames (``clip_cfg``, default test_torch_entry.py's
    ``CKPT_CLIP``), a seeded ncentroid file, and the inputs: a (70, 64)
    feature ``.npy``, a 40-frame JPEG directory and a 24-frame video file.
    ``monkeypatch`` keeps the environment set for the compositions."""
    from anomalyclip_tpu_torch.config import compose, default_config_dir, to_dict
    from anomalyclip_tpu_torch.train.module import AnomalyCLIPTrainModule

    entry = load_by_path("_torch_serving_entry", ROOT / "tests" / "test_torch_entry.py")
    monkeypatch.setenv("PROJECT_ROOT", str(ROOT))
    monkeypatch.setenv("SYNTHETIC_ROOT", str(tmp / "synthetic"))
    monkeypatch.setenv("ANOMALYCLIP_NO_DOWNLOAD", "1")
    for var in ("ANOMALYCLIP_CONFIG_DIR", "CLIP_CKPT_PATH", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    cfg = to_dict(compose(default_config_dir(), "eval", GROUPS + [f"paths.log_dir={tmp / 'shapes'}"]))
    module = AnomalyCLIPTrainModule(cfg, device="cpu")  # writes the synthetic set
    trainable, _ = module.model.init_trainable(torch.Generator().manual_seed(0), module.frozen)
    shapes = {"prompt_ctx": tuple(trainable["prompt_ctx"].shape),
              "input": trainable["temporal"]["projection"]["w"].shape[0],
              "emb": trainable["temporal"]["projection"]["w"].shape[1],
              "output": trainable["temporal"]["head"]["w"].shape[1]}
    ckpt = tmp / "run" / "checkpoints" / "released.ckpt"
    ckpt.parent.mkdir(parents=True)
    torch.save({"state_dict": entry._lightning_state(shapes, clip_cfg or entry.CKPT_CLIP), "epoch": 7}, str(ckpt))

    rng = np.random.default_rng(11)
    ncentroid = tmp / "ncentroid_explicit.npy"
    np.save(ncentroid, (0.1 * rng.standard_normal(entry.CKPT_CLIP.embed_dim)).astype(np.float32))
    npy = tmp / "inputs" / "cam.npy"
    npy.parent.mkdir()
    np.save(npy, rng.standard_normal((70, entry.CKPT_CLIP.embed_dim)).astype(np.float32))
    frames = write_frames(tmp / "inputs" / "clip_frames", 40, rng)
    video = write_video(tmp / "inputs" / "clip.avi", 24, rng)
    common = GROUPS + [f"ckpt_path={ckpt}"]
    return SimpleNamespace(tmp=tmp, ckpt=ckpt, ncentroid=ncentroid, npy=npy, frames=frames, video=video,
                           common=common, entry=entry)
