"""The port's visualizer (anomalyclip_tpu_torch/eval/visualizer.py), on the CPU:
ports of the four tests of tests/test_visualizer.py, ``test()`` with
``data.visualize=True`` handing every video's scores to it, and predict's
``visualize=true`` rendering a frames directory's mp4."""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import pytest

from anomalyclip_tpu_torch.eval.evaluator import VideoScores
from anomalyclip_tpu_torch.eval.visualizer import Visualizer

cv2 = pytest.importorskip("cv2")

ROOT = Path(__file__).resolve().parents[1]
LABELS = ROOT / "anomalyclip_tpu" / "labels" / "synthetic_labels.csv"


def _fake_scores(t: int, n_abn: int, path: str) -> VideoScores:
    rng = np.random.default_rng(0)
    sim = rng.standard_normal((t, n_abn)).astype(np.float32)
    sc = rng.uniform(size=t).astype(np.float32)
    e = np.exp(sim - sim.max(axis=1, keepdims=True))
    probs = e / e.sum(axis=1, keepdims=True) * sc[:, None]
    labels = np.zeros(t, dtype=np.int64)
    labels[t // 2:] = 1  # an anomalous second half: the GT shading
    return VideoScores(similarity=sim, scores=sc, class_probs=probs, frame_labels=labels, video_label=1, path=path)


def _frames(directory: Path, ids, seed: int) -> Path:
    directory.mkdir()
    rng = np.random.default_rng(seed)
    for i in ids:
        cv2.imwrite(str(directory / f"{i:06d}.jpg"), rng.integers(0, 255, size=(32, 48, 3), dtype=np.uint8))
    return directory


def test_process_video_without_frames_skips(tmp_path):
    """A features-only run: no JPEG dir, so no mp4 and a warning."""
    viz = Visualizer(normal_id=3, labels_file=str(LABELS), save_dir=tmp_path, frame_step=16)
    viz.process_video(_fake_scores(t=48, n_abn=5, path=str(tmp_path / "video01.npy")))
    assert not (tmp_path / "visualizations" / "video01.mp4").exists()


def _decoded(path: Path) -> list:
    cap = cv2.VideoCapture(str(path))
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    cap.release()
    return frames


def test_process_video_with_frames(tmp_path):
    """Frames present (0-based ids): an mp4 of ceil(32 / 8) frames, the JAX
    package's Visualizer's frames on the same scores."""
    from anomalyclip_tpu.eval.evaluator import VideoScores as JaxVideoScores
    from anomalyclip_tpu.eval.visualizer import Visualizer as JaxVisualizer

    frames_dir = _frames(tmp_path / "video02", range(32), 1)
    viz = Visualizer(normal_id=3, labels_file=str(LABELS), save_dir=tmp_path, frame_step=8)
    vs = _fake_scores(t=32, n_abn=5, path=str(frames_dir))
    viz.process_video(vs)
    out = tmp_path / "visualizations" / "video02.mp4"
    assert out.is_file() and out.stat().st_size > 0
    got = _decoded(out)
    assert len(got) == 4
    JaxVisualizer(normal_id=3, labels_file=str(LABELS), save_dir=tmp_path / "jax", frame_step=8).process_video(
        JaxVideoScores(**dataclasses.asdict(vs)))
    want = _decoded(tmp_path / "jax" / "visualizations" / "video02.mp4")
    assert len(want) == len(got) and all(np.array_equal(a, b) for a, b in zip(got, want))


def test_default_frame_step_renders_every_frame(tmp_path):
    """The reference renders every frame: the default step is 1."""
    frames_dir = _frames(tmp_path / "video03", range(12), 2)
    viz = Visualizer(normal_id=3, labels_file=str(LABELS), save_dir=tmp_path)
    assert viz.frame_step == 1
    assert Visualizer(normal_id=3, labels_file=str(LABELS), save_dir=tmp_path, frame_step=0).frame_step == 1
    vs = _fake_scores(t=12, n_abn=5, path=str(frames_dir))
    viz.process_video(vs)
    cap = cv2.VideoCapture(str(tmp_path / "visualizations" / "video03.mp4"))
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == len(vs.scores)
    cap.release()


def test_frame_lookup_honors_start_frame(tmp_path, monkeypatch):
    """The panel of score index i shows file i + start_frame (1-based corpora)."""
    t = 8
    frames_dir = _frames(tmp_path / "video04", range(1, t + 1), 3)
    seen = []
    real_imread = cv2.imread
    monkeypatch.setattr(cv2, "imread", lambda p, *a: (seen.append(p), real_imread(p, *a))[1])
    viz = Visualizer(normal_id=3, labels_file=str(LABELS), save_dir=tmp_path)
    viz.process_video(dataclasses.replace(_fake_scores(t=t, n_abn=5, path=str(frames_dir)), start_frame=1))
    names = [p.split("/")[-1] for p in seen]
    assert names[0] == "000001.jpg" and names[-1] == f"{t:06d}.jpg" and len(names) == t


def test_test_pass_hands_every_video_to_the_visualizer(tmp_path, monkeypatch):
    """``data.visualize=True``: ``test()`` builds a Visualizer from the data
    config and calls ``process_video`` on each test video's scores."""
    from anomalyclip_tpu_torch.config import to_dict
    from anomalyclip_tpu_torch.eval import visualizer
    from anomalyclip_tpu_torch.train.module import AnomalyCLIPTrainModule

    helpers = _load("_torch_fit_helpers", ROOT / "tests" / "helpers" / "synthetic_run.py")
    cfg = helpers.synthetic_cfg(tmp_path, "data.num_workers=0", "data.visualize=true",
                                "data.visualize_frame_step=4", f"paths.output_dir={tmp_path / 'run'}")
    module = AnomalyCLIPTrainModule(to_dict(cfg), device="cpu")
    made, seen = [], []
    real_init = visualizer.Visualizer.__init__

    def init(self, *args, **kwargs):
        real_init(self, *args, **kwargs)
        made.append(self)

    monkeypatch.setattr(visualizer.Visualizer, "__init__", init)
    monkeypatch.setattr(visualizer.Visualizer, "process_video", lambda self, vs: seen.append(vs))
    metrics = module.test(state=module.init_state(1), limit=3)
    assert np.isfinite(metrics["auc_roc"])
    assert len(made) == 1 and made[0].frame_step == 4 and made[0].save_dir == module.save_dir / "visualizations"
    assert len(seen) == 3 and all(isinstance(vs, VideoScores) for vs in seen)
    assert [vs.path for vs in seen] == [item.path for item in module.datamodule.test_dataloader(limit=3)]


def test_predict_visualize_renders_a_frames_dir(tmp_path, monkeypatch):
    from anomalyclip_tpu_torch import predict

    helpers = _load("_torch_serving_helpers", ROOT / "tests" / "helpers" / "torch_serving.py")
    s = helpers.serving_setup(tmp_path, monkeypatch)
    predict.main(s.common + [f"input={s.frames}", f"ncentroid_path={s.ncentroid}", "trainer=cpu", "visualize=true",
                             "data.visualize_frame_step=10", f"paths.output_dir={tmp_path / 'out'}"])
    out = tmp_path / "out" / "visualizations" / "clip_frames.mp4"
    assert out.is_file()
    cap = cv2.VideoCapture(str(out))
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 4  # 40 frames, every 10th
    cap.release()


def _load(name: str, path: Path):
    import importlib.util
    import sys

    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, path)
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module
        spec.loader.exec_module(module)
    return sys.modules[name]
