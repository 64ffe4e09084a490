"""Inference on an arbitrary video: per-frame anomaly scores and class
predictions. The counterpart of anomalyclip_tpu/predict.py: any input goes
through the evaluator's ``GridScorer`` and ``score_video``, so a prediction is
the test pass's score of the same frames.

    python -m anomalyclip_tpu_torch.predict model=anomaly_clip_ucfcrime data=ucfcrime \\
        model.net.clip_ckpt_path=<ViT-B-16.pt> ckpt_path=<port checkpoint dir | released.ckpt> \\
        input=<video.mp4 | frames_dir | feats.npy> [output=predictions.json] \\
        [ncentroid_path=...] [visualize=true] [trainer=cpu]

Input forms:
  * a video file       — decoded with OpenCV, CLIP-preprocessed per frame
  * a frames directory — ``{:06d}.jpg`` files (``data.image_tmpl``), 1-based
  * a ``.npy`` file    — pre-extracted CLIP features (single- or ``data.ncrops``-crop)

Decoding (cv2, PIL) imports inside the functions that decode: the card's
machine has neither, and there the features and uint8 frames already decoded
are what predict takes. The normality centroid resolves from
``ncentroid_path=``, else ``ncentroid.npy`` beside the checkpoint's run dir,
else it is computed from the configured training data. The device is the card
unless ``trainer=cpu`` or ``trainer.accelerator=cpu`` asks for the CPU
(``train_entry.choose_device``).

Artifact mode scores from an exported serving artifact (export.py): no config
tree, model or checkpoint; the artifact's graphs and meta are the contract:

    python -m anomalyclip_tpu_torch.predict artifact=<dir> input=<video | frames | .npy> \\
        [output=...] [ncrops=1] [image_tmpl={:06d}.jpg] [fast_decode=false] [trainer=cpu]

``Predictor`` is the same scoring on a model and its state already in memory,
for callers that hold decoded frames.
"""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from anomalyclip_tpu_torch.eval.grids import prediction_result

VIDEO_EXTS = {".mp4", ".avi", ".mkv", ".mov", ".webm"}


def _decode_video_file(path: Path, input_size: int) -> np.ndarray:
    """Video file -> (T, S, S, 3) uint8, CLIP spatial preprocessing per frame.

    Frames stay uint8 (the encoder normalizes them, ``encode_frames_chunked``),
    so a long video costs S*S*3 bytes a frame of host memory."""
    import cv2
    from PIL import Image

    from anomalyclip_tpu_torch.data.sources import spatial_frame

    cap = cv2.VideoCapture(str(path))
    if not cap.isOpened():
        raise FileNotFoundError(f"cannot open video: {path}")
    # the frame count is an estimate: preallocate when there is one, and
    # spill to a list if it undercounts
    hint = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    buf = np.empty((hint, input_size, input_size, 3), np.uint8) if hint > 0 else None
    extra = []
    t = 0
    while True:
        ok, bgr = cap.read()
        if not ok:
            break
        frame = spatial_frame(Image.fromarray(cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)), input_size)
        if buf is not None and t < len(buf):
            buf[t] = frame
        else:
            extra.append(frame)
        t += 1
    cap.release()
    if t == 0:
        raise ValueError(f"no frames decoded from {path}")
    if buf is None:
        return np.stack(extra)
    if extra:
        return np.concatenate([buf, np.stack(extra)])
    return buf[:t]


def input_start_frame(path: str | Path) -> int:
    """File id of score index 0 for this input: frames directories are 1-based
    (``count_frames`` walks 1-based ids); ``.npy`` and video inputs have no
    frame files. One definition: ``_load_input``'s gather and the visualizer's
    frame panels must agree, or every panel lags its score."""
    return 1 if Path(path).is_dir() else 0


def _load_input(path: Path, data_cfg, input_size: int) -> np.ndarray:
    """-> (ncrops, T, ...) features or uint8 frames, the evaluator's layout.
    ``input_size`` is the model's CLIP image resolution; 0 (an artifact
    without an encoder) takes ``.npy`` features only."""
    from anomalyclip_tpu_torch.data.records import VideoRecord
    from anomalyclip_tpu_torch.data.sources import FrameSource, count_frames

    if path.suffix == ".npy":
        feats = np.asarray(np.load(path), dtype=np.float32)
        ncrops = int(data_cfg.get("ncrops", 1))
        return feats.reshape(-1, ncrops, feats.shape[-1]).transpose(1, 0, 2)
    if not input_size:
        raise ValueError(
            f"raw-frame input {path} needs an encoder — export the artifact "
            "with include_encoder=true (feature .npy inputs work without it)"
        )
    if path.is_dir():
        tmpl = data_cfg.get("image_tmpl", "{:06d}.jpg")
        n = count_frames(path, tmpl)
        if n == 0:
            raise FileNotFoundError(f"no {tmpl} frames under {path}")
        src = FrameSource(
            input_size=input_size,
            image_tmpl=tmpl,
            ncrops=int(data_cfg.get("ncrops", 1)),
            fast_decode=bool(data_cfg.get("fast_decode", False)),
        )
        rec = VideoRecord(
            rel_path=path.name, start_frame=input_start_frame(path),
            end_frame=n, label=0, root=str(path.parent),
        )
        # decode on a pool: cv2 and PIL release the GIL
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=min(32, os.cpu_count() or 1)) as pool:
            return src.gather(rec, np.arange(n), pool=pool)
    if path.suffix.lower() in VIDEO_EXTS:
        return _decode_video_file(path, input_size)[None]
    raise ValueError(f"unrecognized input: {path} (video file, frames dir, or .npy)")


def _resolve_ncentroid(cfg, ckpt_path: str) -> Optional[np.ndarray]:
    """``ncentroid_path=``, else ``ncentroid.npy`` beside the run dir of
    ``ckpt_path`` (train runs save it beside <run>/checkpoints/<name>) or
    beside the checkpoint itself, else None."""
    explicit = cfg.get("ncentroid_path")
    if explicit:
        return np.load(explicit).astype(np.float32)
    for cand in (
        Path(ckpt_path).parent.parent / "ncentroid.npy",
        Path(ckpt_path).parent / "ncentroid.npy",
    ):
        if cand.is_file():
            return np.load(cand).astype(np.float32)
    return None


def load_module_and_state(cfg: dict, device: str):
    """Build the train module on ``device``, restore the checkpoint, resolve the
    ncentroid: the common bootstrap of the predict, serve and export CLIs.
    ``cfg`` is the composed config as a plain dict. -> (module, state)"""
    from anomalyclip_tpu_torch.train.module import AnomalyCLIPTrainModule

    ckpt_path = cfg["ckpt_path"]
    module = AnomalyCLIPTrainModule(cfg, device=device)
    state = module.load_state(ckpt_path)
    ncentroid = _resolve_ncentroid(cfg, ckpt_path)
    if ncentroid is not None:
        module.ncentroid = ncentroid
    else:
        module.compute_ncentroid()
    return module, state


def artifact_data_cfg(kv: dict) -> dict:
    """Input-loading options of the config-free artifact mode (the predict and
    serve CLIs)."""
    return {
        "ncrops": int(kv.get("ncrops", 1)),
        "image_tmpl": kv.get("image_tmpl", "{:06d}.jpg"),
        "fast_decode": str(kv.get("fast_decode", "false")).lower() in ("true", "1"),
    }


def artifact_bootstrap(kv: dict, device: str):
    """The artifact-mode start of the predict and serve CLIs: load the artifact
    on ``device``. ``compile_cache`` and ``compile_cache_dir`` are accepted and
    read by nothing (the JAX package's XLA cache has no counterpart).
    -> (ServingArtifact, data_cfg)"""
    from anomalyclip_tpu_torch.export import ServingArtifact

    return ServingArtifact.load(kv["artifact"], device=device), artifact_data_cfg(kv)


def join_group(device: str) -> str:
    """Join the ``torch.distributed`` group that ``WORLD_SIZE`` describes, if
    any (parallel/mesh.py; torchrun's ranks, or ranks started by hand) ->
    ``device``. In a group every rank scores the input, through its shard of the
    tensor-parallel tower under ``trainer.model_parallel``, and rank 0 writes."""
    from anomalyclip_tpu_torch.parallel.mesh import init_distributed

    init_distributed(device=device)
    return device


def cli_device(argv) -> str:
    """The device of an entry point run without a composed config (artifact
    mode): the card unless ``trainer=cpu`` or ``trainer.accelerator=cpu``."""
    from anomalyclip_tpu_torch.train_entry import choose_device

    return join_group(choose_device(argv, {}))


def _emit_result(result: dict, out) -> None:
    """Write the predictions dict to ``output=`` or print the summary keys."""
    if out:
        Path(out).parent.mkdir(parents=True, exist_ok=True)
        Path(out).write_text(json.dumps(result))
        print(f"wrote {out}", file=sys.stderr)
    else:
        print(json.dumps({k: v for k, v in result.items()
                          if k not in ("frame_scores", "frame_top_class",
                                       "frame_top_class_prob")}))


def predict_from_artifact(kv: dict, device: str) -> dict:
    """Config-free inference from an exported serving artifact: the input forms
    of ``main``, without model code, checkpoint or config tree."""
    from collections import Counter

    input_path = kv.get("input")
    if not input_path:
        raise SystemExit("predict requires artifact=<dir> input=<path>")
    art, data_cfg = artifact_bootstrap(kv, device)
    enc = art.meta.get("encode")
    raw = _load_input(Path(input_path), data_cfg, int(enc["resolution"]) if enc else 0)
    result = art.predict(raw, str(input_path))
    _emit_result(result, kv.get("output"))
    top = Counter(result["frame_top_class"]).most_common(1)[0][0]
    print(
        f"{input_path}: {result['num_frames']} frames, max score "
        f"{result['video_anomaly_score']:.4f}, top class {top}",
        file=sys.stderr,
    )
    return result


def score_sampled_input(scorer, model, sampling, classnames, raw: np.ndarray, path, start_frame: int):
    """Score one loaded input (ncrops, T_raw, ...) through ``scorer``
    (a ``GridScorer`` of ``model``) -> (VideoScores, predictions dict).

    The video is covered by whole (num_segments x seg_length) grids of
    ``sampling``'s sizes (the data config's), the tail wrapping around to early
    frames, as the test set's items are (feature_dataset.py:252-259); the
    ground-truth labels are filled with normal_id: unlabeled input must not
    render as anomalous (the visualizer shades labels != normal_id)."""
    from anomalyclip_tpu_torch.data.dataset import TestItem
    from anomalyclip_tpu_torch.data.sampling import gather_frame_indices, test_start_indices
    from anomalyclip_tpu_torch.eval.evaluator import score_video

    t_raw = raw.shape[1]
    starts, segment_size = test_start_indices(
        t_raw, sampling.num_segments, sampling.seg_length, sampling.stride
    )
    indices = gather_frame_indices(starts, sampling.seg_length, sampling.stride, t_raw)
    normal_fill = int(model.cfg.normal_id)
    item = TestItem(
        features=raw[:, indices],
        frame_labels=np.full(t_raw, normal_fill, dtype=np.int64),
        video_label=normal_fill,
        segment_size=segment_size,
        path=path,
        start_frame=start_frame,
    )
    vs = score_video(item, scorer, model)
    return vs, prediction_result(path, t_raw, vs.scores, vs.class_probs, classnames, normal_fill)


def score_input(module, state, raw: np.ndarray, path: str):
    """Score one loaded input through the module's scorer -> (VideoScores,
    predictions dict). Shared by predict and serve."""
    from anomalyclip_tpu_torch.models.anomaly_clip import read_classnames

    return score_sampled_input(
        module._scorer(state), module.model, module.datamodule.cfg,
        read_classnames(module.datamodule.cfg.labels_file), raw, path, input_start_frame(path),
    )


class Predictor:
    """A model with its state on one device, scoring whole videos already in
    memory through ``score_input``'s code. ``sampling`` is the data config
    (anything with ``num_segments``, ``seg_length`` and ``stride``), as
    ``score_input`` takes it from the module's data module."""

    def __init__(self, model, frozen, trainable, bn_state, ncentroid, *, sampling, device="cuda"):
        from anomalyclip_tpu_torch.eval.evaluator import GridScorer

        self.model = model
        self.sampling = sampling
        self.scorer = GridScorer(model, frozen, trainable, bn_state, ncentroid, device=device)

    def score_frames(self, raw: np.ndarray, path: Optional[str] = None) -> Tuple[object, dict]:
        """Score (ncrops, T_raw, H, W, 3) uint8 frames (or (ncrops, T_raw, D)
        features) -> (VideoScores, predictions dict with score_input's keys).
        ``path`` names the input (a frames directory sets the start frame, as
        in ``score_input``); None for frames that came from no file."""
        start_frame = input_start_frame(path) if path else 0
        return score_sampled_input(self.scorer, self.model, self.sampling, self.model.classnames,
                                   raw, path, start_frame)


def main(argv=None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    kv = dict(a.split("=", 1) for a in argv if "=" in a)
    if "artifact" in kv:
        return predict_from_artifact(kv, cli_device(argv))
    from anomalyclip_tpu_torch.train_entry import choose_device

    os.environ.setdefault("PROJECT_ROOT", str(Path(__file__).resolve().parents[1]))

    from anomalyclip_tpu_torch.config import compose, default_config_dir, to_dict

    cfg = compose(default_config_dir(), "eval", argv)
    if not cfg.get("data") or not cfg.get("model"):
        raise SystemExit(
            "predict needs model/data groups, e.g.\n"
            "  python -m anomalyclip_tpu_torch.predict model=anomaly_clip_ucfcrime "
            "data=ucfcrime ckpt_path=... input=video.mp4"
        )
    ckpt_path = cfg.get("ckpt_path")
    input_path = cfg.get("input")
    if not ckpt_path or ckpt_path == "???" or not input_path:
        raise SystemExit("predict requires ckpt_path=... and input=...")

    module, state = load_module_and_state(to_dict(cfg), join_group(choose_device(argv, cfg)))
    data_cfg = cfg["data"]
    raw = _load_input(Path(input_path), data_cfg, int(module.model.clip_cfg.image_resolution))
    t_raw = raw.shape[1]
    vs, result = score_input(module, state, raw, str(input_path))

    if cfg.get("visualize") or data_cfg.get("visualize"):
        # frames-dir inputs, and .npy inputs with a frames dir beside them,
        # render an annotated mp4 (the visualizer finds the frames from vs.path)
        from anomalyclip_tpu_torch.eval.visualizer import Visualizer

        viz = Visualizer(
            normal_id=module.net_cfg.normal_id,
            labels_file=module.datamodule.cfg.labels_file,
            image_tmpl=data_cfg.get("image_tmpl", "{:06d}.jpg"),
            save_dir=cfg.get("paths", {}).get("output_dir", "."),
            frame_step=int(data_cfg.get("visualize_frame_step", 1)),
        )
        viz.process_video(vs)

    from anomalyclip_tpu_torch.utils.logging import is_host_zero

    if is_host_zero():
        _emit_result(result, cfg.get("output"))
    top_col = vs.class_probs.argmax(axis=1)
    print(
        f"{input_path}: {t_raw} frames, max score "
        f"{result['video_anomaly_score']:.4f}, top class "
        f"{result['classnames_abnormal'][int(np.bincount(top_col).argmax())]}",
        file=sys.stderr,
    )
    return result


def cli() -> int:
    """Console-script entry: main() returns the predictions dict, which setuptools
    wrappers pass to sys.exit() — translate to a clean exit status."""
    main()
    return 0


if __name__ == "__main__":
    main()
