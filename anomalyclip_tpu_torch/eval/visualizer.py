"""Qualitative per-video visualizations: score timeline and class bars -> mp4.
The counterpart of anomalyclip_tpu/eval/visualizer.py, with ``matplotlib``
and ``cv2`` imported where a video is rendered (the card's machine has
neither).

Mirror of the reference Visualizer (reference: src/utils/visualizer.py:12-256,
hooked at anomaly_clip_module.py:447-456, 485-492): for each test video, render a
per-frame figure (video frame, per-class probability bars, anomaly-score timeline
with ground-truth shading) and encode the frames to an mp4 with OpenCV. Enabled by
``data.visualize=True``. Videos whose frame JPEGs are unavailable (features-only
runs) are skipped with a warning.
"""

from __future__ import annotations

import csv
from pathlib import Path
from typing import Optional

import numpy as np

from anomalyclip_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


class Visualizer:
    def __init__(
        self,
        normal_id: int,
        labels_file: str,
        image_tmpl: str = "{:06d}.jpg",
        save_dir: str | Path = ".",
        fps: int = 16,
        frame_step: int = 1,
    ):
        self.normal_id = normal_id
        with open(labels_file) as f:
            self.class_names = [row["name"] for row in csv.DictReader(f)]
        self.image_tmpl = image_tmpl
        self.save_dir = Path(save_dir) / "visualizations"
        self.save_dir.mkdir(parents=True, exist_ok=True)
        self.fps = fps
        # frame_step=1 matches the reference, which renders EVERY frame
        # (reference: src/utils/visualizer.py:222-256). Values >1 render every
        # k-th frame as an opt-in speed knob (data.visualize_frame_step): each
        # frame is a full matplotlib figure. A step below 1 is clamped to 1, so
        # that it cannot fail per video after the scoring pass was paid for.
        if int(frame_step) < 1:
            log.warning(f"visualize_frame_step={frame_step} invalid; using 1")
        self.frame_step = max(1, int(frame_step))

    def _frames_dir(self, path: str) -> Optional[Path]:
        p = Path(path)
        candidate = p.with_suffix("") if p.suffix == ".npy" else p
        return candidate if candidate.is_dir() else None

    def process_video(self, video_scores) -> None:
        """video_scores: eval.evaluator.VideoScores."""
        frames_dir = self._frames_dir(video_scores.path)
        name = Path(video_scores.path).stem
        if frames_dir is None:
            # features-only run: no JPEGs to show; skip rather than render
            # placeholder panels for every video of the dataset
            log.warning(f"no frame directory for {name}; skipping visualization")
            return
        import cv2
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        out_path = self.save_dir / f"{name}.mp4"
        scores = video_scores.scores
        labels = video_scores.frame_labels
        probs = video_scores.class_probs
        t = len(scores)

        writer = None
        start = int(getattr(video_scores, "start_frame", 0))
        for i in range(0, t, self.frame_step):
            fig, axes = plt.subplots(1, 3, figsize=(15, 4))
            # frame panel: score index i maps to file id i + start_frame, the
            # data layer's own contract (sources.py; real datasets are
            # 1-based). The reference renders image_tmpl.format(i) raw
            # (visualizer.py:206), which is right only for 0-based corpora.
            fpath = frames_dir / self.image_tmpl.format(i + start)
            if fpath.is_file():
                img = cv2.cvtColor(cv2.imread(str(fpath)), cv2.COLOR_BGR2RGB)
                axes[0].imshow(img)
            else:
                axes[0].text(0.5, 0.5, f"frame {i + start}", ha="center")
            axes[0].set_axis_off()

            # class probability bars (abnormal classes only)
            names = [c for j, c in enumerate(self.class_names) if j != self.normal_id]
            axes[1].barh(names, probs[i], color="steelblue")
            axes[1].set_xlim(0, 1)
            axes[1].set_title("class probabilities")

            # score timeline with GT shading
            axes[2].plot(scores[: i + 1], color="red")
            axes[2].set_xlim(0, t)
            axes[2].set_ylim(0, 1.05)
            anomalous = labels != self.normal_id
            axes[2].fill_between(
                np.arange(t), 0, 1, where=anomalous, color="salmon", alpha=0.3
            )
            axes[2].set_title("anomaly score")

            fig.tight_layout()
            fig.canvas.draw()
            buf = np.asarray(fig.canvas.buffer_rgba())[:, :, :3]
            plt.close(fig)

            if writer is None:
                writer = cv2.VideoWriter(
                    str(out_path),
                    cv2.VideoWriter_fourcc(*"mp4v"),
                    self.fps,
                    (buf.shape[1], buf.shape[0]),
                )
            writer.write(cv2.cvtColor(buf, cv2.COLOR_RGB2BGR))
        if writer is not None:
            writer.release()
            log.info(f"wrote visualization {out_path}")
