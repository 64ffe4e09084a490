"""Synthetic dataset generator: random feature files + annotations on disk.
A copy of anomalyclip_tpu/data/synthetic.py: the same parameters give the same
bytes. PIL is imported only to write frames (``make_frames=True``).

Creates the exact on-disk layout the real datasets use (``<video>.npy`` features,
annotation txts, temporal test annotations) so the full pipeline — parsing,
sampling, batching, training, evaluation — runs end-to-end with no dataset
download. Used by tests and bench (the reference's test suite has no analogous
fixture; its tests depend on real data, SURVEY.md §4)."""

from __future__ import annotations

from pathlib import Path

import numpy as np


def generate_synthetic_dataset(
    frames_root: str | Path,
    annotations_root: str | Path,
    num_normal: int = 8,
    num_abnormal: int = 8,
    num_test: int = 4,
    num_classes: int = 6,
    normal_id: int = 3,
    feature_dim: int = 64,
    min_frames: int = 600,
    max_frames: int = 1400,
    seed: int = 0,
    force: bool = False,
    make_frames: bool = False,
    frame_size: int = 32,
) -> None:
    """With ``make_frames=True``, each video also gets a ``<name>/{:06d}.jpg``
    directory of class-tinted frames so the from-frames path
    (``data.load_from_features=False``) runs end-to-end too."""
    frames_root = Path(frames_root)
    annotations_root = Path(annotations_root)
    # the stamp records the FULL parameter tuple: a generation under different
    # params against the same root must regenerate, or annotations and feature
    # files silently desync (annotation frame counts no longer match the .npy
    # lengths -> length-mismatch crashes deep inside metrics)
    params = repr(
        (
            num_normal, num_abnormal, num_test, num_classes, normal_id,
            feature_dim, min_frames, max_frames, seed, make_frames, frame_size,
        )
    )
    stamp = annotations_root / ".synthetic_ok"
    # single-writer lock: concurrent processes sharing a root (parallel test
    # jobs, multi-host module init) must not wipe each other's files mid-run
    lock = annotations_root.parent / ".synthetic_lock"
    lock.parent.mkdir(parents=True, exist_ok=True)
    _acquire_dir_lock(lock)
    try:
        if stamp.is_file() and not force and stamp.read_text().strip() == params:
            return
        # parameters changed (or first run): wipe both roots so nothing stale
        # (old-length features, other-mode frame dirs) survives — but only
        # when a stamp proves the generator owns the directory; never delete a
        # directory holding data this generator did not write
        import shutil

        owned = stamp.is_file()
        for root in (frames_root, annotations_root):
            if not root.exists():
                continue
            if owned:
                shutil.rmtree(root)
            elif any(root.iterdir()):
                raise RuntimeError(
                    f"refusing to generate synthetic data into non-empty, "
                    f"non-generated directory {root} (no {stamp.name} stamp) — "
                    "point frames_root/annotations_root at a fresh location"
                )
        frames_root.mkdir(parents=True, exist_ok=True)
        annotations_root.mkdir(parents=True, exist_ok=True)
        _generate(
            frames_root, annotations_root, stamp, params,
            num_normal, num_abnormal, num_test, num_classes, normal_id,
            feature_dim, min_frames, max_frames, seed, make_frames, frame_size,
        )
    finally:
        _release_dir_lock(lock)


def _acquire_dir_lock(lock: Path, timeout: float = 120.0) -> None:
    """Advisory mkdir-based lock (atomic on POSIX), with a staleness bound so a
    killed generator cannot deadlock every later run."""
    import os
    import time

    deadline = time.time() + timeout
    while True:
        try:
            lock.mkdir()
            return
        except FileExistsError:
            if time.time() > deadline:
                raise TimeoutError(f"synthetic-data lock stuck: {lock}")
            try:
                if time.time() - lock.stat().st_mtime > timeout:
                    # Stale holder died. Breaking the lock is racy between
                    # multiple waiters (both can rmdir+mkdir interleaved), so
                    # after a successful re-acquire we claim it with our pid
                    # and only proceed if the claim survives a settle window —
                    # the loser sees the other pid (or a fresh mtime) and waits.
                    # A dead breaker may itself have left an owner claim inside;
                    # clear it or rmdir fails ENOTEMPTY forever.
                    for leftover in lock.iterdir():
                        leftover.unlink(missing_ok=True)
                    os.rmdir(lock)
                    try:
                        lock.mkdir()
                    except FileExistsError:
                        time.sleep(0.1)
                        continue
                    claim = lock / f"owner-{os.getpid()}"
                    claim.touch()
                    time.sleep(0.2)
                    if claim.exists() and len(list(lock.iterdir())) == 1:
                        return
                    time.sleep(0.1)
                    continue
            except OSError:
                pass
            time.sleep(0.1)


def _release_dir_lock(lock: Path) -> None:
    import os

    try:
        for claim in lock.iterdir():  # owner-pid claim from a stale-lock break
            claim.unlink(missing_ok=True)
        os.rmdir(lock)
    except OSError:
        pass


def _generate(
    frames_root: Path,
    annotations_root: Path,
    stamp: Path,
    params: str,
    num_normal: int,
    num_abnormal: int,
    num_test: int,
    num_classes: int,
    normal_id: int,
    feature_dim: int,
    min_frames: int,
    max_frames: int,
    seed: int,
    make_frames: bool,
    frame_size: int,
) -> None:
    rng = np.random.default_rng(seed)

    abnormal_classes = [c for c in range(num_classes) if c != normal_id]
    # class-conditioned feature means make the task learnable end-to-end
    class_means = rng.standard_normal((num_classes, feature_dim)).astype(np.float32)
    class_tints = rng.uniform(0.2, 0.8, size=(num_classes, 3)).astype(np.float32)

    def write_frames(name: str, label: int, t: int, anomalous_span) -> None:
        from PIL import Image

        vdir = frames_root / name
        vdir.mkdir(parents=True, exist_ok=True)
        base = class_tints[normal_id]
        for i in range(t):
            tint = base
            if anomalous_span is not None and anomalous_span[0] <= i <= anomalous_span[1]:
                tint = class_tints[label]
            img = rng.uniform(0, 0.3, size=(frame_size, frame_size, 3)) + tint
            img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
            # file id = start_frame + index (reference video_dataset.py:338); the
            # synthetic annotations use start_frame=0, so files are 0-based
            Image.fromarray(img).save(vdir / f"{i:06d}.jpg", quality=80)

    def write_video(name: str, label: int, anomalous_span=None) -> int:
        t = int(rng.integers(min_frames, max_frames + 1))
        feats = 0.1 * rng.standard_normal((t, feature_dim)).astype(np.float32)
        feats += class_means[normal_id]
        if anomalous_span is not None:
            s, e = anomalous_span
            feats[s : e + 1] += class_means[label] - class_means[normal_id]
        np.save(frames_root / f"{name}.npy", feats)
        if make_frames:
            write_frames(name, label, t, anomalous_span)
        return t

    normal_lines, abnormal_lines, test_lines, temporal_lines = [], [], [], []

    for i in range(num_normal):
        name = f"normal_{i:03d}"
        t = write_video(name, normal_id)
        normal_lines.append(f"{name} 0 {t - 1} {normal_id}")

    def plan_span() -> tuple:
        """Anomalous interval within [0, min_frames): start in the first half, span
        of ~1/8..1/2 of the minimum length, clipped to stay in range."""
        s = int(rng.integers(0, max(min_frames // 2, 1)))
        span = int(rng.integers(max(min_frames // 8, 1), max(min_frames // 2, 2)))
        e = min(max(s + span, s + 1), min_frames - 1)
        return s, max(e, s)

    for i in range(num_abnormal):
        name = f"abnormal_{i:03d}"
        label = int(abnormal_classes[i % len(abnormal_classes)])
        s, e = plan_span()
        t = write_video(name, label, (s, e))
        abnormal_lines.append(f"{name} 0 {t - 1} {label}")

    for i in range(num_test):
        anomalous = i % 2 == 0
        name = f"test_{i:03d}"
        if anomalous:
            label = int(abnormal_classes[i % len(abnormal_classes)])
            s, e = plan_span()
            t = write_video(name, label, (s, e))
            test_lines.append(f"{name} 0 {t - 1} {label}")
            temporal_lines.append(f"{name} class_{label} {s} {e}")
        else:
            t = write_video(name, normal_id)
            test_lines.append(f"{name} 0 {t - 1} {normal_id}")
            # real temporal-annotation files list every test video; normal ones
            # carry an empty interval marker
            temporal_lines.append(f"{name} Normal -1 -1")

    (annotations_root / "Anomaly_Train_Normal.txt").write_text("\n".join(normal_lines) + "\n")
    (annotations_root / "Anomaly_Train_Abnormal.txt").write_text("\n".join(abnormal_lines) + "\n")
    (annotations_root / "Anomaly_Test.txt").write_text("\n".join(test_lines) + "\n")
    (annotations_root / "Temporal_Anomaly_Annotation_for_Testing_Videos.txt").write_text(
        "\n".join(temporal_lines) + "\n"
    )
    stamp.write_text(params + "\n")
