"""CLIP feature extraction: frame directories -> one ``<video>.npy`` per video.
The counterpart of anomalyclip_tpu/extract_features.py.

The reference recommends training from pre-extracted CLIP features but ships
no extractor (reference: README.md:64-70, 104-106). Frames decode in a host
thread pool while the image tower encodes fixed-shape chunks on the card
(``AnomalyCLIP``'s ``encode_image`` path: K1 in the tower's attention), the
next chunk decoding while this one encodes.

Output layout matches the reference's feature files: a (T, D) float array per
video for ncrops=1, (T, ncrops, D) for 10-crop; both load through
``FeatureSource.load_video``'s ``reshape(-1, ncrops, D)``
(reference: src/data/components/feature_dataset.py:326-349).

    python -m anomalyclip_tpu_torch.extract_features \\
        --frames-root /data/ucfcrime/frames --out-root /data/ucfcrime/features \\
        --clip-ckpt ~/.cache/clip/ViT-B-16.pt [--ncrops 10] [--dtype bfloat16] [--device cpu]

Videos come from ``--annotations`` files (the training txt format:
``REL_PATH START END LABEL``) or, without one, every subdirectory of
``--frames-root`` that holds frames. CLIP comes from a local file through the
registry (models/clip/registry.py). Decoding a chunk (``decode_chunk``, PIL or
cv2) and encoding and writing (``FeatureWriter``, uint8 arrays in, no decoder)
are separate, so the second runs where no decoder is installed.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Iterable, List, Optional

import numpy as np
import torch

from anomalyclip_tpu_torch.data.records import VideoRecord
from anomalyclip_tpu_torch.eval.grids import encode_frames_chunked


def _discover_videos(frames_root: Path, image_tmpl: str) -> List[str]:
    """Every subdirectory (recursive) that contains frame 1 of the template."""
    found = []
    probe = image_tmpl.format(1)
    for dirpath, _dirnames, filenames in os.walk(frames_root):
        if probe in filenames:
            found.append(os.path.relpath(dirpath, frames_root))
    return sorted(found)


def _video_list(args) -> List[tuple]:
    """-> [(rel_path, start_frame, num_frames)]."""
    frames_root = Path(args.frames_root)
    if args.annotations:
        from anomalyclip_tpu_torch.data.records import parse_annotation_file

        vids = []
        for ann in args.annotations:
            for rec in parse_annotation_file(ann, str(frames_root)):
                vids.append((rec.rel_path, rec.start_frame, rec.num_frames))
        return vids
    from anomalyclip_tpu_torch.data.sources import count_frames

    return [
        (rel, 1, count_frames(frames_root / rel, args.image_tmpl))
        for rel in _discover_videos(frames_root, args.image_tmpl)
    ]


def decode_chunk(source, record: VideoRecord, lo: int, hi: int, pool=None) -> np.ndarray:
    """Frames lo..hi-1 of a video -> (ncrops, hi-lo, S, S, 3) uint8, through a
    ``FrameSource`` (PIL or cv2)."""
    return source.gather(record, np.arange(lo, hi), pool=pool)


class FeatureWriter:
    """Encodes uint8 frame chunks with a CLIP image tower on one device and
    writes each video's features: ``encode`` a chunk, ``write`` the video's
    chunks. Needs no decoder."""

    def __init__(self, params, cfg, compute_dtype: torch.dtype, device, batch: int = 256,
                 save_dtype: str = "float32"):
        from anomalyclip_tpu_torch.convert import tree_to
        from anomalyclip_tpu_torch.models.clip.model import cast_tree

        # the tower's weights in the compute dtype, as the JAX extractor casts them
        self.visual = tree_to(cast_tree(params["visual"], compute_dtype), device)
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        self.device = torch.device(device)
        self.batch = batch
        self.save_dtype = save_dtype
        self.frames = 0

    def _encode_call(self, frames: torch.Tensor) -> torch.Tensor:
        from anomalyclip_tpu_torch.models.clip.model import encode_image

        # uint8 frames are normalized on the device in fp32, then cast
        with torch.no_grad():
            return encode_image({"visual": self.visual}, self.cfg, frames, self.compute_dtype).float()

    def encode(self, chunk: np.ndarray) -> np.ndarray:
        """(ncrops, t, S, S, 3) uint8 -> (ncrops, t, D) float32, in calls of
        ``batch`` frames."""
        ncrops, t = chunk.shape[:2]
        flat = chunk.reshape((-1,) + chunk.shape[2:])
        feats = encode_frames_chunked(self._encode_call, flat, self.device, chunk=self.batch)
        self.frames += ncrops * t
        return feats.reshape(ncrops, t, -1)

    def write(self, out_path: Path, parts: List[np.ndarray]) -> np.ndarray:
        """A video's encoded chunks (ncrops, t_i, D) -> ``out_path``: (T, D) for
        one crop, (T, ncrops, D) for ten, written atomically (a partial file at
        the final name would be skipped as done on a resume). -> the array."""
        feats = np.concatenate(parts, axis=1).transpose(1, 0, 2)  # (T, ncrops, D)
        if feats.shape[1] == 1:
            feats = feats[:, 0]  # (T, D): the reference's single-crop layout
        out_path.parent.mkdir(parents=True, exist_ok=True)
        tmp = out_path.with_name(out_path.stem + ".tmp.npy")  # np.save keeps a .npy suffix
        feats = feats.astype(self.save_dtype)
        np.save(tmp, feats)
        os.replace(tmp, out_path)
        return feats


def main(argv: Optional[Iterable[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--frames-root", required=True, help="root of per-video frame dirs")
    p.add_argument("--out-root", required=True, help="where <video>.npy files go")
    p.add_argument("--annotations", nargs="*", default=None,
                   help="annotation txt file(s); default: discover all frame dirs")
    p.add_argument("--image-tmpl", default="{:06d}.jpg")
    p.add_argument("--ncrops", type=int, default=1, choices=(1, 10))
    p.add_argument("--clip-ckpt", default=None, help="torch CLIP checkpoint path")
    p.add_argument("--clip-init", default="pretrained",
                   choices=("pretrained", "random", "random-full"),
                   help="'random' uses the tiny test config (tests only)")
    p.add_argument("--arch", default="ViT-B/16")
    p.add_argument("--batch", type=int, default=256, help="frames per encode call")
    p.add_argument("--dtype", default="bfloat16", choices=("float32", "bfloat16"),
                   help="compute dtype on the device")
    p.add_argument("--save-dtype", default="float32", choices=("float32", "float16"))
    p.add_argument("--workers", type=int, default=8, help="decode threads")
    p.add_argument("--fast-decode", action="store_true", help="cv2 decode path")
    p.add_argument("--overwrite", action="store_true")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="the card (default) or the CPU")
    args = p.parse_args(list(argv) if argv is not None else None)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: torch sees no CUDA device; pass --device cpu to run on the CPU")

    from anomalyclip_tpu_torch.data.sources import FrameSource
    from anomalyclip_tpu_torch.models.clip.registry import resolve_clip

    params, cfg = resolve_clip(args.arch, args.clip_init, args.clip_ckpt)
    compute_dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    writer = FeatureWriter(params, cfg, compute_dtype, args.device, args.batch, args.save_dtype)
    source = FrameSource(
        input_size=cfg.image_resolution,  # the positional embedding fixes the resolution
        image_tmpl=args.image_tmpl,
        ncrops=args.ncrops,
        fast_decode=args.fast_decode,
    )
    videos = _video_list(args)
    if not videos:
        print(f"no videos found under {args.frames_root}", file=sys.stderr)
        return 1
    out_root = Path(args.out_root)

    todo = []
    for rel, start, n in videos:
        out_path = out_root / f"{rel}.npy"
        if out_path.exists() and not args.overwrite:
            print(f"skip {rel} (exists)", file=sys.stderr)
            continue
        if n <= 0:
            # a silently skipped video would never get a feature file, and the
            # skip-existing resume would retry it forever
            raise SystemExit(f"{rel}: no frames (start/end annotation malformed or empty dir)")
        rec = VideoRecord(rel_path=rel, start_frame=start, end_frame=start + n - 1, label=0,
                          root=str(args.frames_root))
        todo.append((rel, rec, n, out_path))

    # chunk-level pipelining: chunk k+1 decodes on the host pool while chunk k
    # encodes on the device; host memory is O(batch) frames whatever the length
    step = max(1, args.batch // args.ncrops)  # frames per decoded chunk
    tasks = [(vi, lo, min(lo + step, n)) for vi, (_, _, n, _) in enumerate(todo)
             for lo in range(0, n, step)]

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=args.workers) as pool, \
            ThreadPoolExecutor(max_workers=1) as lookahead:

        def load(task):
            vi, lo, hi = task
            return decode_chunk(source, todo[vi][1], lo, hi, pool)

        fut = lookahead.submit(load, tasks[0]) if tasks else None
        parts: List[np.ndarray] = []
        for ti, (vi, lo, hi) in enumerate(tasks):
            chunk = fut.result()
            fut = lookahead.submit(load, tasks[ti + 1]) if ti + 1 < len(tasks) else None
            parts.append(writer.encode(chunk))
            if ti + 1 == len(tasks) or tasks[ti + 1][0] != vi:
                rel, _, t, out_path = todo[vi]
                writer.write(out_path, parts)
                parts = []
                dt = time.perf_counter() - t0
                print(f"{rel}: {t} frames x{args.ncrops} -> {out_path}"
                      f"  [{writer.frames / max(dt, 1e-9):,.0f} fps cum]", file=sys.stderr)
    print(f"done: {len(todo)} videos, {writer.frames} frames", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
