"""Throughput of CLIP frame encoding on the card: the from-frames hot path.

    python -m anomalyclip_tpu_torch.bench [--arch ViT-B/16] [--batch N]
        [--quant none|int8] [--e2e] [--device cuda|cpu]

The counterpart of the JAX package's root ``bench.py``, with its flags, its
defaults and its one JSON line on stdout:

    {"metric": "vit_b16_encode_throughput", "value": N, "unit": "frames/sec/chip",
     "vs_baseline": null}

CLIP image encoding is most of the framework's compute: every frame of every
video at scoring and ncentroid time. The tower (``--arch``: ViT-B/16, ViT-B/32,
ViT-L/14, ViT-L/14@336px) takes seeded weights (``init_clip_params`` from
generator seed 0), cast to bf16 once, and bf16 compute; the attention runs the
kernel ``attention_rung`` picks (K1 on ``mha_tc.cu`` for the three towers at
224 px, K6 for ViT-L/14@336px). ``--quant int8`` quantizes the fp32 tree once
(``quantize_clip_visual``) and encodes through the W8A8 tower, its non-GEMM
compute in bf16. The batch is the arch's (``BATCHES``) unless ``--batch`` says
otherwise.

Method: ``INNER_ITERS`` encodes of the same standard-normal bf16 frames in a
chain, each call's input ``frames + carry * 0`` where ``carry`` is the previous
call's ``out[0, 0]`` as an fp32 tensor on the card, so no call can be skipped
and none can overlap the next; the chain runs under ``torch.inference_mode``
with no synchronisation inside it, and ``float`` of the last output is its one
wait. One chain warms up (the kernels' library loads there), then the best of
``REPEATS`` chains over ``INNER_ITERS`` is the time of one call.

``vs_baseline`` is null for every arch: the JAX script's 3,000 frames/s is a
target set for a TPU, and the port states none for the card.

``--e2e`` is the from-frames ingest: a synthetic 224 px JPEG corpus
(``data/synthetic.py``), the host's decode and preprocess rate alone
(``FrameSource(fast_decode=True)`` over a thread pool) and by thread count, the
warm dispatch of a chunk of frames from host memory as uint8 and as fp32
(``dispatch_rates``, no decoder needed), and ``extract_features.main`` run
twice, cold and sustained. "Cold" is the first run with the kernels' library
load in it: the JAX script's persistent compilation cache has no counterpart.
It needs cv2 and PIL to write and decode JPEG; where either does not import it
exits non-zero, naming them, before anything is timed.

The JAX script re-ran itself once in a fresh process when it failed (for a
remote TPU's dropped link); this one does not: a failed launch fails the run.

``--device cpu`` runs a tiny tower (``cpu_tower``: 2 layers of width 64, the
arch's patch size and resolution, so the arch's sequence length) at batch 2
through the same chain, and ``--e2e`` with ``CLIPConfig.tiny()`` over the same
corpus; no time it prints is a measurement of the card.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import os
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from anomalyclip_tpu_torch.convert import tree_to
from anomalyclip_tpu_torch.models.clip.model import CLIPConfig, cast_tree, encode_image, init_clip_params
from anomalyclip_tpu_torch.scripts._bench_util import announce_device

ARCHS = {
    "ViT-B/16": CLIPConfig.vit_b16,
    "ViT-B/32": CLIPConfig.vit_b32,
    "ViT-L/14": CLIPConfig.vit_l14,
    "ViT-L/14@336px": CLIPConfig.vit_l14_336,
}
# frames a call, per arch: they fix the work measured
BATCHES = {"ViT-B/16": 256, "ViT-B/32": 512, "ViT-L/14": 64, "ViT-L/14@336px": 32}
INNER_ITERS = 12  # encodes in a chain
REPEATS = 4  # timed chains, after one warm chain
CPU_BATCH = 2
E2E_FRAMES = 256  # frames of the dispatch stage and of an extract_features call
E2E_SIDE = 224  # the corpus's frames, decoded and preprocessed at this size
DECODERS = ("cv2", "PIL")  # what --e2e imports


def metric_name(arch: str) -> str:
    """"ViT-L/14@336px" -> "vit_l14_336px_encode_throughput"."""
    return arch.lower().replace("-", "_").replace("/", "").replace("@", "_") + "_encode_throughput"


def cpu_tower(cfg: CLIPConfig) -> CLIPConfig:
    """The tower ``--device cpu`` runs: 2 layers of width 64 (one head), the
    arch's patch size and resolution, a one-layer text tower nothing reads."""
    return dataclasses.replace(cfg, embed_dim=64, vision_layers=2, vision_width=64, transformer_width=64,
                               transformer_heads=1, transformer_layers=1)


def bench_weights(cfg: CLIPConfig, quant: str, device) -> dict:
    """The seeded image tower on ``device``: cast to bf16 once, or for
    ``quant == "int8"`` quantized once from fp32 -> the tree the encoder takes
    (the text tower is never read and stays off the card)."""
    from anomalyclip_tpu_torch.models.clip.quant import quantize_clip_visual

    visual = init_clip_params(torch.Generator().manual_seed(0), cfg)["visual"]
    if quant == "int8":
        return quantize_clip_visual({"visual": tree_to(visual, device)})
    return {"visual": tree_to(cast_tree(visual, torch.bfloat16), device)}


def bench_frames(cfg: CLIPConfig, batch: int, device) -> torch.Tensor:
    """(batch, side, side, 3) standard-normal frames from numpy seed 0, in bf16."""
    side = cfg.image_resolution
    frames = np.random.default_rng(0).standard_normal((batch, side, side, 3))
    return torch.from_numpy(frames).to(torch.bfloat16).to(device)


def encoder(weights: dict, cfg: CLIPConfig, quant: str):
    """-> encode(frames) -> (B, embed_dim) bf16, the fp tower's or the int8 one's."""
    if quant == "int8":
        from anomalyclip_tpu_torch.models.clip.quant import encode_image_int8

        return lambda frames: encode_image_int8(weights, cfg, frames, torch.bfloat16)
    return lambda frames: encode_image(weights, cfg, frames, compute_dtype=torch.bfloat16)


def chain(encode, frames: torch.Tensor, iters: int = INNER_ITERS) -> torch.Tensor:
    """``iters`` encodes, each fed ``frames + carry * 0`` with ``carry`` the
    previous output's [0, 0] in fp32 -> the last output. Nothing here waits on
    the card."""
    carry = torch.zeros((), dtype=torch.float32, device=frames.device)
    with torch.inference_mode():
        for _ in range(iters):
            out = encode(frames + carry.to(torch.bfloat16) * 0)
            carry = out[0, 0].float()
    return out


def run(arch: str = "ViT-B/16", batch: int = 0, quant: str = "none", device: str = "cuda",
        full: bool = True) -> SimpleNamespace:
    """The headline: one warm chain, then the best of ``REPEATS`` -> cfg,
    batch, weights, frames, encode, seconds a call (``best_s``), frames/s.
    ``full=False``: ``cpu_tower`` at ``CPU_BATCH`` frames, unless ``batch``."""
    cfg = ARCHS[arch]()
    if not full:
        cfg = cpu_tower(cfg)
    batch = batch or (BATCHES[arch] if full else CPU_BATCH)
    weights = bench_weights(cfg, quant, device)
    frames = bench_frames(cfg, batch, device)
    encode = encoder(weights, cfg, quant)
    float(chain(encode, frames)[0, 0])  # warm
    best = float("inf")
    for _ in range(REPEATS):
        start = time.perf_counter()
        float(chain(encode, frames)[0, 0])
        best = min(best, (time.perf_counter() - start) / INNER_ITERS)
    return SimpleNamespace(cfg=cfg, batch=batch, weights=weights, frames=frames, encode=encode, best_s=best,
                           fps=batch / best)


# ---------------------------------------------------------------------------
# --e2e: the from-frames ingest
# ---------------------------------------------------------------------------


def missing_decoders() -> list:
    """The JPEG modules ``--e2e`` needs that do not import here, by name."""
    missing = []
    for name in DECODERS:
        try:
            importlib.import_module(name)
        except ImportError:
            missing.append(name)
    return missing


def dispatch_rates(weights: dict, cfg: CLIPConfig, device, frames: int = E2E_FRAMES) -> dict:
    """One warm encode dispatch of ``frames`` frames from a host array, uint8
    against fp32 (CLIP-normalized on the host): each call copies the array to
    the card from pageable memory, encodes in bf16 and brings the features
    back. The best of 3 after a warm call -> frames/s by input type.
    uint8 ships a quarter of the bytes and is normalized on the card."""
    side = cfg.image_resolution
    chunk_u8 = np.random.default_rng(0).integers(0, 256, size=(frames, side, side, 3), dtype=np.uint8)
    chunk_f32 = ((chunk_u8.astype(np.float32) / 255.0) - 0.45) / 0.27

    def dispatch(arr: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            x = torch.from_numpy(arr).to(device)
            return encode_image(weights, cfg, x, compute_dtype=torch.bfloat16).float().cpu().numpy()

    def rate(arr: np.ndarray) -> float:
        dispatch(arr)  # warm
        best = float("inf")
        for _ in range(3):
            start = time.perf_counter()
            dispatch(arr)
            best = min(best, time.perf_counter() - start)
        return len(arr) / best

    return {"uint8": rate(chunk_u8), "float32": rate(chunk_f32)}


def decode_thread_scaling(record, image_tmpl: str = "{:06d}.jpg") -> dict:
    """Decode and preprocess rate of the same in-memory JPEG bytes at 1, 2, 4,
    ... threads up to ``os.cpu_count()`` (cv2 releases the GIL in
    ``imdecode`` and ``resize``): {threads: frames/s}. In-memory bytes keep the
    file cache out of it. File ids are sample index + ``record.start_frame``
    through the source's template, as ``FrameSource`` reads them."""
    from concurrent.futures import ThreadPoolExecutor

    import cv2

    from anomalyclip_tpu_torch.data.transforms import _center_offset, _short_side_size

    n = min(record.num_frames, 192)
    blobs = [np.fromfile(os.path.join(record.frames_dir, image_tmpl.format(i + record.start_frame)), np.uint8)
             for i in range(n)]

    def one(buf) -> int:
        img = cv2.imdecode(buf, cv2.IMREAD_COLOR)
        h, w = img.shape[:2]
        new_h, new_w = _short_side_size(h, w, E2E_SIDE)
        interp = cv2.INTER_AREA if new_w < w else cv2.INTER_CUBIC
        img = cv2.resize(img, (new_w, new_h), interpolation=interp)
        top, left = _center_offset(new_h - E2E_SIDE), _center_offset(new_w - E2E_SIDE)
        return int(img[top : top + E2E_SIDE, left : left + E2E_SIDE, 0].sum()) & 1

    def rate(nthreads: int) -> float:
        with ThreadPoolExecutor(max_workers=nthreads) as ex:
            list(ex.map(one, blobs[: 4 * nthreads]))  # warm the pool
            reps = 3
            start = time.perf_counter()
            for _ in range(reps):
                list(ex.map(one, blobs))
            return reps * len(blobs) / (time.perf_counter() - start)

    ncpu = max(os.cpu_count() or 1, 1)
    scaling, nt = {}, 1
    while nt <= ncpu:
        scaling[str(nt)] = round(rate(nt), 1)
        nt *= 2
    if str(ncpu) not in scaling:
        scaling[str(ncpu)] = round(rate(ncpu), 1)
    return scaling


def e2e_ingest(device: str = "cuda", full: bool = True, root: Optional[Path] = None, n_videos: int = 6,
               min_frames: int = 900, max_frames: int = 1100, dispatch_frames: int = E2E_FRAMES) -> dict:
    """Sustained from-frames ingest through ``extract_features.main``: decode
    threads beside the card's encode, uint8 uploads, normalization on the card
    -> the JSON line's dict. ``full=False`` encodes with the tiny tower
    (``--clip-init random``). The corpus lives under ``root`` (by default the
    temporary directory) and is regenerated only when its parameters change."""
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from anomalyclip_tpu_torch.data.records import parse_annotation_file
    from anomalyclip_tpu_torch.data.sources import FrameSource
    from anomalyclip_tpu_torch.data.synthetic import generate_synthetic_dataset
    from anomalyclip_tpu_torch.extract_features import main as extract_main

    root = Path(root) if root is not None else Path(tempfile.gettempdir()) / "anomalyclip_torch_e2e_bench"
    froot, aroot = root / "frames", root / "annotations"
    generate_synthetic_dataset(frames_root=froot, annotations_root=aroot, num_normal=n_videos, num_abnormal=0,
                               num_test=0, min_frames=min_frames, max_frames=max_frames, make_frames=True,
                               frame_size=E2E_SIDE, seed=3)
    records = parse_annotation_file(aroot / "Anomaly_Train_Normal.txt", str(froot))
    total_frames = sum(r.num_frames for r in records)

    # the host's decode and preprocess alone (cv2, the throughput path)
    workers = max(os.cpu_count() or 1, 1)
    src = FrameSource(input_size=E2E_SIDE, fast_decode=True)
    with ThreadPoolExecutor(max_workers=workers) as pool:
        warm = records[0]
        src.gather(warm, np.arange(min(64, warm.num_frames)), pool=pool)
        start = time.perf_counter()
        for r in records:
            src.gather(r, np.arange(r.num_frames), pool=pool)
        decode_fps = total_frames / (time.perf_counter() - start)
    decode_scaling = decode_thread_scaling(records[0], src.image_tmpl)

    cfg = CLIPConfig.vit_b16() if full else CLIPConfig.tiny()
    dispatch = dispatch_rates(bench_weights(cfg, "none", device), cfg, device, dispatch_frames)

    out_root = root / "features_out"

    def run_extract() -> float:
        shutil.rmtree(out_root, ignore_errors=True)
        start = time.perf_counter()
        rc = extract_main(["--frames-root", str(froot), "--out-root", str(out_root), "--annotations",
                           str(aroot / "Anomaly_Train_Normal.txt"),
                           "--clip-init", "random-full" if full else "random", "--batch", str(E2E_FRAMES),
                           "--workers", str(workers), "--fast-decode", "--device", device])
        if rc != 0:
            raise RuntimeError(f"extract_features exited {rc}")
        return total_frames / (time.perf_counter() - start)

    cold_fps = run_extract()
    e2e_fps = run_extract()
    print(f"# e2e ingest: {e2e_fps:,.0f} fps sustained over {total_frames} frames (cold, the library load "
          f"included: {cold_fps:,.0f}); host decode+preprocess alone: {decode_fps:,.0f} fps on {workers} core(s) "
          f"({decode_fps / workers:,.0f} fps/core); thread scaling {decode_scaling}; warm {dispatch_frames}-frame "
          f"encode dispatch from host: uint8 {dispatch['uint8']:,.0f} fps vs float32 {dispatch['float32']:,.0f} fps",
          file=sys.stderr, flush=True)
    return {
        "metric": "vit_b16_e2e_ingest_throughput",
        "value": round(e2e_fps, 1),
        "unit": "frames/sec (decode+preprocess+transfer+encode)",
        "vs_baseline": None,
        "host_decode_fps": round(decode_fps, 1),
        "decode_workers": workers,
        "host_decode_scaling": decode_scaling,
        "dispatch_fps_uint8": round(dispatch["uint8"], 1),
        "dispatch_fps_float32": round(dispatch["float32"], 1),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="ViT-B/16", choices=list(ARCHS))
    ap.add_argument("--batch", type=int, default=0, help="0 = per-arch default")
    ap.add_argument("--quant", default="none", choices=["none", "int8"],
                    help="int8 = W8A8 serving tower (models/clip/quant.py)")
    ap.add_argument("--e2e", action="store_true",
                    help="end-to-end from-frames ingest: JPEG decode + preprocess + transfer + encode, "
                         "sustained (needs cv2 and PIL)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cpu: a tiny tower at the arch's sequence length, batch 2; no measurement")
    args = ap.parse_args(argv)
    on_card = announce_device("bench", args.device, "a tiny tower at the arch's sequence length, batch 2; "
                                                    "no time is a measurement")
    if args.e2e:
        missing = missing_decoders()
        if missing:
            raise SystemExit(f"bench --e2e: {' and '.join(missing)} cannot be imported here; the ingest decodes "
                             "JPEG with cv2 and writes its corpus with PIL, so it runs only where both import")
        line = e2e_ingest(args.device, full=on_card)
    else:
        r = run(args.arch, args.batch, args.quant, args.device, full=on_card)
        print(f"# {r.fps:,.0f} frames/s (batch={r.batch}, {r.best_s * 1e3:.2f} ms/iter)", file=sys.stderr,
              flush=True)
        line = {"metric": metric_name(args.arch), "value": round(r.fps, 1), "unit": "frames/sec/chip",
                "vs_baseline": None}
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
