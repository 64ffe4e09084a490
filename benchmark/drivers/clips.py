"""Mix kind ``clips``: whole videos of uint8 frames in host memory, scored one
after another by ``Predictor.score_frames`` in a closed loop with one client.

The mix's parameters: ``lengths``, the videos' lengths in frames (each cycle
sends every length once, in an order shuffled by the seed, so that every seed
sends the same sizes); ``cycles``; ``pool_frames``, a seeded pool of uint8
frames in pageable host memory, of which each video is a slice at a seeded
offset; ``trace_videos`` and ``trace_seconds``, the traced window (that many
videos, or as many as start within the seconds). The configuration's
``check_grids`` is the size of the sample the reference scores again.

Set-up makes the weights and the frame pool from the seed, builds the
predictor (its text features included) and scores the shortest video that
meets each shape the window will (the program pads a video's grids to a
bucket, a power of two, and encodes in fixed chunks), so that nothing is built
inside the window. The window sends videos until ``--seconds`` have passed and
waits for the last one started. Then the peak memory is read, the program is
freed, and a sample of the grids that covered the videos, drawn from the seed
(the last grid of one video, with its wrapped frames, among them), is scored
again by the plain reference and compared frame by frame.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from benchmark import program, weights, work
from benchmark.cells import load_tower
from benchmark.reference.anomaly import grid_positions, score_grids
from benchmark.reference.clip import text_features
from benchmark.reference.precision import Products
from benchmark.session import Phases, free, memory_peak
from benchmark.trace import Reading, traced


@dataclasses.dataclass
class Video:
    offset: int
    frames: int
    latency_s: float
    scores: Optional[np.ndarray]
    probs: Optional[np.ndarray]


@dataclasses.dataclass
class Trees:
    clip: dict
    trainable: dict
    bn: tuple
    ncentroid: torch.Tensor


def make_trees(cfg: dict, seed: int, device) -> Trees:
    clip = weights.clip_tree(cfg, seed, device)
    trainable, bn, ncentroid = weights.head_trees(cfg, seed, device, clip["text"]["text_projection"])
    return Trees(clip, trainable, bn, ncentroid)


def schedule(mix: dict, seed: int) -> List[tuple]:
    """-> [(offset into the pool, length)] for ``cycles`` cycles."""
    lengths = [int(n) for n in mix["lengths"]]
    if max(lengths) > mix["pool_frames"]:
        raise ValueError("the longest video exceeds the frame pool")
    rng = np.random.default_rng([int(seed), 17])
    out = []
    for _ in range(mix["cycles"]):
        for i in rng.permutation(len(lengths)):
            out.append((int(rng.integers(0, mix["pool_frames"] - lengths[i] + 1)), lengths[i]))
    return out


def frame_pool(mix: dict, side: int, seed: int, device) -> np.ndarray:
    """(pool_frames, side, side, 3) uint8 frames, drawn on ``device`` and copied
    to pageable host memory, where decoded frames would be."""
    gen = weights.generator(seed, "frames", device)
    pool = torch.randint(0, 256, (mix["pool_frames"], side, side, 3), generator=gen, device=device,
                         dtype=torch.uint8)
    return pool.cpu().numpy()


def bucket(grids: int) -> int:
    return 1 << (grids - 1).bit_length()


def warm_lengths(lengths: List[int], cfg: dict) -> List[int]:
    """The shortest video of each grid bucket the lengths reach: every shape
    the window will meet (the encoder's chunks are all of one size)."""
    per_grid = cfg["model"]["num_segments"] * cfg["model"]["seg_length"]
    return sorted({(bucket(work.clip_grids(n, cfg)) // 2) * per_grid + 1 for n in lengths})


def send(scorer, pool: np.ndarray, plan: list, seconds: float, max_videos: Optional[int] = None) -> tuple:
    """The closed loop: videos until ``seconds`` have passed (or ``max_videos``
    are done) -> (videos done, window seconds to the end of the last)."""
    done: List[Video] = []
    start = time.perf_counter()
    end = start
    for offset, length in plan:
        if time.perf_counter() - start >= seconds or (max_videos is not None and len(done) >= max_videos):
            break
        sent = time.perf_counter()
        scores, probs = scorer.score(pool[offset:offset + length])
        end = time.perf_counter()
        done.append(Video(offset, length, end - sent, scores, probs))
    return done, end - start


def pick_grids(videos: List[Video], count: int, cfg: dict, seed: int) -> List[tuple]:
    """A sample of (video, grid) drawn from the seed: the last grid of one
    video, then others, all distinct."""
    rng = np.random.default_rng([int(seed), weights.STREAMS["sample"]])
    grids = [work.clip_grids(v.frames, cfg) for v in videos]
    first = int(rng.integers(len(videos)))
    pairs = [(v, g) for v in range(len(videos)) for g in range(grids[v]) if (v, g) != (first, grids[first] - 1)]
    rest = rng.choice(len(pairs), size=min(count - 1, len(pairs)), replace=False) if count > 1 else []
    return sorted([(first, grids[first] - 1)] + [pairs[i] for i in rest])


def reference_outputs(cfg: dict, trees: Trees, pool: np.ndarray, videos: List[Video], picks: List[tuple],
                      device, mode: str = "fp32") -> list:
    """The plain reference's (frames, scores, class probabilities) of each
    picked grid, at its real frames."""
    prod = Products(mode)
    tower = load_tower(cfg["tower"])
    chunk = tower.reference_chunk(cfg["clip"])
    model = cfg["model"]
    n, l = model["num_segments"], model["seg_length"]
    ids = torch.as_tensor(cfg["prompt_token_ids_padded"], device=device)
    out = []
    with torch.no_grad(), prod.scope():
        text = text_features(trees.clip["text"], cfg["clip"], ids, trees.trainable["prompt_ctx"],
                             trees.trainable["text_projection"], prod)
        for v, g in picks:
            video = videos[v]
            positions = grid_positions(video.frames, g, model).numpy()
            frames = pool[video.offset + positions % video.frames]
            feats = torch.cat([tower.encode(trees.clip["visual"], cfg["clip"],
                                            torch.from_numpy(frames[i:i + chunk]).to(device), prod)
                               for i in range(0, len(frames), chunk)])
            scores, probs = score_grids(feats.reshape(1, n, l, -1), text, trees.trainable, trees.bn,
                                        trees.ncentroid, model, prod)
            real = positions < video.frames
            out.append((positions[real], scores.reshape(-1).cpu().numpy()[real],
                        probs.reshape(n * l, -1).cpu().numpy()[real]))
    return out


GAPS = ("score_gap", "prob_gap", "score_mean_gap", "prob_mean_gap")


def gaps(videos: List[Video], picks: List[tuple], reference: list) -> dict:
    """The gaps between the program's outputs and the reference's at the
    picked grids' frames: the widest (``*_gap``) and the mean (``*_mean_gap``)."""
    score, prob = [], []
    for (v, _), (frames, scores, probs) in zip(picks, reference):
        video = videos[v]
        if video.scores.shape != (video.frames,) or video.probs.shape != (video.frames, probs.shape[-1]):
            return dict.fromkeys(GAPS, float("inf"))
        score.append(np.abs(video.scores[frames] - scores).ravel())
        prob.append(np.abs(video.probs[frames] - probs).ravel())
    score, prob = np.concatenate(score).astype(np.float64), np.concatenate(prob).astype(np.float64)
    if not (np.isfinite(score).all() and np.isfinite(prob).all()):
        return dict.fromkeys(GAPS, float("inf"))
    return {"score_gap": float(score.max()), "prob_gap": float(prob.max()),
            "score_mean_gap": float(score.mean()), "prob_mean_gap": float(prob.mean())}


def run(cell, seed: int, seconds: float, trace: bool, device, setup_clock: Callable[[], float]) -> dict:
    """One run of a scoring cell -> the outcome ``run.py`` reports."""
    cfg, mix = cell.config, cell.mix
    phases = Phases(setup_clock)
    trees = make_trees(cfg, seed, device)
    phases.mark("weights", device)
    pool = frame_pool(mix, cfg["clip"]["image_resolution"], seed, device)
    plan = schedule(mix, seed)
    phases.mark("frames", device)
    scorer = program.Scorer(cfg, trees.clip, trees.trainable, trees.bn, trees.ncentroid, device)
    phases.mark("predictor", device)
    for length in warm_lengths(mix["lengths"], cfg):
        scorer.score(pool[:length])
    phases.mark("warm_up", device)
    setup_s = setup_clock()

    reading: Optional[Reading] = None
    if trace:
        box = {}

        def window():
            calls = scorer.encode_calls
            box["done"], box["s"] = send(scorer, pool, plan, min(seconds, mix["trace_seconds"]), mix["trace_videos"])
            box["calls"] = scorer.encode_calls - calls

        reading = traced(window, device)
        done, window_s = box["done"], box["s"]
        tower = load_tower(cfg["tower"])
        real = sum(v.frames for v in done)
        grids = sum(work.clip_grids(v.frames, cfg) for v in done)
        reading.counters.update(real_frames=real, grids=grids, videos=len(done),
                                encoded_frames=box["calls"] * program.encode_chunk())
        reading.work.update(
            flops=real * tower.flops_per_frame(cfg["clip"]) + grids * work.head_flops_per_grid(cfg),
            peak_flops=work.PEAK_FLOPS[cell.dtype],
            attention_bound_s=(tower.attention_bound_s(cfg["clip"], real, cell.dtype)
                               + work.temporal_attention_bound_s(cfg, grids)))
    else:
        done, window_s = send(scorer, pool, plan, seconds)
    peak = memory_peak(device)
    del scorer
    free()

    start = time.perf_counter()
    picks = pick_grids(done, cfg["check_grids"], cfg, seed)
    numbers = gaps(done, picks, reference_outputs(cfg, trees, pool, done, picks, device))
    phases.times["reference"] = time.perf_counter() - start
    return {
        "end_to_end": {"frames_per_s": sum(v.frames for v in done) / window_s, "setup_s": setup_s},
        "attempted": len(done), "failed": 0, "numbers": numbers, "memory_peak_bytes": peak,
        "reading": reading, "notes": {"videos": len(done), "window_s": window_s, "checked_grids": len(picks),
                                       "seconds": phases.times},
    }


def controls(cell) -> List[str]:
    """The control: the reference in the nearest precision below the
    configuration's, in the program's place."""
    return ["fp8"] if cell.dtype == "bfloat16" else ["tf32"]


def reading(cell, seed: int, device, mode: str) -> dict:
    """The gaps a run compares, on the sample drawn from the first video of the
    seed's schedule alone (no window): ``mode`` "program" for the program as
    configured, or a control's precision for the reference in its place."""
    cfg, mix = cell.config, cell.mix
    trees = make_trees(cfg, seed, device)
    pool = frame_pool(mix, cfg["clip"]["image_resolution"], seed, device)
    offset, length = schedule(mix, seed)[0]
    videos = [Video(offset, length, 0.0, None, None)]
    picks = pick_grids(videos, cfg["check_grids"], cfg, seed)
    if mode == "program":
        scorer = program.Scorer(cfg, trees.clip, trees.trainable, trees.bn, trees.ncentroid, device)
        videos[0].scores, videos[0].probs = scorer.score(pool[offset:offset + length])
        del scorer
        free()
    else:
        videos[0].scores = np.full(length, np.nan, np.float32)
        videos[0].probs = np.full((length, len(cfg["classnames"]) - 1), np.nan, np.float32)
        for frames, scores, probs in reference_outputs(cfg, trees, pool, videos, picks, device, mode=mode):
            videos[0].scores[frames], videos[0].probs[frames] = scores, probs
    numbers = gaps(videos, picks, reference_outputs(cfg, trees, pool, videos, picks, device))
    return {"numbers": numbers, "frames": length, "grids": picks}
