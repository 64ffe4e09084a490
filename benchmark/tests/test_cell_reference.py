"""The plain reference against the port at tiny sizes on the CPU: part by
part, and whole runs of both kinds of cell through the harness."""

from __future__ import annotations

import time

import pytest
import torch

from benchmark.cells import load_driver
from benchmark.reference import clip as ref_clip
from benchmark.reference.anomaly import score_clip
from benchmark.reference.precision import Products, round_tf32
from benchmark.run import execute, judge
from benchmark.tests.tiny import tiny_cell

SEED = 2**31 + 777
CPU = torch.device("cpu")
CLIPS = load_driver("clips")
TRAIN = load_driver("train")


@pytest.fixture(scope="module")
def tiny():
    cell = tiny_cell("clips")
    trees = CLIPS.make_trees(cell.config, SEED, CPU)
    pool = CLIPS.frame_pool(cell.mix, cell.config["clip"]["image_resolution"], SEED, CPU)
    return cell, trees, pool


def test_image_tower(tiny):
    from anomalyclip_tpu_torch.models.clip.model import CLIPConfig, encode_image

    cell, trees, pool = tiny
    clip = cell.config["clip"]
    frames = torch.from_numpy(pool[:5])
    ours = ref_clip.encode_frames(trees.clip["visual"], clip, frames, Products())
    theirs = encode_image(trees.clip, CLIPConfig(**clip), frames, torch.float32)
    assert torch.allclose(ours, theirs, atol=1e-5, rtol=1e-5)


def test_text_tower_and_prompts(tiny):
    from benchmark import program

    cell, trees, _ = tiny
    scorer = program.Scorer(cell.config, trees.clip, trees.trainable, trees.bn, trees.ncentroid, CPU)
    ids = torch.as_tensor(cell.config["prompt_token_ids_padded"])
    ours = ref_clip.text_features(trees.clip["text"], cell.config["clip"], ids, trees.trainable["prompt_ctx"],
                                  trees.trainable["text_projection"], Products())
    assert torch.allclose(ours, scorer.predictor.scorer.text_features, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("length", [5, 16, 17, 40])  # under, at, over one grid; three grids
def test_video_scores_grid_by_grid(tiny, length):
    from benchmark import program

    cell, trees, pool = tiny
    scorer = program.Scorer(cell.config, trees.clip, trees.trainable, trees.bn, trees.ncentroid, CPU)
    scores, probs = scorer.score(pool[:length])
    assert scores.shape == (length,) and probs.shape == (length, 13)
    video = CLIPS.Video(0, length, 0.0, scores, probs)
    grids = -(-length // 16)
    picks = [(0, g) for g in range(grids)]
    ref = CLIPS.reference_outputs(cell.config, trees, pool, [video], picks, CPU)
    assert sorted(int(f) for frames, _, _ in ref for f in frames) == list(range(length))
    numbers = CLIPS.gaps([video], picks, ref)
    assert numbers["score_gap"] < 1e-5 and numbers["prob_gap"] < 1e-5


def test_grid_scores_match_the_whole_video(tiny):
    """A grid scored alone reads as the same grid scored with the rest of its video."""
    cell, trees, pool = tiny
    cfg = cell.config
    feats = ref_clip.encode_frames(trees.clip["visual"], cfg["clip"], torch.from_numpy(pool[:40]), Products())
    ids = torch.as_tensor(cfg["prompt_token_ids_padded"])
    text = ref_clip.text_features(trees.clip["text"], cfg["clip"], ids, trees.trainable["prompt_ctx"],
                                  trees.trainable["text_projection"], Products())
    whole, _ = score_clip(feats, text, trees.trainable, trees.bn, trees.ncentroid, cfg["model"], Products())
    video = CLIPS.Video(0, 40, 0.0, whole.numpy(), None)
    for (frames, scores, _) in CLIPS.reference_outputs(cfg, trees, pool, [video], [(0, 0), (0, 2)], CPU):
        assert abs(whole.numpy()[frames] - scores).max() < 1e-5


@pytest.mark.parametrize("kind", ["clips", "train"])
def test_whole_run_is_correct(kind):
    cell = tiny_cell(kind)
    start = time.perf_counter()
    out = execute(cell, SEED, 0.5, False, CPU, lambda: time.perf_counter() - start)
    correct, checks = judge(out["numbers"], cell.limits)
    assert correct, checks
    assert all(v < 1e-5 for _, v, _ in checks), checks
    assert out["attempted"] > 0 and out["end_to_end"]["setup_s"] > 0


def test_training_follows_the_reference_step_by_step():
    cell = tiny_cell("train")
    cfg = cell.config
    from benchmark import program, weights

    clip = weights.clip_tree(cfg, SEED, CPU, visual=False)
    trainable, bn, ncentroid = weights.head_trees(cfg, SEED, CPU, clip["text"]["text_projection"])
    batches = TRAIN.feature_pool(cell.mix, cfg, SEED, CPU)
    first = cell.mix["start_epoch"] * cfg["epoch_steps"]
    trainer = program.Trainer(cfg, clip, trainable, bn, ncentroid, first, CPU)
    prog = TRAIN.first_steps(trainer, batches, weights.generator(SEED, "masks", CPU), 3)
    ref = TRAIN.reference_steps(cfg, clip["text"], trainable, bn, ncentroid, batches, SEED, first, 3, CPU)
    for p, r in zip(prog["losses"], ref["losses"]):
        assert p == pytest.approx(r, rel=1e-5)
    for key, tol in (("grads", 1e-5), ("change", 1e-4)):
        for p, r in zip(prog[key], ref[key]):
            assert float(r.norm()) > 0 and float((p - r).norm() / r.norm()) < tol, key


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-10, 1.0 + 3 * 2**-11, -3.0 + 2**-20])
    assert round_tf32(x).tolist() == [1.0, 1.0, 1.0 + 2**-10, 1.0 + 2**-9, -3.0]


def test_reference_scores_cover_a_video_by_whole_grids():
    """score_clip's grid layout by hand: chunk c of l frames is segment c // s of grid c % s."""
    cfg = tiny_cell("clips").config
    n, l = cfg["model"]["num_segments"], cfg["model"]["seg_length"]
    t = 2 * n * l - 3
    feats = torch.arange(t, dtype=torch.float32)[:, None].repeat(1, 64)
    seen = {}

    def fake_temporal(x, tp, heads, prod):
        seen["grids"] = x[..., 0].clone()
        return torch.zeros(x.shape[:3])

    import benchmark.reference.anomaly as anomaly

    original = anomaly.temporal_scores
    anomaly.temporal_scores = fake_temporal
    try:
        text = torch.randn(14, 64)
        score_clip(feats, text, {"temporal": None}, (torch.zeros(13), torch.ones(13)), torch.zeros(64),
                   cfg["model"], Products())
    finally:
        anomaly.temporal_scores = original
    grids = seen["grids"]  # (s, n, l) of frame ids
    s = 2
    for c in range(s * n):
        frames = [(c * l + i) % t for i in range(l)]
        assert grids[c % s, c // s].tolist() == frames
