"""Each mix's output repeats for a seed, and every seed sends the same sizes."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.cells import load_driver, load_mix
from benchmark.tests.tiny import tiny_cell

SEED = 2**31 + 12345
CLIPS = load_driver("clips")
TRAIN = load_driver("train")


def test_video_schedule_repeats_and_keeps_its_sizes():
    mix = load_mix("clips")
    a, b = CLIPS.schedule(mix, SEED), CLIPS.schedule(mix, SEED)
    assert a == b
    other = CLIPS.schedule(mix, SEED + 1)
    assert other != a
    assert mix["lengths"] == [7247] and len(a) == mix["cycles"]
    for sched in (a, other):
        assert {n for _, n in sched} == {7247}
        assert all(0 <= off and off + n <= mix["pool_frames"] for off, n in sched)


def test_every_cycle_sends_every_length_once():
    mix = tiny_cell("clips").mix
    sched = CLIPS.schedule(mix, SEED)
    cycle = len(mix["lengths"])
    for c in range(mix["cycles"]):
        assert sorted(n for _, n in sched[c * cycle:(c + 1) * cycle]) == sorted(mix["lengths"])


def test_warm_up_meets_every_bucket_at_its_shortest():
    cfg = tiny_cell("clips").config  # 16 frames a grid
    # 40 frames: 3 grids, bucket 4, shortest 33; 17: 2 grids, bucket 2, shortest 17; 5: 1 grid, bucket 1
    assert CLIPS.warm_lengths([40, 17, 5], cfg) == [1, 17, 33]
    full = load_mix("clips")
    from benchmark.cells import load_config

    # 7,247 frames: 15 grids of 512, bucket 16, whose shortest video is 8 grids and a frame
    assert CLIPS.warm_lengths(full["lengths"], load_config("ucfcrime-vitb16")) == [4097]


def test_grid_sample_holds_a_last_grid_and_repeats():
    cfg = tiny_cell("clips").config
    videos = [CLIPS.Video(0, n, 0.0, None, None) for n in (40, 17, 5)]
    picks = CLIPS.pick_grids(videos, 3, cfg, SEED)
    assert picks == CLIPS.pick_grids(videos, 3, cfg, SEED) and len(set(picks)) == 3
    last = {(0, 2), (1, 1), (2, 0)}
    assert last & set(picks)
    assert all(0 <= g < -(-videos[v].frames // 16) for v, g in picks)


def test_frame_and_feature_pools_repeat():
    cell = tiny_cell("clips")
    cpu = torch.device("cpu")
    p1 = CLIPS.frame_pool(cell.mix, 32, SEED, cpu)
    p2 = CLIPS.frame_pool(cell.mix, 32, SEED, cpu)
    assert p1.dtype == np.uint8 and p1.shape == (cell.mix["pool_frames"], 32, 32, 3)
    assert np.array_equal(p1, p2)
    assert not np.array_equal(p1, CLIPS.frame_pool(cell.mix, 32, SEED + 1, cpu))
    tcell = tiny_cell("train")
    f1 = TRAIN.feature_pool(tcell.mix, tcell.config, SEED, cpu)
    f2 = TRAIN.feature_pool(tcell.mix, tcell.config, SEED, cpu)
    assert len(f1) == tcell.mix["pool_batches"]
    for x, y in zip(f1, f2):
        for u, v in zip(x, y):
            assert np.array_equal(u, v)
    abn_labels, nor_labels = f1[0][1], f1[0][3]
    assert (abn_labels != 7).all() and (nor_labels == 7).all()
