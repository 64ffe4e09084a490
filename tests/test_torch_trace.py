"""The port's spans (``anomalyclip_tpu_torch/utils/trace.py``) on the scoring
and training paths, on the CPU.

- With no profiler session recording, ``Predictor.score_frames`` and
  ``fit_steps`` enter no ``record_function`` of theirs.
- Under a CPU ``torch.profiler`` session, a video gives one span each of
  ``predict.video``, ``predict.cover``, ``evaluator.encode``,
  ``evaluator.grids`` and ``model.score``, and one ``evaluator.stage``,
  ``evaluator.upload``, ``model.encode`` and ``evaluator.fetch`` a 256-frame
  chunk of the covered frames, each inside its parent.
- ``fit_steps`` over k steps gives k ``trainer.step`` spans, each holding one
  ``next_batch``, ``prepare``, ``forward``, ``backward`` and ``optimizer``, and
  one ``epoch_end`` an epoch.
- Every output is bit-identical with the session on and off.
"""

from __future__ import annotations

import math
from collections import Counter
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from anomalyclip_tpu_torch.data import sampling
from anomalyclip_tpu_torch.eval.grids import ENCODE_CHUNK
from anomalyclip_tpu_torch.models.anomaly_clip import AnomalyCLIP, AnomalyCLIPConfig
from anomalyclip_tpu_torch.models.clip.model import CLIPConfig, init_clip_params
from anomalyclip_tpu_torch.models.losses import LossConfig
from anomalyclip_tpu_torch.predict import Predictor
from anomalyclip_tpu_torch.train import module as tmod

PREFIX = "anomalyclip."
SEGMENTS, SEG_LENGTH, NORMAL_ID = 4, 4, 2
VIDEO_FRAMES = 300  # 19 grids of 16: 304 covered frames, two encode chunks
STEP_PARTS = ("next_batch", "prepare", "forward", "backward", "optimizer")


def _model(labels_file: str, from_features: bool):
    clip_cfg = CLIPConfig.tiny()
    net = AnomalyCLIPConfig(labels_file=labels_file, emb_size=64, depth=1, heads=2, num_segments=SEGMENTS,
                            seg_length=SEG_LENGTH, normal_id=NORMAL_ID, load_from_features=from_features)
    model, frozen = AnomalyCLIP.build(net, init_clip_params(torch.Generator().manual_seed(0), clip_cfg), clip_cfg)
    trainable, bn = model.init_trainable(torch.Generator().manual_seed(1), frozen)
    return model, frozen, trainable, bn


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    labels = tmp_path_factory.mktemp("trace") / "labels.csv"
    labels.write_text("id,name\n0,Abuse\n1,Arson\n2,Normal\n3,Robbery\n4,Shooting\n")
    rng = np.random.default_rng(0)
    ncentroid = (0.1 * rng.standard_normal(CLIPConfig.tiny().embed_dim)).astype(np.float32)
    model, frozen, trainable, bn = _model(str(labels), from_features=False)
    cover = SimpleNamespace(num_segments=SEGMENTS, seg_length=SEG_LENGTH, stride=1)
    predictor = Predictor(model, frozen, trainable, bn, ncentroid, sampling=cover, device="cpu")
    res = CLIPConfig.tiny().image_resolution
    video = rng.integers(0, 256, (1, VIDEO_FRAMES, res, res, 3), dtype=np.uint8)
    return SimpleNamespace(labels=str(labels), ncentroid=ncentroid, predictor=predictor, video=video,
                           trainer=_model(str(labels), from_features=True))


def _batches(count: int, dim: int):
    rng = np.random.default_rng(7)
    abnormal = [c for c in range(5) if c != NORMAL_ID]
    return [
        tmod.TrainBatch(
            rng.standard_normal((4, SEGMENTS * SEG_LENGTH, dim)).astype(np.float32),
            np.array([abnormal[(k + i) % len(abnormal)] for i in range(4)], dtype=np.int64),
            rng.standard_normal((4, SEGMENTS * SEG_LENGTH, dim)).astype(np.float32),
            np.full(4, NORMAL_ID, dtype=np.int64),
        )
        for k in range(count)
    ]


def _fit(tiny, batches, epochs: int, steps_per_epoch: int):
    model, frozen, trainable, bn = tiny.trainer
    state = tmod.init_state(trainable, bn, {"lr": 1e-3}, {}, {"warmup_epochs": 0}, steps_per_epoch)
    loss = LossConfig(normal_id=NORMAL_ID, frames_per_segment=SEG_LENGTH, num_segments=SEGMENTS)
    losses = []
    state, history = tmod.fit_steps(
        tmod.build_train_step(model, loss), frozen, state, batches, torch.from_numpy(tiny.ncentroid),
        torch.Generator().manual_seed(3), epochs=epochs, steps_per_epoch=steps_per_epoch,
        on_step=lambda s, terms: losses.append(terms.total.clone()),
    )
    return state, history, losses


def _spans(prof) -> list:
    return [(e.name[len(PREFIX):], e.time_range.start, e.time_range.end)
            for e in prof.events() if e.name.startswith(PREFIX)]


def _inside(child, parent) -> bool:
    return parent[1] <= child[1] and child[2] <= parent[2]


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _spans(prof)


def test_no_session_enters_no_record_function(tiny, monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def counting(name, *args, **kwargs):
        if name.startswith(PREFIX):
            entered.append(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", counting)
    assert not torch.autograd._profiler_enabled()
    tiny.predictor.score_frames(tiny.video)
    _fit(tiny, _batches(2, tiny.trainer[0].clip_cfg.embed_dim), epochs=1, steps_per_epoch=2)
    assert entered == []
    # the same counter sees the spans once a session records
    with profile(activities=[ProfilerActivity.CPU]):
        tiny.predictor.score_frames(tiny.video)
    assert "anomalyclip.predict.video" in entered


def test_a_video_gives_its_spans_nested(tiny):
    (_, _), spans = _traced(lambda: tiny.predictor.score_frames(tiny.video))
    _, segment_size = sampling.test_start_indices(VIDEO_FRAMES, SEGMENTS, SEG_LENGTH, 1)
    chunks = math.ceil(SEGMENTS * segment_size * SEG_LENGTH / ENCODE_CHUNK)
    assert chunks == 2
    counts = Counter(name for name, _, _ in spans)
    assert counts == {"predict.video": 1, "predict.cover": 1, "evaluator.encode": 1, "evaluator.grids": 1,
                      "model.score": 1, "evaluator.stage": chunks, "evaluator.upload": chunks,
                      "model.encode": chunks, "evaluator.fetch": chunks}
    by_name = {name: [s for s in spans if s[0] == name] for name in counts}
    (video,) = by_name["predict.video"]
    parents = {"predict.cover": "predict.video", "evaluator.encode": "predict.video",
               "evaluator.grids": "predict.video", "model.score": "evaluator.grids",
               "evaluator.stage": "evaluator.encode", "evaluator.upload": "evaluator.encode",
               "model.encode": "evaluator.encode", "evaluator.fetch": "evaluator.encode"}
    for child, parent in parents.items():
        (outer,) = by_name[parent]
        assert all(_inside(s, outer) for s in by_name[child]), (child, parent)
    # the chunk's four spans follow one another, chunk by chunk
    chunk_spans = sorted((s for s in spans if s[0] in ("evaluator.stage", "evaluator.upload", "model.encode",
                                                       "evaluator.fetch")), key=lambda s: s[1])
    assert [s[0] for s in chunk_spans] == ["evaluator.stage", "evaluator.upload", "model.encode",
                                           "evaluator.fetch"] * chunks
    assert all(a[2] <= b[1] for a, b in zip(chunk_spans, chunk_spans[1:]))
    assert all(_inside(s, video) for s in spans)


@pytest.mark.parametrize("epochs,steps_per_epoch", [(1, 3), (2, 2)])
def test_fit_steps_gives_a_step_span_a_step(tiny, epochs, steps_per_epoch):
    k = epochs * steps_per_epoch
    (state, history, _), spans = _traced(
        lambda: _fit(tiny, _batches(k, tiny.trainer[0].clip_cfg.embed_dim), epochs, steps_per_epoch))
    assert state.step == k and len(history) == epochs
    counts = Counter(name for name, _, _ in spans)
    assert counts == {"trainer.step": k, "trainer.epoch_end": epochs,
                      **{("model." if part in ("forward", "backward") else "trainer.") + part: k
                         for part in STEP_PARTS}}
    steps = [s for s in spans if s[0] == "trainer.step"]
    for step in steps:
        held = Counter(s[0].split(".")[1] for s in spans if s is not step and _inside(s, step))
        assert held == dict.fromkeys(STEP_PARTS, 1), held
    ends = [s for s in spans if s[0] == "trainer.epoch_end"]
    assert not any(_inside(e, s) for e in ends for s in steps)


def test_a_stream_that_runs_out_leaves_one_step_span_with_its_draw_alone(tiny):
    (state, history, _), spans = _traced(
        lambda: _fit(tiny, _batches(3, tiny.trainer[0].clip_cfg.embed_dim), epochs=5, steps_per_epoch=2))
    assert state.step == 3 and len(history) == 2
    steps = sorted((s for s in spans if s[0] == "trainer.step"), key=lambda s: s[1])
    assert len(steps) == 4
    last = [s[0] for s in spans if s is not steps[-1] and _inside(s, steps[-1])]
    assert last == ["trainer.next_batch"]


def test_outputs_are_bit_identical_with_the_session_on_and_off(tiny):
    off_vs, off_result = tiny.predictor.score_frames(tiny.video)
    (on_vs, on_result), _ = _traced(lambda: tiny.predictor.score_frames(tiny.video))
    np.testing.assert_array_equal(on_vs.scores, off_vs.scores)
    np.testing.assert_array_equal(on_vs.class_probs, off_vs.class_probs)
    np.testing.assert_array_equal(on_vs.similarity, off_vs.similarity)
    assert on_result == off_result

    dim = tiny.trainer[0].clip_cfg.embed_dim
    off_state, off_history, off_losses = _fit(tiny, _batches(4, dim), epochs=2, steps_per_epoch=2)
    (on_state, on_history, on_losses), _ = _traced(lambda: _fit(tiny, _batches(4, dim), epochs=2,
                                                                steps_per_epoch=2))
    assert on_history == off_history
    assert all(torch.equal(a, b) for a, b in zip(on_losses, off_losses))
    off_leaves, on_leaves = tmod.tree_leaves(off_state.trainable), tmod.tree_leaves(on_state.trainable)
    assert len(off_leaves) == len(on_leaves) > 0
    assert all(torch.equal(a, b) for a, b in zip(on_leaves, off_leaves))
    assert torch.equal(on_state.bn_state.mean, off_state.bn_state.mean)
    assert torch.equal(on_state.bn_state.var, off_state.bn_state.var)
