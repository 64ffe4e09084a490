"""The port's spans in a reading (``spans.py``) and the nine readers of them, on
made-up readings: nested spans, idle gaps, stretches with no span open, a
span that outlasts the window, and a host operator that is not a span."""

from __future__ import annotations

import pytest

from benchmark import spans
from benchmark.cells import load_benchmark, load_metric
from benchmark.trace import Reading

SCORE = ["idle_predict_pct.score", "idle_evaluator_pct.score", "idle_model_pct.score", "idle_untraced_pct.score"]
TRAIN = ["idle_trainer_pct.train", "idle_model_pct.train", "idle_untraced_pct.train"]
READERS = SCORE + TRAIN + ["cover_ms_per_video.score", "prepare_ms_per_step.train"]


def _kernels(*intervals):
    return [("k", "elementwise", float(s), float(e - s)) for s, e in intervals]


def scoring() -> Reading:
    """One video: idle 0-100, 200-300, 350-600, 700-900, 950-1000 (700 us of 1000)."""
    host = [("anomalyclip.predict.video", 50, 980), ("anomalyclip.predict.cover", 60, 250),
            ("anomalyclip.evaluator.encode", 260, 800), ("anomalyclip.evaluator.stage", 260, 320),
            ("anomalyclip.evaluator.upload", 320, 400), ("anomalyclip.model.encode", 400, 500),
            ("anomalyclip.evaluator.fetch", 500, 780), ("anomalyclip.evaluator.grids", 820, 970),
            ("anomalyclip.model.score", 830, 880), ("aten::copy_", 330, 390), ("cudaStreamSynchronize", 520, 770)]
    return Reading(_kernels((100, 200), (300, 350), (600, 700), (900, 950)), [], host, (0.0, 1000.0), 1e-3,
                   {"videos": 2})


def training() -> Reading:
    """Two steps and an epoch's end that outlasts the window: idle 460 us of 1000."""
    host = []
    for start, parts in ((10, (50, 150, 300, 400, 480, 490)), (500, (520, 600, 700, 800, 950, 990))):
        edges = (start,) + parts
        host.append(("anomalyclip.trainer.step", start, parts[-1]))
        for name, s, e in zip(("trainer.next_batch", "trainer.prepare", "model.forward", "model.backward",
                               "trainer.optimizer"), edges, edges[1:]):
            host.append((f"anomalyclip.{name}", s, e))
    host.append(("anomalyclip.trainer.epoch_end", 990, 1100))
    kernels = _kernels((100, 140), (160, 290), (310, 390), (420, 470), (560, 590), (610, 690), (710, 790),
                       (850, 900))
    copies = [("Memcpy HtoD (Pageable -> Device)", 560.0, 10.0)]
    return Reading(kernels, copies, host, (0.0, 1000.0), 1e-3, {"steps": 2})


def test_idle_by_span_and_layer_in_a_video():
    r = scoring()
    by_span = spans.idle_by_span(r)
    want = {"untraced": 70, "anomalyclip.predict.video": 50, "anomalyclip.predict.cover": 90,
            "anomalyclip.evaluator.stage": 40, "anomalyclip.evaluator.upload": 50, "anomalyclip.model.encode": 100,
            "anomalyclip.evaluator.fetch": 180, "anomalyclip.evaluator.encode": 20,
            "anomalyclip.evaluator.grids": 50, "anomalyclip.model.score": 50}
    assert by_span == pytest.approx({k: v * 1e-6 for k, v in want.items()})
    assert spans.idle_by_layer(r) == pytest.approx({"untraced": 70e-6, "predict": 140e-6, "evaluator": 340e-6,
                                                    "model": 150e-6})
    assert spans.span_s(r, "anomalyclip.predict.cover") == pytest.approx(190e-6)


def test_idle_by_span_in_training_clips_to_the_window():
    r = training()
    by_span = spans.idle_by_span(r)
    assert by_span["anomalyclip.trainer.epoch_end"] == pytest.approx(10e-6)
    assert by_span["anomalyclip.trainer.prepare"] == pytest.approx(110e-6)
    assert by_span["anomalyclip.trainer.optimizer"] == pytest.approx(130e-6)
    assert spans.idle_by_layer(r) == pytest.approx({"untraced": 20e-6, "trainer": 360e-6, "model": 80e-6})
    assert spans.span_s(r, "anomalyclip.trainer.epoch_end") == pytest.approx(10e-6)


@pytest.mark.parametrize("reading,readers,whole", [(scoring, SCORE, "device_idle_pct.score"),
                                                   (training, TRAIN, "device_idle_pct.train")])
def test_layer_shares_add_up_to_the_idle_share(reading, readers, whole):
    r = reading()
    assert sum(load_metric(name)(r) for name in readers) == pytest.approx(load_metric(whole)(r), abs=1e-9)


def test_the_readers():
    r, t = scoring(), training()
    assert [load_metric(name)(r) for name in SCORE] == pytest.approx([14.0, 34.0, 15.0, 7.0])
    assert [load_metric(name)(t) for name in TRAIN] == pytest.approx([36.0, 8.0, 2.0])
    assert load_metric("cover_ms_per_video.score")(r) == pytest.approx(0.095)
    assert load_metric("prepare_ms_per_step.train")(t) == pytest.approx(0.09)
    # a layer with no span in the reading reads nothing
    assert load_metric("idle_trainer_pct.train")(r) is None
    assert load_metric("idle_predict_pct.score")(t) is None
    assert spans.idle_pct(t, "untraced") == pytest.approx(2.0)


@pytest.mark.parametrize("name", READERS)
def test_readers_find_nothing_without_spans(name):
    empty = Reading([], [], [], (0.0, 1000.0), 1e-3)
    assert load_metric(name)(empty) is None
    # the parent's program: kernels, idle and host operators, but no span of the port
    r = scoring()
    r.host = [h for h in r.host if not h[0].startswith(spans.PREFIX)]
    assert load_metric(name)(r) is None


def test_the_entries():
    entries = {m["name"]: m for m in load_benchmark()["per_layer"]}
    assert {n for n, m in entries.items() if m["source"] == "program_span"} == set(READERS)
    for name in READERS:
        assert entries[name]["moves"] == ("frames_per_s" if name.endswith(".score") else "train_step_ms")


def test_split():
    out = spans.split(training())
    assert out["spans"]["anomalyclip.trainer.step"] == {"count": 2, "host_s": pytest.approx(970e-6)}
    assert sum(out["idle_s_by_span"].values()) == pytest.approx(sum(out["idle_s_by_layer"].values()))
    assert out["window_s"] - out["busy_s"] == pytest.approx(460e-6)
