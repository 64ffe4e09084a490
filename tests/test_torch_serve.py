"""The port's serving CLI against the JAX package's, on the CPU.

On the reference Lightning ``.ckpt`` of tests/helpers/torch_serving.py: the
stdin mode writes one ``<stem>.json`` per input, equal to the port's predict
CLI on the same input and within 1e-4 of the JAX ``serve.main``'s (the
tolerance of tests/test_golden.py for fp32 scores); a bad input is logged and
skipped while the inputs around it still score; the watch mode scores a file
once it settles and a frames directory only once its entries stop changing
(the directory is filled while the service polls, on a virtual clock).
"""

from __future__ import annotations

import io
import json
import time
from pathlib import Path

import numpy as np
import pytest

from anomalyclip_tpu import serve as jserve
from anomalyclip_tpu_torch import predict, serve

ROOT = Path(__file__).resolve().parents[1]


def _helpers():
    import importlib.util
    import sys

    name = "_torch_serving_helpers"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, ROOT / "tests" / "helpers" / "torch_serving.py")
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module
        spec.loader.exec_module(module)
    return sys.modules[name]


def _predictions_module():
    import importlib.util
    import sys

    name = "_torch_serving_predict_tests"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, ROOT / "tests" / "test_torch_predict.py")
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module
        spec.loader.exec_module(module)
    return sys.modules[name]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    try:
        s = _helpers().serving_setup(tmp_path_factory.mktemp("serve"), mp)
        s.common = s.common + [f"ncentroid_path={s.ncentroid}"]
        yield s
    finally:
        mp.undo()


def _served(out_dir: Path) -> dict:
    return {p.name: json.loads(p.read_text()) for p in sorted(out_dir.glob("*.json"))}


def test_stdin_mode_matches_predict_and_jax(setup, tmp_path, monkeypatch):
    inputs = [setup.npy, setup.frames]
    feed = "\n".join(str(p) for p in inputs) + "\n"
    monkeypatch.setattr("sys.stdin", io.StringIO(feed))
    assert serve.main(setup.common + ["trainer=cpu", f"output_dir={tmp_path / 'port'}",
                                      f"paths.log_dir={tmp_path / 'logs'}"]) == 0
    got = _served(tmp_path / "port")
    assert set(got) == {"cam.json", "clip_frames.json"}

    # equal to the port's predict on the same input, to the bit
    for path in inputs:
        want = predict.main(setup.common + [f"input={path}", "trainer=cpu", f"paths.log_dir={tmp_path / 'p'}"])
        assert got[f"{path.stem}.json"] == want

    # within the golden tolerance of the JAX service on the same inputs
    monkeypatch.setattr("sys.stdin", io.StringIO(feed))
    assert jserve.main(setup.common + [f"output_dir={tmp_path / 'jax'}", f"paths.log_dir={tmp_path / 'jlogs'}"]) == 0
    want = _served(tmp_path / "jax")
    assert set(want) == set(got)
    for name in got:
        _predictions_module().assert_predictions_close(got[name], want[name])


def test_a_bad_input_is_logged_and_skipped(setup, tmp_path, monkeypatch, capsys):
    missing = tmp_path / "missing.npy"
    monkeypatch.setattr("sys.stdin", io.StringIO(f"{setup.npy}\n{missing}\n{setup.video}\n"))
    assert serve.main(setup.common + ["trainer=cpu", f"output_dir={tmp_path / 'out'}",
                                      f"paths.log_dir={tmp_path / 'logs'}"]) == 0
    assert sorted(p.name for p in (tmp_path / "out").glob("*.json")) == ["cam.json", "clip.json"]
    err = capsys.readouterr().err
    assert f"ERROR {missing}: FileNotFoundError" in err and "served 3 inputs" in err


class _VirtualClock:
    """``serve``'s ``time`` for the watch loop: ``sleep`` advances a virtual
    clock and runs the next step of a filling, so that what the service sees
    at each poll does not depend on the machine's speed."""

    def __init__(self, steps):
        self.now = time.time()
        self.steps = list(steps)

    def time(self) -> float:
        return self.now

    def sleep(self, seconds: float) -> None:
        self.now += seconds
        if self.steps:
            self.steps.pop(0)()


def test_watch_mode_waits_for_a_frames_dir_to_settle(setup, tmp_path, monkeypatch):
    from PIL import Image

    watch = tmp_path / "incoming"
    watch.mkdir()
    (watch / "cam_a.npy").write_bytes(setup.npy.read_bytes())
    late = watch / "cam_b"
    late.mkdir()
    rng = np.random.default_rng(5)

    def add_frame(i):
        def step():
            Image.fromarray(rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)).save(late / f"{i:06d}.jpg")
        return step

    # the directory gains one frame at each poll for six polls, then settles
    clock = _VirtualClock([add_frame(i) for i in range(1, 7)])
    monkeypatch.setattr(serve, "time", clock)
    assert serve.main(setup.common + ["trainer=cpu", f"watch={watch}", "poll_interval=1", "stop_after=12",
                                      f"output_dir={tmp_path / 'out'}", f"paths.log_dir={tmp_path / 'logs'}"]) == 0
    got = _served(tmp_path / "out")
    assert set(got) == {"cam_a.json", "cam_b.json"}
    assert got["cam_b.json"]["num_frames"] == 6  # scored once, whole
    assert got["cam_a.json"] == predict.main(setup.common + [f"input={watch / 'cam_a.npy'}", "trainer=cpu",
                                                            f"paths.log_dir={tmp_path / 'p'}"])


def test_iter_watch_matches_jax_on_the_same_polls(tmp_path, monkeypatch):
    """``_iter_watch``'s settle rule is the JAX package's: the same entries in
    the same order on the same virtual polls."""
    from anomalyclip_tpu import serve as jserve_module

    (tmp_path / "a.npy").write_bytes(b"x")
    (tmp_path / "b.mp4").write_bytes(b"x")
    (tmp_path / "notes.txt").write_bytes(b"x")
    (tmp_path / "frames").mkdir()
    (tmp_path / "frames" / "000001.jpg").write_bytes(b"x")
    orders = []
    for module in (serve, jserve_module):
        clock = _VirtualClock([])
        monkeypatch.setattr(module, "time", clock)
        orders.append(list(module._iter_watch(tmp_path, 1.0, 5.0)))
    assert orders[0] == orders[1] == [tmp_path / "a.npy", tmp_path / "b.mp4", tmp_path / "frames"]
