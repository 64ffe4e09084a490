"""The port's predict CLI against the JAX package's, on the CPU.

Both packages read one reference Lightning ``.ckpt`` with a tiny CLIP, built
here (tests/helpers/torch_serving.py), and score the same inputs: a feature
``.npy``, a directory of JPEG frames and a video file. Held: the predictions
(scores and top-class probabilities within 1e-4, the tolerance of
tests/test_golden.py for fp32 scores; lengths, class names and keys equal),
``input_start_frame``, the ncentroid's resolution order, and
``Predictor.score_frames`` carrying the input's path and start frame.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest

from anomalyclip_tpu import predict as jpredict
from anomalyclip_tpu_torch import predict

ROOT = Path(__file__).resolve().parents[1]
SERVING = ROOT / "tests" / "helpers" / "torch_serving.py"
SCORE_TOL = 1e-4


def _helpers():
    import importlib.util
    import sys

    name = "_torch_serving_helpers"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, SERVING)
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module
        spec.loader.exec_module(module)
    return sys.modules[name]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    try:
        yield _helpers().serving_setup(tmp_path_factory.mktemp("predict"), mp)
    finally:
        mp.undo()


def assert_predictions_close(got: dict, want: dict) -> None:
    """Two predictions dicts of one input: the same keys, lengths and class
    names, scores and top-class probabilities within SCORE_TOL; a top class
    may differ only where its probability ties another within SCORE_TOL."""
    assert got.keys() == want.keys()
    for key in ("num_frames", "classnames_abnormal", "class_probs_shape"):
        assert got[key] == want[key], key
    np.testing.assert_allclose(got["frame_scores"], want["frame_scores"], rtol=0, atol=SCORE_TOL)
    np.testing.assert_allclose(got["frame_top_class_prob"], want["frame_top_class_prob"], rtol=0,
                               atol=SCORE_TOL)
    assert abs(got["video_anomaly_score"] - want["video_anomaly_score"]) <= SCORE_TOL
    flips = sum(g != w for g, w in zip(got["frame_top_class"], want["frame_top_class"]))
    assert flips <= max(1, got["num_frames"] // 50), flips


@pytest.mark.parametrize("form", ["npy", "frames", "video"])
def test_predict_main_matches_jax(setup, tmp_path, form):
    argv = setup.common + [f"input={getattr(setup, form)}", f"ncentroid_path={setup.ncentroid}"]
    want = jpredict.main(argv + [f"output={tmp_path / 'jax.json'}", f"paths.log_dir={tmp_path / 'jax'}"])
    got = predict.main(argv + ["trainer=cpu", f"output={tmp_path / 'port.json'}",
                               f"paths.log_dir={tmp_path / 'port'}"])
    assert json.loads((tmp_path / "port.json").read_text()) == got
    assert got["input"] == str(getattr(setup, form)) == want["input"]
    assert_predictions_close(got, want)
    assert got["num_frames"] == {"npy": 70, "frames": 40, "video": 24}[form]
    assert all(0.0 <= s <= 1.0 for s in got["frame_scores"])


def test_predict_main_needs_a_card_unless_asked_for_the_cpu(setup):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        predict.main(setup.common + [f"input={setup.npy}"])


def test_input_start_frame_matches_jax(setup):
    for path in (setup.frames, setup.npy, setup.video, setup.tmp / "missing"):
        assert predict.input_start_frame(path) == jpredict.input_start_frame(path)
        assert predict.input_start_frame(str(path)) == jpredict.input_start_frame(str(path))
    assert predict.input_start_frame(setup.frames) == 1


def test_load_input_matches_jax(setup):
    cfg = {"ncrops": 1, "image_tmpl": "{:06d}.jpg", "fast_decode": False}
    for form in ("npy", "frames", "video"):
        got = predict._load_input(getattr(setup, form), cfg, 32)
        want = jpredict._load_input(getattr(setup, form), cfg, 32)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="needs an encoder"):
        predict._load_input(setup.frames, cfg, 0)
    with pytest.raises(ValueError, match="unrecognized input"):
        predict._load_input(setup.tmp / "notes.txt", cfg, 32)


def test_ncentroid_resolution_order(setup, tmp_path):
    """``ncentroid_path=`` first, then ``ncentroid.npy`` beside the run dir,
    then beside the checkpoint, else None; as the JAX package resolves it."""
    ckpt = tmp_path / "run" / "checkpoints" / "last"
    ckpt.mkdir(parents=True)
    values = {name: np.full(4, i, np.float32) for i, name in enumerate(("explicit", "run", "ckpt"))}
    np.save(tmp_path / "explicit.npy", values["explicit"])

    def resolved(cfg):
        got = predict._resolve_ncentroid(cfg, str(ckpt))
        want = jpredict._resolve_ncentroid(cfg, str(ckpt))
        assert (got is None) == (want is None)
        if got is not None:
            np.testing.assert_array_equal(got, want)
        return got

    assert resolved({}) is None
    np.save(ckpt.parent / "ncentroid.npy", values["ckpt"])
    np.testing.assert_array_equal(resolved({}), values["ckpt"])
    np.save(tmp_path / "run" / "ncentroid.npy", values["run"])
    np.testing.assert_array_equal(resolved({}), values["run"])
    np.testing.assert_array_equal(resolved({"ncentroid_path": str(tmp_path / "explicit.npy")}),
                                  values["explicit"])


def test_predict_main_reads_the_ncentroid_beside_the_run(setup, tmp_path):
    """Without ``ncentroid_path=``, main scores with the ``ncentroid.npy`` of the
    checkpoint's run dir: the same predictions as passing the file."""
    run_nc = setup.ckpt.parent.parent / "ncentroid.npy"
    np.save(run_nc, np.load(setup.ncentroid))
    try:
        got = predict.main(setup.common + [f"input={setup.npy}", "trainer=cpu",
                                           f"paths.log_dir={tmp_path / 'a'}"])
    finally:
        run_nc.unlink()
    want = predict.main(setup.common + [f"input={setup.npy}", "trainer=cpu", f"ncentroid_path={setup.ncentroid}",
                                        f"paths.log_dir={tmp_path / 'b'}"])
    assert got == want


def test_score_frames_carries_path_and_start_frame(setup, tmp_path):
    """``Predictor.score_frames`` runs ``score_input``'s code: on the module's
    own model and state it gives score_input's result, the input's path and,
    for a frames directory, its 1-based start frame."""
    from anomalyclip_tpu_torch.config import compose, default_config_dir, to_dict

    cfg = to_dict(compose(default_config_dir(), "eval", setup.common + [
        f"ncentroid_path={setup.ncentroid}", f"paths.log_dir={tmp_path}"]))
    module, state = predict.load_module_and_state(cfg, "cpu")
    raw = predict._load_input(setup.frames, cfg["data"], 32)
    vs, result = predict.score_input(module, state, raw, str(setup.frames))
    assert vs.path == str(setup.frames) and vs.start_frame == 1

    predictor = predict.Predictor(module.model, module.frozen, state.trainable, state.bn_state,
                                  module.ncentroid, device="cpu", sampling=module.datamodule.cfg)
    pvs, presult = predictor.score_frames(raw, str(setup.frames))
    assert pvs.path == str(setup.frames) and pvs.start_frame == 1
    assert presult == result
    np.testing.assert_array_equal(pvs.scores, vs.scores)
    nvs, nresult = predictor.score_frames(raw)
    assert nvs.path is None and nvs.start_frame == 0 and nresult["input"] is None
    np.testing.assert_array_equal(nvs.scores, vs.scores)
    # from a .npy, the start frame is 0 (no frame files)
    feats = predict._load_input(setup.npy, cfg["data"], 32)
    fvs, _ = predictor.score_frames(feats, str(setup.npy))
    assert fvs.start_frame == 0
