"""The port's serving artifact (anomalyclip_tpu_torch/export.py, ``torch.export``)
against its checkpoint-backed scoring and the JAX package's artifact, on the
CPU.

- ports of the eight tests of tests/test_export.py: the score graph at several
  grid counts from one export, the encode graph with uint8 normalized on the
  host, meta and the version guard, the shape guard, per-video scoring from
  features and from frames, the export CLI through predict and the eval
  entry's ``artifact=``, and predict and serve in artifact mode. The port's
  artifact is held within 1e-6 of the port's checkpoint-backed scoring
  (the same functions, traced);
- the port's artifact against the JAX artifact exported from the same weights,
  at the tolerance of tests/test_golden.py (1e-4);
- ``torch.library.opcheck`` on every registered attention operator, and each
  operator's CPU implementation equal to its entry's plain version to the bit;
- loading an artifact imports none of the model's modules.
"""

from __future__ import annotations

import io
import json
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from anomalyclip_tpu import eval_entry as jeval_entry
from anomalyclip_tpu import export as jexport
from anomalyclip_tpu_torch import convert, eval_entry, graft_entry, predict, serve
from anomalyclip_tpu_torch.data.dataset import TestItem
from anomalyclip_tpu_torch.data import sampling
from anomalyclip_tpu_torch.eval.evaluator import GridScorer, score_video
from anomalyclip_tpu_torch.export import ServingArtifact, export_serving_artifact
from anomalyclip_tpu_torch.models.anomaly_clip import AnomalyCLIP
from anomalyclip_tpu_torch.models.clip.model import CLIPConfig
from anomalyclip_tpu_torch.ops import attention as tattn

ROOT = Path(__file__).resolve().parents[1]
CLASSNAMES = ["alpha", "beta", "normal", "omega"]
SAME = 1e-6  # the artifact against the checkpoint-backed scoring it traces
GOLDEN = 1e-4  # the port against the JAX package (tests/test_golden.py)
METRICS = ("auc_roc", "auc_pr", "mean_mc_auroc", "mean_mc_aupr")


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """The JAX package's tiny model (``__graft_entry__._build_tiny``), its
    weights converted into the port's, and an artifact of each package."""
    jmodel, jfrozen, jtrainable, jbn = ge._build_tiny()
    model, _, _, _ = graft_entry._build_tiny()
    clip_cfg = CLIPConfig(**{f: getattr(jmodel.clip_cfg, f) for f in jmodel.clip_cfg.__dataclass_fields__})
    frozen = convert.params_from_jax(_np_tree(jfrozen), device="cpu")
    model, frozen = AnomalyCLIP.build(model.cfg, frozen["clip"], clip_cfg)
    trainable = convert.params_from_jax(_np_tree(jtrainable), device="cpu")
    bn_state = convert.bn_state_from_jax(jbn, device="cpu")
    ncentroid = np.random.default_rng(0).standard_normal(model.embedding_dim).astype(np.float32)
    out = tmp_path_factory.mktemp("artifact")
    export_serving_artifact(model, frozen, trainable, bn_state, ncentroid, out / "port",
                            include_encoder=True, classnames=CLASSNAMES)
    jexport.export_serving_artifact(jmodel, jfrozen, jtrainable, jbn, ncentroid, out / "jax",
                                    include_encoder=True, classnames=CLASSNAMES)
    scorer = GridScorer(model, frozen, trainable, bn_state, ncentroid, device="cpu")
    return SimpleNamespace(model=model, scorer=scorer, out=out / "port", jax_out=out / "jax",
                           art=ServingArtifact.load(out / "port", device="cpu"),
                           state=(frozen, trainable, bn_state, ncentroid))


def test_score_parity_across_grid_counts(exported):
    """One symbolic-g graph equals the GridScorer at several g."""
    model, scorer, art = exported.model, exported.scorer, exported.art
    rng = np.random.default_rng(1)
    n, l, d = model.cfg.num_segments, model.cfg.seg_length, model.embedding_dim
    for g in (1, 2, 3, 5):
        grids = rng.standard_normal((g, n, l, d)).astype(np.float32)
        sim_ref, sc_ref = scorer.score_grids(grids)
        sim_art, sc_art = art.score(grids)
        assert sim_art.shape == (g * n * l, len(CLASSNAMES) - 1) and sc_art.shape == (g * n * l,)
        np.testing.assert_allclose(sim_art, sim_ref, rtol=0, atol=SAME)
        np.testing.assert_allclose(sc_art, sc_ref, rtol=0, atol=SAME)


def test_encode_parity_and_uint8_normalization(exported):
    """The encode graph (uint8 normalized on the host) equals the scorer's
    encoder (uint8 normalized on the device); float frames pass as they are."""
    side = int(exported.model.clip_cfg.image_resolution)
    frames_u8 = np.random.default_rng(2).integers(0, 256, (5, side, side, 3), dtype=np.uint8)
    ref = exported.scorer.encode_frames_np(frames_u8)
    got = exported.art.encode(frames_u8)
    assert got.shape == ref.shape == (5, exported.model.clip_cfg.embed_dim)
    np.testing.assert_allclose(got, ref, rtol=0, atol=SAME)
    from anomalyclip_tpu_torch.data.sources import normalize_frames

    np.testing.assert_allclose(exported.art.encode(normalize_frames(frames_u8)), ref, rtol=0, atol=SAME)


def test_meta_and_version_guard(exported, tmp_path):
    meta = json.loads((exported.out / "meta.json").read_text())
    jmeta = json.loads((exported.jax_out / "meta.json").read_text())
    assert meta["format_version"] == 1
    assert meta["classnames"] == CLASSNAMES
    assert meta["grid"] == jmeta["grid"] and meta["grid"]["num_segments"] == 8 and meta["grid"]["seg_length"] == 4
    assert meta["normal_id"] == jmeta["normal_id"]
    assert {k: v for k, v in meta["encode"].items() if k != "platforms"} == {
        k: v for k, v in jmeta["encode"].items() if k != "platforms"}
    assert meta["score_platforms"] == meta["encode"]["platforms"] == ["cpu", "cuda"]
    assert meta["torch_version"] == torch.__version__ and "jax_version" not in meta

    newer = tmp_path / "newer"
    shutil.copytree(exported.out, newer)
    meta["format_version"] = 99
    (newer / "meta.json").write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="newer"):
        ServingArtifact.load(newer, device="cpu")


def test_score_shape_guard(exported):
    with pytest.raises(ValueError, match="exported"):
        exported.art.score(np.zeros((2, 3, 3, 7), np.float32))


def _reference_video_scores(model, scorer, raw):
    """The checkpoint-backed per-video pipeline (predict.score_input's core):
    test-time sampling and score_video on a TestItem."""
    t_raw = raw.shape[1]
    cfg = model.cfg
    starts, segment_size = sampling.test_start_indices(t_raw, cfg.num_segments, cfg.seg_length, cfg.stride)
    indices = sampling.gather_frame_indices(starts, cfg.seg_length, cfg.stride, t_raw)
    item = TestItem(features=raw[:, indices], frame_labels=np.full(t_raw, int(cfg.normal_id), dtype=np.int64),
                    video_label=int(cfg.normal_id), segment_size=segment_size, path="x")
    return score_video(item, scorer, model)


def _assert_video_close(got: tuple, vs, atol: float) -> None:
    sim, sc, probs = got
    assert sim.shape == vs.similarity.shape and sc.shape == vs.scores.shape
    np.testing.assert_allclose(sim, vs.similarity, rtol=0, atol=atol)
    np.testing.assert_allclose(sc, vs.scores, rtol=0, atol=atol)
    np.testing.assert_allclose(probs, vs.class_probs, rtol=0, atol=atol)


def test_artifact_score_video_matches_evaluator_features(exported):
    """At a length that is not a multiple of n*l: covering pad and trim."""
    raw = np.random.default_rng(3).standard_normal((1, 77, exported.model.embedding_dim)).astype(np.float32)
    vs = _reference_video_scores(exported.model, exported.scorer, raw)
    _assert_video_close(exported.art.score_video(raw), vs, SAME)


def test_artifact_score_video_matches_evaluator_frames(exported):
    """The from-frames branch: the encode graph feeding the score graph."""
    side = int(exported.model.clip_cfg.image_resolution)
    raw = np.random.default_rng(4).integers(0, 256, (1, 37, side, side, 3), dtype=np.uint8)
    vs = _reference_video_scores(exported.model, exported.scorer, raw)
    _assert_video_close(exported.art.score_video(raw), vs, SAME)


def test_port_artifact_matches_the_jax_artifact(exported):
    """Both packages' artifacts of the same weights: the score graph at
    several g, the encode graph and a whole video from frames."""
    jart = jexport.ServingArtifact.load(exported.jax_out)
    model, art = exported.model, exported.art
    rng = np.random.default_rng(6)
    n, l, d = model.cfg.num_segments, model.cfg.seg_length, model.embedding_dim
    for g in (1, 3):
        grids = rng.standard_normal((g, n, l, d)).astype(np.float32)
        for ours, theirs in zip(art.score(grids), jart.score(grids)):
            np.testing.assert_allclose(ours, np.asarray(theirs), rtol=0, atol=GOLDEN)
    side = int(model.clip_cfg.image_resolution)
    raw = rng.integers(0, 256, (1, 21, side, side, 3), dtype=np.uint8)
    np.testing.assert_allclose(art.encode(raw[0]), np.asarray(jart.encode(raw[0]), np.float32), rtol=0,
                               atol=GOLDEN)
    for ours, theirs in zip(art.score_video(raw), jart.score_video(raw)):
        np.testing.assert_allclose(ours, theirs, rtol=0, atol=GOLDEN)
    assert art.predict(raw, "v").keys() == jart.predict(raw, "v").keys()
    # the leaves are the same numbers: the text features, the temporal tree,
    # the BN state and the ncentroid
    with np.load(exported.out / "score_params.npz") as ours, np.load(exported.jax_out / "score_params.npz") as theirs:
        assert sorted(float(np.abs(ours[k]).sum()) for k in ours.files if k.startswith("leaf_")) == pytest.approx(
            sorted(float(np.abs(theirs[k]).sum()) for k in theirs.files if k.startswith("leaf_")), rel=1e-5)


def test_predict_and_serve_artifact_mode(exported, tmp_path, monkeypatch):
    """The config-free surfaces: predict artifact=... and serve artifact=...
    give the predictions schema from a feature .npy, equal to the JAX
    artifact's within the golden tolerance."""
    rng = np.random.default_rng(5)
    feats = rng.standard_normal((50, exported.model.embedding_dim)).astype(np.float32)
    npy = tmp_path / "cam.npy"
    np.save(npy, feats)
    want = exported.art.predict(feats[None], str(npy))
    assert want["num_frames"] == 50 and len(want["frame_scores"]) == 50
    assert all(0.0 <= s <= 1.0 for s in want["frame_scores"])
    assert want["classnames_abnormal"] == ["alpha", "beta", "omega"]
    jwant = jexport.ServingArtifact.load(exported.jax_out).predict(feats[None], str(npy))
    np.testing.assert_allclose(want["frame_scores"], jwant["frame_scores"], rtol=0, atol=GOLDEN)

    out_json = tmp_path / "pred.json"
    got = predict.main([f"artifact={exported.out}", f"input={npy}", f"output={out_json}", "trainer=cpu"])
    assert got == want and json.loads(out_json.read_text()) == want

    served_dir = tmp_path / "served"
    monkeypatch.setattr("sys.stdin", io.StringIO(f"{npy}\n"))
    assert serve.main([f"artifact={exported.out}", f"output_dir={served_dir}", "trainer=cpu"]) == 0
    assert json.loads((served_dir / "cam.json").read_text()) == want
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            predict.main([f"artifact={exported.out}", f"input={npy}"])


def test_artifact_without_encoder_refuses_frames(exported, tmp_path):
    export_serving_artifact(exported.model, *exported.state, tmp_path / "noenc", include_encoder=False,
                            classnames=CLASSNAMES)
    art = ServingArtifact.load(tmp_path / "noenc", device="cpu")
    assert art.meta["encode"] is None and not (tmp_path / "noenc" / "encode.pt2").exists()
    with pytest.raises(ValueError, match="without the encoder"):
        art.encode(np.zeros((2, 32, 32, 3), np.uint8))
    frames = tmp_path / "frames"
    frames.mkdir()
    with pytest.raises(ValueError, match="needs an encoder"):
        predict._load_input(frames, {}, 0)


def test_loading_an_artifact_builds_no_model(exported):
    """``ServingArtifact.load`` and a scoring call import the ops package and
    the numpy helpers only: none of the model's modules."""
    probe = (
        "import json, sys, numpy as np\n"
        "from anomalyclip_tpu_torch.export import ServingArtifact\n"
        f"art = ServingArtifact.load({str(exported.out)!r}, device='cpu')\n"
        "art.score_video(np.zeros((1, 40, art.meta['grid']['feature_dim']), np.float32))\n"
        "art.encode(np.zeros((3, 32, 32, 3), np.uint8))\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.startswith('anomalyclip_tpu'))))\n"
    )
    proc = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "anomalyclip_tpu_torch.ops.attention" in loaded
    assert not [m for m in loaded if m.startswith(("anomalyclip_tpu_torch.models", "anomalyclip_tpu_torch.train",
                                                    "anomalyclip_tpu_torch.eval.evaluator"))], loaded
    assert not [m for m in loaded if m == "anomalyclip_tpu" or m.startswith("anomalyclip_tpu.")], loaded


# ---------------------------------------------------------------------------
# the export CLI and the artifact paths of the entry points
# ---------------------------------------------------------------------------


def _helpers():
    import importlib.util

    name = "_torch_serving_helpers"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, ROOT / "tests" / "helpers" / "torch_serving.py")
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module
        spec.loader.exec_module(module)
    return sys.modules[name]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    try:
        yield _helpers().serving_setup(tmp_path_factory.mktemp("export_cli"), mp)
    finally:
        mp.undo()


def test_export_cli_end_to_end(served, tmp_path):
    """The deployment path: the export CLI on a checkpoint, then the artifact
    through predict (within 1e-6 of the checkpoint-backed predict on the same
    input, features and frames) and the eval entry's ``artifact=`` (AUC, AP,
    mAUC and mAP within 1e-6 of the checkpoint's eval, and within 1e-4 of the
    JAX eval entry on the same checkpoint). Every run computes the ncentroid
    from the synthetic training set, as the test pass does."""
    from anomalyclip_tpu_torch import export

    art_dir = tmp_path / "artifact"
    out = export.main(served.common + [f"out={art_dir}", "trainer=cpu", f"paths.log_dir={tmp_path / 'x'}"])
    assert (out / "meta.json").is_file() and (out / "score.pt2").is_file() and (out / "encode.pt2").is_file()

    for form in ("npy", "frames"):
        path = getattr(served, form)
        ref = predict.main(served.common + [f"input={path}", "trainer=cpu", f"paths.log_dir={tmp_path / 'p'}"])
        got = predict.main([f"artifact={art_dir}", f"input={path}", "trainer=cpu"])
        assert got.keys() == ref.keys() and got["num_frames"] == ref["num_frames"]
        assert got["classnames_abnormal"] == ref["classnames_abnormal"]
        np.testing.assert_allclose(got["frame_scores"], ref["frame_scores"], rtol=0, atol=SAME)
        np.testing.assert_allclose(got["frame_top_class_prob"], ref["frame_top_class_prob"], rtol=0, atol=SAME)

    limit = "trainer.limit_test_batches=3"
    ckpt_metrics = eval_entry.main(served.common + [limit, "trainer=cpu", f"paths.log_dir={tmp_path / 'ck'}"])
    art_metrics = eval_entry.main([f"artifact={art_dir}", "data=synthetic", limit, "trainer=cpu",
                                   "data.num_workers=0", f"paths.output_dir={tmp_path / 'art_eval'}"])
    jax_metrics = jeval_entry.main(served.common + [limit, f"paths.log_dir={tmp_path / 'jx'}"])
    for key in METRICS:
        assert abs(art_metrics[key] - ckpt_metrics[key]) <= SAME, (key, art_metrics[key], ckpt_metrics[key])
        assert abs(art_metrics[key] - jax_metrics[key]) <= GOLDEN, (key, art_metrics[key], jax_metrics[key])
    assert (tmp_path / "art_eval" / "artifact_eval" / "metrics.json").is_file()
    with pytest.raises(SystemExit, match="exported for"):
        eval_entry.main([f"artifact={art_dir}", "data=synthetic", "data.num_segments=16", "trainer=cpu",
                         "data.num_workers=0", f"paths.output_dir={tmp_path / 'bad'}"])


# ---------------------------------------------------------------------------
# the registered operators
# ---------------------------------------------------------------------------


def _op_cases():
    """(op name, the operator's arguments, the entry's plain version on them),
    at small shapes, fp32, causal where the entry takes it."""
    gen = torch.Generator().manual_seed(9)

    def t(*shape):
        return torch.randn(shape, generator=gen)

    qkv, q, k, v, kv = t(2, 7, 96), t(2, 7, 32), t(2, 7, 32), t(2, 7, 32), t(2, 7, 64)
    heads = [t(2, 2, 9, 16) for _ in range(3)]
    flat = [t(3, 9, 16) for _ in range(3)]
    return [
        ("fused_mha_qkv", (qkv, 2, True), lambda: tattn.mha_qkv_reference(qkv, 2, True)),
        ("fused_mha_bld", (q, k, v, 2, False), lambda: tattn.mha_bld_reference(q, k, v, 2, False)),
        ("fused_mha_qtile", (q, kv, 2), lambda: tattn.mha_qtile_reference(q, kv, 2)),
        ("flash_attention_heads", (*flat, True, True),
         lambda: tattn.flash_attention_reference(*flat, True, causal=True)),
        ("fused_attention", (*heads, True), lambda: tattn.fused_attention_reference(*heads, True)),
    ]


@pytest.mark.parametrize("index", range(5))
def test_opcheck_on_every_registered_op(index):
    name, args, _ = _op_cases()[index]
    op = tattn.REGISTERED_OPS[name]
    args = tuple(a.clone().requires_grad_(True) if isinstance(a, torch.Tensor) else a for a in args)
    # the schema, the autograd registration, the fake implementation against the
    # real one, and a trace with symbolic sizes forward and backward
    torch.library.opcheck(op, args)


@pytest.mark.parametrize("index", range(5))
def test_op_cpu_implementation_is_the_plain_version(index):
    name, args, plain = _op_cases()[index]
    got = getattr(torch.ops.anomalyclip, name)(*args)
    want = plain()
    if name == "flash_attention_heads":
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    else:
        assert torch.equal(got, want)
    assert set(tattn.REGISTERED_OPS) == {case[0] for case in _op_cases()}
