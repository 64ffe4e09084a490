"""The port's whole-set evaluation against the JAX package, on the CPU.

``evaluate_videos`` over the port's own datamodule (the synthetic corpus of the
golden fixture, written by the port's generator) with the golden tiny state:
against ``tests/golden/tiny_pipeline.npz`` ``eval/*`` (labels exact, scores and
class probabilities at rtol 1e-4 / atol 2e-5, AUC, AP, mAUC, mAP and the
threshold at atol 1e-4: tests/test_golden.py:225-251) and against the JAX
``evaluate_videos`` over the JAX datamodule at the same tolerances. Also
``should_stop``, ``on_video`` and ``score_item``; ``GridScorer.update`` against
a freshly built scorer; a scorer of features whose image tower is on the
``meta`` device; and ``gather_processes`` in one process and across two.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import os
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anomalyclip_tpu.data.datamodule import AnomalyCLIPDataModule as JDataModule
from anomalyclip_tpu.data.datamodule import DataConfig as JDataConfig
from anomalyclip_tpu.eval import evaluator as jeval
from anomalyclip_tpu.models import anomaly_clip as jac
from anomalyclip_tpu.models import selector as jsel
from anomalyclip_tpu.models.clip import model as jclip
from anomalyclip_tpu.utils.treeio import unflatten_tree
from anomalyclip_tpu_torch import convert
from anomalyclip_tpu_torch.data.datamodule import AnomalyCLIPDataModule, DataConfig
from anomalyclip_tpu_torch.data.synthetic import generate_synthetic_dataset
from anomalyclip_tpu_torch.eval import evaluator as teval
from anomalyclip_tpu_torch.eval.metrics import detection_metrics
from anomalyclip_tpu_torch.models import anomaly_clip as tac

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "golden"
RTOL, ATOL = 1e-4, 2e-5  # tests/test_golden.py:234-240
METRIC_ATOL = 1e-4  # tests/test_golden.py:251
# the same computation twice in one process: the CPU's BLAS may split a product
# over another number of threads under load, so the sums may run in another order
SAME_RTOL, SAME_ATOL = 1e-5, 1e-6
# the golden fixture's settings (tests/test_golden.py:142-147)
OVERRIDES = (
    "model.net.select_idx_dropout_topk=0.0",
    "model.net.select_idx_dropout_bottomk=0.0",
    "model.net.emb_size=32",
    "data.num_workers=0",
)


def _synthetic_cfg():
    """tests/helpers/synthetic_run.py loaded by its path (an installed package
    named ``tests`` may shadow this repository's)."""
    path = Path(__file__).resolve().parent / "helpers" / "synthetic_run.py"
    spec = importlib.util.spec_from_file_location("_test_torch_eval_synthetic_run", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.synthetic_cfg


def _load(name: str) -> dict:
    with np.load(GOLDEN / name, allow_pickle=False) as data:
        return {k: data[k] for k in data.files}


def _fields(cls, mapping) -> dict:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in dict(mapping).items() if k in names}


def _sub(flat: dict, prefix: str):
    return unflatten_tree({k[len(prefix):]: v for k, v in flat.items() if k.startswith(prefix)})


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The golden tiny state in both packages, and the golden fixture's corpus
    written by the port's generator, as the JAX train module writes it."""
    cfg = _synthetic_cfg()(tmp_path_factory.mktemp("torch_eval"), *OVERRIDES)
    flat = _load("tiny_state.npz")
    frozen, trainable, bn, clip_cfg = convert.state_from_flat(flat, device="cpu")
    net = _fields(tac.AnomalyCLIPConfig, cfg.model.net)
    model, frozen = tac.AnomalyCLIP.build(tac.AnomalyCLIPConfig(**net), frozen["clip"], clip_cfg)
    data = dict(cfg.data)
    generate_synthetic_dataset(
        frames_root=data["frames_root"], annotations_root=data["annotations_root"],
        num_normal=data["synthetic_num_normal"], num_abnormal=data["synthetic_num_abnormal"],
        num_test=data["synthetic_num_test"], num_classes=data["num_classes"],
        normal_id=data["normal_id"], feature_dim=clip_cfg.embed_dim,
        min_frames=data["synthetic_min_frames"], max_frames=data["synthetic_max_frames"],
        seed=int(cfg.seed), make_frames=False, frame_size=int(data["input_size"]),
    )
    jfrozen = _sub(flat, "frozen/")
    jclip_cfg = jclip.CLIPConfig(**dataclasses.asdict(clip_cfg))
    jnet = _fields(jac.AnomalyCLIPConfig, cfg.model.net)
    jmodel, _ = jac.AnomalyCLIP.build(jac.AnomalyCLIPConfig(**jnet), jfrozen["clip"], jclip_cfg)
    golden = _load("tiny_pipeline.npz")
    return SimpleNamespace(
        cfg=cfg, data=data, model=model, frozen=frozen, trainable=trainable, bn=bn,
        ncentroid=golden["ncentroid"], golden=golden,
        datamodule=AnomalyCLIPDataModule(DataConfig.from_dict(data), seed=int(cfg.seed)),
        jmodel=jmodel, jfrozen=jfrozen, jtrainable=_sub(flat, "trainable/"),
        jbn=jsel.BNState(jnp.asarray(flat["bn/mean"]), jnp.asarray(flat["bn/var"])),
    )


def _scorer(tiny, **kw):
    return teval.GridScorer(tiny.model, tiny.frozen, tiny.trainable, tiny.bn, tiny.ncentroid,
                            device="cpu", **kw)


def _metrics(ev: dict, data: dict) -> np.ndarray:
    det = detection_metrics(ev["abnormal_scores"], ev["labels"], ev["class_probs"],
                            int(data["normal_id"]), int(data["num_classes"]))
    return np.asarray([det["auc_roc"], det["auc_pr"], det["mean_mc_auroc"],
                       det["mean_mc_aupr"], det["optimal_threshold"]])


def _assert_same(ev: dict, want: dict) -> None:
    """Two passes of one evaluation: labels exact, outputs to the sum order."""
    np.testing.assert_array_equal(ev["labels"], want["labels"])
    for name in ("abnormal_scores", "class_probs"):
        np.testing.assert_allclose(ev[name], want[name], rtol=SAME_RTOL, atol=SAME_ATOL, err_msg=name)


def _assert_close(ev: dict, labels, scores, class_probs) -> None:
    np.testing.assert_array_equal(ev["labels"], labels)
    np.testing.assert_allclose(ev["abnormal_scores"], scores, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ev["class_probs"], class_probs, rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def evaluated(tiny):
    return teval.evaluate_videos(tiny.datamodule.test_dataloader(), _scorer(tiny), tiny.model)


def test_evaluate_videos_matches_golden(tiny, evaluated):
    g = tiny.golden
    _assert_close(evaluated, g["eval/labels"], g["eval/abnormal_scores"], g["eval/class_probs"])
    np.testing.assert_allclose(_metrics(evaluated, tiny.data), g["eval/metrics"], atol=METRIC_ATOL)


def test_evaluate_videos_matches_jax(tiny, evaluated):
    """Against the JAX evaluate_videos over the JAX datamodule on the same files."""
    jdm = JDataModule(JDataConfig.from_dict(tiny.data), seed=int(tiny.cfg.seed))
    jscorer = jeval.GridScorer(tiny.jmodel, tiny.jfrozen, tiny.jtrainable, tiny.jbn, tiny.ncentroid)
    want = jeval.evaluate_videos(jdm.test_dataloader(), jscorer, tiny.jmodel)
    _assert_close(evaluated, want["labels"], want["abnormal_scores"], want["class_probs"])
    np.testing.assert_allclose(_metrics(evaluated, tiny.data), _metrics(want, tiny.data),
                               atol=METRIC_ATOL)


def test_should_stop_on_video_and_score_item(tiny, evaluated):
    scorer = _scorer(tiny)
    loader = tiny.datamodule.test_dataloader()
    seen, scored = [], []

    def score_item(item):
        scored.append(item.path)
        return teval.score_video(item, scorer, tiny.model)

    ev = teval.evaluate_videos(loader, on_video=seen.append, score_item=score_item)
    assert scored == [tiny.datamodule.test_data.records[i].feature_path for i in range(len(loader))]
    assert [vs.path for vs in seen] == scored
    _assert_same(ev, evaluated)
    np.testing.assert_array_equal(np.concatenate([vs.scores for vs in seen]), ev["abnormal_scores"])

    polls = []

    def stop_after_two():
        polls.append(1)
        return len(polls) > 2

    scored.clear()
    assert teval.evaluate_videos(loader, score_item=score_item, should_stop=stop_after_two) == {}
    assert len(scored) == 2
    assert teval.evaluate_videos(loader, scorer, tiny.model, should_stop=lambda: True) == {}
    assert teval.evaluate_videos([], scorer, tiny.model) == {}


def test_update_equals_a_fresh_scorer(tiny):
    """update() with other parameters scores as a scorer built with them."""
    gen = torch.Generator().manual_seed(5)
    other, _ = tiny.model.init_trainable(gen, tiny.frozen)
    other_bn = type(tiny.bn)(tiny.bn.mean + 0.05, tiny.bn.var * 1.5)
    other_centroid = tiny.ncentroid + 0.01
    updated = _scorer(tiny)
    before = updated.text_features.clone()
    assert updated.update(tiny.frozen, other, other_bn, other_centroid) is updated
    fresh = teval.GridScorer(tiny.model, tiny.frozen, other, other_bn, other_centroid, device="cpu")
    assert not torch.equal(updated.text_features, before)
    torch.testing.assert_close(updated.text_features, fresh.text_features, rtol=SAME_RTOL, atol=SAME_ATOL)
    grids = np.random.default_rng(0).standard_normal(
        (3, tiny.model.cfg.num_segments, tiny.model.cfg.seg_length, tiny.model.clip_cfg.embed_dim)
    ).astype(np.float32)
    for got, want in zip(updated.score_grids(grids), fresh.score_grids(grids)):
        np.testing.assert_allclose(got, want, rtol=SAME_RTOL, atol=SAME_ATOL)


def test_a_feature_scorer_needs_no_image_tower_on_its_device(tiny, evaluated):
    """The scorer reads the text tower only; the image tower's device is
    checked where it is used, by encode_frames_np."""
    frozen = {"clip": dict(tiny.frozen["clip"], visual=convert.tree_to(tiny.frozen["clip"]["visual"], "meta"))}
    scorer = teval.GridScorer(tiny.model, frozen, tiny.trainable, tiny.bn, tiny.ncentroid, device="cpu")
    ev = teval.evaluate_videos(tiny.datamodule.test_dataloader(), scorer, tiny.model)
    _assert_same(ev, evaluated)
    frames = np.zeros((2, 224, 224, 3), np.uint8)
    with pytest.raises(ValueError, match="device is cpu, but the frozen visual parameters are on meta"):
        scorer.encode_frames_np(frames)
    text_on_meta = {"clip": dict(tiny.frozen["clip"], text=convert.tree_to(tiny.frozen["clip"]["text"], "meta"))}
    with pytest.raises(ValueError, match="device is cpu, but the frozen parameters are on meta"):
        teval.GridScorer(tiny.model, text_on_meta, tiny.trainable, tiny.bn, tiny.ncentroid, device="cpu")
    with pytest.raises(ValueError, match="the trainable parameters are on meta"):
        scorer.update(tiny.frozen, convert.tree_to(tiny.trainable, "meta"), tiny.bn, tiny.ncentroid)


def test_gather_processes_in_one_process_is_the_whole_set(tiny, evaluated, tmp_path):
    import torch.distributed as dist

    loader = tiny.datamodule.test_dataloader()
    ev = teval.evaluate_videos(loader, _scorer(tiny), tiny.model, gather_processes=True)
    _assert_same(ev, evaluated)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rendezvous'}",
                            world_size=1, rank=0)
    try:
        ev = teval.evaluate_videos(loader, _scorer(tiny), tiny.model, gather_processes=True)
    finally:
        dist.destroy_process_group()
    _assert_same(ev, evaluated)


_RANK = textwrap.dedent("""
    import sys
    import numpy as np
    import torch.distributed as dist
    from anomalyclip_tpu_torch.eval.evaluator import VideoScores, evaluate_videos

    rank, path = int(sys.argv[1]), sys.argv[2]
    dist.init_process_group("gloo", init_method="file://" + path, world_size=2, rank=rank)

    def video(k):
        t = 3 + 2 * k
        return VideoScores(np.zeros((t, 2), np.float32), np.full(t, k, np.float32),
                           np.full((t, 2), k / 10, np.float32), np.full(t, k), k, f"v{k}")

    class Strided(list):
        def global_indices(self):
            return range(rank, 5, 2)

    try:
        try:  # a loader without global video indices cannot be put in order
            evaluate_videos([0], score_item=video, gather_processes=True)
        except AttributeError as exc:
            print("refused:", exc)
        else:
            raise SystemExit("gathered videos it could not order")
        got = evaluate_videos(Strided(range(rank, 5, 2)), score_item=video, gather_processes=True)
        want = evaluate_videos(range(5), score_item=video)
        assert all(np.array_equal(got[k], want[k]) for k in want), (got, want)
        print("gathered", got["abnormal_scores"].size, "frames in global order")
        assert evaluate_videos([], gather_processes=False) == {}
    finally:
        dist.destroy_process_group()
""")


def test_gather_processes_across_two_ranks_raises(tmp_path):
    """Across two ranks (a gloo group) each rank's stride of the videos is
    gathered into the whole set in global order on both; a loader without
    ``global_indices`` raises, since its videos have no global place."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [
        subprocess.Popen([sys.executable, "-c", _RANK, str(rank), str(tmp_path / "rendezvous")],
                         cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in (0, 1)
    ]
    for proc in procs:
        try:
            out, err = proc.communicate(timeout=120)
        finally:
            proc.kill()
        assert proc.returncode == 0, err
        assert "refused:" in out and "gathered 35 frames in global order" in out, out
