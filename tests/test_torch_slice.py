"""The port's whole test-mode slice against the JAX package.

``Predictor.score_frames`` from uint8 frames at a tiny CLIP config, over video
lengths that give one and several grid buckets and one and two 256-frame encode
chunks, against the JAX ``GridScorer`` + ``score_video`` on the same converted
weights, with the sampling of ``predict.score_input``: scores, similarity and
class_probs at rtol 1e-4 / atol 2e-5 (tests/test_golden.py:234-240). Also the
``tests/golden/tiny_state.npz`` state through convert.py.
"""

from __future__ import annotations

import tempfile
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anomalyclip_tpu.data import sampling
from anomalyclip_tpu.data.dataset import TestItem
from anomalyclip_tpu.eval import evaluator as jeval
from anomalyclip_tpu.models import anomaly_clip as jac
from anomalyclip_tpu.models.clip import model as jclip
from anomalyclip_tpu.models.selector import BNState as JBNState
from anomalyclip_tpu_torch import convert
from anomalyclip_tpu_torch.eval import evaluator as teval
from anomalyclip_tpu_torch.models import anomaly_clip as tac
from anomalyclip_tpu_torch.models.clip.model import CLIPConfig
from anomalyclip_tpu_torch.predict import Predictor

RTOL, ATOL = 1e-4, 2e-5
ROOT = Path(__file__).resolve().parents[1]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_score(model, scorer, raw):
    """predict.score_input's sampling and item, scored by the JAX evaluator."""
    cfg = model.cfg
    t_raw = raw.shape[1]
    starts, segment_size = sampling.test_start_indices(
        t_raw, cfg.num_segments, cfg.seg_length, cfg.stride
    )
    indices = sampling.gather_frame_indices(starts, cfg.seg_length, cfg.stride, t_raw)
    item = TestItem(
        features=raw[:, indices],
        frame_labels=np.full(t_raw, cfg.normal_id, dtype=np.int64),
        video_label=cfg.normal_id,
        segment_size=segment_size,
        path="",
    )
    return jeval.score_video(item, scorer, model), segment_size


def _build_pair(net_kwargs, jfrozen, jtrainable, jbn, jclip_cfg, ncentroid):
    """The same state in both packages -> (jax model, jax scorer, port predictor);
    the predictor's scorer holds the port's converted state."""
    jmodel = jac.AnomalyCLIP.build(jac.AnomalyCLIPConfig(**net_kwargs), jfrozen["clip"], jclip_cfg)[0]
    jscorer = jeval.GridScorer(jmodel, jfrozen, jtrainable, jbn, ncentroid)
    tclip_cfg = CLIPConfig(
        **{f.name: getattr(jclip_cfg, f.name) for f in jclip_cfg.__dataclass_fields__.values()}
    )
    frozen = convert.params_from_jax(_np_tree(jfrozen))
    tmodel, frozen = tac.AnomalyCLIP.build(tac.AnomalyCLIPConfig(**net_kwargs), frozen["clip"], tclip_cfg)
    predictor = Predictor(
        tmodel, frozen, convert.params_from_jax(_np_tree(jtrainable)),
        convert.bn_state_from_jax(jbn), ncentroid,
    )
    return jmodel, jscorer, predictor


def _assert_same(ours, theirs):
    for name in ("scores", "similarity", "class_probs"):
        np.testing.assert_allclose(
            getattr(ours, name), getattr(theirs, name), rtol=RTOL, atol=ATOL, err_msg=name
        )


@pytest.fixture(scope="module")
def tiny_pair():
    labels = Path(tempfile.mkdtemp()) / "labels.csv"
    labels.write_text("id,name\n0,Abuse\n1,Arson\n2,Normal\n3,Robbery\n4,Shooting\n")
    net = dict(
        labels_file=str(labels), emb_size=64, depth=1, heads=2, num_segments=4,
        seg_length=4, normal_id=2, load_from_features=False,
    )
    clip_cfg = jclip.CLIPConfig.tiny()
    jmodel, jfrozen = jac.AnomalyCLIP.build(
        jac.AnomalyCLIPConfig(**net), jclip.init_clip_params(jax.random.PRNGKey(0), clip_cfg), clip_cfg
    )
    jtrainable, _ = jmodel.init_trainable(jax.random.PRNGKey(1), jfrozen)
    rng = np.random.default_rng(0)
    jbn = JBNState(
        mean=jnp.asarray(0.1 * rng.standard_normal(4), jnp.float32),
        var=jnp.asarray(rng.uniform(0.5, 2.0, 4), jnp.float32),
    )
    ncentroid = (0.1 * rng.standard_normal(clip_cfg.embed_dim)).astype(np.float32)
    jmodel, jscorer, predictor = _build_pair(net, jfrozen, jtrainable, jbn, clip_cfg, ncentroid)
    return SimpleNamespace(
        jmodel=jmodel, jscorer=jscorer, predictor=predictor,
        jstate=(jfrozen, jtrainable, jbn), ncentroid=ncentroid,
    )


@pytest.mark.parametrize(
    "t_raw,grids",
    [
        (10, 1),  # one grid, bucket 1, one encode chunk
        (45, 3),  # three grids, padded to bucket 4
        (300, 19),  # nineteen grids, bucket 32, two encode chunks (304 frames)
    ],
)
def test_score_frames_matches_jax(tiny_pair, t_raw, grids):
    jmodel, jscorer, predictor = tiny_pair.jmodel, tiny_pair.jscorer, tiny_pair.predictor
    raw = np.random.default_rng(t_raw).integers(0, 256, (1, t_raw, 32, 32, 3), dtype=np.uint8)
    theirs, segment_size = _jax_score(jmodel, jscorer, raw)
    assert segment_size == grids
    ours, result = predictor.score_frames(raw)
    _assert_same(ours, theirs)
    assert ours.scores.shape == (t_raw,) and ours.class_probs.shape == (t_raw, 4)
    assert result["num_frames"] == t_raw
    assert result["classnames_abnormal"] == ["Abuse", "Arson", "Robbery", "Shooting"]
    np.testing.assert_allclose(result["frame_scores"], np.round(theirs.scores, 6), atol=2e-5)
    assert result["video_anomaly_score"] == pytest.approx(float(theirs.scores.max()), abs=ATOL)


def test_text_features_match_jax(tiny_pair):
    np.testing.assert_allclose(
        tiny_pair.predictor.scorer.text_features.numpy(),
        np.asarray(tiny_pair.jscorer.text_features),
        rtol=RTOL, atol=ATOL,
    )


def test_forward_test_matches_jax(tiny_pair):
    """The whole test forward on one padded from-frames video of two grids."""
    jfrozen, jtrainable, jbn = tiny_pair.jstate
    frames = np.random.default_rng(9).integers(0, 256, (1, 2 * 16, 32, 32, 3), dtype=np.uint8)
    want_sim, want_sc = tiny_pair.jmodel.forward_test(
        jfrozen, jtrainable, jbn, jnp.asarray(frames), jnp.asarray(tiny_pair.ncentroid),
        segment_size=2,
    )
    got_sim, got_sc = tiny_pair.predictor.model.forward_test(
        convert.params_from_jax(_np_tree(jfrozen)),
        convert.params_from_jax(_np_tree(jtrainable)),
        convert.bn_state_from_jax(jbn),
        torch.from_numpy(frames),
        torch.from_numpy(tiny_pair.ncentroid),
        segment_size=2,
    )
    np.testing.assert_allclose(got_sim.numpy(), np.asarray(want_sim), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_sc.numpy(), np.asarray(want_sc), rtol=RTOL, atol=ATOL)


def test_bucketing_and_padding_helpers():
    assert [teval.bucket_size(g, teval.DEFAULT_BUCKETS) for g in (1, 3, 64, 65, 130)] == [
        jeval.bucket_size(g, jeval.DEFAULT_BUCKETS) for g in (1, 3, 64, 65, 130)
    ]
    grids = np.ones((3, 2, 2, 5), np.float32)
    ours, theirs = teval.pad_to_bucket(grids), jeval.pad_to_bucket(grids)
    assert ours[1] == theirs[1] == 3
    np.testing.assert_array_equal(ours[0], theirs[0])


def test_encode_frames_chunked_pads_by_repetition():
    seen = []

    def encode(part):
        seen.append(tuple(part.shape))
        return part.reshape(part.shape[0], -1)[:, :2].float()

    frames = np.arange(5 * 2 * 2 * 3, dtype=np.uint8).reshape(5, 2, 2, 3)
    out = teval.encode_frames_chunked(encode, frames, "cpu", chunk=4)
    assert seen == [(4, 2, 2, 3), (4, 2, 2, 3)]
    np.testing.assert_array_equal(out, frames.reshape(5, -1)[:, :2].astype(np.float32))


def test_tiny_state_through_convert():
    """The golden tiny state (stacked JAX blocks, HWIO convs) converts to the
    port's layout and scores a feature video as the JAX package does."""
    with np.load(ROOT / "tests" / "golden" / "tiny_state.npz") as data:
        flat = {k: data[k] for k in data.files}
    frozen, trainable, bn, clip_cfg = convert.state_from_flat(flat)

    blocks = frozen["clip"]["visual"]["blocks"]
    assert isinstance(blocks, list) and len(blocks) == clip_cfg.vision_layers
    np.testing.assert_array_equal(
        blocks[1]["attn"]["qkv_w"].numpy(), flat["frozen/clip/visual/blocks/attn/qkv_w"][1]
    )
    conv = trainable["temporal"]["layers"][0]["ff1"]["conv1_w"]
    np.testing.assert_array_equal(
        conv.detach().permute(2, 3, 1, 0).numpy(), flat["trainable/temporal/layers/0/ff1/conv1_w"]
    )
    assert conv.requires_grad and conv.is_leaf and not blocks[1]["attn"]["qkv_w"].requires_grad
    np.testing.assert_array_equal(bn.var.numpy(), flat["bn/var"])

    # the synthetic experiment's net settings the state was trained under
    net = dict(
        labels_file=str(ROOT / "anomalyclip_tpu" / "labels" / "synthetic_labels.csv"),
        emb_size=32, depth=1, heads=8, num_segments=32, seg_length=16,
        concat_features=True, normal_id=3, load_from_features=True,
    )
    from anomalyclip_tpu.utils.treeio import unflatten_tree

    def sub(prefix):
        return unflatten_tree({k[len(prefix):]: v for k, v in flat.items() if k.startswith(prefix)})

    jclip_cfg = jclip.CLIPConfig(**{f.name: getattr(clip_cfg, f.name) for f in clip_cfg.__dataclass_fields__.values()})
    jbn = JBNState(mean=jnp.asarray(flat["bn/mean"]), var=jnp.asarray(flat["bn/var"]))
    ncentroid = np.random.default_rng(7).standard_normal(clip_cfg.embed_dim).astype(np.float32)
    jmodel, jscorer, predictor = _build_pair(
        net, sub("frozen/"), sub("trainable/"), jbn, jclip_cfg, ncentroid
    )
    feats = np.random.default_rng(8).standard_normal((1, 700, clip_cfg.embed_dim)).astype(np.float32)
    theirs, _ = _jax_score(jmodel, jscorer, feats)
    ours, _ = predictor.score_frames(feats)
    _assert_same(ours, theirs)
