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
from anomalyclip_tpu_torch.eval import grids as tgrids
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
    frozen = convert.params_from_jax(_np_tree(jfrozen), device="cpu")
    tmodel, frozen = tac.AnomalyCLIP.build(tac.AnomalyCLIPConfig(**net_kwargs), frozen["clip"], tclip_cfg)
    predictor = Predictor(
        tmodel, frozen, convert.params_from_jax(_np_tree(jtrainable), device="cpu"),
        convert.bn_state_from_jax(jbn, device="cpu"), ncentroid, sampling=tmodel.cfg, device="cpu",
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


def test_score_frames_l14_336_shape_matches_jax():
    """The ViT-L/14@336px sequence (336 px, patch 14: L=577) at a narrow width:
    the image tower takes the core rung into the flash entry (fp32), which runs
    its KV-blocked plain version here. One grid of 16 frames, one 256-frame
    encode call (the chunk pads by repetition)."""
    labels = Path(tempfile.mkdtemp()) / "labels.csv"
    labels.write_text("id,name\n0,Abuse\n1,Arson\n2,Normal\n3,Robbery\n4,Shooting\n")
    net = dict(
        labels_file=str(labels), emb_size=64, depth=1, heads=2, num_segments=4,
        seg_length=4, normal_id=2, load_from_features=False,
    )
    clip_cfg = jclip.CLIPConfig(
        embed_dim=64, image_resolution=336, vision_layers=2, vision_width=128,
        vision_patch_size=14, transformer_width=64, transformer_heads=4, transformer_layers=2,
    )
    jmodel, jfrozen = jac.AnomalyCLIP.build(
        jac.AnomalyCLIPConfig(**net), jclip.init_clip_params(jax.random.PRNGKey(2), clip_cfg), clip_cfg
    )
    jtrainable, _ = jmodel.init_trainable(jax.random.PRNGKey(3), jfrozen)
    rng = np.random.default_rng(1)
    jbn = JBNState(
        mean=jnp.asarray(0.1 * rng.standard_normal(4), jnp.float32),
        var=jnp.asarray(rng.uniform(0.5, 2.0, 4), jnp.float32),
    )
    ncentroid = (0.1 * rng.standard_normal(clip_cfg.embed_dim)).astype(np.float32)
    jmodel, jscorer, predictor = _build_pair(net, jfrozen, jtrainable, jbn, clip_cfg, ncentroid)
    assert (clip_cfg.grid_size**2 + 1, clip_cfg.vision_width // 64) == (577, 2)

    raw = rng.integers(0, 256, (1, 12, 336, 336, 3), dtype=np.uint8)
    theirs, segment_size = _jax_score(jmodel, jscorer, raw)
    ours, result = predictor.score_frames(raw)
    assert segment_size == 1 and predictor.scorer.encode_calls == 1
    _assert_same(ours, theirs)
    assert ours.scores.shape == (12,) and result["num_frames"] == 12


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
        convert.params_from_jax(_np_tree(jfrozen), device="cpu"),
        convert.params_from_jax(_np_tree(jtrainable), device="cpu"),
        convert.bn_state_from_jax(jbn, device="cpu"),
        torch.from_numpy(frames),
        torch.from_numpy(tiny_pair.ncentroid),
        segment_size=2,
    )
    np.testing.assert_allclose(got_sim.numpy(), np.asarray(want_sim), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_sc.numpy(), np.asarray(want_sc), rtol=RTOL, atol=ATOL)


def test_bucketing_and_padding_helpers():
    assert [tgrids.bucket_size(g, tgrids.DEFAULT_BUCKETS) for g in (1, 3, 64, 65, 130)] == [
        jeval.bucket_size(g, jeval.DEFAULT_BUCKETS) for g in (1, 3, 64, 65, 130)
    ]
    grids = np.ones((3, 2, 2, 5), np.float32)
    ours, theirs = tgrids.pad_to_bucket(grids), jeval.pad_to_bucket(grids)
    assert ours[1] == theirs[1] == 3
    np.testing.assert_array_equal(ours[0], theirs[0])


def test_encode_frames_chunked_pads_by_repetition():
    seen = []

    def encode(part):
        seen.append(tuple(part.shape))
        return part.reshape(part.shape[0], -1)[:, :2].float()

    frames = np.arange(5 * 2 * 2 * 3, dtype=np.uint8).reshape(5, 2, 2, 3)
    out = tgrids.encode_frames_chunked(encode, frames, "cpu", chunk=4)
    assert seen == [(4, 2, 2, 3), (4, 2, 2, 3)]
    np.testing.assert_array_equal(out, frames.reshape(5, -1)[:, :2].astype(np.float32))


def test_tiny_state_through_convert():
    """The golden tiny state (stacked JAX blocks, HWIO convs) converts to the
    port's layout and scores a feature video as the JAX package does."""
    with np.load(ROOT / "tests" / "golden" / "tiny_state.npz") as data:
        flat = {k: data[k] for k in data.files}
    frozen, trainable, bn, clip_cfg = convert.state_from_flat(flat, device="cpu")

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


# ---------------------------------------------------------------------------
# the gradient through the image tower
# ---------------------------------------------------------------------------

# fp32: rtol and atol of each leaf's max |gradient|. bf16: the two packages round
# the stream at different places (measured here: up to 2.4e-2 of a leaf's max
# after two layers each way), so the limit is absolute, of each leaf's max.
GRAD_TOL = {"float32": 1e-4, "bfloat16": 5e-2}

_L577_CFG = dict(
    embed_dim=64, image_resolution=336, vision_layers=2, vision_width=128,
    vision_patch_size=14, transformer_width=64, transformer_heads=4, transformer_layers=2,
)


@pytest.mark.parametrize(
    "cfg_kwargs,dtype_name,rung",
    [
        (_L577_CFG, "float32", "core"),  # fused_attention -> the flash entry and its backward
        (_L577_CFG, "bfloat16", "qtile"),  # q and k|v as two GEMMs, the q-tiled backward
        (None, "float32", "mha"),  # the tiny ViT-B config: the packed qkv entry
    ],
)
def test_image_tower_gradient_matches_jax(cfg_kwargs, dtype_name, rung):
    """d sum(encode_image(...)^2) / d every visual leaf against jax.grad of the
    JAX ``encode_image`` on the same weights through convert.py."""
    from anomalyclip_tpu_torch.models.clip import model as tclip

    jcfg = jclip.CLIPConfig.tiny() if cfg_kwargs is None else jclip.CLIPConfig(**cfg_kwargs)
    tcfg = CLIPConfig(**{f.name: getattr(jcfg, f.name) for f in jcfg.__dataclass_fields__.values()})
    jdtype, tdtype = {"float32": (jnp.float32, torch.float32),
                      "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype_name]
    length = tcfg.grid_size**2 + 1
    assert tclip.attention_rung(2, length, tcfg.vision_width, tcfg.vision_heads,
                                tdtype.itemsize, False) == rung

    jparams = jclip.init_clip_params(jax.random.PRNGKey(4), jcfg)
    res = jcfg.image_resolution
    frames = np.random.default_rng(4).integers(0, 256, (2, res, res, 3), dtype=np.uint8)

    def jloss(visual):
        out = jclip.encode_image({**jparams, "visual": visual}, jcfg, jnp.asarray(frames), jdtype)
        return (out.astype(jnp.float32) ** 2).sum()

    want = _np_tree(jax.grad(jloss)(jparams["visual"]))

    tparams = convert.clip_params_require_grad(convert.params_from_jax(_np_tree(jparams), device="cpu"))
    leaves = convert.tree_leaves(tparams["visual"])
    assert all(t.requires_grad and t.dtype == torch.float32 for t in leaves)
    out = tclip.encode_image(tparams, tcfg, torch.from_numpy(frames), tdtype)
    grads = torch.autograd.grad((out.float() ** 2).sum(), leaves)
    got = convert.tree_to_jax(convert.tree_from_leaves(tparams["visual"], grads))

    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    tol = GRAD_TOL[dtype_name]
    worst = {}

    def check(path, ours, theirs):
        top = float(np.abs(theirs).max())
        assert ours.shape == theirs.shape and ours.dtype == np.float32 and top > 0, path
        worst[jax.tree_util.keystr(path)] = float(np.abs(ours - theirs).max()) / top
        rtol = tol if dtype_name == "float32" else 0
        np.testing.assert_allclose(ours, theirs, rtol=rtol, atol=tol * top,
                                   err_msg=jax.tree_util.keystr(path))

    jax.tree_util.tree_map_with_path(check, got, want)
    assert len(worst) == len(jax.tree_util.tree_leaves(want))  # blocks count once, stacked
