"""The port's ModifiedResNet tower (models/clip/resnet.py) and ``clip_similarity``
against the JAX package, on the CPU, with the weights carried by
``convert.params_from_jax``.

- Every conv kernel of a carried tree is OIHW, the JAX kernel transposed, and
  ``tree_to_jax`` undoes ``params_from_jax`` exactly, on a ResNet tree and on
  the AnomalyCLIP trainable tree (the temporal model's two convs).
- ``encode_image`` on a small RN config ((1, 1, 1, 1) stages, width 16, 64 px,
  BN parameters and running statistics randomized) from float and uint8
  frames, and at the full RN50 shapes of ``resolve_clip("RN50",
  "random-full")`` on 2 uint8 frames at 224: fp32 within 1e-4 (rtol and atol,
  tests/test_golden.py's), bf16 within 5e-2.
- ``init_clip_params``' RN tree has the JAX ``init_resnet_params``' shapes;
  ``state_dict_from_params`` -> ``torch_state_dict_to_params`` is the
  identity on an RN tree, equal to the JAX converter's, with RN50's config.
- ``AnomalyCLIP.forward_test`` from frames on the small RN config against the
  JAX ``forward_test``, and ``clip_similarity`` on the tiny ViT and the small
  RN, within 1e-4.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anomalyclip_tpu.models import anomaly_clip as jac
from anomalyclip_tpu.models.clip import convert as jclip_convert
from anomalyclip_tpu.models.clip import model as jclip
from anomalyclip_tpu.models.clip.resnet import init_resnet_params as jax_init_resnet_params
from anomalyclip_tpu_torch import convert
from anomalyclip_tpu_torch.models.anomaly_clip import AnomalyCLIP, AnomalyCLIPConfig
from anomalyclip_tpu_torch.models.clip import convert as clip_convert
from anomalyclip_tpu_torch.models.clip import model as tclip
from anomalyclip_tpu_torch.models.clip.registry import resolve_clip
from anomalyclip_tpu_torch.models.clip.tokenizer import tokenize

TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
JAX_DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
# a small ModifiedResNet: one bottleneck a stage, 64 px (an attention pool over
# 2x2 + 1 tokens), 16 * 32 // 64 = 8 heads of 64; text width 64 (1 head, as
# config_from_state_dict infers heads from the width)
SMALL_RN = dict(embed_dim=64, image_resolution=64, vision_layers=(1, 1, 1, 1), vision_width=16,
                vision_patch_size=None, transformer_width=64, transformer_heads=1, transformer_layers=2)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _randomize_bn(tree, rng):
    """Every BN node of a JAX ResNet tree with random parameters and running
    statistics, so that eval-mode BN is exercised (tests/test_clip_parity.py)."""
    if isinstance(tree, dict):
        if set(tree) == {"scale", "bias", "mean", "var"}:
            c = tree["scale"].shape
            return {"scale": (1 + 0.1 * rng.standard_normal(c)).astype(np.float32),
                    "bias": (0.1 * rng.standard_normal(c)).astype(np.float32),
                    "mean": (0.5 * rng.standard_normal(c)).astype(np.float32),
                    "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}
        return {k: _randomize_bn(v, rng) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_randomize_bn(v, rng) for v in tree]
    return tree


def _paths(tree, prefix=""):
    """(path, leaf) of every leaf of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in _paths(v, f"{prefix}/{k}")]
    if isinstance(tree, list):
        return [p for i, v in enumerate(tree) for p in _paths(v, f"{prefix}/{i}")]
    return [(prefix, tree)]


def _assert_same_tree(got, want):
    """The same leaves at the same paths (in any key order: JAX's tree
    functions sort a dictionary's keys)."""
    got, want = dict(_paths(got)), dict(_paths(want))
    assert sorted(got) == sorted(want)
    for path, a in got.items():
        assert a.shape == want[path].shape and np.array_equal(a, want[path]), path


@pytest.fixture(scope="module")
def small_rn():
    """(JAX cfg, JAX params with random BN, port params, port cfg)."""
    jcfg = jclip.CLIPConfig(**SMALL_RN)
    jparams = _np_tree(jclip.init_clip_params(jax.random.PRNGKey(11), jcfg))
    jparams["visual"] = _randomize_bn(jparams["visual"], np.random.default_rng(12))
    return jcfg, jparams, convert.params_from_jax(jparams, device="cpu"), tclip.CLIPConfig(**SMALL_RN)


@pytest.fixture(scope="module")
def rn50():
    """RN50 at its full shapes from the port's registry, and the same tree in
    the JAX layout."""
    params, cfg = resolve_clip("RN50", "random-full", seed=3)
    return cfg, params, convert.tree_to_jax(params), jclip.CLIPConfig.rn50()


def _trainable_tree():
    from anomalyclip_tpu.utils.treeio import unflatten_tree
    from pathlib import Path

    flat = np.load(Path(__file__).resolve().parent / "golden" / "tiny_state.npz")
    return unflatten_tree({k[len("trainable/"):]: flat[k] for k in flat.files if k.startswith("trainable/")})


@pytest.mark.parametrize("tree", ["resnet", "anomaly_clip_trainable"])
def test_conv_kernels_are_oihw_and_round_trip(tree):
    """Each conv kernel of the carried tree is the JAX HWIO kernel transposed to
    OIHW, whatever its key (a ResNet tree names its stem's and bottlenecks'
    conv1_w, conv2_w, conv3_w and down_conv_w; the temporal model its conv1_w
    and conv2_w), and tree_to_jax(params_from_jax(tree)) is the tree."""
    if tree == "resnet":
        jtree = _np_tree(jax_init_resnet_params(jax.random.PRNGKey(0), jclip.CLIPConfig(**SMALL_RN)))
    else:
        jtree = _trainable_tree()
    carried = convert.params_from_jax(jtree, device="cpu")
    convs = 0
    for (path, got), (_, want) in zip(_paths(carried), _paths(jtree), strict=True):
        if path.rsplit("/", 1)[-1] in ("conv1_w", "conv2_w", "conv3_w", "down_conv_w"):
            convs += 1
            assert got.shape == tuple(np.transpose(want, (3, 2, 0, 1)).shape), path
            assert np.array_equal(got.numpy(), np.transpose(want, (3, 2, 0, 1))), path
    # the stem's three, three a bottleneck and each stage's shortcut; two in
    # each of a temporal level's two feed-forwards
    assert convs == (3 + 4 * 3 + 4 if tree == "resnet" else 4 * len(jtree["temporal"]["layers"]))
    _assert_same_tree(convert.tree_to_jax(carried), jtree)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("uint8", [False, True])
def test_resnet_encode_image_small(small_rn, dtype, uint8):
    jcfg, jparams, tparams, tcfg = small_rn
    rng = np.random.default_rng(5)
    if uint8:
        frames = rng.integers(0, 256, (3, 64, 64, 3), dtype=np.uint8)
    else:
        frames = rng.standard_normal((3, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jclip.encode_image(jparams, jcfg, jnp.asarray(frames), JAX_DTYPES[dtype]).astype(jnp.float32))
    got = tclip.encode_image(tparams, tcfg, torch.from_numpy(frames), dtype)
    assert got.dtype == dtype and got.shape == (3, 64)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_resnet_encode_image_rn50(rn50, dtype):
    """The full RN50 shapes (stages (3, 4, 6, 3), width 64, a 2048-wide
    attention pool of 32 heads over 7x7 + 1 tokens, embed dim 1024) on two
    uint8 frames at 224."""
    cfg, params, jparams, jcfg = rn50
    assert cfg == tclip.CLIPConfig.rn50() and cfg.vision_heads == 32
    frames = np.random.default_rng(6).integers(0, 256, (2, 224, 224, 3), dtype=np.uint8)
    want = np.asarray(jclip.encode_image(jparams, jcfg, jnp.asarray(frames), JAX_DTYPES[dtype]).astype(jnp.float32))
    got = tclip.encode_image(params, cfg, torch.from_numpy(frames), dtype)
    assert got.shape == (2, 1024) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.float().numpy(), want, rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("config", ["small", "rn50"])
def test_init_clip_params_resnet_shapes(config):
    cfg = tclip.CLIPConfig(**SMALL_RN) if config == "small" else tclip.CLIPConfig.rn50()
    visual = tclip.init_clip_params(torch.Generator().manual_seed(0), cfg)["visual"]
    jvisual = jax_init_resnet_params(jax.random.PRNGKey(0), jclip.CLIPConfig(**dataclasses.asdict(cfg)))
    want = convert.params_from_jax(_np_tree(jvisual), device="cpu")
    got, want = dict(_paths(visual)), dict(_paths(want))
    assert {p: tuple(t.shape) for p, t in got.items()} == {p: tuple(t.shape) for p, t in want.items()}
    assert all(t.dtype == torch.float32 for t in got.values())


@pytest.mark.parametrize("config", ["small", "rn50"])
def test_resnet_state_dict_round_trip(config):
    """state_dict_from_params -> torch_state_dict_to_params is the identity on
    an RN tree; the JAX converter reads the same state dict into the tree
    params_from_jax carries to the port's, and config_from_state_dict gives
    the tree's config."""
    cfg = tclip.CLIPConfig(**SMALL_RN) if config == "small" else tclip.CLIPConfig.rn50()
    params = tclip.init_clip_params(torch.Generator().manual_seed(1), cfg)
    sd = {k: v.numpy() for k, v in clip_convert.state_dict_from_params(params).items()}
    got, got_cfg = clip_convert.torch_state_dict_to_params(sd)
    assert got_cfg == cfg
    _assert_same_tree(convert.tree_map(lambda t: t.numpy(), got), convert.tree_map(lambda t: t.numpy(), params))
    if config == "small":
        jparams, jcfg = jclip_convert.torch_state_dict_to_params(sd)
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
        _assert_same_tree(convert.tree_map(lambda t: t.numpy(), convert.params_from_jax(jparams, device="cpu")),
                          convert.tree_map(lambda t: t.numpy(), got))


def test_forward_test_from_frames_resnet(small_rn, tmp_path):
    """The AnomalyCLIP test forward from frames on the small RN tower."""
    jcfg, jparams, tparams, tcfg = small_rn
    labels = tmp_path / "labels.csv"
    labels.write_text("id,name\n0,alpha\n1,beta\n2,normal\n3,omega\n")
    sizes = dict(labels_file=str(labels), emb_size=32, depth=1, heads=4, num_segments=4, seg_length=4,
                 concat_features=True, normal_id=2, num_topk=2, num_bottomk=2, load_from_features=False)
    jmodel, jfrozen = jac.AnomalyCLIP.build(jac.AnomalyCLIPConfig(**sizes), jparams, jcfg)
    jtrainable, jbn = jmodel.init_trainable(jax.random.PRNGKey(1), jfrozen)
    model, frozen = AnomalyCLIP.build(AnomalyCLIPConfig(**sizes), tparams, tcfg)
    trainable = convert.params_from_jax(_np_tree(jtrainable), device="cpu")
    bn = convert.bn_state_from_jax(jbn, device="cpu")

    rng = np.random.default_rng(7)
    frames = rng.integers(0, 256, (1, 16, 64, 64, 3), dtype=np.uint8)
    ncentroid = rng.standard_normal(64).astype(np.float32)
    sim, scores = model.forward_test(frozen, trainable, bn, torch.from_numpy(frames), torch.from_numpy(ncentroid), 1)
    jsim, jscores = jmodel.forward_test(jfrozen, _np_tree(jtrainable), jbn, jnp.asarray(frames),
                                        jnp.asarray(ncentroid), segment_size=1)
    assert sim.shape == jsim.shape and scores.shape == jscores.shape == (16,)
    np.testing.assert_allclose(sim.numpy(), np.asarray(jsim), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("tower", ["tiny_vit", "small_rn"])
def test_clip_similarity(small_rn, tower):
    if tower == "small_rn":
        jcfg, jparams, tparams, tcfg = small_rn
    else:
        jcfg = jclip.CLIPConfig.tiny()
        jparams = _np_tree(jclip.init_clip_params(jax.random.PRNGKey(3), jcfg))
        tparams, tcfg = convert.params_from_jax(jparams, device="cpu"), tclip.CLIPConfig.tiny()
    side = tcfg.image_resolution
    images = np.random.default_rng(8).standard_normal((3, side, side, 3)).astype(np.float32)
    ids = tokenize(["a photo of a fight.", "normal street", "an explosion."])
    got = tclip.clip_similarity(tparams, tcfg, torch.from_numpy(images), torch.from_numpy(ids))
    want = jclip.clip_similarity(jparams, jcfg, jnp.asarray(images), jnp.asarray(ids))
    assert got[0].shape == (3, 3) and torch.equal(got[1], got[0].T)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)
