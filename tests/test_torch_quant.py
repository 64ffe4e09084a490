"""The port's int8 (W8A8) serving tower (models/clip/quant.py) and the module's
routing of it, against the JAX package on the CPU.

- ``quantize_weight`` equals the JAX one: codes to the bit, scales within 1e-7
  relative, on a 2-D weight and on a stacked (layers, in, out) one, per layer.
- ``int8_linear`` fed the same fp32 or bf16 input: the activation codes to the
  bit, the outputs within 1e-6 of max|out| (with the fc GEMM's QuickGELU in
  bf16: one bf16 step, see the test).
- ``int8_matmul``'s padding (M <= 16, K = 588 as ViT-L/14's patch embed) equal
  to the unpadded integer product to the bit.
- ``encode_image_int8`` against the JAX one on ``CLIPConfig.tiny()`` in fp32 and
  bf16, and on a ViT-L/14@336px geometry at width 64 (L = 577, the patch
  embed's K = 588), whose attention takes the "core" rung in fp32 and the
  "qtile" rung in bf16, with K6 fed strided views of the packed qkv; each
  within cosine 0.999 of the fp32 tower (tests/test_quant.py's bound).
- The routing tests of tests/test_quant.py on the port's module: int8 serving,
  fp inside ``fit`` with both caches dropped at both edges, an unknown value
  raising ``ValueError`` at the first encode (under ``trainer.model_parallel=2``
  too, which in one process leaves int8 on the int8 tower), and an RN tower
  warned onto the fp tower.
- ``scripts/probe_int8_drift.py``'s readings on the CPU.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anomalyclip_tpu.models.clip import model as jclip
from anomalyclip_tpu.models.clip import quant as jquant
from anomalyclip_tpu_torch import convert
from anomalyclip_tpu_torch.config import to_dict
from anomalyclip_tpu_torch.models.clip import model as tclip
from anomalyclip_tpu_torch.models.clip import quant as tquant
from anomalyclip_tpu_torch.models.clip.model import attention_rung
from anomalyclip_tpu_torch.train import module as tmod

ROOT = Path(__file__).resolve().parents[1]
# ViT-L/14@336px's token count and patch size at width 64 (one head of 64)
L14_GEOMETRY = dict(embed_dim=64, image_resolution=336, vision_layers=2, vision_width=64, vision_patch_size=14,
                    transformer_width=64, transformer_heads=4, transformer_layers=1)
# fp32: the same int8 codes on both sides (a code that flipped at a rounding
# tie between the two LayerNorms would move a feature by a whole quantization
# step, far past this); bf16: the repository's bf16 limit, as the two sides
# round the bf16 residual stream at different points
TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
JAX_DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _load_by_path(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


synthetic_cfg = _load_by_path("_test_torch_quant_synthetic_run",
                              ROOT / "tests" / "helpers" / "synthetic_run.py").synthetic_cfg


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _cosine(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


@pytest.mark.parametrize("shape", [(64, 96), (3, 8, 16)])
def test_quantize_weight_equals_jax(shape):
    rng = np.random.default_rng(0)
    w = (0.1 * rng.standard_normal(shape)).astype(np.float32)
    if len(shape) == 3:
        w[1] *= 100.0  # one layer much larger: its scales must be its own
    want = jquant.quantize_weight(w)
    got = tquant.quantize_weight(torch.from_numpy(w))
    assert got["w_q"].dtype == torch.int8 and got["w_q"].shape == shape[:-2] + (shape[-1], shape[-2])
    np.testing.assert_array_equal(got["w_q"].transpose(-1, -2).numpy(), np.asarray(want["w_q"]))
    np.testing.assert_allclose(got["scale"].numpy(), np.asarray(want["scale"]), rtol=1e-7, atol=0)
    if len(shape) == 3:  # the port quantizes a layer at a time: the same numbers
        for i in range(shape[0]):
            layer = tquant.quantize_weight(torch.from_numpy(w[i]))
            assert torch.equal(layer["w_q"], got["w_q"][i]) and torch.equal(layer["scale"], got["scale"][i])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gelu", [False, True])
def test_int8_linear_equals_jax(dtype, gelu):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((5, 7, 128)).astype(np.float32)
    w = (0.05 * rng.standard_normal((128, 256))).astype(np.float32)
    b = (0.01 * rng.standard_normal(256)).astype(np.float32)
    jx = jnp.asarray(x).astype(JAX_DTYPES[dtype])
    tx = torch.from_numpy(x).to(dtype)
    # the activation codes: the JAX formula (quant.py:80-82) against quantize_rows
    xf = jx.astype(jnp.float32)
    x_scale = jnp.maximum(jnp.max(jnp.abs(xf), axis=-1, keepdims=True), 1e-12) / 127.0
    want_codes = np.asarray(jnp.clip(jnp.rint(xf / x_scale), -127, 127).astype(jnp.int8))
    codes, scales = tquant.quantize_rows(tx)
    np.testing.assert_array_equal(codes.numpy(), want_codes)
    np.testing.assert_array_equal(scales.numpy(), np.asarray(x_scale))

    want = np.asarray(jquant.int8_linear(jx, jax.tree_util.tree_map(jnp.asarray, jquant.quantize_weight(w)),
                                         jnp.asarray(b), gelu=gelu).astype(jnp.float32))
    got = tquant.int8_linear(tx, tquant.quantize_weight(torch.from_numpy(w)), torch.from_numpy(b), gelu=gelu)
    assert got.dtype == dtype and got.shape == (5, 7, 256)
    # the int32 product and the fp32 epilogue are the same operations on both
    # sides; QuickGELU's exp may differ by an fp32 ulp between the two
    # libraries, which can move a bf16 output across a rounding boundary: one
    # bf16 step, 2^-8 of the value
    tol = 2.0**-8 if (dtype == torch.bfloat16 and gelu) else 1e-6
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("m, k, n", [(3, 588, 64), (16, 768, 512), (17, 588, 1024), (40, 64, 192)])
def test_int8_matmul_padding_is_exact(m, k, n):
    rng = np.random.default_rng(m + k + n)
    a = torch.from_numpy(rng.integers(-127, 128, (m, k), dtype=np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (n, k), dtype=np.int8))
    got = tquant.int8_matmul(a, w)
    assert got.dtype == torch.int32 and got.shape == (m, n)
    assert torch.equal(got, torch._int_mm(a, w.t()))
    assert torch.equal(got.long(), a.long() @ w.long().T)


def _towers(kw):
    jcfg = jclip.CLIPConfig(**kw)
    jparams = _np_tree(jclip.init_clip_params(jax.random.PRNGKey(0), jcfg))
    return jcfg, jparams, convert.params_from_jax(jparams, device="cpu"), tclip.CLIPConfig(**kw)


@pytest.fixture(scope="module")
def tiny():
    return _towers({f: getattr(jclip.CLIPConfig.tiny(), f) for f in jclip.CLIPConfig.__dataclass_fields__})


@pytest.fixture(scope="module")
def l14_geometry():
    return _towers(L14_GEOMETRY)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("config", ["tiny", "l14_geometry"])
def test_encode_image_int8_equals_jax(request, config, dtype):
    jcfg, jparams, tparams, tcfg = request.getfixturevalue(config)
    side = tcfg.image_resolution
    tokens = (side // tcfg.vision_patch_size) ** 2 + 1
    rung = attention_rung(2, tokens, tcfg.vision_width, tcfg.vision_heads, torch.tensor([], dtype=dtype).element_size(),
                          False)
    if config == "l14_geometry":
        assert tokens == 577 and rung == {torch.float32: "core", torch.bfloat16: "qtile"}[dtype]
    images = np.random.default_rng(3).standard_normal((2, side, side, 3)).astype(np.float32)
    want = jquant.encode_image_int8(jquant.quantize_clip_visual(jparams), jcfg, jnp.asarray(images), JAX_DTYPES[dtype])
    got = tquant.encode_image_int8(tquant.quantize_clip_visual(tparams), tcfg, torch.from_numpy(images), dtype)
    assert got.dtype == dtype and got.shape == (2, tcfg.embed_dim)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=TOL[dtype], atol=TOL[dtype])
    fp32 = tclip.encode_image(tparams, tcfg, torch.from_numpy(images))
    cos = _cosine(fp32.numpy(), got.float().numpy())
    assert np.all(cos > 0.999), cos


def test_encode_image_int8_uint8_input(tiny):
    _, _, tparams, tcfg = tiny
    frames = np.random.default_rng(4).integers(0, 256, (3, 32, 32, 3), dtype=np.uint8)
    q = tquant.quantize_clip_visual(tparams)
    got = tquant.encode_image_int8(q, tcfg, torch.from_numpy(frames), torch.float32)
    want = tquant.encode_image_int8(q, tcfg, tclip.normalize_frames_on_device(torch.from_numpy(frames)),
                                    torch.float32)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="ViT"):
        tquant.quantize_clip_visual(tclip.init_clip_params(torch.Generator().manual_seed(0), tclip.CLIPConfig(
            embed_dim=64, image_resolution=64, vision_layers=(1, 1, 1, 1), vision_width=16,
            vision_patch_size=None)))


# ---------------------------------------------------------------------------
# the module's routing (tests/test_quant.py:90-175)
# ---------------------------------------------------------------------------


def _module(tmp_path, *overrides):
    cfg = synthetic_cfg(tmp_path, "data.num_workers=0", f"paths.output_dir={tmp_path / 'run'}", *overrides)
    return tmod.AnomalyCLIPTrainModule(to_dict(cfg), device="cpu")


def test_module_routes_int8_encode(tmp_path):
    """model.net.quantize=int8 routes the module's frame encoder, and so its
    scorer, through the W8A8 tower; the features track the fp32 tower's."""
    m = _module(tmp_path, "model.net.quantize=int8")
    fn = m._encode_fn()
    assert getattr(fn, "int8", False), "int8 route not taken"
    assert m._encode_fn() is fn  # quantized once
    frames = torch.from_numpy(np.random.default_rng(0).standard_normal((8, 32, 32, 3)).astype(np.float32))
    feats = fn(m.frozen, frames)
    assert feats.shape == (8, m.model.clip_cfg.embed_dim) and torch.isfinite(feats).all()
    ref = m.model.encode_frames(m.frozen, frames)
    assert np.all(_cosine(ref.numpy(), feats.numpy()) > 0.999)
    state = m.init_state(1)
    m.ncentroid = np.zeros(m.model.embedding_dim, np.float32)
    assert m._scorer(state).encode is fn


def test_int8_is_serving_only(tmp_path):
    """fit() (its ncentroid pass included) encodes on the fp tower with
    quantize=int8, and neither the fit's fp encoder nor a pre-fit int8 one
    leaks across the edges of fit()."""
    m = _module(tmp_path, "model.net.quantize=int8")
    assert getattr(m._encode_fn(), "int8", False)  # pre-fit (serving): int8

    seen = {}
    m._scorer_cache = "pre-fit-int8-scorer"  # must not leak into fit

    def fake_body():
        seen["in_fit"] = m._in_fit
        seen["int8_during_fit"] = getattr(m._encode_fn(), "int8", False)
        seen["scorer_cache_at_entry"] = m._scorer_cache
        m._scorer_cache = "fit-scoped-fp-scorer"  # must not leak out of fit
        return {}

    m._fit_body = fake_body  # the routing is the test, not the epoch loop
    m._fit()
    assert seen == {"in_fit": True, "int8_during_fit": False, "scorer_cache_at_entry": None}
    assert m._encode_frames_fn is None and m._scorer_cache is None and not m._in_fit
    assert getattr(m._encode_fn(), "int8", False)


@pytest.mark.parametrize("mp", [1, 2])
def test_quantize_knob_validated(tmp_path, mp):
    """An unknown quantize value raises ValueError at the first encode, not at
    construction, on every route, ``trainer.model_parallel`` included (JAX
    module.py:180-182). In one process model_parallel=2 has too few ranks for
    the tensor-parallel tower, so int8 serves on the int8 tower."""
    overrides = ("model.net.quantize=w8a8", f"+trainer.model_parallel={mp}")
    m = _module(tmp_path, *overrides)
    with pytest.raises(ValueError, match="quantize"):
        m._encode_fn()
    if mp > 1:
        m = _module(tmp_path, "model.net.quantize=int8", f"+trainer.model_parallel={mp}")
        assert m.model_group is None and getattr(m._encode_fn(), "int8", False)


def test_int8_on_a_resnet_tower_serves_fp(tmp_path, monkeypatch):
    m = _module(tmp_path, "model.net.quantize=int8", "model.net.arch=RN50", "model.net.clip_init=random-full")
    warnings = []
    monkeypatch.setattr(tmod.log, "warning", lambda msg, *args: warnings.append(msg))
    assert m.model.clip_cfg.is_resnet
    fn = m._encode_fn()
    assert not getattr(fn, "int8", False) and fn == m.model.encode_frames
    assert any("ResNet" in w for w in warnings), warnings


def test_probe_int8_drift_returns_its_readings(capsys):
    """What the script prints it also returns: per layer the local gap and the
    flipped share at each GEMM's input, then the features' gaps. On the CPU the
    kernel form is the plain one, so the two runs agree to the bit."""
    from anomalyclip_tpu_torch.scripts import probe_int8_drift

    readings = probe_int8_drift.main(["--device", "cpu"])
    assert readings["arch"] == "tiny" and len(readings["layers"]) == tclip.CLIPConfig.tiny().vision_layers
    for layer in readings["layers"]:
        assert layer["local_gap"] == 0 and set(layer["flipped"]) == set(probe_int8_drift.GEMMS)
        assert all(share == 0 for share in layer["flipped"].values())
    features = readings["features"]
    assert features["kernel_vs_plain"]["max"] == 0 and features["int8_vs_fp"]["cosine"] > 0.999
    assert "features, int8 vs fp" in capsys.readouterr().out
