"""The port's CLIP towers against the JAX package on the same converted weights.

Tiny config: encode_image (uint8 and float input), text_transformer_on_embeddings
and encode_text, fp32 at rtol/atol 1e-4 (a composed module, as in
tests/test_golden.py). Full ViT-B/16: the PRNGKey(0) tower, converted, against
the frozen ``tests/golden/clip_b16.npz`` features at 1e-4, as test_golden.py
holds the JAX package.
"""

from __future__ import annotations

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anomalyclip_tpu.models.clip import model as jclip
from anomalyclip_tpu_torch import convert
from anomalyclip_tpu_torch.models.clip import model as tclip

TOL = 1e-4
GOLDEN = Path(__file__).resolve().parent / "golden"


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def tiny():
    cfg = jclip.CLIPConfig.tiny()
    params = jclip.init_clip_params(jax.random.PRNGKey(3), cfg)
    return cfg, params, convert.params_from_jax(_np_tree(params), device="cpu"), tclip.CLIPConfig.tiny()


def test_encode_image_tiny(tiny):
    jcfg, jparams, tparams, tcfg = tiny
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (3, 32, 32, 3), dtype=np.uint8)
    want = np.asarray(jclip.encode_image(jparams, jcfg, jnp.asarray(frames)))
    got = tclip.encode_image(tparams, tcfg, torch.from_numpy(frames)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)

    images = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jclip.encode_image(jparams, jcfg, jnp.asarray(images)))
    got = tclip.encode_image(tparams, tcfg, torch.from_numpy(images)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_text_transformer_on_embeddings_tiny(tiny):
    jcfg, jparams, tparams, tcfg = tiny
    rng = np.random.default_rng(1)
    emb = (0.02 * rng.standard_normal((5, 77, 64))).astype(np.float32)
    eot = np.asarray([3, 10, 76, 0, 40], np.int32)
    proj = (0.1 * rng.standard_normal((64, 64))).astype(np.float32)
    want = np.asarray(
        jclip.text_transformer_on_embeddings(
            jparams, jcfg, jnp.asarray(emb), jnp.asarray(eot), jnp.asarray(proj)
        )
    )
    got = tclip.text_transformer_on_embeddings(
        tparams, tcfg, torch.from_numpy(emb), torch.from_numpy(eot).long(), torch.from_numpy(proj)
    ).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_encode_text_tiny(tiny):
    from anomalyclip_tpu_torch.models.clip.tokenizer import tokenize

    jcfg, jparams, tparams, tcfg = tiny
    ids = tokenize(["a photo of a fight.", "normal street", "X X X X explosion."])
    want = np.asarray(jclip.encode_text(jparams, jcfg, jnp.asarray(ids)))
    got = tclip.encode_text(tparams, tcfg, torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_bf16_encode_stays_close_to_jax(tiny):
    """bf16 compute: the same casts as the JAX package, so both land within
    bf16 rounding of each other (5e-2)."""
    jcfg, jparams, tparams, tcfg = tiny
    frames = np.random.default_rng(2).integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
    want = np.asarray(
        jclip.encode_image(jparams, jcfg, jnp.asarray(frames), jnp.bfloat16)
    ).astype(np.float32)
    got = tclip.encode_image(tparams, tcfg, torch.from_numpy(frames), torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=5e-2, atol=5e-2)


def test_seeded_init_matches_jax_layout():
    """The port's own init draws the JAX init's shapes and distributions."""
    jcfg = jclip.CLIPConfig.tiny()
    want = convert.params_from_jax(
        _np_tree(jclip.init_clip_params(jax.random.PRNGKey(0), jcfg)), device="cpu"
    )
    got = tclip.init_clip_params(torch.Generator().manual_seed(0), tclip.CLIPConfig.tiny())

    def walk(a, b, path=""):
        if isinstance(a, dict):
            assert a.keys() == b.keys(), path
            for k in a:
                walk(a[k], b[k], f"{path}/{k}")
        elif isinstance(a, list):
            assert len(a) == len(b), path
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, f"{path}/{i}")
        else:
            assert a.shape == b.shape and a.dtype == b.dtype, path
            if a.numel() > 1000:  # a std measured on enough draws to compare
                np.testing.assert_allclose(float(a.std()), float(b.std()), rtol=0.1, err_msg=path)

    walk(got, want)


def test_vit_b16_matches_golden_features():
    """fp32 ViT-B/16 image and text features at the published shapes."""
    with np.load(GOLDEN / "clip_b16.npz") as data:
        golden = {k: data[k] for k in data.files}
    cfg = jclip.CLIPConfig.vit_b16()
    params = convert.params_from_jax(
        _np_tree(jclip.init_clip_params(jax.random.PRNGKey(0), cfg)), device="cpu"
    )
    tcfg = tclip.CLIPConfig.vit_b16()
    img = tclip.encode_image(params, tcfg, torch.from_numpy(golden["image_u8"])).numpy()
    txt = tclip.encode_text(params, tcfg, torch.from_numpy(golden["text_ids"])).numpy()
    np.testing.assert_allclose(img, golden["image_features"], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(txt, golden["text_features"], rtol=TOL, atol=TOL)
