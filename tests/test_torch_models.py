"""The port's prompt learner, test-mode selector and temporal model against the
JAX package on the same inputs and converted weights. Prompt assembly is a
gather and must be exact; the composed modules hold fp32 at rtol/atol 1e-4."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anomalyclip_tpu.models import prompt_learner as jprompt
from anomalyclip_tpu.models import selector as jsel
from anomalyclip_tpu.models import temporal as jtemp
from anomalyclip_tpu_torch import convert
from anomalyclip_tpu_torch.models import prompt_learner as tprompt
from anomalyclip_tpu_torch.models import selector as tsel
from anomalyclip_tpu_torch.models import temporal as ttemp

TOL = 1e-4
CLASSNAMES = ["Abuse", "Arrest", "Normal", "Road_Accidents", "Shoplifting"]


@pytest.mark.parametrize("position", ["end", "middle", "front"])
@pytest.mark.parametrize("shared", [False, True])
def test_prompt_assembly(position, shared):
    rng = np.random.default_rng(0)
    token_embedding = rng.standard_normal((49408, 16)).astype(np.float32)
    kw = dict(n_ctx=4, shared_context=shared, class_token_position=position)
    jspec = jprompt.build_prompt_spec(CLASSNAMES, token_embedding, **kw)
    tspec = tprompt.build_prompt_spec(CLASSNAMES, token_embedding, **kw)
    np.testing.assert_array_equal(tspec.tokenized_prompts, jspec.tokenized_prompts)
    np.testing.assert_array_equal(tspec.eot_indices, jspec.eot_indices)
    ctx_shape = (4, 16) if shared else (len(CLASSNAMES), 4, 16)
    ctx = rng.standard_normal(ctx_shape).astype(np.float32)
    want = np.asarray(jprompt.assemble_prompts(jnp.asarray(ctx), jspec))
    got = tprompt.assemble_prompts(torch.from_numpy(ctx), tspec).numpy()
    np.testing.assert_array_equal(got, want)


def test_prompt_ctx_init_from_words():
    token_embedding = np.random.default_rng(1).standard_normal((49408, 8)).astype(np.float32)
    kw = dict(ctx_init="a_photo_of_a")
    jspec = jprompt.build_prompt_spec(CLASSNAMES, token_embedding, **kw)
    tspec = tprompt.build_prompt_spec(CLASSNAMES, token_embedding, **kw)
    want = jprompt.init_prompt_params(jax.random.PRNGKey(0), jspec, token_embedding, "a_photo_of_a")
    got = tprompt.init_prompt_params(torch.Generator(), tspec, token_embedding, "a_photo_of_a")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_selector_test():
    rng = np.random.default_rng(2)
    image = rng.standard_normal((512, 64)).astype(np.float32)
    text = rng.standard_normal((6, 64)).astype(np.float32)
    ncentroid = rng.standard_normal(64).astype(np.float32)
    mean = rng.standard_normal(5).astype(np.float32)
    var = rng.uniform(0.5, 2.0, 5).astype(np.float32)
    cfg = jsel.SelectorConfig(normal_id=2)
    want = jsel.selector_test(
        jnp.asarray(image), jnp.asarray(text), jnp.asarray(ncentroid),
        jsel.BNState(jnp.asarray(mean), jnp.asarray(var)), cfg,
    )
    got = tsel.selector_test(
        torch.from_numpy(image), torch.from_numpy(text), torch.from_numpy(ncentroid),
        tsel.BNState(torch.from_numpy(mean), torch.from_numpy(var)), tsel.SelectorConfig(normal_id=2),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def _temporal_pair(input_size, emb, depth, heads, n, l, seed):
    kw = dict(input_size=input_size, emb_size=emb, depth=depth, heads=heads,
              dim_heads=None, num_segments=n, seg_length=l)
    jcfg, tcfg = jtemp.TemporalConfig(**kw), ttemp.TemporalConfig(**kw)
    jparams = jtemp.init_temporal_params(jax.random.PRNGKey(seed), jcfg)
    tparams = convert.params_from_jax(
        {"temporal": jax.tree_util.tree_map(np.asarray, jparams)}, device="cpu"
    )["temporal"]
    return jcfg, jparams, tcfg, tparams


@pytest.mark.parametrize(
    "input_size,emb,depth,heads,n,l,grids",
    [
        (24, 64, 2, 2, 4, 4, 3),  # tiny, two depth levels, head dim 32
        (512, 256, 1, 8, 32, 16, 2),  # UCF-Crime: emb 256, depth 1, 32 x 16 grids
    ],
)
@pytest.mark.parametrize("test_mode", [False, True])
def test_temporal_scores(input_size, emb, depth, heads, n, l, grids, test_mode):
    jcfg, jparams, tcfg, tparams = _temporal_pair(input_size, emb, depth, heads, n, l, seed=4)
    feats = np.random.default_rng(5).standard_normal((grids * n * l, input_size)).astype(np.float32)
    seg = grids if test_mode else 1
    want = np.asarray(
        jtemp.temporal_scores(jnp.asarray(feats), jparams, jcfg, segment_size=seg, test_mode=test_mode)
    )
    got = ttemp.temporal_scores(
        torch.from_numpy(feats), tparams, tcfg, segment_size=seg, test_mode=test_mode
    ).numpy()
    assert got.shape == (grids * n * l, 1)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_temporal_seeded_init_matches_jax_layout():
    """The port's own init draws the JAX init's shapes and distributions."""
    _, _, tcfg, want = _temporal_pair(40, 64, 1, 2, 8, 4, seed=0)
    got = ttemp.init_temporal_params(torch.Generator().manual_seed(0), tcfg)
    flat_want, flat_got = dict(_flatten(want)), dict(_flatten(got))
    assert flat_got.keys() == flat_want.keys()
    for key, w in flat_want.items():
        g = flat_got[key]
        assert g.shape == w.shape and g.dtype == w.dtype, key
        if w.numel() > 1000:  # a std measured on enough draws to compare
            np.testing.assert_allclose(float(g.std()), float(w.std()), rtol=0.1, err_msg=key)


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}/{i}")
    else:
        yield prefix, tree
